"""Multi-device dry-run: trace rank 0's serve step of every (architecture x
input shape) on the production meshes, 16x16 (256 ranks) and 2x16x16 (512
ranks), and report its memory, flops, bytes and collective bytes against
an H100 SXM's roofline (the JAX package's ``repro/launch/dryrun.py``, with
its arguments and JSON fields).

No card and no compiler: a fake process group (``torch.testing``'s
``FakeStore``, backend "fake") gives the 256 or 512 ranks in one process,
the production mesh's ``DeviceMesh`` and groups are built on it, and rank
0's step runs on fake tensors (``FakeTensorMode``: shapes, no data) of
its local shards (``partition.param_specs``/``cache_specs``).  The
tensors are fake CUDA tensors where this torch is built for CUDA and a
card is visible, so the trace is the card's path, kernels included
(K1-K4 and the backward kernels propagate shapes as custom ops,
``kernels/ops.py``); elsewhere it traces the same path on fake CPU
tensors and says so (``"device"``).  Every layer is
traced.  Collectives run against the fake group and are recorded
(``sharding/collectives.RECORD``); flops, bytes and peak memory are
``launch/analysis.py``'s.

Every registry config shards, at the serve shapes and at ``train_4k``:
the train step's forward and backward (remat per block, K2's and K4's
backward kernels as custom ops) and its ZeRO-1 AdamW update over fake
shards of the parameters and the moments.  Only the ``long_500k``
combinations that ``applicable`` refuses (full attention at 524k
positions) are written as skipped.  The sLSTM and chunkwise mLSTM
recurrences trace as one op each (``analysis.one_op_recurrences``): their
bytes are their inputs and outputs, as one fused scan would move, and
their backward's working memory is not seen.  ``flops_by_op`` gives each
op's share of the flops.
The process group is torn down before returning, unless the caller set
one up itself.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape decode_32k [--multi-pod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.shapes import (SHAPES, applicable, cache_len_for,
                                        input_specs)
from repro_torch.launch import analysis
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.launch.steps import make_step_fn
from repro_torch.models.model import DecoderModel
from repro_torch.sharding import collectives as col
from repro_torch.sharding.partition import (cache_specs, default_rules,
                                            local_shape, map_with_specs,
                                            param_specs, sharding_context)

def trace_device() -> str:
    """The fake tensors' device: the card's where torch is built for it and
    a card is visible (a train step's backward runs on autograd's device
    threads, which need one), else the CPU."""
    return ("cuda" if torch.version.cuda and torch.cuda.is_available()
            else "cpu")


def _fake_group(world: int) -> bool:
    """Set up the fake process group of ``world`` ranks (rank 0); False
    where the caller already has a process group (which is then used)."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is set up; the mesh needs {world}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


def trace_step(cfg, shape, mesh, device: str) -> dict:
    """Rank ``mesh.rank``'s step of (cfg, shape) on fake local shards:
    flops, bytes, collective bytes, peak memory, and the local shards'
    parameter and cache bytes (for ``train_4k``: the forward and backward
    with remat per block, as the JAX dry-run lowers it, and the ZeRO-1
    update; the moments' bytes stand where the cache's do)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training.train import train_plan
    rules = default_rules(mesh)
    train = shape.kind == "train"
    model = DecoderModel(cfg, device="cpu", remat=train)
    shapes = model.param_shapes()
    b = shape.global_batch
    b_n = mesh.size(rules.get("batch"))
    b_loc = b // b_n if b % b_n == 0 else b
    plan = None
    if train:
        with sharding_context(mesh, rules):
            plan = train_plan(model)
    with FakeTensorMode(), analysis.one_op_recurrences():
        def local(x, spec):
            return torch.empty(local_shape(tuple(x.shape), spec, mesh),
                               dtype=x.dtype, device=device)
        params = map_with_specs(local, shapes, param_specs(shapes, mesh))
        step = make_step_fn(model, shape)
        if train:
            # the train step takes the global batch and cuts its rows
            state = step.opt.init(params, plan)
            batch = input_specs(cfg, shape, device=device)
            held = [params, state, batch]
        else:
            cache_g = model.init_cache(b, cache_len_for(cfg, shape))
            state = map_with_specs(local, cache_g,
                                   cache_specs(cache_g, mesh, b))
            del cache_g
            batch = input_specs(cfg, shape, batch=b_loc, device=device)
            held = [params, state, batch]
        col.reset_record()
        cost = analysis.StepCost()
        param_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(params))
        state_bytes = sum(t.numel() * t.element_size() for t in _leaves(
            (state.mu, state.nu) if train else state))
        with cost, FlopCounterMode(display=False) as fc:
            cost.track(held)
            with sharding_context(mesh, rules):
                out = step(params, state, batch)
            del out
        by_op = {str(k): float(v)
                 for k, v in fc.get_flop_counts()["Global"].items()}
        rec = {"flops": float(fc.get_total_flops()), "flops_by_op": by_op,
               "bytes": float(cost.bytes), "coll": col.record_totals(),
               "peak": float(cost.peak), "param_bytes": param_bytes}
        rec["moment_bytes" if train else "cache_bytes"] = state_bytes
        return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True) -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, reason = applicable(cfg, shape)
    if not ok:
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: skipped "
                  f"({reason})", flush=True)
        return {**head, "status": "skipped", "reason": reason}

    t0 = time.time()
    dims, _ = production_shape(multi_pod)
    world = 1
    for n in dims:
        world *= n
    owned = _fake_group(world)
    try:
        mesh = make_production_mesh(multi_pod, rank=0, distributed=True)
        device = trace_device()
        m = trace_step(cfg, shape, mesh, device)
    finally:
        if owned:
            dist.destroy_process_group()
    trace_s = time.time() - t0
    rep = analysis.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, n_chips=world,
        hlo_flops=m["flops"], hlo_bytes=m["bytes"],
        coll_bytes=m["coll"]["total"], coll_by_kind=m["coll"],
        model_flops=analysis.model_flops_estimate(cfg, shape),
        peak_memory_per_device=m["peak"])
    out = {**head, "status": "ok", "device": f"fake {device}",
           "compile_s": trace_s, **rep.to_dict(),
           "flops_by_op": m["flops_by_op"],
           "param_bytes_per_device": m["param_bytes"],
           **({"moment_bytes_per_device": m["moment_bytes"]}
              if "moment_bytes" in m else
              {"cache_bytes_per_device": m["cache_bytes"]}),
           "total_s": time.time() - t0}
    if verbose:
        kinds = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in
                          m["coll"].items() if k != "total")
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: ok "
              f"trace={trace_s:.0f}s flops/dev={out['hlo_flops']:.3e} "
              f"({out['hlo_flops'] / 1e12:.1f} TFLOP) "
              f"bytes/dev={out['hlo_bytes']:.3e} "
              f"({out['hlo_bytes'] / 1e9:.1f} GB) "
              f"coll/dev={out['collective_bytes']:.3e} (GB by kind: "
              f"{kinds}) bottleneck={out['bottleneck']} "
              f"mem/dev={out['peak_memory_per_device'] / 1e9:.2f}GB",
              flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.all else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                path = os.path.join(args.out, tag + ".json")
                try:
                    rec = dryrun_one(arch, shape, multi_pod=mp)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": str(e)}
                    failures.append(tag)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                print("[dryrun] json " + json.dumps(rec), flush=True)
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")
    print("[dryrun] all requested combinations traced", flush=True)


if __name__ == "__main__":
    main()
