"""Training launcher of the port: the JAX package's ``launch/train.py`` on
one device — the synthetic data pipeline, the train step on torch
autograd (K2 and K4 with their hand-written backward kernels on the card),
AdamW under the WSD (default), cosine or constant schedule, and an optional
checkpoint.

The model runs at its full configured width and depth (``--smoke`` selects
the reduced variant) with random weights from seed 0, or the parameters of
a checkpoint (``--init``: a file ``training.checkpoint.save`` wrote, such as
one ``--ckpt`` wrote, or the JAX package's parameters converted through
``repro_torch.convert``).  Activation checkpointing per block (``remat``)
is on unless ``--smoke``, as in the JAX launcher.  It prints the JAX
launcher's ``[train]`` lines with the device in place of the mesh; a
logged step reads its metrics back in one transfer, other steps read
nothing.

``--production-mesh`` trains over the JAX launcher's 16x16 ``(data,
model)`` mesh: one process a GPU, 256 of them, which the caller starts
(``torchrun``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous
in the environment; NCCL on the card, gloo with ``--device cpu``).
Without such a process group it raises and says so.  Each rank draws the
whole model from seed 0 on its device (it refuses, before drawing, a
model whose weights exceed the device's free memory: deepseek-v2-236b's
471 GB need a sharded init, ROADMAP.md §1 item 2), keeps its shards
(``partition.param_specs``) and ZeRO-1 moments (``moment_specs``), and
runs ``train_sharded``, the per-rank body, which takes any mesh (the
tests drive it at (2, 2) on gloo CPU ranks); rank 0 prints the ``[train]``
lines with the mesh, and ``--ckpt`` writes whole leaves, gathered by
their specs, under the JAX package's leaf names (the one-device
``--init`` reads them).

Usage:
  # on the card, full minicpm-2b (2.7 B parameters), 8 x 256 tokens a step:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 50

  # on the CPU, reduced model (the kernels' plain versions run):
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3 [--batch 8] [--seq 256] [--ckpt /path/ck.pt]

  # 256 GPUs (32 nodes of 8), the production mesh:
  torchrun --nnodes 32 --nproc-per-node 8 --rdzv-backend c10d \\
      --rdzv-endpoint HOST:PORT -m repro_torch.launch.train \\
      --arch qwen3-30b-a3b --production-mesh --steps 50
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_configs
from repro_torch.kernels import ops
from repro_torch.models.model import DecoderModel
from repro_torch.training import checkpoint as ckpt_io
from repro_torch.training.data import PackedDataset, SyntheticCorpus
from repro_torch.training.optimizer import adamw, tree_leaves
from repro_torch.training.train import (device_batch, make_train_step,
                                        read_metrics)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b", choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "const"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh (a process group of 256 ranks "
                         "that torchrun starts)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--init", default=None,
                    help="start from the 'params' of this checkpoint")
    return ap


def _optimizer(args):
    return adamw(lr=args.lr, schedule=args.schedule, total_steps=args.steps,
                 warmup=max(args.steps // 10, 1))


def train_sharded(args, mesh, device=None) -> dict:
    """The per-rank body of ``--production-mesh`` over any ``mesh`` built
    with its process groups (``collectives.Mesh(..., distributed=True)``):
    this rank's shards of the seed-0 model (or ``--init``'s), ZeRO-1
    moments, the JAX launcher's data and schedule; rank 0 prints the
    ``[train]`` lines.  Returns ``history`` (every step's metrics, read
    back at the end; every rank holds the same), and the rank's
    ``params`` and ``opt_state``."""
    from repro_torch.convert import gather_params, shard_params
    from repro_torch.sharding.partition import (moment_specs, param_specs,
                                                sharding_context)
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train import train_plan
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = DecoderModel(cfg, device=device, remat=not args.smoke)
    dev = model.device
    opt = _optimizer(args)
    shapes = model.param_shapes()
    need = sum(p.numel() * p.element_size() for p in tree_leaves(shapes))
    free = _free_bytes(dev)
    if need > free:
        raise SystemExit(
            f"--production-mesh draws the whole model on each rank before "
            f"keeping its shards: {cfg.name}'s weights take {need / 1e9:.1f} "
            f"GB, the rank has {free / 1e9:.1f} GB free; models this large "
            f"need a sharded init (ROADMAP.md §1 item 2, step 2)")
    whole = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.init:
        whole = ckpt_io.restore(args.init, {"params": whole})["params"]
    # this rank's own copies: nothing it updates aliases the whole tree
    params = ops.tree_map(torch.clone, shard_params(whole, mesh))
    del whole
    lead = mesh.rank == 0
    kept = []
    with sharding_context(mesh):
        opt_state = opt.init(params, train_plan(model))
        step_fn = make_train_step(model, opt, cfg.encoder.enabled)
        n = sum(p.numel() for p in tree_leaves(shapes))
        if lead:
            print(f"[train] {cfg.name}: {n / 1e6:.1f}M params on mesh "
                  f"{dict(mesh.shape)}", flush=True)
        corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0)
        ds = iter(PackedDataset(corpus, seq_len=args.seq,
                                batch_size=args.batch, seed=0))
        t0 = time.time()
        for step in range(1, args.steps + 1):
            batch = device_batch(model, *next(ds))
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            kept.append(metrics)
            if step % 10 == 0 or step == 1:
                m = read_metrics({"loss": metrics["loss"],
                                  "lr": metrics["lr"]})
                if lead:
                    print(f"[train] step {step:>5} loss={m['loss']:.3f} "
                          f"lr={m['lr']:.2e} "
                          f"({(time.time() - t0) / step:.2f}s/step)",
                          flush=True)
        if args.ckpt:
            tree = {"params": gather_params(params, mesh,
                                            param_specs(shapes, mesh)),
                    "opt": AdamWState(
                        step=opt_state.step,
                        mu=gather_params(opt_state.mu, mesh,
                                         moment_specs(shapes, mesh)),
                        nu=gather_params(opt_state.nu, mesh,
                                         moment_specs(shapes, mesh)))}
            if lead:
                ckpt_io.save(args.ckpt, tree)
                print(f"[train] checkpoint -> {args.ckpt}", flush=True)
    return {"history": [read_metrics(m) for m in kept], "params": params,
            "opt_state": opt_state}


def _free_bytes(dev: torch.device) -> int:
    """The memory free for the whole model on ``dev``: the card's, or the
    host's available memory for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[0]
    import os
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _production_mesh(args):
    """The 16x16 mesh on the process group ``torchrun`` describes in the
    environment; raises without one of 256 ranks."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh, production_shape
    dims, _ = production_shape(False)
    need = dims[0] * dims[1]
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if world != need:
        raise SystemExit(
            f"--production-mesh needs a process group of {need} ranks, one a "
            f"GPU, started by torchrun (WORLD_SIZE={world or 'unset'}): "
            f"torchrun --nnodes 32 --nproc-per-node 8 ... -m "
            f"repro_torch.launch.train --production-mesh")
    cpu = args.device == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if cpu else "nccl")
    return make_production_mesh(rank=dist.get_rank(), distributed=True)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.production_mesh:
        import torch.distributed as dist
        mesh = _production_mesh(args)
        try:
            train_sharded(args, mesh, device=args.device
                          or torch.device("cuda", torch.cuda.current_device()))
        finally:
            dist.destroy_process_group()
        return
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = DecoderModel(cfg, device=args.device, remat=not args.smoke)
    dev = model.device
    opt = _optimizer(args)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.init:
        params = ckpt_io.restore(args.init, {"params": params})["params"]
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, cfg.encoder.enabled)

    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n / 1e6:.1f}M params on device {dev}"
          f"{' (' + torch.cuda.get_device_name(dev) + ')' if dev.type == 'cuda' else ''}")

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0)
    ds = iter(PackedDataset(corpus, seq_len=args.seq,
                            batch_size=args.batch, seed=0))
    ops.reset_launches()
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = device_batch(model, *next(ds))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == 1:
            m = read_metrics({"loss": metrics["loss"], "lr": metrics["lr"]})
            print(f"[train] step {step:>5} loss={m['loss']:.3f} "
                  f"lr={m['lr']:.2e} "
                  f"({(time.time() - t0) / step:.2f}s/step)")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        print("[train] kernel launches: " + ", ".join(
            f"{k} {v}" for k, v in ops.LAUNCHES.items() if v))
    if args.ckpt:
        ckpt_io.save(args.ckpt, {"params": params, "opt": opt_state})
        print(f"[train] checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
