"""Rank processes of the port's sharded tests (``test_torch_sharding.py``,
``test_torch_sharded_train.py``):
one gloo process per mesh position on the CPU, rendezvous through a
``file://`` path in the test's temp dir (no TCP port, so parallel test
workers cannot collide).  Imports torch and the port only.

``run_ranks(world, tmp, job)`` spawns ``world`` ranks that each run
``job["kind"]`` over ``job`` and save what they computed to
``tmp/rank<r>.pt``; it returns the per-rank results."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rows(mesh, x, b_split: bool):
    if not b_split:
        return x
    axes = ("pod", "data")
    n = mesh.size(axes)
    c = x.shape[0] // n
    return x[mesh.index(axes) * c:(mesh.index(axes) + 1) * c]


def _steps(rank: int, mesh, job: dict) -> dict:
    """Prefill, decode and layered steps of the port over this rank's
    shards; the same steps unsharded are the JAX reference's."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.convert import shard_cache, shard_params
    from repro_torch.launch import steps
    from repro_torch.models.model import DecoderModel
    from repro_torch.sharding import spmd
    from repro_torch.sharding.partition import (default_rules,
                                                sharding_context)
    cfg, b, s, clen = job["cfg"], job["b"], job["s"], job["cache_len"]
    model = DecoderModel(cfg, device="cpu")
    params = shard_params(torch.load(job["params"]), mesh)
    rules = default_rules(mesh)
    lay = spmd.layout(mesh, rules, b, s)
    cache = shard_cache(model.init_cache(b, clen), mesh, b)
    inp = job["inputs"]
    out: dict = {}
    # the step functions take the cache length from the shape
    steps.cache_len_for = lambda c, shape: clen
    with sharding_context(mesh, rules):
        pre = steps.make_step_fn(model, InputShape("p", "prefill", s, b),
                                 moe_dispatch=job["dispatch"])
        dec = steps.make_step_fn(model, InputShape("d", "decode", s, b),
                                 moe_dispatch=job["dispatch"])
        batch = {"tokens": _rows(mesh, inp["tokens"], lay.b_split)}
        if "frames" in inp:
            batch["enc_out"] = _rows(mesh, inp["frames"], lay.b_split)
        logits, cache, aux = pre(params, cache, batch)
        out["prefill"] = (logits, aux["expert_counts"], aux["dropped"])
        if "frames" in inp:
            # whisper: the cross K/V installed, as the engine's admission
            enc = model.encode(params, batch["enc_out"], global_batch=b)
            model.install_cross_kv(params, cache, enc)
        logits, cache, aux = dec(params, cache, {
            "tokens": _rows(mesh, inp["tokens2"], lay.b_split),
            "offsets": _rows(mesh, inp["offsets2"], lay.b_split)})
        out["decode"] = (logits, aux["expert_counts"], aux["dropped"])
        if "hidden" in inp:
            p = inp["hidden"].shape[1]
            lay1 = spmd.layout(mesh, rules, 1, p)
            step = steps.make_layered_step_fn(
                model, group=job["group"], prefill_len=p, global_batch=b,
                cache_len=clen, moe_dispatch=job["dispatch"])
            logits, h_out, cache, aux = step(params, cache, {
                "tokens": _rows(mesh, inp["tokens3"], lay.b_split),
                "offsets": _rows(mesh, inp["offsets3"], lay.b_split),
                "valid": _rows(mesh, inp["valid3"], lay.b_split),
                "hidden": spmd.take_seq(mesh, rules, inp["hidden"], lay1)})
            out["layered"] = (logits, h_out, aux["expert_counts"],
                              aux["prefill_expert_counts"])
    out["cache"] = cache
    return out


def _moe(rank: int, mesh, job: dict) -> dict:
    """One sharded MoE call over this rank's block of the residual."""
    from repro_torch.convert import shard_params
    from repro_torch.models import moe
    from repro_torch.sharding import spmd
    from repro_torch.sharding.partition import (default_rules,
                                                sharding_context)
    cfg, x = job["cfg"], job["x"]
    b, s = x.shape[:2]
    rules = default_rules(mesh)
    lay = spmd.layout(mesh, rules, b, s)
    p = shard_params({"segments": [{"pattern": [{"moe": job["params"]}]}]},
                     mesh)["segments"][0]["pattern"][0]["moe"]
    xl = spmd.take_seq(mesh, rules, _rows(mesh, x, lay.b_split), lay)
    with sharding_context(mesh, rules):
        y, aux = moe.apply_moe(cfg, p, xl, moe_dispatch=job["dispatch"],
                               lay=lay)
    return {"out": y, "counts": aux["expert_counts"],
            "dropped": aux["dropped"]}


def _train(rank: int, mesh, job: dict) -> dict:
    """Sharded train steps of the port over this rank's shards (JAX's
    initial parameters through ``shard_params``, the zero moments through
    ``shard_moments``), the
    global batches given: per step the metrics, this rank's gradient
    shards (in the moments' layout), parameter blocks and moment shards,
    in ``tree_leaves`` order."""
    from repro_torch.convert import shard_moments, shard_params
    from repro_torch.models.model import DecoderModel
    from repro_torch.sharding.partition import sharding_context
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train import make_train_step, train_plan

    class Recording(topt.AdamW):
        def update(self, grads, state, params, plan=None):
            seen.append([g.clone() for g in topt.tree_leaves(grads)])
            return super().update(grads, state, params, plan)
    seen: list = []
    cfg = job["cfg"]
    model = DecoderModel(cfg, device="cpu", remat=True)
    import dataclasses
    base = topt.adamw(**job["opt"])
    opt = Recording(**{f.name: getattr(base, f.name)
                       for f in dataclasses.fields(base)})
    whole = torch.load(job["params"])
    params = shard_params(whole, mesh)
    params = topt.tree_unflatten(params, [
        t.clone() for t in topt.tree_leaves(params)])
    # the one-device optimizer state cut to this rank's ZeRO-1 shards: the
    # blocks ``opt.init(params, plan)`` makes (the launcher's way)
    state = shard_moments(opt.init(whole), mesh)
    steps = []
    with sharding_context(mesh):
        plan = train_plan(model)
        for a, b in zip(topt.tree_leaves(state.mu), topt.tree_leaves(
                opt.init(params, plan).mu)):
            assert a.shape == b.shape
        step = make_train_step(model, opt, cfg.encoder.enabled)
        for batch in job["batches"]:
            params, state, m = step(params, state, batch)
            steps.append({
                "metrics": {k: float(v) for k, v in m.items()},
                "grads": seen.pop(),
                "params": [t.clone() for t in topt.tree_leaves(params)],
                "mu": [t.clone() for t in topt.tree_leaves(state.mu)],
                "nu": [t.clone() for t in topt.tree_leaves(state.nu)]})
    return {"steps": steps}


def _colls(rank: int, mesh, job: dict) -> dict:
    """Each collective (and ``regroup``) on this rank's block of one input,
    its output weighted by a rank-specific tensor and summed: the gradient
    of that term (the convention of ``collectives.py``: the ranks' terms
    add) on the rank's block, and the calls ``RECORD`` counted, forward
    and backward."""
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding import spmd
    out = {}
    for name, x_all, w_all in job["cases"]:
        x = x_all[rank].clone().requires_grad_(True)
        col.reset_record()
        if name == "all_gather":
            y = col.all_gather(mesh, x, "model", dim=1)
        elif name == "reduce_scatter":
            y = col.reduce_scatter(mesh, x, "model", dim=1)
        elif name == "all_reduce":
            y = col.all_reduce(mesh, x, ("data", "model"))
        elif name == "all_to_all":
            y = col.all_to_all(mesh, x, "data", split_dim=0, concat_dim=1)
        elif name == "all_to_all_v":
            send, recv = job["counts"][rank]
            y = col.all_to_all_v(mesh, x, "model", send, recv)
        else:
            y = spmd.regroup(mesh, "model", x, *job["regroup"], dim=1)
        (y * w_all[rank][:y.numel()].reshape(y.shape)).sum().backward()
        out[name] = (y.detach(), x.grad,
                     {k: v["calls"] for k, v in col.RECORD.items()})
    return out


def _launcher(rank: int, mesh, job: dict) -> dict:
    """The launcher's per-rank body (``train_sharded``) with ``argv``."""
    from repro_torch.launch import train
    from repro_torch.training.optimizer import tree_leaves
    args = train.build_parser().parse_args(job["argv"])
    run = train.train_sharded(args, mesh, device="cpu")
    state = run["opt_state"]
    return {"history": run["history"], "params": tree_leaves(run["params"]),
            "mu": tree_leaves(state.mu), "nu": tree_leaves(state.nu)}


def _rank(rank: int, world: int, tmp: str, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "rendezvous"), rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh
        res = []
        for sub in job["runs"]:
            mesh = make_mesh(sub["mesh"], sub["axes"], rank=rank,
                             distributed=True)
            fn = {"steps": _steps, "moe": _moe, "train": _train,
                  "colls": _colls, "launcher": _launcher}[sub["kind"]]
            res.append({"coords": mesh.coords, **fn(rank, mesh, sub)})
        torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, tmp: str, job: dict):
    mp.start_processes(_rank, args=(world, tmp, job), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
            for r in range(world)]
