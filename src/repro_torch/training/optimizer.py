"""AdamW and LR schedules: the JAX package's ``training/optimizer.py`` in
PyTorch (no ``torch.optim``), the same function on the same trees.

Includes the WSD (Warmup-Stable-Decay) schedule from MiniCPM
(arXiv:2404.06395) alongside cosine decay.  Schedules take an int or a
0-dim tensor step and return a 0-dim fp32 tensor (on the step's device),
so a training step reads nothing back from the card.

``AdamW.update`` computes what JAX's does — fp32 moments, the global-norm
clip (the norm reported before clipping), decay of the leaves with two or
more dimensions only, the result cast back to each parameter's dtype —
with one difference of form: it updates the moments and the parameters IN
PLACE, a chunk of at most ``CHUNK`` elements of a leaf at a time, in the
same order of operations.  JAX's leaf-wise formula makes several fp32
temporaries of a whole leaf, and a stacked expert leaf of qwen3-30b-a3b
(reps, 128, 2048, 768) holds 201 M elements a layer: the transients alone
would outgrow the card.  The grad norm is summed per chunk the same way.

Under a sharding context the train step passes a ZeRO-1 plan
(``partition.zero1_plan``): the moments are the rank's ``moment_specs``
shards and ``update_zero1`` updates the moment shard's slice of each
parameter, then gathers it back.  Without one, ``update`` is the one-device
update, bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple

import torch

Tensor = torch.Tensor

# elements of a leaf updated at once: fp32 temporaries of 256 MB each
CHUNK = 1 << 26
# the same under ZeRO-1, where every rank of a card's pool holds its own
# temporaries beside its shards: 16 MB each
ZERO_CHUNK = 1 << 22


class AdamWState(NamedTuple):
    step: Tensor        # 0-dim int32, on the parameters' device
    mu: object          # tree like params, fp32
    nu: object


def tree_leaves(tree) -> List[Tensor]:
    """Leaves in the JAX package's order: dict keys sorted, lists and
    tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return next(it)
    return build(template)


def _chunks(t: Tensor, n: int = CHUNK):
    return t.view(-1).split(n)


def _as_step(step, device=None) -> Tensor:
    if isinstance(step, Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32, device=device)


@dataclass(frozen=True)
class AdamW:
    lr_fn: Callable[[Tensor], Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params, plan=None) -> AdamWState:
        """Zero moments; with ``plan`` (``partition.zero1_plan``, under a
        sharding context) each the rank's ZeRO-1 shard of its parameter's
        local block."""
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        shapes = [p.shape for p in leaves]
        if plan is not None:
            shapes = [_moment_shape(p, lp)
                      for p, lp in zip(leaves, tree_leaves(plan))]

        def z():
            return tree_unflatten(params, [
                torch.zeros(sh, dtype=torch.float32, device=p.device)
                for p, sh in zip(leaves, shapes)])
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=z(), nu=z())

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, plan=None):
        """-> (params, state, {"grad_norm", "lr"}).  ``params`` and the
        state's moments are updated in place and returned; nothing is read
        back to the host.  ``plan`` (``partition.zero1_plan``, under a
        sharding context): ZeRO-1, ``update_zero1``."""
        if plan is not None:
            return self.update_zero1(grads, state, params, plan)
        step = state.step + 1
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
        # global-norm clip, the norm reported before clipping
        sq = torch.zeros((), dtype=torch.float32, device=step.device)
        for g in gs:
            for gc in _chunks(g.contiguous()):
                sq = sq + torch.sum(torch.square(gc.float()))
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        sf = step.to(torch.float32)
        bc1 = 1 - self.b1 ** sf
        bc2 = 1 - self.b2 ** sf
        lr = self.lr_fn(step)
        for p, g, m, v in zip(ps, gs, ms, vs):
            decay = p.dim() >= 2   # decay matrices only (norms/bias exempt)
            for pc, gc, mc, vc in zip(_chunks(p), _chunks(g.contiguous()),
                                      _chunks(m), _chunks(v)):
                gf = gc.float() * scale
                mc.mul_(self.b1).add_((1 - self.b1) * gf)
                vc.mul_(self.b2).add_((1 - self.b2) * torch.square(gf))
                delta = (mc / bc1) / (torch.sqrt(vc / bc2) + self.eps)
                if decay:
                    delta = delta + self.weight_decay * pc.float()
                pc.copy_(pc.float() - lr * delta)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
            "grad_norm": gnorm, "lr": lr}


    @torch.no_grad()
    def update_zero1(self, grads, state: AdamWState, params, plan):
        """ZeRO-1 over this rank's shards, inside a sharding context:
        ``grads`` are already in the moments' layout (each leaf summed over
        the axes its spec leaves it whole on and cut like its moment,
        ``training/train.py``), ``state``'s moments the rank's
        ``moment_specs`` shards.  The global-norm clip counts each element
        of the global gradient once (a shard's square sum over its
        ``copies``, all-reduced over the mesh); each leaf's update is
        computed on the moment shard's slice of the local parameter with
        the same formula, chunk by chunk, and the new values are
        all-gathered over ``data`` back into the parameter's block."""
        from repro_torch.sharding import collectives as col
        from repro_torch.sharding.partition import active_context
        mesh, _ = active_context()
        step = state.step + 1
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
        plans = tree_leaves(plan)
        sq = torch.zeros((), dtype=torch.float32, device=step.device)
        for g, lp in zip(gs, plans):
            part = torch.zeros((), dtype=torch.float32, device=step.device)
            for gc in _chunks(g.contiguous(), ZERO_CHUNK):
                part = part + torch.sum(torch.square(gc.float()))
            sq = sq + part / lp.copies
        gnorm = torch.sqrt(col.all_reduce(mesh, sq, mesh.axis_names))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        sf = step.to(torch.float32)
        bc1 = 1 - self.b1 ** sf
        bc2 = 1 - self.b2 ** sf
        lr = self.lr_fn(step)
        for p, g, m, v, lp in zip(ps, gs, ms, vs, plans):
            decay = p.dim() >= 2
            mine = p if lp.dim is None else p.narrow(
                lp.dim, lp.j * (p.shape[lp.dim] // lp.n),
                p.shape[lp.dim] // lp.n).contiguous()
            for pc, gc, mc, vc in zip(*(_chunks(t, ZERO_CHUNK) for t in (
                    mine, g.contiguous(), m, v))):
                gf = gc.float() * scale
                mc.mul_(self.b1).add_((1 - self.b1) * gf)
                vc.mul_(self.b2).add_((1 - self.b2) * torch.square(gf))
                delta = (mc / bc1) / (torch.sqrt(vc / bc2) + self.eps)
                if decay:
                    delta = delta + self.weight_decay * pc.float()
                pc.copy_(pc.float() - lr * delta)
            if lp.dim is not None:
                p.copy_(col.all_gather(mesh, mine, lp.scatter, dim=lp.dim))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
            "grad_norm": gnorm, "lr": lr}


def _moment_shape(p: Tensor, lp) -> tuple:
    """The ZeRO-1 moment shard's shape of local parameter block ``p``."""
    if lp.dim is None:
        return tuple(p.shape)
    return tuple(n // lp.n if i == lp.dim else n
                 for i, n in enumerate(p.shape))


def adamw(lr: float = 3e-4, schedule: str = "cosine", total_steps: int = 1000,
          warmup: int = 100, **kw) -> AdamW:
    if schedule == "wsd":
        fn = wsd_schedule(lr, total_steps, warmup)
    elif schedule == "cosine":
        fn = cosine_schedule(lr, total_steps, warmup)
    else:
        def fn(step):
            dev = step.device if isinstance(step, Tensor) else None
            return torch.tensor(lr, dtype=torch.float32, device=dev)
    return AdamW(lr_fn=fn, **kw)


def cosine_schedule(peak: float, total_steps: int, warmup: int):
    def fn(step):
        s = _as_step(step)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0, 1)
        cos = 0.1 * peak + 0.9 * peak * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn


def wsd_schedule(peak: float, total_steps: int, warmup: int,
                 decay_frac: float = 0.1, floor_frac: float = 0.01):
    """MiniCPM Warmup-Stable-Decay: linear warmup, long stable plateau at
    peak, exponential decay over the final ``decay_frac`` of training."""
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step):
        s = _as_step(step)
        warm = peak * s / max(warmup, 1)
        stable = torch.full((), peak, dtype=torch.float32, device=s.device)
        prog = torch.clamp((s - decay_start)
                           / max(total_steps - decay_start, 1), 0, 1)
        decay = peak * torch.pow(floor_frac, prog)
        return torch.where(s < warmup, warm,
                           torch.where(s < decay_start, stable, decay))
    return fn
