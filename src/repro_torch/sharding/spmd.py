"""Explicit SPMD over local shards: the residual stream's layout between
blocks and the moves between layouts.

PyTorch has no GSPMD, so the port runs one program per rank, each over
its own shards as plain tensors, and moves data where the JAX package's
shardings change.  Between blocks the residual (B, S, D) lies as the JAX
package's ``shard_seq_hint`` lays it: rows over the batch axes where they
divide B, the sequence over the tensor-parallel axis where it divides S
(``Layout``).  Column-parallel projections read the rank's rows at the
full sequence (``gather_seq``); row-parallel outputs are partial sums
that ``reduce_rows`` sums and cuts back to the layout (a reduce-scatter
over the sequence: Megatron sequence parallelism).

``regroup`` moves items (columns of an activation, or tokens) between two
static assignments of items to ranks: every rank names the items it holds
and the items it needs, and each needed item travels once, from the rank
that holds it (its own copy where it has one), by one uneven all-to-all.
Every move here is differentiable (``collectives.py`` states the
convention): the slices' backward pads with zeros, the collectives'
is their transpose, ``regroup``'s the reverse regroup.
Attention uses it to turn column shards that cut heads into whole heads
(never gathering a weight); the MoE's a2a regime uses it to group tokens
as the JAX package's ``shard_map`` groups them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding import collectives as col
from repro_torch.sharding.partition import seq_layout

Tensor = torch.Tensor


@dataclass(frozen=True)
class Layout:
    """The residual stream of one call: its global rows ``b`` and positions
    ``s``, whether this rank holds a block of the rows (``b_split``, over
    the batch axes) and of the positions (``s_split``, over ``model``), and
    the global length of the KV cache rows it writes (``cache_len``)."""
    b: int
    s: int
    b_split: bool
    s_split: bool
    cache_len: Optional[int] = None


def layout(mesh, rules, b: int, s: int,
           cache_len: Optional[int] = None) -> Layout:
    b_split, s_split = seq_layout(mesh, rules, b, s)
    return Layout(b, s, b_split, s_split, cache_len)


def gather_seq(mesh, rules, x: Tensor, lay: Layout, dim: int = 1) -> Tensor:
    """This rank's rows at every position (whole over ``model``)."""
    if not lay.s_split:
        return x
    return col.all_gather(mesh, x, rules.get("tp"), dim=dim)


def take_seq(mesh, rules, x: Tensor, lay: Layout, dim: int = 1) -> Tensor:
    """This rank's block of positions of ``x``, which it holds whole."""
    if not lay.s_split:
        return x
    n = mesh.size(rules.get("tp"))
    j = mesh.index(rules.get("tp"))
    c = x.shape[dim] // n
    return x.narrow(dim, j * c, c)


def take_rows(mesh, rules, x: Tensor, lay: Layout) -> Tensor:
    """This rank's block of rows (dim 0) of ``x``, which it holds whole."""
    if not lay.b_split:
        return x
    axes = rules.get("batch")
    c = x.shape[0] // mesh.size(axes)
    return x.narrow(0, mesh.index(axes) * c, c)


def sum_partials(mesh, y: Tensor, axes,
                 scatter_dim: Optional[int] = None) -> Tensor:
    """Partial sums ``y`` added over ``axes`` in fp32 and rounded once to
    y's dtype, as one GEMM over the whole contraction rounds its fp32
    accumulator once; summed in bf16, every add would round again (over
    8 ranks about 2.8 times the unsharded rounding; at qwen3-30b-a3b's
    widths, 8 blocks of random weights grew that to 5.3e-2 of the
    logits against 4.4e-2 this way, PERF.md §6).  Cut along
    ``scatter_dim`` by a reduce-scatter where it is given."""
    f = y.float()
    if scatter_dim is None:
        return col.all_reduce(mesh, f, axes).to(y.dtype)
    return col.reduce_scatter(mesh, f, axes, dim=scatter_dim).to(y.dtype)


def reduce_rows(mesh, rules, y: Tensor, lay: Layout, partial: bool) -> Tensor:
    """A row-parallel output (B_local, S, D) back to the layout: summed
    over ``model`` where it holds partial sums (cut to this rank's
    positions by a reduce-scatter where the layout splits them), else cut
    to the rank's positions."""
    if not partial:
        return take_seq(mesh, rules, y, lay)
    return sum_partials(mesh, y, rules.get("tp"),
                        1 if lay.s_split else None)


def block_sets(n_items: int, sharded: bool, n: int) -> Tuple[Tuple[int, ...], ...]:
    """Items each of ``n`` ranks holds: contiguous equal blocks, or all."""
    if not sharded or n == 1:
        return (tuple(range(n_items)),) * n
    c = n_items // n
    return tuple(tuple(range(r * c, (r + 1) * c)) for r in range(n))


@functools.lru_cache(maxsize=None)
def _plan(src: Tuple[Tuple[int, ...], ...], dst: Tuple[Tuple[int, ...], ...],
          me: int):
    """(send index per destination, receive counts, local index, and where
    each received or local item lands in the output) for rank ``me``."""
    n = len(src)
    pos = [{it: i for i, it in enumerate(s)} for s in src]

    def source(it, r):
        if it in pos[r]:
            return r
        for q in range(n):
            if it in pos[q]:
                return q
        raise ValueError(f"item {it} is held by no rank")
    send = []
    for r in range(n):
        send.append([pos[me][it] for it in dst[r]
                     if r != me and source(it, r) == me])
    recv_from = [[k for k, it in enumerate(dst[me]) if source(it, me) == q]
                 for q in range(n)]
    local_src = [pos[me][dst[me][k]] for k in recv_from[me]]
    order = []            # output slot of each received row, source order
    for q in range(n):
        if q != me:
            order.extend(recv_from[q])
    return (np.array([i for s in send for i in s], dtype=np.int64),
            [len(s) for s in send],
            [0 if q == me else len(recv_from[q]) for q in range(n)],
            np.array(local_src, dtype=np.int64),
            np.array(recv_from[me], dtype=np.int64),
            np.array(order, dtype=np.int64))


def regroup(mesh, axes, x: Tensor, src: Sequence[Sequence[int]],
            dst: Sequence[Sequence[int]], dim: int = -1) -> Tensor:
    """``x`` holds, on the rank of index j over ``axes``, the items
    ``src[j]`` along ``dim`` (in that order); returns the items ``dst[j]``
    (in that order).  The sets are static and the same on every rank.
    Differentiable: the backward is the reverse regroup, and an item
    that went to several ranks (or to several places) gets the sum of
    their gradients."""
    src = tuple(tuple(int(i) for i in s) for s in src)
    dst = tuple(tuple(int(i) for i in s) for s in dst)
    n = mesh.size(axes)
    me = mesh.index(axes)
    if src[me] == dst[me] and (n == 1 or src == dst):
        return x
    dim = dim % x.dim()
    everything = tuple(range(len(dst[me])))
    if (n > 1 and all(d == everything for d in dst)
            and src == block_sets(len(everything), True, n)):
        return col.all_gather(mesh, x, axes, dim=dim)
    return _Regroup.apply(x, mesh, axes, _plan(src, dst, me), len(dst[me]),
                          dim, n)


class _Regroup(torch.autograd.Function):
    """``regroup``'s general case: the rank's own items copied, the others
    moved by one uneven all-to-all; backward the same moves reversed, the
    gradients of an item summed over the places it went."""

    @staticmethod
    def forward(ctx, x, mesh, axes, plan, n_out, dim, n):
        send_idx, send_n, recv_n, local_src, local_dst, order = plan
        ctx.args = (mesh, axes, plan, x.shape[dim], dim, n)
        xm = x.movedim(dim, 0)
        out = xm.new_empty((n_out,) + tuple(xm.shape[1:]))
        if len(local_src):
            out[_index(local_dst, x)] = xm[_index(local_src, x)]
        if n > 1:
            got = col._all_to_all_v(mesh, xm[_index(send_idx, x)], axes,
                                    send_n, recv_n)
            if len(order):
                out[_index(order, x)] = got
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, plan, n_in, dim, n = ctx.args
        send_idx, send_n, recv_n, local_src, local_dst, order = plan
        gm = g.movedim(dim, 0)
        gx = gm.new_zeros((n_in,) + tuple(gm.shape[1:]))
        if len(local_src):
            gx.index_add_(0, _index(local_src, g), gm[_index(local_dst, g)])
        if n > 1:
            back = col._all_to_all_v(mesh, gm[_index(order, g)], axes,
                                     recv_n, send_n)
            if len(send_idx):
                gx.index_add_(0, _index(send_idx, g), back)
        return (gx.movedim(0, dim).contiguous(), None, None, None, None,
                None, None)


def _index(a: np.ndarray, like: Tensor) -> Tensor:
    """A host index array on ``like``'s device (a fake tensor's stand-in
    under the dry-run's fake mode, where only its shape counts)."""
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(like, FakeTensor):
        return torch.zeros(len(a), dtype=torch.long, device=like.device)
    return torch.from_numpy(a).to(like.device)
