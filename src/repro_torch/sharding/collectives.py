"""The mesh and its collectives over ``torch.distributed``.

``Mesh`` holds the axis sizes (JAX's names and order), this rank's
coordinates, a ``torch.distributed.device_mesh.DeviceMesh`` whose per-axis
process groups the collectives use, and a flattened group for every other
tuple of axes the model reduces over (JAX passes tuples such as
``("pod", "data")``).  A mesh without a process group (``Mesh(shape,
names)``) serves the spec functions and single-rank runs.

The collectives take one axis or a tuple of axes, and are identities over
axes of size 1.  They match ``jax.lax``'s tiled forms: ``all_gather``
concatenates the ranks' blocks along ``dim`` in rank order,
``reduce_scatter`` sums and keeps this rank's block of ``dim``,
``all_to_all`` splits ``split_dim`` into one block per rank and
concatenates what arrives along ``concat_dim``.  ``all_to_all_v`` moves
rows in uneven counts (``torch.distributed.all_to_all_single`` with
split sizes).

The collectives are differentiable (``torch.autograd.Function``s whose
backward is the forward's transpose): all-gather and reduce-scatter are
each other's, all-reduce is its own, an all-to-all's is the reverse
all-to-all (``split_dim`` and ``concat_dim`` swapped) and
``all_to_all_v``'s the same call with the send and receive counts
swapped.  The convention that makes those transposes the gradient: a
sharded step minimises the SUM over ranks of each rank's loss term, and
a term that every rank of an axis computes alike (the MoE aux loss,
which every rank holds; the cross entropy where the residual is whole
over ``model``) enters each rank's term divided by that axis's size.  A
parameter that a rank holds whole over some axes then has, on each
rank, its share of the gradient; the train step sums the shares over
those axes (``training/train.py``).  Integer tensors (counts, drops)
never require grad and stay outside autograd.

``RECORD`` notes each call's kind and result bytes on this rank, forward
and backward calls alike (the counterpart of the JAX package's
``analysis.collective_bytes``, which sums result-shape bytes of the
compiled program's collectives); ``reset_record`` clears it.  Under
``gloo`` the collectives take CUDA tensors as they are (gloo stages them
through the host itself).
"""

from __future__ import annotations

import itertools
import warnings
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
RECORD: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0}
                                     for k in KINDS}

# torch >= 2.12 names all_gather_into_tensor / reduce_scatter_tensor
# deprecated; the card's machine may have an older torch without the new
# names, so the port keeps the old ones
warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|"
                        r"reduce_scatter_tensor).*deprecated", category=FutureWarning)


def reset_record() -> None:
    for k in KINDS:
        RECORD[k] = {"calls": 0, "bytes": 0}


def record_totals() -> Dict[str, int]:
    """Result bytes by kind, and their total (the JAX analysis' keys)."""
    out = {k: RECORD[k]["bytes"] for k in KINDS}
    out["total"] = sum(out.values())
    return out


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """A mesh of ``shape`` over ``axis_names`` seen from global rank
    ``rank`` (row-major over the axes, the last fastest, as JAX and
    ``DeviceMesh`` number devices).  ``distributed=True`` builds the
    ``DeviceMesh`` and the flattened groups on the default process group,
    which must span exactly the mesh; every rank builds its mesh in the
    same order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, distributed: bool = False):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size_total = int(np.prod(list(self.shape.values())))
        self.rank = rank
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if distributed:
            self._build_groups()

    def _build_groups(self) -> None:
        from torch.distributed.device_mesh import init_device_mesh
        if dist.get_world_size() != self.size_total:
            raise ValueError(f"the process group has {dist.get_world_size()}"
                             f" ranks; the mesh {self.shape} needs "
                             f"{self.size_total}")
        self.device_mesh = init_device_mesh(
            "cpu", tuple(self.shape.values()), mesh_dim_names=self.axis_names)
        for a in self.axis_names:
            self._groups[(a,)] = self.device_mesh.get_group(a)
        self._groups[self.axis_names] = dist.group.WORLD
        ranks = np.arange(self.size_total).reshape(tuple(self.shape.values()))
        n = len(self.axis_names)
        for k in range(2, n):
            for sub in itertools.combinations(range(n), k):
                rest = [i for i in range(n) if i not in sub]
                blocks = np.transpose(ranks, rest + list(sub)).reshape(
                    -1, int(np.prod([ranks.shape[i] for i in sub])))
                mine, _ = dist.new_subgroups_by_enumeration(
                    [[int(r) for r in row] for row in blocks])
                self._groups[tuple(self.axis_names[i] for i in sub)] = mine

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name, a tuple or None) as the tuple of this mesh's
        axes among them, in mesh order."""
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self.axes(axes)] or [1]))

    def index(self, axes) -> int:
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        key = self.axes(axes)
        if key not in self._groups:
            raise ValueError(f"no process group over {key} (a mesh built "
                             "with distributed=True has one per axis tuple)")
        return self._groups[key]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _run(kind: str, fn, out: Tensor, *inputs: Tensor) -> Tensor:
    """Run ``fn(out, *inputs)`` and record it."""
    fn(out, *inputs)
    RECORD[kind]["calls"] += 1
    RECORD[kind]["bytes"] += _nbytes(out)
    return out


def _all_reduce(mesh: Mesh, x: Tensor, axes) -> Tensor:
    g = mesh.group(axes)
    return _run("all-reduce", lambda o: dist.all_reduce(o, group=g),
                x.contiguous().clone())


def _all_gather(mesh: Mesh, x: Tensor, axes, dim: int) -> Tensor:
    n, g = mesh.size(axes), mesh.group(axes)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _run("all-gather",
         lambda o, i: dist.all_gather_into_tensor(o, i, group=g), out, src)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(mesh: Mesh, x: Tensor, axes, dim: int) -> Tensor:
    n, g = mesh.size(axes), mesh.group(axes)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {n}")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _run("reduce-scatter",
         lambda o, i: dist.reduce_scatter_tensor(o, i, group=g), out, src)
    return out.movedim(0, dim).contiguous()


def _all_to_all(mesh: Mesh, x: Tensor, axes, split_dim: int,
                concat_dim: int) -> Tensor:
    n, g = mesh.size(axes), mesh.group(axes)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not divide over {n}")
    src = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0).contiguous()
    out = torch.empty_like(src)
    _run("all-to-all",
         lambda o, i: dist.all_to_all_single(o, i, group=g), out, src)
    # out[j] is source j's block (x's shape with split_dim cut n-fold)
    return out.movedim(0, concat_dim).flatten(
        concat_dim, concat_dim + 1).contiguous()


def _all_to_all_v(mesh: Mesh, x: Tensor, axes, send_counts: Sequence[int],
                  recv_counts: Sequence[int]) -> Tensor:
    g = mesh.group(axes)
    src = x.contiguous()
    out = src.new_empty((int(sum(recv_counts)),) + tuple(src.shape[1:]))
    _run("all-to-all",
         lambda o, i: dist.all_to_all_single(
             o, i, output_split_sizes=[int(c) for c in recv_counts],
             input_split_sizes=[int(c) for c in send_counts], group=g),
         out, src)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(ctx.mesh, g, ctx.axes, ctx.dim), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return _all_to_all(mesh, x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (_all_to_all(mesh, g, axes, concat_dim, split_dim), None, None,
                None, None)


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, send_counts, recv_counts):
        ctx.args = (mesh, axes, send_counts, recv_counts)
        return _all_to_all_v(mesh, x, axes, send_counts, recv_counts)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, send_counts, recv_counts = ctx.args
        return (_all_to_all_v(mesh, g, axes, recv_counts, send_counts), None,
                None, None, None)


def all_reduce(mesh: Mesh, x: Tensor, axes) -> Tensor:
    """Sum over ``axes``; returns a new tensor (``x`` is not changed)."""
    if mesh.size(axes) <= 1:
        return x
    return _AllReduce.apply(x, mesh, axes)


def all_reduce_max(mesh: Mesh, x: Tensor, axes) -> Tensor:
    """Elementwise maximum over ``axes``, outside autograd (a detached
    result: the callers use it as a constant shift)."""
    if mesh.size(axes) <= 1:
        return x.detach()
    g = mesh.group(axes)
    return _run("all-reduce",
                lambda o: dist.all_reduce(o, op=dist.ReduceOp.MAX, group=g),
                x.detach().contiguous().clone())


def all_gather(mesh: Mesh, x: Tensor, axes, dim: int = 0) -> Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` in rank order."""
    if mesh.size(axes) <= 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter(mesh: Mesh, x: Tensor, axes, dim: int = 0) -> Tensor:
    """Sum over ``axes`` and keep this rank's block of ``dim``."""
    if mesh.size(axes) <= 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)


def all_to_all(mesh: Mesh, x: Tensor, axes, split_dim: int,
               concat_dim: int) -> Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: block j of ``split_dim``
    goes to rank j; the blocks received are concatenated along
    ``concat_dim`` in source order."""
    if mesh.size(axes) <= 1:
        return x
    return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim)


def all_to_all_v(mesh: Mesh, x: Tensor, axes, send_counts: Sequence[int],
                 recv_counts: Sequence[int]) -> Tensor:
    """Rows of ``x`` (dim 0) in uneven counts: the first ``send_counts[0]``
    rows go to rank 0, the next to rank 1, ...; the result holds
    ``recv_counts[j]`` rows from each rank j, in source order."""
    if mesh.size(axes) <= 1:
        return x
    return _AllToAllV.apply(x, mesh, axes, tuple(send_counts),
                            tuple(recv_counts))
