"""Production mesh construction, with the JAX package's shapes and axis
names (``repro/launch/mesh.py``):

Single pod: (16, 16) = 256 ranks, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model) — the ``pod``
axis is pure data parallelism.

Functions, not module constants: importing this module touches no process
group.  ``distributed=True`` builds the mesh's process groups on the
default group (``torch.distributed.init_process_group`` first, with one
rank per mesh position); without it the mesh serves the spec functions.
On 8-GPU H100 nodes a 16-way ``model`` axis spans two nodes.
"""

from __future__ import annotations

from repro_torch.sharding.collectives import Mesh


def production_shape(multi_pod: bool = False):
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


def make_production_mesh(multi_pod: bool = False, *, rank: int = 0,
                         distributed: bool = False) -> Mesh:
    shape, axes = production_shape(multi_pod)
    return Mesh(shape, axes, rank=rank, distributed=distributed)


def make_local_mesh() -> Mesh:
    """1-rank mesh with the same axis names (tests / single-card runs)."""
    return Mesh((1, 1), ("data", "model"))


def make_mesh(shape, axes, *, rank: int = 0,
              distributed: bool = False) -> Mesh:
    """Any mesh: ``shape`` over ``axes`` (e.g. (2, 8) over data, model)."""
    return Mesh(shape, axes, rank=rank, distributed=distributed)
