"""The weights of a run, made by the benchmark from ``--seed``: every
leaf the port's model declares (its parameter tree, shapes and dtypes
read on the meta device), drawn on the device with one ``torch.Generator``
in the dtype it is served in, one call a leaf (the port stacks each
segment's layers, so a leaf holds every layer's copy of a matrix).

Matrices are normal with standard deviation 1/sqrt(fan-in) (the
second-to-last dim), the embedding and the router 0.02; norm scales are
1.  The port and the reference read the same tensors: ``Weights`` gives
the reference one layer's leaves by name, block by block."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

Tensor = torch.Tensor


def leaves(tree, path: str = "") -> Iterator[Tuple[str, object, object]]:
    """(path, container, key) of every leaf, in a fixed order."""
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    for k, v in items:
        p = f"{path}/{k}" if path else str(k)
        if isinstance(v, (dict, list)):
            yield from leaves(v, p)
        else:
            yield p, tree, k


def std_of(path: str, shape) -> float:
    name = path.rsplit("/", 1)[-1]
    if name in ("tok", "router", "pos"):
        return 0.02
    return 1.0 / math.sqrt(shape[-2])


def draw(shapes: dict, seed: int, device) -> dict:
    """The tree ``shapes`` (meta tensors) filled on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = _copy(shapes)
    for path, holder, key in leaves(out):
        t = holder[key]
        if path.endswith("/scale"):
            holder[key] = torch.ones(t.shape, dtype=t.dtype, device=device)
        elif path.endswith("/bias"):
            holder[key] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        else:
            holder[key] = torch.randn(t.shape, dtype=t.dtype, device=device,
                                      generator=gen).mul_(
                                          std_of(path, t.shape))
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def nbytes(tree) -> int:
    return sum(h[k].numel() * h[k].element_size() for _, h, k in leaves(tree))


class Weights:
    """The reference's view of the tree: layer ``i``'s leaves by name
    (the segments' stacks walked in order: each segment's repeats, each
    repeat's pattern of blocks)."""

    def __init__(self, params: dict):
        self.params = params
        self._where = []
        for s, seg in enumerate(params["segments"]):
            pattern = seg["pattern"]
            reps = next(iter(leaves(pattern[0])))
            reps = reps[1][reps[2]].shape[0]
            for r in range(reps):
                for p in range(len(pattern)):
                    self._where.append((s, p, r))

    @property
    def n_layers(self) -> int:
        return len(self._where)

    def layer(self, i: int) -> Dict[str, Tensor]:
        s, p, r = self._where[i]
        block = self.params["segments"][s]["pattern"][p]
        return {path: h[k][r] for path, h, k in leaves(block)}

    def embed(self) -> Tensor:
        return self.params["embed"]["tok"]

    def lm_head(self) -> Tensor:
        e = self.params["embed"]
        return e["lm_head"] if "lm_head" in e else e["tok"].t()

    def final_norm(self) -> Tensor:
        return self.params["final_norm"]["scale"]
