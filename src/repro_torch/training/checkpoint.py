"""Tree checkpointing (params + optimizer state + step) with the JAX
package's flat leaf names.

Every leaf is stored under its '/'-joined tree path as the JAX package's
``training/checkpoint.py`` writes it (dict keys, list indices, and
``.field`` for a NamedTuple's fields such as ``AdamWState``'s), with dtype
and shape preserved; ``restore`` rebuilds into a template tree and raises
``KeyError`` on a missing leaf.  The file is a ``torch.save`` of the flat
dict of the leaves (the JAX package writes msgpack, which the port does
not use), written to a temporary name and renamed into place.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import torch

Tensor = torch.Tensor


def _flatten(tree, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[str, Tensor]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def leaf_names(tree) -> list:
    """The flat names ``save`` writes for ``tree``, in its order."""
    return [k for k, _ in _flatten(tree)]


def save(path: str, tree) -> None:
    # leaves stay where they are: torch.save copies one storage at a time
    # to the host, so a model on the card never has a whole host copy
    flat: Dict[str, Tensor] = {}
    for key, x in _flatten(tree):
        t = x if isinstance(x, Tensor) else torch.as_tensor(x)
        flat[key] = t.detach().contiguous()
    tmp = path + ".tmp"
    torch.save(flat, tmp)
    os.replace(tmp, path)


def restore(path: str, template, device=None):
    """The tree of ``template`` with every leaf read from ``path``, in the
    stored dtype, on ``device`` or else the template leaf's device (a
    template of ``meta`` tensors gives shapes without memory).  The file
    is memory-mapped and read leaf by leaf."""
    flat = torch.load(path, map_location="cpu", weights_only=True, mmap=True)

    def rebuild(t, prefix):
        if isinstance(t, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[rebuild(getattr(t, n), prefix + ("." + n,))
                             for n in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, prefix + (str(i),))
                           for i, v in enumerate(t))
        key = "/".join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        a = flat[key]
        want = tuple(t.shape) if isinstance(t, Tensor) else ()
        assert tuple(a.shape) == want, (key, tuple(a.shape), want)
        dev = device or (t.device if isinstance(t, Tensor) else "cpu")
        return a.to(dev, copy=True)

    return rebuild(template, ())
