"""Weight bridge: the JAX package's parameter pytree -> the port's dict.

``from_jax_params(cfg, tree)`` takes the tree ``repro.models.model.
DecoderModel(cfg).init(key)`` returns, with its leaves already turned into
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), and returns
the same structure with torch tensors: the stacked ``(reps, ...)`` segment
leaves stay stacked, and every layout is unchanged (``x @ W`` with ``W`` of
shape ``(d_in, d_out)``; MLA's leaves are such matrices and norm dicts;
the recurrent mixers' fp32 leaves, RG-LRU's ``a_param``, stay fp32;
whisper's ``encoder`` list of unstacked blocks and the learned position
table ``embed["pos"]`` come across as they are).
JAX's PRNG cannot be reproduced in torch, so every test that holds the
port against the JAX package goes through here.
This module imports numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: no numpy
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(cfg: ModelConfig, tree, device=None):
    """numpy pytree (dicts / lists of arrays) -> the same tree of tensors
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _to_torch(x, dev)
    return conv(tree)
