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
port against the JAX package goes through here.  ``from_jax_opt_state``
does the same for the JAX package's ``AdamWState`` (step, mu, nu), so a
JAX run's ``(params, opt)`` can continue in the port.  ``shard_params``,
``shard_cache`` and ``shard_moments`` cut whole trees to one rank's
blocks (parameter, cache and ZeRO-1 moment specs); ``gather_params``,
called on every rank, puts blocks back together into whole leaves.
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


def shard_params(params, mesh, coords=None, rules=None):
    """One rank's local shards of the parameter tree ``params`` (the
    port's tree, e.g. ``from_jax_params``' output): each leaf cut to the
    rank's block under ``partition.param_specs`` (``coords``: the rank's
    coordinates, by default the mesh's own), so a sharded port and an
    unsharded forward compute the same function."""
    from repro_torch.sharding.partition import (local_shard,
                                                map_with_specs, param_specs)
    return map_with_specs(lambda x, s: local_shard(x, s, mesh, coords),
                          params, param_specs(params, mesh, rules))


def shard_cache(cache, mesh, batch: int, coords=None, rules=None):
    """One rank's block of a cache tree (``DecoderModel.init_cache``'s
    layout) under ``partition.cache_specs`` for a call of global
    ``batch`` rows."""
    from repro_torch.sharding.partition import (cache_specs, local_shard,
                                                map_with_specs)
    return map_with_specs(lambda x, s: local_shard(x, s, mesh, coords),
                          cache, cache_specs(cache, mesh, batch, rules))


def from_jax_opt_state(cfg: ModelConfig, state, device=None):
    """The JAX package's ``AdamWState`` (a NamedTuple of ``step`` and the
    fp32 moment trees ``mu``/``nu``, its leaves turned into numpy arrays)
    -> the port's ``training.optimizer.AdamWState`` on ``device``."""
    from repro_torch.training.optimizer import AdamWState
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step=step, mu=from_jax_params(cfg, state.mu, dev),
                      nu=from_jax_params(cfg, state.nu, dev))


def shard_moments(state, mesh, coords=None, rules=None):
    """One rank's ZeRO-1 shards of an optimizer state whose moments are
    whole (the port's ``AdamWState``, e.g. ``from_jax_opt_state``'s
    output): each moment leaf cut to the rank's block under
    ``partition.moment_specs``; the step is kept."""
    from repro_torch.sharding.partition import (local_shard, map_with_specs,
                                                moment_specs)
    from repro_torch.training.optimizer import AdamWState
    specs = moment_specs(state.mu, mesh, rules)

    def cut(tree):
        return map_with_specs(lambda x, s: local_shard(x, s, mesh, coords),
                              tree, specs)
    return AdamWState(step=state.step, mu=cut(state.mu), nu=cut(state.nu))


def gather_params(tree, mesh, specs):
    """Whole leaves from this rank's blocks: every rank calls it (a
    collective over the mesh's groups) with its blocks of ``tree`` laid
    out by ``specs`` (``param_specs`` or ``moment_specs`` of the whole
    tree), and gets every leaf whole, each dim gathered over the axes its
    spec entry names (major to minor, as the blocks lie)."""
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding.partition import map_with_specs

    def whole(x, spec):
        with torch.no_grad():
            for i, e in enumerate(spec):
                if e is not None:
                    x = col.all_gather(mesh, x, e, dim=i)
        return x
    return map_with_specs(whole, tree, specs)
