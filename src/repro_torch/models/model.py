"""DecoderModel: the model runtime of the port.

Two execution paths over the same block definitions:

- ``forward``: the full stack, a Python loop over blocks (the JAX
  package's ``lax.scan`` over segments has no counterpart PyTorch needs).
- ``run_blocks(start, n)``: blocks [start, start+n) with boundary
  activations in and out — the primitive layered prefill schedules over.

Parameters are a plain dict with the JAX package's structure and layouts:
``params["segments"][s]["pattern"][p]`` holds one block's parameters
stacked over the segment's repeats (leading axis ``reps``).  Caches mirror
it: ``cache[s][p]`` is ``{"k", "v"}`` of shape (reps, batch, S_max, Hkv,
hd), or MLA's ``{"ckv", "kr"}`` of shape (reps, batch, S_max, width), or
a recurrent mixer's state, which has no position axis: RG-LRU's
``{"conv", "h"}``, mLSTM's ``{"C", "n", "m", "conv"}``, sLSTM's ``{"c",
"n", "h", "m"}``, each (reps, batch, ...).  ``recurrent[s][p]`` says which
blocks hold state rather than KV rows.  A stack with a dense first block
has two segments once it is deeper than the 16-block period search
(deepseek-v2-236b at full depth: 1 + 59).  Cache updates happen in place
(see models/attention.py, models/rglru.py, models/xlstm.py).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import blocks, layers
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


class DecoderModel:
    def __init__(self, cfg: ModelConfig, device=None):
        """``device`` defaults to ``cuda`` (raises without CUDA); pass
        ``"cpu"`` to run the plain versions on the CPU."""
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        self.specs = cfg.block_specs()
        self.segments = cfg.scan_segments()
        self.index_map = cfg.block_index_map()
        self.n_blocks = cfg.n_layers
        # per segment and pattern position: True where the block's cache
        # is recurrent state (no position axis) rather than KV rows
        self.recurrent = [[sp.is_recurrent() for sp in pattern]
                          for pattern, _ in self.segments]
        if cfg.encoder.enabled or cfg.vision.enabled \
                or cfg.pos_emb == "learned":
            raise NotImplementedError(
                f"{cfg.name}: the torch port runs decoder-only stacks "
                "without learned positions (no encoder, no vision stub)")

    # -- init ---------------------------------------------------------------

    def init_params(self, generator: Optional[torch.Generator] = None) -> dict:
        """Random parameters with the JAX package's distributions (normal x
        1/sqrt(fan_in); 0.02 for router and embeddings; RG-LRU's
        ``a_param`` and the xLSTM gate biases as in models/rglru.py and
        models/xlstm.py), drawn directly in
        ``param_dtype`` on the model's device from ``generator`` (a
        ``torch.Generator`` on that device; seed 0 when omitted)."""
        cfg, dev = self.cfg, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params: dict = {"embed": layers.init_embed(cfg, dev, generator),
                        "final_norm": layers.init_norm(cfg, dev)}
        params["segments"] = [
            {"pattern": [blocks.init_block(cfg, sp, dev, generator, reps=reps)
                         for sp in pattern]}
            for pattern, reps in self.segments]
        return params

    def init_cache(self, batch: int, max_len: int, dtype=None) -> list:
        """Zeroed KV rows and recurrent state at its init values (the
        stabilizers' -1e30 included), repeated over each segment's reps."""
        dt = dtype or torch_dtype(self.cfg.dtype)
        cache = []
        for pattern, reps in self.segments:
            seg = []
            for sp in pattern:
                c = blocks.init_block_cache(self.cfg, sp, batch, max_len,
                                            self.device, dt)
                seg.append({k: v[None].repeat((reps,) + (1,) * v.dim())
                            for k, v in c.items()})
            cache.append(seg)
        return cache

    # -- embedding / head ----------------------------------------------------

    def embed(self, params, tokens: Tensor) -> Tensor:
        return layers.embed_tokens(self.cfg, params["embed"], tokens)

    def logits(self, params, x: Tensor) -> Tensor:
        x = layers.apply_norm(self.cfg, params["final_norm"], x)
        return layers.unembed(self.cfg, params["embed"], x)

    # -- execution -----------------------------------------------------------

    def block_params(self, params, b: int) -> dict:
        s, r, p_idx = self.index_map[b]
        return _index(params["segments"][s]["pattern"][p_idx], r)

    def run_blocks(self, params, x: Tensor, start: int, n: int, *,
                   positions: Tensor, offset: Optional[Tensor] = None,
                   cache: Optional[list] = None,
                   valid: Optional[Tensor] = None, dropless: bool = False,
                   moe_dispatch: str = "ragged"):
        """Run blocks [start, start+n) over x (B, S, D).  Returns (x', cache,
        aux-list-in-block-order); ``cache`` (leaves (reps, B, ...)) is
        updated in place.  Rows are independent: the engine's packed
        layer-group path runs every prefill slice sharing this block range
        as one batch, with per-row ``offset``/``valid`` masking and
        bucket-padded rows that are no-ops end to end."""
        auxes = []
        for b in range(start, start + n):
            s, r, p_idx = self.index_map[b]
            c = (_index(cache[s][p_idx], r) if cache is not None else None)
            x, _, aux = blocks.apply_block(
                self.cfg, self.specs[b], self.block_params(params, b), x,
                positions=positions, offset=offset, cache=c, valid=valid,
                dropless=dropless, moe_dispatch=moe_dispatch)
            auxes.append(aux)
        return x, cache, auxes

    def forward(self, params, tokens: Tensor, *,
                positions: Optional[Tensor] = None,
                offset: Optional[Tensor] = None,
                cache: Optional[list] = None,
                valid: Optional[Tensor] = None, dropless: bool = False,
                moe_dispatch: str = "ragged"):
        """tokens (B, S) -> (logits (B, S, V) fp32, cache, aux) with
        ``aux["expert_counts"]`` of shape (L, E)."""
        b, s = tokens.shape
        if offset is None and cache is not None:
            offset = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
        if positions is None:
            base = offset.long() if offset is not None else torch.zeros(
                (b,), dtype=torch.long, device=tokens.device)
            positions = base[:, None] + torch.arange(s, device=tokens.device)[None]
        x = self.embed(params, tokens)
        x, cache, auxes = self.run_blocks(
            params, x, 0, self.n_blocks, positions=positions, offset=offset,
            cache=cache, valid=valid, dropless=dropless,
            moe_dispatch=moe_dispatch)
        aux = {
            "expert_counts": torch.stack([a["expert_counts"] for a in auxes]),
            "aux_loss": sum(a["aux_loss"] for a in auxes),
            "dropped": sum(a["dropped"] for a in auxes),
        }
        return self.logits(params, x), cache, aux
