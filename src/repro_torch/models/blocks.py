"""Block-level dispatch: one decoder block = mixer (GQA or MLA attention,
RecurrentGemma's RG-LRU, xLSTM's mLSTM or sLSTM) + FFN (dense, MoE or
none), pre-norm residual style.  ``apply_block`` is the single entry point
of both execution paths: the full forward and the engine's
``run_blocks(start, n)`` partial vertical execution (layered prefill).
Every mixer writes its cache (KV rows or recurrent state) in place.
Cross-attention raises ``NotImplementedError``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import attention, layers, moe, rglru, xlstm
from repro_torch.models.config import (FFN_MOE, FFN_NONE, MIXER_MLSTM,
                                       MIXER_RGLRU, MIXER_SLSTM, BlockSpec,
                                       ModelConfig)

Tensor = torch.Tensor


def init_block(cfg: ModelConfig, spec: BlockSpec, device, generator,
               reps: int = 0) -> dict:
    """One block's parameters; ``reps > 0`` gives every leaf a leading
    axis of ``reps`` independently drawn copies (a segment's stack)."""
    p = {"ln1": layers.init_norm(cfg, device, reps=reps)}
    if spec.mixer == MIXER_RGLRU:
        p["rglru"] = rglru.init_rglru(cfg, device, generator, reps=reps)
    elif spec.mixer == MIXER_MLSTM:
        p["lstm"] = xlstm.init_mlstm(cfg, device, generator, reps=reps)
    elif spec.mixer == MIXER_SLSTM:
        p["lstm"] = xlstm.init_slstm(cfg, device, generator, reps=reps)
    else:
        p["attn"] = attention.init_attn(cfg, spec, device, generator,
                                        reps=reps)
    if spec.ffn != FFN_NONE:
        p["ln2"] = layers.init_norm(cfg, device, reps=reps)
        if spec.ffn == FFN_MOE:
            p["moe"] = moe.init_moe(cfg, device, generator, reps=reps)
        else:
            p["mlp"] = layers.init_mlp(cfg, device, generator, reps=reps)
    return p


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     max_len: int, device, dtype=None) -> dict:
    if spec.mixer == MIXER_RGLRU:
        return rglru.init_cache_rglru(cfg, batch, device, dtype)
    if spec.mixer == MIXER_MLSTM:
        return xlstm.init_cache_mlstm(cfg, batch, device, dtype)
    if spec.mixer == MIXER_SLSTM:
        return xlstm.init_cache_slstm(cfg, batch, device, dtype)
    return attention.init_cache_attn(cfg, spec, batch, max_len, device, dtype)


def apply_block(cfg: ModelConfig, spec: BlockSpec, p, x: Tensor, *,
                positions: Tensor, offset: Optional[Tensor] = None,
                cache: Optional[dict] = None,
                valid: Optional[Tensor] = None, dropless: bool = False,
                moe_dispatch: str = "ragged"
                ) -> Tuple[Tensor, Optional[dict], dict]:
    """x: (B,S,D) -> (x', cache (updated in place), aux)."""
    h = layers.apply_norm(cfg, p["ln1"], x)
    if spec.mixer == MIXER_RGLRU:
        out, new_cache = rglru.apply_rglru(cfg, p["rglru"], h, cache=cache,
                                           valid=valid)
    elif spec.mixer == MIXER_MLSTM:
        out, new_cache = xlstm.apply_mlstm(cfg, p["lstm"], h, cache=cache,
                                           valid=valid)
    elif spec.mixer == MIXER_SLSTM:
        out, new_cache = xlstm.apply_slstm(cfg, p["lstm"], h, cache=cache,
                                           valid=valid)
    else:
        out, new_cache = attention.apply_mixer_attn(
            cfg, spec, p["attn"], h, positions=positions, offset=offset,
            cache=cache, valid=valid)
    x = x + out
    aux = moe.empty_moe_aux(cfg, x.device)
    if spec.ffn != FFN_NONE:
        h2 = layers.apply_norm(cfg, p["ln2"], x)
        if spec.ffn == FFN_MOE:
            out2, aux = moe.apply_moe(cfg, p["moe"], h2, valid=valid,
                                      dropless=dropless,
                                      moe_dispatch=moe_dispatch)
        else:
            out2 = layers.apply_mlp(cfg, p["mlp"], h2)
        x = x + out2
    return x, new_cache, aux
