"""Block-level dispatch: one decoder block = mixer (GQA or MLA attention,
RecurrentGemma's RG-LRU, xLSTM's mLSTM or sLSTM) + optional cross-
attention (whisper's decoder) + FFN (dense, MoE or none), pre-norm
residual style.  ``apply_block`` is the single entry point of both
execution paths: the full forward and the engine's ``run_blocks(start,
n)`` partial vertical execution (layered prefill).  Every mixer writes its
cache (KV rows or recurrent state) in place; the cross-attention K/V are
read, never written, here."""

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
                enc_out: Optional[Tensor] = None,
                valid: Optional[Tensor] = None,
                positions3: Optional[Tensor] = None, dropless: bool = False,
                moe_dispatch: str = "ragged", lay=None
                ) -> Tuple[Tensor, Optional[dict], dict]:
    """x: (B,S,D) -> (x', cache (updated in place), aux).  A cross-
    attention block attends over ``enc_out``'s K/V when it is given, else
    over the cache's ``xk``/``xv``.  ``lay`` (under a sharding context,
    ``sharding/spmd.py``): x is this rank's block of the residual and the
    block runs over the rank's shards, every mixer, the cross-attention
    and every FFN alike."""
    h = layers.apply_norm(cfg, p["ln1"], x)
    if spec.mixer == MIXER_RGLRU:
        out, new_cache = rglru.apply_rglru(cfg, p["rglru"], h, cache=cache,
                                           valid=valid, lay=lay)
    elif spec.mixer == MIXER_MLSTM:
        out, new_cache = xlstm.apply_mlstm(cfg, p["lstm"], h, cache=cache,
                                           valid=valid, lay=lay)
    elif spec.mixer == MIXER_SLSTM:
        out, new_cache = xlstm.apply_slstm(cfg, p["lstm"], h, cache=cache,
                                           valid=valid, lay=lay)
    else:
        kw = {} if positions3 is None else {"positions3": positions3}
        if lay is not None:
            kw["lay"] = lay
        out, new_cache = attention.apply_mixer_attn(
            cfg, spec, p["attn"], h, positions=positions, offset=offset,
            cache=cache, valid=valid, **kw)
    x = x + out
    if spec.cross_attn:
        hx = layers.apply_norm(cfg, p["attn"]["x_norm"], x)
        # fresh encoder output takes precedence over the cached cross K/V
        if enc_out is not None:
            xk, xv = attention.encode_cross_kv(cfg, p["attn"], enc_out)
            xc = {"xk": xk, "xv": xv}
        elif cache is not None and "xk" in cache:
            xc = cache
        else:
            raise ValueError("cross-attention needs enc_out or cached K/V")
        x = x + attention.apply_cross_attn(cfg, p["attn"], hx, xc, lay=lay)
    aux = moe.empty_moe_aux(cfg, x.device)
    if spec.ffn != FFN_NONE:
        h2 = layers.apply_norm(cfg, p["ln2"], x)
        if spec.ffn == FFN_MOE:
            out2, aux = moe.apply_moe(cfg, p["moe"], h2, valid=valid,
                                      dropless=dropless,
                                      moe_dispatch=moe_dispatch, lay=lay)
        else:
            out2 = layers.apply_mlp(cfg, p["mlp"], h2, lay=lay)
        x = x + out2
    return x, new_cache, aux
