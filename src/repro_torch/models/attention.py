"""GQA attention mixer with the slot-row KV-cache protocol.

Cache per attention block: ``{"k": (B, S_max, Hkv, hd), "v": ...}``.  The
caller tracks the filled length as ``offset`` (B,): the S new tokens are
written at ``[offset, offset + S)`` of each row and attention covers
positions ``< offset + S`` under the causal (and window) mask.

Unlike the JAX package, cache updates happen IN PLACE: ``apply_gqa``
writes the new K/V into the tensors it is given (views into the engine's
preallocated pool) and returns the same dict.  This stands in for the
JAX engine's donated buffers.

Attention runs through ``kernels.ops``: ``decode_attention`` when S == 1,
``prefill_attention`` otherwise — hand-written kernels for CUDA tensors,
the plain ``masked_attention`` (kernels/ref.py) for CPU tensors.  Both kernels take the
query positions to be ``offset + arange(S)``, which is what every caller
passes (the engine, ``DecoderModel.forward``); RoPE uses ``positions``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import MIXER_GQA, MIXER_LOCAL, BlockSpec, ModelConfig

Tensor = torch.Tensor


def init_attn(cfg: ModelConfig, spec: BlockSpec, device, generator,
              reps: int = 0) -> dict:
    _check_spec(spec)
    d, hd = cfg.d_model, cfg.head_dim_
    dt = torch_dtype(cfg.param_dtype)

    def w(shape):
        return layers.dense_init(shape, dt, device, generator, reps=reps)
    return {"w_q": w((d, cfg.n_heads * hd)), "w_k": w((d, cfg.n_kv_heads * hd)),
            "w_v": w((d, cfg.n_kv_heads * hd)), "w_o": w((cfg.n_heads * hd, d))}


def init_cache_attn(cfg: ModelConfig, spec: BlockSpec, batch: int,
                    max_len: int, device, dtype=None) -> dict:
    _check_spec(spec)
    dt = dtype or torch_dtype(cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer not in (MIXER_GQA, MIXER_LOCAL) or spec.cross_attn:
        raise NotImplementedError(
            f"the torch port runs GQA attention only (mixer {spec.mixer!r}, "
            f"cross_attn={spec.cross_attn})")


def _write_cache(buf: Tensor, new: Tensor, offset: Tensor,
                 tok_ok: Optional[Tensor] = None) -> Tensor:
    """Write ``new`` (B, S, ...) into ``buf`` (B, S_max, ...) at per-row
    offsets, IN PLACE; returns ``buf``.  Tokens with ``tok_ok == False``
    and tokens at positions >= S_max are DROPPED (their slots keep their
    contents) — the JAX ``.at[].set(mode="drop")`` scatter, which
    ``index_put_`` cannot express because it raises on out-of-range
    indices.

    Dropped tokens write back the value already at ``(offset + i) % S_max``.
    Those targets are distinct within a row (S <= S_max consecutive
    positions modulo S_max), so the scatter has no duplicate indices and
    needs no host sync."""
    b, s = new.shape[:2]
    s_max = buf.shape[1]
    if s > s_max:
        raise ValueError(f"cannot write {s} tokens into a {s_max}-row cache")
    pos = offset.long()[:, None] + torch.arange(s, device=buf.device)[None]
    keep = pos < s_max
    if tok_ok is not None:
        keep = keep & tok_ok
    tgt = pos % s_max
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    old = buf[rows, tgt]
    shape = keep.shape + (1,) * (new.dim() - 2)
    buf[rows, tgt] = torch.where(keep.view(shape), new.to(buf.dtype), old)
    return buf


def apply_gqa(cfg: ModelConfig, spec: BlockSpec, p, x: Tensor, *,
              positions: Tensor, offset: Optional[Tensor] = None,
              cache: Optional[dict] = None,
              valid: Optional[Tensor] = None) -> Tuple[Tensor, Optional[dict]]:
    """x: (B, S, D).  With a cache: writes the S new tokens at ``offset``
    (in place) and attends over the whole masked cache row.  Without:
    plain causal attention over x."""
    _check_spec(spec)
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ p["w_q"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["w_k"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["w_v"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.pos_emb in ("rope", "rope_partial"):
        pct = cfg.rotary_pct if cfg.pos_emb == "rope_partial" else 1.0
        q = layers.apply_rope(q, positions, cfg.rope_theta, pct)
        k = layers.apply_rope(k, positions, cfg.rope_theta, pct)
    elif cfg.pos_emb != "none":
        raise NotImplementedError(f"pos_emb {cfg.pos_emb!r} is not ported")

    if cache is not None:
        kbuf = _write_cache(cache["k"], k, offset, valid)
        vbuf = _write_cache(cache["v"], v, offset, valid)
        off32 = offset.to(torch.int32)
        if s == 1:
            out = ops.decode_attention(q[:, 0].contiguous(), kbuf, vbuf,
                                       off32 + 1, window=spec.window)[:, None]
        else:
            out = ops.prefill_attention(q.contiguous(), kbuf, vbuf, off32,
                                        window=spec.window)
        new_cache = cache
    else:
        zeros = torch.zeros((b,), dtype=torch.int32, device=x.device)
        out = ops.prefill_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), zeros,
                                    window=spec.window)
        new_cache = None
    return out.reshape(b, s, -1) @ p["w_o"], new_cache
