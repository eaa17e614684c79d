"""Attention mixers with the slot-row KV-cache protocol: GQA (full or
sliding-window), DeepSeek-V2 multi-head latent attention (MLA), and
whisper's cross-attention over the encoder's frames.

Cache per attention block:
  GQA: ``{"k": (B, S_max, Hkv, hd), "v": (B, S_max, Hkv, hd)}``
  MLA: ``{"ckv": (B, S_max, kv_lora), "kr": (B, S_max, rope_dim)}``
  cross (beside GQA's, written once at admission, then read-only):
  ``{"xk": (B, n_frames, Hkv, hd), "xv": (B, n_frames, Hkv, hd)}``
The caller tracks the filled length as ``offset`` (B,): the S new tokens
are written at ``[offset, offset + S)`` of each row and attention covers
positions ``< offset + S`` under the causal (and window) mask.

Unlike the JAX package, cache updates happen IN PLACE: ``apply_gqa`` and
``apply_mla`` write the new entries into the tensors they are given (views
into the engine's preallocated pool) and return the same dict.  This
stands in for the JAX engine's donated buffers.

Attention runs through ``kernels.ops``: ``decode_attention`` when S == 1,
``prefill_attention`` otherwise — hand-written kernels for CUDA tensors,
the plain ``masked_attention`` (kernels/ref.py) for CPU tensors.  Both kernels take the
query positions to be ``offset + arange(S)``, which is what every caller
passes (the engine, ``DecoderModel.forward``); RoPE uses ``positions``
(M-RoPE ``positions3``, by default three equal planes of ``positions``;
learned positions are added at the embedding, so "learned" and "none"
rotate nothing).  Cross-attention sees every frame: prefill attention
with ``causal=False`` for S > 1, decode attention at lengths = n_frames
for one token.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import (MIXER_GQA, MIXER_LOCAL, MIXER_MLA,
                                       BlockSpec, ModelConfig)

Tensor = torch.Tensor


def init_attn(cfg: ModelConfig, spec: BlockSpec, device, generator,
              reps: int = 0) -> dict:
    _check_spec(spec)
    d, hd = cfg.d_model, cfg.head_dim_
    dt = torch_dtype(cfg.param_dtype)

    def w(shape):
        return layers.dense_init(shape, dt, device, generator, reps=reps)
    if spec.mixer == MIXER_MLA:
        m, h = cfg.mla, cfg.n_heads
        qdim = h * (m.qk_nope_dim + m.qk_rope_dim)
        p = {}
        if m.q_lora_rank:
            p["w_dq"] = w((d, m.q_lora_rank))
            p["q_norm"] = layers.init_norm(cfg, device, dim=m.q_lora_rank,
                                           reps=reps)
            p["w_uq"] = w((m.q_lora_rank, qdim))
        else:
            p["w_q"] = w((d, qdim))
        p["w_dkv"] = w((d, m.kv_lora_rank))
        p["kv_norm"] = layers.init_norm(cfg, device, dim=m.kv_lora_rank,
                                        reps=reps)
        p["w_kr"] = w((d, m.qk_rope_dim))
        p["w_uk"] = w((m.kv_lora_rank, h * m.qk_nope_dim))
        p["w_uv"] = w((m.kv_lora_rank, h * m.v_head_dim))
        p["w_o"] = w((h * m.v_head_dim, d))
        return p
    return {"w_q": w((d, cfg.n_heads * hd)), "w_k": w((d, cfg.n_kv_heads * hd)),
            "w_v": w((d, cfg.n_kv_heads * hd)),
            "w_o": w((cfg.n_heads * hd, d)),
            **({"x_q": w((d, cfg.n_heads * hd)),
                "x_k": w((d, cfg.n_kv_heads * hd)),
                "x_v": w((d, cfg.n_kv_heads * hd)),
                "x_o": w((cfg.n_heads * hd, d)),
                "x_norm": layers.init_norm(cfg, device, reps=reps)}
               if spec.cross_attn else {})}


def init_cache_attn(cfg: ModelConfig, spec: BlockSpec, batch: int,
                    max_len: int, device, dtype=None) -> dict:
    _check_spec(spec)
    dt = dtype or torch_dtype(cfg.dtype)
    if spec.mixer == MIXER_MLA:
        m = cfg.mla
        return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                   dtype=dt, device=device),
                "kr": torch.zeros((batch, max_len, m.qk_rope_dim),
                                  dtype=dt, device=device)}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    c = {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
    if spec.cross_attn:
        xshape = (batch, cfg.encoder.n_frames, cfg.n_kv_heads, cfg.head_dim_)
        c["xk"] = torch.zeros(xshape, dtype=dt, device=device)
        c["xv"] = torch.zeros(xshape, dtype=dt, device=device)
    return c


# the cross-attention cache leaves: a frame axis, not a position axis
CROSS_LEAVES = ("xk", "xv")


def _check_spec(spec: BlockSpec) -> None:
    if spec.mixer not in (MIXER_GQA, MIXER_LOCAL, MIXER_MLA) \
            or spec.cross_attn and spec.mixer == MIXER_MLA:
        raise NotImplementedError(
            f"the torch port runs GQA and MLA attention, and cross-"
            f"attention beside GQA (mixer {spec.mixer!r}, "
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
              valid: Optional[Tensor] = None,
              positions3: Optional[Tensor] = None,
              causal: bool = True) -> Tuple[Tensor, Optional[dict]]:
    """x: (B, S, D).  With a cache: writes the S new tokens at ``offset``
    (in place) and attends over the whole masked cache row.  Without:
    plain attention over x, causal unless ``causal=False`` (the encoder's
    bidirectional self-attention)."""
    _check_spec(spec)
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ p["w_q"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["w_k"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["w_v"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.pos_emb == "mrope":
        p3 = positions3 if positions3 is not None \
            else layers.position_plane(positions)
        q = layers.apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.pos_emb in ("rope", "rope_partial"):
        pct = cfg.rotary_pct if cfg.pos_emb == "rope_partial" else 1.0
        q = layers.apply_rope(q, positions, cfg.rope_theta, pct)
        k = layers.apply_rope(k, positions, cfg.rope_theta, pct)
    elif cfg.pos_emb not in ("learned", "none"):
        raise NotImplementedError(f"pos_emb {cfg.pos_emb!r} is not ported")

    if cache is not None:
        k = _write_cache(cache["k"], k, offset, valid)
        v = _write_cache(cache["v"], v, offset, valid)
    out = _attend(q, k, v, offset, cache is not None, spec.window, causal)
    return out.reshape(b, s, -1) @ p["w_o"], cache


def _attend(q: Tensor, k: Tensor, v: Tensor, offset: Optional[Tensor],
            cached: bool, window: Optional[int],
            causal: bool = True) -> Tensor:
    """q (B, S, H, dk) over k (B, S_kv, Hkv, dk) / v (B, S_kv, Hkv, dv) ->
    (B, S, H, dv) through the kernels: decode attention for one token over
    the cache, prefill attention otherwise (over the cache at ``offset``,
    or, without one, over the S keys of this call: causally, or all of
    them with ``causal=False``)."""
    b, s = q.shape[:2]
    if not cached:
        zeros = torch.zeros((b,), dtype=torch.int32, device=q.device)
        return ops.prefill_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), zeros, window=window,
                                     causal=causal)
    off32 = offset.to(torch.int32)
    if s == 1:
        return ops.decode_attention(q[:, 0].contiguous(), k, v, off32 + 1,
                                    window=window)[:, None]
    return ops.prefill_attention(q.contiguous(), k, v, off32, window=window)


def apply_mla(cfg: ModelConfig, spec: BlockSpec, p, x: Tensor, *,
              positions: Tensor, offset: Optional[Tensor] = None,
              cache: Optional[dict] = None,
              valid: Optional[Tensor] = None) -> Tuple[Tensor, Optional[dict]]:
    """DeepSeek-V2 multi-head latent attention.  x: (B, S, D).  The cache
    keeps the compressed latent ``ckv`` (kv_lora) and the one shared rope
    key ``kr`` per token, written IN PLACE at ``offset``; attention
    decompresses the whole row (the JAX package's naive path): k = [ckv
    W_uk, kr] of width nope + rope per head, v = ckv W_uv, H = Hkv, scaled
    by 1/sqrt(nope + rope).  The decompressed K/V are transients of this
    call."""
    _check_spec(spec)
    m = cfg.mla
    b, s, _ = x.shape
    h, nope = cfg.n_heads, m.qk_nope_dim
    if m.q_lora_rank:
        cq = layers.apply_norm(cfg, p["q_norm"], x @ p["w_dq"])
        q = (cq @ p["w_uq"]).reshape(b, s, h, nope + m.qk_rope_dim)
    else:
        q = (x @ p["w_q"]).reshape(b, s, h, nope + m.qk_rope_dim)
    q = torch.cat([q[..., :nope],
                   layers.apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)], dim=-1)
    ckv = layers.apply_norm(cfg, p["kv_norm"], x @ p["w_dkv"])     # (B,S,r)
    kr = layers.apply_rope((x @ p["w_kr"])[:, :, None], positions,
                           cfg.rope_theta)[:, :, 0]                  # (B,S,rope)
    if cache is not None:
        ckv = _write_cache(cache["ckv"], ckv, offset, valid)
        kr = _write_cache(cache["kr"], kr, offset, valid)
    s_kv = ckv.shape[1]
    k = torch.cat([(ckv @ p["w_uk"]).reshape(b, s_kv, h, nope),
                   kr[:, :, None].expand(b, s_kv, h, m.qk_rope_dim)], dim=-1)
    v = (ckv @ p["w_uv"]).reshape(b, s_kv, h, m.v_head_dim)
    out = _attend(q, k, v, offset, cache is not None, spec.window)
    return out.reshape(b, s, -1) @ p["w_o"], cache


def apply_cross_attn(cfg: ModelConfig, p, x: Tensor, xc: dict) -> Tensor:
    """Whisper's decoder cross-attention of x (B, S, D) over the encoder
    K/V ``xc["xk"]``/``xc["xv"]`` (B, n_frames, Hkv, hd): every frame is
    visible.  One token takes decode attention at lengths = n_frames;
    more take prefill attention with ``causal=False``."""
    b, s, _ = x.shape
    q = (x @ p["x_q"]).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    xk, xv = xc["xk"].contiguous(), xc["xv"].contiguous()
    if s == 1:
        lengths = torch.full((b,), xk.shape[1], dtype=torch.int32,
                             device=x.device)
        out = ops.decode_attention(q[:, 0].contiguous(), xk, xv,
                                   lengths)[:, None]
    else:
        zeros = torch.zeros((b,), dtype=torch.int32, device=x.device)
        out = ops.prefill_attention(q.contiguous(), xk, xv, zeros,
                                    causal=False)
    return out.reshape(b, s, -1) @ p["x_o"]


def encode_cross_kv(cfg: ModelConfig, p, enc_out: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Project the encoder output (B, T, D) once, at admission, to the
    cross K/V (B, T, Hkv, hd) that the cache keeps.  ``p["x_k"]`` may
    carry a leading axis of reps (a segment's stack): the K/V then do too,
    (reps, B, T, Hkv, hd)."""
    b, t, _ = enc_out.shape
    shape = p["x_k"].shape[:-2] + (b, t, cfg.n_kv_heads, cfg.head_dim_)
    lead = p["x_k"].dim() - 2
    x = enc_out.reshape((1,) * lead + tuple(enc_out.shape))
    w_k = p["x_k"].reshape(p["x_k"].shape[:-2] + (1,) + p["x_k"].shape[-2:])
    w_v = p["x_v"].reshape(p["x_v"].shape[:-2] + (1,) + p["x_v"].shape[-2:])
    return (x @ w_k).reshape(shape), (x @ w_v).reshape(shape)


def apply_mixer_attn(cfg: ModelConfig, spec: BlockSpec, p, x: Tensor, **kw):
    """The attention mixer of ``spec``: MLA or GQA."""
    if spec.mixer == MIXER_MLA:
        return apply_mla(cfg, spec, p, x, **kw)
    return apply_gqa(cfg, spec, p, x, **kw)
