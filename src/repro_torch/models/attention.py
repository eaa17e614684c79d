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

Under a ``sharding_context`` (``sharding/partition.py``) ``apply_gqa``
runs rank-locally over the rank's shards (``_apply_gqa_sharded``): the
column-parallel projections of its rows at every position, a regroup of
their columns into whole heads (column shards cut heads: minicpm-2b's 144
q columns a rank on 16 ranks are 2.25 heads), then one of two schemes, and
the row-parallel ``w_o`` summed back into the residual layout.
``_attn_shard_plan`` makes the JAX package's decision; where it gives
"gqa", where there is no cache (training: K2 causal at offset 0 over the
full sequence of the rank's rows, differentiated by its backward kernel),
or where the cache's kv heads are split over ``model`` or whole,
attention is head-parallel (``_head_sets``: each rank a set of query heads
over the kv heads they read; K/V whole over ``model`` in the "gqa"
region, a sequence-split cache gathered there as the JAX region gathers
it).  Where the plan gives None over a sequence-split cache, the softmax
is split across ranks (``_split_softmax``): each rank attends over its
slice of the positions with the kernels' log-sum-exp output, and the
partial (o, lse) are merged in fp32; no rank reads another's cache.
``apply_mla`` does the same over MLA's latent (``_apply_mla_sharded``):
the compressions whole on every rank, the decompressions for the rank's
heads only, the latent gathered for several new tokens and the softmax
split for one.  A local block's window reaches every sharded kernel call
(over a slice, the query's position relative to the slice is passed
unclamped, so the window's edge stays put); the encoder's self-attention
runs with ``causal=False``; whisper's cross-attention runs on the rank's
heads (``_cross_attn_sharded``) over the cross K/V in the cache's layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import (MIXER_GQA, MIXER_LOCAL, MIXER_MLA,
                                       BlockSpec, ModelConfig)
from repro_torch.sharding import collectives as col
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import active_context, kv_cache_mode

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
              causal: bool = True,
              lay: Optional[spmd.Layout] = None
              ) -> Tuple[Tensor, Optional[dict]]:
    """x: (B, S, D).  With a cache: writes the S new tokens at ``offset``
    (in place) and attends over the whole masked cache row.  Without:
    plain attention over x, causal unless ``causal=False`` (the encoder's
    bidirectional self-attention).  ``lay`` (under a sharding context):
    x is this rank's block of the residual (``spmd.Layout``) and the
    parameters and cache are its shards."""
    _check_spec(spec)
    if lay is not None:
        return _apply_gqa_sharded(cfg, spec, p, x, positions=positions,
                                  offset=offset, cache=cache, valid=valid,
                                  positions3=positions3, causal=causal,
                                  lay=lay)
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


# ---------------------------------------------------------------------------
# Sharded attention (explicit SPMD over the rank's shards)
# ---------------------------------------------------------------------------


def _attn_shard_plan(cfg: ModelConfig, b: int, s: int, n_kv: int = None,
                     force_mha: bool = False):
    """The JAX package's decision (``repro/models/attention.py``
    ``_attn_shard_plan``) for a call of global batch ``b`` and ``s`` new
    tokens: ``(batch axes, tp axes, mode)`` with mode "gqa" (few kv
    heads: q heads over TP, K/V whole over TP inside) or "mha" (MLA), or
    None (JAX leaves it to GSPMD; gated to s >= 256)."""
    ctx = active_context()
    if ctx is None or s < 256:
        return None
    n_kv = cfg.n_kv_heads if n_kv is None else n_kv
    mesh, rules = ctx
    tp = rules.get("tp") or ()
    batch = rules.get("batch") or ()
    tp_n = 1
    for a in tp:
        tp_n *= mesh.shape.get(a, 1)
    b_n = 1
    for a in batch:
        b_n *= mesh.shape.get(a, 1)
    if tp_n <= 1 or b_n <= 1 or b % b_n:
        return None
    h_loc = cfg.n_heads // tp_n
    if cfg.n_heads % tp_n:
        return None
    if force_mha and n_kv == cfg.n_heads:
        mode = "mha"
    elif n_kv < tp_n and h_loc % n_kv == 0:
        mode = "gqa"
    else:
        return None
    return tuple(batch), tuple(tp), mode


def _head_cols(heads, hd: int) -> Tuple[int, ...]:
    return tuple(h * hd + c for h in heads for c in range(hd))


def _head_sets(cfg: ModelConfig, n: int, plan, mode: str, out_sets,
               whole_kv: bool = False):
    """Per rank r of ``n`` over ``model``: (query heads, kv heads) it
    attends with, ordered so its local query head l reads its local kv
    head ``l % len(kv heads)`` (the kernels' g-major grouping).

    - plan "gqa": the contiguous block of H/n query heads over every kv
      head (the block starts at a multiple of Hkv);
    - kv heads split over ``model``: its Hkv/n kv heads and the g query
      heads of each, h = gi * Hkv + kv (strided, gi-major);
    - otherwise (kv heads whole): the query heads that the rank's ``w_o``
      rows ``out_sets[r]`` cover (a head cut between two ranks is computed
      on both), over the kv head each reads where they are at most Hkv
      and ``whole_kv`` is off (g 1: whisper's 8 heads on 16 ranks take one
      head a rank), else widened to whole groups of Hkv over every kv
      head in order.  ``whole_kv`` is for a whole cache that the call
      writes and reads: every rank keeps every kv head of it."""
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = h // hkv
    sets = []
    for r in range(n):
        if plan is not None:
            h_loc = h // n
            q, kv = range(r * h_loc, (r + 1) * h_loc), range(hkv)
        elif mode == "heads":
            kv_loc = hkv // n
            kv = range(r * kv_loc, (r + 1) * kv_loc)
            q = [gi * hkv + k for gi in range(g) for k in kv]
        else:
            h0, h1 = min(out_sets[r]) // hd, max(out_sets[r]) // hd + 1
            if h1 - h0 <= hkv and not whole_kv:
                q = range(h0, h1)
                kv = [hq % hkv for hq in q]
            else:
                q = range(h0 // hkv * hkv, -(-h1 // hkv) * hkv)
                kv = range(hkv)
        sets.append((tuple(q), tuple(kv)))
    return sets


def _write_slice(buf: Tensor, new: Tensor, offset: Tensor, lo: int,
                 valid: Optional[Tensor]) -> Tensor:
    """Write the tokens of ``new`` (B, S, ...) at global positions
    ``offset + i`` that fall in this rank's slice ``[lo, lo + S_c)`` of
    the cache into ``buf`` (B, S_c, ...), IN PLACE; the rest (and tokens
    with ``valid == False``) are dropped."""
    b, s = new.shape[:2]
    s_c = buf.shape[1]
    off = offset.long()
    if s <= s_c:
        pos = off[:, None] - lo + torch.arange(s, device=buf.device)[None]
        keep = pos >= 0
        if valid is not None:
            keep = keep & valid
        return _write_cache(buf, new, off - lo, keep)
    # more new tokens than the slice holds: each slot looks up its token
    i = (torch.arange(s_c, device=buf.device)[None] + lo - off[:, None])
    ic = i.clamp(0, s - 1)
    ok = (i >= 0) & (i < s)
    if valid is not None:
        ok = ok & torch.gather(valid, 1, ic)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s_c)
    shape = ok.shape + (1,) * (new.dim() - 2)
    buf.copy_(torch.where(ok.view(shape), new[rows, ic].to(buf.dtype), buf))
    return buf


def _apply_gqa_sharded(cfg: ModelConfig, spec: BlockSpec, p, x: Tensor, *,
                       positions: Tensor, offset: Optional[Tensor],
                       cache: Optional[dict], valid: Optional[Tensor],
                       positions3: Optional[Tensor], lay: spmd.Layout,
                       causal: bool = True):
    """``apply_gqa`` on this rank's shards: x (B_local, S_local, D) in the
    residual layout; positions, valid (B_local, S) at every position;
    the cache's leaves this rank's block (``cache_specs``).  The window of
    ``spec`` reaches every kernel call, over a gathered cache and over a
    slice alike; ``causal=False`` is the encoder's self-attention."""
    mesh, rules = active_context()
    tp = rules.get("tp")
    n, j = mesh.size(tp), mesh.index(tp)
    h_, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    hx = spmd.gather_seq(mesh, rules, x, lay)               # (B_l, S, D)
    b, s, _ = hx.shape
    qc, kc, vc = hx @ p["w_q"], hx @ p["w_k"], hx @ p["w_v"]
    q_src = spmd.block_sets(h_ * hd, qc.shape[-1] != h_ * hd, n)
    k_src = spmd.block_sets(hkv * hd, kc.shape[-1] != hkv * hd, n)
    o_partial = p["w_o"].shape[0] != h_ * hd
    o_sets = spmd.block_sets(h_ * hd, o_partial, n)
    plan = _attn_shard_plan(cfg, lay.b, lay.s)
    if cache is not None:
        mode = kv_cache_mode(mesh, rules, hkv, lay.cache_len or 0)
    else:
        # no cache (training): kv heads split over model where they
        # divide, else whole; never the split softmax
        mode = "heads" if n > 1 and hkv % n == 0 else "rep"

    def rope(t):
        if cfg.pos_emb == "mrope":
            p3 = positions3 if positions3 is not None \
                else layers.position_plane(positions)
            return layers.apply_mrope(t, p3, cfg.rope_theta,
                                      cfg.mrope_sections)
        if cfg.pos_emb in ("rope", "rope_partial"):
            pct = cfg.rotary_pct if cfg.pos_emb == "rope_partial" else 1.0
            return layers.apply_rope(t, positions, cfg.rope_theta, pct)
        if cfg.pos_emb in ("learned", "none"):
            return t            # learned positions enter at the embedding
        raise NotImplementedError(f"sharded pos_emb {cfg.pos_emb!r}")

    if plan is None and mode == "seq":
        out = _split_softmax(mesh, rules, cfg, qc, kc, vc, q_src, k_src,
                             o_sets, rope, offset, cache, valid, lay,
                             spec.window)
    else:
        sets = _head_sets(cfg, n, plan, mode, o_sets,
                          whole_kv=cache is not None and mode == "rep")
        qh, kvh = sets[j]
        q = spmd.regroup(mesh, tp, qc, q_src,
                         [_head_cols(qs, hd) for qs, _ in sets])
        kv_dst = [_head_cols(ks, hd) for _, ks in sets]
        k = spmd.regroup(mesh, tp, kc, k_src, kv_dst)
        v = spmd.regroup(mesh, tp, vc, k_src, kv_dst)
        q = rope(q.reshape(b, s, len(qh), hd))
        k = rope(k.reshape(b, s, len(kvh), hd))
        v = v.reshape(b, s, len(kvh), hd)
        if cache is None:
            # causal at offset 0 over the full sequence of the rank's rows
            kb, vb = k, v
        elif mode == "seq":    # "gqa" region: the cache whole over TP
            lo = j * cache["k"].shape[1]
            kb = col.all_gather(mesh, _write_slice(
                cache["k"], k, offset, lo, valid), tp, dim=1)
            vb = col.all_gather(mesh, _write_slice(
                cache["v"], v, offset, lo, valid), tp, dim=1)
        else:
            kb = _write_cache(cache["k"], k, offset, valid)
            vb = _write_cache(cache["v"], v, offset, valid)
        o = _attend(q, kb, vb, offset, cache is not None, spec.window,
                    causal)
        out = spmd.regroup(mesh, tp, o.reshape(b, s, -1),
                           [_head_cols(qs, hd) for qs, _ in sets], o_sets)
    y = out @ p["w_o"]
    return spmd.reduce_rows(mesh, rules, y, lay, o_partial), cache


def _split_softmax(mesh, rules, cfg, qc, kc, vc, q_src, k_src, o_sets, rope,
                   offset, cache, valid, lay, window=None):
    """Attention over a sequence-split cache with the softmax split across
    ranks: every rank attends with all query heads over its slice of the
    positions (K3, or K2 for several new tokens, each with its log-sum-
    exp: lengths and offsets taken relative to the slice, so a slice past
    a row's end sees nothing), writes the new keys that fall in its
    slice, and the partial (o, lse) are merged in fp32 into the columns
    its ``w_o`` rows take.  A query past the slice keeps its true
    relative position (a length or offset past the slice's S_max, the
    kernels' contract), so a window's lower edge stays where it is: a
    slice wholly before the window sees nothing, one cut by it sees its
    keys from the edge on."""
    tp = rules.get("tp")
    n, j = mesh.size(tp), mesh.index(tp)
    h_, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b, s = qc.shape[:2]
    everything = [tuple(range(h_ * hd))] * n
    q = rope(spmd.regroup(mesh, tp, qc, q_src, everything).reshape(
        b, s, h_, hd))
    kv_all = [tuple(range(hkv * hd))] * n
    k = rope(spmd.regroup(mesh, tp, kc, k_src, kv_all).reshape(b, s, hkv, hd))
    v = spmd.regroup(mesh, tp, vc, k_src, kv_all).reshape(b, s, hkv, hd)
    s_c = cache["k"].shape[1]
    lo = j * s_c
    kb = _write_slice(cache["k"], k, offset, lo, valid)
    vb = _write_slice(cache["v"], v, offset, lo, valid)
    rel = offset.long() - lo
    if s == 1:
        lengths = (rel + 1).clamp(min=0).to(torch.int32)
        o, lse = ops.decode_attention(q[:, 0].contiguous(), kb, vb, lengths,
                                      window=window, return_lse=True)
        o, lse = o[:, None], lse[:, :, None]                # lse (B, H, 1)
    else:
        o, lse = ops.prefill_attention(q.contiguous(), kb, vb,
                                       rel.clamp(min=-s).to(torch.int32),
                                       window=window, return_lse=True)
    return _merge_slices(mesh, tp, o, lse, o_sets, hd).to(qc.dtype)


def _merge_slices(mesh, tp, o: Tensor, lse: Tensor, o_sets, hd_v: int
                  ) -> Tensor:
    """The ranks' partial attention over their slices of the positions,
    ``o`` (B, S, H, hd_v) and ``lse`` (B, H, S), merged in fp32 into the
    columns this rank's ``w_o`` rows take, ``o_sets[j]``: (B, S, C) fp32
    (0 where no slice saw a key)."""
    j = mesh.index(tp)
    b, s, h_ = o.shape[:3]
    lse_all = col.all_gather(mesh, lse[None], tp, dim=0)   # (n,B,H,S)
    o = o.reshape(b, s, h_ * hd_v)
    if o_sets[0] == o_sets[-1]:
        parts = col.all_gather(mesh, o[None], tp, dim=0)
    else:
        parts = col.all_to_all(mesh, o[None], tp, split_dim=3,
                                    concat_dim=0)          # (n, B, S, C)
    cols = torch.arange(o_sets[j][0], o_sets[j][-1] + 1, device=o.device)
    lse_c = lse_all.index_select(2, cols // hd_v).transpose(2, 3)  # (n,B,S,C)
    m = lse_c.max(dim=0).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse_c - m[None])
    den = w.sum(dim=0)
    num = (w * parts.float()).sum(dim=0)
    return torch.where(den > 0, num / den.clamp(min=1e-30),
                       torch.zeros_like(num))


def apply_mla(cfg: ModelConfig, spec: BlockSpec, p, x: Tensor, *,
              positions: Tensor, offset: Optional[Tensor] = None,
              cache: Optional[dict] = None,
              valid: Optional[Tensor] = None,
              positions3: Optional[Tensor] = None,
              lay: Optional[spmd.Layout] = None
              ) -> Tuple[Tensor, Optional[dict]]:
    """DeepSeek-V2 multi-head latent attention.  x: (B, S, D).  The cache
    keeps the compressed latent ``ckv`` (kv_lora) and the one shared rope
    key ``kr`` per token, written IN PLACE at ``offset``; attention
    decompresses the whole row (the JAX package's naive path): k = [ckv
    W_uk, kr] of width nope + rope per head, v = ckv W_uv, H = Hkv, scaled
    by 1/sqrt(nope + rope).  The decompressed K/V are transients of this
    call.  ``positions3`` is ignored, as the JAX package's MLA ignores
    it.  ``lay`` (under a sharding context): as ``apply_gqa``'s
    (``_apply_mla_sharded``)."""
    _check_spec(spec)
    if lay is not None:
        return _apply_mla_sharded(cfg, p, x, positions=positions,
                                  offset=offset, cache=cache, valid=valid,
                                  lay=lay)
    m = cfg.mla
    b, s, _ = x.shape
    h, nope = cfg.n_heads, m.qk_nope_dim
    q, ckv, kr = _mla_compress(cfg, p, x, positions)
    q = q.reshape(b, s, h, nope + m.qk_rope_dim)
    q = torch.cat([q[..., :nope],
                   layers.apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)], dim=-1)
    if cache is not None:
        ckv = _write_cache(cache["ckv"], ckv, offset, valid)
        kr = _write_cache(cache["kr"], kr, offset, valid)
    k, v = _mla_decompress(cfg, ckv, kr, p["w_uk"], p["w_uv"])
    out = _attend(q, k, v, offset, cache is not None, spec.window)
    return out.reshape(b, s, -1) @ p["w_o"], cache


def _mla_compress(cfg: ModelConfig, p, x: Tensor, positions: Tensor):
    """MLA's projections of x (B, S, D) that every head shares, and the
    query's decompression by the columns of ``w_uq`` (or ``w_q``) given:
    (q columns, the latent ``ckv`` (B, S, kv_lora), the rope key ``kr``
    (B, S, rope), rotated)."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = layers.apply_norm(cfg, p["q_norm"], x @ p["w_dq"])
        q = cq @ p["w_uq"]
    else:
        q = x @ p["w_q"]
    ckv = layers.apply_norm(cfg, p["kv_norm"], x @ p["w_dkv"])     # (B,S,r)
    kr = layers.apply_rope((x @ p["w_kr"])[:, :, None], positions,
                           cfg.rope_theta)[:, :, 0]                  # (B,S,rope)
    return q, ckv, kr


def _mla_decompress(cfg: ModelConfig, ckv: Tensor, kr: Tensor, w_uk: Tensor,
                    w_uv: Tensor) -> Tuple[Tensor, Tensor]:
    """K (B, S, H', nope + rope) and V (B, S, H', dv) of the heads whose
    columns ``w_uk``/``w_uv`` hold, from the latent and the rope key."""
    m = cfg.mla
    b, s_kv = ckv.shape[:2]
    kn = (ckv @ w_uk).reshape(b, s_kv, -1, m.qk_nope_dim)
    h = kn.shape[2]
    k = torch.cat([kn, kr[:, :, None].expand(b, s_kv, h, m.qk_rope_dim)],
                  dim=-1)
    return k, (ckv @ w_uv).reshape(b, s_kv, h, m.v_head_dim)


def _mla_regime(n: int, cached: bool, cache_len: Optional[int],
                s: int) -> str:
    """The regime of ``_apply_mla_sharded`` a call of ``s`` new tokens
    takes on ``n`` ranks over ``model``: "heads" (no cache, or a latent
    whole over ``model``: ``cache_specs`` splits its positions where
    ``n`` divides ``cache_len``), "gather" (a split latent, several new
    tokens) or "split" (a split latent, one new token)."""
    if not cached or n <= 1 or (cache_len or 0) % n:
        return "heads"
    return "split" if s == 1 else "gather"


def _apply_mla_sharded(cfg: ModelConfig, p, x: Tensor, *, positions: Tensor,
                       offset: Optional[Tensor], cache: Optional[dict],
                       valid: Optional[Tensor], lay: spmd.Layout):
    """``apply_mla`` on this rank's shards (x, positions, valid and the
    cache as ``_apply_gqa_sharded`` takes them).  The compressions
    (``w_dq``, ``w_dkv``, ``w_kr`` and their norms, whole on every rank)
    run over the rank's rows at every position; the decompressions
    (column blocks of ``w_uq``, ``w_uk``, ``w_uv``: whole heads where
    the heads divide over ``model``, else regrouped into them) only for
    the heads the rank's ``w_o`` rows take.  Three regimes, as the cache
    lies (``cache_specs`` splits the latent's positions over ``model``
    where they divide):

    - no cache (training), or a latent whole over ``model``: K/V of the
      rank's heads decompressed over every position, K2 (or K3) at g = 1,
      the ``w_o`` row block's partial sums reduced; nothing else moves,
      and every gradient the compressions get is its heads' share;
    - a sequence-split latent and several new tokens (prefill, the
      layered row): the latent's slices gathered over ``model`` (kv_lora
      + rope values a token), then as above;
    - a sequence-split latent and one new token (decode): the softmax
      split over the slices: ``w_uk``/``w_uv`` gathered whole, every
      head's query, the rank's slice decompressed for every head, K3 with
      its log-sum-exp, and the (o, lse) merged in fp32 into the rank's
      ``w_o`` columns (``_merge_slices``)."""
    mesh, rules = active_context()
    tp = rules.get("tp")
    n, j = mesh.size(tp), mesh.index(tp)
    m, h = cfg.mla, cfg.n_heads
    nope, dq, dv = m.qk_nope_dim, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    hx = spmd.gather_seq(mesh, rules, x, lay)               # (B_l, S, D)
    b, s, _ = hx.shape
    qc, ckv, kr = _mla_compress(cfg, p, hx, positions)
    q_src = spmd.block_sets(h * dq, qc.shape[-1] != h * dq, n)
    k_src = spmd.block_sets(h * nope, p["w_uk"].shape[-1] != h * nope, n)
    v_src = spmd.block_sets(h * dv, p["w_uv"].shape[-1] != h * dv, n)
    o_partial = p["w_o"].shape[0] != h * dv
    o_sets = spmd.block_sets(h * dv, o_partial, n)

    def rope_q(q):
        return torch.cat([q[..., :nope], layers.apply_rope(
            q[..., nope:], positions, cfg.rope_theta)], dim=-1)
    regime = _mla_regime(n, cache is not None, lay.cache_len, s)
    if regime != "heads":
        lo = j * cache["ckv"].shape[1]
        ckv = _write_slice(cache["ckv"], ckv, offset, lo, valid)
        kr = _write_slice(cache["kr"], kr, offset, lo, valid)
        if regime == "split":
            every = [tuple(range(h * dq))] * n
            q = rope_q(spmd.regroup(mesh, tp, qc, q_src, every)
                       .reshape(b, 1, h, dq))
            k, v = _mla_decompress(
                cfg, ckv, kr,
                spmd.regroup(mesh, tp, p["w_uk"], k_src,
                             [tuple(range(h * nope))] * n),
                spmd.regroup(mesh, tp, p["w_uv"], v_src,
                             [tuple(range(h * dv))] * n))
            lengths = (offset.long() - lo + 1).clamp(
                0, ckv.shape[1]).to(torch.int32)
            o, lse = ops.decode_attention(q[:, 0].contiguous(), k, v,
                                          lengths, return_lse=True)
            out = _merge_slices(mesh, tp, o[:, None], lse[:, :, None],
                                o_sets, dv).to(qc.dtype)
            return spmd.reduce_rows(mesh, rules, out @ p["w_o"], lay,
                                    o_partial), cache
        ckv = col.all_gather(mesh, ckv, tp, dim=1)
        kr = col.all_gather(mesh, kr, tp, dim=1)
    elif cache is not None:
        ckv = _write_cache(cache["ckv"], ckv, offset, valid)
        kr = _write_cache(cache["kr"], kr, offset, valid)
    # the heads the rank's w_o rows take, widened to whole heads
    heads = [tuple(range(min(o) // dv, max(o) // dv + 1)) for o in o_sets]
    hl = len(heads[j])
    q = rope_q(spmd.regroup(mesh, tp, qc, q_src,
                            [_head_cols(hs, dq) for hs in heads])
               .reshape(b, s, hl, dq))
    wk = spmd.regroup(mesh, tp, p["w_uk"], k_src,
                      [_head_cols(hs, nope) for hs in heads])
    wv = spmd.regroup(mesh, tp, p["w_uv"], v_src,
                      [_head_cols(hs, dv) for hs in heads])
    k, v = _mla_decompress(cfg, ckv, kr, wk, wv)
    o = _attend(q, k, v, offset, cache is not None, None)
    out = spmd.regroup(mesh, tp, o.reshape(b, s, -1),
                       [_head_cols(hs, dv) for hs in heads], o_sets)
    return spmd.reduce_rows(mesh, rules, out @ p["w_o"], lay,
                            o_partial), cache


def apply_cross_attn(cfg: ModelConfig, p, x: Tensor, xc: dict,
                     lay: Optional[spmd.Layout] = None) -> Tensor:
    """Whisper's decoder cross-attention of x (B, S, D) over the encoder
    K/V ``xc["xk"]``/``xc["xv"]`` (B, n_frames, Hkv, hd): every frame is
    visible.  One token takes decode attention at lengths = n_frames;
    more take prefill attention with ``causal=False``.  ``lay`` (under a
    sharding context): ``_cross_attn_sharded``."""
    if lay is not None:
        return _cross_attn_sharded(cfg, p, x, xc, lay)
    b, s, _ = x.shape
    q = (x @ p["x_q"]).reshape(b, s, cfg.n_heads, cfg.head_dim_)
    return _attend_frames(q, xc["xk"], xc["xv"]).reshape(b, s, -1) @ p["x_o"]


def _attend_frames(q: Tensor, xk: Tensor, xv: Tensor) -> Tensor:
    """q (B, S, H, hd) over every frame of xk/xv (B, T, Hkv, hd)."""
    b, s = q.shape[:2]
    xk, xv = xk.contiguous(), xv.contiguous()
    if s == 1:
        lengths = torch.full((b,), xk.shape[1], dtype=torch.int32,
                             device=q.device)
        out = ops.decode_attention(q[:, 0].contiguous(), xk, xv,
                                   lengths)[:, None]
    else:
        zeros = torch.zeros((b,), dtype=torch.int32, device=q.device)
        out = ops.prefill_attention(q.contiguous(), xk, xv, zeros,
                                    causal=False)
    return out


def _cross_attn_sharded(cfg: ModelConfig, p, x: Tensor, xc: dict,
                        lay: spmd.Layout) -> Tensor:
    """``apply_cross_attn`` on this rank's shards: x (B_local, S_local, D)
    in the residual layout, ``x_q`` a column block and ``x_o`` a row block,
    the cross K/V as ``cache_specs`` lays them (``encode_cross_kv`` under a
    context gives the same layout): kv heads split over ``model`` where
    they divide (the rank's query heads over its kv heads), else whole
    (the query heads its ``x_o`` rows cover, ``_head_sets``, over the kv
    heads they read).  The frames are never split: 1500 divides over
    neither 8 nor 16 ranks, and a frame-split cross cache is refused."""
    mesh, rules = active_context()
    tp = rules.get("tp")
    n, j = mesh.size(tp), mesh.index(tp)
    h_, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    xk, xv = xc["xk"], xc["xv"]
    if xk.shape[1] != cfg.encoder.n_frames:
        raise NotImplementedError(
            f"cross-attention over a frame-split cache ({xk.shape[1]} of "
            f"{cfg.encoder.n_frames} frames a rank)")
    hx = spmd.gather_seq(mesh, rules, x, lay)
    b, s, _ = hx.shape
    qc = hx @ p["x_q"]
    q_src = spmd.block_sets(h_ * hd, qc.shape[-1] != h_ * hd, n)
    o_partial = p["x_o"].shape[0] != h_ * hd
    o_sets = spmd.block_sets(h_ * hd, o_partial, n)
    sets = _head_sets(cfg, n, None, "heads" if xk.shape[2] != hkv else "rep",
                      o_sets)
    qh, kvh = sets[j]
    q = spmd.regroup(mesh, tp, qc, q_src,
                     [_head_cols(qs, hd) for qs, _ in sets])
    if xk.shape[2] == hkv and kvh != tuple(range(hkv)):
        idx = torch.tensor(kvh, device=xk.device)
        xk, xv = xk.index_select(2, idx), xv.index_select(2, idx)
    o = _attend_frames(q.reshape(b, s, len(qh), hd), xk, xv)
    out = spmd.regroup(mesh, tp, o.reshape(b, s, -1),
                       [_head_cols(qs, hd) for qs, _ in sets], o_sets)
    return spmd.reduce_rows(mesh, rules, out @ p["x_o"], lay, o_partial)


def encode_cross_kv(cfg: ModelConfig, p, enc_out: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Project the encoder output (B, T, D) once, at admission, to the
    cross K/V (B, T, Hkv, hd) that the cache keeps.  ``p["x_k"]`` may
    carry a leading axis of reps (a segment's stack): the K/V then do too,
    (reps, B, T, Hkv, hd).  Under a sharding context ``enc_out`` is the
    rank's rows (whole over ``model``) and ``x_k``/``x_v`` column blocks:
    the K/V come out in the cross cache's layout, the rank's kv heads
    where they divide over ``model`` (its column block, no move), else
    every kv head (the column blocks gathered)."""
    b, t, _ = enc_out.shape
    lead = p["x_k"].dim() - 2
    x = enc_out.reshape((1,) * lead + tuple(enc_out.shape))
    w_k = p["x_k"].reshape(p["x_k"].shape[:-2] + (1,) + p["x_k"].shape[-2:])
    w_v = p["x_v"].reshape(p["x_v"].shape[:-2] + (1,) + p["x_v"].shape[-2:])
    k, v = x @ w_k, x @ w_v
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    ctx = active_context()
    if ctx is not None and k.shape[-1] != hkv * hd:
        mesh, rules = ctx
        tp = rules.get("tp")
        n = mesh.size(tp)
        src = spmd.block_sets(hkv * hd, True, n)
        dst = spmd.block_sets(hkv * hd, hkv % n == 0, n)
        k = spmd.regroup(mesh, tp, k, src, dst)
        v = spmd.regroup(mesh, tp, v, src, dst)
    shape = p["x_k"].shape[:-2] + (b, t, k.shape[-1] // hd, hd)
    return k.reshape(shape), v.reshape(shape)


def apply_mixer_attn(cfg: ModelConfig, spec: BlockSpec, p, x: Tensor, **kw):
    """The attention mixer of ``spec``: MLA or GQA."""
    if spec.mixer == MIXER_MLA:
        return apply_mla(cfg, spec, p, x, **kw)
    return apply_gqa(cfg, spec, p, x, **kw)
