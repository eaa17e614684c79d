"""Plain PyTorch versions of the port's six kernels.

These are what the CPU runs (the wrappers in ``ops.py`` take them for a
tensor that lies on the CPU) and what ``chip_smoke.py`` holds each CUDA
kernel against on the card.  They repeat the kernels' arithmetic in fp32
and are no yardstick of speed.

* ``masked_attention`` — the model's GQA attention over a masked KV axis
  (dense, plus a query-chunked path at Sq >= 1024).  It is the plain
  version of both attention kernels:
  ``prefill_attention_ref`` and ``decode_attention_ref`` only build its
  masks from the kernels' contracts.
* ``paged_decode_attention_ref`` and ``paged_verify_attention_ref`` —
  decode attention over the paged KV pool: they gather each sequence's
  pages through its block table into a contiguous row and defer to
  ``masked_attention``.
* ``moe_gmm_ragged_ref`` — the ragged grouped fused SwiGLU.
* ``moe_gmm_ref`` — the fused SwiGLU over the dense (E, C, d) buffer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

NEG_INF = -1e30

# query length above which attention runs query chunk by query chunk (the
# (Sq x Skv) score matrix is never materialised whole)
_CHUNK_THRESHOLD = 1024
_Q_CHUNK = 512


def masked_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor,
                     kv_pos: Tensor, kv_valid: Tensor, *,
                     window: Optional[int] = None) -> Tensor:
    """Causal attention.  q: (B,Sq,H,hd); k/v: (B,Skv,Hkv,hd'); q_pos:
    (B,Sq); kv_pos: (B,Skv) or (Skv,); kv_valid: (B,Skv) bool ->
    (B,Sq,H,hd') in q's dtype, scaled by 1/sqrt(hd).

    GQA uses g-major head grouping: query head h reads kv head ``h % Hkv``
    (SDPA's ``enable_gqa`` and ``repeat_interleave`` use ``h // g``, a
    different model).  A fully masked query row outputs 0."""
    sq = q.shape[1]
    if sq >= _CHUNK_THRESHOLD and sq % _Q_CHUNK == 0:
        outs = [_masked_attention_dense(
            q[:, i:i + _Q_CHUNK], k, v, q_pos[:, i:i + _Q_CHUNK], kv_pos,
            kv_valid, window) for i in range(0, sq, _Q_CHUNK)]
        return torch.cat(outs, dim=1)
    return _masked_attention_dense(q, k, v, q_pos, kv_pos, kv_valid, window)


def _masked_attention_dense(q, k, v, q_pos, kv_pos, kv_valid, window):
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(b, sq, g, hkv, hd).float()
    scores = torch.einsum("bqgkd,bskd->bgkqs", qf, k.float()) * scale
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None].expand(b, kv_pos.shape[0])
    kp = kv_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = kv_valid[:, None, None, None, :] & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)
    out = torch.einsum("bgkqs,bskd->bqgkd", w, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def prefill_attention_ref(q: Tensor, k: Tensor, v: Tensor, offset: Tensor,
                          *, window: Optional[int] = None) -> Tensor:
    """The prefill kernel's contract over the slot-row cache.

    q: (B, P, H, hd) at positions ``offset[b] + i``; k/v: (B, S_max, Hkv,
    hd), already holding this call's keys.  Key j is visible to query i
    when ``j < offset + P``, ``j <= offset + i`` and, with a window,
    ``j > offset + i - window`` — the masks ``apply_gqa`` builds."""
    p = q.shape[1]
    s_max = k.shape[1]
    off = offset.to(device=q.device, dtype=torch.int64)
    q_pos = off[:, None] + torch.arange(p, device=q.device)[None]
    kv_pos = torch.arange(s_max, device=q.device)
    kv_valid = kv_pos[None, :] < (off + p)[:, None]
    return masked_attention(q, k, v, q_pos, kv_pos, kv_valid, window=window)


def decode_attention_ref(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                         lengths: Tensor, *,
                         window: Optional[int] = None) -> Tensor:
    """The decode kernel's contract: q (B, H, hd), caches (B, S_max, Hkv,
    hd), lengths (B,) valid entries INCLUDING the new token's K/V.  The
    query sits at position ``length - 1``; with a window it sees keys
    ``>= length - window``."""
    s_max = k_cache.shape[1]
    ln = lengths.to(device=q.device, dtype=torch.int64)
    kv_pos = torch.arange(s_max, device=q.device)
    kv_valid = kv_pos[None, :] < ln[:, None]
    out = masked_attention(q[:, None], k_cache, v_cache, (ln - 1)[:, None],
                           kv_pos, kv_valid, window=window)
    return out[:, 0]


def _gather_pages(pages: Tensor, block_tables: Tensor) -> Tensor:
    """(n_pages, page_size, Hkv, hd) pool + (B, max_pages) block tables ->
    (B, max_pages * page_size, Hkv, hd): the logical rows the tables
    encode (entries past a sequence's pages read some page; the lengths
    mask them)."""
    b, max_pages = block_tables.shape
    rows = pages[block_tables.to(pages.device).long()]
    return rows.reshape(b, max_pages * pages.shape[1], *pages.shape[2:])


def paged_verify_attention_ref(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                               block_tables: Tensor, lengths: Tensor, *,
                               window: Optional[int] = None) -> Tensor:
    """The verify kernel's contract: q (B, W, H, hd), the W window tokens
    of each sequence, oldest first; pages (n_pages, page_size, Hkv, hd);
    block_tables (B, max_pages); lengths (B,) valid tokens INCLUDING the
    window's K/V.  Window query w sits at position ``length - W + w`` and
    sees keys ``< length - W + 1 + w`` (with a window, also ``>= length -
    W + 1 + w - window``); a row that sees no key outputs 0."""
    w_len = q.shape[1]
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    ln = lengths.to(device=q.device, dtype=torch.int64)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    kv_valid = kv_pos[None, :] < ln[:, None]
    q_pos = ln[:, None] - w_len + torch.arange(w_len, device=q.device)[None]
    return masked_attention(q, k, v, q_pos, kv_pos, kv_valid, window=window)


def paged_decode_attention_ref(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                               block_tables: Tensor, lengths: Tensor, *,
                               window: Optional[int] = None) -> Tensor:
    """The paged decode kernel's contract: ``decode_attention_ref`` over
    the pool, q (B, H, hd) -> (B, H, hd); the verify window with W = 1."""
    return paged_verify_attention_ref(q[:, None], k_pages, v_pages,
                                      block_tables, lengths,
                                      window=window)[:, 0]


def moe_gmm_ref(x: Tensor, w_gate: Tensor, w_up: Tensor,
                w_down: Tensor) -> Tensor:
    """Fused SwiGLU per expert over the dense capacity buffer:
    ``out[e] = (silu(x[e] @ Wg[e]) * (x[e] @ Wu[e])) @ Wd[e]``;
    x (E, C, d), w_gate/w_up (E, d, F), w_down (E, F, d) -> (E, C, d),
    computed in fp32 and rounded once to ``x.dtype``."""
    xf = x.float()
    h = F.silu(torch.bmm(xf, w_gate.float())) * torch.bmm(xf, w_up.float())
    return torch.bmm(h, w_down.float()).to(x.dtype)


def moe_gmm_ragged_ref(rows: Tensor, w_gate: Tensor, w_up: Tensor,
                       w_down: Tensor, tile_expert: Tensor,
                       m_blk: int) -> Tensor:
    """Ragged grouped fused SwiGLU: every ``m_blk``-row tile of the
    expert-sorted buffer goes through the FFN of its owner
    ``tile_expert[t]``; sentinel tiles (``== E``) give zero rows.
    rows: (n_rows, d); w_gate/w_up: (E, d, F); w_down: (E, F, d).

    Computed in fp32 and rounded once to ``rows.dtype``.  The loop runs
    over the ACTIVE experts and gathers each one's rows — it never
    gathers per-tile weight copies (at a 2048-token prefill that would
    materialise gigabytes of fp32 weights)."""
    n_rows, d = rows.shape
    e = w_gate.shape[0]
    row_expert = tile_expert.to(rows.device).long().repeat_interleave(m_blk)
    out = torch.zeros((n_rows, d), dtype=torch.float32, device=rows.device)
    for ex in torch.unique(row_expert).tolist():
        if ex >= e:
            continue
        idx = (row_expert == ex).nonzero(as_tuple=True)[0]
        x = rows.index_select(0, idx).float()
        h = F.silu(x @ w_gate[ex].float()) * (x @ w_up[ex].float())
        out.index_copy_(0, idx, h @ w_down[ex].float())
    return out.to(rows.dtype)
