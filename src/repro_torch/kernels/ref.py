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

And the plain versions of the two backward kernels, written out step by
step (training differentiates K2 and K4; JAX's ``jax.grad`` of
``masked_attention`` and ``expert_ffn_ref`` is what they compute):

* ``prefill_attention_lse_ref`` — the per-row log-sum-exp that the
  prefill kernel's forward writes when asked (its backward reads it).
* ``prefill_attention_bwd_ref`` — (dq, dk, dv) of the prefill contract.
* ``moe_gmm_bwd_ref`` — (dx, dw_gate, dw_up, dw_down) of the dense
  SwiGLU.
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
                     causal: bool = True,
                     window: Optional[int] = None) -> Tensor:
    """Causal (or, with ``causal=False``, bidirectional: every valid key
    is visible) attention.  q: (B,Sq,H,hd); k: (B,Skv,Hkv,hd); v:
    (B,Skv,Hkv,hd_v); q_pos: (B,Sq); kv_pos: (B,Skv) or (Skv,); kv_valid:
    (B,Skv) bool -> (B,Sq,H,hd_v) in q's dtype, scaled by 1/sqrt(hd) (GQA
    has hd_v = hd; multi-head latent attention hd 192 = 128 nope + 64
    rope against hd_v 128).

    GQA uses g-major head grouping: query head h reads kv head ``h % Hkv``
    (SDPA's ``enable_gqa`` and ``repeat_interleave`` use ``h // g``, a
    different model).  A fully masked query row outputs 0."""
    sq = q.shape[1]
    if sq >= _CHUNK_THRESHOLD and sq % _Q_CHUNK == 0:
        outs = [_masked_attention_dense(
            q[:, i:i + _Q_CHUNK], k, v, q_pos[:, i:i + _Q_CHUNK], kv_pos,
            kv_valid, causal, window) for i in range(0, sq, _Q_CHUNK)]
        return torch.cat(outs, dim=1)
    return _masked_attention_dense(q, k, v, q_pos, kv_pos, kv_valid, causal,
                                   window)


def _masked_attention_dense(q, k, v, q_pos, kv_pos, kv_valid, causal,
                            window):
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
    mask = kv_valid[:, None, None, None, :]
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)
    out = torch.einsum("bgkqs,bskd->bqgkd", w, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def prefill_attention_ref(q: Tensor, k: Tensor, v: Tensor, offset: Tensor,
                          *, window: Optional[int] = None,
                          causal: bool = True) -> Tensor:
    """The prefill kernel's contract over the slot-row cache.

    q: (B, P, H, hd) at positions ``offset[b] + i``; k: (B, S_max, Hkv,
    hd) and v: (B, S_max, Hkv, hd_v), already holding this call's keys ->
    (B, P, H, hd_v).  Key j is visible to query i
    when ``j < offset + P``, ``j <= offset + i`` and, with a window,
    ``j > offset + i - window`` — the masks ``apply_gqa`` builds.  With
    ``causal=False`` every key ``j < S_max`` is visible to every query and
    ``offset`` and ``window`` are ignored: the masks of the encoder's
    bidirectional self-attention and of cross-attention
    (``apply_cross_attn``)."""
    p = q.shape[1]
    s_max = k.shape[1]
    kv_pos = torch.arange(s_max, device=q.device)
    if not causal:
        kv_valid = torch.ones((q.shape[0], s_max), dtype=torch.bool,
                              device=q.device)
        q_pos = torch.zeros((q.shape[0], p), dtype=torch.int64,
                            device=q.device)
        return masked_attention(q, k, v, q_pos, kv_pos, kv_valid,
                                causal=False)
    off = offset.to(device=q.device, dtype=torch.int64)
    q_pos = off[:, None] + torch.arange(p, device=q.device)[None]
    kv_valid = kv_pos[None, :] < (off + p)[:, None]
    return masked_attention(q, k, v, q_pos, kv_pos, kv_valid, window=window)


def decode_attention_ref(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                         lengths: Tensor, *,
                         window: Optional[int] = None) -> Tensor:
    """The decode kernel's contract: q (B, H, hd), caches k (B, S_max,
    Hkv, hd) and v (B, S_max, Hkv, hd_v), lengths (B,) valid entries
    INCLUDING the new token's K/V -> (B, H, hd_v).  The
    query sits at position ``length - 1``; with a window it sees keys
    ``>= length - window``.  A length past S_max (the query beyond a
    slice of the cache) sees ``[max(0, length - window), S_max)``; a
    query that sees no key outputs 0."""
    s_max = k_cache.shape[1]
    ln = lengths.to(device=q.device, dtype=torch.int64)
    kv_pos = torch.arange(s_max, device=q.device)
    kv_valid = kv_pos[None, :] < ln[:, None]
    out = masked_attention(q[:, None], k_cache, v_cache, (ln - 1)[:, None],
                           kv_pos, kv_valid, window=window)
    return out[:, 0]


def decode_attention_lse_ref(q: Tensor, k_cache: Tensor, lengths: Tensor, *,
                             window: Optional[int] = None) -> Tensor:
    """(B, H) fp32: the natural-log log-sum-exp of each query's scaled
    scores over the keys ``decode_attention_ref`` lets it see (``j <
    min(length, S_max)``, with a window ``j >= length - window``); -inf
    for a query that sees none (length 0, or a window that ends before
    the cache starts)."""
    s_max = k_cache.shape[1]
    ln = lengths.to(device=q.device, dtype=torch.int64)
    kv_pos = torch.arange(s_max, device=q.device)
    vis = kv_pos[None, :] < ln[:, None].clamp(max=s_max)
    if window is not None:
        vis = vis & (kv_pos[None, :] >= ln[:, None] - window)
    scores = _grouped_scores(q[:, None], k_cache, vis[:, None])
    b, h = q.shape[:2]
    return torch.logsumexp(scores, dim=-1).reshape(b, h)


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


# ------------------------------------------------------------- backwards


def _prefill_visible(q: Tensor, k: Tensor, offset: Tensor,
                     window: Optional[int], causal: bool) -> Tensor:
    """(B, P, S_max) bool: key j visible to query i under the prefill
    contract (``prefill_attention_ref``'s masks)."""
    b, p = q.shape[:2]
    s_max = k.shape[1]
    kv_pos = torch.arange(s_max, device=q.device)
    if not causal:
        return torch.ones((b, p, s_max), dtype=torch.bool, device=q.device)
    off = offset.to(device=q.device, dtype=torch.int64)
    q_pos = off[:, None] + torch.arange(p, device=q.device)[None]
    vis = ((kv_pos[None, None, :] <= q_pos[:, :, None])
           & (kv_pos[None, None, :] < (off + p)[:, None, None]))
    if window is not None:
        vis = vis & (kv_pos[None, None, :] > q_pos[:, :, None] - window)
    return vis


def _grouped_scores(q: Tensor, k: Tensor, vis: Tensor) -> Tensor:
    """Scaled fp32 scores (B, g, Hkv, P, S_max), g-major heads (query head
    h = gi * Hkv + kv head), -inf where ``vis`` (B, P, S_max) is False."""
    b, p, h, dk = q.shape
    hkv = k.shape[2]
    qf = q.reshape(b, p, h // hkv, hkv, dk).float()
    s = torch.einsum("bqgkd,bskd->bgkqs", qf, k.float()) / math.sqrt(dk)
    return s.masked_fill(~vis[:, None, None], float("-inf"))


def prefill_attention_lse_ref(q: Tensor, k: Tensor, v: Tensor,
                              offset: Tensor, *,
                              window: Optional[int] = None,
                              causal: bool = True) -> Tensor:
    """(B, H, P) fp32: the natural-log log-sum-exp of each query row's
    scaled scores over the keys it sees (``prefill_attention_ref``'s
    masks); -inf for a row that sees none."""
    b, p, h, _ = q.shape
    vis = _prefill_visible(q, k, offset, window, causal)
    lse = torch.logsumexp(_grouped_scores(q, k, vis), dim=-1)  # (B,g,Hkv,P)
    return lse.reshape(b, h, p)


def prefill_attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                              lse: Tensor, do: Tensor, offset: Tensor, *,
                              window: Optional[int] = None,
                              causal: bool = True):
    """The vjp of ``prefill_attention_ref`` at (q, k, v) for the output
    cotangent ``do`` (B, P, H, dv), from the forward's output ``o`` and
    log-sum-exp ``lse`` (B, H, P), in fp32:

        P  = exp(S - lse)            S = q k^T / sqrt(dk), masked
        D  = rowsum(dO o o)
        dV = P^T dO        dP = dO V^T        dS = P o (dP - D)
        dQ = dS K / sqrt(dk)          dK = dS^T Q / sqrt(dk)

    with GQA's g query heads of a kv head summed into its dK and dV.
    Returns (dq, dk, dv) in the dtypes of q, k and v; keys no query sees
    get zero gradients."""
    b, p, h, dk = q.shape
    hkv, dv_w = k.shape[2], v.shape[3]
    g = h // hkv
    scale = 1.0 / math.sqrt(dk)
    vis = _prefill_visible(q, k, offset, window, causal)
    lse_g = lse.float().reshape(b, g, hkv, p)
    do_f = do.reshape(b, p, g, hkv, dv_w).float()
    d_row = (do_f * o.reshape(b, p, g, hkv, dv_w).float()).sum(-1)
    d_row = d_row.permute(0, 2, 3, 1)                         # (B,g,Hkv,P)
    qf = q.reshape(b, p, g, hkv, dk).float()
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qf)
    dk_ = torch.zeros_like(kf)
    dv_ = torch.zeros_like(vf)
    step = _Q_CHUNK if p >= _CHUNK_THRESHOLD else p
    for i in range(0, p, step):
        sl = slice(i, i + step)
        s = _grouped_scores(q[:, sl], k, vis[:, sl])
        prob = torch.where(vis[:, None, None, sl],
                           torch.exp(s - lse_g[..., sl, None]), 0.0)
        dv_ += torch.einsum("bgkqs,bqgkd->bskd", prob, do_f[:, sl])
        dp = torch.einsum("bqgkd,bskd->bgkqs", do_f[:, sl], vf)
        ds = prob * (dp - d_row[..., sl, None])
        dq[:, sl] = torch.einsum("bgkqs,bskd->bqgkd", ds, kf) * scale
        dk_ += torch.einsum("bgkqs,bqgkd->bskd", ds, qf[:, sl]) * scale
    return (dq.reshape(b, p, h, dk).to(q.dtype), dk_.to(k.dtype),
            dv_.to(v.dtype))


def moe_gmm_bwd_ref(x: Tensor, w_gate: Tensor, w_up: Tensor,
                    w_down: Tensor, dy: Tensor):
    """The vjp of ``moe_gmm_ref`` for the output cotangent ``dy`` (E, C,
    d), in fp32:

        G = X Wg, U = X Wu, H = silu(G) U        dH = dY Wd^T
        dG = dH o U o silu'(G)   dU = dH o silu(G)   silu' = s (1 + G (1 - s))
        dX = dG Wg^T + dU Wu^T
        dWg = X^T dG   dWu = X^T dU   dWd = H^T dY

    per expert.  Returns (dx, dw_gate, dw_up, dw_down) in the inputs'
    dtypes."""
    xf, dyf = x.float(), dy.float()
    wg, wu, wd = w_gate.float(), w_up.float(), w_down.float()
    g = torch.bmm(xf, wg)
    u = torch.bmm(xf, wu)
    sig = torch.sigmoid(g)
    act = g * sig
    h = act * u
    dh = torch.bmm(dyf, wd.transpose(1, 2))
    dg = dh * u * (sig * (1.0 + g * (1.0 - sig)))
    du = dh * act
    dx = torch.bmm(dg, wg.transpose(1, 2)) + torch.bmm(du, wu.transpose(1, 2))
    xt = xf.transpose(1, 2)
    return (dx.to(x.dtype), torch.bmm(xt, dg).to(w_gate.dtype),
            torch.bmm(xt, du).to(w_up.dtype),
            torch.bmm(h.transpose(1, 2), dyf).to(w_down.dtype))
