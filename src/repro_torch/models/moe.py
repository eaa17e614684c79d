"""Mixture-of-Experts FFN with the ragged (dropless) dispatch, shared
experts and the expert-load accounting the paper's metric rests on.

Assignments are sorted by expert id into ONE flat (rows, d) buffer whose
per-expert groups are padded to row-tile boundaries; the ragged grouped
SwiGLU (``kernels.ops.moe_gmm_ragged``) then reads exactly the active
experts' weights, ``active_experts x bytes_per_expert`` — the quantity the
serving engine's ``expert_load_bytes`` counter measures.

Every call returns an ``aux`` dict: ``expert_counts`` (E,) int32 tokens
routed to each expert, ``active_experts``, ``dropped`` (always 0 — ragged
dispatch never drops) and the Switch load-balance ``aux_loss``.

Only ``moe_dispatch="ragged"`` is ported; the dense capacity-buffer
dispatch raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

Tensor = torch.Tensor


def init_moe(cfg: ModelConfig, device, generator, reps: int = 0) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.expert_d_ff
    dt = torch_dtype(cfg.param_dtype)

    def w(shape, scale=None):
        return dense_init(shape, dt, device, generator, scale=scale, reps=reps)
    p = {
        "router": w((d, e.n_experts), scale=0.02),
        # fan-in is shape[0] = E for the stacked expert weights, exactly as
        # the JAX package's layers._dense draws them
        "w_gate": w((e.n_experts, d, f)),
        "w_up": w((e.n_experts, d, f)),
        "w_down": w((e.n_experts, f, d)),
    }
    if e.n_shared_experts:
        fs = e.shared_d_ff * e.n_shared_experts
        p["shared"] = {"w_gate": w((d, fs)), "w_up": w((d, fs)),
                       "w_down": w((fs, d))}
    return p


def route(cfg: ModelConfig, p, x_flat: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """x_flat: (T, d) -> (expert_idx (T,k) int64, weights (T,k), probs (T,E)).

    fp32 softmax, top-k, renormalised weights.  Ties go to the LOWER
    expert index, as ``jax.lax.top_k`` breaks them: the top-k is a stable
    descending sort, so equal probabilities keep index order."""
    k = cfg.moe.top_k
    logits = x_flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / w.sum(dim=-1, keepdim=True)
    return idx, w, probs


def ragged_tile_rows(n_assign: int, n_experts: int,
                     m_blk_max: int = 128) -> Tuple[int, int]:
    """Static (row-tile size, padded row count) for the ragged buffer: the
    tile tracks the ceil-average expert load (so decode does not pay
    E x (m_blk - 1) alignment rows); the row count is the worst case
    ``sum_e ceil(count_e / m_blk) * m_blk`` rounded up to a whole tile."""
    avg = max(1, -(-n_assign // max(n_experts, 1)))
    m_blk = 8
    while m_blk < min(avg, m_blk_max):
        m_blk *= 2
    rows = n_assign + n_experts * (m_blk - 1)
    rows = -(-rows // m_blk) * m_blk
    return m_blk, rows


def _group_ranks(flat: Tensor, counts: Tensor, n_experts: int) -> Tensor:
    """Rank of each assignment within its expert group, in stable-sort
    order.  Entries with id >= n_experts get garbage ranks (masked by the
    caller's ``keep``)."""
    a = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    sorted_expert = flat[order]
    gstarts = torch.cumsum(counts, 0) - counts
    pos_sorted = (torch.arange(a, device=flat.device)
                  - gstarts[sorted_expert.clamp(max=n_experts - 1)])
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def _combine_topk(y_flat: Tensor, slot: Tensor, keep: Tensor,
                  w: Tensor) -> Tensor:
    """out[t] = sum_i w[t,i] * y_flat[slot[t,i]] over i = 0..k-1 in that
    order, in ``y_flat.dtype``; dropped/masked assignments add nothing."""
    t, top_k = w.shape
    n_rows = y_flat.shape[0]
    slot_k = slot.reshape(t, top_k)
    keep_k = keep.reshape(t, top_k)
    out = torch.zeros((t, y_flat.shape[1]), dtype=y_flat.dtype,
                      device=y_flat.device)
    for i in range(top_k):
        contrib = y_flat[slot_k[:, i].clamp(max=n_rows - 1)]
        gate = torch.where(keep_k[:, i], w[:, i], 0.0)
        out = out + contrib * gate[:, None].to(contrib.dtype)
    return out


def ragged_dispatch_indices(expert_idx: Tensor, n_experts: int, m_blk: int,
                            n_rows: int):
    """Tile-aligned ranking: each (token, k) assignment's row in the
    expert-sorted buffer whose per-expert groups start on ``m_blk``
    boundaries.  Masked assignments (id == n_experts) get row ``n_rows``
    and keep=False.  Returns (slot (T*k,), keep (T*k,), counts (E,) int64,
    tile_expert (n_rows/m_blk,) int32 — the owner of each tile, or the
    sentinel ``n_experts`` for padding tiles)."""
    flat = expert_idx.reshape(-1).long()
    # count into E + 1 bins and slice off the sentinel bin E
    # (jnp.bincount(length=E) drops it; torch.bincount would keep it, and
    # on the card it syncs the host to size its output)
    counts = torch.zeros(n_experts + 1, dtype=torch.long, device=flat.device)
    counts = counts.scatter_add_(0, flat, torch.ones_like(flat))[:n_experts]
    padded = (counts + m_blk - 1) // m_blk * m_blk
    pcum = torch.cumsum(padded, 0)
    starts = pcum - padded
    pos = _group_ranks(flat, counts, n_experts)
    keep = flat < n_experts
    slot = torch.where(keep, starts[flat.clamp(max=n_experts - 1)] + pos,
                       n_rows)
    row0 = torch.arange(n_rows // m_blk, device=flat.device) * m_blk
    tile_expert = torch.searchsorted(pcum, row0, right=True).to(torch.int32)
    return slot, keep, counts, tile_expert


def ragged_dispatch(xf: Tensor, idx: Tensor, n_local: int):
    """Gather tokens xf (T, d) routed by idx (T, k) into the expert-sorted
    tile-aligned (rows, d) buffer.  Returns (rows, tile_expert, m_blk,
    slot, keep, counts) — the ragged grouped SwiGLU's inputs plus what the
    combine and the expert-load counters need."""
    t, k = idx.shape
    m_blk, n_rows = ragged_tile_rows(t * k, n_local)
    slot, keep, counts, tile_expert = ragged_dispatch_indices(
        idx, n_local, m_blk, n_rows)
    tok_ids = torch.arange(t, device=xf.device).repeat_interleave(k)
    # masked assignments all land in the scratch entry n_rows, then dropped
    tok_of_row = torch.zeros(n_rows + 1, dtype=torch.long, device=xf.device)
    tok_of_row.scatter_(0, torch.where(keep, slot, n_rows), tok_ids)
    return xf[tok_of_row[:n_rows]], tile_expert, m_blk, slot, keep, counts


def _dispatch_gmm_combine_ragged(p, xf: Tensor, idx: Tensor, w: Tensor,
                                 n_local: int):
    """Ragged dispatch, ragged grouped SwiGLU, weighted combine."""
    rows, tile_expert, m_blk, slot, keep, counts = ragged_dispatch(
        xf, idx, n_local)
    y = ops.moe_gmm_ragged(rows, p["w_gate"], p["w_up"], p["w_down"],
                           tile_expert, m_blk)
    return _combine_topk(y, slot, keep, w), counts


def apply_moe(cfg: ModelConfig, p, x: Tensor, *,
              valid: Optional[Tensor] = None,
              moe_dispatch: str = "ragged") -> Tuple[Tensor, dict]:
    """x: (B, S, d) -> (out (B, S, d), aux).  ``valid`` (B, S) masks padding
    tokens out of routing and the expert-load counters (they route to the
    sentinel expert E, contribute nothing and load nothing)."""
    if moe_dispatch != "ragged":
        raise NotImplementedError(
            f"moe_dispatch={moe_dispatch!r}: the torch port runs the ragged "
            "dispatch only")
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    idx, w, probs = route(cfg, p, xf)
    if valid is not None:
        idx = torch.where(valid.reshape(t, 1), idx, e.n_experts)
    out, counts = _dispatch_gmm_combine_ragged(p, xf, idx, w, e.n_experts)
    if e.n_shared_experts:
        sp = p["shared"]
        out = out + (F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]
    # Switch load-balance loss: E * sum_i f_i * P_i
    f = counts.float() / max(t * e.top_k, 1)
    aux_loss = e.n_experts * torch.sum(f * probs.mean(dim=0)) * e.router_aux_coef
    aux = {
        "expert_counts": counts.to(torch.int32),
        "active_experts": (counts > 0).sum().to(torch.int32),
        "dropped": torch.zeros((), dtype=torch.int32, device=x.device),
        "aux_loss": aux_loss,
    }
    return out.reshape(b, s, d).to(x.dtype), aux


def empty_moe_aux(cfg: ModelConfig, device) -> dict:
    """Aux dict of the same structure for blocks without MoE."""
    n = max(cfg.moe.n_experts, 1)
    return {
        "expert_counts": torch.zeros((n,), dtype=torch.int32, device=device),
        "active_experts": torch.zeros((), dtype=torch.int32, device=device),
        "dropped": torch.zeros((), dtype=torch.int32, device=device),
        "aux_loss": torch.zeros((), dtype=torch.float32, device=device),
    }
