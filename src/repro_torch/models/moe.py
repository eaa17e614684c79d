"""Mixture-of-Experts FFN with the ragged and the dense dispatch, shared
experts and the expert-load accounting the paper's metric rests on.

``moe_dispatch="ragged"`` (the default) sorts assignments by expert id into
ONE flat (rows, d) buffer whose per-expert groups are padded to row-tile
boundaries; the ragged grouped SwiGLU (``kernels.ops.moe_gmm_ragged``) then
reads exactly the active experts' weights, ``active_experts x
bytes_per_expert`` — the quantity the serving engine's
``expert_load_bytes`` counter measures.

``moe_dispatch="dense"`` gathers tokens into the (E, C, d) capacity buffer
and runs the batched per-expert SwiGLU (``kernels.ops.moe_gmm``) over every
expert's C rows; ``dropless=True`` sizes C to the token count so nothing is
dropped (the serving engine's setting), otherwise GShard's ``capacity``
drops the assignments that overflow an expert.

Every call returns an ``aux`` dict: ``expert_counts`` (E,) int32 tokens
routed to each expert, ``active_experts``, ``dropped`` (assignments that
overflowed the dense capacity; always 0 for ragged) and the Switch
load-balance ``aux_loss``.

Under a sharding context (``sharding/partition.py``) the routed experts
run over the rank's shards: experts over ``model``, the expert FFN width
over ``data`` (``_PARAM_RULES``).  ``_sharded_moe_plan`` makes the JAX
package's decision and ``_apply_moe_sharded`` runs its regimes with
explicit collectives: "a2a" (tokens over batch x model; dense: per-group
capacity, one all-to-all of the (E, C, d) buffer out and one back;
ragged: destination-shard-major tile-aligned chunks, worst-case sized,
their sizes in a second small all-to-all), "psum" (tokens over the batch
axes, whole over the expert axis; a sum over it combines), each with the
expert blocks' FFN width gathered over ``data`` as the JAX region's
boundary gathers it; and, where JAX leaves the call to GSPMD (None: few
tokens, decode), the port's own scheme (``_moe_gathered``): every rank
takes all the call's tokens, runs its experts over its FFN-width shard
(SwiGLU is a sum over that width), and the partial outputs are summed over
``data`` and ``model`` — no expert weight moves.  K4 and K1 run on the
rank's local experts in every regime.  Shared experts (DeepSeek-V2) run
beside them as a column/row-parallel SwiGLU over ``model``
(``shared_experts``), their partial output summed into the layout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding import collectives as col
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import active_context

Tensor = torch.Tensor


def init_moe(cfg: ModelConfig, draw, path: str, reps: int = 0) -> dict:
    e = cfg.moe
    d, f = cfg.d_model, e.expert_d_ff
    dt = torch_dtype(cfg.param_dtype)

    def w(name, shape, scale=None):
        return dense_init(draw, f"{path}/{name}", shape, dt, scale=scale,
                          reps=reps)
    p = {
        "router": w("router", (d, e.n_experts), scale=0.02),
        # fan-in is shape[0] = E for the stacked expert weights, exactly as
        # the JAX package's layers._dense draws them
        "w_gate": w("w_gate", (e.n_experts, d, f)),
        "w_up": w("w_up", (e.n_experts, d, f)),
        "w_down": w("w_down", (e.n_experts, f, d)),
    }
    if e.n_shared_experts:
        fs = e.shared_d_ff * e.n_shared_experts
        p["shared"] = {"w_gate": w("shared/w_gate", (d, fs)),
                       "w_up": w("shared/w_up", (d, fs)),
                       "w_down": w("shared/w_down", (fs, d))}
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


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """GShard capacity per expert for ``n_tokens`` routed tokens: the
    balanced share times ``capacity_factor``, at least top-k, rounded up to
    a multiple of 8 when above 8, and never more than ``n_tokens``."""
    e = cfg.moe
    c = int(math.ceil(n_tokens * e.top_k / e.n_experts * e.capacity_factor))
    c = max(c, e.top_k)
    if c > 8:
        c = (c + 7) // 8 * 8
    return min(c, n_tokens)


def _expert_counts(flat: Tensor, n_experts: int) -> Tensor:
    """Assignments per expert, (E,) int64; masked ids (== E) not counted.
    Counts into E + 1 bins and slices off the sentinel bin E
    (``torch.bincount`` would keep it, and on the card it syncs the host
    to size its output)."""
    counts = torch.zeros(n_experts + 1, dtype=torch.long, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat))[:n_experts]


def dispatch_indices(expert_idx: Tensor, n_experts: int, cap: int):
    """Stable-sort ranking into the (E, C) capacity buffer: assignment a
    of expert e with rank r in e's group goes to slot ``e * cap + r``;
    ranks >= ``cap`` and masked ids (== n_experts) are dropped
    (keep=False; their slot is clamped to the group's last cell or lies
    past the buffer).  Returns (slot (T*k,), keep (T*k,), counts (E,))."""
    flat = expert_idx.reshape(-1).long()
    counts = _expert_counts(flat, n_experts)
    pos = _group_ranks(flat, counts, n_experts)
    keep = (pos < cap) & (flat < n_experts)
    slot = flat * cap + pos.clamp(max=cap - 1)
    return slot, keep, counts


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
    counts = _expert_counts(flat, n_experts)
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


def _gather_slots(xf: Tensor, slot: Tensor, keep: Tensor, n_rows: int,
                  top_k: int) -> Tensor:
    """ONE gather of the (n_rows, d) expert buffer through the inverted
    slot -> token map: row ``slot[a]`` holds the token of kept assignment
    a (assignment a is token a // top_k); rows no kept assignment fills
    read token 0, so a kernel's rows stay finite (the combine never reads
    them back)."""
    tok_ids = torch.arange(xf.shape[0], device=xf.device).repeat_interleave(top_k)
    # unkept assignments all land in the scratch entry n_rows, then dropped
    tok_of_row = torch.zeros(n_rows + 1, dtype=torch.long, device=xf.device)
    tok_of_row.scatter_(0, torch.where(keep, slot, n_rows), tok_ids)
    return xf[tok_of_row[:n_rows]]


def ragged_dispatch(xf: Tensor, idx: Tensor, n_local: int):
    """Gather tokens xf (T, d) routed by idx (T, k) into the expert-sorted
    tile-aligned (rows, d) buffer.  Returns (rows, tile_expert, m_blk,
    slot, keep, counts) — the ragged grouped SwiGLU's inputs plus what the
    combine and the expert-load counters need."""
    t, k = idx.shape
    m_blk, n_rows = ragged_tile_rows(t * k, n_local)
    slot, keep, counts, tile_expert = ragged_dispatch_indices(
        idx, n_local, m_blk, n_rows)
    rows = _gather_slots(xf, slot, keep, n_rows, k)
    return rows, tile_expert, m_blk, slot, keep, counts


def _dispatch_gmm_combine_ragged(p, xf: Tensor, idx: Tensor, w: Tensor,
                                 n_local: int):
    """Ragged dispatch, ragged grouped SwiGLU, weighted combine."""
    rows, tile_expert, m_blk, slot, keep, counts = ragged_dispatch(
        xf, idx, n_local)
    y = ops.moe_gmm_ragged(rows, p["w_gate"], p["w_up"], p["w_down"],
                           tile_expert, m_blk)
    return _combine_topk(y, slot, keep, w), counts


def _dispatch_gmm_combine(p, xf: Tensor, idx: Tensor, w: Tensor, cap: int,
                          n_local: int):
    """Dense dispatch: one gather of the (E, C, d) capacity buffer, the
    batched per-expert SwiGLU, then one (t, d) gather per top-k slot.
    Returns (out (t, d), counts (E,), dropped ())."""
    d = xf.shape[1]
    slot, keep, counts = dispatch_indices(idx, n_local, cap)
    n_cells = n_local * cap
    buf = _gather_slots(xf, slot, keep, n_cells, idx.shape[1])
    y = ops.moe_gmm(buf.reshape(n_local, cap, d), p["w_gate"], p["w_up"],
                    p["w_down"])
    out = _combine_topk(y.reshape(n_cells, d), slot, keep, w)
    dropped = ((idx.reshape(-1) < n_local) & ~keep).sum()
    return out, counts, dropped


def apply_moe(cfg: ModelConfig, p, x: Tensor, *,
              valid: Optional[Tensor] = None, dropless: bool = False,
              moe_dispatch: str = "ragged",
              lay: Optional[spmd.Layout] = None) -> Tuple[Tensor, dict]:
    """x: (B, S, d) -> (out (B, S, d), aux).  ``valid`` (B, S) masks padding
    tokens out of routing and the expert-load counters (they route to the
    sentinel expert E, contribute nothing and load nothing).
    ``moe_dispatch`` is "ragged" or "dense"; ``dropless`` sizes the dense
    capacity buffer to the worst case (C = B * S) and is moot for ragged,
    which never drops.  ``lay`` (under a sharding context): x is this
    rank's block of the residual, ``valid`` its rows at every position,
    and the counts are the whole call's."""
    if moe_dispatch not in ("dense", "ragged"):
        raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
    if lay is not None:
        out, aux = _apply_moe_sharded(cfg, p, x, valid, dropless,
                                      moe_dispatch, lay)
        if cfg.moe.n_shared_experts:
            out = out + shared_experts(cfg, p["shared"], x, lay)
        return out, aux
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    idx, w, probs = route(cfg, p, xf)
    if valid is not None:
        idx = torch.where(valid.reshape(t, 1), idx, e.n_experts)
    if moe_dispatch == "ragged":
        out, counts = _dispatch_gmm_combine_ragged(p, xf, idx, w, e.n_experts)
        dropped = torch.zeros((), dtype=torch.long, device=x.device)
    else:
        cap = t if dropless else capacity(cfg, t)
        out, counts, dropped = _dispatch_gmm_combine(p, xf, idx, w, cap,
                                                     e.n_experts)
    if e.n_shared_experts:
        out = out + shared_experts(cfg, p["shared"], xf)
    # Switch load-balance loss: E * sum_i f_i * P_i
    f = counts.float() / max(t * e.top_k, 1)
    aux_loss = e.n_experts * torch.sum(f * probs.mean(dim=0)) * e.router_aux_coef
    aux = {
        "expert_counts": counts.to(torch.int32),
        "active_experts": (counts > 0).sum().to(torch.int32),
        "dropped": dropped.to(torch.int32),
        "aux_loss": aux_loss,
    }
    return out.reshape(b, s, d).to(x.dtype), aux


def shared_experts(cfg: ModelConfig, sp, x: Tensor,
                   lay: Optional[spmd.Layout] = None) -> Tensor:
    """The shared experts' SwiGLU, on SiLU whatever ``cfg.activation``
    says (as the JAX package's).  ``lay`` (under a sharding context): x is
    this rank's block of the residual and ``w_gate``/``w_up`` column and
    ``w_down`` row blocks of the shared width (``moe/shared/*``), so the
    rank reads its rows at every position and its partial output is
    summed back into the layout.  Whether that output is partial follows
    the shared width, not ``cfg.d_ff`` as in ``layers.apply_mlp``."""
    if lay is None:
        return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    mesh, rules = active_context()
    width = cfg.moe.shared_d_ff * cfg.moe.n_shared_experts
    y = shared_experts(cfg, sp, spmd.gather_seq(mesh, rules, x, lay))
    return spmd.reduce_rows(mesh, rules, y, lay,
                            sp["w_down"].shape[0] != width)


# ---------------------------------------------------------------------------
# Sharded MoE (explicit SPMD over the rank's shards)
# ---------------------------------------------------------------------------


def _sharded_moe_plan(cfg: ModelConfig, b: int, s: int):
    """The JAX package's decision (``repro/models/moe.py``
    ``_sharded_moe_plan``) for a call of global batch ``b`` and ``s``
    tokens a row: ``(batch axes, expert axes, b_n, tp_n, mode)`` with mode
    "a2a" or "psum", or None (no context, shapes that do not divide, or
    fewer than 16 expected tokens an expert)."""
    ctx = active_context()
    if ctx is None:
        return None
    mesh, rules = ctx
    tp = rules.get("tp") or ()
    batch = rules.get("batch") or ()
    tp_n = 1
    for a in tp:
        tp_n *= mesh.shape.get(a, 1)
    b_n = 1
    for a in batch:
        b_n *= mesh.shape.get(a, 1)
    e = cfg.moe
    if tp_n <= 1 or b_n <= 1:
        return None
    if e.n_experts % tp_n or (b * s) % b_n:
        return None
    if (b * s) * e.top_k < 16 * e.n_experts:
        return None
    mode = "a2a" if (b % b_n == 0 and s % tp_n == 0
                     and len(tp) == 1) else "psum"
    return tuple(batch), tuple(tp), b_n, tp_n, mode


def _moe_aux(cfg: ModelConfig, counts: Tensor, dropped: Tensor,
             pbar: Tensor, t: int) -> dict:
    e = cfg.moe
    f = counts.float() / max(t * e.top_k, 1)
    return {"expert_counts": counts.to(torch.int32),
            "active_experts": (counts > 0).sum().to(torch.int32),
            "dropped": dropped.to(torch.int32),
            "aux_loss": e.n_experts * torch.sum(f * pbar) * e.router_aux_coef}


def _full_width(mesh, rules, p, f: int) -> dict:
    """The rank's experts at their whole FFN width: the shards over
    ``data`` gathered (the JAX region's boundary gather)."""
    if p["w_gate"].shape[-1] == f:
        return p
    inner = rules.get("expert_inner")
    return {"w_gate": col.all_gather(mesh, p["w_gate"], inner, dim=2),
            "w_up": col.all_gather(mesh, p["w_up"], inner, dim=2),
            "w_down": col.all_gather(mesh, p["w_down"], inner, dim=1)}


def _local_ids(idx: Tensor, e0: int, e_loc: int) -> Tensor:
    """Global expert ids -> this rank's local ids; others -> sentinel."""
    local = (idx >= e0) & (idx < e0 + e_loc)
    return torch.where(local, idx - e0, e_loc)


def _apply_moe_sharded(cfg: ModelConfig, p, x: Tensor, valid, dropless,
                       moe_dispatch: str, lay: spmd.Layout):
    mesh, rules = active_context()
    e = cfg.moe
    b_loc, s_loc, d = x.shape
    t = lay.b * lay.s
    plan = _sharded_moe_plan(cfg, lay.b, lay.s)
    if plan is None:
        return _moe_gathered(mesh, rules, cfg, p, x, valid, dropless,
                             moe_dispatch, lay)
    batch_axes, tp, b_n, tp_n, mode = plan
    e_loc = e.n_experts // tp_n
    e0 = mesh.index(tp) * e_loc
    pw = _full_width(mesh, rules, p, e.expert_d_ff)
    if mode == "a2a":
        v = (spmd.take_seq(mesh, rules, valid, lay) if valid is not None
             else None)
        out, counts, dropped, pbar = _moe_a2a(
            mesh, tp, batch_axes, cfg, p["router"], pw, x.reshape(-1, d),
            v.reshape(-1) if v is not None else None, dropless, moe_dispatch,
            e_loc, t, b_loc, s_loc)
        return out.reshape(b_loc, s_loc, d).to(x.dtype), \
            _moe_aux(cfg, counts, dropped, pbar, t)
    # psum: the flattened tokens over the batch axes, whole over model
    t_loc = t // b_n
    xs = spmd.gather_seq(mesh, rules, x, lay).reshape(-1, d)
    vs = valid.reshape(-1) if valid is not None else None
    if not lay.b_split:
        i0 = mesh.index(batch_axes) * t_loc
        xs = xs[i0:i0 + t_loc]
        vs = vs[i0:i0 + t_loc] if vs is not None else None
    idx, w, probs = route(cfg, p, xs)
    if vs is not None:
        idx = torch.where(vs[:, None], idx, e.n_experts)
    idx_l = _local_ids(idx, e0, e_loc)
    if moe_dispatch == "ragged":
        out, counts_l = _dispatch_gmm_combine_ragged(pw, xs, idx_l, w, e_loc)
        dropped_l = torch.zeros((), dtype=torch.long, device=x.device)
    else:
        cap = t_loc if dropless else capacity(cfg, t_loc)
        out, counts_l, dropped_l = _dispatch_gmm_combine(pw, xs, idx_l, w,
                                                         cap, e_loc)
    out = spmd.sum_partials(mesh, out, tp)
    counts = col.all_reduce(mesh, col.all_gather(mesh, counts_l, tp),
                            batch_axes)
    dropped = col.all_reduce(mesh, col.all_reduce(mesh, dropped_l, tp),
                             batch_axes)
    pbar = col.all_reduce(mesh, probs.sum(dim=0), batch_axes) / t
    if not lay.b_split:
        out = col.all_gather(mesh, out, batch_axes, dim=0)
    out = spmd.take_seq(mesh, rules, out.reshape(b_loc, lay.s, d), lay)
    return out.to(x.dtype), _moe_aux(cfg, counts, dropped, pbar, t)


def _jax_groups(b_loc: int, s: int, n: int):
    """Token ids (row * s + position, within the rank's rows) of the
    residual's blocks over ``model`` (all rows x one block of positions),
    and of the JAX region's groups (contiguous blocks of the flattened
    tokens): the a2a regime's dense dispatch groups its tokens as JAX
    does, so their capacities bind alike."""
    s_c = s // n
    ours = [tuple(r * s + m * s_c + i for r in range(b_loc)
                  for i in range(s_c)) for m in range(n)]
    t_loc = b_loc * s_c
    theirs = [tuple(range(m * t_loc, (m + 1) * t_loc)) for m in range(n)]
    return ours, theirs


def _moe_a2a(mesh, tp, batch_axes, cfg, router, pw, xr, vr, dropless,
             moe_dispatch, e_loc, t, b_loc, s_loc):
    """The a2a regime on this rank's t_loc = t / (b_n * tp_n) tokens."""
    e = cfg.moe
    tp_n = mesh.size(tp)
    d = xr.shape[1]
    all_axes = tuple(batch_axes) + tuple(tp)
    if moe_dispatch == "ragged":
        t_loc = xr.shape[0]
        idx, w, probs = route(cfg, {"router": router}, xr)
        if vr is not None:
            idx = torch.where(vr[:, None], idx, e.n_experts)
        a_loc = t_loc * e.top_k
        m_blk, s_pair = ragged_tile_rows(a_loc, e_loc)
        n_send = tp_n * s_pair
        flat = idx.reshape(-1).long()
        counts_l = _expert_counts(flat, e.n_experts)
        padded = (counts_l + m_blk - 1) // m_blk * m_blk
        p2 = padded.reshape(tp_n, e_loc)
        pcum = torch.cumsum(p2, dim=1)
        starts = ((pcum - p2) + torch.arange(tp_n, device=xr.device)[:, None]
                  * s_pair).reshape(-1)
        pos = _group_ranks(flat, counts_l, e.n_experts)
        keep = flat < e.n_experts
        slot = torch.where(keep, starts[flat.clamp(max=e.n_experts - 1)] + pos,
                           n_send)
        buf = _gather_slots(xr, slot, keep, n_send, e.top_k)
        buf = col.all_to_all(mesh, buf.reshape(tp_n, s_pair, d), tp, 0, 0)
        sizes = col.all_to_all(mesh, p2, tp, 0, 0)          # (tp, e_loc)
        ccum = torch.cumsum(sizes, dim=1)
        r0 = (torch.arange(s_pair // m_blk, device=xr.device) * m_blk)
        tile_expert = torch.searchsorted(
            ccum, r0[None].expand(tp_n, -1).contiguous(),
            right=True).reshape(-1).to(torch.int32)
        y = ops.moe_gmm_ragged(buf.reshape(n_send, d), pw["w_gate"],
                               pw["w_up"], pw["w_down"], tile_expert, m_blk)
        y = col.all_to_all(mesh, y.reshape(tp_n, s_pair, d), tp, 0, 0)
        out = _combine_topk(y.reshape(n_send, d), slot, keep, w)
        dropped_l = torch.zeros((), dtype=torch.long, device=xr.device)
    else:
        ours, theirs = _jax_groups(b_loc, s_loc * tp_n, tp_n)
        xr = spmd.regroup(mesh, tp, xr, ours, theirs, dim=0)
        if vr is not None:
            vr = spmd.regroup(mesh, tp, vr.to(torch.int32), ours, theirs,
                              dim=0).bool()
        t_loc = xr.shape[0]
        idx, w, probs = route(cfg, {"router": router}, xr)
        if vr is not None:
            idx = torch.where(vr[:, None], idx, e.n_experts)
        cap = t_loc if dropless else capacity(cfg, t_loc)
        slot, keep, counts_l = dispatch_indices(idx, e.n_experts, cap)
        buf = _gather_slots(xr, slot, keep, e.n_experts * cap, e.top_k)
        # dispatch: (E, cap, d) -> (E_loc, cap * tp, d)
        buf = col.all_to_all(mesh, buf.reshape(e.n_experts, cap, d), tp,
                             split_dim=0, concat_dim=1)
        y = ops.moe_gmm(buf.contiguous(), pw["w_gate"], pw["w_up"],
                        pw["w_down"])
        # combine: back to (E, cap, d), token-major
        y = col.all_to_all(mesh, y, tp, split_dim=1, concat_dim=0)
        out = _combine_topk(y.reshape(e.n_experts * cap, d), slot, keep, w)
        dropped_l = ((idx.reshape(-1) < e.n_experts) & ~keep).sum()
        out = spmd.regroup(mesh, tp, out, theirs, ours, dim=0)
    counts = col.all_reduce(mesh, counts_l, all_axes)
    dropped = col.all_reduce(mesh, dropped_l, all_axes)
    pbar = col.all_reduce(mesh, probs.sum(dim=0), all_axes) / t
    return out, counts, dropped, pbar


def _moe_gathered(mesh, rules, cfg, p, x, valid, dropless, moe_dispatch,
                  lay):
    """Where JAX leaves the call to GSPMD (few tokens): every rank takes
    all of the call's tokens (gathered over ``model`` and the batch axes;
    a decode step's are few), routes them, and runs its local experts over
    its FFN-width shard; the partial outputs are summed over ``model`` and
    ``data``, and each rank keeps its own rows.  Capacity, counts and
    drops are the unsharded call's, exactly: the dispatch ranks the whole
    call's tokens within each expert."""
    e = cfg.moe
    tp, batch_axes = rules.get("tp"), rules.get("batch")
    b_loc, _, d = x.shape
    xs = spmd.gather_seq(mesh, rules, x, lay)
    vs = valid
    if lay.b_split:
        xs = col.all_gather(mesh, xs, batch_axes, dim=0)
        vs = col.all_gather(mesh, vs.to(torch.int32), batch_axes,
                            dim=0).bool() if vs is not None else None
    t = lay.b * lay.s
    xf = xs.reshape(t, d)
    idx, w, probs = route(cfg, p, xf)
    if vs is not None:
        idx = torch.where(vs.reshape(t, 1), idx, e.n_experts)
    e_loc = p["w_gate"].shape[0]
    e_split = e_loc != e.n_experts
    f_split = p["w_gate"].shape[-1] != e.expert_d_ff
    e0 = mesh.index(tp) * e_loc if e_split else 0
    idx_l = _local_ids(idx, e0, e_loc)
    counts = _expert_counts(idx.reshape(-1).long(), e.n_experts)
    if moe_dispatch == "ragged":
        out, _ = _dispatch_gmm_combine_ragged(p, xf, idx_l, w, e_loc)
        dropped = torch.zeros((), dtype=torch.long, device=x.device)
    else:
        cap = t if dropless else capacity(cfg, t)
        out, _, _ = _dispatch_gmm_combine(p, xf, idx_l, w, cap, e_loc)
        dropped = (counts - cap).clamp(min=0).sum()
    axes = ((tuple(rules.get("expert_inner") or ()) if f_split else ())
            + (tuple(tp or ()) if e_split else ()))
    if axes:
        out = spmd.sum_partials(mesh, out, axes)
    out = out.reshape(lay.b, lay.s, d)
    if lay.b_split:
        out = spmd.take_rows(mesh, rules, out, lay)
    out = spmd.take_seq(mesh, rules, out, lay)
    return out.to(x.dtype), _moe_aux(cfg, counts, dropped,
                                     probs.mean(dim=0), t)


def empty_moe_aux(cfg: ModelConfig, device) -> dict:
    """Aux dict of the same structure for blocks without MoE."""
    n = max(cfg.moe.n_experts, 1)
    return {
        "expert_counts": torch.zeros((n,), dtype=torch.int32, device=device),
        "active_experts": torch.zeros((), dtype=torch.int32, device=device),
        "dropped": torch.zeros((), dtype=torch.int32, device=device),
        "aux_loss": torch.zeros((), dtype=torch.float32, device=device),
    }
