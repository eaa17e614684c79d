"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent gate connections), both with exponential
gating and the max-stabilizer state m.

State per mLSTM block:  C (B, H, dk, dk), n (B, H, dk), m (B, H) in fp32,
conv tail (B, 3, D_inner) in the model dtype.
State per sLSTM block:  c, n, h, m (B, D) in fp32.

mLSTM prefill takes the chunkwise-parallel form under exactly the JAX
package's condition (S a multiple of 128 and at least 256: the two forms
round differently), else a loop of single steps, as does decode.  sLSTM is
sequential by construction: a loop of single steps.  The JAX package has
no Pallas kernel here; the port runs plain PyTorch, the large products
through ``torch.matmul``.  As with the attention caches, ``apply_mlstm``
and ``apply_slstm`` write the new state IN PLACE into the dict they are
given and return it.

Under a sharding context (``lay``) the JAX package's specs keep every
recurrent weight whole and split only the up and down projections:

- mLSTM: ``w_up`` is a column block, so the rank computes its columns of
  ``xin`` and of the depthwise conv (the cache's ``conv`` tail holds the
  same columns); ``w_q``/``w_k``/``w_if`` read the whole conv output and
  ``w_v`` the whole ``xin``, so both are gathered over ``model`` and the
  recurrence runs whole on every rank (``C``, ``n``, ``m`` are whole over
  ``model``).  ``h * silu(z)`` is cut to the rank's ``w_down`` rows (``z``
  computed for those columns only) and summed by ``spmd.reduce_rows``.
- sLSTM: the recurrence runs whole on every rank; the cache's ``h`` lies
  split over ``model`` (the JAX rule for RG-LRU's ``h`` catches it by
  name), so it is gathered on entry and cut on exit.  The GLU pairs
  column c of ``h @ w_up`` with column d + c, which lie on different
  ranks of a column-split ``w_up``: one regroup brings the rank the two
  halves its ``w_down`` rows take.

A rank's gradient of a recurrent weight is then its share, through its
own columns of the output (``sharding/collectives.py``'s convention).

The two recurrences are Python loops (sLSTM's S steps of a few dozen
small ops, the chunkwise mLSTM's S/128 chunks of a few hundred); the
dry-run traces each as one op (``launch/analysis.one_op_recurrences``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import causal_conv
from repro_torch.sharding import collectives as col
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import active_context

Tensor = torch.Tensor
_NEG = -1e30        # the stabilizer's start: "no input yet"


def _inner(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model


def _heads(cfg: ModelConfig) -> int:
    return max(cfg.n_heads, 1)


def _where_rows(ok: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """``new`` on the rows (axis 0) where ``ok``, else ``old``."""
    return torch.where(ok.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def _store(cache: dict, state: dict) -> dict:
    for k, v in state.items():
        cache[k].copy_(v)
    return cache


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(cfg: ModelConfig, device, generator, reps: int = 0) -> dict:
    d, di, h = cfg.d_model, _inner(cfg), _heads(cfg)
    dt = torch_dtype(cfg.param_dtype)

    def dense(shape, scale=None):
        return layers.dense_init(shape, dt, device, generator, scale=scale,
                                 reps=reps)
    lead = (reps,) if reps else ()
    b_if = torch.cat([torch.zeros(h), 3.0 * torch.ones(h)]).to(dt)
    return {
        "w_up": dense((d, di)),
        "w_z": dense((d, di)),                      # output gate branch
        "conv_w": dense((4, di), scale=0.1),
        "conv_b": torch.zeros(lead + (di,), dtype=dt, device=device),
        "w_q": dense((di, di)),
        "w_k": dense((di, di)),
        "w_v": dense((di, di)),
        "w_if": dense((di, 2 * h), scale=0.02),     # i, f gate logits
        "b_if": b_if.to(device).expand(lead + (2 * h,)).clone(),
        "w_down": dense((di, d)),
    }


def init_cache_mlstm(cfg: ModelConfig, batch: int, device,
                     dtype=None) -> dict:
    di, h = _inner(cfg), _heads(cfg)
    dk = di // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dk, dk), **f32),
            "n": torch.zeros((batch, h, dk), **f32),
            "m": torch.full((batch, h), _NEG, **f32),
            "conv": torch.zeros((batch, 3, di), device=device,
                                dtype=dtype or torch_dtype(cfg.dtype))}


def _conv4(p, x: Tensor, tail: Optional[Tensor],
           valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The width-4 causal conv, then SiLU; the tail as in
    ``rglru.causal_conv``."""
    y, new_tail = causal_conv(p, x, tail, valid)
    return F.silu(y), new_tail


def _mlstm_step(q, k, v, log_i, log_f, state):
    """One timestep.  q, k, v: (B, H, dk); log_i/log_f: (B, H)."""
    C, n, m = state
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)[..., None]
    f_p = torch.exp(log_f + m - m_new)[..., None]
    C = f_p[..., None] * C + i_p[..., None] * (k[..., :, None] * v[..., None, :])
    n = f_p * n + i_p * k
    denom = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    h = torch.einsum("bhkv,bhk->bhv", C, q) / denom[..., None]
    return (C, n, m_new), h


CHUNK_W = 128


def mlstm_chunkwise(q, k, v, log_i, log_f, state, valid=None):
    """The chunkwise-parallel mLSTM: an exact reformulation of the
    per-step recurrence over chunks of ``CHUNK_W`` steps (the JAX
    package's ``_mlstm_chunkwise``).  With F_t = cumsum(log_f) and
    g_t = log_i_t - F_t the stabilizer is m_t = F_t + M_t, M_t =
    max(m_0, cummax_{j<=t} g_j); step j contributes exp(g_j - M_t) k_j v_j^T
    at time t and the carried state scales by exp(m_0 - M_t).  Masked
    positions are set before the exponent (positions past the diagonal
    have positive exponents).

    q, k, v: (B, S, H, dk) fp32; log_i/log_f: (B, S, H); valid (B, S) or
    None.  Returns (state', h (B, S, H, dk))."""
    b, s_len, hh, dk = q.shape
    w = CHUNK_W
    causal = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    C0, n0, m0 = state
    hs = []
    for c in range(s_len // w):
        sl = slice(c * w, (c + 1) * w)
        ok = (valid[:, sl].bool() if valid is not None else
              torch.ones((b, w), dtype=torch.bool, device=q.device))
        li = torch.where(ok[:, :, None], log_i[:, sl], _NEG)
        lf = torch.where(ok[:, :, None], log_f[:, sl], 0.0)
        Fc = torch.cumsum(lf, dim=1)                        # (B, W, H)
        g = li - Fc
        M = torch.maximum(torch.cummax(g, dim=1).values, m0[:, None])

        qh = q[:, sl].transpose(1, 2)                       # (B, H, W, dk)
        kh = k[:, sl].transpose(1, 2)
        vh = v[:, sl].transpose(1, 2)
        dots = torch.einsum("bhid,bhjd->bhij", qh, kh)
        expo = (g.transpose(1, 2)[:, :, None, :]
                - M.transpose(1, 2)[:, :, :, None])
        keep = causal[None, None] & ok[:, None, None, :]
        scores = dots * torch.exp(torch.where(keep, expo, _NEG))
        h_intra = torch.einsum("bhij,bhjd->bhid", scores, vh)

        a = torch.exp(m0[:, None] - M).transpose(1, 2)      # (B, H, W)
        h_inter = torch.einsum("bhid,bhde->bhie", qh, C0) * a[..., None]
        qn0 = torch.einsum("bhid,bhd->bhi", qh, n0) * a
        denom = qn0 + torch.sum(scores, dim=-1)
        h = (h_inter + h_intra) / torch.clamp(torch.abs(denom),
                                              min=1.0)[..., None]

        M_W, F_W = M[:, -1], Fc[:, -1]                      # (B, H)
        decay = torch.exp(g - M_W[:, None]) * ok[:, :, None]
        kd = kh * decay.transpose(1, 2)[..., None]
        scale = torch.exp(m0 - M_W)
        C0 = scale[..., None, None] * C0 + torch.einsum("bhjd,bhje->bhde",
                                                        kd, vh)
        n0 = scale[..., None] * n0 + torch.sum(kd, dim=2)
        m0 = F_W + M_W
        hs.append(h.transpose(1, 2))                        # (B, W, H, dk)
    return (C0, n0, m0), torch.cat(hs, dim=1)


def mlstm_stepwise(q, k, v, log_i, log_f, state, valid=None):
    """The per-step recurrence over S; masked steps keep the state
    verbatim.  Same arguments and result as ``mlstm_chunkwise``."""
    hs = []
    for t in range(q.shape[1]):
        new, h = _mlstm_step(q[:, t], k[:, t], v[:, t], log_i[:, t],
                             log_f[:, t], state)
        if valid is not None:
            ok = valid[:, t].bool()
            new = tuple(_where_rows(ok, nw, old) for nw, old in zip(new, state))
        state = new
        hs.append(h)
    return state, torch.stack(hs, dim=1)


def _rank_cols(mesh, tp, c: int) -> slice:
    """The rank's block of ``c`` columns over ``model``."""
    j = mesh.index(tp)
    return slice(j * c, (j + 1) * c)


def apply_mlstm(cfg: ModelConfig, p, x: Tensor, *,
                cache: Optional[dict] = None,
                valid: Optional[Tensor] = None, lay=None
                ) -> Tuple[Tensor, Optional[dict]]:
    """x: (B, S, D) -> (out, cache written in place); ``lay`` (under a
    sharding context): x is the rank's block of the residual (the module
    docstring)."""
    di, hh = _inner(cfg), _heads(cfg)
    dk = di // hh
    split = None
    if lay is not None:
        mesh, rules = active_context()
        tp = rules.get("tp")
        x = spmd.gather_seq(mesh, rules, x, lay)
        if p["w_up"].shape[-1] != di:
            split = _rank_cols(mesh, tp, p["w_up"].shape[-1])
    b, s, _ = x.shape
    xin = x @ p["w_up"]
    pc = p
    if split is not None:
        pc = dict(p, conv_w=p["conv_w"][:, split], conv_b=p["conv_b"][split])
        z = x @ p["w_z"][:, split]
    else:
        z = x @ p["w_z"]
    xc, new_tail = _conv4(pc, xin, cache["conv"] if cache is not None
                          else None, valid)
    if split is not None:
        xin = col.all_gather(mesh, xin, tp, dim=-1)
        xc = col.all_gather(mesh, xc, tp, dim=-1)
    q = (xc @ p["w_q"]).reshape(b, s, hh, dk).float() / (dk ** 0.5)
    k = (xc @ p["w_k"]).reshape(b, s, hh, dk).float() / (dk ** 0.5)
    v = (xin @ p["w_v"]).reshape(b, s, hh, dk).float()
    gates = xc.float() @ p["w_if"].float() + p["b_if"].float()
    log_i, f_raw = gates[..., :hh], gates[..., hh:]
    log_f = -F.softplus(-f_raw)                             # log sigmoid(f)

    if cache is not None:
        state = (cache["C"], cache["n"], cache["m"])
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, hh, dk, dk), **f32),
                 torch.zeros((b, hh, dk), **f32),
                 torch.full((b, hh), _NEG, **f32))
    form = (mlstm_chunkwise if s % CHUNK_W == 0 and s >= 2 * CHUNK_W
            else mlstm_stepwise)
    state, h = form(q, k, v, log_i, log_f, state, valid)
    h = h.reshape(b, s, di).to(x.dtype)
    if split is not None:
        h = h[..., split]
    out = (h * F.silu(z)) @ p["w_down"]
    if cache is not None:
        _store(cache, {"C": state[0], "n": state[1], "m": state[2],
                       "conv": new_tail})
    if lay is not None:
        out = spmd.reduce_rows(mesh, rules, out, lay, split is not None)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(cfg: ModelConfig, device, generator, reps: int = 0) -> dict:
    d, h = cfg.d_model, _heads(cfg)
    dh = d // h
    dt = torch_dtype(cfg.param_dtype)

    def dense(shape, scale=None):
        return layers.dense_init(shape, dt, device, generator, scale=scale,
                                 reps=reps)
    lead = (reps,) if reps else ()
    b_zifo = torch.cat([torch.zeros(2 * d), 3.0 * torch.ones(d),
                        torch.zeros(d)]).to(dt)
    return {
        "w_zifo": dense((d, 4 * d)),                # input weights z, i, f, o
        "b_zifo": b_zifo.to(device).expand(lead + (4 * d,)).clone(),
        "r_zifo": dense((4, h, dh, dh), scale=0.02),  # per-head recurrent
        "w_up": dense((d, 2 * d)),
        "w_down": dense((d, d)),                    # after the GLU halves
    }


def init_cache_slstm(cfg: ModelConfig, batch: int, device,
                     dtype=None) -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), _NEG, **f32)}


def _slstm_step(wx: Tensor, r: Tensor, state):
    """One timestep from its input projection ``wx`` (B, 4D) fp32 (bias
    included) and the per-head recurrent weights ``r`` (4, H, dh, dh)
    fp32.  Sequential by construction (recurrent gate connections)."""
    c, n, h, m = state
    b, d = c.shape
    hh = r.shape[1]
    rec = torch.einsum("bhd,ghde->gbhe", h.reshape(b, hh, d // hh),
                       r).reshape(4, b, d)
    z_raw, i_raw, f_raw, o_raw = torch.split(wx, d, dim=-1)
    z = torch.tanh(z_raw + rec[0])
    log_i = i_raw + rec[1]
    log_f = -F.softplus(-(f_raw + rec[2]))                  # log sigmoid
    o = torch.sigmoid(o_raw + rec[3])
    m_new = torch.maximum(log_f + m, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    return (c, n, o * c / torch.clamp(n, min=1.0), m_new)


def slstm_scan(wx: Tensor, r: Tensor, state, valid: Optional[Tensor]):
    """The recurrence over S: wx (B, S, 4D) fp32, the input projection of
    every step; masked steps keep the state verbatim.  Returns (state',
    hs (B, S, D) fp32)."""
    hs = []
    for t in range(wx.shape[1]):
        new = _slstm_step(wx[:, t], r, state)
        if valid is not None:
            ok = valid[:, t].bool()
            new = tuple(_where_rows(ok, nw, old) for nw, old in zip(new, state))
        state = new
        hs.append(state[2])
    return state, torch.stack(hs, dim=1)


def apply_slstm(cfg: ModelConfig, p, x: Tensor, *,
                cache: Optional[dict] = None,
                valid: Optional[Tensor] = None, lay=None
                ) -> Tuple[Tensor, Optional[dict]]:
    """x: (B, S, D) -> (out, cache written in place); ``lay`` (under a
    sharding context): x is the rank's block of the residual (the module
    docstring)."""
    d = cfg.d_model
    if lay is not None:
        mesh, rules = active_context()
        tp = rules.get("tp")
        x = spmd.gather_seq(mesh, rules, x, lay)
    b, s, _ = x.shape
    if cache is not None:
        h0 = cache["h"]
        if h0.shape[-1] != d:               # split over model
            h0 = col.all_gather(mesh, h0, tp, dim=-1)
        state = (cache["c"], cache["n"], h0, cache["m"])
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, d), **f32), torch.zeros((b, d), **f32),
                 torch.zeros((b, d), **f32), torch.full((b, d), _NEG, **f32))
    wx = x.float() @ p["w_zifo"].float() + p["b_zifo"].float()
    state, hs = slstm_scan(wx, p["r_zifo"].float(), state, valid)
    h = hs.to(x.dtype)                                      # (B, S, D)
    u = h @ p["w_up"]
    partial = p["w_down"].shape[0] != d
    if lay is not None and u.shape[-1] != 2 * d:
        # the GLU's halves of the rank's w_down rows: columns c and d + c
        n = mesh.size(tp)
        rows = spmd.block_sets(d, partial, n)
        u = spmd.regroup(mesh, tp, u, spmd.block_sets(2 * d, True, n),
                         [r + tuple(d + i for i in r) for r in rows])
    a, g = torch.chunk(u, 2, dim=-1)                        # the GLU
    out = (a * torch.sigmoid(g)) @ p["w_down"]
    if cache is not None:
        c, n_, h_last, m = state
        if cache["h"].shape[-1] != d:
            h_last = h_last[..., _rank_cols(mesh, tp, cache["h"].shape[-1])]
        _store(cache, {"c": c, "n": n_, "h": h_last, "m": m})
    if lay is not None:
        out = spmd.reduce_rows(mesh, rules, out, lay, partial)
    return out, cache
