"""RecurrentGemma's recurrent block: causal depthwise conv + RG-LRU
(Real-Gated Linear Recurrent Unit), arXiv:2402.19427.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),  c = 8

The recurrence is linear in h, so prefill runs it as a log-depth scan in
plain PyTorch: ``ceil(log2 S)`` combine steps over the whole (B, S, W)
tensor, never a loop over S.  The JAX package's ``associative_scan``
combines in another order, so ``h`` agrees within fp32 rounding, not bit
for bit.  Decode (S = 1) is one step.  The JAX package has no Pallas
kernel here; neither has the port.

State per block: conv tail (B, conv_width-1, W) in the model dtype and the
LRU hidden (B, W) in fp32.  As with the attention caches
(models/attention.py), ``apply_rglru`` writes the new state IN PLACE into
the dict it is given (views into the engine's pool) and returns it.

Under a sharding context (``lay``) the block runs on the rank's W columns
(``_rank_params``): ``w_x`` and ``w_gate`` are column blocks, the cache's
``conv`` and ``h`` the same columns, and the replicated ``conv_w``,
``conv_b``, ``a_param`` and ``w_rec_gate`` are sliced to them (whole gate
blocks).  The spec splits ``w_input_gate`` (16, W/16, W/16) by output
column inside every block, so the rank's whole blocks come from one
all-to-all of the weight (2 MB a layer at recurrentgemma-9b, against the
(B, S, W) activations a regroup of the other side would move); its
backward is the reverse all-to-all, so the gradient lands in the spec's
layout.  The residual is gathered over the sequence first, the scan runs
over the whole sequence of the rank's rows, and ``w_out``'s row block
gives a partial sum for ``spmd.reduce_rows``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as col
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import active_context

Tensor = torch.Tensor
_C = 8.0
_N_GATE_BLOCKS = 16


def lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _block_diag(x: Tensor, w: Tensor) -> Tensor:
    """x: (..., W) @ block-diagonal w: (NB, W/NB, W/NB) -> (..., W)."""
    nb, bw, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bw))
    return torch.einsum("...nb,nbc->...nc", xb, w).reshape(x.shape)


def init_rglru(cfg: ModelConfig, draw, path: str, reps: int = 0) -> dict:
    """The JAX package's distributions: dense weights normal x
    1/sqrt(fan_in) (0.1 for the conv, 0.02 for the block-diagonal gates),
    and ``a_param`` in fp32 such that a^2 ~ U[0.81, 0.999] (the paper's
    init) through the inverse softplus."""
    d, w = cfg.d_model, lru_width(cfg)
    dt = torch_dtype(cfg.param_dtype)

    def dense(name, shape, scale=None):
        return layers.dense_init(draw, f"{path}/{name}", shape, dt,
                                 scale=scale, reps=reps)
    lead = (reps,) if reps else ()

    def a_param(u):
        log_a = 0.5 * torch.log(u)
        return torch.log(torch.expm1(-log_a / _C))
    nb = _N_GATE_BLOCKS
    return {
        "w_x": dense("w_x", (d, w)),
        "w_gate": dense("w_gate", (d, w)),
        "w_out": dense("w_out", (w, d)),
        "conv_w": dense("conv_w", (cfg.conv_width, w), scale=0.1),
        "conv_b": draw.full(f"{path}/conv_b", lead + (w,), dt, 0.0),
        "w_input_gate": dense("w_input_gate", (nb, w // nb, w // nb),
                              scale=0.02),
        "w_rec_gate": dense("w_rec_gate", (nb, w // nb, w // nb),
                            scale=0.02),
        "a_param": draw.uniform(f"{path}/a_param", lead + (w,),
                                torch.float32, 0.81, 0.999, then=a_param),
    }


def init_cache_rglru(cfg: ModelConfig, batch: int, device,
                     dtype=None) -> dict:
    w = lru_width(cfg)
    dt = dtype or torch_dtype(cfg.dtype)
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def causal_conv(p, x: Tensor, conv_state: Optional[Tensor],
                valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d (no activation).  x: (B, S, W) ->
    (y, new tail).  With ``valid`` (B, S) the tail is taken at each row's
    true length (the last cw-1 real inputs, gathered), so right-padding
    never enters the decode-time state; a row with no valid token keeps
    its tail.  Valid tokens are a prefix of each row."""
    cw = p["conv_w"].shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], cw - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)     # (B, S+cw-1, W)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(cw))
    y = y + p["conv_b"]
    if valid is None:
        return y, xp[:, s:]
    lengths = valid.sum(-1).long()                          # (B,)
    idx = lengths[:, None] + torch.arange(cw - 1, device=x.device)[None]
    tail = torch.gather(xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
    return y, tail


def lru_scan(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 from ``h0`` (B, W): a log-depth
    (Hillis-Steele) scan — step d combines each position with the one d
    earlier.  Returns h at every t, (B, S, W)."""
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rank_params(cfg: ModelConfig, p, mesh, tp) -> dict:
    """The block's parameters for the rank's W columns (its ``w_x``
    block): the replicated leaves sliced to them, ``w_input_gate``'s
    whole blocks by an all-to-all.  Unchanged where the guard kept W
    whole."""
    w, c = lru_width(cfg), p["w_x"].shape[-1]
    if c == w:
        return p
    bw = w // _N_GATE_BLOCKS
    if c % bw:
        raise NotImplementedError(
            f"RG-LRU under a mesh: the rank's {c} of {w} columns do not "
            f"cover whole gate blocks of {bw}")
    j = mesh.index(tp)
    cols, blocks = slice(j * c, (j + 1) * c), slice(j * c // bw,
                                                     (j + 1) * c // bw)
    ig = p["w_input_gate"]
    ig = (ig[blocks] if ig.shape[-1] == bw
          else col.all_to_all(mesh, ig, tp, split_dim=0, concat_dim=2))
    return dict(p, conv_w=p["conv_w"][:, cols], conv_b=p["conv_b"][cols],
                a_param=p["a_param"][cols],
                w_rec_gate=p["w_rec_gate"][blocks], w_input_gate=ig)


def apply_rglru(cfg: ModelConfig, p, x: Tensor, *,
                cache: Optional[dict] = None,
                valid: Optional[Tensor] = None, lay=None
                ) -> Tuple[Tensor, Optional[dict]]:
    """x: (B, S, D) -> (out (B, S, D), cache written in place).  ``valid``
    (B, S) turns masked timesteps into identity state updates (a = 1,
    b = 0), so padding and idle rows never perturb the state: a fully
    masked row keeps ``conv`` and ``h`` bit for bit.  ``lay`` (under a
    sharding context): x is the rank's block of the residual and the
    block runs on its W columns (the module docstring)."""
    if lay is not None:
        mesh, rules = active_context()
        tp = rules.get("tp")
        y, cache = apply_rglru(
            cfg, _rank_params(cfg, p, mesh, tp),
            spmd.gather_seq(mesh, rules, x, lay), cache=cache, valid=valid)
        return spmd.reduce_rows(mesh, rules, y, lay,
                                p["w_out"].shape[0] != lru_width(cfg)), cache
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")      # (B, S, W)
    xin = x @ p["w_x"]
    xc, new_tail = causal_conv(p, xin, cache["conv"] if cache is not None
                               else None, valid)
    xf = xc.float()
    rg = torch.sigmoid(_block_diag(xf, p["w_rec_gate"].float()))
    ig = torch.sigmoid(_block_diag(xf, p["w_input_gate"].float()))
    log_a = -_C * F.softplus(p["a_param"]) * rg
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bt = mult * (ig * xf)
    if valid is not None:
        v = valid[..., None]
        a = torch.where(v, a, 1.0)
        bt = torch.where(v, bt, 0.0)
    h0 = cache["h"] if cache is not None else torch.zeros(
        (x.shape[0], xin.shape[-1]), dtype=torch.float32, device=x.device)
    h = lru_scan(a, bt, h0)
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    if cache is not None:
        tail = new_tail.to(cache["conv"].dtype)
        if valid is not None:
            tail = torch.where(valid.any(-1)[:, None, None], tail,
                               cache["conv"])
        cache["conv"].copy_(tail)
        cache["h"].copy_(h[:, -1])
    return y, cache
