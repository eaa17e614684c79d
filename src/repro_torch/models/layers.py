"""Shared primitive layers: norms, rotary embeddings, MLPs, embedding.

Plain functions over a parameter dict, with the JAX package's layouts:
weights are applied as ``x @ W`` with ``W`` of shape ``(d_in, d_out)``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Init (same distributions as the JAX package's ``layers._dense``)
# ---------------------------------------------------------------------------


def dense_init(shape, dtype: torch.dtype, device: torch.device,
               generator: torch.Generator, scale: Optional[float] = None,
               reps: int = 0) -> Tensor:
    """normal * 1/sqrt(shape[0]) (or * ``scale``), drawn directly in
    ``dtype`` on ``device`` — the full bf16 model never passes through fp32
    on the host.  ``reps > 0`` draws a stack of ``reps`` such leaves at
    once (a segment's stacked parameters)."""
    std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = (reps,) + tuple(shape) if reps else tuple(shape)
    w = torch.randn(full, dtype=dtype, device=device, generator=generator)
    return w.mul_(std)


def init_norm(cfg: ModelConfig, device: torch.device,
              dim: Optional[int] = None, reps: int = 0) -> dict:
    d = dim or cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    shape = (reps, d) if reps else (d,)
    p = {"scale": torch.ones(shape, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dt, device=device)
    return p


def init_mlp(cfg: ModelConfig, device, generator, d_ff: Optional[int] = None,
             reps: int = 0):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    dt = torch_dtype(cfg.param_dtype)

    def w(shape):
        return dense_init(shape, dt, device, generator, reps=reps)
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": w((d, f)), "w_up": w((d, f)), "w_down": w((f, d))}
    return {"w_up": w((d, f)), "w_down": w((f, d))}


def init_embed(cfg: ModelConfig, device, generator) -> dict:
    dt = torch_dtype(cfg.param_dtype)
    p = {"tok": dense_init((cfg.vocab_size, cfg.d_model), dt, device,
                           generator, scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), dt, device,
                                  generator)
    if cfg.pos_emb == "learned":
        p["pos"] = dense_init((cfg.max_seq_len, cfg.d_model), dt, device,
                              generator, scale=0.02)
    return p


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def apply_norm(cfg: ModelConfig, p, x: Tensor) -> Tensor:
    """RMSNorm / LayerNorm computed in fp32, cast back to ``x.dtype``."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


def rope_freqs(dim: int, theta: float, device) -> Tensor:
    """Inverse frequencies for a rotary dim (must be even)."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def _rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Half-split rotation: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               rotary_pct: float = 1.0) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S).  Rotates the first
    ``rotary_pct`` of the head dim, in fp32, then casts back."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_freqs(rot, theta, x.device)
    ang = positions.float()[..., None] * inv            # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot = _rotate(x[..., :rot].float(), cos, sin).to(x.dtype)
    if rot == hd:
        return x_rot
    return torch.cat([x_rot, x[..., rot:]], dim=-1)


def apply_mrope(x: Tensor, positions3: Tensor, theta: float,
                sections: Tuple[int, ...]) -> Tensor:
    """Qwen2-VL M-RoPE.  x: (B, S, H, hd); positions3: (3, B, S), the
    (temporal, height, width) position ids; ``sections`` splits the hd/2
    frequency channels among the three planes.  With three equal planes
    (text) it is ``apply_rope``."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    inv = rope_freqs(hd, theta, x.device)
    # which position plane drives each frequency channel: JAX's
    # repeat(arange(3), sections), built on the device from the sections'
    # boundaries (no host-to-device copy)
    chan = torch.arange(hd // 2, device=x.device)
    sel = torch.zeros_like(chan)
    for edge in np.cumsum(sections)[:-1]:
        sel += chan >= int(edge)
    ang = positions3.float().movedim(0, -1)[..., sel] * inv   # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def position_plane(positions: Tensor) -> Tensor:
    """Text-only M-RoPE position ids: (B, S) -> (3, B, S), equal planes."""
    return positions[None].expand((3,) + tuple(positions.shape))


def apply_mlp(cfg: ModelConfig, p, x: Tensor, lay=None) -> Tensor:
    """The dense MLP.  ``lay`` (under a sharding context): x is this
    rank's block of the residual; ``w_gate``/``w_up`` are column shards
    and ``w_down`` a row shard of d_ff, so the rank reads its rows at every
    position and its partial output is summed back into the layout (a
    reduce-scatter over the sequence where the layout splits it)."""
    if lay is not None:
        from repro_torch.sharding import spmd
        from repro_torch.sharding.partition import active_context
        mesh, rules = active_context()
        y = apply_mlp(cfg, p, spmd.gather_seq(mesh, rules, x, lay))
        return spmd.reduce_rows(mesh, rules, y, lay,
                                p["w_down"].shape[0] != cfg.d_ff)
    if cfg.activation in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        act = F.silu(g) if cfg.activation == "swiglu" \
            else F.gelu(g, approximate="tanh")
        return (act * u) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def embed_tokens(cfg: ModelConfig, p, tokens: Tensor) -> Tensor:
    """Token embeddings.  Under a sharding context with the table's rows
    split over ``model`` (vocab parallel): a masked lookup of the rank's
    rows, summed over ``model``; a table the guard kept whole (minicpm's
    122753 rows on 16 ranks) is read whole."""
    tok = p["tok"]
    if tok.shape[0] != cfg.vocab_size:
        from repro_torch.sharding import collectives as col
        from repro_torch.sharding.partition import active_context
        mesh, rules = active_context()
        tp = rules.get("tp")
        v_loc = tok.shape[0]
        loc = tokens.long() - mesh.index(tp) * v_loc
        ok = (loc >= 0) & (loc < v_loc)
        x = torch.where(ok[..., None], tok[loc.clamp(0, v_loc - 1)],
                        torch.zeros((), dtype=tok.dtype, device=tok.device))
        return col.all_reduce(mesh, x.to(torch_dtype(cfg.dtype)), tp)
    return tok[tokens].to(torch_dtype(cfg.dtype))


def unembed(cfg: ModelConfig, p, x: Tensor) -> Tensor:
    """Matmul in ``x.dtype``, logits in fp32.  On vocab-split shards the
    logits are this rank's vocab columns (the serve steps gather the last
    position's; the training loss reads them where they lie,
    ``token_nll``)."""
    w = p["tok"].t() if cfg.tie_embeddings else p["lm_head"]
    logits = (x @ w.to(x.dtype)).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def token_nll(logits: Tensor, targets: Tensor, mesh, axes) -> Tensor:
    """-log softmax(logits)[target] per token, fp32: logits (..., V_loc)
    fp32, targets (...), vocab parallel over ``axes`` of ``mesh`` (None:
    the whole vocab).  The logits are this rank's block of the vocab
    columns (rank j of n holds [j V_loc, (j + 1) V_loc)) and are never
    gathered: the row maximum comes from an all-reduce max (detached: a
    constant shift), the sum of exponentials from an all-reduce sum, and
    the target's logit from the rank that owns its column, all-reduced.
    Every rank of ``axes`` returns the same values."""
    from repro_torch.sharding import collectives as col
    v_loc = logits.shape[-1]
    m = col.all_reduce_max(mesh, logits.max(dim=-1).values, axes)
    z = logits - m[..., None]
    loc = targets.long() - mesh.index(axes) * v_loc
    ok = (loc >= 0) & (loc < v_loc)
    zt = torch.gather(z, -1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
    zt = torch.where(ok, zt, torch.zeros((), dtype=zt.dtype,
                                         device=zt.device))
    se = col.all_reduce(mesh, torch.exp(z).sum(dim=-1), axes)
    return torch.log(se) - col.all_reduce(mesh, zt, axes)
