"""The plain pieces both references share.  ``precision`` is "fp32" (the
reference) or "fp8" (the control: every matrix product's operands
rounded to float8 e4m3, the weights by output column, the activations
and attention's queries, keys and values by row, each scaled to its
largest magnitude; the rest in float32)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Q_BLOCK = 1024             # queries a block of attention
E4M3_MAX = 448.0


def fp32_matmuls() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _e4m3(t: Tensor, dim: int) -> Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def lin(x: Tensor, w: Tensor, precision: str) -> Tensor:
    """x (N, a) @ w (a, b) in float32, or with fp8 operands."""
    wf = w.float()
    if precision == "fp8":
        return _e4m3(x, -1) @ _e4m3(wf, 0)
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ wf


def rms(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """Rotary embedding of x (N, heads, dim) at positions pos (N,): the
    two halves of the dim rotated as pairs, angle pos / theta^(2i/dim)."""
    dim = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=x.device) / dim)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: Tensor, k: Tensor, v: Tensor,
                     precision: str = "fp32") -> Tensor:
    """q (N, H, dk), k (N, Hkv, dk), v (N, Hkv, dv) -> (N, H, dv), causal,
    scaled by 1/sqrt(dk); query head h reads key/value head h % Hkv.
    Under "fp8" q, k and v are rounded to e4m3, each row of a head by its
    own scale."""
    if precision == "fp8":
        q, k, v = _e4m3(q, -1), _e4m3(k, -1), _e4m3(v, -1)
    n, h, dk = q.shape
    hkv = k.shape[1]
    idx = torch.arange(h, device=q.device) % hkv
    kh, vh = k[:, idx].transpose(0, 1), v[:, idx].transpose(0, 1)
    out = torch.empty((n, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for a in range(0, n, Q_BLOCK):
        b = min(n, a + Q_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], kh[:, :b]) / math.sqrt(dk)
        mask = torch.arange(b, device=q.device)[None] > \
            torch.arange(a, b, device=q.device)[:, None]
        s.masked_fill_(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1),
                                vh[:, :b])
    return out


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
           precision: str) -> Tensor:
    return lin(F.silu(lin(x, w_gate, precision)) * lin(x, w_up, precision),
               w_down, precision)


def routed_experts(x: Tensor, router: Tensor, w_gate: Tensor, w_up: Tensor,
                   w_down: Tensor, top_k: int, precision: str) -> Tensor:
    """Softmax over every expert in float32, the top ``top_k`` (ties to
    the lower index), their weights renormalised to sum to 1; each
    expert's SwiGLU over its tokens, its weights upcast as it runs."""
    probs = torch.softmax(x @ router.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        y = swiglu(x[tok], w_gate[e], w_up[e], w_down[e], precision)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out
