"""Shared primitive layers: norms, rotary embeddings, MLPs, embedding.

Plain functions over a parameter dict, with the JAX package's layouts:
weights are applied as ``x @ W`` with ``W`` of shape ``(d_in, d_out)``.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Init: a counter-based draw (the JAX package's ``layers._dense``
# distributions)
# ---------------------------------------------------------------------------

# a chunk of a random leaf holds at most this many elements (32 MiB of bf16)
CHUNK = 1 << 24


def chunk_layout(shape) -> Tuple[int, int]:
    """``(k, rows)``: a leaf of ``shape`` is drawn in chunks of one index
    on each dim before ``k``, a run of ``rows`` on dim ``k`` and every dim
    after it whole; ``k`` is the first dim whose trailing dims hold at most
    ``CHUNK`` elements.  The layout depends on the shape only."""
    shape = tuple(shape)
    for k in range(len(shape)):
        inner = math.prod(shape[k + 1:])
        if inner <= CHUNK:
            return k, min(shape[k], max(1, CHUNK // inner))
    raise ValueError(f"no chunk layout for {shape}")


def chunk_elements(shape) -> int:
    """The elements of the largest chunk of a leaf of ``shape``."""
    k, rows = chunk_layout(shape)
    return rows * math.prod(tuple(shape)[k + 1:])


def _bounds(block, shape) -> Tuple[Tuple[int, int], ...]:
    return tuple(s.indices(n)[:2] for s, n in zip(block, shape))


def drawn_elements(shape, block) -> int:
    """The elements of the chunks that meet ``block`` (one slice per dim)
    of a leaf of ``shape``: what a draw of that block generates."""
    shape = tuple(shape)
    k, rows = chunk_layout(shape)
    b = _bounds(block, shape)
    outer = math.prod(hi - lo for lo, hi in b[:k])
    lo, hi = b[k]
    n = 0
    for j in range(lo // rows, -(-hi // rows)):
        n += min((j + 1) * rows, shape[k]) - j * rows
    return outer * n * math.prod(shape[k + 1:])


class Draw:
    """Every leaf of an init, by its '/'-joined tree path (JAX's leaf
    path, ``segments/0/pattern/0/moe/w_gate``).  A random leaf is drawn
    chunk by chunk (``chunk_layout``), each chunk in its dtype on
    ``device`` from a generator seeded by a stable hash of (``seed``, the
    path, the chunk's index), then transformed elementwise, so that its
    values depend on nothing drawn before it.  With ``blocks`` ({path:
    one slice per dim}) each leaf is its block only: the chunks that meet
    the block are drawn and cut, which gives that block of the whole draw
    bit for bit.  Constant leaves draw nothing.  On the meta device or
    fake tensors (the dry-run's ``FakeTensorMode``) nothing is drawn."""

    def __init__(self, seed: int, device, blocks: Optional[dict] = None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.blocks = blocks
        self._gen = None

    def _block(self, path: str, shape) -> Tuple[slice, ...]:
        if self.blocks is None:
            return tuple(slice(0, n) for n in shape)
        return tuple(slice(lo, hi) for lo, hi in
                     _bounds(self.blocks[path], shape))

    def _stream(self, path: str, c: int) -> torch.Generator:
        # hashlib, not hash(): Python salts str hashes per process
        h = hashlib.blake2b(f"{self.seed}/{path}/{c}".encode(),
                            digest_size=8).digest()
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        return self._gen.manual_seed(int.from_bytes(h, "little") >> 1)

    def _draw(self, path: str, shape, dtype: torch.dtype, fn) -> Tensor:
        """``fn(generator, chunk shape)`` chunk by chunk into the leaf's
        block."""
        shape = tuple(shape)
        block = self._block(path, shape)
        out = torch.empty(tuple(s.stop - s.start for s in block),
                          dtype=dtype, device=self.device)
        if out.is_meta or isinstance(out, FakeTensor):
            return out
        k, rows = chunk_layout(shape)
        n_k = -(-shape[k] // rows)
        lo, hi = block[k].start, block[k].stop
        for idx in itertools.product(*(range(s.start, s.stop)
                                       for s in block[:k])):
            first = int(np.ravel_multi_index(idx, shape[:k])) * n_k \
                if k else 0
            at = tuple(i - s.start for i, s in zip(idx, block[:k]))
            for j in range(lo // rows, -(-hi // rows)):
                r0, r1 = j * rows, min((j + 1) * rows, shape[k])
                a, b = max(r0, lo), min(r1, hi)
                # one chunk alive at a time: nothing names it past the copy
                out[at + (slice(a - lo, b - lo),)].copy_(
                    fn(self._stream(path, first + j),
                       (r1 - r0,) + shape[k + 1:])[
                        (slice(a - r0, b - r0),) + block[k + 1:]])
        return out

    def normal(self, path: str, shape, dtype: torch.dtype,
               std: float) -> Tensor:
        """normal * ``std``, drawn in ``dtype``."""
        return self._draw(path, shape, dtype, lambda g, sh: torch.randn(
            sh, dtype=dtype, device=self.device, generator=g).mul_(std))

    def uniform(self, path: str, shape, dtype: torch.dtype, lo: float,
                hi: float, then=None) -> Tensor:
        """U[lo, hi) drawn in ``dtype``, then ``then`` (elementwise) on
        each chunk."""
        def fn(g, sh):
            u = torch.rand(sh, dtype=dtype, device=self.device,
                           generator=g) * (hi - lo) + lo
            return then(u) if then is not None else u
        return self._draw(path, shape, dtype, fn)

    def const(self, path: str, whole: Tensor) -> Tensor:
        """A constant leaf's block of ``whole`` (on the device; an
        expanded view is enough: only the block is allocated)."""
        return whole[self._block(path, tuple(whole.shape))].contiguous()

    def full(self, path: str, shape, dtype: torch.dtype,
             value: float) -> Tensor:
        return self.const(path, torch.full((), value, dtype=dtype,
                                           device=self.device).expand(shape))


def dense_init(draw: Draw, path: str, shape, dtype: torch.dtype,
               scale: Optional[float] = None, reps: int = 0) -> Tensor:
    """normal * 1/sqrt(shape[0]) (or * ``scale``), drawn directly in
    ``dtype`` on the draw's device: the full bf16 model never passes
    through fp32 on the host.  ``reps > 0`` draws a stack of ``reps``
    independent such leaves (a segment's stacked parameters)."""
    std = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    full = (reps,) + tuple(shape) if reps else tuple(shape)
    return draw.normal(path, full, dtype, std)


def init_norm(cfg: ModelConfig, draw: Draw, path: str,
              dim: Optional[int] = None, reps: int = 0) -> dict:
    d = dim or cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    shape = (reps, d) if reps else (d,)
    p = {"scale": draw.full(f"{path}/scale", shape, dt, 1.0)}
    if cfg.norm == "layernorm":
        p["bias"] = draw.full(f"{path}/bias", shape, dt, 0.0)
    return p


def init_mlp(cfg: ModelConfig, draw: Draw, path: str,
             d_ff: Optional[int] = None, reps: int = 0):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    dt = torch_dtype(cfg.param_dtype)

    def w(name, shape):
        return dense_init(draw, f"{path}/{name}", shape, dt, reps=reps)
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": w("w_gate", (d, f)), "w_up": w("w_up", (d, f)),
                "w_down": w("w_down", (f, d))}
    return {"w_up": w("w_up", (d, f)), "w_down": w("w_down", (f, d))}


def init_embed(cfg: ModelConfig, draw: Draw) -> dict:
    dt = torch_dtype(cfg.param_dtype)
    p = {"tok": dense_init(draw, "embed/tok", (cfg.vocab_size, cfg.d_model),
                           dt, scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(draw, "embed/lm_head",
                                  (cfg.d_model, cfg.vocab_size), dt)
    if cfg.pos_emb == "learned":
        p["pos"] = dense_init(draw, "embed/pos",
                              (cfg.max_seq_len, cfg.d_model), dt, scale=0.02)
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
