"""Wrappers of the port's six kernels, plus the slot-row gather/scatter of
the engine's packed batches.  The model calls ``moe_gmm_ragged`` (ragged
MoE dispatch) or ``moe_gmm`` (dense dispatch), ``prefill_attention`` and
``decode_attention``; ``paged_decode_attention`` and
``paged_verify_attention`` read the paged KV pool and are on no engine
path (the engine keeps slot rows).  The decode kernels (contiguous and
paged) split the key axis and are two CUDA launches (split, then merge)
when their split count exceeds 1.

Each wrapper takes the kernel's plain PyTorch version (``ref.py``) for a
tensor that lies on the CPU, and for a CUDA tensor launches the hand-
written kernel (``csrc/*.cu``, built by ``build.py``) or raises — there is
no fallback from the card to the plain version.  A wrapper checks dtype,
shape and contiguity, launches on PyTorch's current stream, raises if the
launch returned a CUDA error, and adds one to ``LAUNCHES[name]`` for every
kernel launch (and for nothing else), so a run can show that its main path
went through the kernels.

Training (``repro_torch.training``) differentiates two of them, K2 and K4,
which the training path runs: ``prefill_attention`` and ``moe_gmm`` go
through ``torch.autograd.Function``s (``PrefillAttention``, ``MoeGmm``)
whose backward is a hand-written kernel too (``prefill_attention_bwd``,
``moe_gmm_bwd``; on the CPU their plain versions) whenever grad mode is on
and an input requires grad.  K2's backward takes every contract its
forward takes: each pair of ``PREFILL_HEAD_DIMS``, any group size,
offsets, a window and ``causal=False``.  The other four kernels have no
backward: on the card their wrappers raise when grad mode is on and an
input requires grad, rather than return an output that autograd would
silently treat as a constant.

Tracing: K1-K4 and the two backward kernels are also
``torch.library.custom_op``s (``repro_torch::`` namespace) with a fake
implementation that only propagates shapes.  A wrapper given a
``FakeTensor`` (the dry-run traces a step on fake tensors,
``launch/dryrun.py``; the train step's backward too) calls its custom op,
which under the fake mode returns empty outputs of the kernel's shapes and
launches nothing; a real tensor never takes that branch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.kernels import ref

Tensor = torch.Tensor

# one count per wrapper call that launched its kernel; the split-K
# designs of decode_attention and of the paged kernels are two CUDA
# launches (split, then merge) when their split count exceeds 1, and
# moe_gmm_ragged's and moe_gmm's two-phase design is always two (gate/up,
# then down); the backward of K2 is three launches (D = rowsum(dO o O)
# with the log-sum-exp rows, then dK/dV, then dQ; two more sum the dK and
# dV partials of its head groups where ``bwd_split`` splits it) and that
# of K4 four (G, U, dH and the epilogue, then dX, dWg/dWu, dWd): each
# still counts one
LAUNCHES: Dict[str, int] = {"moe_gmm_ragged": 0, "prefill_attention": 0,
                            "decode_attention": 0, "moe_gmm": 0,
                            "paged_decode_attention": 0,
                            "paged_verify_attention": 0,
                            "prefill_attention_bwd": 0, "moe_gmm_bwd": 0}
# calls of moe_gmm on the card that zero-padded d or F to a multiple of 8
# (a copy of the operands; widths of real models never take it)
PAD_COPIES: Dict[str, int] = {"moe_gmm": 0, "moe_gmm_bwd": 0}
# what the last launch of each backward wrapper on the card launched, as
# its C entry reported it: CTAs of each pass (and K4's row tile and
# weight-gradient tiles)
GRIDS: Dict[str, Dict[str, int]] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# kernel -> (source csrc/<source>.cu, C entry point, its argument types)
_SIGNATURES = {
    # the MoE kernels take an H scratch (rows, F) between their two phases
    "moe_gmm_ragged": ("moe_gmm_ragged", "moe_gmm_ragged_bf16",
                       [_P] * 7 + [_I] * 5 + [_P]),
    # the last pointer before the ints is the optional log-sum-exp output
    "prefill_attention": ("prefill_attention", "prefill_attention_bf16",
                          [_P] * 6 + [_I] * 9 + [_F, _P]),
    # the pointer after the split count is the optional log-sum-exp output
    "decode_attention": ("decode_attention", "decode_attention_bf16",
                         [_P] * 6 + [_I] * 7 + [_F, _I, _P, _P]),
    "moe_gmm": ("moe_gmm", "moe_gmm_bf16", [_P] * 6 + [_I] * 5 + [_P]),
    # one kernel: paged decode is the verify window W = 1
    "paged_decode_attention": ("paged_attention", "paged_attention_bf16",
                               [_P] * 7 + [_I] * 8 + [_F, _I, _P]),
    "paged_verify_attention": ("paged_attention", "paged_attention_bf16",
                               [_P] * 7 + [_I] * 8 + [_F, _I, _P]),
    # q, k, v, o, lse, dO, offset, dq, dk, dv, the L/D scratch, the
    # split's partials; then the ints up to the split count and the key
    # tile it was chosen for; the scale; the launched grid (out)
    "prefill_attention_bwd": ("prefill_attention_bwd",
                              "prefill_attention_bwd_bf16",
                              [_P] * 12 + [_I] * 11 + [_F, _IP, _P]),
    # x, Wg, Wu, Wd, dY, the H / dG / dU scratch, dx, dWg, dWu, dWd; the
    # ints; the launched grid (out)
    "moe_gmm_bwd": ("moe_gmm_bwd", "moe_gmm_bwd_bf16",
                    [_P] * 12 + [_I] * 4 + [_IP, _P]),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, PAD_COPIES):
        for k in counts:
            counts[k] = 0


def _fn(name: str):
    if name not in _fns:
        from repro_torch.kernels import build
        source, sym, argtypes = _SIGNATURES[name]
        f = getattr(build.load(source), sym)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[name] = f
    return _fns[name]


def _launch(name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _on_card(name: str, *tensors: Tensor) -> bool:
    """False for CPU tensors (take the plain version); True for CUDA
    tensors; raises on anything else or on a mix."""
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return False
    if devs != {"cuda"}:
        raise ValueError(f"{name}: tensors on {sorted(devs)}; all must be "
                         "on one CPU or CUDA device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    return True


def _fake(*tensors: Tensor) -> bool:
    """True when tracing on fake tensors (no data: shapes only)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


def _needs_grad(*tensors: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors: Tensor) -> None:
    """Refuse a launch whose output autograd would take for a constant:
    the kernel records nothing for the backward pass."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            "requires grad (its output would silently drop out of the "
            "gradient)")


def _check_bf16(name: str, *tensors: Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")


# --------------------------------------------------------------------- K1

# row-tile heights of the MoE kernels (one expert per tile)
_ROW_TILES = (8, 16, 32, 64, 128)


def moe_gmm_ragged(rows: Tensor, w_gate: Tensor, w_up: Tensor,
                   w_down: Tensor, tile_expert: Tensor, m_blk: int) -> Tensor:
    """Ragged grouped fused SwiGLU: rows (n_rows, d) expert-sorted in
    ``m_blk``-aligned groups, w_gate/w_up (E, d, F), w_down (E, F, d),
    tile_expert (n_rows / m_blk,) with sentinel E for padding tiles ->
    (n_rows, d).  On the card: bf16, d and F multiples of 8, m_blk a
    power of two in [8, 128], 16-byte aligned tensors."""
    n_rows, d = rows.shape
    e, d2, f = w_gate.shape
    if (d2 != d or w_up.shape != w_gate.shape or w_down.shape != (e, f, d)
            or n_rows % m_blk or tile_expert.shape != (n_rows // m_blk,)):
        raise ValueError(f"moe_gmm_ragged: bad shapes rows {tuple(rows.shape)} "
                         f"w_gate {tuple(w_gate.shape)} w_down "
                         f"{tuple(w_down.shape)} tile_expert "
                         f"{tuple(tile_expert.shape)} m_blk {m_blk}")
    if _fake(rows, w_gate):
        return torch.ops.repro_torch.moe_gmm_ragged(rows, w_gate, w_up, w_down,
                                                    tile_expert, m_blk)
    if not _on_card("moe_gmm_ragged", rows, w_gate, w_up, w_down, tile_expert):
        return ref.moe_gmm_ragged_ref(rows, w_gate, w_up, w_down, tile_expert,
                                      m_blk)
    _no_backward("moe_gmm_ragged", rows, w_gate, w_up, w_down)
    _check_bf16("moe_gmm_ragged", rows, w_gate, w_up, w_down)
    if tile_expert.dtype != torch.int32:
        raise TypeError("moe_gmm_ragged: tile_expert must be int32")
    if d % 8 or f % 8 or m_blk not in _ROW_TILES:
        raise ValueError(f"moe_gmm_ragged: kernel needs d, F multiples of 8 "
                         f"and m_blk in {_ROW_TILES} (d={d}, F={f}, "
                         f"m_blk={m_blk})")
    _check_aligned("moe_gmm_ragged", rows, w_gate, w_up, w_down)
    out = torch.empty_like(rows)
    h = torch.empty((n_rows, f), dtype=rows.dtype, device=rows.device)
    _launch("moe_gmm_ragged", rows.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), tile_expert.data_ptr(),
            h.data_ptr(), out.data_ptr(), n_rows, d, f, e, m_blk)
    return out


def _check_aligned(name: str, *tensors: Tensor) -> None:
    """The kernels read 16-byte chunks (cp.async, TMA)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: kernel needs 16-byte aligned tensors")


# --------------------------------------------------------------------- K2

# query rows per CTA of the prefill kernel: PREFILL_ROWS // g positions x
# g heads of one group, the rows past them padding; and the (query/key,
# value) head widths it and its backward are built for: GQA's equal pairs
# (256 at recurrentgemma-9b) and multi-head latent attention's 128 nope +
# 64 rope query/key dims against 128 value dims
PREFILL_ROWS = 128
PREFILL_HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128), (256, 256))
# the pairs past 128 the decode kernel is built for (it takes every equal
# pair of a multiple of 16 up to 128)
DECODE_WIDE_DIMS = ((192, 128), (256, 256))


def _check_attention(name: str, q: Tensor, k: Tensor, v: Tensor,
                     idx: Tensor) -> None:
    _check_bf16(name, q, k, v)
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: offsets/lengths must be int32")
    h, hkv = q.shape[-2], k.shape[2]
    if h % hkv:
        raise ValueError(f"{name}: kernel needs H % Hkv == 0 (H={h}, "
                         f"Hkv={hkv})")


def _check_kv(name: str, q: Tensor, k: Tensor, v: Tensor) -> None:
    """k (B, S_max, Hkv, dk) and v (B, S_max, Hkv, dv) beside q (B, ...,
    H, dk)."""
    if (k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[-1]):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")


def prefill_attention(q: Tensor, k: Tensor, v: Tensor, offset: Tensor, *,
                      window: Optional[int] = None,
                      causal: bool = True, return_lse: bool = False):
    """Causal GQA attention of P new tokens over the slot-row cache:
    q (B, P, H, dk) at positions ``offset[b] + i``, k (B, S_max, Hkv, dk)
    and v (B, S_max, Hkv, dv) already holding the new keys, offset (B,)
    -> (B, P, H, dv), scaled by 1/sqrt(dk).  With ``causal=False`` every
    query sees all S_max keys (``offset`` and ``window`` are ignored): the
    encoder's self-attention and cross-attention.  See
    ``ref.prefill_attention_ref`` for the masks.  Differentiable
    (``PrefillAttention``, whose backward kernel takes every contract the
    forward takes) where grad mode is on and q, k or v requires grad.
    ``return_lse``: also each query row's natural-log log-sum-exp (B, H,
    P) fp32, the kernel's optional output: ``(out, lse)``.  Offsets may
    lie outside [0, S_max) (a rank's slice of a sequence-sharded cache):
    the masks are the same arithmetic."""
    b, p, h, dk = q.shape
    _check_kv("prefill_attention", q, k, v)
    if offset.shape != (b,):
        raise ValueError(f"prefill_attention: bad offset shape "
                         f"{tuple(offset.shape)}")
    if _needs_grad(q, k, v):
        if return_lse:
            raise RuntimeError("prefill_attention: return_lse is for calls "
                               "without autograd")
        return PrefillAttention.apply(q, k, v, offset, window, causal)
    out, lse = _prefill_forward(q, k, v, offset, window, causal, return_lse)
    return (out, lse) if return_lse else out


def _prefill_forward(q: Tensor, k: Tensor, v: Tensor, offset: Tensor,
                     window: Optional[int], causal: bool, want_lse: bool):
    """(out, lse or None): the kernel (or, for CPU tensors, the plain
    version); ``lse`` (B, H, P) fp32 is the kernel's optional output,
    which the serve paths never ask for.  Fake tensors (the dry-run's
    trace) take the custom op, which only propagates shapes."""
    if _fake(q, k):
        out, lse = torch.ops.repro_torch.prefill_attention(
            q, k, v, offset, window or 0, causal, want_lse)
        return out, (lse if want_lse else None)
    if not _on_card("prefill_attention", q, k, v, offset):
        out = ref.prefill_attention_ref(q, k, v, offset, window=window,
                                        causal=causal)
        return out, (ref.prefill_attention_lse_ref(
            q, k, v, offset, window=window, causal=causal)
            if want_lse else None)
    b, p, h, dk = q.shape
    _check_attention("prefill_attention", q, k, v, offset)
    g, dv = h // k.shape[2], v.shape[3]
    if g > PREFILL_ROWS or (dk, dv) not in PREFILL_HEAD_DIMS:
        raise ValueError(f"prefill_attention: kernel needs the group size "
                         f"at most {PREFILL_ROWS} and (hd, hd_v) in "
                         f"{PREFILL_HEAD_DIMS} (g={g}, hd={dk}, hd_v={dv})")
    _check_aligned("prefill_attention", q, k, v)
    out = q.new_empty((b, p, h, dv))
    lse = (torch.empty((b, h, p), dtype=torch.float32, device=q.device)
           if want_lse else None)
    _launch("prefill_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            offset.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, b, p, h,
            k.shape[2], k.shape[1], dk, dv, window or 0, int(causal),
            1.0 / math.sqrt(dk))
    return out, lse


class PrefillAttention(torch.autograd.Function):
    """K2 with its backward: the forward kernel also writes each query
    row's log-sum-exp, which the backward kernel reads."""

    @staticmethod
    def forward(ctx, q, k, v, offset, window, causal):
        out, lse = _prefill_forward(q, k, v, offset, window, causal, True)
        ctx.save_for_backward(q, k, v, out, lse, offset)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, offset = ctx.saved_tensors
        dq, dk, dv = prefill_attention_bwd(q, k, v, out, lse,
                                           d_out.contiguous(), offset,
                                           window=ctx.window,
                                           causal=ctx.causal)
        return dq, dk, dv, None, None, None


def prefill_attention_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                          lse: Tensor, do: Tensor, offset: Tensor, *,
                          window: Optional[int] = None,
                          causal: bool = True):
    """The vjp of ``prefill_attention`` (see
    ``ref.prefill_attention_bwd_ref``): from q, k, v, the forward's output
    ``o`` (B, P, H, dv) and log-sum-exp ``lse`` (B, H, P) fp32 and the
    output cotangent ``do`` -> (dq, dk, dv).  On the card: bf16, the
    forward's contract (``_prefill_forward``: (hd, hd_v) in
    ``PREFILL_HEAD_DIMS``, any group size up to ``PREFILL_ROWS``, offsets,
    a window, ``causal=False``); three launches, five where the dK/dV
    pass splits its query heads (``bwd_split``), no atomics (two calls
    give the same bits)."""
    b, p, h, dk = q.shape
    if (o.shape != (b, p, h, v.shape[3]) or do.shape != o.shape
            or lse.shape != (b, h, p)):
        raise ValueError(f"prefill_attention_bwd: bad shapes o "
                         f"{tuple(o.shape)} do {tuple(do.shape)} lse "
                         f"{tuple(lse.shape)}")
    if _fake(q, do):
        return torch.ops.repro_torch.prefill_attention_bwd(
            q, k, v, o, lse, do, offset, window or 0, causal)
    if not _on_card("prefill_attention_bwd", q, k, v, o, lse, do, offset):
        return ref.prefill_attention_bwd_ref(q, k, v, o, lse, do, offset,
                                             window=window, causal=causal)
    _check_attention("prefill_attention_bwd", q, k, v, offset)
    _check_bf16("prefill_attention_bwd", o, do)
    if lse.dtype != torch.float32:
        raise TypeError("prefill_attention_bwd: lse must be float32")
    hkv, s_max, dv = k.shape[2], k.shape[1], v.shape[3]
    if h // hkv > PREFILL_ROWS or (dk, dv) not in PREFILL_HEAD_DIMS:
        raise ValueError(f"prefill_attention_bwd: kernel needs the group "
                         f"size at most {PREFILL_ROWS} and (hd, hd_v) in "
                         f"{PREFILL_HEAD_DIMS} (g={h // hkv}, hd={dk}, "
                         f"hd_v={dv})")
    _check_aligned("prefill_attention_bwd", q, k, v, o, do)
    dq = torch.empty_like(q)
    dk_ = torch.empty_like(k)
    dv_ = torch.empty_like(v)
    launch_prefill_bwd(q, k, v, o, lse, do, offset, dq, dk_, dv_,
                       window=window, causal=causal)
    return dq, dk_, dv_


def launch_prefill_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                       lse: Tensor, do: Tensor, offset: Tensor, dq: Tensor,
                       dk: Tensor, dv: Tensor, *, window: Optional[int],
                       causal: bool) -> None:
    """Launch K2's backward into ``dq``, ``dk`` and ``dv`` (checked
    inputs on the card): allocates its scratch, the padded L/D rows and,
    where ``bwd_split`` splits the dK/dV pass, the groups' fp32
    partials."""
    b, p, h, hd = q.shape
    hkv, s_max, hd_v = k.shape[2], k.shape[1], v.shape[3]
    split = bwd_split(b, hkv, h // hkv, s_max, hd)
    # the grids' y axis is B and their z axis the key or query tiles
    if b > 65535 or s_max > 64 * 65535 or p > _BWD_ROW_PAD * 65535:
        raise ValueError("prefill_attention_bwd: grid past the launch limit")
    pad = -(-p // _BWD_ROW_PAD) * _BWD_ROW_PAD
    stat = torch.empty(2 * b * h * pad, dtype=torch.float32, device=q.device)
    part = (torch.empty(split * b * s_max * hkv * (hd + hd_v),
                        dtype=torch.float32, device=q.device)
            if split > 1 else None)
    grid = (ctypes.c_int * 3)()
    # the C entry refuses a key tile other than its build's
    _launch("prefill_attention_bwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
            offset.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stat.data_ptr(), part.data_ptr() if part is not None else None,
            b, p, h, hkv, s_max, hd, hd_v, window or 0, int(causal), split,
            bwd_key_tile(hd), 1.0 / math.sqrt(hd), grid)
    GRIDS["prefill_attention_bwd"] = {"split": split, "dkdv": grid[0],
                                      "reduce": grid[1], "dq": grid[2]}


# K2's backward: L and D rows padded to its dQ pass's 128-query tiles
_BWD_ROW_PAD = 128


def bwd_key_tile(hd: int) -> int:
    """Keys per CTA of K2's backward dK/dV pass (two warpgroups of 64 up
    to dk 128, one tile of 64 shared by both past it); the C entry checks
    it against its build's."""
    return 128 if hd <= 128 else 64


def bwd_split(b: int, hkv: int, g: int, s_max: int, hd: int) -> int:
    """Query-head groups of K2's backward dK/dV pass, from the shapes the
    host knows: 1 where its (key tile, kv head, row) grid already fills
    the 132 SMs; else the smallest divisor s of the group size g that
    makes s times as many CTAs fill them (each group sums its own heads
    into fp32 partials, which a second launch adds in a fixed order); g
    where no divisor does."""
    ctas = -(-s_max // bwd_key_tile(hd)) * hkv * b
    if ctas >= _SMS:
        return 1
    return next((s for s in range(1, g + 1)
                 if g % s == 0 and ctas * s >= _SMS), g)


# --------------------------------------------------------------------- K3

# the card's SMs (H100 SXM) and the decode kernel's keys per tile
_SMS = 132
_DECODE_KT = 64
_DECODE_MAX_SPLIT = 32


def decode_split(b: int, hkv: int, s_max: int) -> int:
    """Key-axis splits of the decode kernel, from the shapes the host
    knows (never the lengths, which stay on the card): enough CTAs on the
    (split, Hkv, B) grid for two waves over 132 SMs, but no more splits
    than S_max has 64-key tiles (a split of a full row keeps at least one
    tile) and at most 32."""
    want = -(-2 * _SMS // max(b * hkv, 1))
    tiles = -(-s_max // _DECODE_KT)
    return max(1, min(want, tiles, _DECODE_MAX_SPLIT))


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     lengths: Tensor, *, window: Optional[int] = None,
                     return_lse: bool = False):
    """One query token per row over the contiguous cache: q (B, H, dk),
    caches k (B, S_max, Hkv, dk) and v (B, S_max, Hkv, dv), lengths (B,)
    valid entries including the new token's K/V -> (B, H, dv), scaled by
    1/sqrt(dk).  On the card dk = dv a multiple of 16 up to 128, or a pair
    of ``DECODE_WIDE_DIMS``.  ``return_lse``: also each query's natural-
    log log-sum-exp (B, H) fp32 (-inf where it sees no key), the kernel's
    optional output, which the serve paths never ask for: ``(out,
    lse)``.  A length past S_max puts the query beyond the cache (a
    rank's slice of a sequence-split one): it sees keys ``[max(0, length
    - window), min(length, S_max))``, none where that range is empty."""
    b, h, dk = q.shape
    _check_kv("decode_attention", q, k_cache, v_cache)
    if lengths.shape != (b,):
        raise ValueError(f"decode_attention: bad lengths shape "
                         f"{tuple(lengths.shape)}")
    if _fake(q, k_cache):
        out, lse = torch.ops.repro_torch.decode_attention(
            q, k_cache, v_cache, lengths, window or 0, return_lse)
        return (out, lse) if return_lse else out
    if not _on_card("decode_attention", q, k_cache, v_cache, lengths):
        out = ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                       window=window)
        if not return_lse:
            return out
        return out, ref.decode_attention_lse_ref(q, k_cache, lengths,
                                                 window=window)
    _no_backward("decode_attention", q, k_cache, v_cache)
    _check_attention("decode_attention", q, k_cache, v_cache, lengths)
    dv = v_cache.shape[3]
    if not ((dk == dv and dk % 16 == 0 and dk <= 128)
            or (dk, dv) in DECODE_WIDE_DIMS):
        raise ValueError(f"decode_attention: kernel needs hd = hd_v a "
                         f"multiple of 16 up to 128, or (hd, hd_v) in "
                         f"{DECODE_WIDE_DIMS} (hd={dk}, hd_v={dv})")
    if h // k_cache.shape[2] > 16:
        raise ValueError("decode_attention: kernel takes at most 16 query "
                         "heads per kv head")
    _check_aligned("decode_attention", q, k_cache, v_cache)
    hkv, s_max = k_cache.shape[2], k_cache.shape[1]
    split = decode_split(b, hkv, s_max)
    out = q.new_empty((b, h, dv))
    # fp32 partials (O, then m and l) of every (slot, head, split)
    scratch = (torch.empty(b * h * split * (dv + 2), dtype=torch.float32,
                           device=q.device) if split > 1 else None)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _launch("decode_attention", q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, b, h, hkv,
            s_max, dk, dv, window or 0, 1.0 / math.sqrt(dk), split,
            lse.data_ptr() if lse is not None else None)
    return (out, lse) if return_lse else out


# ------------------------------------------------ K1-K4 as custom ops

# Shape propagation for tracing on fake tensors: the real implementation
# is the wrapper itself (so a real tensor that reached a custom op would
# launch the kernel or take the plain version, as the wrapper does); the
# fake one allocates the outputs' shapes and launches nothing.


@torch.library.custom_op("repro_torch::moe_gmm_ragged", mutates_args=())
def _moe_gmm_ragged_op(rows: Tensor, w_gate: Tensor, w_up: Tensor,
                       w_down: Tensor, tile_expert: Tensor,
                       m_blk: int) -> Tensor:
    return moe_gmm_ragged(rows, w_gate, w_up, w_down, tile_expert, m_blk)


@_moe_gmm_ragged_op.register_fake
def _(rows, w_gate, w_up, w_down, tile_expert, m_blk):
    return torch.empty_like(rows)


@torch.library.custom_op("repro_torch::prefill_attention", mutates_args=())
def _prefill_attention_op(q: Tensor, k: Tensor, v: Tensor, offset: Tensor,
                          window: int, causal: bool,
                          want_lse: bool) -> Tuple[Tensor, Tensor]:
    out, lse = _prefill_forward(q, k, v, offset, window or None, causal,
                                want_lse)
    return out, (lse if lse is not None else q.new_empty((0,),
                                                         dtype=torch.float32))


@_prefill_attention_op.register_fake
def _(q, k, v, offset, window, causal, want_lse):
    b, p, h, _ = q.shape
    lse_shape = (b, h, p) if want_lse else (0,)
    return (q.new_empty((b, p, h, v.shape[3])),
            q.new_empty(lse_shape, dtype=torch.float32))


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention_op(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                         lengths: Tensor, window: int,
                         want_lse: bool) -> Tuple[Tensor, Tensor]:
    if want_lse:
        return decode_attention(q, k_cache, v_cache, lengths,
                                window=window or None, return_lse=True)
    out = decode_attention(q, k_cache, v_cache, lengths,
                           window=window or None)
    return out, q.new_empty((0,), dtype=torch.float32)


@_decode_attention_op.register_fake
def _(q, k_cache, v_cache, lengths, window, want_lse):
    b, h, _ = q.shape
    return (q.new_empty((b, h, v_cache.shape[3])),
            q.new_empty((b, h) if want_lse else (0,), dtype=torch.float32))


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=())
def _moe_gmm_op(x: Tensor, w_gate: Tensor, w_up: Tensor,
                w_down: Tensor) -> Tensor:
    return _moe_gmm_forward(x, w_gate, w_up, w_down)


@_moe_gmm_op.register_fake
def _(x, w_gate, w_up, w_down):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::prefill_attention_bwd",
                         mutates_args=())
def _prefill_attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                              lse: Tensor, do: Tensor, offset: Tensor,
                              window: int, causal: bool
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    return prefill_attention_bwd(q, k, v, o, lse, do, offset,
                                 window=window or None, causal=causal)


@_prefill_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, offset, window, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("repro_torch::moe_gmm_bwd", mutates_args=())
def _moe_gmm_bwd_op(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
                    dy: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    return moe_gmm_bwd(x, w_gate, w_up, w_down, dy)


@_moe_gmm_bwd_op.register_fake
def _(x, w_gate, w_up, w_down, dy):
    return (torch.empty_like(x), torch.empty_like(w_gate),
            torch.empty_like(w_up), torch.empty_like(w_down))


# --------------------------------------------------------------------- K4

def _row_tile(c: int) -> int:
    """Rows per tile of the dense SwiGLU: the power of two in [8, 128]
    nearest above C, so a decode buffer (C = 8) is one 8-row tile."""
    m = 8
    while m < min(c, 128):
        m *= 2
    return m


def pad_widths(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor):
    """The dense SwiGLU's operands with d and F zero-padded to multiples
    of 8 (the kernel's TMA rows must be 16-byte multiples), as the JAX
    wrapper pads C and F with a copy.  Exact: the zero columns of x and
    rows of Wg/Wu add zero products, H's padded columns are silu(0) * 0 =
    0, and Wd's padded rows and columns meet only those zeros or are
    sliced off.  Returns the inputs themselves where nothing needs
    padding."""
    d, f = x.shape[-1], w_gate.shape[-1]
    pd, pf = -d % 8, -f % 8
    if not (pd or pf):
        return x, w_gate, w_up, w_down
    pad = torch.nn.functional.pad
    return (pad(x, (0, pd)) if pd else x, pad(w_gate, (0, pf, 0, pd)),
            pad(w_up, (0, pf, 0, pd)), pad(w_down, (0, pd, 0, pf)))


def _check_moe_shapes(name: str, x: Tensor, w_gate: Tensor, w_up: Tensor,
                      w_down: Tensor) -> None:
    e, c, d = x.shape
    f = w_gate.shape[-1]
    if (w_gate.shape != (e, d, f) or w_up.shape != w_gate.shape
            or w_down.shape != (e, f, d)):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} w_gate "
                         f"{tuple(w_gate.shape)} w_up {tuple(w_up.shape)} "
                         f"w_down {tuple(w_down.shape)}")


def moe_gmm(x: Tensor, w_gate: Tensor, w_up: Tensor,
            w_down: Tensor) -> Tensor:
    """Batched per-expert fused SwiGLU over the dense capacity buffer:
    x (E, C, d), w_gate/w_up (E, d, F), w_down (E, F, d) -> (E, C, d).
    Any C; on the card bf16, and d or F off a multiple of 8 costs a padded
    copy of the operands (``pad_widths``, counted in ``PAD_COPIES``).
    Differentiable (``MoeGmm``) where grad mode is on and an input
    requires grad."""
    _check_moe_shapes("moe_gmm", x, w_gate, w_up, w_down)
    if _needs_grad(x, w_gate, w_up, w_down):
        return MoeGmm.apply(x, w_gate, w_up, w_down)
    return _moe_gmm_forward(x, w_gate, w_up, w_down)


def _moe_gmm_forward(x: Tensor, w_gate: Tensor, w_up: Tensor,
                     w_down: Tensor) -> Tensor:
    if _fake(x, w_gate):
        return torch.ops.repro_torch.moe_gmm(x, w_gate, w_up, w_down)
    e, c, d = x.shape
    if not _on_card("moe_gmm", x, w_gate, w_up, w_down):
        return ref.moe_gmm_ref(x, w_gate, w_up, w_down)
    _check_bf16("moe_gmm", x, w_gate, w_up, w_down)
    m_tile = _row_tile(c)
    if e * -(-c // m_tile) > 2 ** 31 - 1:
        raise ValueError(f"moe_gmm: grid past the launch limit (E={e}, "
                         f"C={c})")
    if x.numel() == 0:
        return torch.empty_like(x)
    xp, wg, wu, wd = pad_widths(x, w_gate, w_up, w_down)
    if wg is not w_gate:
        PAD_COPIES["moe_gmm"] += 1
    _check_aligned("moe_gmm", xp, wg, wu, wd)
    out = torch.empty_like(xp)
    h = torch.empty((e * c, wg.shape[-1]), dtype=x.dtype, device=x.device)
    _launch("moe_gmm", xp.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), h.data_ptr(), out.data_ptr(), e, c, xp.shape[-1],
            wg.shape[-1], m_tile)
    return out if xp is x else out[..., :d].contiguous()


class MoeGmm(torch.autograd.Function):
    """K4 with its backward (``moe_gmm_bwd``), which recomputes G and U
    from the saved inputs rather than keeping the forward's H."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        return _moe_gmm_forward(x, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        return moe_gmm_bwd(*ctx.saved_tensors, dy.contiguous())


def moe_gmm_bwd(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor,
                dy: Tensor):
    """The vjp of ``moe_gmm`` (see ``ref.moe_gmm_bwd_ref``) for the output
    cotangent ``dy`` (E, C, d) -> (dx, dw_gate, dw_up, dw_down) in the
    inputs' dtype.  On the card: bf16, any C; d or F off a multiple of 8
    pads the operands as the forward does and slices the padded grads
    back (counted in ``PAD_COPIES``); four launches, no atomics."""
    _check_moe_shapes("moe_gmm_bwd", x, w_gate, w_up, w_down)
    if dy.shape != x.shape:
        raise ValueError(f"moe_gmm_bwd: dy {tuple(dy.shape)} against x "
                         f"{tuple(x.shape)}")
    if _fake(x, dy):
        return torch.ops.repro_torch.moe_gmm_bwd(x, w_gate, w_up, w_down, dy)
    if not _on_card("moe_gmm_bwd", x, w_gate, w_up, w_down, dy):
        return ref.moe_gmm_bwd_ref(x, w_gate, w_up, w_down, dy)
    _check_bf16("moe_gmm_bwd", x, w_gate, w_up, w_down, dy)
    e, c, d = x.shape
    f = w_gate.shape[-1]
    if x.numel() == 0 or f == 0:
        return (torch.zeros_like(x), torch.zeros_like(w_gate),
                torch.zeros_like(w_up), torch.zeros_like(w_down))
    xp, wg, wu, wd = pad_widths(x, w_gate, w_up, w_down)
    dyp = dy
    if wg is not w_gate:
        PAD_COPIES["moe_gmm_bwd"] += 1
        dyp = torch.nn.functional.pad(dy, (0, xp.shape[-1] - d))
    dp, fp = xp.shape[-1], wg.shape[-1]
    _check_aligned("moe_gmm_bwd", xp, wg, wu, wd, dyp)
    scratch = torch.empty((3, e, c, fp), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(xp)
    dwg, dwu, dwd = (torch.empty_like(wg), torch.empty_like(wu),
                     torch.empty_like(wd))
    grid = (ctypes.c_int * 7)()
    _launch("moe_gmm_bwd", xp.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), dyp.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), scratch[2].data_ptr(), dx.data_ptr(),
            dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), e, c, dp, fp,
            grid)
    GRIDS["moe_gmm_bwd"] = dict(zip(
        ("gate_up_dh", "dx", "dwgu", "dwd", "row_tile", "dwgu_tiles",
         "dwd_tiles"), grid))
    if xp is x:
        return dx, dwg, dwu, dwd
    # the backward of pad_widths: the grads of the zero padding are
    # sliced off
    return (dx[..., :d].contiguous(), dwg[:, :d, :f].contiguous(),
            dwu[:, :d, :f].contiguous(), dwd[:, :f, :d].contiguous())


# ----------------------------------------------------------------- K5, K6

# query rows (window token, head-in-group pairs) per CTA of the paged
# kernel: its mma n-tiles hold 16
_PAGED_ROWS = 16


def paged_row_blocks(w: int, g: int) -> int:
    """CTAs per (kv head, split) of the paged kernel: the W * g query rows
    that read one kv head, in blocks of at most 16."""
    return max(1, -(-w * g // _PAGED_ROWS))


def paged_split(b: int, hkv: int, row_blocks: int, max_pages: int,
                page_size: int) -> int:
    """Key-axis splits of the paged kernel: ``decode_split`` with S_max =
    max_pages * page_size and each row block counted as a sequence of the
    (split, Hkv * row_blocks, B) grid."""
    return decode_split(b * row_blocks, hkv, max_pages * page_size)


def _paged(name: str, q: Tensor, k_pages: Tensor, v_pages: Tensor,
           block_tables: Tensor, lengths: Tensor,
           window: Optional[int]) -> Optional[Tensor]:
    """Shared checks and launch of K5/K6 for q (B, W, H, hd); None when
    the tensors lie on the CPU (the caller takes the plain version).  On
    the card: bf16, H % Hkv == 0, hd a multiple of 16 up to 128, 16-byte
    aligned tensors; any W and page size."""
    b, w, h, hd = q.shape
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or k_pages.shape[3] != hd or block_tables.dim() != 2
            or block_tables.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)} block_tables "
                         f"{tuple(block_tables.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not _on_card(name, q, k_pages, v_pages, block_tables, lengths):
        return None
    _no_backward(name, q, k_pages, v_pages)
    _check_bf16(name, q, k_pages, v_pages)
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and lengths must be int32")
    _, page_size, hkv, _ = k_pages.shape
    if h % hkv or hd % 16 or hd > 128:
        raise ValueError(f"{name}: kernel needs H % Hkv == 0 and hd a "
                         f"multiple of 16 up to 128 (H={h}, Hkv={hkv}, "
                         f"hd={hd})")
    _check_aligned(name, q, k_pages, v_pages)
    max_pages = block_tables.shape[1]
    row_blocks = paged_row_blocks(w, h // hkv)
    if b > 65535 or hkv * row_blocks > 65535:
        raise ValueError(f"{name}: grid past the launch limit (B={b}, "
                         f"Hkv={hkv}, row blocks={row_blocks})")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    split = paged_split(b, hkv, row_blocks, max_pages, page_size)
    # fp32 partials (O, then m and l) of every (sequence, token, head, split)
    scratch = (torch.empty(b * w * h * split * (hd + 2), dtype=torch.float32,
                           device=q.device) if split > 1 else None)
    _launch(name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, b, w, h,
            hkv, page_size, max_pages, hd, window or 0, 1.0 / math.sqrt(hd),
            split)
    return out


def paged_decode_attention(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                           block_tables: Tensor, lengths: Tensor, *,
                           window: Optional[int] = None) -> Tensor:
    """Decode attention over the paged pool: q (B, H, hd); k/v pages
    (n_pages, page_size, Hkv, hd); block_tables (B, max_pages) int32
    physical page ids in logical order (entries past a sequence's pages
    are never read); lengths (B,) int32 valid tokens including the new
    token's K/V -> (B, H, hd)."""
    out = _paged("paged_decode_attention", q[:, None], k_pages, v_pages,
                 block_tables, lengths, window)
    if out is None:
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths,
                                              window=window)
    return out[:, 0]


def paged_verify_attention(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                           block_tables: Tensor, lengths: Tensor, *,
                           window: Optional[int] = None) -> Tensor:
    """Speculative verify-window attention over the paged pool: q
    (B, W, H, hd), the W window tokens oldest first, whose K/V are already
    written; lengths count them -> (B, W, H, hd).  Each sequence's K/V
    stream is read once for the whole window."""
    out = _paged("paged_verify_attention", q, k_pages, v_pages,
                 block_tables, lengths, window)
    if out is None:
        return ref.paged_verify_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths,
                                              window=window)
    return out


# ------------------------------------------------------- slot-row gather

def _host_slots(slots) -> np.ndarray:
    if isinstance(slots, Tensor):
        if slots.device.type != "cpu":
            raise ValueError("slot ids must be host-side (numpy or a CPU "
                             "tensor): filtering them must not sync the card")
        slots = slots.numpy()
    return np.asarray(slots, np.int64)


def gather_slot_rows(cache, slots):
    """Gather a slot VECTOR of cache rows: leaves ``(reps, n_slots, ...)``
    -> ``(reps, B, ...)`` copies.  ``slots`` (B,) is host-side; padding rows
    carry the out-of-range id ``n_slots`` and read the last real row (clip
    semantics — their outputs are masked downstream and their writeback is
    dropped by ``scatter_slot_rows``)."""
    s = _host_slots(slots)

    def take(c: Tensor) -> Tensor:
        return c.index_select(1, to_device(np.minimum(s, c.shape[1] - 1),
                                           c.device))
    return tree_map(take, cache)


def scatter_slot_rows(cache, rows, slots) -> None:
    """Write gathered rows back into the multi-slot cache IN PLACE with one
    ``index_copy_`` per leaf; writes from padding rows (id ``n_slots``, out
    of range) are dropped.  Real slot ids are distinct by construction.
    The filter runs on the host-side ids, so nothing syncs the card."""
    s = _host_slots(slots)

    def put(full: Tensor, part: Tensor) -> None:
        keep = np.nonzero(s < full.shape[1])[0]
        if len(keep) == 0:
            return
        dst = to_device(s[keep], full.device)
        src = part if len(keep) == len(s) else part.index_select(
            1, to_device(keep, part.device))
        full.index_copy_(1, dst, src.to(full.dtype))
    tree_zip(put, cache, rows)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_zip(fn, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            tree_zip(fn, a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            tree_zip(fn, x, y)
    else:
        fn(a, b)
