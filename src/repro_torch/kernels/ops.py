"""Wrappers the model calls for the three hot-path kernels, plus the slot-
row gather/scatter of the engine's packed batches.

Each wrapper takes the kernel's plain PyTorch version (``ref.py``) for a
tensor that lies on the CPU, and for a CUDA tensor launches the hand-
written kernel (``csrc/*.cu``, built by ``build.py``) or raises — there is
no fallback from the card to the plain version.  A wrapper checks dtype,
shape and contiguity, launches on PyTorch's current stream, raises if the
launch returned a CUDA error, and adds one to ``LAUNCHES[name]`` for every
kernel launch (and for nothing else), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.kernels import ref

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"moe_gmm_ragged": 0, "prefill_attention": 0,
                            "decode_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "moe_gmm_ragged": ("moe_gmm_ragged_bf16", [_P] * 6 + [_I] * 5 + [_P]),
    "prefill_attention": ("prefill_attention_bf16",
                          [_P] * 5 + [_I] * 7 + [_F, _P]),
    "decode_attention": ("decode_attention_bf16", [_P] * 5 + [_I] * 6 + [_F, _P]),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(name: str):
    if name not in _fns:
        from repro_torch.kernels import build
        sym, argtypes = _SIGNATURES[name]
        f = getattr(build.load(name), sym)
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


def _check_bf16(name: str, *tensors: Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")


# --------------------------------------------------------------------- K1

def moe_gmm_ragged(rows: Tensor, w_gate: Tensor, w_up: Tensor,
                   w_down: Tensor, tile_expert: Tensor, m_blk: int) -> Tensor:
    """Ragged grouped fused SwiGLU: rows (n_rows, d) expert-sorted in
    ``m_blk``-aligned groups, w_gate/w_up (E, d, F), w_down (E, F, d),
    tile_expert (n_rows / m_blk,) with sentinel E for padding tiles ->
    (n_rows, d).  On the card: bf16, d and F multiples of 16, m_blk a
    power of two in [8, 128]."""
    n_rows, d = rows.shape
    e, d2, f = w_gate.shape
    if (d2 != d or w_up.shape != w_gate.shape or w_down.shape != (e, f, d)
            or n_rows % m_blk or tile_expert.shape != (n_rows // m_blk,)):
        raise ValueError(f"moe_gmm_ragged: bad shapes rows {tuple(rows.shape)} "
                         f"w_gate {tuple(w_gate.shape)} w_down "
                         f"{tuple(w_down.shape)} tile_expert "
                         f"{tuple(tile_expert.shape)} m_blk {m_blk}")
    if not _on_card("moe_gmm_ragged", rows, w_gate, w_up, w_down, tile_expert):
        return ref.moe_gmm_ragged_ref(rows, w_gate, w_up, w_down, tile_expert,
                                      m_blk)
    _check_bf16("moe_gmm_ragged", rows, w_gate, w_up, w_down)
    if tile_expert.dtype != torch.int32:
        raise TypeError("moe_gmm_ragged: tile_expert must be int32")
    if d % 16 or f % 16 or m_blk not in (8, 16, 32, 64, 128) \
            or n_rows // m_blk > 65535:
        raise ValueError(f"moe_gmm_ragged: kernel needs d, F multiples of 16 "
                         f"and m_blk in 8..128 (d={d}, F={f}, m_blk={m_blk})")
    out = torch.empty_like(rows)
    _launch("moe_gmm_ragged", rows.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), tile_expert.data_ptr(),
            out.data_ptr(), n_rows, d, f, e, m_blk)
    return out


# --------------------------------------------------------------------- K2

def _check_attention(name: str, q: Tensor, k: Tensor, v: Tensor,
                     idx: Tensor) -> None:
    _check_bf16(name, q, k, v)
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: offsets/lengths must be int32")
    h, hd = q.shape[-2], q.shape[-1]
    hkv = k.shape[2]
    if h % hkv or hd % 16 or hd > 128:
        raise ValueError(f"{name}: kernel needs H % Hkv == 0 and hd a "
                         f"multiple of 16 up to 128 (H={h}, Hkv={hkv}, "
                         f"hd={hd})")


def prefill_attention(q: Tensor, k: Tensor, v: Tensor, offset: Tensor, *,
                      window: Optional[int] = None) -> Tensor:
    """Causal GQA attention of P new tokens over the slot-row cache:
    q (B, P, H, hd) at positions ``offset[b] + i``, k/v (B, S_max, Hkv, hd)
    already holding the new keys, offset (B,) -> (B, P, H, hd).  See
    ``ref.prefill_attention_ref`` for the masks."""
    b, p, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd \
            or offset.shape != (b,):
        raise ValueError(f"prefill_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} offset {tuple(offset.shape)}")
    if not _on_card("prefill_attention", q, k, v, offset):
        return ref.prefill_attention_ref(q, k, v, offset, window=window)
    _check_attention("prefill_attention", q, k, v, offset)
    g = h // k.shape[2]
    if 64 % g:
        raise ValueError(f"prefill_attention: kernel needs the group size "
                         f"to divide 64 (g={g})")
    out = torch.empty_like(q)
    _launch("prefill_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            offset.data_ptr(), out.data_ptr(), b, p, h, k.shape[2],
            k.shape[1], hd, window or 0, 1.0 / math.sqrt(hd))
    return out


# --------------------------------------------------------------------- K3

def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     lengths: Tensor, *,
                     window: Optional[int] = None) -> Tensor:
    """One query token per row over the contiguous cache: q (B, H, hd),
    caches (B, S_max, Hkv, hd), lengths (B,) valid entries including the
    new token's K/V -> (B, H, hd)."""
    b, h, hd = q.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != hd or lengths.shape != (b,):
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not _on_card("decode_attention", q, k_cache, v_cache, lengths):
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        window=window)
    _check_attention("decode_attention", q, k_cache, v_cache, lengths)
    if h // k_cache.shape[2] > 16:
        raise ValueError("decode_attention: kernel takes at most 16 query "
                         "heads per kv head")
    out = torch.empty_like(q)
    _launch("decode_attention", q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
            k_cache.shape[2], k_cache.shape[1], hd, window or 0,
            1.0 / math.sqrt(hd))
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
    return _tree_map(take, cache)


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
    _tree_zip(put, cache, rows)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_zip(fn, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _tree_zip(fn, x, y)
    else:
        fn(a, b)
