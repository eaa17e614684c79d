"""Wrappers of the port's six kernels, plus the slot-row gather/scatter of
the engine's packed batches.  The model calls ``moe_gmm_ragged`` (ragged
MoE dispatch) or ``moe_gmm`` (dense dispatch), ``prefill_attention`` and
``decode_attention``; ``paged_decode_attention`` and
``paged_verify_attention`` read the paged KV pool and are on no engine
path (the engine keeps slot rows).

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

# one count per wrapper call that launched its kernel; decode_attention's
# split-K design is two CUDA launches (split, then merge) when its split
# count exceeds 1, and moe_gmm_ragged's and moe_gmm's two-phase design is
# always two (gate/up, then down): each still counts one
LAUNCHES: Dict[str, int] = {"moe_gmm_ragged": 0, "prefill_attention": 0,
                            "decode_attention": 0, "moe_gmm": 0,
                            "paged_decode_attention": 0,
                            "paged_verify_attention": 0}
# calls of moe_gmm on the card that zero-padded d or F to a multiple of 8
# (a copy of the operands; widths of real models never take it)
PAD_COPIES: Dict[str, int] = {"moe_gmm": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel -> (source csrc/<source>.cu, C entry point, its argument types)
_SIGNATURES = {
    # the MoE kernels take an H scratch (rows, F) between their two phases
    "moe_gmm_ragged": ("moe_gmm_ragged", "moe_gmm_ragged_bf16",
                       [_P] * 7 + [_I] * 5 + [_P]),
    "prefill_attention": ("prefill_attention", "prefill_attention_bf16",
                          [_P] * 5 + [_I] * 7 + [_F, _P]),
    "decode_attention": ("decode_attention", "decode_attention_bf16",
                         [_P] * 6 + [_I] * 6 + [_F, _I, _P]),
    "moe_gmm": ("moe_gmm", "moe_gmm_bf16", [_P] * 6 + [_I] * 5 + [_P]),
    # one kernel: paged decode is the verify window W = 1
    "paged_decode_attention": ("paged_attention", "paged_attention_bf16",
                               [_P] * 6 + [_I] * 8 + [_F, _P]),
    "paged_verify_attention": ("paged_attention", "paged_attention_bf16",
                               [_P] * 6 + [_I] * 8 + [_F, _P]),
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
    if not _on_card("moe_gmm_ragged", rows, w_gate, w_up, w_down, tile_expert):
        return ref.moe_gmm_ragged_ref(rows, w_gate, w_up, w_down, tile_expert,
                                      m_blk)
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

# query rows per CTA of the prefill kernel ((position, head-of-group)
# pairs; the group size must divide it) and the head dims it is built for
PREFILL_ROWS = 128
PREFILL_HEAD_DIMS = (32, 64, 128)


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
    if PREFILL_ROWS % g or hd not in PREFILL_HEAD_DIMS:
        raise ValueError(f"prefill_attention: kernel needs the group size "
                         f"to divide {PREFILL_ROWS} and hd in "
                         f"{PREFILL_HEAD_DIMS} (g={g}, hd={hd})")
    _check_aligned("prefill_attention", q, k, v)
    out = torch.empty_like(q)
    _launch("prefill_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            offset.data_ptr(), out.data_ptr(), b, p, h, k.shape[2],
            k.shape[1], hd, window or 0, 1.0 / math.sqrt(hd))
    return out


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
    _check_aligned("decode_attention", q, k_cache, v_cache)
    hkv, s_max = k_cache.shape[2], k_cache.shape[1]
    split = decode_split(b, hkv, s_max)
    out = torch.empty_like(q)
    # fp32 partials (O, then m and l) of every (slot, head, split)
    scratch = (torch.empty(b * h * split * (hd + 2), dtype=torch.float32,
                           device=q.device) if split > 1 else None)
    _launch("decode_attention", q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, b, h, hkv,
            s_max, hd, window or 0, 1.0 / math.sqrt(hd), split)
    return out


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


def moe_gmm(x: Tensor, w_gate: Tensor, w_up: Tensor,
            w_down: Tensor) -> Tensor:
    """Batched per-expert fused SwiGLU over the dense capacity buffer:
    x (E, C, d), w_gate/w_up (E, d, F), w_down (E, F, d) -> (E, C, d).
    Any C; on the card bf16, and d or F off a multiple of 8 costs a padded
    copy of the operands (``pad_widths``, counted in ``PAD_COPIES``)."""
    e, c, d = x.shape
    f = w_gate.shape[-1]
    if (w_gate.shape != (e, d, f) or w_up.shape != w_gate.shape
            or w_down.shape != (e, f, d)):
        raise ValueError(f"moe_gmm: bad shapes x {tuple(x.shape)} w_gate "
                         f"{tuple(w_gate.shape)} w_up {tuple(w_up.shape)} "
                         f"w_down {tuple(w_down.shape)}")
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


# ----------------------------------------------------------------- K5, K6

def _paged(name: str, q: Tensor, k_pages: Tensor, v_pages: Tensor,
           block_tables: Tensor, lengths: Tensor,
           window: Optional[int]) -> Optional[Tensor]:
    """Shared checks and launch of K5/K6 for q (B, W, H, hd); None when
    the tensors lie on the CPU (the caller takes the plain version).  The
    kernel holds all W * g query rows of a kv head in shared memory; a
    window too wide for it fails its launch, which raises."""
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
    _check_bf16(name, q, k_pages, v_pages)
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: block_tables and lengths must be int32")
    _, page_size, hkv, _ = k_pages.shape
    if h % hkv or hd % 8 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: kernel needs H % Hkv == 0, hd a multiple "
                         f"of 8 and 16-byte aligned pages (H={h}, Hkv={hkv}, "
                         f"hd={hd})")
    out = torch.empty_like(q)
    _launch(name, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, w,
            h, hkv, page_size, block_tables.shape[1], hd, window or 0,
            1.0 / math.sqrt(hd))
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
