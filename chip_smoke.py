#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught and turned into exit 0):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a), one process per
   source, all started together.
2. hold each of the six kernels against its plain PyTorch version at the
   qwen3-30b-a3b shapes its path gives it, in bf16, and time kernel,
   plain version and, where one PyTorch call computes the same function,
   that call: K1 ragged SwiGLU, K2 prefill attention (with its CTA
   count), K3 decode attention at S_max 2048 and 512 (with its split
   count; all three timings rotate over cache copies larger than L2, so
   each call reads its cache cold, as the serve's layers do; two launches
   must agree bit for bit), K4 dense SwiGLU (beside the cuBLAS chain of
   three bf16 bmm calls), K5 paged decode attention over block tables from
   the port's PagedKVAllocator (also against K3 on the same keys as slot
   rows), K6 paged verify attention (W = 4, and W = 1 against K5).  K1
   and K4 at decode are timed in CUDA graphs beside their eager time; two
   launches of each must agree bit for bit.  Each kernel's share of its
   bound is bound_ms / ms.  The build's ptxas report and, where cuobjdump
   exists, the SASS opcodes that show K2, K1 and K4 on wgmma (HGMMA) and
   TMA (UTMALDG) are printed (none in K1 or K4 fails the run).
3. check the kernel path end to end against the CPU fp32 plain path on a
   small model, under the ragged and the dense MoE dispatch (finite
   logits that agree within a stated tolerance).
4. serve qwen3-30b-a3b at full width (d_model 2048, 32/4 heads, 128
   experts top-8, 48 layers, random weights from a seed) through the
   port's launcher: the ragged dispatch with layered and then chunked
   prefill on long prompts, then the dense dispatch with layered and
   chunked prefill on a short-prompt trace and the ragged dispatch once
   more on that trace as its yardstick.  Every request completes with
   in-vocabulary tokens; every serve launches each kernel of its own
   path and none of another's; one host sync per iteration; no MoE call
   padded its operands; layered expert-load <= chunked; on the short
   trace the dense and the ragged layered serves give the same expert-load
   bytes and the same token streams.
   Then profile the ragged layered and the dense layered serve once more
   (device time by kernel, the device's busy share).

It prints a JSON ``kernels`` line, the ``nvidia-smi`` line, and, as its
last line, ``{"ok": true, "device": {...}}``.  ``--skip-serve`` stops
after phase 3 (a quick compile-and-check call): it prints the ``kernels``
line without launch counts and exits 1 with no result.  Without CUDA, or run from
a directory without the rest of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
L2_BYTES = 50e6

# tolerances against the fp32 plain versions, in bf16
ATTN_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 inputs, fp32 softmax; P rounded to bf16
GMM_REL_FRO = 1e-2                     # H rounded to bf16 for the tensor cores
E2E_REL_FRO = 5e-2                     # whole small model: bf16 kernels vs fp32 CPU


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 2


def check_moe_gmm(tag: str, n_tokens: int, gen) -> dict:
    """K1 at the ragged layout the model builds for ``n_tokens`` routed
    tokens at qwen3-30b-a3b widths (E 128, top-8, d 2048, F 768)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    from repro_torch.models.layers import dense_init
    e, k, d, f = 128, 8, 2048, 768
    dev = torch.device("cuda")
    w_gate = dense_init((e, d, f), torch.bfloat16, dev, gen)
    w_up = dense_init((e, d, f), torch.bfloat16, dev, gen)
    w_down = dense_init((e, f, d), torch.bfloat16, dev, gen)
    x = torch.randn((n_tokens, d), device=dev, generator=gen).to(torch.bfloat16)
    router = torch.randn((d, e), device=dev, generator=gen) * 0.02
    probs = torch.softmax(x.float() @ router, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    rows, tile_expert, m_blk, _, _, counts = moe.ragged_dispatch(x, idx, e)
    n_rows = rows.shape[0]
    args = (rows, w_gate, w_up, w_down, tile_expert, m_blk)

    got = ops.moe_gmm_ragged(*args)
    want = ref.moe_gmm_ragged_ref(*args)
    again = ops.moe_gmm_ragged(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"moe_gmm_ragged[{tag}]: two launches differ")
    diff = got.float() - want.float()
    rel = (diff.norm() / want.float().norm()).item()
    max_abs = diff.abs().max().item()
    sentinel = (tile_expert == e).repeat_interleave(m_blk)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"moe_gmm_ragged[{tag}]: non-finite output")
    if (got[sentinel] != 0).any():
        raise AssertionError(f"moe_gmm_ragged[{tag}]: sentinel rows not zero")
    log(f"moe_gmm_ragged[{tag}] rows {n_rows} m_blk {m_blk}: rel Frobenius "
        f"{rel:.3e} (tol {GMM_REL_FRO}), max abs {max_abs:.3e}")
    if not rel <= GMM_REL_FRO:
        raise AssertionError(f"moe_gmm_ragged[{tag}] disagrees: rel {rel}")

    n_active = int((counts > 0).sum())
    active_rows = int((tile_expert < e).sum()) * m_blk
    nbytes = (n_rows * d * 2 * 2 + tile_expert.numel() * 4
              + n_active * 3 * d * f * 2)
    flops = active_rows * 6 * d * f
    b_ms, b_by = bound_ms(nbytes, flops)
    ms, ms_eager, timing = _time_gmm(lambda: ops.moe_gmm_ragged(*args),
                                     m_blk <= 8)
    plain = cuda_time(lambda: ref.moe_gmm_ragged_ref(*args), iters=3)
    return {"name": f"moe_gmm_ragged[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm_ragged.cu",
            "replaces": "src/repro/kernels/moe_gmm_ragged.py:69",
            "max_abs_err": max_abs, "rel_fro_err": rel, "ms": ms,
            "ms_eager": ms_eager, "timing": timing,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes a per-expert "
                            "fused SwiGLU",
            "shape": {"rows": n_rows, "m_blk": m_blk, "active_experts": n_active}}


def _time_gmm(fn, decode: bool):
    """(ms, ms_eager, how): a decode-sized MoE call is timed in a CUDA
    graph (device time; its weights, 0.45-1.2 GB, are far larger than L2,
    so each call reads them cold), since the wrapper's two launches from
    Python can outlast a 0.2 ms kernel; ``ms_eager`` is the same call
    launched from Python.  A prefill-sized call is timed eagerly."""
    eager = cuda_time(fn, iters=10 if decode else 3)
    if not decode:
        return eager, eager, "eager CUDA events"
    return (cuda_time_cold(lambda i: fn(), 1, rounds=20), eager,
            "CUDA graph replay of 20 calls; ms_eager: launched from Python")


def _sdpa_gmajor(q, k, v, mask):
    """One SDPA call over KV repeated in g-major order (query head h reads
    kv head h % Hkv) — the yardstick, never used by the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def check_prefill_attention(tag: str, gen, b=4, p=2048, s_max=2048,
                            offsets=None) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd = 32, 4, 128
    dev = torch.device("cuda")
    q = torch.randn((b, p, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    kc = torch.randn((b, s_max, hkv, hd), device=dev, generator=gen).to(torch.bfloat16)
    vc = torch.randn((b, s_max, hkv, hd), device=dev, generator=gen).to(torch.bfloat16)
    off = torch.tensor(offsets or [0] * b, dtype=torch.int32, device=dev)
    got = ops.prefill_attention(q, kc, vc, off)
    want = ref.prefill_attention_ref(q, kc, vc, off)
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **ATTN_TOL)
    log(f"prefill_attention[{tag}] B {b} P {p} offsets {off.tolist()}: "
        f"max abs {max_abs:.3e} (tol {ATTN_TOL})")
    if not ok:
        raise AssertionError(f"prefill_attention[{tag}] disagrees")

    # visible (query, key) pairs and the K/V rows that must be read
    offl = [int(o) for o in off.tolist()]
    pairs = sum(min(o + i + 1, s_max) for o in offl for i in range(p))
    kv_rows = sum(min(o + p, s_max) for o in offl)
    nbytes = 2 * q.numel() * 2 + kv_rows * 2 * hkv * hd * 2 + b * 4
    flops = 4 * hd * h * pairs
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = cuda_time(lambda: ops.prefill_attention(q, kc, vc, off), iters=5)
    plain = cuda_time(lambda: ref.prefill_attention_ref(q, kc, vc, off), iters=2)
    g = h // hkv
    qt = q.transpose(1, 2)
    kt = kc.transpose(1, 2).repeat(1, g, 1, 1)
    vt = vc.transpose(1, 2).repeat(1, g, 1, 1)
    pos = torch.arange(s_max, device=dev)
    qpos = off.long()[:, None] + torch.arange(p, device=dev)[None]
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (pos[None, None, :] < (off.long() + p)[:, None, None]))[:, None]
    lib = cuda_time(lambda: _sdpa_gmajor(qt, kt, vt, mask), iters=5)
    rows = ops.PREFILL_ROWS
    ctas = -(-p * g // rows) * hkv * b
    return {"name": f"prefill_attention[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefill_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "ctas": ctas, "achieved_tflops": flops / ms / 1e9,
            "shape": {"B": b, "P": p, "S_max": s_max, "offsets": offl}}


def cuda_time_cold(fn, n_copies: int, rounds: int, graph: bool = True) -> float:
    """Mean milliseconds per call of ``fn(i)``, where call i reads input
    copy ``i % n_copies`` (CUDA events): with the copies together larger
    than the 50 MB L2, each call finds its inputs cold, as each of the
    serve's 48 layers finds its own cache.  With ``graph`` the calls are
    captured once in a CUDA graph and replayed, so the time is the card's
    and not that of the Python that launches them (a call that takes the
    card a few microseconds takes the host longer to launch)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_copies):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    n = n_copies * rounds
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(n):
                fn(i % n_copies)
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    else:
        def run():
            for i in range(n):
                fn(i % n_copies)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_decode_attention(gen, tag: str, b=8, s_max=2048,
                           len_range=(601, 1517)) -> dict:
    """K3 at the serve's decode step (8 slots, one of them idle with the
    stale length S_max + 1), timed cold in CUDA graphs: kernel, plain
    version and SDPA each rotate over copies of the cache that together
    exceed 4 x the 50 MB L2.  ``ms_hot`` repeats one copy and
    ``ms_eager`` launches from Python: how K3 was timed before it became
    faster than its own launch."""
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd = 32, 4, 128
    dev = torch.device("cuda")
    q = torch.randn((b, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    cache_bytes = 2 * b * s_max * hkv * hd * 2
    n_copies = max(2, int(-(-4 * L2_BYTES // cache_bytes)))
    caches = [tuple(torch.randn((b, s_max, hkv, hd), device=dev, generator=gen)
                    .to(torch.bfloat16) for _ in range(2)) for _ in range(n_copies)]
    kc, vc = caches[0]
    lens = torch.randint(*len_range, (b,), device=dev, generator=gen,
                         dtype=torch.int32)
    lens[-1] = s_max + 1
    got = ops.decode_attention(q, kc, vc, lens)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **ATTN_TOL)
    split = ops.decode_split(b, hkv, s_max)
    log(f"decode_attention[{tag}] B{b} S_max {s_max} lengths {lens.tolist()}: "
        f"max abs {max_abs:.3e} (tol {ATTN_TOL}); split {split}, "
        f"{split * hkv * b} CTAs")
    if not ok:
        raise AssertionError(f"decode_attention[{tag}] disagrees")
    again = ops.decode_attention(q, kc, vc, lens)
    if not torch.equal(got, again):
        raise AssertionError(f"decode_attention[{tag}]: two launches differ")
    used = [min(int(n), s_max) for n in lens.tolist()]
    nbytes = 2 * q.numel() * 2 + sum(used) * 2 * hkv * hd * 2 + b * 4
    flops = 4 * hd * h * sum(used)
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = cuda_time_cold(lambda i: ops.decode_attention(q, *caches[i], lens),
                        n_copies, rounds=8)
    ms_eager = cuda_time_cold(
        lambda i: ops.decode_attention(q, *caches[i], lens), n_copies,
        rounds=8, graph=False)
    ms_hot = cuda_time_cold(lambda i: ops.decode_attention(q, kc, vc, lens),
                            1, rounds=48)
    plain = cuda_time_cold(
        lambda i: ref.decode_attention_ref(q, *caches[i], lens), n_copies,
        rounds=2)
    g = h // hkv
    rep = [tuple(c.transpose(1, 2).repeat(1, g, 1, 1) for c in kv)
           for kv in caches]
    mask = (torch.arange(s_max, device=dev)[None, :]
            < lens.clamp(max=s_max).long()[:, None])[:, None, None, :]
    lib = cuda_time_cold(lambda i: _sdpa_gmajor(q[:, :, None], *rep[i], mask),
                         n_copies, rounds=8)
    del caches, rep
    return {"name": f"decode_attention[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:85",
            "max_abs_err": max_abs, "ms": ms, "ms_hot": ms_hot,
            "ms_eager": ms_eager,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "split": split, "ctas": split * hkv * b,
            "timing": f"CUDA graph replay, cold: {n_copies} cache copies "
                      f"of {cache_bytes / 1e6:.1f} MB rotated; ms_hot: one "
                      "copy; ms_eager: cold, launched from Python",
            "shape": {"B": b, "S_max": s_max, "lengths": lens.tolist()}}


def check_moe_gmm_dense(tag: str, c: int, gen) -> dict:
    """K4 over the dense (E, C, d) buffer at qwen3-30b-a3b widths: C = 8 is
    the engine's full-pool decode step (dropless, C = n_slots), C = 1024 a
    packed 4 x 256-token prefill."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import dense_init
    e, d, f = 128, 2048, 768
    dev = torch.device("cuda")
    w_gate = dense_init((e, d, f), torch.bfloat16, dev, gen)
    w_up = dense_init((e, d, f), torch.bfloat16, dev, gen)
    w_down = dense_init((e, f, d), torch.bfloat16, dev, gen)
    x = torch.randn((e, c, d), device=dev, generator=gen).to(torch.bfloat16)
    args = (x, w_gate, w_up, w_down)
    got = ops.moe_gmm(*args)
    want = ref.moe_gmm_ref(*args)
    again = ops.moe_gmm(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"moe_gmm[{tag}]: two launches differ")
    diff = got.float() - want.float()
    rel = (diff.norm() / want.float().norm()).item()
    max_abs = diff.abs().max().item()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"moe_gmm[{tag}]: non-finite output")
    log(f"moe_gmm[{tag}] E {e} C {c}: rel Frobenius {rel:.3e} (tol "
        f"{GMM_REL_FRO}), max abs {max_abs:.3e}")
    if not rel <= GMM_REL_FRO:
        raise AssertionError(f"moe_gmm[{tag}] disagrees: rel {rel}")
    # every expert computes all C rows: all E experts' weights are read
    nbytes = 2 * x.numel() * 2 + e * 3 * d * f * 2
    flops = e * c * 6 * d * f
    b_ms, b_by = bound_ms(nbytes, flops)
    ms, ms_eager, timing = _time_gmm(lambda: ops.moe_gmm(*args), c <= 8)
    plain = cuda_time(lambda: ref.moe_gmm_ref(*args), iters=3)
    del want

    def chain():
        # the cuBLAS yardstick in bf16: bmm, bmm, silu * mul, bmm
        h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
        return torch.bmm(h, w_down)
    chain_ms = _time_gmm(chain, c <= 8)[0]
    return {"name": f"moe_gmm[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:45",
            "max_abs_err": max_abs, "rel_fro_err": rel, "ms": ms,
            "ms_eager": ms_eager, "timing": timing,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes a per-expert "
                            "fused SwiGLU",
            "cublas_chain_ms": chain_ms,
            "cublas_chain_note": "three bf16 torch.bmm calls plus silu and "
                                 "mul, timed as the kernel is: a yardstick "
                                 "of several calls, not library_ms",
            "achieved_tflops": flops / ms / 1e9,
            "shape": {"E": e, "C": c, "d": d, "F": f}}


def _paged_pool(lens, page, hkv, hd, gen):
    """Slot rows of K/V for sequences of ``lens`` tokens, and the same
    keys scattered into a page pool through block tables that the port's
    PagedKVAllocator hands out as the sequences grow page by page in turns
    (so each sequence's pages interleave with the others')."""
    import torch
    from repro_torch.serving.kvcache import PagedKVAllocator
    dev = torch.device("cuda")
    b = len(lens)
    max_pages = -(-max(lens) // page)
    alloc = PagedKVAllocator(n_pages=b * max_pages, page_size=page)
    for rid in range(b):
        alloc.reserve(rid, page)
    for n in range(2 * page, max_pages * page + 1, page):
        for rid, ln in enumerate(lens):
            if n - page < ln:
                alloc.grow_to(rid, min(n, ln))
    s_max = max_pages * page
    k_slot = torch.randn((b, s_max, hkv, hd), device=dev, generator=gen).to(torch.bfloat16)
    v_slot = torch.randn((b, s_max, hkv, hd), device=dev, generator=gen).to(torch.bfloat16)
    k_pages = torch.zeros((alloc.n_pages, page, hkv, hd), dtype=torch.bfloat16, device=dev)
    v_pages = torch.zeros_like(k_pages)
    bt = torch.zeros((b, max_pages), dtype=torch.int32)
    for rid in range(b):
        table = alloc.block_table(rid)
        bt[rid, :len(table)] = torch.tensor(table, dtype=torch.int32)
        ids = torch.tensor(table, device=dev)
        k_pages[ids] = k_slot[rid, :len(table) * page].reshape(-1, page, hkv, hd)
        v_pages[ids] = v_slot[rid, :len(table) * page].reshape(-1, page, hkv, hd)
    return k_slot, v_slot, k_pages, v_pages, bt.to(dev)


def check_paged_attention(gen) -> list:
    """K5 and K6 at qwen3-30b-a3b widths (H 32, Hkv 4, hd 128) over the
    engine's default 16-token pages, 8 sequences of 723-2049 tokens."""
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd, page = 32, 4, 128, 16
    dev = torch.device("cuda")
    lens = torch.randint(723, 2050, (8,), generator=torch.Generator().manual_seed(5))
    lens[0], lens[-1] = 723, 2049
    lens_l = [int(n) for n in lens.tolist()]
    k_slot, v_slot, kp, vp, bt = _paged_pool(lens_l, page, hkv, hd, gen)
    lengths = lens.to(dev, torch.int32)
    b, max_pages = bt.shape
    q = torch.randn((b, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    got = ops.paged_decode_attention(q, kp, vp, bt, lengths)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, lengths)
    slot = ops.decode_attention(q, k_slot, v_slot, lengths)
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    vs_k3 = (got.float() - slot.float()).abs().max().item()
    log(f"paged_decode_attention[B{b} pages of {page}, lengths {lens_l}]: "
        f"max abs {max_abs:.3e} vs plain, {vs_k3:.3e} vs decode_attention "
        f"on slot rows (tol {ATTN_TOL})")
    if not (torch.allclose(got.float(), want.float(), **ATTN_TOL)
            and torch.allclose(got.float(), slot.float(), **ATTN_TOL)):
        raise AssertionError("paged_decode_attention disagrees")

    def kv_bytes(n_tok):
        return n_tok * 2 * hkv * hd * 2
    table_bytes = bt.numel() * 4 + b * 4
    nbytes = 2 * q.numel() * 2 + kv_bytes(sum(lens_l)) + table_bytes
    b_ms, b_by = bound_ms(nbytes, 4 * hd * h * sum(lens_l))
    ms = cuda_time(lambda: ops.paged_decode_attention(q, kp, vp, bt, lengths),
                   iters=50)
    plain = cuda_time(lambda: ref.paged_decode_attention_ref(q, kp, vp, bt,
                                                             lengths), iters=10)
    no_lib = "no PyTorch call reads K/V through a block table"
    out = [{"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:277",
            "max_abs_err": max_abs, "max_abs_vs_decode_attention": vs_k3,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "library_note": no_lib,
            "shape": {"B": b, "page_size": page, "max_pages": max_pages,
                      "lengths": lens_l}}]

    # K6: a 4-token verify window, and W = 1 against K5
    w = 4
    qw = torch.randn((b, w, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    got = ops.paged_verify_attention(qw, kp, vp, bt, lengths)
    want = ref.paged_verify_attention_ref(qw, kp, vp, bt, lengths)
    one = ops.paged_verify_attention(q[:, None], kp, vp, bt, lengths)[:, 0]
    dec = ops.paged_decode_attention(q, kp, vp, bt, lengths)
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    vs_k5 = (one.float() - dec.float()).abs().max().item()
    log(f"paged_verify_attention[W{w}]: max abs {max_abs:.3e} vs plain; "
        f"W 1 vs paged_decode_attention max abs {vs_k5:.3e} (tol {ATTN_TOL})")
    if not (torch.allclose(got.float(), want.float(), **ATTN_TOL)
            and torch.allclose(one.float(), dec.float(), **ATTN_TOL)):
        raise AssertionError("paged_verify_attention disagrees")
    # window row j of a sequence of length n sees n - w + 1 + j keys
    pairs = sum(n - w + 1 + j for n in lens_l for j in range(w))
    nbytes = 2 * qw.numel() * 2 + kv_bytes(sum(lens_l)) + table_bytes
    b_ms, b_by = bound_ms(nbytes, 4 * hd * h * pairs)
    ms = cuda_time(lambda: ops.paged_verify_attention(qw, kp, vp, bt, lengths),
                   iters=50)
    plain = cuda_time(lambda: ref.paged_verify_attention_ref(qw, kp, vp, bt,
                                                             lengths), iters=10)
    out.append({"name": f"paged_verify_attention[W{w}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:216",
                "max_abs_err": max_abs, "max_abs_w1_vs_paged_decode": vs_k5,
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "library_note": no_lib,
                "shape": {"B": b, "W": w, "page_size": page,
                          "max_pages": max_pages, "lengths": lens_l}})
    return out


# ---------------------------------------------------------------- phase 3


def check_small_model_end_to_end() -> None:
    """The reduced qwen3 model in bf16 on the card (the kernels of the
    ragged and of the dense MoE path) vs the same weights in fp32 on the
    CPU (plain versions, ragged): a 48-token prefill into the cache, then
    one decode step."""
    import torch
    from repro_torch.launch.serve import ServeArgs, model_config
    from repro_torch.models.model import DecoderModel
    cfg = model_config(ServeArgs(smoke=True, dtype="bfloat16"))
    gpu = DecoderModel(cfg, device="cuda")
    params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))
    cpu = DecoderModel(dataclasses.replace(cfg, dtype="float32",
                                           param_dtype="float32"), device="cpu")

    def tree(t, fn):
        if isinstance(t, dict):
            return {k: tree(v, fn) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v, fn) for v in t]
        return fn(t)
    p_cpu = tree(params, lambda a: a.float().cpu())
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (2, 49), generator=g)
    off = torch.tensor([0, 5], dtype=torch.int32)
    def run(model, p_, dev, moe_dispatch):
        cache = model.init_cache(2, 128)
        kw = dict(cache=cache, dropless=True, moe_dispatch=moe_dispatch)
        lp, cache, _ = model.forward(p_, toks[:, :48].to(dev),
                                     offset=off.to(dev), **kw)
        ld, cache, _ = model.forward(p_, toks[:, 48:].to(dev),
                                     offset=(off + 48).to(dev), **kw)
        return lp.float().cpu(), ld.float().cpu()
    want = run(cpu, p_cpu, "cpu", "ragged")
    for moe_dispatch in ("ragged", "dense"):
        got = run(gpu, params, "cuda", moe_dispatch)
        for name, a, b_ in (("prefill", got[0], want[0]),
                            ("decode", got[1], want[1])):
            if not torch.isfinite(a).all():
                raise AssertionError(f"end-to-end {name}: non-finite logits")
            rel = ((a - b_).norm() / b_.norm()).item()
            agree = (a.argmax(-1) == b_.argmax(-1)).float().mean().item()
            log(f"small model {name} logits, {moe_dispatch} dispatch, bf16 "
                f"kernels vs fp32 CPU: rel Frobenius {rel:.3e} (tol "
                f"{E2E_REL_FRO}), argmax agreement {agree:.3f}")
            if not rel <= E2E_REL_FRO:
                raise AssertionError(f"end-to-end {name} ({moe_dispatch}) "
                                     f"disagrees: rel {rel}")


# ---------------------------------------------------------------- phase 4


# the kernels each MoE dispatch's serve must launch; a serve launches no
# other kernel (the paged kernels are on no serve path)
PATH_KERNELS = {"ragged": ("moe_gmm_ragged", "prefill_attention",
                           "decode_attention"),
                "dense": ("moe_gmm", "prefill_attention", "decode_attention")}


def run_serve(a, model, params, n_new: int) -> dict:
    """One closed-loop serve through the port's launcher, with the launch
    counts set to 0 just before it and read just after, and its host syncs
    counted; raises unless every request completes with ``n_new``
    in-vocabulary tokens, every kernel of the dispatch's path launched and
    no other kernel did, and the serve made at most one host sync per
    iteration (plus the two synchronize() calls that bound the timing)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_real
    tag = f"{a.moe_dispatch}/{a.scheduler}"
    # counts start at 0 just before the main path (the comparison
    # launches of phase 2 do not count) and are read just after
    ops.reset_launches()
    # count the host syncs the serve makes: torch reports each
    # synchronizing call as a warning in its sync debug mode
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = serve_real(a, model, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts = dict(ops.LAUNCHES)
    sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    r["host_syncs"] = sum(sites.values())
    r["host_sync_sites"] = dict(sites)
    r["launches"] = counts
    r["pad_copies"] = dict(ops.PAD_COPIES)
    torch.cuda.empty_cache()
    vocab = model.cfg.vocab_size
    if r["completed"] != r["requests"]:
        raise AssertionError(f"{tag}: {r['completed']}/{r['requests']} "
                             "requests completed")
    if any(len(t) != n_new for t in r["outputs"].values()):
        raise AssertionError(f"{tag}: a request did not get {n_new} tokens")
    if any(not 0 <= x < vocab for t in r["outputs"].values() for x in t):
        raise AssertionError(f"{tag}: token id out of range")
    path = PATH_KERNELS[a.moe_dispatch]
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    stray = {k: v for k, v in counts.items() if k not in path and v}
    if stray:
        raise AssertionError(f"{tag}: kernels of another path launched: "
                             f"{stray}")
    if any(r["pad_copies"].values()):
        raise AssertionError(f"{tag}: the MoE kernel padded its operands "
                             f"{r['pad_copies']}: qwen3 widths never need it")
    if r["host_syncs"] > r["iterations"] + 2:
        raise AssertionError(f"{tag}: {r['host_syncs']} host syncs in "
                             f"{r['iterations']} iterations")
    log(f"{tag}: {r['iterations']} iterations, {r['ms_per_iter']:.1f} "
        f"ms/iter, expert-load {r['expert_load_bytes'] / 1e6:.1f} MB, "
        f"{r['host_syncs']} host syncs {r['host_sync_sites']}, "
        f"launches {counts}, padded MoE copies {r['pad_copies']}")
    return r


def _same_streams(x: dict, y: dict) -> str:
    same = sum(x["outputs"][r] == y["outputs"][r] for r in x["outputs"])
    first = sum(x["outputs"][r][0] == y["outputs"][r][0] for r in x["outputs"])
    n = len(x["outputs"])
    return (f"identical first tokens {first}/{n}, identical token streams "
            f"{same}/{n}")


def serve_full() -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeArgs, build_model
    base = ServeArgs(arch="qwen3-30b-a3b", requests=4, max_len=2048, slots=8,
                     quantum=512, token_budget=512, seed=0,
                     prompt_len=(600, 1501), new_tokens=(16, 17))
    # the dense dispatch computes every expert over every token of a batch
    # (C = T), so it serves short prompts: 64-256 tokens, 8 new each
    short = dataclasses.replace(base, max_len=512, quantum=128,
                                token_budget=128, prompt_len=(64, 257),
                                new_tokens=(8, 9))
    t0 = time.perf_counter()
    model, params = build_model(base)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"built {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, vocab {cfg.vocab_size}; {n_params / 1e9:.2f} B "
        f"params ({torch.cuda.memory_allocated() / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for sched in ("layered", "chunked"):
        runs[f"ragged/{sched}"] = run_serve(
            dataclasses.replace(base, scheduler=sched), model, params, 16)
    for disp, sched in (("dense", "layered"), ("dense", "chunked"),
                        ("ragged", "layered")):
        runs[f"short {disp}/{sched}"] = run_serve(
            dataclasses.replace(short, scheduler=sched, moe_dispatch=disp),
            model, params, 8)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ops.LAUNCHES}

    lay, chk = runs["ragged/layered"], runs["ragged/chunked"]
    if not lay["expert_load_bytes"] <= chk["expert_load_bytes"]:
        raise AssertionError("layered expert-load exceeds chunked")
    log(f"layered / chunked expert-load {lay['expert_load_bytes'] / 1e6:.1f} / "
        f"{chk['expert_load_bytes'] / 1e6:.1f} MB "
        f"({lay['expert_load_bytes'] / chk['expert_load_bytes']:.3f}); "
        f"{_same_streams(lay, chk)} (bf16: other batch shapes round "
        "differently and may flip an argmax)")
    dl, dc = runs["short dense/layered"], runs["short dense/chunked"]
    rl = runs["short ragged/layered"]
    if not dl["expert_load_bytes"] <= dc["expert_load_bytes"]:
        raise AssertionError("dense: layered expert-load exceeds chunked")
    # K1 and K4 share their per-row arithmetic, so the two dispatches give
    # the same rows, the same tokens and the same expert unions
    if (dl["expert_load_bytes"] != rl["expert_load_bytes"]
            or dl["outputs"] != rl["outputs"]):
        raise AssertionError(f"short trace, layered: dense and ragged differ: "
                             f"{_same_streams(dl, rl)}, expert-load "
                             f"{dl['expert_load_bytes']} / "
                             f"{rl['expert_load_bytes']} B")
    log(f"short trace, layered: dense / ragged expert-load "
        f"{dl['expert_load_bytes'] / 1e6:.1f} / "
        f"{rl['expert_load_bytes'] / 1e6:.1f} MB, {_same_streams(dl, rl)}; "
        f"{dl['ms_per_iter']:.1f} / {rl['ms_per_iter']:.1f} ms/iter. Dense "
        f"layered / chunked expert-load {dl['expert_load_bytes'] / 1e6:.1f} / "
        f"{dc['expert_load_bytes'] / 1e6:.1f} MB, {_same_streams(dl, dc)}")
    profile_serve(dataclasses.replace(base, scheduler="layered"), model,
                  params)
    profile_serve(dataclasses.replace(short, scheduler="layered",
                                      moe_dispatch="dense"), model, params)
    return {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "outputs"}
                     for k, v in runs.items()}, "launches": launches}


def profile_serve(a, model, params) -> None:
    """The same serve once more under torch.profiler: device time by
    kernel and the device's busy share of the (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_real
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = serve_real(a, model, params)
    dev = []
    for e in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if e.device_type == DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev.append((us, e.count, e.key))
    dev.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in dev) / 1e3
    log(f"profile of the {a.moe_dispatch}/{a.scheduler} serve "
        f"({r['iterations']} iterations, "
        f"{r['wall_s'] * 1e3:.1f} ms wall under the profiler): device busy "
        f"{busy_ms:.1f} ms = {busy_ms / (r['wall_s'] * 1e3):.3f} of wall")
    own = ("moe_swiglu", "prefill_attention", "decode_", "paged_attention")
    for rank, (us, n, name) in enumerate(dev):
        if rank < 12 or any(k in name for k in own):
            log(f"  {us / 1e3:10.1f} ms {n:7d} x  {name[:100]}")


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, list):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("[chip_smoke] CUDA is not available")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("[chip_smoke] src/repro_torch is missing: run from "
                         "the root of a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("registers" in line or "spill" in line or "setmaxnreg" in line
                    or "entry function" in line):
                log(f"  {name}: {line.strip()[:160]}")
    # the prefill and the two MoE kernels' products should run on wgmma
    # (HGMMA) and their tiles arrive by TMA (UTMALDG); the decode kernel's
    # on mma.sync (HMMA) fed by cp.async (LDGSTS)
    sass = {k: build.sass_counts(k) for k in ("prefill_attention",
                                              "moe_gmm_ragged", "moe_gmm")}
    log(f"SASS opcodes: {sass}, decode_attention "
        f"{build.sass_counts('decode_attention', ('HMMA', 'LDGSTS', 'MOVM'))}")
    for k in ("moe_gmm_ragged", "moe_gmm"):
        if sass[k] is not None and not (sass[k]["HGMMA"] > 0
                                        and sass[k]["UTMALDG"] > 0):
            raise AssertionError(f"{k}: no wgmma or TMA in its SASS: {sass[k]}")

    # K1 at decode (8 slots -> 960 rows, m_blk 8) and at a 2048-token
    # prefill (32640 rows, m_blk 128); K2 at a layered first group (4
    # whole prompts in the 2048 bucket) and a chunked step (512-token
    # chunks at four offsets); K3 at the 8-slot decode step of the long
    # (S_max 2048) and the short (S_max 512) trace; K4 at the
    # dense decode step (C 8) and a packed 4 x 256 prefill (C 1024); K5
    # and K6 over the paged pool
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_moe_gmm("decode", 8, gen),
               check_moe_gmm("prefill", 2048, gen),
               check_prefill_attention("layered", gen),
               check_prefill_attention("chunked", gen, b=4, p=512,
                                       offsets=[0, 512, 1024, 1536]),
               check_decode_attention(gen, "long"),
               check_decode_attention(gen, "short", s_max=512,
                                      len_range=(65, 266))]
    torch.cuda.empty_cache()
    kernels += [check_moe_gmm_dense("decode", 8, gen),
                check_moe_gmm_dense("prefill", 1024, gen)]
    torch.cuda.empty_cache()
    kernels += check_paged_attention(gen)
    torch.cuda.empty_cache()
    for k in kernels:
        k["bound_share"] = k["bound_ms"] / k["ms"]
    check_small_model_end_to_end()
    torch.cuda.empty_cache()
    if "--skip-serve" in sys.argv[1:]:
        print(json.dumps({"kernels": kernels}))
        raise SystemExit("[chip_smoke] --skip-serve: stopped after the kernel "
                         "checks; no result")

    serve = serve_full()
    for k in kernels:
        k["launches"] = serve["launches"][k["name"].split("[")[0]]
    log("serve summary " + json.dumps(serve["runs"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
