#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught and turned into exit 0):

1. print the card's name and power limit; build the three CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a), in parallel.
2. hold each kernel against its plain PyTorch version at the serving
   path's qwen3-30b-a3b shapes in bf16 and time kernel, plain version and,
   where one PyTorch call computes the same function, that call.
3. check the kernel path end to end against the CPU fp32 plain path on a
   small model (finite logits that agree within a stated tolerance).
4. serve qwen3-30b-a3b at full width (d_model 2048, 32/4 heads, 128
   experts top-8, 48 layers, random weights from a seed) through the
   port's launcher with layered and then chunked prefill: every request
   completes, every kernel launches, one host sync per iteration,
   layered expert-load <= chunked; then profile the layered serve once
   more (device time by kernel, the device's busy share).

It prints a JSON ``kernels`` line, the ``nvidia-smi`` line, and, as its
last line, ``{"ok": true, "device": {...}}``.  Without CUDA, or run from
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
    torch.cuda.synchronize()
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
    ms = cuda_time(lambda: ops.moe_gmm_ragged(*args), iters=10)
    plain = cuda_time(lambda: ref.moe_gmm_ragged_ref(*args), iters=3)
    return {"name": f"moe_gmm_ragged[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm_ragged.cu",
            "replaces": "src/repro/kernels/moe_gmm_ragged.py:69",
            "max_abs_err": max_abs, "rel_fro_err": rel, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": {"rows": n_rows, "m_blk": m_blk, "active_experts": n_active}}


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
    return {"name": f"prefill_attention[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefill_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "shape": {"B": b, "P": p, "S_max": s_max, "offsets": offl}}


def check_decode_attention(gen, b=8, s_max=2048) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd = 32, 4, 128
    dev = torch.device("cuda")
    q = torch.randn((b, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    kc = torch.randn((b, s_max, hkv, hd), device=dev, generator=gen).to(torch.bfloat16)
    vc = torch.randn((b, s_max, hkv, hd), device=dev, generator=gen).to(torch.bfloat16)
    # prompts of 600-1500 tokens part-way through 16 new tokens, and one
    # idle slot with the stale offset max_len (length clamps to S_max)
    lens = torch.randint(601, 1517, (b,), device=dev, generator=gen, dtype=torch.int32)
    lens[-1] = s_max + 1
    got = ops.decode_attention(q, kc, vc, lens)
    want = ref.decode_attention_ref(q, kc, vc, lens)
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **ATTN_TOL)
    log(f"decode_attention[B{b} lengths {lens.tolist()}]: max abs "
        f"{max_abs:.3e} (tol {ATTN_TOL})")
    if not ok:
        raise AssertionError("decode_attention disagrees")
    used = [min(int(n), s_max) for n in lens.tolist()]
    nbytes = 2 * q.numel() * 2 + sum(used) * 2 * hkv * hd * 2 + b * 4
    flops = 4 * hd * h * sum(used)
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = cuda_time(lambda: ops.decode_attention(q, kc, vc, lens), iters=50)
    plain = cuda_time(lambda: ref.decode_attention_ref(q, kc, vc, lens), iters=10)
    g = h // hkv
    kt = kc.transpose(1, 2).repeat(1, g, 1, 1)
    vt = vc.transpose(1, 2).repeat(1, g, 1, 1)
    mask = (torch.arange(s_max, device=dev)[None, :]
            < lens.clamp(max=s_max).long()[:, None])[:, None, None, :]
    lib = cuda_time(lambda: _sdpa_gmajor(q[:, :, None], kt, vt, mask), iters=50)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:85",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "shape": {"B": b, "S_max": s_max, "lengths": lens.tolist()}}


# ---------------------------------------------------------------- phase 3


def check_small_model_end_to_end() -> None:
    """The reduced qwen3 model in bf16 on the card (all three kernels) vs
    the same weights in fp32 on the CPU (plain versions): a 48-token
    prefill into the cache, then one decode step."""
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
    res = []
    for model, p_, dev in ((gpu, params, "cuda"), (cpu, p_cpu, "cpu")):
        cache = model.init_cache(2, 128)
        lp, cache, _ = model.forward(p_, toks[:, :48].to(dev),
                                     offset=off.to(dev), cache=cache)
        ld, cache, _ = model.forward(p_, toks[:, 48:].to(dev),
                                     offset=(off + 48).to(dev), cache=cache)
        res.append((lp.float().cpu(), ld.float().cpu()))
    for name, a, b_ in (("prefill", res[0][0], res[1][0]),
                        ("decode", res[0][1], res[1][1])):
        if not torch.isfinite(a).all():
            raise AssertionError(f"end-to-end {name}: non-finite logits")
        rel = ((a - b_).norm() / b_.norm()).item()
        agree = (a.argmax(-1) == b_.argmax(-1)).float().mean().item()
        log(f"small model {name} logits, bf16 kernels vs fp32 CPU: rel "
            f"Frobenius {rel:.3e} (tol {E2E_REL_FRO}), argmax agreement "
            f"{agree:.3f}")
        if not rel <= E2E_REL_FRO:
            raise AssertionError(f"end-to-end {name} disagrees: rel {rel}")


# ---------------------------------------------------------------- phase 4


def serve_full() -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ServeArgs, build_model, serve_real
    base = ServeArgs(arch="qwen3-30b-a3b", requests=4, max_len=2048, slots=8,
                     quantum=512, token_budget=512, seed=0,
                     prompt_len=(600, 1501), new_tokens=(16, 17))
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
    runs, launches = {}, {k: 0 for k in ops.LAUNCHES}
    for sched in ("layered", "chunked"):
        a = dataclasses.replace(base, scheduler=sched)
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
        for k, v in counts.items():
            launches[k] += v
        r["launches"] = counts
        runs[sched] = r
        torch.cuda.empty_cache()
        if r["completed"] != r["requests"]:
            raise AssertionError(f"{sched}: {r['completed']}/{r['requests']} "
                                 "requests completed")
        if any(len(t) != 16 for t in r["outputs"].values()):
            raise AssertionError(f"{sched}: a request did not get 16 tokens")
        if any(not 0 <= x < cfg.vocab_size for t in r["outputs"].values() for x in t):
            raise AssertionError(f"{sched}: token id out of range")
        missing = [k for k, v in counts.items() if v <= 0]
        if missing:
            raise AssertionError(f"{sched}: kernels never launched: {missing}")
        # one fetch per iteration, plus the two synchronize() calls that
        # bound the timed region
        if r["host_syncs"] > r["iterations"] + 2:
            raise AssertionError(f"{sched}: {r['host_syncs']} host syncs in "
                                 f"{r['iterations']} iterations")
        log(f"{sched}: {r['iterations']} iterations, {r['ms_per_iter']:.1f} "
            f"ms/iter, expert-load {r['expert_load_bytes'] / 1e6:.1f} MB, "
            f"{r['host_syncs']} host syncs {r['host_sync_sites']}, "
            f"launches {counts}")
    lay, chk = runs["layered"], runs["chunked"]
    if not lay["expert_load_bytes"] <= chk["expert_load_bytes"]:
        raise AssertionError("layered expert-load exceeds chunked")
    same = sum(lay["outputs"][r] == chk["outputs"][r] for r in lay["outputs"])
    first = sum(lay["outputs"][r][0] == chk["outputs"][r][0]
                for r in lay["outputs"])
    log(f"layered / chunked expert-load {lay['expert_load_bytes'] / 1e6:.1f} / "
        f"{chk['expert_load_bytes'] / 1e6:.1f} MB "
        f"({lay['expert_load_bytes'] / chk['expert_load_bytes']:.3f}); "
        f"identical first tokens {first}/{len(lay['outputs'])}, identical "
        f"token streams {same}/{len(lay['outputs'])} (bf16: other batch "
        "shapes round differently and may flip an argmax)")
    profile_serve(dataclasses.replace(base, scheduler="layered"), model,
                  params)
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
    log(f"profile of the {a.scheduler} serve ({r['iterations']} iterations, "
        f"{r['wall_s'] * 1e3:.1f} ms wall under the profiler): device busy "
        f"{busy_ms:.1f} ms = {busy_ms / (r['wall_s'] * 1e3):.3f} of wall")
    for us, n, name in dev[:12]:
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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # K1 at decode (8 slots -> 960 rows, m_blk 8) and at a 2048-token
    # prefill (32640 rows, m_blk 128); K2 at a layered first group (4
    # whole prompts in the 2048 bucket) and a chunked step (512-token
    # chunks at four offsets); K3 at the 8-slot decode step
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_moe_gmm("decode", 8, gen),
               check_moe_gmm("prefill", 2048, gen),
               check_prefill_attention("layered", gen),
               check_prefill_attention("chunked", gen, b=4, p=512,
                                       offsets=[0, 512, 1024, 1536]),
               check_decode_attention(gen)]
    torch.cuda.empty_cache()
    check_small_model_end_to_end()
    torch.cuda.empty_cache()

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
