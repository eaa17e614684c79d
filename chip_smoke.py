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
   rows, and beside a gather-then-SDPA chain), K6 paged verify attention
   (W = 4 and 5, and W = 1 bit for bit equal to K5); K5 and K6 are timed
   as K3 is, with their split, row blocks and CTA count.  K2 also at the
   group sizes that do not divide its 128 query rows (phi4-mini's g 3 and
   yi-34b's g 7, layered) and at the verify window (P 5 over 8 rows deep
   in their cache); K3 at g 3 and g 7; and K2 at g 8 must give the bits
   of the kernel before it took every group size (``K2_G8_SHA256``).  K1 and K4 at
   decode are timed in CUDA graphs beside their eager time; two launches
   of each kernel must agree bit for bit.  Each kernel's share of its
   bound is bound_ms / ms.  The build's ptxas report and, where cuobjdump
   exists, the SASS opcodes that show K2, K1, K4 and the backwards of K2
   and K4 on wgmma (HGMMA) and TMA (UTMALDG), and K3 and K5/K6 on
   mma.sync (HMMA) fed by cp.async (LDGSTS), are printed (none in K1, K4
   or either backward, or no HMMA in K5/K6, fails the run).  The large
   MoE models' shapes too: K2 and K3 at multi-head latent attention's
   query/key width 192 against value width 128
   (deepseek-v2-236b, H = Hkv = 128; two launches bit for bit; SDPA at
   the same widths beside them, with the backends that take them) and at
   g 16 (qwen3-moe-235b-a22b), K1 at both models' widths and K4 at
   deepseek's.  recurrentgemma-9b's local attention: K2 at (256, 256),
   16/1 heads (g 16), window 2048, on a layered first group (4 x 2048)
   and a chunked step (512-token chunks at offsets 2048-3584 of a
   4096-row cache: the window binds), K3 at the 8-slot decode step
   (lengths 2100-4096), each beside SDPA at the same mask with the
   backends that take hd 256.  whisper-base: K2 without the causal mask
   at its encoder (1 x 1500 frames over themselves, 8/8 heads of 64) and
   at cross-attention prefill (4 x 512 prompt tokens over 1500 frames),
   each beside SDPA without a mask; K3 at cross decode (8 slots, lengths
   1500); K2 and K3 at its decoder's short trace; qwen2-vl-72b's K2 and
   K3 (64/8 heads of 128) at the long trace.  Training's kernels: K2's
   forward with its log-sum-exp (against the plain one; the output
   unchanged by it) and K2's backward (three launches: D and the
   log-sum-exp rows, dK/dV, dQ; two more sum the dK/dV pass's query-head
   groups where ``ops.bwd_split`` splits it; the split and each pass's
   CTAs printed as the C entry reports launching them) at minicpm-2b's heads (36/36 of 64) and qwen3-30b-a3b's
   (32/4 of 128), at the launcher's 8 x 256 tokens and at two 2048-token
   rows, and at the contracts of the other three archs' attention:
   recurrentgemma-9b's (16/1 of 256, window 2048) at 8 x 256 tokens and
   at one 4096-token row, where the window binds; deepseek-v2-236b's MLA
   (128 heads, dk 192, dv 128) at 8 x 256; whisper-base's cross-
   attention (8 x 256 queries over 1500 frames, no causal mask) and its
   encoder (1500 frames over themselves, not on the training path),
   beside the plain backward and SDPA's backward (each row's kernel and
   SDPA timed over 20 calls), and the gradients at
   (64, 64) and (128, 128) must keep their bits (``K2_BWD_SHA256``); K4's
   backward (four launches) at qwen3's widths with C 160 (2048 tokens),
   130 and 1 and at widths off a multiple of 8 (the padded copy), beside
   the plain version and the bf16 bmm chain (both timed over 10 calls),
   with each launch's CTAs as its C entry reports them;
   each within ``BWD_REL_FRO`` of its fp32 plain version and bit for bit
   across two launches, with its achieved TFLOP/s.
3. check the kernel path end to end against the CPU fp32 plain path on a
   small model, under the ragged and the dense MoE dispatch (finite
   logits that agree within a stated tolerance); and a small MLA model
   (block 0 dense, block 1 MoE with a shared expert, MLA's full head
   widths: K2 and K3 at (192, 128)) the same way, each token's expert set
   recorded on both sides: tokens routed alike within the tolerance, any
   other token at a router near-tie.  Then a small RG-LRU + local model
   (one period, 16/1 heads of 256: K2 and K3 at (256, 256), a window
   shorter than the prompt) and a small xLSTM model (7 mLSTM + 1 sLSTM;
   48- and 256-token prefills: the stepwise and chunkwise mLSTM), each
   one-shot and (48 tokens) in three chunks through the cache, then one
   decode step: bf16 on the card vs fp32 on the CPU within
   ``E2E_REL_FRO``; the RG-LRU model launches K2 and K3 only, the xLSTM
   model none of the six.  Then a small whisper model (whisper's head
   shape over 150 frames) and a small qwen2-vl model (hd 128, its M-RoPE
   sections): the encoder, the cross K/V, a prefill and a decode step
   through the cache, and the forward with the encoder output or with 8
   patch embeddings prepended, within ``E2E_REL_FRO``; K2 and K3 only.
   Then five small models at the backward kernels' contracts (a
   dense one at minicpm's head shape, a MoE one at qwen3's, an MLA + MoE
   one at (192, 128), an RG-LRU + local one at 16/1 heads of 256 under a
   window shorter than the sequence, a whisper one with cross-attention
   over 150 frames) train 5
   steps in bf16 on the card and in fp32 on the CPU: losses and step 1's
   gradients leaf by leaf within ``E2E_REL_FRO``, tokens routed otherwise
   at router near-ties only.
4. serve qwen3-30b-a3b at full width (d_model 2048, 32/4 heads, 128
   experts top-8, 48 layers, random weights from a seed) through the
   port's launcher: the ragged dispatch with layered and then chunked
   prefill on long prompts, then the dense dispatch with layered and
   chunked prefill on a short-prompt trace and the ragged dispatch once
   more on that trace as its yardstick (these five without the prefix
   cache, as before it was ported).  Then: open-loop replay of
   ``ServeConfig.engine_trace`` (8 Poisson arrivals at 1.3 req/s) on the
   wall clock, layered and chunked,
   with TTFT and TBT in ms; a shared-prefix trace (2 prefixes of 512
   tokens) with prefix hits and row restores; swap preemption in an
   oversubscribed page pool (every victim swapped back in) beside the same
   trace without pressure; and the hybrid, continuous and static
   schedulers on the short trace.  Then speculative verify-k decoding:
   a repetitive-prompt trace (``repetitive_trace``) under the n-gram
   drafter (spec_k 4) beside speculation off, and the draft model on the short
   trace, once the target drafting for itself and once a differently
   seeded 2-layer twin (their accepted shares reported); the draft step
   (capacity-limited dense dispatch, K2 and K4) is held against the
   target's no-cache forward on the self-draft's histories, each proposal
   within 4 bf16 ulps of the top logit; where spec and spec-off streams
   part, the first parting position and its logit gap in bf16 ulps are
   reported, not asserted.
   Every request completes with
   in-vocabulary tokens; every serve launches each kernel of its own path
   and none of another's; one host sync per iteration; no MoE call padded
   its operands; layered expert-load <= chunked; on the short trace the
   dense and the ragged layered serves give the same expert-load bytes
   and the same token streams (each serve's record carries a digest of
   its token streams, to compare trees).  Then disaggregated serving:
   two pools (a prefill engine and a decode engine) over the one copy of
   the weights, on the launcher's closed-loop generator (8 requests of
   16-1023 prompt tokens and 4-15 new ones, max_len 2048, 8 slots a pool,
   ragged): layered with streaming handoff (each layer group's K/V copied
   to pinned host memory as it completes) and with whole-prompt handoff,
   chunked with streaming, and the monolithic layered engine on the same
   requests as the yardstick; then chaos: the two pools layered/stream
   under two link drops, a link delay and a crash of each pool, and the
   swap serve under a seeded plan of crashes, pressure spikes, swap-DMA
   failures and client disconnects (retry budget 50).  Each two-pool
   serve must run no prefill slice on the decode pool; its prefill pool
   must launch exactly K1 and K2 and its decode pool K1 and K3; every
   export must move the prompt's K/V (98 304 B a token at qwen3's
   widths) and nothing else; it must sync the host once per iteration of
   each pool plus once per whole-prompt export; stream and whole must
   give the same streams.  Chaos serves must inject every planned fault,
   complete or shed (with a reason) every request, and leave no page in
   use on any allocator.  Where two-pool streams part from the
   monolithic ones, and chaos survivors from their fault-free serve, the
   first parting position and its logit gap in bf16 ulps are reported,
   not asserted.  Then the JAX launcher's remaining serving modes: the
   live HTTP/SSE serve (an in-process ``ServingServer`` on port 0 over a
   fresh engine, driven by ``load_gen.run_load`` with 4 clients over the
   open-loop trace's 8 requests, layered, while /metrics is scraped from
   the asyncio thread): every response 200, every request its
   ``max_new_tokens``, SSE order equal to the server's ``token_log`` and
   the engine's outputs, /metrics parsed with TTFT/TBT and the HTTP
   counters, /healthz and /readyz 200, one host sync per iteration, K1,
   K2 and K3 and no other kernel, no page in use after the stop; a replay
   of its admission log (each request arriving at the engine iteration at
   which it entered the live scheduler) must plan what the live serve
   planned and give its bf16 streams bit for bit; ``load_gen``'s offline
   replay is compared and reported, not asserted; ms/iter, TTFT/TBT,
   client latency and time to first byte are printed beside the
   wall-clock replay of the same trace.  Then the same 8 requests from 8
   clients under a rate limit of 2 req/s (burst 2): a 429 with a
   Retry-After, every request completed; then drained: a POST is answered
   503 and /readyz fails while a 64-token stream in flight completes.
   Then the short trace per slice (``packed=False``): the packed serve's
   plans, more launches, K1/K2/K3 only (streams against packed reported).
   Then the simulator (host only): ``serve_sim`` on the arXiv and ShareGPT
   length models, layered and chunked (modelled layered expert bytes below
   chunked), and the open-loop trace on the iteration clock through the
   card's engine and through ``SimExecutor``: the same plans, the modelled
   ms/iter (h100x2 preset) printed beside the measured one.  Then profile
   the ragged layered serve once more at its first 4 of 48 layers
   (``PROFILE_LAYERS``: device time by kernel, the device's busy share).
5. free qwen3 and serve gpt-oss-20b at full width (d_model 2880, 64/8
   heads of 64, 32 experts top-4 of d_ff 2880, 24 layers): the long trace
   layered and chunked (layered expert-load <= chunked), and the short
   trace under the dense dispatch.  Phase 2 holds K1-K4 at its shapes
   too (K2 and K3 at hd 64; K1 and K4 at d = F = 2880, off the
   128-column d-tile).  Then free gpt-oss and serve the registry's two
   large MoE models at full width, each at the depth the card's free
   memory holds (the reckoning is logged): deepseek-v2-236b (d_model
   5120, 128 MLA heads with a 512 + 64 latent cache, 160 experts top-6
   of d_ff 1536 plus 2 shared, block 0 dense) on the long trace layered
   and chunked and on the short trace layered under the dense and the
   ragged dispatch (the same expert bytes and streams); then
   qwen3-moe-235b-a22b (d_model 4096, 64/4 heads: g 16, 128 experts
   top-8 of d_ff 1536) on the long trace layered and chunked.
6. free gpt-oss and serve the dense decoders at full width, which launch
   K2 and K3 and no MoE kernel: phi4-mini-3.8b (16 of 32 layers, 24/8 heads:
   g 3) on the short trace layered and chunked and the n-gram serves of
   phase 4; then yi-34b (60 layers, 56/8 heads:
   g 7, 68.8 GB of bf16 weights, drawn on the card) on the short trace,
   layered, at the depth the card's free memory holds (the reckoning and
   any cut are logged).
7. free them and serve the recurrent models at full width and depth:
   recurrentgemma-9b (26 RG-LRU + 12 local attention blocks; K2 and K3
   at (256, 256) and nothing else) on the long trace at max_len 4096 (4
   prompts of 2100-3500 tokens, past the 2048-token window) layered and
   chunked; 12 short-trace requests with 48 new tokens on 8 slots in 64
   pages under recompute preemption (every slot reused), and the first
   8 under swap preemption; each of the 12 requests served alone; every
   stream of the reuse and the swap serve must equal the request's
   stream alone or part at a near-tie (``NEAR_TIE_ULPS``, the gap from
   one bf16 prefill as ``--explain-divergence`` computes it: a stale
   state would part at the first token).  Then xlstm-1.3b (16 of 48
   blocks: 14 mLSTM + 2 sLSTM) on the short trace,
   layered and chunked, launching none of the six kernels.  Each serve
   logs the recurrent state bytes a slot.
8. free them and serve whisper-base at full width and depth (6 encoder
   + 6 decoder layers, each request's 1500 frames seeded): 12 short-trace
   requests with 48 new tokens on 8 slots in 64 pages under recompute
   and under swap preemption, each request alone, and two pools (layered,
   streaming) beside the monolithic engine on the launcher's closed loop;
   every stream equal to its yardstick's or parted at a near-tie; one
   cross-K/V install per admission; K2 and K3 only.  Then qwen2-vl-72b
   at full width and the depth the card holds (the reckoning logged;
   145 GB at 80 layers), text-only, the long trace layered and chunked.
9. free them and train as ``python -m repro_torch.launch.train``
   does (8 x 256 tokens of ``PackedDataset``, WSD, remat): minicpm-2b at
   full width, 12 of 40 layers (K2 and its backward) 20
   steps, then qwen3-30b-a3b at full width and the depth the card holds
   at 12 B a parameter (the reckoning logged; K2 at g 8, K4 and their
   backwards) 10 steps; whisper-base at full depth (K2 causal and
   non-causal over its 1500 frames) 20 steps; recurrentgemma-9b at full
   width and the depth the card holds, a multiple of its 3-block pattern
   (K2 at (256, 256), window 2048) 10 steps; deepseek-v2-236b at full
   width, its dense block 0 and the MoE blocks the card holds (K2 at (192,
   128), K4 and their backwards) 10 steps: every loss finite, ce falling,
   the matrices the loss reaches moved, the training path's kernels
   only, one host sync per logged
   step, and step 1's loss, ce and grad norm within ``TRAIN_LOSS_REL`` /
   ``TRAIN_GNORM_REL`` of the same step in fp32 through the plain
   versions on the card (the yardstick; the trainer's path never calls a
   plain version); minicpm's state saved and restored, the next
   step bit for bit the step without the round trip.  Seconds a step,
   peak memory and the checkpoint's seconds are printed.  One more step
   of minicpm-2b and of qwen3-30b-a3b runs under torch.profiler: device
   time by kernel, the two backward kernels' share, the optimizer's share
   and the device's idle share of the step.
10. the multi-device code on this card: qwen3-30b-a3b at full width, 2
   of 48 layers (4 until phase 10c joined, 8 until phase 10b joined),
   seed-0 bf16 weights made once on the card and handed to
   16 ranks by CUDA IPC, sharded over the (2, 8) ``(data, model)`` mesh
   (gloo; every kernel built before any rank starts): a prefill step (2 x
   512 tokens, dense and ragged: the a2a MoE and the "gqa" attention
   region over a sequence-split cache), 8 decode steps (the split softmax
   with K3's log-sum-exp, the gathered MoE) and one layered step (its row
   of 256 tokens: the split softmax with K2's log-sum-exp, the psum MoE),
   dropless as the serving engine is.  Per step: K1-K4 launches summed
   over ranks (each rank launches every kernel of the path), collectives
   by kind and bytes, and the wall time (the harness, not a cluster).
   Held against the unsharded port on the same card and weights, every
   rank's routes pinned to the unsharded run's (``serve_sharded``): each
   step's logits within ``E2E_REL_FRO``, expert counts equal, greedy
   tokens equal but at logit near-ties, and each block's update,
   teacher-forced, within ``BLOCK_TOL``.  Phase 2 adds K3 with its
   log-sum-exp (``check_decode_lse``).
   10b. in the same 16 ranks, after the serve steps: one sharded
   training step of qwen3-30b-a3b at full width (``sharded_train_depth``:
   the depth the card holds beside the pool, reckoned from the specs and
   the card's free memory, and logged; seed-1 weights, capacity raised so
   that nothing drops), the launcher's 8 x 256 tokens and WSD step 1,
   remat: attention's "gqa" region and the a2a dense MoE, K2, K4 and both
   backward kernels on every rank, ZeRO-1 AdamW.  Held against the
   unsharded port's step on the same card and weights, routes pinned
   block by block: loss, ce, aux loss and grad norm within
   ``TRAIN_LOSS_REL`` / ``TRAIN_GNORM_REL``, each leaf's gradient and
   moments and the new parameters within ``TRAIN_SHARD_*`` (their reasons
   beside them), no other kernel of the six launched; launches,
   collectives forward and backward, wall time and peak memory a rank
   printed.  Phase 2 adds K2, K4 and both backwards at the ranks' shapes
   (``sharded_train_shapes``).
   10c. in the same pool of 16 ranks (the ranks take each model's job
   from a queue; a second pool cost 30 s to start): deepseek-v2-236b at
   full width, 2 of 60 layers (its dense block 0 and one MoE block with
   160 routed and 2 shared experts), the same serve steps and checks as
   phase 10: multi-head latent attention with the latent split over the
   sequence (gathered over ``model`` for the prefill and the layered row:
   K2 at g 1 over each rank's 16 heads at (192, 128); the split softmax
   at decode: K3 with its log-sum-exp over each rank's 128 positions for
   all 128 heads), the shared experts column/row-parallel; then one
   sharded training step of its block 0 (the depth the card holds beside
   the pool, reckoned and logged as in 10b: K2 and its backward on every
   rank).  Phase 2 adds K3 with its log-sum-exp, K2, K1, K4 and K2's
   backward at these ranks' shapes.
   10d. in the same pool after deepseek, each model's seed-0 bf16 weights
   handed to the ranks by CUDA IPC and dropped after use, with the same
   steps and checks (no experts: no routes to pin): recurrentgemma-9b at
   full width, 3 of 38 layers (two RG-LRU blocks, one local-attention
   block), a 4096-row cache (512 positions a rank), prefill 2 x 2816
   (K2 under the 2048-key window over the gathered cache), 8 decodes at
   positions 2816-2823 (the split softmax under the window, K3 with its
   log-sum-exp: slice 0 lies before the window, slice 1 is cut by it) and
   the layered row (K2 with its log-sum-exp over the slices);
   xlstm-1.3b, 8 of 48 layers (seven mLSTM blocks, one sLSTM), prefill 2
   x 512 (chunkwise), decodes and the layered row (no kernel);
   whisper-base whole (6 + 6): each row's 1500 seeded frames through the
   encoder at the prefill (K2 non-causal on each rank's head), decodes
   over the cross cache (one kv head a rank), the layered row, and its
   encoder output against the unsharded one; then one sharded training
   step of whisper-base at full depth, held as in 10b (K2 and its
   backward on every rank).  Phase 2 adds K2, K3 with its log-sum-exp
   and K2's backward at these ranks' shapes.
11. beside phases 9 and 10, on the host: ``python -m
   repro_torch.launch.dryrun`` for qwen3-moe-235b-a22b at prefill_32k
   (16x16) and decode_32k (2x16x16), for qwen3-30b-a3b at train_4k
   (16x16), recurrentgemma-9b at long_500k (16x16) and whisper-base at
   prefill_32k (2x16x16); each JSON line printed.
   Each phase's seconds are printed.

It prints a JSON ``kernels`` line (each row's ``launches`` summed over
the serves, or the training run, of its own model, ``launches_of``),
the ``nvidia-smi`` line,
and, as its last line, ``{"ok": true, "device": {...}}``.
``--explain-divergence`` adds to phase 4 the analysis of the long
trace's bf16 streams: where a request's layered and chunked streams
part, that position's logits are recomputed by one bf16 prefill (and
once more padded to 2048 tokens) and the gaps printed in bf16 ulps.
``--skip-serve`` stops after phase 3 (a quick compile-and-check call): it
prints the ``kernels`` line without launch counts and exits 1 with no
result.  Without CUDA, or run from a directory without the rest of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import hashlib
import json
import math
import os
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


QWEN3_MOE = (128, 8, 2048, 768)        # E, top-k, d, F
GPT_OSS_MOE = (32, 4, 2880, 2880)
DEEPSEEK_MOE = (160, 6, 5120, 1536)
QWEN3_235B_MOE = (128, 8, 4096, 1536)


def expert_weights(shape, gen):
    """A stack of expert weights for a kernel check, bf16 on the card:
    normal x 1/sqrt(shape[0]) from the check's sequential generator (the
    model's init draws by leaf path; the checks keep their own stream)."""
    import torch
    w = torch.randn(shape, dtype=torch.bfloat16, device="cuda", generator=gen)
    return w.mul_(1.0 / math.sqrt(shape[0]))


def check_moe_gmm(tag: str, n_tokens: int, gen, widths=QWEN3_MOE) -> dict:
    """K1 at the ragged layout the model builds for ``n_tokens`` routed
    tokens at qwen3-30b-a3b widths (E 128, top-8, d 2048, F 768),
    gpt-oss-20b's (E 32, top-4, d = F = 2880), deepseek-v2-236b's (E 160,
    top-6, d 5120, F 1536) or qwen3-moe-235b-a22b's (E 128, top-8, d 4096,
    F 1536)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe
    e, k, d, f = widths
    dev = torch.device("cuda")
    w_gate = expert_weights((e, d, f), gen)
    w_up = expert_weights((e, d, f), gen)
    w_down = expert_weights((e, f, d), gen)
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
            "shape": {"rows": n_rows, "m_blk": m_blk, "active_experts": n_active,
                      "E": e, "top_k": k, "d": d, "F": f}}


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


QWEN3_ATTN = (32, 4, 128)              # H, Hkv, hd (and hd_v = hd)
GPT_OSS_ATTN = (64, 8, 64)
PHI4_MINI_ATTN = (24, 8, 128)          # g 3
YI_34B_ATTN = (56, 8, 128)             # g 7
QWEN3_235B_ATTN = (64, 4, 128)         # g 16
RECURRENTGEMMA_ATTN = (16, 1, 256)     # g 16 at hd 256 (local, window 2048)
# deepseek-v2-236b's decompressed MLA keys and values: H = Hkv = 128, hd
# 192 (128 nope + 64 rope), hd_v 128
DEEPSEEK_ATTN = (128, 128, 192, 128)
WHISPER_ATTN = (8, 8, 64)              # g 1: encoder, decoder and cross
QWEN2_VL_ATTN = (64, 8, 128)           # g 8
WHISPER_FRAMES = 1500                  # 30 s of audio


def _heads(heads):
    """(H, Hkv, hd, hd_v) of an attention shape (hd_v = hd unless given)."""
    return tuple(heads) if len(heads) == 4 else tuple(heads) + (heads[2],)


def sdpa_backends(q, k, v, mask) -> list:
    """The SDPA backends that take these inputs (each tried alone), in
    torch's order: which one the dispatcher picked for ``library_ms``."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ok = []
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _sdpa_gmajor(q, k, v, mask)
            torch.cuda.synchronize()
            ok.append(name)
        except RuntimeError:
            pass
    return ok


def _visible(o: int, i: int, s_max: int, window) -> int:
    """Keys the query at position o + i sees: causal, below S_max and,
    with a window, within it."""
    lo = max(0, o + i - window + 1) if window else 0
    return max(min(o + i + 1, s_max) - lo, 0)


def check_prefill_attention(tag: str, gen, b=4, p=2048, s_max=2048,
                            offsets=None, heads=QWEN3_ATTN,
                            cold: bool = False, window=None,
                            causal: bool = True) -> dict:
    """K2 against its plain version, timed beside SDPA at the same mask
    (with ``window``, the sliding window's too; with ``causal=False``
    every one of the S_max keys, SDPA without a mask and is_causal
    False); ``heads`` is (H,
    Hkv, hd) or, for MLA, (H, Hkv, hd, hd_v).  With ``cold`` (a
    verify window: tens of microseconds, less than its launch from
    Python) kernel, plain version and SDPA are timed as K3 is, in CUDA
    graphs over cache copies larger than L2; ``ms_eager`` keeps the time
    of launches from Python."""
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd, hd_v = _heads(heads)
    dev = torch.device("cuda")
    q = torch.randn((b, p, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    kc = torch.randn((b, s_max, hkv, hd), device=dev, generator=gen).to(torch.bfloat16)
    vc = torch.randn((b, s_max, hkv, hd_v), device=dev, generator=gen).to(torch.bfloat16)
    off = torch.tensor(offsets or [0] * b, dtype=torch.int32, device=dev)
    kw = dict(window=window, causal=causal)
    got = ops.prefill_attention(q, kc, vc, off, **kw)
    want = ref.prefill_attention_ref(q, kc, vc, off, **kw)
    again = ops.prefill_attention(q, kc, vc, off, **kw)
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **ATTN_TOL)
    log(f"prefill_attention[{tag}] B {b} P {p} S_max {s_max} offsets "
        f"{off.tolist()}{f' window {window}' if window else ''}"
        f"{'' if causal else ' non-causal'}: "
        f"max abs {max_abs:.3e} (tol {ATTN_TOL})")
    if not ok:
        raise AssertionError(f"prefill_attention[{tag}] disagrees")
    if not torch.equal(got, again):
        raise AssertionError(f"prefill_attention[{tag}]: two launches differ")
    del want, again

    # visible (query, key) pairs and the K/V rows that must be read
    offl = [int(o) for o in off.tolist()]
    if causal:
        pairs = sum(_visible(o, i, s_max, window) for o in offl
                    for i in range(p))
        kv_rows = sum(min(o + p, s_max)
                      - (max(0, o - window + 1) if window else 0)
                      for o in offl)
    else:
        pairs, kv_rows = b * p * s_max, b * s_max
    nbytes = (q.numel() * 2 + got.numel() * 2
              + kv_rows * hkv * (hd + hd_v) * 2 + b * 4)
    flops = 2 * (hd + hd_v) * h * pairs
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = ms_eager = cuda_time(
        lambda: ops.prefill_attention(q, kc, vc, off, **kw), iters=5)
    g = h // hkv
    qt = q.transpose(1, 2)
    pos = torch.arange(s_max, device=dev)
    qpos = off.long()[:, None] + torch.arange(p, device=dev)[None]
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (pos[None, None, :] < (off.long() + p)[:, None, None]))
    if window:
        mask &= pos[None, None, :] > qpos[:, :, None] - window
    mask = mask[:, None] if causal else None
    extra = {}
    if cold:
        n = max(2, int(-(-4 * L2_BYTES // (2 * kc.numel() * 2))))
        kv = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n - 1)]
        rep = [tuple(t.transpose(1, 2).repeat(1, g, 1, 1) for t in c)
               for c in kv]
        ms = cuda_time_cold(
            lambda i: ops.prefill_attention(q, *kv[i], off, window=window),
            n, rounds=8)
        plain = cuda_time_cold(
            lambda i: ref.prefill_attention_ref(q, *kv[i], off,
                                                window=window), n, rounds=2)
        lib = cuda_time_cold(lambda i: _sdpa_gmajor(qt, *rep[i], mask), n,
                             rounds=8)
        extra = {"ms_eager": ms_eager,
                 "timing": f"CUDA graph replay, cold: {n} cache copies "
                           "rotated; ms_eager: launched from Python"}
        del kv, rep
    else:
        plain = cuda_time(lambda: ref.prefill_attention_ref(
            q, kc, vc, off, **kw), iters=2)
        kt = kc.transpose(1, 2).repeat(1, g, 1, 1)
        vt = vc.transpose(1, 2).repeat(1, g, 1, 1)
        lib = cuda_time(lambda: _sdpa_gmajor(qt, kt, vt, mask), iters=5)
        if hd_v != hd or hd > 128:
            extra = {"sdpa_backends": sdpa_backends(qt, kt, vt, mask)}
            log(f"prefill_attention[{tag}]: SDPA at hd {hd} / hd_v {hd_v}: "
                f"{lib:.4f} ms; backends that take it "
                f"{extra['sdpa_backends']} (the first is torch's pick)")
        del kt, vt
    ctas = -(-p // (ops.PREFILL_ROWS // g)) * hkv * b
    return {"name": f"prefill_attention[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prefill_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:78",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "ctas": ctas, "achieved_tflops": flops / ms / 1e9, **extra,
            "shape": {"B": b, "P": p, "S_max": s_max, "offsets": offl,
                      "H": h, "Hkv": hkv, "hd": hd, "hd_v": hd_v,
                      "window": window, "causal": causal}}


# K2 at g 8 on inputs built by integer hashing (exact in bf16, the same on
# every torch version): the sha256 of the outputs of these calls.  The
# digest was taken from the kernel before it took every group size (the
# tree of the parent commit, built and run on an H100 by this function);
# at a group size that divides 128 the repaired kernel must give the same
# bits.  (B, P, S_max, H, Hkv, hd, offsets, window)
K2_G8_CASES = ((2, 300, 512, 32, 4, 128, (0, 137), None),
               (3, 40, 300, 64, 8, 64, (0, 50, 260), 70),
               (8, 5, 2048, 32, 4, 128, (700, 900, 1100, 1300, 1500, 1700,
                                         1900, 2000), None))
K2_G8_SHA256 = "93ea6e2424650d26"


def hashed_bf16(shape, salt: int, device):
    """Values k / 64, k in [-128, 128), from a multiplicative hash of the
    element index: exactly representable in bf16, no random generator."""
    import torch
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    h = (i * 2654435761 + salt * 97531) % 4294967296
    h = ((h >> 11) ^ h) % 256
    return ((h - 128).float() / 64).reshape(shape).to(torch.bfloat16)


def k2_g8_digest() -> str:
    """sha256 (first 16 hex digits) of K2's outputs on K2_G8_CASES."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    h = hashlib.sha256()
    for n, (b, p, s_max, nh, hkv, hd, offs, window) in enumerate(K2_G8_CASES):
        q = hashed_bf16((b, p, nh, hd), 3 * n, dev)
        k = hashed_bf16((b, s_max, hkv, hd), 3 * n + 1, dev)
        v = hashed_bf16((b, s_max, hkv, hd), 3 * n + 2, dev)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        out = ops.prefill_attention(q, k, v, off, window=window)
        h.update(out.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
                           len_range=(601, 1517), heads=QWEN3_ATTN,
                           window=None, full: bool = False) -> dict:
    """K3 at the serve's decode step (8 slots, one of them idle with the
    stale length S_max + 1; with ``full`` every slot at length S_max, as
    cross-attention decode reads all the encoder's frames), timed cold in
    CUDA graphs: kernel, plain
    version and SDPA each rotate over copies of the cache that together
    exceed 4 x the 50 MB L2.  ``ms_hot`` repeats one copy and
    ``ms_eager`` launches from Python: how K3 was timed before it became
    faster than its own launch.  ``heads`` and ``window`` as for
    ``check_prefill_attention``."""
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd, hd_v = _heads(heads)
    dev = torch.device("cuda")
    q = torch.randn((b, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    cache_bytes = b * s_max * hkv * (hd + hd_v) * 2
    n_copies = max(2, int(-(-4 * L2_BYTES // cache_bytes)))
    caches = [tuple(torch.randn((b, s_max, hkv, w), device=dev, generator=gen)
                    .to(torch.bfloat16) for w in (hd, hd_v))
              for _ in range(n_copies)]
    kc, vc = caches[0]
    lens = torch.randint(*len_range, (b,), device=dev, generator=gen,
                         dtype=torch.int32)
    lens[-1] = s_max + 1
    if full:
        lens.fill_(s_max)
    got = ops.decode_attention(q, kc, vc, lens, window=window)
    want = ref.decode_attention_ref(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    max_abs = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **ATTN_TOL)
    split = ops.decode_split(b, hkv, s_max)
    log(f"decode_attention[{tag}] B{b} S_max {s_max} lengths {lens.tolist()}: "
        f"max abs {max_abs:.3e} (tol {ATTN_TOL}); split {split}, "
        f"{split * hkv * b} CTAs")
    if not ok:
        raise AssertionError(f"decode_attention[{tag}] disagrees")
    again = ops.decode_attention(q, kc, vc, lens, window=window)
    if not torch.equal(got, again):
        raise AssertionError(f"decode_attention[{tag}]: two launches differ")
    used = [min(int(n), s_max) - (max(0, int(n) - window) if window else 0)
            for n in lens.tolist()]
    nbytes = (q.numel() * 2 + got.numel() * 2
              + sum(used) * hkv * (hd + hd_v) * 2 + b * 4)
    flops = 2 * (hd + hd_v) * h * sum(used)
    b_ms, b_by = bound_ms(nbytes, flops)
    ms = cuda_time_cold(
        lambda i: ops.decode_attention(q, *caches[i], lens, window=window),
        n_copies, rounds=8)
    ms_eager = cuda_time_cold(
        lambda i: ops.decode_attention(q, *caches[i], lens, window=window),
        n_copies, rounds=8, graph=False)
    ms_hot = cuda_time_cold(
        lambda i: ops.decode_attention(q, kc, vc, lens, window=window), 1,
        rounds=48)
    plain = cuda_time_cold(
        lambda i: ref.decode_attention_ref(q, *caches[i], lens,
                                           window=window), n_copies,
        rounds=2)
    g = h // hkv
    rep = [tuple(c.transpose(1, 2).repeat(1, g, 1, 1) for c in kv)
           for kv in caches]
    pos = torch.arange(s_max, device=dev)[None, :]
    mask = pos < lens.clamp(max=s_max).long()[:, None]
    if window:
        mask &= pos >= lens.long()[:, None] - window
    mask = mask[:, None, None, :]
    lib = cuda_time_cold(lambda i: _sdpa_gmajor(q[:, :, None], *rep[i], mask),
                         n_copies, rounds=8)
    extra = {}
    if hd_v != hd or hd > 128:
        extra["sdpa_backends"] = sdpa_backends(q[:, :, None], *rep[0], mask)
        log(f"decode_attention[{tag}]: SDPA at hd {hd} / hd_v {hd_v}: "
            f"{lib:.4f} ms cold; backends that take it "
            f"{extra['sdpa_backends']} (the first is torch's pick)")
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
                      "copy; ms_eager: cold, launched from Python", **extra,
            "shape": {"B": b, "S_max": s_max, "lengths": lens.tolist(),
                      "H": h, "Hkv": hkv, "hd": hd, "hd_v": hd_v,
                      "window": window}}


def check_moe_gmm_dense(tag: str, c: int, gen, widths=QWEN3_MOE) -> dict:
    """K4 over the dense (E, C, d) buffer at qwen3-30b-a3b widths,
    gpt-oss-20b's or deepseek-v2-236b's: C = 8 is the engine's full-pool decode step (dropless,
    C = n_slots), C = 1024 the short trace's packed prefill (4 prompts of
    201-242 tokens in the 256-token bucket)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    e, _, d, f = widths
    dev = torch.device("cuda")
    w_gate = expert_weights((e, d, f), gen)
    w_up = expert_weights((e, d, f), gen)
    w_down = expert_weights((e, f, d), gen)
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
    log(f"moe_gmm[{tag}] E {e} C {c} d {d} F {f}: rel Frobenius {rel:.3e} (tol "
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
    """K5, and K6 at W 4 and W 5 (the JAX engine's default spec_k 4 plus
    the bonus token), at qwen3-30b-a3b widths (H 32, Hkv 4, hd 128) over
    the engine's default 16-token pages, 8 sequences of 723-2049 tokens.
    Timed as K3: ``ms`` cold in CUDA graphs over copies of the page pool
    that together exceed 4 x the 50 MB L2, ``ms_eager`` the same calls
    launched from Python, ``ms_hot_eager`` one pool launched from Python
    (``cuda_time``, how these two kernels were first timed).  Beside
    them: K3 on the same keys in slot rows and a gather chain (the pages
    gathered by index into slot rows, then SDPA over KV repeated g-major),
    both cold in graphs."""
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd, page = 32, 4, 128, 16
    g = h // hkv
    dev = torch.device("cuda")
    lens = torch.randint(723, 2050, (8,), generator=torch.Generator().manual_seed(5))
    lens[0], lens[-1] = 723, 2049
    lens_l = [int(n) for n in lens.tolist()]
    k_slot, v_slot, kp, vp, bt = _paged_pool(lens_l, page, hkv, hd, gen)
    lengths = lens.to(dev, torch.int32)
    b, max_pages = bt.shape
    s_max = max_pages * page

    def copies(kv):
        n = max(2, int(-(-4 * L2_BYTES // (2 * kv[0].numel() * 2))))
        return [kv] + [tuple(t.clone() for t in kv) for _ in range(n - 1)]
    pools, slots = copies((kp, vp)), copies((k_slot, v_slot))
    pool_mb = 2 * kp.numel() * 2 / 1e6
    bt_flat = bt.long().reshape(-1)
    pos = torch.arange(s_max, device=dev)

    def chain(i, qw):
        # the pages gathered into slot rows, then one SDPA over KV repeated
        # g-major; window row j of a sequence of length n sees n - W + 1 + j keys
        w = qw.shape[1]
        kv = [t.index_select(0, bt_flat).reshape(b, s_max, hkv, hd)
              .transpose(1, 2).repeat(1, g, 1, 1) for t in pools[i]]
        horizon = (lengths.long()[:, None] - w + 1
                   + torch.arange(w, device=dev)[None])
        mask = (pos[None, None, :] < horizon[:, :, None])[:, None]
        return _sdpa_gmajor(qw.transpose(1, 2), *kv, mask)

    # K/V bytes of the keys read, the block-table entries read, q in and out
    kv_bytes = sum(lens_l) * 2 * hkv * hd * 2
    table_bytes = sum(-(-n // page) for n in lens_l) * 4 + b * 4
    timing = (f"ms: CUDA graph replay, cold: {len(pools)} pool copies of "
              f"{pool_mb:.1f} MB rotated; ms_eager: the same calls launched "
              "from Python; ms_hot_eager: one pool, launched from Python "
              "(cuda_time)")
    no_lib = "no PyTorch call reads K/V through a block table"
    out = []
    for w in (1, 4, 5):
        qw = torch.randn((b, w, h, hd), device=dev, generator=gen).to(torch.bfloat16)
        if w == 1:
            name = "paged_decode_attention"
            q = qw[:, 0].contiguous()

            def kern(i, q=q):
                return ops.paged_decode_attention(q, *pools[i], bt, lengths)

            def plain(i, q=q):
                return ref.paged_decode_attention_ref(q, *pools[i], bt, lengths)
        else:
            name = f"paged_verify_attention[W{w}]"

            def kern(i, qw=qw):
                return ops.paged_verify_attention(qw, *pools[i], bt, lengths)

            def plain(i, qw=qw):
                return ref.paged_verify_attention_ref(qw, *pools[i], bt,
                                                      lengths)
        got, again, want = kern(0), kern(0), plain(0)
        torch.cuda.synchronize()
        max_abs = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), **ATTN_TOL):
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"max abs {max_abs}")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        row_blocks = ops.paged_row_blocks(w, g)
        split = ops.paged_split(b, hkv, row_blocks, max_pages, page)
        extra = {}
        if w == 1:
            # K3 on the same keys as slot rows, and verify at W 1 is K5
            slot = ops.decode_attention(q, k_slot, v_slot, lengths)
            one = ops.paged_verify_attention(qw, kp, vp, bt, lengths)[:, 0]
            torch.cuda.synchronize()
            vs_k3 = (got.float() - slot.float()).abs().max().item()
            if not torch.allclose(got.float(), slot.float(), **ATTN_TOL):
                raise AssertionError(f"{name} disagrees with decode_attention "
                                     f"on slot rows: max abs {vs_k3}")
            if not torch.equal(one, got):
                raise AssertionError("paged_verify_attention at W 1 differs "
                                     "from paged_decode_attention")
            extra = {"max_abs_vs_decode_attention": vs_k3,
                     "equal_to_decode_attention": torch.equal(got, slot),
                     "k3_same_keys_ms": cuda_time_cold(
                         lambda i: ops.decode_attention(q, *slots[i], lengths),
                         len(slots), rounds=8)}
        log(f"{name} B{b} pages of {page}, lengths {lens_l}: max abs "
            f"{max_abs:.3e} vs plain (tol {ATTN_TOL}); split {split}, "
            f"{row_blocks} row blocks, {split * hkv * row_blocks * b} CTAs"
            + (f"; vs decode_attention on slot rows max abs "
               f"{extra['max_abs_vs_decode_attention']:.3e}, bit-equal "
               f"{extra['equal_to_decode_attention']}; W 1 verify == K5"
               if w == 1 else ""))
        # window row j of a sequence of length n sees n - w + 1 + j keys
        pairs = sum(n - w + 1 + j for n in lens_l for j in range(w))
        b_ms, b_by = bound_ms(2 * qw.numel() * 2 + kv_bytes + table_bytes,
                              4 * hd * h * pairs)
        ms = cuda_time_cold(kern, len(pools), rounds=8)
        ms_eager = cuda_time_cold(kern, len(pools), rounds=8, graph=False)
        ms_hot_eager = cuda_time(lambda: kern(0), iters=50)
        plain_ms = cuda_time_cold(plain, len(pools), rounds=2)
        chain_ms = cuda_time_cold(lambda i, qw=qw: chain(i, qw), len(pools),
                                  rounds=2)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": ("src/repro/kernels/decode_attention.py:277" if w == 1
                         else "src/repro/kernels/decode_attention.py:216"),
            "max_abs_err": max_abs, "ms": ms, "ms_eager": ms_eager,
            "ms_hot_eager": ms_hot_eager, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_note": no_lib, "gather_chain_ms": chain_ms,
            "gather_chain_note": "index_select of the pages into slot rows, "
                                 "repeat to H heads g-major, one SDPA: a "
                                 "yardstick of several calls, not library_ms",
            **extra, "split": split, "row_blocks": row_blocks,
            "ctas": split * hkv * row_blocks * b, "timing": timing,
            "shape": {"B": b, "W": w, "page_size": page,
                      "max_pages": max_pages, "lengths": lens_l}})
    del pools, slots
    return out


# ---------------------------------------------------------------- phase 3


def check_small_model_end_to_end() -> None:
    """The reduced qwen3 model in bf16 on the card (the kernels of the
    ragged and of the dense MoE path) vs the same weights in fp32 on the
    CPU (plain versions, ragged): a 48-token prefill into the cache, then
    one decode step."""
    import torch
    from repro_torch.launch.serve import ServeConfig, model_config
    from repro_torch.models.model import DecoderModel
    cfg = model_config(ServeConfig(smoke=True, dtype="bfloat16"))
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
    # the same prefill in three 16-token chunks through the cache (the
    # chunked scheduler's path: K2 at non-zero offsets): as close to the
    # fp32 one-shot logits as the one-shot bf16 path is
    cache = gpu.init_cache(2, 128)
    for c0 in range(0, 48, 16):
        lc, cache, _ = gpu.forward(params, toks[:, c0:c0 + 16].cuda(),
                                   offset=(off + c0).cuda(), cache=cache,
                                   dropless=True)
    lc = lc.float().cpu()
    one = run(gpu, params, "cuda", "ragged")[0][:, 32:]
    ref_ = want[0][:, 32:]
    rel_chunk = ((lc - ref_).norm() / ref_.norm()).item()
    rel_one = ((one - ref_).norm() / ref_.norm()).item()
    log(f"small model prefill in 16-token chunks through the cache, bf16 "
        f"kernels vs fp32 CPU one-shot (last chunk's logits): rel Frobenius "
        f"{rel_chunk:.3e} (one-shot bf16: {rel_one:.3e}; tol {E2E_REL_FRO})")
    if not rel_chunk <= E2E_REL_FRO:
        raise AssertionError(f"chunked prefill disagrees: rel {rel_chunk}")
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


def small_mla_config():
    """A small MLA + MoE model at MLA's full head widths, so that its
    attention runs K2 and K3 at the (192, 128) pair deepseek-v2-236b
    gives them: deepseek-v2-236b's smoke variant (2 layers, d_model 512,
    block 0 dense, block 1 MoE with one shared expert) with MLA's nope
    128, rope 64, v 128, kv_lora 512 (q_lora 64), 4 heads, 8 experts
    top-2, in bf16."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import MLAConfig
    cfg = get_smoke_config("deepseek-v2-236b")
    return dataclasses.replace(
        cfg, name="deepseek-mla-small", n_heads=4, n_kv_heads=4,
        head_dim=128,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=64, qk_rope_dim=64,
                      qk_nope_dim=128, v_head_dim=128),
        moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2),
        dtype="bfloat16", param_dtype="bfloat16").validate()


# an fp32 router margin (k-th minus (k+1)-th expert probability) below
# which a token's expert set may flip under bf16: the bf16 model's hidden
# states carry ~1e-2 relative error into router probabilities of ~1/8
ROUTER_TIE = 2e-3


def check_small_mla_end_to_end() -> None:
    """``small_mla_config`` in bf16 on the card (K2 and K3 at (192, 128),
    K1 or K4) vs the same weights in fp32 on the CPU (plain versions): a
    48-token prefill into the latent cache at per-row offsets, then one
    decode step, under the ragged and the dense dispatch.  Every token's
    expert set is recorded on both sides: the logits of tokens routed
    alike must agree within ``E2E_REL_FRO``; a token whose set differs
    (its MoE output then differs wholly: the expert weights' fan-in is E)
    must sit at a router near-tie (fp32 margin below ``ROUTER_TIE``), and
    at most one token in 16 (or one) may."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import DecoderModel
    cfg = small_mla_config()
    gpu = DecoderModel(cfg, device="cuda")
    params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))
    cpu = DecoderModel(dataclasses.replace(cfg, dtype="float32",
                                           param_dtype="float32"), device="cpu")
    p_cpu = ops.tree_map(lambda a: a.float().cpu(), params)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(1, cfg.vocab_size, (2, 49), generator=g)
    off = torch.tensor([0, 5], dtype=torch.int32)
    route, routes = moe.route, []

    def recorded(*args):
        out = route(*args)
        routes.append(out)
        return out

    def run(model, p_, dev, moe_dispatch):
        """(prefill logits, decode logits) and each one's routes: one
        (expert ids (T, k), probabilities (T, E)) per MoE block."""
        cache = model.init_cache(2, 128)
        kw = dict(cache=cache, dropless=True, moe_dispatch=moe_dispatch)
        out = []
        moe.route = recorded
        try:
            for sl, o in ((slice(0, 48), off), (slice(48, 49), off + 48)):
                routes.clear()
                lg, cache, _ = model.forward(p_, toks[:, sl].to(dev),
                                             offset=o.to(dev), **kw)
                out.append((lg.float().cpu(),
                            [(i.cpu(), pr.float().cpu()) for i, _, pr in routes]))
        finally:
            moe.route = route
        return out
    want = run(cpu, p_cpu, "cpu", "ragged")
    k = cfg.moe.top_k
    for moe_dispatch in ("ragged", "dense"):
        ops.reset_launches()
        got = run(gpu, params, "cuda", moe_dispatch)
        need = ("prefill_attention", "decode_attention",
                MOE_KERNEL[moe_dispatch])
        check_launches(f"small MLA model ({moe_dispatch})",
                       dict(ops.LAUNCHES), need, need)
        for name, (a, ra), (b_, rb) in zip(("prefill", "decode"), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"MLA end-to-end {name}: non-finite "
                                     "logits")
            alike = torch.ones(a.shape[0] * a.shape[1], dtype=torch.bool)
            margin = torch.full_like(alike, float("inf"), dtype=torch.float32)
            for (ia, _), (ib, pb) in zip(ra, rb):
                alike &= (ia.sort(-1).values == ib.sort(-1).values).all(-1)
                top = pb.sort(-1, descending=True).values
                margin = torch.minimum(margin, top[:, k - 1] - top[:, k])
            a2, b2 = a.reshape(alike.numel(), -1), b_.reshape(alike.numel(), -1)
            rel = ((a2[alike] - b2[alike]).norm() / b2[alike].norm()).item()
            agree = (a2.argmax(-1) == b2.argmax(-1)).float().mean().item()
            flipped = (~alike).nonzero().flatten().tolist()
            log(f"small MLA model {name} logits, {moe_dispatch} dispatch, "
                f"bf16 kernels vs fp32 CPU: rel Frobenius {rel:.3e} over the "
                f"{int(alike.sum())} of {alike.numel()} tokens routed alike "
                f"(tol {E2E_REL_FRO}), argmax agreement {agree:.3f}; tokens "
                f"routed otherwise {flipped}, fp32 router margins "
                f"{[round(float(margin[i]), 6) for i in flipped]} (near-tie "
                f"below {ROUTER_TIE}; all tokens rel Frobenius "
                f"{((a - b_).norm() / b_.norm()).item():.3e})")
            if not rel <= E2E_REL_FRO:
                raise AssertionError(f"MLA end-to-end {name} "
                                     f"({moe_dispatch}) disagrees: rel {rel}")
            if (len(flipped) > max(1, alike.numel() // 16)
                    or any(margin[i] >= ROUTER_TIE for i in flipped)):
                raise AssertionError(f"MLA end-to-end {name} ({moe_dispatch}):"
                                     f" tokens {flipped} routed otherwise, "
                                     f"not at router near-ties")


def small_recurrent_configs():
    """The two small recurrent models of phase 3, in bf16: recurrentgemma-
    9b's smoke variant (one period: RG-LRU, RG-LRU, local attention) at
    its full head shape (16 query heads over one kv head of 256: K2 and
    K3 at (256, 256), g 16) with a 32-token window, shorter than the
    48-token prompt; and xlstm-1.3b's smoke variant (7 mLSTM + 1 sLSTM
    blocks, d_model 256)."""
    from repro_torch.configs import get_smoke_config
    rg = dataclasses.replace(
        get_smoke_config("recurrentgemma-9b"), name="recurrentgemma-small",
        n_heads=16, n_kv_heads=1, head_dim=256, local_window=32,
        dtype="bfloat16", param_dtype="bfloat16").validate()
    xl = dataclasses.replace(get_smoke_config("xlstm-1.3b"),
                             name="xlstm-small", dtype="bfloat16",
                             param_dtype="bfloat16").validate()
    return rg, xl


def check_small_recurrent_end_to_end() -> None:
    """Each small recurrent model in bf16 on the card vs the same weights
    in fp32 on the CPU (plain versions): a prefill into the cache at
    per-row offsets 0 and 5 — 48 tokens, and for xLSTM also 256 (mLSTM's
    chunkwise form) — then one decode step; and the 48 tokens in three
    16-token chunks through the cache (the chunked scheduler's path: the
    recurrent state carried across calls, K2 at non-zero offsets where
    the window binds).  Logits within ``E2E_REL_FRO``.  The RG-LRU model
    launches K2 and K3 and nothing else; the xLSTM model none of the six
    kernels."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import DecoderModel
    for cfg, need in zip(small_recurrent_configs(),
                         (("prefill_attention", "decode_attention"), ())):
        gpu = DecoderModel(cfg, device="cuda")
        params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))
        cpu = DecoderModel(dataclasses.replace(cfg, dtype="float32",
                                               param_dtype="float32"),
                           device="cpu")
        p_cpu = ops.tree_map(lambda a: a.float().cpu(), params)
        g = torch.Generator().manual_seed(4)
        off = torch.tensor([0, 5], dtype=torch.int32)
        for n in ((48, 256) if "xlstm" in cfg.name else (48,)):
            toks = torch.randint(1, cfg.vocab_size, (2, n + 1), generator=g)

            def run(model, p_, dev, chunks=(n,)):
                cache = model.init_cache(2, 512)
                out, c0 = [], 0
                for c in chunks + (1,):
                    lg, cache, _ = model.forward(
                        p_, toks[:, c0:c0 + c].to(dev),
                        offset=(off + c0).to(dev), cache=cache)
                    out.append(lg.float().cpu())
                    c0 += c
                return out
            want = run(cpu, p_cpu, "cpu")
            ops.reset_launches()
            got = run(gpu, params, "cuda")
            check_launches(f"small {cfg.name}", dict(ops.LAUNCHES), need,
                           need)
            cases = [("prefill", got[0], want[0]), ("decode", got[1], want[1])]
            if n == 48:
                chunked = run(gpu, params, "cuda", (16, 16, 16))
                cases += [("prefill, last of 3 chunks", chunked[2],
                           want[0][:, 32:]),
                          ("decode after chunks", chunked[3], want[1])]
            for name, a, b_ in cases:
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{cfg.name} {name}: non-finite "
                                         "logits")
                rel = ((a - b_).norm() / b_.norm()).item()
                agree = (a.argmax(-1) == b_.argmax(-1)).float().mean().item()
                log(f"small {cfg.name} {n}-token {name} logits, bf16 on the "
                    f"card vs fp32 CPU: rel Frobenius {rel:.3e} (tol "
                    f"{E2E_REL_FRO}), argmax agreement {agree:.3f}")
                if not rel <= E2E_REL_FRO:
                    raise AssertionError(f"{cfg.name} {name} ({n} tokens) "
                                         f"disagrees: rel {rel}")
        del gpu, params
        torch.cuda.empty_cache()


def small_encdec_configs():
    """The two small models of phase 3 for the last two architectures, in
    bf16: whisper-base's smoke variant (2 encoder + 2 decoder layers,
    d_model 256) at whisper's head shape (8/8 heads of 64) over 150
    frames, a count off K2's 128-row query tile and 128-key tile; and
    qwen2-vl-72b's smoke variant at its head width (8/1 heads of 128: g 8)
    with its M-RoPE sections (16, 24, 24)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import EncoderConfig
    wh = dataclasses.replace(
        get_smoke_config("whisper-base"), name="whisper-small", head_dim=64,
        encoder=EncoderConfig(n_layers=2, n_frames=150), dtype="bfloat16",
        param_dtype="bfloat16").validate()
    vl = dataclasses.replace(
        get_smoke_config("qwen2-vl-72b"), name="qwen2-vl-small",
        head_dim=128, mrope_sections=(16, 24, 24), dtype="bfloat16",
        param_dtype="bfloat16").validate()
    return wh, vl


def check_small_encdec_end_to_end() -> None:
    """Each small model of ``small_encdec_configs`` in bf16 on the card vs
    the same weights in fp32 on the CPU (plain versions), within
    ``E2E_REL_FRO``: whisper's ``encode`` (K2 non-causal over the frames),
    its cross K/V, a 48-token prefill through the cache at offsets 0 and 5
    (cross-attention by K2 non-causal over the cached frames), one decode
    step (K3 at lengths = n_frames), and the cache-free forward with the
    encoder output; qwen2-vl's 48-token prefill and decode step through
    the cache and its forward with 8 patch embeddings prepended.  Each
    launches K2 and K3 and nothing else."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import DecoderModel
    need = ("prefill_attention", "decode_attention")
    for cfg in small_encdec_configs():
        gpu = DecoderModel(cfg, device="cuda")
        params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))
        cpu = DecoderModel(dataclasses.replace(cfg, dtype="float32",
                                               param_dtype="float32"),
                           device="cpu")
        p_cpu = ops.tree_map(lambda a: a.float().cpu(), params)
        g = torch.Generator().manual_seed(5)
        toks = torch.randint(1, cfg.vocab_size, (2, 49), generator=g)
        off = torch.tensor([0, 5], dtype=torch.int32)
        frames = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                             generator=g) * 0.01
        extra = torch.randn((2, 8, cfg.d_model), generator=g) * 0.02

        def run(model, p_, dev):
            out = {}
            enc = None
            cache = model.init_cache(2, 128)
            if cfg.encoder.enabled:
                enc = model.encode(p_, frames.to(dev))
                out["encode"] = enc
                model.install_cross_kv(p_, cache, enc)
                out["cross K"] = cache[0][0]["xk"]
            out["prefill"], cache, _ = model.forward(
                p_, toks[:, :48].to(dev), offset=off.to(dev), cache=cache)
            out["decode"], cache, _ = model.forward(
                p_, toks[:, 48:].to(dev), offset=(off + 48).to(dev),
                cache=cache)
            if enc is not None:
                out["forward with enc_out"], _, _ = model.forward(
                    p_, toks[:, :48].to(dev), enc_out=enc)
            else:
                out["forward with 8 patches"], _, _ = model.forward(
                    p_, toks[:, :48].to(dev), extra_embeds=extra.to(dev))
            return {k: v.float().cpu() for k, v in out.items()}
        want = run(cpu, p_cpu, "cpu")
        ops.reset_launches()
        got = run(gpu, params, "cuda")
        check_launches(f"small {cfg.name}", dict(ops.LAUNCHES), need, need)
        for name, a in got.items():
            b_ = want[name]
            if not torch.isfinite(a).all() or a.shape != b_.shape:
                raise AssertionError(f"{cfg.name} {name}: non-finite or "
                                     f"misshapen {tuple(a.shape)}")
            rel = ((a - b_).norm() / b_.norm()).item()
            log(f"small {cfg.name} {name} {tuple(a.shape)}, bf16 on the card "
                f"vs fp32 CPU: rel Frobenius {rel:.3e} (tol {E2E_REL_FRO})")
            if not rel <= E2E_REL_FRO:
                raise AssertionError(f"{cfg.name} {name} disagrees: rel {rel}")
        del gpu, params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4


# the MoE kernel of each dispatch
MOE_KERNEL = {"ragged": "moe_gmm_ragged", "dense": "moe_gmm"}


def path_kernels(eng):
    """(kernels the serve must launch, kernels it may launch): K2, the
    MoE dispatch's kernel on an MoE model, K4 on an MoE draft model (the
    draft runs the capacity-limited dense dispatch, as JAX's does), and K3
    — which a speculating serve launches only for rows that fall back to
    plain decode.  No serve launches anything else (the paged kernels are
    on no serve path); a stack without attention blocks (xLSTM) launches
    none of the six."""
    attn = any(sp.is_attention() for sp in eng.model.specs)
    need = ["prefill_attention"] if attn else []
    if eng.cfg.moe.enabled:
        need.append(MOE_KERNEL[eng.moe_dispatch])
    if eng.draft_model is not None and eng.draft_model.cfg.moe.enabled:
        need.append(MOE_KERNEL["dense"])
    may = ["decode_attention"] if attn else []
    if eng.spec_mode == "off":
        need, may = need + may, []
    return tuple(need), tuple(need) + tuple(may)


def draft_engine(a, model, params, draft, spec_k=4):
    """``a``'s engine with ``draft`` = (model, params) drafting for it
    (the launcher's ``--spec draft`` builds the smoke variant of the
    config ``--draft-config`` names; these drafts are full width)."""
    from repro_torch.core import make_scheduler
    from repro_torch.serving.engine import Engine
    sched = make_scheduler(a.scheduler, model.n_blocks,
                           **a.scheduler_kwargs())
    return Engine(model, params, sched, **dict(
        a.engine_kwargs(), spec_mode="draft", spec_k=spec_k,
        draft_model=draft[0], draft_params=draft[1]))


def traced(fn):
    """``fn()`` with the kernel launch counts set to 0 just before it (the
    comparison launches of phase 2 do not count) and read just after, and
    the host syncs it makes counted by site (torch reports each
    synchronizing call as a warning in its sync debug mode): (result,
    launches, syncs by site)."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return r, dict(ops.LAUNCHES), sites


def streams_sha256(outputs: dict) -> str:
    """A digest of a serve's token streams, to compare trees."""
    return hashlib.sha256(json.dumps(outputs, sort_keys=True, default=int)
                          .encode()).hexdigest()[:16]


def run_serve(a, model, params, trace=None, draft=None, frames=None,
              jobs=None) -> dict:
    """One serve through the port's launcher (closed loop, or open loop
    over ``trace`` / ``a.engine_trace``; ``draft`` = (model, params)
    drafts for it, spec_k 4, on ``draft_engine``; an encoder-decoder's
    closed-loop request i carries ``frames(i)``; ``jobs``, (prompt,
    max_new, frames) triples, are submitted up front instead of the closed
    loop's draw and replayed on the iteration clock), with the launch counts
    set to 0 just before it and read just after, and its host syncs
    counted; raises unless every
    request completes with its ``max_new_tokens`` in-vocabulary tokens,
    every kernel of its path launched and no other kernel did, and the
    serve made at most one host sync per iteration (plus the two
    synchronize() calls that bound the timing).  A speculating serve must
    launch verify windows, each one K2 call per layer, and (n-gram) its
    drafter must propose."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, run_engine
    from repro_torch.launch.load_gen import plan_key
    eng = (build_engine(a, model, params) if draft is None
           else draft_engine(a, model, params, draft))
    spec = eng.spec_mode
    tag = f"{a.arch} {a.moe_dispatch}/{a.scheduler}" + (
        f" spec {spec}" if spec != "off" else "") + (
        "" if a.packed else " per-slice")
    plans, execute = [], eng.execute_plan

    def execute_plan(plan):
        plans.append(plan_key(plan))
        return execute(plan)
    eng.execute_plan = execute_plan
    run_a = a
    if jobs is not None:
        for prompt, max_new, frm in jobs:
            eng.submit(list(prompt), max_new, frm)
        run_a, trace = dataclasses.replace(a, open_loop=True,
                                           clock="virtual"), []
    r, counts, sites = traced(lambda: run_engine(eng, run_a, trace, frames))
    r["plans"] = plans
    r["n_dispatches"] = eng.n_dispatches
    r["n_prefill_dispatches"] = eng.n_prefill_dispatches
    r["n_pages"] = eng.alloc.n_pages
    r["streams_sha256"] = streams_sha256(r["outputs"])
    r["state_bytes_per_slot"] = eng.state_bytes_per_slot
    r["cache_bytes"] = sum(t.numel() * t.element_size()
                           for t in _leaves(eng.cache))
    r["host_syncs"] = sum(sites.values())
    r["host_sync_sites"] = dict(sites)
    r["launches"] = counts
    r["pad_copies"] = dict(ops.PAD_COPIES)
    r["arch"] = a.arch
    need, may = path_kernels(eng)
    if a.fault_plan is not None:
        tag += " chaos"
        eng.alloc.check_invariants()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    check_served(tag, a, r, model.cfg.vocab_size)
    check_launches(tag, counts, need, may)
    if any(r["pad_copies"].values()):
        raise AssertionError(f"{tag}: the MoE kernel padded its operands "
                             f"{r['pad_copies']}: the models' widths never "
                             "need it")
    if r["host_syncs"] > r["iterations"] + 2:
        raise AssertionError(f"{tag}: {r['host_syncs']} host syncs in "
                             f"{r['iterations']} iterations")
    if spec != "off":
        verify_k2 = r["n_verify_dispatches"] * model.n_blocks
        if not (r["n_verify_dispatches"] > 0
                and counts["prefill_attention"] >= verify_k2):
            raise AssertionError(f"{tag}: {r['n_verify_dispatches']} verify "
                                 f"windows, {counts['prefill_attention']} "
                                 "K2 launches")
        if spec == "ngram" and not r["n_spec_proposed"] > 0:
            raise AssertionError(f"{tag}: the n-gram drafter never proposed")
        r["accepted_share"] = (r["n_spec_accepted"]
                               / max(r["n_spec_proposed"], 1))
    ms = 1e3 if r["clock_unit"] == "s" else None
    lat = (f"TTFT p50/p99 {r['ttft_p50'] * ms:.1f}/{r['ttft_p99'] * ms:.1f} "
           f"ms, TBT p50/p99 {r['tbt_p50'] * ms:.1f}/{r['tbt_p99'] * ms:.1f} "
           "ms, " if ms else "")
    extra = ""
    if a.prefix_cache:
        extra += (f", prefix hits {r['n_prefix_hits']} "
                  f"({r['n_prefix_tokens']} tokens), restores "
                  f"{r['n_prefix_restores']}")
    if r["n_swapped_out"] or a.preemption in ("swap", "auto"):
        extra += (f", swapped out/in {r['n_swapped_out']}/"
                  f"{r['n_swapped_in']}")
    if spec != "off":
        extra += (f", spec k {r['spec_k']}: {r['n_spec_proposed']} proposed, "
                  f"{r['n_spec_accepted']} accepted (share "
                  f"{r['accepted_share']:.4f}), {r['n_verify_dispatches']} "
                  f"verify + {r['n_draft_dispatches']} draft launches")
    if r["state_bytes_per_slot"]:
        extra += (f", recurrent state {r['state_bytes_per_slot'] / 1e6:.3f} "
                  f"MB a slot (cache {r['cache_bytes'] / 1e9:.2f} GB)")
    if model.cfg.encoder.enabled:
        admitted = sum(len(p[0]) for p in plans)
        if r["n_cross_installs"] != admitted:
            raise AssertionError(f"{tag}: {r['n_cross_installs']} cross-K/V "
                                 f"installs for {admitted} admissions")
        extra += (f", cross-K/V installs {r['n_cross_installs']} = "
                  f"admissions (cache {r['cache_bytes'] / 1e9:.2f} GB)")
    if a.fault_plan is not None:
        extra += (f", faults injected {r['fault_counters']}, shed "
                  f"{r['shed']}, retries {r['fault_stats']['n_fault_retries']}")
    log(f"{tag}{' open-loop ' + a.clock if a.open_loop else ''}: "
        f"{r['requests']} requests, {r['iterations']} iterations, "
        f"{r['ms_per_iter']:.1f} ms/iter, {lat}expert-load "
        f"{r['expert_load_bytes'] / 1e6:.1f} MB, preemptions "
        f"{r['n_preempted']}{extra}, {r['host_syncs']} host syncs "
        f"{r['host_sync_sites']}, launches {counts}, padded MoE copies "
        f"{r['pad_copies']}, token streams sha256 {r['streams_sha256']}")
    return r


def check_launches(tag: str, counts: dict, need, may) -> None:
    """Every kernel of ``need`` launched, and none outside ``may``."""
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    stray = {k: v for k, v in counts.items() if k not in may and v}
    if stray:
        raise AssertionError(f"{tag}: kernels of another path launched: "
                             f"{stray}")


def plan_kinds(a) -> collections.Counter:
    """The events of ``a.fault_plan`` by kind (empty without one)."""
    from repro_torch.serving.faults import FaultPlan
    if a.fault_plan is None:
        return collections.Counter()
    return collections.Counter(e.kind for e in
                               FaultPlan.load(a.fault_plan).events)


def check_served(tag: str, a, r: dict, vocab: int) -> None:
    """Every request completed with all its ``max_new_tokens`` in-vocabulary
    tokens or, in a chaos serve, was shed with a reason and a stream no
    longer than that; a chaos serve injected every event of its plan and
    left no page in use on the device or the host."""
    shed = r.get("shed", {})
    if r["completed"] + len(shed) != r["requests"]:
        raise AssertionError(f"{tag}: {r['completed']} completed + "
                             f"{len(shed)} shed of {r['requests']} requests")
    short = [rid for rid, t in r["outputs"].items()
             if rid not in shed and len(t) != r["max_new"][rid]
             or len(t) > r["max_new"][rid]]
    if short:
        raise AssertionError(f"{tag}: requests {short} did not get all "
                             "their tokens")
    if any(not 0 <= x < vocab for t in r["outputs"].values() for x in t):
        raise AssertionError(f"{tag}: token id out of range")
    injected = collections.Counter({k[2:]: v for k, v in
                                    r["fault_counters"].items() if v})
    if injected != plan_kinds(a):
        raise AssertionError(f"{tag}: injected {dict(injected)}, planned "
                             f"{dict(plan_kinds(a))}")
    if a.fault_plan is not None and (r["pages_left"]
                                     or r["host_pages_left"]):
        raise AssertionError(f"{tag}: {r['pages_left']} device and "
                             f"{r['host_pages_left']} host pages in use "
                             "at drain")


def _same_streams(x: dict, y: dict) -> str:
    same = sum(x["outputs"][r] == y["outputs"][r] for r in x["outputs"])
    first = sum(x["outputs"][r][0] == y["outputs"][r][0] for r in x["outputs"])
    n = len(x["outputs"])
    return (f"identical first tokens {first}/{n}, identical token streams "
            f"{same}/{n}")


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def explain_divergence(model, params, lay: dict, chk: dict,
                       labels=("layered", "chunked"), enc=None) -> list:
    """Where a request's two bf16 streams part (layered and chunked, or
    the ``labels`` of two other serves of the same requests), recompute
    that position's logits with ONE bf16 prefill of prompt + the common
    prefix of the two streams (no cache, a third batch shape) and report
    the gap between the two tokens the schedulers chose, and the top-2
    gap, beside bf16's ulp at the top logit.  Then the same prefill once
    more with the sequence padded to 2048 tokens (masked padding after
    it: causal, so the same function, only other GEMM shapes): how far
    rounding alone moves the logits, and how many of the routers' top-k
    assignments it moves (the per-block expert counts of the real
    tokens).  An encoder-decoder's requests attend over ``enc[rid]``,
    their encoder output (1, T, D)."""
    import torch
    out = []
    for rid, a_toks in lay["outputs"].items():
        b_toks = chk["outputs"][rid]
        j = next((i for i, (x, y) in enumerate(zip(a_toks, b_toks))
                  if x != y), None)
        if j is None:
            continue
        seq = [int(t) for t in lay["prompts"][rid]] + list(a_toks[:j])
        n = len(seq)
        toks = torch.tensor([seq], dtype=torch.long, device=model.device)
        pad = torch.randint(1, model.cfg.vocab_size, (1, 2048 - n),
                            generator=torch.Generator().manual_seed(rid))
        padded = torch.cat([toks, pad.to(model.device)], dim=1)
        valid = torch.arange(2048, device=model.device)[None] < n
        e = {} if enc is None else {"enc_out": enc[rid]}
        with torch.no_grad():
            logits, _, aux = model.forward(params, toks, dropless=True, **e)
            lg = logits[0, -1].float()
            del logits
            logits_p, _, aux_p = model.forward(params, padded, valid=valid,
                                               dropless=True, **e)
            lp = logits_p[0, n - 1].float()
            del logits_p
        moved = int((aux["expert_counts"] - aux_p["expert_counts"]).abs()
                    .sum()) // 2
        n_assign = n * model.cfg.moe.top_k * model.n_blocks
        top = torch.topk(lg, 2)
        t1, t2 = (float(v) for v in top.values)
        la, lb = float(lg[a_toks[j]]), float(lg[b_toks[j]])
        ulp = _bf16_ulp(t1)
        row = {"req": rid, "position": j, "prompt_len": len(lay["prompts"][rid]),
               f"{labels[0]}_token": a_toks[j], f"{labels[1]}_token": b_toks[j],
               "top2_tokens": [int(i) for i in top.indices],
               "top2_gap": t1 - t2, "chosen_gap": abs(la - lb),
               "bf16_ulp_at_top": ulp,
               "top2_gap_ulps": (t1 - t2) / ulp,
               "chosen_gap_ulps": abs(la - lb) / ulp,
               "padded_same_argmax": bool(lg.argmax() == lp.argmax()),
               "padded_max_shift_ulps": float((lg - lp).abs().max()) / ulp,
               "padded_rel_fro": float((lg - lp).norm() / lg.norm()),
               "padded_routing_moved": moved,
               "routing_assignments": n_assign}
        log(f"  divergence req {rid} at new token {j} (prompt "
            f"{row['prompt_len']}): {labels[0]} {a_toks[j]} / {labels[1]} "
            f"{b_toks[j]}; one-prefill logits: top-2 {row['top2_tokens']} "
            f"gap {t1 - t2:.4g} = {row['top2_gap_ulps']:.2f} ulp, the two "
            f"chosen tokens' gap {abs(la - lb):.4g} = "
            f"{row['chosen_gap_ulps']:.2f} ulp (bf16 ulp at {t1:.4g}: "
            f"{ulp:.4g}); padded to 2048: argmax same "
            f"{row['padded_same_argmax']}, logits moved up to "
            f"{row['padded_max_shift_ulps']:.1f} ulp (rel Frobenius "
            f"{row['padded_rel_fro']:.3e}), {moved} of {n_assign} routed "
            "assignments moved")
        out.append(row)
    return out


def _phase(name: str, t0: float, times: dict) -> float:
    t = time.perf_counter()
    times[name] = t - t0
    log(f"phase {name}: {t - t0:.1f} s")
    return t


def serve_configs(arch: str):
    """The long and the short trace's closed-loop configs of ``arch``: the
    serves of earlier runs, without the prefix cache (their plans, streams
    and digests stay comparable).  The dense dispatch computes every
    expert over every token of a batch (C = T), so it serves the short
    trace: 64-256-token prompts, 8 new tokens each."""
    from repro_torch.launch.serve import ServeConfig
    base = ServeConfig(arch=arch, requests=4, max_len=2048, slots=8,
                       quantum=512, token_budget=512, seed=0,
                       prompt_len=(600, 1501), new_tokens=(16, 17),
                       prefix_cache=False)
    short = dataclasses.replace(base, max_len=512, quantum=128,
                                token_budget=128, prompt_len=(64, 257),
                                new_tokens=(8, 9))
    return base, short


def build_logged(a, label: str, times: dict, n_layers=None, seed=None):
    """The model of ``a`` at full width (``n_layers`` cuts its depth,
    ``seed`` replaces ``a.seed``), its build logged and timed."""
    import torch
    from repro_torch.launch.serve import build_model, model_config
    from repro_torch.models.model import DecoderModel
    t0 = time.perf_counter()
    if n_layers is None and seed is None:
        model, params = build_model(a)
    else:
        cfg = model_config(a)
        model = DecoderModel(dataclasses.replace(
            cfg, n_layers=n_layers or cfg.n_layers), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(
            a.seed if seed is None else seed)
        params = model.init_params(gen)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"built {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads (hd {cfg.head_dim_}), "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, expert d_ff "
        f"{cfg.moe.expert_d_ff}, vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.2f} B params "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f} s; expert bytes "
        f"{cfg.expert_bytes(2) / 1e6:.1f} MB")
    return model, params, _phase(f"{label} build", t0, times)


def serve_qwen3(times: dict, explain: bool = False) -> dict:
    """Phase 4a: every serve at qwen3-30b-a3b width.  With ``explain``,
    the long trace's layered/chunked bf16 divergence is analysed too."""
    from repro_torch.launch.serve import ServeConfig
    from repro_torch.serving.traffic import shared_prefix_trace
    base, short = serve_configs("qwen3-30b-a3b")
    model, params, t0 = build_logged(base, "qwen3", times)
    cfg = model.cfg
    runs = {}
    for sched in ("layered", "chunked"):
        runs[f"ragged/{sched}"] = run_serve(
            dataclasses.replace(base, scheduler=sched), model, params)
    for disp, sched in (("dense", "layered"), ("dense", "chunked"),
                        ("ragged", "layered")):
        runs[f"short {disp}/{sched}"] = run_serve(
            dataclasses.replace(short, scheduler=sched, moe_dispatch=disp),
            model, params)
    t0 = _phase("qwen3 closed-loop serves", t0, times)

    lay, chk = runs["ragged/layered"], runs["ragged/chunked"]
    if not lay["expert_load_bytes"] <= chk["expert_load_bytes"]:
        raise AssertionError("layered expert-load exceeds chunked")
    log(f"layered / chunked expert-load {lay['expert_load_bytes'] / 1e6:.1f} / "
        f"{chk['expert_load_bytes'] / 1e6:.1f} MB "
        f"({lay['expert_load_bytes'] / chk['expert_load_bytes']:.3f}); "
        f"{_same_streams(lay, chk)} (bf16: other batch shapes round "
        "differently and may flip an argmax)")
    divergence = (explain_divergence(model, params, lay, chk) if explain
                  else None)
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
    t0 = _phase("qwen3 serve checks", t0, times)

    # open loop on the wall clock: ServeConfig.engine_trace, 8 Poisson
    # arrivals at the JAX launcher's 1.3 req/s, the prefix cache on
    wall = ServeConfig(arch="qwen3-30b-a3b", open_loop=True, clock="wall",
                       requests=8, rate=1.3, max_len=2048, slots=8,
                       quantum=512, token_budget=512, seed=0)
    for sched in ("layered", "chunked"):
        runs[f"open-loop {sched}"] = run_serve(
            dataclasses.replace(wall, scheduler=sched), model, params)
    ol, oc = runs["open-loop layered"], runs["open-loop chunked"]
    log(f"open loop: layered / chunked expert-load "
        f"{ol['expert_load_bytes'] / 1e6:.1f} / "
        f"{oc['expert_load_bytes'] / 1e6:.1f} MB; TTFT p99 "
        f"{ol['ttft_p99'] * 1e3:.1f} / {oc['ttft_p99'] * 1e3:.1f} ms, TBT p99 "
        f"{ol['tbt_p99'] * 1e3:.1f} / {oc['tbt_p99'] * 1e3:.1f} ms")
    t0 = _phase("qwen3 open-loop serves", t0, times)

    # prefix hits: two 512-token system prompts, 64-token suffixes
    trace = shared_prefix_trace(8, n_prefixes=2, prefix_len=512,
                                suffix_len=64, output_len=8, rate=1.3,
                                vocab_size=cfg.vocab_size, seed=0)
    r = runs["prefix layered"] = run_serve(
        dataclasses.replace(wall, scheduler="layered"), model, params,
        trace=trace)
    if not (r["n_prefix_hits"] > 0 and r["n_prefix_restores"] > 0):
        raise AssertionError(f"prefix trace: {r['n_prefix_hits']} hits, "
                             f"{r['n_prefix_restores']} restores")
    t0 = _phase("qwen3 prefix-cache serve", t0, times)

    # swap: 8 requests of 64-256 prompt tokens and 48 new ones in 80
    # pages of 16 tokens (the schedule swaps twice), then the same trace
    # with no pressure
    swap = dataclasses.replace(short, requests=8, new_tokens=(48, 49),
                               pages=80, preemption="swap")
    sw = runs["swap layered"] = run_serve(swap, model, params)
    if not sw["n_swapped_in"] == sw["n_swapped_out"] > 0:
        raise AssertionError(f"swap serve: swapped out/in "
                             f"{sw['n_swapped_out']}/{sw['n_swapped_in']}")
    free = runs["swap layered, no pressure"] = run_serve(
        dataclasses.replace(swap, pages=None, preemption="on"), model,
        params)
    victims = sw["swapped_ids"]
    same = sum(sw["outputs"][v] == free["outputs"][v] for v in victims)
    log(f"swap: victims {victims}; {same}/{len(victims)} victims' streams "
        f"equal their unpressured streams, {_same_streams(sw, free)} over "
        "all requests (bf16: the decode batch differs; equality is held in "
        "fp32 on the CPU)")
    sw["victims_equal_unpressured"] = same
    t0 = _phase("qwen3 swap serves", t0, times)

    # the three other schedulers on the short trace
    for sched in ("hybrid", "continuous", "static"):
        runs[f"short ragged/{sched}"] = run_serve(
            dataclasses.replace(short, scheduler=sched), model, params)
    t0 = _phase("qwen3 other schedulers", t0, times)

    spec = serve_spec(model, params, short, runs, times, t0)
    disagg = serve_disagg(model, params, runs, times, time.perf_counter())
    live = serve_live(model, params, runs, times, time.perf_counter())

    t0 = time.perf_counter()
    profile_serve(dataclasses.replace(base, scheduler="layered"),
                  *first_layers(model, params, PROFILE_LAYERS))
    _phase("qwen3 profile", t0, times)
    del model, params
    return {"runs": runs, "divergence": divergence, "spec": spec,
            "disagg": disagg, "live": live}


def repetitive_trace(vocab: int, seed: int = 0) -> list:
    """8 requests at time 0, 64 new tokens each, whose prompts are a block
    of 1024-1407 distinct random tokens followed by 256-511 tokens that
    repeat a random pattern of 3-8 tokens.  The n-gram drafter proposes
    where the model's last token occurs earlier in its history.  A
    random-weight model never repeats a token on its own (a periodic
    prompt alone gave the drafter nothing in 38 iterations), so its
    matches fall on the block of distinct tokens, as answers that quote a
    retrieved document do: about 4 of the 512 new tokens at qwen3's vocab
    of 151936."""
    import numpy as np
    from repro_torch.serving.traffic import TraceRequest
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(8):
        block = rng.choice(np.arange(1, vocab),
                           min(int(rng.integers(1024, 1408)), vocab - 1),
                           replace=False)
        pattern = rng.integers(1, vocab, int(rng.integers(3, 9)))
        n = int(rng.integers(256, 512))
        prompt = np.concatenate(
            [block, np.tile(pattern, -(-n // len(pattern)))[:n]])
        trace.append(TraceRequest(0.0, len(prompt), 64, prompt_tokens=tuple(
            int(x) for x in prompt)))
    return trace


def ngram_serves(model, params, runs: dict, label: str) -> None:
    """The repetitive trace under the n-gram drafter (spec_k 4) and with
    speculation off."""
    ng = spec_config(model.cfg.name)
    trace = repetitive_trace(model.cfg.vocab_size)
    runs[f"{label}spec ngram"] = run_serve(ng, model, params, trace=trace)
    runs[f"{label}spec off, ngram trace"] = run_serve(
        dataclasses.replace(ng, spec="off"), model, params, trace=trace)


def spec_config(arch: str, spec: str = "ngram"):
    """The repetitive trace's serve: replayed on the iteration clock (every
    request arrives at 0: a closed loop), layered, ragged, 8 slots."""
    from repro_torch.launch.serve import ServeConfig
    return ServeConfig(arch=arch, open_loop=True, clock="virtual",
                       requests=8, max_len=2048, slots=8, quantum=512,
                       token_budget=512, seed=0, prefix_cache=False,
                       spec=spec, spec_k=4)


def compare_streams(model, params, x: dict, y: dict, labels) -> dict:
    """Digests of two serves of the same requests and, where a request's
    streams part, the first parting position with the logit gap there in
    bf16 ulps (``explain_divergence``): reported, not asserted (bf16
    rounds the verify window's batch otherwise than the decode step's)."""
    rows = explain_divergence(model, params, x, y, labels)
    log(f"{labels[0]} / {labels[1]}: streams sha256 {x['streams_sha256']} / "
        f"{y['streams_sha256']}; {_same_streams(x, y)}")
    return {"labels": list(labels), "sha256": [x["streams_sha256"],
                                               y["streams_sha256"]],
            "parted": rows}


def check_draft_step(model, params, a, r, k: int = 4) -> dict:
    """The draft step of the target drafting for itself, at the self-draft
    serve's shapes, against the target's own no-cache ``forward`` under
    the draft's dispatch (capacity-limited dense MoE over the padded
    batch, full (B, P, V) logits) on the same histories: each request's
    prompt and the first half of its served stream, padded as the engine
    pads them, and extended step by step with the draft's own proposals
    (teacher forcing).  Each proposal must be the reference's argmax or
    within 4 bf16 ulps of its top logit (near-ties of random weights:
    the two computations round in other GEMM shapes); a wrong position,
    token write or length in the draft loop misses by far more.  Reports
    the exact matches, the largest gap in ulps, and the real tokens'
    routed assignments the capacity dropped."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import _bucket
    eng = draft_engine(a, model, params, (model, params), spec_k=k)
    hists = [list(r["prompts"][rid]) + list(t[:len(t) // 2])
             for rid, t in sorted(r["outputs"].items())]
    b = _bucket(len(hists), minimum=1, cap=eng.n_slots)
    p = _bucket(max(map(len, hists)) + k, cap=eng.max_len + k)
    toks = np.zeros((b, p), np.int64)
    lens = np.ones(b, np.int64)
    for i, h in enumerate(hists):
        toks[i, :len(h)] = h
        lens[i] = len(h)
    dev = model.device
    with torch.no_grad():
        props = eng._draft_impl(k, torch.from_numpy(toks).to(dev),
                                torch.from_numpy(lens).to(dev)).cpu().numpy()
        del eng
        n = len(hists)
        exact, worst, dropped = 0, 0.0, 0
        for j in range(k):
            logits, _, aux = model.forward(
                params, torch.from_numpy(toks).to(dev), dropless=False,
                moe_dispatch="dense")
            at = logits[torch.arange(n, device=dev),
                        torch.from_numpy(lens[:n] - 1 + j)
                        .to(dev)].float().cpu()
            del logits
            dropped += int(aux["dropped"])
            for i in range(n):
                top = float(at[i].max())
                gap = (top - float(at[i, props[i, j]])) / _bf16_ulp(top)
                exact += int(at[i].argmax()) == int(props[i, j])
                worst = max(worst, gap)
            toks[np.arange(n), lens[:n] + j] = props[:n, j]
    routed = k * b * p * model.cfg.moe.top_k * model.n_blocks
    log(f"draft step vs the target's no-cache forward (B {b}, P {p}, "
        f"k {k}): {exact}/{n * k} proposals its argmax, largest gap "
        f"{worst:.2f} bf16 ulp; the capacity dropped {dropped} of the "
        f"{routed} routed assignments of the {k} steps (padding's too)")
    if worst > 4:
        raise AssertionError(f"a draft proposal is {worst:.2f} bf16 ulp "
                             "below the target's top logit")
    return {"proposals": n * k, "argmax": exact, "max_gap_ulps": worst,
            "dropped": dropped, "routed": routed}


def serve_spec(model, params, short, runs: dict, times: dict, t0) -> dict:
    """Phase 4, speculative verify-k at qwen3-30b-a3b width: the n-gram
    drafter (spec_k 4) on the repetitive trace beside the same trace with
    speculation off (``ngram_serves``); then the draft model on the short
    trace, once the target drafting for itself and once a differently
    seeded twin of the target cut to 2 layers (a full-depth twin would
    not fit beside the target).  The self-draft's step is held against
    the target's no-cache forward (``check_draft_step``); its accepted
    share beside the twin's is reported, not asserted (random weights
    leave the logits nearly flat, so bf16 rounding decides most argmaxes,
    and the draft's capacity drops tokens the target's verify keeps)."""
    import torch
    cfg = model.cfg
    ngram_serves(model, params, runs, "")
    runs["spec self-draft"] = run_serve(short, model, params,
                                        draft=(model, params))
    step = check_draft_step(model, params, short, runs["spec self-draft"])
    twin, twin_params, _ = build_logged(short, "qwen3 twin draft", times,
                                        n_layers=2, seed=7)
    runs["spec twin-draft"] = run_serve(short, model, params,
                                        draft=(twin, twin_params))
    del twin, twin_params
    gc.collect()
    torch.cuda.empty_cache()
    own, other = (runs["spec self-draft"]["accepted_share"],
                  runs["spec twin-draft"]["accepted_share"])
    log(f"draft acceptance: self {own:.4f}, twin {other:.6f} (1/vocab "
        f"{1 / cfg.vocab_size:.2e})")
    t0 = _phase("qwen3 spec serves", t0, times)
    off = runs["short ragged/layered"]
    out = {"ngram": compare_streams(model, params, runs["spec ngram"],
                                    runs["spec off, ngram trace"],
                                    ("ngram", "off")),
           "self-draft": compare_streams(model, params,
                                         runs["spec self-draft"], off,
                                         ("self-draft", "off")),
           "twin-draft": compare_streams(model, params,
                                         runs["spec twin-draft"], off,
                                         ("twin-draft", "off"))}
    _phase("qwen3 spec stream comparison", t0, times)
    return {**out, "self-draft step": step}


# the kernels each pool of a two-pool serve launches: the prefill pool
# never decodes (completed prefills migrate in the iteration that ends
# them), the decode pool never prefills
POOL_KERNELS = {"prefill": {"moe_gmm_ragged", "prefill_attention"},
                "decode": {"moe_gmm_ragged", "decode_attention"}}
# the two-pool chaos schedule of tests/test_faults.py: two link drops, a
# link delay and a crash of each pool (target 0: prefill, 1: decode)
LINK_FAULTS = [dict(iteration=2, kind="link_drop"),
               dict(iteration=6, kind="link_delay", magnitude=3.0),
               dict(iteration=10, kind="link_drop", target=1),
               dict(iteration=8, kind="executor_crash", target=0),
               dict(iteration=20, kind="executor_crash", target=1)]
# the monolithic chaos schedule: a seeded plan over the swap serve's
# oversubscribed pool, every event of which comes due in that serve
CHAOS_SEED = dict(seed=8, horizon=30, n_events=6,
                  kinds=["executor_crash", "pressure_spike",
                         "swap_dma_fail", "client_disconnect"])


def disagg_config(arch: str):
    """The two-pool serves' config: the launcher's closed-loop generator
    (8 requests, prompts of 16-1023 tokens, 4-15 new), max_len 2048, 8
    slots on each pool, ragged dispatch, the prefix cache on."""
    from repro_torch.launch.serve import ServeConfig
    return ServeConfig(arch=arch, disagg=True, requests=8, max_len=2048,
                       slots=8, quantum=512, token_budget=512, seed=0)


def kv_bytes_per_token(cfg) -> int:
    """bf16 cache bytes of one token over every layer (K and V for GQA,
    the latent and the rope key for MLA)."""
    return cfg.kv_bytes_per_token(2)


def cross_bytes(cfg) -> int:
    """bf16 bytes of one slot's cross-attention K/V over every layer (an
    encoder-decoder's; 0 for a decoder-only stack): they move whole."""
    n = sum(sp.cross_attn for sp in cfg.block_specs())
    return n * 2 * cfg.encoder.n_frames * cfg.n_kv_heads * cfg.head_dim_ * 2


def run_disagg_serve(a, model, params, frames=None) -> dict:
    """One two-pool serve through the port's launcher (``run_disagg`` on
    engines from ``build_disagg_engines``), with each pool's kernel
    launches read around its every ``execute_plan`` and each export's
    prompt length and bytes recorded; raises unless the decode pool ran no
    prefill slice, every request completed (or, in a chaos serve, was shed
    with a reason) with in-vocabulary tokens, no page is in use on either
    pool's device or host pool and both allocators' invariants hold, the
    plan's every fault was injected, each pool launched exactly its
    kernels (``POOL_KERNELS``, without the MoE kernel on a dense model),
    every export moved the prompt's K/V (and, for an encoder-decoder, the
    slot's whole cross K/V) and nothing else, and the serve synced the
    host once per iteration of each pool plus once per whole-prompt
    export.  ``frames`` as for ``run_serve``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_disagg_engines, run_disagg
    ep, ed = build_disagg_engines(a, model, params)
    tag = (f"{a.arch} two-pool {a.scheduler}/{a.handoff}"
           + (" chaos" if a.fault_plan is not None else ""))
    per_pool = {"prefill": collections.Counter(),
                "decode": collections.Counter()}
    for pool, eng in (("prefill", ep), ("decode", ed)):
        def execute_plan(plan, _execute=eng.execute_plan,
                         _counts=per_pool[pool]):
            before = dict(ops.LAUNCHES)
            events = _execute(plan)
            _counts.update({k: v - before[k] for k, v in ops.LAUNCHES.items()})
            return events
        eng.execute_plan = execute_plan
    exports = []

    def export_request(rid, _export=ep.export_request):
        p = _export(rid)
        blob = [rows for _, _, rows in p["chunks"]] if p["row"] is None \
            else p["row"]
        exports.append((p["offset"], len(p["chunks"]), sum(
            t.numel() * t.element_size() for t in _leaves(blob))))
        return p
    ep.export_request = export_request
    r, launches, sites = traced(lambda: run_disagg(ep, ed, a, frames=frames))
    r["launches"] = launches
    r["streams_sha256"] = streams_sha256(r["outputs"])
    r["state_bytes_per_slot"] = eng.state_bytes_per_slot
    r["cache_bytes"] = sum(t.numel() * t.element_size()
                           for t in _leaves(eng.cache))
    r["launches_by_pool"] = {k: dict(v) for k, v in per_pool.items()}
    r["arch"] = a.arch
    for eng in (ep, ed):
        eng.alloc.check_invariants()
    del ep, ed
    gc.collect()
    torch.cuda.empty_cache()
    check_served(tag, a, r, model.cfg.vocab_size)
    if r["decode_prefill_slices"] != 0:
        raise AssertionError(f"{tag}: {r['decode_prefill_slices']} prefill "
                             "slices on the decode pool")
    if r["pages_left"] or r["host_pages_left"]:
        raise AssertionError(f"{tag}: {r['pages_left']} device and "
                             f"{r['host_pages_left']} host pages in use at "
                             "drain")
    for pool, want in POOL_KERNELS.items():
        if not model.cfg.moe.enabled:
            want = want - {"moe_gmm_ragged"}
        got = {k for k, v in per_pool[pool].items() if v}
        if got != want:
            raise AssertionError(f"{tag}: the {pool} pool launched "
                                 f"{dict(per_pool[pool])}, not {sorted(want)}")
    per_token, cross = kv_bytes_per_token(model.cfg), cross_bytes(model.cfg)
    moved = sum(b for _, _, b in exports)
    if moved != (sum(n for n, _, _ in exports) * per_token
                 + len(exports) * cross) or moved != r["handoff_bytes"]:
        raise AssertionError(f"{tag}: handoff bytes {r['handoff_bytes']}, "
                             f"exports moved {moved} for "
                             f"{sum(n for n, _, _ in exports)} prompt tokens "
                             f"x {per_token} B + {len(exports)} x {cross} B")
    whole = sum(1 for _, n_chunks, _ in exports if n_chunks == 0)
    if a.handoff == "whole" and whole != len(exports):
        raise AssertionError(f"{tag}: {len(exports) - whole} exports "
                             "streamed under whole handoff")
    # the two synchronize() calls that bound the timing are torch's own
    # (torch/cuda/__init__.py) or the launcher's; the rest are the serve's
    timing = sum(v for k, v in sites.items()
                 if k.startswith(("serve.py:", "__init__.py:")))
    r["host_syncs"] = sum(sites.values()) - timing
    r["host_sync_sites"] = dict(sites)
    r["whole_exports"] = whole
    if r["host_syncs"] != r["iterations"] + whole:
        raise AssertionError(f"{tag}: {r['host_syncs']} host syncs in "
                             f"{r['iterations']} iterations and {whole} "
                             f"whole-prompt exports: {dict(sites)}")
    r["n_exports"] = len(exports)
    log(f"{tag}: {r['requests']} requests, {r['n_prefill_iterations']} "
        f"prefill + {r['n_decode_iterations']} decode iterations, "
        f"{r['ms_per_iter']:.1f} ms/iter, expert-load prefill / decode "
        f"{r['expert_load_bytes_prefill'] / 1e6:.1f} / "
        f"{r['expert_load_bytes_decode'] / 1e6:.1f} MB, "
        f"{r['n_migrations']} migrations of {len(exports)} exports "
        f"({whole} whole-prompt), {r['n_returns']} returns, handoff "
        f"{r['handoff_bytes'] / 1e6:.1f} MB "
        f"(= {sum(n for n, _, _ in exports)} prompt tokens x {per_token} B"
        f"{f' + {len(exports)} x {cross} B of cross K/V' if cross else ''}), "
        f"{r['host_syncs']} host syncs {dict(sites)}, launches by pool "
        f"{r['launches_by_pool']}"
        + (f", faults injected {r['fault_counters']}, shed {r['shed']}, "
           f"retries {r['fault_stats']['n_fault_retries']}"
           if a.fault_plan is not None else "")
        + f", token streams sha256 {r['streams_sha256']}")
    return r


def serve_disagg(model, params, runs: dict, times: dict, t0) -> dict:
    """Phase 4, disaggregated serving at qwen3-30b-a3b width: two pools
    over the one copy of the weights (``disagg_config``), layered with
    streaming and with whole-prompt handoff, chunked with streaming, the
    same requests through the monolithic layered engine as the yardstick;
    then chaos: the two-pool layered/stream serve under ``LINK_FAULTS``,
    and the monolithic swap serve under the seeded ``CHAOS_SEED`` plan
    (retry budget 50 each).  Streaming and whole-prompt handoff must give
    the same streams; where the two-pool streams part from the monolithic
    ones, and a chaos serve's from its fault-free serve, is reported."""
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    _, short = serve_configs(model.cfg.name)
    a = disagg_config(model.cfg.name)
    for sched, handoff in (("layered", "stream"), ("layered", "whole"),
                           ("chunked", "stream")):
        runs[f"two-pool {sched}/{handoff}"] = run_disagg_serve(
            dataclasses.replace(a, scheduler=sched, handoff=handoff), model,
            params)
    mono = runs["two-pool yardstick, layered"] = run_serve(
        dataclasses.replace(a, disagg=False), model, params)
    st, wh = runs["two-pool layered/stream"], runs["two-pool layered/whole"]
    if st["outputs"] != wh["outputs"]:
        raise AssertionError(f"two-pool layered: stream and whole handoff "
                             f"give other streams: {_same_streams(st, wh)}")
    if wh["handoff_bytes"] != st["handoff_bytes"]:
        raise AssertionError(f"handoff bytes stream {st['handoff_bytes']}, "
                             f"whole {wh['handoff_bytes']}")
    ch = runs["two-pool chunked/stream"]
    log(f"two-pool / monolithic layered expert-load "
        f"{st['expert_load_bytes'] / 1e6:.1f} (prefill "
        f"{st['expert_load_bytes_prefill'] / 1e6:.1f} + decode "
        f"{st['expert_load_bytes_decode'] / 1e6:.1f}) / "
        f"{mono['expert_load_bytes'] / 1e6:.1f} MB, chunked two-pool "
        f"{ch['expert_load_bytes'] / 1e6:.1f} MB; ms/iter two-pool "
        f"{st['ms_per_iter']:.1f} / {wh['ms_per_iter']:.1f} (stream / whole) "
        f"over {st['iterations']} pool iterations, monolithic "
        f"{mono['ms_per_iter']:.1f} over {mono['iterations']}")
    t0 = _phase("qwen3 two-pool serves", t0, times)

    plan = FaultPlan(events=[FaultEvent(**e) for e in LINK_FAULTS])
    runs["two-pool chaos"] = run_disagg_serve(
        dataclasses.replace(a, fault_plan=plan.to_json(), retry_budget=50),
        model, params)
    swap = dataclasses.replace(short, requests=8, new_tokens=(48, 49),
                               pages=80, preemption="swap")
    seeded = FaultPlan.from_seed(CHAOS_SEED["seed"],
                                 horizon=CHAOS_SEED["horizon"],
                                 n_events=CHAOS_SEED["n_events"],
                                 kinds=CHAOS_SEED["kinds"])
    runs["swap layered chaos"] = run_serve(
        dataclasses.replace(swap, fault_plan=seeded.to_json(),
                            retry_budget=50), model, params)
    t0 = _phase("qwen3 chaos serves", t0, times)
    out = {"two-pool vs monolithic": compare_streams(
               model, params, st, mono, ("two-pool", "monolithic")),
           "two-pool chaos vs fault-free": compare_streams(
               model, params, runs["two-pool chaos"], st,
               ("chaos", "fault-free")),
           "swap chaos vs fault-free": compare_streams(
               model, params, runs["swap layered chaos"],
               runs["swap layered"], ("chaos", "fault-free"))}
    _phase("qwen3 two-pool stream comparison", t0, times)
    return out


# ------------------------------------------------------ phase 4, live serve


# the kernels a serve on the ragged dispatch launches, and no other
RAGGED_PATH = ("moe_gmm_ragged", "prefill_attention", "decode_attention")
# the simulator's times are the cost model's, for its preset: never a time
# of this card
MODELLED = "modelled, h100x2 preset (two GPUs, TP)"


def parse_metrics(text: str) -> dict:
    """A /metrics body (Prometheus text) as {sample: value}; raises unless
    every sample line is a name and a float."""
    flat = {}
    for ln in text.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        name, _, val = ln.rpartition(" ")
        flat[name] = float(val)
    return flat


def live_serve(a, model, params, trace, n_clients: int, drain: bool = False,
               **server_kw) -> dict:
    """One live serve through the port's HTTP/SSE front-end: an in-process
    ``ServingServer`` on port 0 over a fresh engine on ``model``/``params``
    (its kernels built before the socket binds), driven by
    ``load_gen.run_load`` with ``n_clients`` closed-loop clients over
    ``trace`` while a task on the same asyncio thread scrapes /metrics
    every 0.2 s; /healthz and /readyz after the load.  ``drain``: a
    64-token stream is put in flight, ``drain()`` called, and a POST and
    /readyz sent while it drains; else ``stop()``.  The launch counts are
    set to 0 before the server starts and read after it stopped; the host
    syncs of both threads are counted; every POST's status and
    Retry-After is recorded.  Raises unless every request got its
    ``max_new_tokens`` in-vocabulary tokens in SSE order equal to the
    server's ``token_log`` and the engine's outputs, every /metrics
    scrape parsed with TTFT/TBT and the HTTP counters, /healthz and
    /readyz answered 200, the serve launched K1, K2 and K3 and nothing
    else with one host sync per iteration, and no page is left in use."""
    import asyncio
    import torch
    from repro_torch.launch import load_gen
    from repro_torch.launch.load_gen import plan_key
    from repro_torch.launch.serve import build_server
    from repro_torch.serving.metrics import request_metrics
    srv = build_server(dataclasses.replace(a, http=":0"), model, params,
                       record_plans=True, **server_kw)
    seen = []                         # (status, Retry-After) of each POST
    post = load_gen._post_generate

    async def recorded(*args, **kw):
        status, headers, events = await post(*args, **kw)
        seen.append((status, headers.get("retry-after")))
        return status, headers, events

    async def go():
        await srv.start()
        host, port = srv.host, srv.port
        scrapes, stop = [], asyncio.Event()

        async def scrape():
            while not stop.is_set():
                scrapes.append(await load_gen._fetch(host, port, "/metrics"))
                await asyncio.sleep(0.2)
        task = asyncio.ensure_future(scrape())
        t0 = time.perf_counter()
        report = await load_gen.run_load(host, port, trace, n_clients)
        elapsed = time.perf_counter() - t0
        iterations = srv.engine.iteration     # a host int: no sync
        stop.set()
        await task
        scrapes.append(await load_gen._fetch(host, port, "/metrics"))
        health = [(await load_gen._fetch(host, port, path))[0]
                  for path in ("/healthz", "/readyz")]
        out = {"report": report, "elapsed": elapsed, "scrapes": scrapes,
               "health": health, "iterations": iterations}
        if not drain:
            await srv.stop()
            return out
        inflight = asyncio.ensure_future(recorded(host, port, {
            "prompt_tokens": list(trace[0].prompt_tokens),
            "max_new_tokens": 64, "tenant": "drain"}))
        while not srv._streams:
            await asyncio.sleep(0.01)
        draining = asyncio.ensure_future(srv.drain(timeout=120.0))
        await asyncio.sleep(0)
        out["refused"] = (await recorded(host, port, {
            "prompt_tokens": [1, 2, 3], "max_new_tokens": 4,
            "tenant": "late"}))[0]
        out["readyz_draining"] = (await load_gen._fetch(host, port,
                                                        "/readyz"))[0]
        out["inflight"] = await inflight
        await draining
        try:
            await asyncio.open_connection(host, port)
            out["closed"] = False
        except OSError:
            out["closed"] = True
        return out

    load_gen._post_generate = recorded
    try:
        out, counts, sites = traced(lambda: asyncio.run(go()))
    finally:
        load_gen._post_generate = post
    eng = srv.engine
    reqs = sorted(eng.requests.values(), key=lambda r: r.req_id)
    report = out["report"]
    rid_of = {tuple(spec.prompt_tokens): rid      # the clients' requests
              for rid, _, spec in srv.admission_log if spec.tenant != "drain"}
    tag = f"{a.arch} live {a.scheduler}, {n_clients} clients" + (
        ", rate-limited, drained" if drain else "")
    for res in report.results:
        rid = rid_of.get(tuple(trace[res.index].prompt_tokens))
        mine = [t for r, t in srv.token_log if r == rid]
        if not (res.status == 200 and res.tokens == mine
                == list(eng.outputs[rid])):
            raise AssertionError(f"{tag}: request {res.index} (id {rid}): "
                                 f"status {res.status}, SSE {res.tokens}, "
                                 f"token_log {mine}")
    scraped = [parse_metrics(body.decode()) for status, body
               in out["scrapes"] if status == 200]
    if len(scraped) != len(out["scrapes"]) or not all(
            any(k.startswith(f"repro_{f}") for k in m)
            for m in scraped[-1:] for f in ("ttft", "tbt",
                                            "http_responses_total")):
        raise AssertionError(f"{tag}: /metrics: {len(scraped)} of "
                             f"{len(out['scrapes'])} scrapes parsed")
    if out["health"] != [200, 200]:
        raise AssertionError(f"{tag}: /healthz, /readyz {out['health']}")
    m = request_metrics(reqs)
    s = report.summary()
    # ms/iter over the clients' load (a drain's in-flight stream after it
    # is not timed)
    r = {"iterations": eng.iteration, "wall_s": out["elapsed"],
         "iterations_timed": out["iterations"],
         "ms_per_iter": out["elapsed"] * 1e3 / max(out["iterations"], 1),
         "expert_load_bytes": eng.expert_load_bytes,
         "completed": sum(q.finish_time is not None
                          and q.shed_reason is None for q in reqs),
         "requests": len(reqs),
         "outputs": {q.req_id: list(eng.outputs[q.req_id]) for q in reqs},
         "prompts": {q.req_id: list(q.prompt_tokens) for q in reqs},
         "max_new": {q.req_id: q.max_new_tokens for q in reqs},
         "plans": [plan_key(p) for p in srv.runtime.plans],
         "admission_log": list(srv.admission_log),
         "fault_counters": {}, "shed": {}, "arch": a.arch,
         "pages_left": eng.alloc.pages_in_use(),
         "host_pages_left": eng.alloc.host_pages_in_use(),
         "launches": counts, "host_syncs": sum(sites.values()),
         "host_sync_sites": dict(sites), "client": s,
         "n_429": report.n_429, "scrapes": len(scraped),
         "posts": collections.Counter(st for st, _ in seen),
         "retry_after_429": sorted({int(ra) for st, ra in seen
                                    if st == 429 and ra is not None}),
         **{k: m[k] for k in ("ttft_p50", "ttft_p99", "tbt_p50",
                              "tbt_p99")}}
    r["streams_sha256"] = streams_sha256(r["outputs"])
    r["state_bytes_per_slot"] = eng.state_bytes_per_slot
    r["cache_bytes"] = sum(t.numel() * t.element_size()
                           for t in _leaves(eng.cache))
    for key in ("refused", "readyz_draining", "closed"):
        if key in out:
            r[key] = out[key]
    if drain:
        status, _, events = out["inflight"]
        done = [d for k, d in events if k == "done"]
        r["inflight"] = (status, done[0]["n_generated"] if done else None,
                         done[0].get("shed_reason") if done else None)
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()
    check_served(tag, a, r, model.cfg.vocab_size)
    check_launches(tag, counts, RAGGED_PATH, RAGGED_PATH)
    if r["host_syncs"] > r["iterations"] + 2:
        raise AssertionError(f"{tag}: {r['host_syncs']} host syncs in "
                             f"{r['iterations']} iterations")
    if r["pages_left"]:
        raise AssertionError(f"{tag}: {r['pages_left']} pages in use after "
                             "the stop")
    ms = 1e3
    log(f"{tag}: {r['requests']} requests, {r['iterations']} iterations, "
        f"{r['ms_per_iter']:.1f} ms/iter over the load's "
        f"{r['iterations_timed']} in {r['wall_s']:.2f} s; TTFT "
        f"p50/p99 {r['ttft_p50'] * ms:.1f}/{r['ttft_p99'] * ms:.1f} ms, TBT "
        f"p50/p99 {r['tbt_p50'] * ms:.1f}/{r['tbt_p99'] * ms:.1f} ms; client "
        f"latency p50/p99 {s['latency_p50'] * ms:.1f}/"
        f"{s['latency_p99'] * ms:.1f} ms, time to first byte p50/p99 "
        f"{s['ttfb_p50'] * ms:.1f}/{s['ttfb_p99'] * ms:.1f} ms; POSTs by "
        f"status {dict(r['posts'])}, 429 Retry-After {r['retry_after_429']}"
        f"; {r['scrapes']} /metrics scrapes; expert-load "
        f"{r['expert_load_bytes'] / 1e6:.1f} MB, {r['host_syncs']} host "
        f"syncs {r['host_sync_sites']}, launches {counts}, token streams "
        f"sha256 {r['streams_sha256']}")
    return r


def replay_live(a, model, params, live: dict) -> dict:
    """The admission-log replay of a live serve (``load_gen.
    replay_admissions``: the same specs, each arriving at the engine
    iteration at which it entered the live scheduler, through a fresh
    engine on the same weights, on the iteration clock), its launches
    counted as a serve's.  Raises unless its plans are the live plans and
    its bf16 streams the live streams bit for bit."""
    import torch
    from repro_torch.launch.load_gen import (check_admission_replay,
                                             replay_admissions)
    rep, counts, sites = traced(lambda: replay_admissions(
        a, live["admission_log"], model, params))
    gc.collect()
    torch.cuda.empty_cache()
    parted = check_admission_replay(live["plans"], live["outputs"], rep)
    n = len(live["outputs"])
    log(f"admission-log replay: {len(rep['plans'])} plans, identical to the "
        f"live serve's; {n - parted}/{n} streams bit-identical; launches "
        f"{counts}, {sum(sites.values())} host syncs")
    if parted:
        raise AssertionError(f"admission-log replay: {parted} of {n} "
                             "streams parted from the live serve's")
    check_launches("admission-log replay", counts, RAGGED_PATH, RAGGED_PATH)
    return {"iterations": len(rep["plans"]), "launches": counts,
            "arch": a.arch, "streams_identical": n - parted,
            "host_syncs": sum(sites.values())}


def simulate(model, a, card: dict) -> dict:
    """Phase 4, the simulator (host only): ``serve_sim`` for qwen3-30b-a3b
    on the arXiv and ShareGPT length models at 1.3 req/s, 30 requests,
    layered and chunked (modelled layered expert bytes must be below
    chunked's on both); then the card's open-loop serve ``card`` (the
    trace of ``a`` on the iteration clock) replayed through
    ``SimExecutor`` with the engine's scheduler and page pool: its plan
    stream must be the card's, and its modelled ms/iter is printed beside
    the card's measured one."""
    import contextlib
    import io
    from repro_torch.launch.load_gen import plan_key
    from repro_torch.launch.serve import serve_sim
    from repro_torch.serving.cost_model import H100X2
    from repro_torch.serving.runtime import ServingRuntime, SimExecutor
    from repro_torch.serving.simulator import Simulator
    out = {}
    for ds in ("arxiv", "sharegpt"):
        for sched in ("layered", "chunked"):
            sc = dataclasses.replace(a, simulate=True, dataset=ds, rate=1.3,
                                     requests=30, scheduler=sched,
                                     open_loop=False)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                res = serve_sim(sc)
            for line in text.getvalue().splitlines():
                log(f"  {line}")
            out[f"{ds} {sched}"] = {
                "expert_bytes": res.total_expert_bytes,
                "iterations": res.n_iterations,
                "energy_per_token_mj": res.energy_per_token * 1e3}
        lay, chk = out[f"{ds} layered"], out[f"{ds} chunked"]
        log(f"simulator ({MODELLED}), {ds} at 1.3 req/s: layered / chunked "
            f"expert traffic {lay['expert_bytes'] / 1e12:.2f} / "
            f"{chk['expert_bytes'] / 1e12:.2f} TB")
        if not lay["expert_bytes"] < chk["expert_bytes"]:
            raise AssertionError(f"simulator, {ds}: layered expert bytes "
                                 "not below chunked")
    sim = Simulator(model.cfg, a.scheduler, H100X2,
                    **dict(a.sim_kwargs(), n_pages=card["n_pages"]))
    ex = SimExecutor(sim)
    durations, execute = [], ex.execute

    def priced(plan, now):
        outcome = execute(plan, now)
        durations.append(outcome.duration)
        return outcome
    ex.execute = priced
    rt = ServingRuntime(ex, clock="iteration", record_plans=True)
    rt.run(a.engine_trace(model.cfg.vocab_size), max_iterations=100_000)
    plans = [plan_key(p) for p in rt.plans]
    modelled = sum(durations) * 1e3 / max(len(durations), 1)
    log(f"cross-backend, open-loop trace on the iteration clock: "
        f"{len(plans)} SimExecutor plans, identical to the card engine's "
        f"{len(card['plans'])}: {plans == card['plans']}; ms/iter "
        f"{modelled:.2f} ({MODELLED}) beside {card['ms_per_iter']:.1f} "
        "measured on this card")
    if plans != card["plans"]:
        raise AssertionError("SimExecutor planned otherwise than the card's "
                             "engine on the same trace")
    out["cross-backend"] = {"plans": len(plans), "modelled_ms_per_iter":
                            modelled, "measured_ms_per_iter":
                            card["ms_per_iter"]}
    return out


def serve_live(model, params, runs: dict, times: dict, t0) -> dict:
    """Phase 4, the JAX launcher's remaining serving modes at
    qwen3-30b-a3b width: the live HTTP/SSE serve (4 clients over
    ``ServeConfig.engine_trace``: 8 Poisson arrivals at 1.3 req/s,
    layered) held against the replay of its admission log, bit for bit,
    and reported against ``load_gen``'s offline replay; the same 8
    requests from 8 clients under a rate limit of 2 req/s (burst 2), then
    drained; the short trace per slice (``packed=False``) beside the
    packed serve; and the simulator."""
    from repro_torch.launch import load_gen
    from repro_torch.launch.serve import ServeConfig
    _, short = serve_configs(model.cfg.name)
    wall = ServeConfig(arch=model.cfg.name, open_loop=True, clock="wall",
                       requests=8, rate=1.3, max_len=2048, slots=8,
                       quantum=512, token_budget=512, seed=0)
    trace = wall.engine_trace(model.cfg.vocab_size)
    live = runs["live layered"] = live_serve(wall, model, params, trace, 4)
    rep = runs["live layered, admission-log replay"] = replay_live(
        wall, model, params, live)
    offline_toks = load_gen.offline_tokens(wall, trace, model, params)
    by_index = {tuple(spec.prompt_tokens): rid
                for rid, _, spec in live["admission_log"]}
    rids = [by_index[tuple(tr.prompt_tokens)] for tr in trace]
    offline = {"outputs": {rid: offline_toks[i]
                           for i, rid in enumerate(rids)},
               "prompts": live["prompts"]}
    offline["streams_sha256"] = streams_sha256(offline["outputs"])
    out = {"live vs offline": compare_streams(
        model, params, live, offline, ("live", "offline"))}
    ol = runs.get("open-loop layered")
    log(f"live serve {live['ms_per_iter']:.1f} ms/iter over "
        f"{live['iterations']} iterations, beside the wall-clock open-loop "
        f"replay of the same trace: "
        + (f"{ol['ms_per_iter']:.1f} ms/iter over {ol['iterations']}"
           if ol else "not run"))
    t0 = _phase("qwen3 live serve", t0, times)

    bp = runs["live layered, rate-limited"] = live_serve(
        wall, model, params, trace, 8, drain=True, ratelimit_rate=2.0,
        ratelimit_burst=2.0)
    if not bp["retry_after_429"] or min(bp["retry_after_429"]) < 1:
        raise AssertionError(f"rate-limited serve: no 429 with a "
                             f"Retry-After: POSTs {dict(bp['posts'])}")
    if not (bp["refused"] == 503 and bp["readyz_draining"] == 503
            and bp["closed"]):
        raise AssertionError(f"drain: POST {bp['refused']}, /readyz "
                             f"{bp['readyz_draining']}, listener closed "
                             f"{bp['closed']}")
    if bp["inflight"] != (200, 64, None):
        raise AssertionError(f"drain: the in-flight stream ended "
                             f"{bp['inflight']}")
    log(f"backpressure: {bp['n_429']} rate-limit retries, 429 Retry-After "
        f"{bp['retry_after_429']} s; every request completed; while "
        f"draining a POST got {bp['refused']} and /readyz "
        f"{bp['readyz_draining']}, the in-flight stream ended "
        f"{bp['inflight']}, then the listener closed")
    t0 = _phase("qwen3 backpressure and drain", t0, times)

    ps = runs["short ragged/layered, per-slice"] = run_serve(
        dataclasses.replace(short, scheduler="layered", packed=False),
        model, params)
    pk = runs["short ragged/layered"]
    if ps["plans"] != pk["plans"]:
        raise AssertionError("per-slice serve planned otherwise than the "
                             "packed serve")
    if not ps["n_dispatches"] > pk["n_dispatches"]:
        raise AssertionError(f"per-slice dispatches {ps['n_dispatches']}, "
                             f"packed {pk['n_dispatches']}")
    log(f"per-slice / packed (short trace, layered): {ps['n_dispatches']} / "
        f"{pk['n_dispatches']} launches, {ps['n_prefill_dispatches']} / "
        f"{pk['n_prefill_dispatches']} prefill batches, plans identical; "
        f"{ps['ms_per_iter']:.1f} / {pk['ms_per_iter']:.1f} ms/iter")
    out["per-slice vs packed"] = compare_streams(
        model, params, ps, pk, ("per-slice", "packed"))
    t0 = _phase("qwen3 per-slice serve", t0, times)

    virt = dataclasses.replace(wall, clock="virtual")
    card = runs["open-loop layered, iteration clock"] = run_serve(
        virt, model, params)
    out["simulator"] = simulate(model, virt, card)
    _phase("qwen3 simulator", t0, times)
    return out


def serve_gpt_oss(times: dict) -> dict:
    """Phase 4b: gpt-oss-20b at full width (after qwen3 is freed: the two
    do not fit on one 80 GB card together)."""
    import torch
    base, short = serve_configs("gpt-oss-20b")
    model, params, t0 = build_logged(base, "gpt-oss", times)
    runs = {}
    for sched in ("layered", "chunked"):
        runs[f"gpt-oss ragged/{sched}"] = run_serve(
            dataclasses.replace(base, scheduler=sched), model, params)
    runs["gpt-oss short dense/layered"] = run_serve(
        dataclasses.replace(short, scheduler="layered", moe_dispatch="dense"),
        model, params)
    lay, chk = runs["gpt-oss ragged/layered"], runs["gpt-oss ragged/chunked"]
    if not lay["expert_load_bytes"] <= chk["expert_load_bytes"]:
        raise AssertionError("gpt-oss: layered expert-load exceeds chunked")
    log(f"gpt-oss layered / chunked expert-load "
        f"{lay['expert_load_bytes'] / 1e6:.1f} / "
        f"{chk['expert_load_bytes'] / 1e6:.1f} MB "
        f"({lay['expert_load_bytes'] / chk['expert_load_bytes']:.3f}); "
        f"{_same_streams(lay, chk)}")
    _phase("gpt-oss serves", t0, times)
    del model, params
    torch.cuda.empty_cache()
    return {"runs": runs}


def large_moe_depth(arch: str, a) -> int:
    """The depth of ``arch`` (at full width, bf16) that the card's free
    memory holds beside the serve's cache (``a.slots`` rows of
    ``a.max_len``), the decode step's transients (MLA: the decompressed
    keys and values of every slot row, one layer at a time) and 6 GB for
    the prefill's activations; the reckoning is logged."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    free, total = torch.cuda.mem_get_info()
    kv_layer = cfg.kv_bytes_per_token(2) / cfg.n_layers * a.slots * a.max_len
    m = cfg.mla
    transient = (a.slots * a.max_len * cfg.n_heads * 2
                 * (2 * m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim)
                 if m.enabled else 0)

    def weights(n):
        return 2 * dataclasses.replace(cfg, n_layers=n).param_count()

    def need(n):
        return weights(n) + kv_layer * n + transient + 6e9
    depth = cfg.n_layers
    while depth > 2 and need(depth) > free:
        depth -= 1
    specs = cfg.block_specs()
    per = {sp.ffn: 2 * (cfg.attn_param_count(sp) + cfg.ffn_param_count(sp))
           for sp in specs}
    log(f"{arch}: bf16 weights {weights(cfg.n_layers) / 1e9:.2f} GB at "
        f"{cfg.n_layers} layers (a layer: "
        + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in per.items())
        + f"; embeddings and head {weights(0) / 1e9:.2f} GB), cache "
        f"{kv_layer / 1e6:.1f} MB a layer, decode transients "
        f"{transient / 1e9:.2f} GB, 6 GB for activations; the card has "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free: depth {depth} of "
        f"{cfg.n_layers} (cut: {need(depth) / 1e9:.2f} GB needed)")
    return depth


def serve_large_moe(times: dict) -> dict:
    """Phase 5b: the registry's two large MoE models at full width, at the
    depth the card holds (after gpt-oss is freed).  deepseek-v2-236b
    (MLA: K2 and K3 at (192, 128); 160 experts top-6 and 2 shared; a
    dense block 0) serves the long trace layered and chunked on the ragged
    dispatch, and the short trace layered on the dense and on the ragged
    dispatch (the same expert bytes and streams); qwen3-moe-235b-a22b
    (64/4 heads: g 16) the long trace layered and chunked.  Layered
    expert-load <= chunked on each."""
    import torch
    runs, depths = {}, {}
    for arch, label in (("deepseek-v2-236b", "deepseek"),
                        ("qwen3-moe-235b-a22b", "qwen3-235b")):
        base, short = serve_configs(arch)
        depth = depths[arch] = large_moe_depth(arch, base)
        model, params, t0 = build_logged(base, label, times, n_layers=depth)
        for sched in ("layered", "chunked"):
            runs[f"{label} ragged/{sched}"] = run_serve(
                dataclasses.replace(base, scheduler=sched), model, params)
        lay, chk = runs[f"{label} ragged/layered"], runs[f"{label} ragged/chunked"]
        if not lay["expert_load_bytes"] <= chk["expert_load_bytes"]:
            raise AssertionError(f"{label}: layered expert-load exceeds "
                                 "chunked")
        log(f"{label} ({depth} layers) layered / chunked expert-load "
            f"{lay['expert_load_bytes'] / 1e6:.1f} / "
            f"{chk['expert_load_bytes'] / 1e6:.1f} MB "
            f"({lay['expert_load_bytes'] / chk['expert_load_bytes']:.3f}; "
            f"{model.cfg.expert_bytes(2) / 1e6:.2f} MB an expert); "
            f"{_same_streams(lay, chk)} (bf16 streams may part at router "
            "near-ties: reported, not asserted)")
        if label == "deepseek":
            for disp in ("dense", "ragged"):
                runs[f"{label} short {disp}/layered"] = run_serve(
                    dataclasses.replace(short, scheduler="layered",
                                        moe_dispatch=disp), model, params)
            dl = runs[f"{label} short dense/layered"]
            rl = runs[f"{label} short ragged/layered"]
            if (dl["expert_load_bytes"] != rl["expert_load_bytes"]
                    or dl["outputs"] != rl["outputs"]):
                raise AssertionError(
                    f"{label} short trace, layered: dense and ragged differ: "
                    f"{_same_streams(dl, rl)}, expert-load "
                    f"{dl['expert_load_bytes']} / {rl['expert_load_bytes']} B")
            log(f"{label} short trace, layered: dense / ragged expert-load "
                f"{dl['expert_load_bytes'] / 1e6:.1f} / "
                f"{rl['expert_load_bytes'] / 1e6:.1f} MB, "
                f"{_same_streams(dl, rl)}; {dl['ms_per_iter']:.1f} / "
                f"{rl['ms_per_iter']:.1f} ms/iter")
        _phase(f"{label} serves", t0, times)
        del model, params, lay, chk
        gc.collect()
        torch.cuda.empty_cache()
    return {"runs": runs, "depths": depths}


def dense_param_bytes(cfg, n_layers=None) -> int:
    """bf16 bytes of a dense GQA decoder's weights: attention, SwiGLU and
    two norms per layer, the embedding (and an untied head)."""
    d, hd, f = cfg.d_model, cfg.head_dim_, cfg.d_ff
    per_layer = (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * d + 3 * d * f + 2 * d)
    head = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) + d
    return 2 * ((n_layers or cfg.n_layers) * per_layer + head)


# phi4-mini-3.8b serves at 16 of its 32 layers (full depth until phase
# 10d joined: 21.0 s of the script)
PHI4_SERVE_LAYERS = 16


def serve_dense(times: dict) -> dict:
    """Phase 6: the dense GQA decoders at full width, after the MoE
    models are freed.  phi4-mini-3.8b (``PHI4_SERVE_LAYERS`` of 32 layers,
    24/8 heads of 128: K2
    and K3 at g 3) serves the short trace layered and chunked and the
    n-gram serves of ``ngram_serves``; then yi-34b (56/8 heads of
    128: g 7; 68.8 GB of bf16 weights) serves the short trace layered, at
    full depth where the card's free memory holds it, else at the depth
    it holds (the cut is logged)."""
    import torch
    from repro_torch.configs import get_config
    runs = {}
    _, short = serve_configs("phi4-mini-3.8b")
    model, params, t0 = build_logged(short, "phi4-mini", times,
                                     n_layers=PHI4_SERVE_LAYERS)
    for sched in ("layered", "chunked"):
        runs[f"phi4-mini short/{sched}"] = run_serve(
            dataclasses.replace(short, scheduler=sched), model, params)
    ngram_serves(model, params, runs, "phi4-mini ")
    lay, chk = runs["phi4-mini short/layered"], runs["phi4-mini short/chunked"]
    log(f"phi4-mini layered / chunked: {_same_streams(lay, chk)}")
    spec = compare_streams(model, params, runs["phi4-mini spec ngram"],
                           runs["phi4-mini spec off, ngram trace"],
                           ("ngram", "off"))
    t0 = _phase("phi4-mini serves", t0, times)
    del model, params, lay, chk
    gc.collect()
    torch.cuda.empty_cache()

    _, short = serve_configs("yi-34b")
    cfg = get_config("yi-34b")
    free, total = torch.cuda.mem_get_info()
    # the KV cache of 8 slots of max_len, and 3 GB for activations
    kv = (2 * 2 * cfg.n_layers * short.slots * short.max_len
          * cfg.n_kv_heads * cfg.head_dim_)
    need = dense_param_bytes(cfg) + kv + 3e9
    depth = cfg.n_layers
    while depth > 1 and (dense_param_bytes(cfg, depth) + kv * depth
                         / cfg.n_layers + 3e9) > free:
        depth -= 1
    log(f"yi-34b: weights {dense_param_bytes(cfg) / 1e9:.2f} GB in bf16, KV "
        f"cache {kv / 1e9:.2f} GB, with 3 GB for activations "
        f"{need / 1e9:.2f} GB; the card has {free / 1e9:.2f} of "
        f"{total / 1e9:.2f} GB free: depth {depth} of {cfg.n_layers}"
        + ("" if depth == cfg.n_layers else " (cut)"))
    model, params, t0 = build_logged(
        short, "yi-34b", times,
        n_layers=None if depth == cfg.n_layers else depth)
    runs["yi-34b short/layered"] = run_serve(
        dataclasses.replace(short, scheduler="layered"), model, params)
    _phase("yi-34b serve", t0, times)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "yi_depth": depth, "spec": spec}


# a bf16 logit gap, in ulps of the top logit, below which two serves of
# one request may choose different tokens (other batch shapes round
# otherwise): a near-tie.  A request started from another's recurrent
# state parts from its stream alone at its first token, by far more.
NEAR_TIE_ULPS = 8.0


# xlstm-1.3b serves at 16 of its 48 layers (14 mLSTM + 2 sLSTM blocks;
# full depth until phase 10d joined: 26.4 s of the script)
XLSTM_SERVE_LAYERS = 16


def serve_recurrent(times: dict) -> dict:
    """Phase 7: the recurrent models at full width and depth, after the
    earlier models are freed.  recurrentgemma-9b (26 RG-LRU + 12 local
    attention blocks, 16/1 heads of 256: K2 and K3 at (256, 256), g 16,
    window 2048) serves the long trace at max_len 4096 (4 prompts of
    2100-3500 tokens, 16 new: the window binds) layered and chunked, a
    slot-reuse serve (12 requests of the short trace with 48 new tokens
    on 8 slots in 64 pages: recompute preemption), a swap serve (its
    first 8 requests, swap preemption), and each of the 12 requests alone
    on a fresh engine: every stream of the reuse and the swap serve must
    equal its stream alone or part at a near-tie (the gap recomputed by
    one bf16 prefill, in ulps).  Then xlstm-1.3b (``XLSTM_SERVE_LAYERS``
    of its 48 blocks) serves the short trace layered and chunked,
    launching none of the six kernels."""
    import torch
    from repro_torch.serving.traffic import TraceRequest
    runs = {}
    base, short = serve_configs("recurrentgemma-9b")
    base = dataclasses.replace(base, max_len=4096, prompt_len=(2100, 3501))
    model, params, t0 = build_logged(base, "recurrentgemma", times)
    for sched in ("layered", "chunked"):
        runs[f"recurrentgemma long/{sched}"] = run_serve(
            dataclasses.replace(base, scheduler=sched), model, params)
    lay, chk = (runs["recurrentgemma long/layered"],
                runs["recurrentgemma long/chunked"])
    log(f"recurrentgemma long trace layered / chunked: "
        f"{_same_streams(lay, chk)}; {lay['ms_per_iter']:.1f} / "
        f"{chk['ms_per_iter']:.1f} ms/iter")
    t0 = _phase("recurrentgemma long serves", t0, times)

    # 64 pages of 16 tokens with a decode reserve of one token: two
    # preemptions in either mode (the schedule depends only on lengths,
    # n_layers and the stash factor, rehearsed on a stand-in)
    pressure = dataclasses.replace(short, scheduler="layered",
                                   new_tokens=(48, 49), pages=64,
                                   decode_reserve=1)
    reuse = runs["recurrentgemma reuse/recompute"] = run_serve(
        dataclasses.replace(pressure, requests=12, preemption="recompute"),
        model, params)
    swap = runs["recurrentgemma swap"] = run_serve(
        dataclasses.replace(pressure, requests=8, preemption="swap"), model,
        params)
    if not reuse["n_preempted"] > 0:
        raise AssertionError("recurrentgemma reuse serve: no preemption")
    if not swap["n_swapped_in"] == swap["n_swapped_out"] > 0:
        raise AssertionError(f"recurrentgemma swap serve: swapped out/in "
                             f"{swap['n_swapped_out']}/"
                             f"{swap['n_swapped_in']}")
    alone = {"outputs": {}, "prompts": reuse["prompts"]}
    for rid, prompt in reuse["prompts"].items():
        n_new = reuse["max_new"][rid]
        r = run_serve(dataclasses.replace(pressure, open_loop=True,
                                          requests=1, pages=None,
                                          decode_reserve=None),
                      model, params,
                      trace=[TraceRequest(0.0, len(prompt), n_new,
                                          prompt_tokens=tuple(prompt))])
        alone["outputs"][rid] = r["outputs"][0]
    t0 = _phase("recurrentgemma reuse, swap and alone serves", t0, times)
    parted = {}
    for label, run in (("reuse", reuse), ("swap", swap)):
        mine = {"outputs": run["outputs"], "prompts": run["prompts"]}
        rows = explain_divergence(model, params, mine,
                                  {"outputs": {rid: alone["outputs"][rid]
                                               for rid in run["outputs"]}},
                                  labels=(label, "alone"))
        parted[label] = [(row["req"], row["position"],
                          row["chosen_gap_ulps"]) for row in rows]
        log(f"recurrentgemma {label} serve against each request alone: "
            f"{_same_streams(run, {'outputs': alone['outputs']})}; partings "
            f"(request, new-token position, chosen-token gap in bf16 ulps) "
            f"{parted[label]} (near-tie below {NEAR_TIE_ULPS} ulps)")
        far = [p for p in parted[label] if not p[2] <= NEAR_TIE_ULPS]
        if far:
            raise AssertionError(f"recurrentgemma {label} serve parts from "
                                 f"the requests served alone away from a "
                                 f"near-tie: {far}")
    t0 = _phase("recurrentgemma stream comparison", t0, times)
    del model, params, lay, chk
    gc.collect()
    torch.cuda.empty_cache()

    _, short = serve_configs("xlstm-1.3b")
    model, params, t0 = build_logged(short, "xlstm", times,
                                     n_layers=XLSTM_SERVE_LAYERS)
    for sched in ("layered", "chunked"):
        runs[f"xlstm short/{sched}"] = run_serve(
            dataclasses.replace(short, scheduler=sched), model, params)
    lay, chk = runs["xlstm short/layered"], runs["xlstm short/chunked"]
    log(f"xlstm short trace layered / chunked: {_same_streams(lay, chk)}; "
        f"{lay['ms_per_iter']:.1f} / {chk['ms_per_iter']:.1f} ms/iter")
    _phase("xlstm serves", t0, times)
    del model, params, lay, chk
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "parted": parted}


def whisper_frames(seed: int, d_model: int):
    """Request i's encoder frames (n_frames, d_model): normal x 0.01,
    drawn from (seed, i)."""
    import numpy as np

    def frames(i):
        rng = np.random.default_rng([seed, i])
        return (rng.standard_normal((WHISPER_FRAMES, d_model))
                * 0.01).astype(np.float32)
    return frames


def check_partings(model, params, label: str, run: dict, other: dict,
                   labels, enc=None) -> list:
    """Where ``run``'s streams part from ``other``'s, the chosen tokens'
    logit gap by one bf16 prefill (``explain_divergence``); raises unless
    every parting sits at a near-tie (``NEAR_TIE_ULPS``).  Returns
    (request, new-token position, gap in ulps) per parting."""
    rows = explain_divergence(model, params,
                              {"outputs": run["outputs"],
                               "prompts": run["prompts"]},
                              {"outputs": {rid: other["outputs"][rid]
                                           for rid in run["outputs"]}},
                              labels=labels, enc=enc)
    parted = [(row["req"], row["position"], row["chosen_gap_ulps"])
              for row in rows]
    log(f"{label}: {_same_streams(run, other)}; partings (request, new-token "
        f"position, chosen-token gap in bf16 ulps) {parted} (near-tie below "
        f"{NEAR_TIE_ULPS} ulps)")
    far = [p for p in parted if not p[2] <= NEAR_TIE_ULPS]
    if far:
        raise AssertionError(f"{label}: streams part away from a near-tie: "
                             f"{far}")
    return parted


def serve_whisper(times: dict) -> dict:
    """Phase 8: whisper-base at full width and depth (6 encoder + 6
    decoder layers, d_model 512, 8/8 heads of 64, 1500 frames; learned
    positions), each request's frames seeded (``whisper_frames``): 12
    short-trace requests with 48 new tokens on 8 slots in 64 pages under
    recompute preemption (a victim re-encodes at re-admission) and under
    swap preemption (the cross K/V go to host memory and come back
    whole), each rehearsed on a 6-layer stand-in with the same stash
    factor to preempt (3 recompute preemptions; 3 swaps); each of the 12
    served alone; then the
    two-pool layered/stream serve and the monolithic layered serve of the
    same 8 requests (the cross K/V move whole with each handoff).  Every
    stream of the reuse, swap and two-pool serves must equal its
    yardstick's (alone; monolithic) or part at a near-tie.  Every serve
    launches K2 and K3 only (the encoder and cross-attention prefill: K2
    non-causal; cross decode: K3 over the 1500 frames), syncs the host
    once per iteration and installs cross K/V once per admission."""
    import torch
    runs = {}
    _, short = serve_configs("whisper-base")
    model, params, t0 = build_logged(short, "whisper", times)
    frames = whisper_frames(short.seed, model.cfg.d_model)
    pressure = dataclasses.replace(short, scheduler="layered",
                                   new_tokens=(48, 49), pages=64,
                                   decode_reserve=1)
    reuse = runs["whisper reuse/recompute"] = run_serve(
        dataclasses.replace(pressure, requests=12, preemption="recompute"),
        model, params, frames=frames)
    swap = runs["whisper swap"] = run_serve(
        dataclasses.replace(pressure, requests=12, preemption="swap"), model,
        params, frames=frames)
    if not reuse["n_preempted"] > 0:
        raise AssertionError("whisper reuse serve: no preemption")
    if not swap["n_swapped_in"] == swap["n_swapped_out"] > 0:
        raise AssertionError(f"whisper swap serve: swapped out/in "
                             f"{swap['n_swapped_out']}/{swap['n_swapped_in']}")
    alone = {"outputs": {}}
    for rid, prompt in reuse["prompts"].items():
        r = run_serve(dataclasses.replace(pressure, requests=1, pages=None,
                                          decode_reserve=None),
                      model, params,
                      jobs=[(prompt, reuse["max_new"][rid], frames(rid))])
        alone["outputs"][rid] = r["outputs"][0]
    t0 = _phase("whisper reuse, swap and alone serves", t0, times)

    a = dataclasses.replace(disagg_config("whisper-base"), scheduler="layered")
    two = runs["whisper two-pool layered/stream"] = run_disagg_serve(
        a, model, params, frames=frames)
    mono = runs["whisper two-pool yardstick, layered"] = run_serve(
        dataclasses.replace(a, disagg=False), model, params, frames=frames)
    t0 = _phase("whisper two-pool serves", t0, times)
    with torch.no_grad():
        enc = {rid: model.encode(params, torch.from_numpy(frames(rid))[None]
                                 .cuda()) for rid in range(12)}
    parted = {label: check_partings(model, params, f"whisper {label}", run,
                                    other, labels, enc)
              for label, run, other, labels in (
                  ("reuse vs alone", reuse, alone, ("reuse", "alone")),
                  ("swap vs alone", swap, alone, ("swap", "alone")),
                  ("two-pool vs monolithic", two, mono,
                   ("two-pool", "monolithic")))}
    _phase("whisper stream comparison", t0, times)
    del model, params, enc
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "parted": parted}


def serve_qwen2_vl(times: dict) -> dict:
    """Phase 8b: qwen2-vl-72b at full width (d_model 8192, 64/8 heads of
    128: g 8, M-RoPE, d_ff 29568, vocab 152064 untied), text-only as the
    JAX engine serves it, at the depth the card's free memory holds (the
    reckoning is logged, as for the large MoE models): the long trace
    layered and chunked, launching K2 and K3 only."""
    import torch
    runs = {}
    base, _ = serve_configs("qwen2-vl-72b")
    depth = large_moe_depth("qwen2-vl-72b", base)
    model, params, t0 = build_logged(base, "qwen2-vl", times, n_layers=depth)
    for sched in ("layered", "chunked"):
        runs[f"qwen2-vl long/{sched}"] = run_serve(
            dataclasses.replace(base, scheduler=sched), model, params)
    lay, chk = runs["qwen2-vl long/layered"], runs["qwen2-vl long/chunked"]
    log(f"qwen2-vl ({depth} layers) long trace layered / chunked: "
        f"{_same_streams(lay, chk)}; {lay['ms_per_iter']:.1f} / "
        f"{chk['ms_per_iter']:.1f} ms/iter")
    _phase("qwen2-vl serves", t0, times)
    del model, params, lay, chk
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "depth": depth}


# the profiled serve runs the first 8 of qwen3's 48 layers: the
# training phase's 64-90 s were paid for by halving this 107 s phase, the
# two profiled training steps' ~17 s (the backward rows' ~14 s on top)
# by a third of what was left, phase 10c by halving it again and phase
# 10d by halving it once more (14.4 s at 8; the serves whose streams are
# compared across trees keep their depth)
PROFILE_LAYERS = 4


def first_layers(model, params, n: int):
    """(model, params) of the first ``n`` blocks of a one-segment stack:
    the segment's stacked leaves sliced (views, no copy), the embedding
    and head shared."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import DecoderModel
    if len(model.segments) != 1:
        raise ValueError("first_layers takes a one-segment stack")
    cut = DecoderModel(dataclasses.replace(model.cfg, n_layers=n),
                       device=model.device)
    seg = params["segments"][0]
    cut_params = dict(params, segments=[
        {"pattern": ops.tree_map(lambda a: a[:n], seg["pattern"])}])
    log(f"profile at {n} of {model.cfg.n_layers} layers (depth cut to pay "
        f"for the training phase)")
    return cut, cut_params


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



# ---------------------------------------------------------------- phase 9
# training: K2 and K4 with their hand-written backward kernels

# the backward kernels against their fp32 plain versions on the same bf16
# inputs: relative Frobenius per gradient (P and dS, or H, dG and dU, are
# rounded to bf16 for the tensor cores, and every gradient to bf16)
BWD_REL_FRO = 2e-2
# step 1 of a full-size model in bf16 against the same step in fp32
# through the plain versions on the card, from the same weights and batch
# (predicted before its first run in PERF.md §6): the loss and ce
# of a random model (about ln V) move by bf16 rounding of the logits only,
# well under 1e-2 of their value; the grad norm sums every bf16 gradient
# (routing near-ties at qwen3 move some tokens' experts), within 5e-2
TRAIN_LOSS_REL = 1e-2
TRAIN_GNORM_REL = 5e-2
MINICPM_TRAIN_ATTN = (36, 36, 64)      # MHA: g 1
TRAIN_B, TRAIN_SEQ = 8, 256            # the training launcher's defaults
# the batches after the run's that phase 9 holds out: the trained model's
# mean ce over them must lie below the initial model's.  Each step's own
# ce is another batch's, and between two batches it moves by as much as
# 20 steps lower it (minicpm-2b at 12 layers: step 1 against step 20 fell
# at two of four seeds of the draw before the counter-based one and at
# three of four of this one; over these batches every run fell, by 0.022
# to 0.156; PERF.md §6)
TRAIN_HELD_OUT = 8


def held_out_ce(model, params, batches) -> float:
    """The mean masked next-token ce of ``params`` over ``batches`` (host
    batches), without gradients."""
    import torch
    from repro_torch.training.train import device_batch, loss_fn
    total = 0.0
    with torch.no_grad():
        for b in batches:
            d = device_batch(model, *b)
            _, m = loss_fn(model, params, d["tokens"], d["targets"],
                           d["mask"], enc_out=d.get("enc_out"))
            total += float(m["ce"])
    return total / len(batches)
# qwen3's dense dispatch at the launcher's 2048 tokens: C = ceil(2048 * 8
# / 128 * 1.25) = 160
QWEN3_TRAIN_C = 160


def _train_pairs(b: int, p: int, s_max: int, window, causal: bool) -> int:
    """(query, key) pairs of attention without a cache (offset 0): causal
    under an optional window, or every query over all S_max keys."""
    if not causal:
        return b * p * s_max
    return b * sum(min(i + 1, window or p) for i in range(p))


def _sdpa_train(qt, kt, vt, mask, is_causal, dot, iters: int):
    """SDPA's forward and its forward + backward through autograd minus
    its forward, in ms over ``iters`` calls each: the yardstick (every
    training shape here has a backend that takes it)."""
    import torch
    import torch.nn.functional as F

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=is_causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    return (cuda_time(fwd, iters=iters),
            cuda_time(fwd_bwd, iters=iters) - cuda_time(fwd, iters=iters))


def check_prefill_attention_bwd(tag: str, gen, b: int, p: int, heads,
                                s_max=None, window=None,
                                causal: bool = True) -> list:
    """K2's forward with the log-sum-exp and its backward at a training
    path's contract (no cache: offset 0; S_max = P for self-attention,
    or the encoder's frames with ``causal=False``; ``heads`` is (H, Hkv,
    hd) or (H, Hkv, hd, hd_v)), against the plain versions; two launches
    bit for bit; timed beside the plain backward and SDPA's backward
    (forward + backward through autograd, minus its forward; KV repeated
    g-major; the window as a boolean mask).  Returns the forward row (with
    the log-sum-exp) and the backward row."""
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd, hd_v = _heads(heads)
    s_max = s_max or p
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn(s, device=dev, generator=gen).to(torch.bfloat16)
                   for s in ((b, p, h, hd), (b, s_max, hkv, hd),
                             (b, s_max, hkv, hd_v), (b, p, h, hd_v)))
    off = torch.zeros(b, dtype=torch.int32, device=dev)
    kw = dict(window=window, causal=causal)
    out, lse = ops._prefill_forward(q, k, v, off, window, causal, True)
    plain_out = ops.prefill_attention(q, k, v, off, **kw)
    want_lse = ref.prefill_attention_lse_ref(q, k, v, off, **kw)
    torch.cuda.synchronize()
    lse_err = (lse - want_lse).abs().max().item()
    if not torch.equal(out, plain_out):
        raise AssertionError(f"prefill_attention[{tag}]: the output with "
                             "the log-sum-exp differs from the output without")
    if not lse_err <= 1e-4:
        raise AssertionError(f"prefill_attention[{tag}]: log-sum-exp off by "
                             f"{lse_err}")
    got = ops.prefill_attention_bwd(q, k, v, out, lse, do, off, **kw)
    again = ops.prefill_attention_bwd(q, k, v, out, lse, do, off, **kw)
    want = ref.prefill_attention_bwd_ref(q, k, v, out, lse, do, off, **kw)
    torch.cuda.synchronize()
    rels, max_abs = {}, 0.0
    for name, g_, a_, w_ in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(g_, a_):
            raise AssertionError(f"prefill_attention_bwd[{tag}]: two launches "
                                 f"differ in {name}")
        d_ = g_.float() - w_.float()
        rels[name] = (d_.norm() / w_.float().norm()).item()
        max_abs = max(max_abs, d_.abs().max().item())
    # the CTAs of each pass as the C entry reports launching them: dK/dV
    # one per (key tile, kv head, row, head group), each walking the query
    # heads of its group; the sums of the groups' partials; dQ
    ctas = dict(ops.GRIDS["prefill_attention_bwd"])
    split = ctas.pop("split")
    log(f"prefill_attention_bwd[{tag}] B {b} P {p} S_max {s_max} {h}/{hkv} "
        f"heads of {hd}/{hd_v}{f' window {window}' if window else ''}"
        f"{'' if causal else ' non-causal'}: rel Frobenius "
        f"{({k_: f'{v_:.3e}' for k_, v_ in rels.items()})} (tol "
        f"{BWD_REL_FRO}), max abs {max_abs:.3e}; forward log-sum-exp max abs "
        f"{lse_err:.3e}; split {split}, CTAs {ctas}")
    if max(rels.values()) > BWD_REL_FRO:
        raise AssertionError(f"prefill_attention_bwd[{tag}] disagrees: {rels}")
    del want, again
    pairs = _train_pairs(b, p, s_max, window, causal) * h
    # inputs q, k, v, o, dO and the log-sum-exp read once, dq, dk, dv
    # written once; five products of a pair: S, dK, dQ over hd and dP, dV
    # over hd_v
    nbytes = 2 * (2 * (q.numel() + k.numel() + v.numel()) + out.numel()
                  + do.numel()) + 4 * lse.numel()
    flops = 2 * (3 * hd + 2 * hd_v) * pairs
    b_ms, b_by = bound_ms(nbytes, flops)
    # 20 launches, and as many of each yardstick: at the training shapes a
    # launch's device time (~0.1 ms) is near the wrapper's host time, so a
    # short run times the host
    iters = 20
    ms = cuda_time(lambda: ops.prefill_attention_bwd(q, k, v, out, lse, do,
                                                     off, **kw), iters=iters)
    log(f"prefill_attention_bwd[{tag}]: {ms:.4f} ms, "
        f"{flops / ms / 1e9:.1f} TFLOP/s of the five products")
    plain = cuda_time(lambda: ref.prefill_attention_bwd_ref(
        q, k, v, out, lse, do, off, **kw), iters=2)
    g = h // hkv
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt = k.transpose(1, 2).repeat(1, g, 1, 1).detach().requires_grad_(True)
    vt = v.transpose(1, 2).repeat(1, g, 1, 1).detach().requires_grad_(True)
    mask = None
    if causal and window:
        pos = torch.arange(s_max, device=dev)
        mask = ((pos[None, :] <= pos[:p, None])
                & (pos[None, :] > pos[:p, None] - window))
    lib_fwd, lib = _sdpa_train(qt, kt, vt, mask, causal and not window,
                               do.transpose(1, 2), iters)
    del qt, kt, vt, mask
    mask_note = ("is_causal" if causal and not window else
                 "a boolean window mask" if causal else "no mask")
    fwd_bytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * lse.numel()
    fb_ms, fb_by = bound_ms(fwd_bytes, 2 * (hd + hd_v) * pairs)
    fwd_ms = cuda_time(lambda: ops._prefill_forward(q, k, v, off, window,
                                                    causal, True), iters=iters)
    fwd_plain = cuda_time(lambda: (ref.prefill_attention_ref(q, k, v, off, **kw),
                                   ref.prefill_attention_lse_ref(q, k, v, off,
                                                                 **kw)),
                          iters=2)
    shape = {"B": b, "P": p, "S_max": s_max, "offsets": 0, "H": h, "Hkv": hkv,
             "hd": hd, "hd_v": hd_v, "window": window, "causal": causal}
    return [{"name": f"prefill_attention[{tag}, lse]", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/prefill_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:78",
             "max_abs_err": (out.float() - ref.prefill_attention_ref(
                 q, k, v, off, **kw).float()).abs().max().item(),
             "lse_max_abs_err": lse_err, "ms": fwd_ms, "plain_ms": fwd_plain,
             "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": lib_fwd,
             "library_note": f"SDPA forward, {mask_note}, KV repeated "
                             "g-major",
             "shape": shape},
            {"name": f"prefill_attention_bwd[{tag}]", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/prefill_attention_bwd.cu",
             "replaces": "src/repro/kernels/flash_attention.py:78",
             "replaces_note": "the vjp of that kernel's function: the JAX "
                              "package has no backward Pallas kernel",
             "max_abs_err": max_abs, "rel_fro_err": rels, "ms": ms,
             "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib,
             "library_note": f"SDPA ({mask_note}, KV repeated g-major) "
                             "forward + backward through autograd minus "
                             "its forward",
             "split": split, "ctas": ctas,
             "achieved_tflops": flops / ms / 1e9, "shape": shape}]


# K2's backward at (64, 64) and (128, 128) on inputs built by integer
# hashing (``hashed_bf16``): the sha256 of dq, dk and dv at minicpm-2b's
# and qwen3-30b-a3b's training shapes (the latter split into 4 head
# groups), one at P off the tiles (g 3) and one at g 8 over one kv head.
# The digest was taken from the wgmma kernel on an H100 on its first run
# (the mma.sync kernel it replaced summed in another order and gave
# deb003311f295bc6); a change that moves these bits must say why.
# (B, P, H, Hkv, hd)
K2_BWD_CASES = ((8, 256, 36, 36, 64), (8, 256, 32, 4, 128),
                (2, 300, 12, 4, 64), (1, 200, 8, 1, 128))
K2_BWD_SHA256 = "243cb0d6e10c6ce6"


def k2_bwd_digest() -> str:
    """sha256 (first 16 hex digits) of K2's backward on K2_BWD_CASES."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    h = hashlib.sha256()
    for n, (b, p, nh, hkv, hd) in enumerate(K2_BWD_CASES):
        q = hashed_bf16((b, p, nh, hd), 4 * n, dev)
        k = hashed_bf16((b, p, hkv, hd), 4 * n + 1, dev)
        v = hashed_bf16((b, p, hkv, hd), 4 * n + 2, dev)
        do = hashed_bf16((b, p, nh, hd), 4 * n + 3, dev)
        off = torch.zeros(b, dtype=torch.int32, device=dev)
        out, lse = ops._prefill_forward(q, k, v, off, None, True, True)
        for g in ops.prefill_attention_bwd(q, k, v, out, lse, do, off):
            h.update(g.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def check_moe_gmm_bwd(tag: str, c: int, gen, widths=QWEN3_MOE) -> dict:
    """K4's backward over the dense (E, C, d) buffer against its plain
    version; two launches bit for bit; timed beside the plain version and
    the cuBLAS chain (bf16 torch.bmm calls with the elementwise steps)."""
    import torch
    from repro_torch.kernels import ops, ref
    e, _, d, f = widths
    dev = torch.device("cuda")
    args = (torch.randn((e, c, d), device=dev, generator=gen).to(torch.bfloat16),
            expert_weights((e, d, f), gen), expert_weights((e, d, f), gen),
            expert_weights((e, f, d), gen))
    dy = torch.randn((e, c, d), device=dev, generator=gen).to(torch.bfloat16)
    padded = ops.PAD_COPIES["moe_gmm_bwd"]
    got = ops.moe_gmm_bwd(*args, dy)
    again = ops.moe_gmm_bwd(*args, dy)
    want = ref.moe_gmm_bwd_ref(*args, dy)
    torch.cuda.synchronize()
    rels, max_abs = {}, 0.0
    for name, g_, a_, w_ in zip(("dx", "dwg", "dwu", "dwd"), got, again, want):
        if not torch.equal(g_, a_):
            raise AssertionError(f"moe_gmm_bwd[{tag}]: two launches differ "
                                 f"in {name}")
        d_ = g_.float() - w_.float()
        rels[name] = (d_.norm() / w_.float().norm()).item()
        max_abs = max(max_abs, d_.abs().max().item())
    pad = ops.PAD_COPIES["moe_gmm_bwd"] - padded
    # the C entry's report of its launches: CTAs of kernels 1 and 2 (row
    # tiles by F or d columns) and of the two persistent weight-gradient
    # launches, the row tile and the weight-gradient output tiles
    ctas = dict(ops.GRIDS["moe_gmm_bwd"])
    log(f"moe_gmm_bwd[{tag}] E {e} C {c} d {d} F {f}: rel Frobenius "
        f"{({k_: f'{v_:.3e}' for k_, v_ in rels.items()})} (tol "
        f"{BWD_REL_FRO}), max abs {max_abs:.3e}; padded copies {pad}; "
        f"CTAs {ctas}")
    if max(rels.values()) > BWD_REL_FRO:
        raise AssertionError(f"moe_gmm_bwd[{tag}] disagrees: {rels}")
    del want, again
    # x, the three weights and dY read once; dx and the three weight
    # grads written once; eight products of 2 E C d F flops (G, U, dH, dX
    # twice, dWg, dWu, dWd)
    nbytes = 2 * (3 * args[0].numel() + 6 * args[1].numel())
    flops = 8 * 2 * e * c * d * f
    b_ms, b_by = bound_ms(nbytes, flops)
    # 10 launches of the kernel and of the chain
    iters = 10
    ms = cuda_time(lambda: ops.moe_gmm_bwd(*args, dy), iters=iters)
    log(f"moe_gmm_bwd[{tag}]: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s of "
        f"the eight products, {b_ms / ms:.3f} of the bound ({b_by})")
    plain = cuda_time(lambda: ref.moe_gmm_bwd_ref(*args, dy), iters=2)
    x, wg, wu, wd = args

    def chain():
        g = torch.bmm(x, wg)
        u = torch.bmm(x, wu)
        s = torch.sigmoid(g)
        dh = torch.bmm(dy, wd.transpose(1, 2))
        h = g * s * u
        dg = dh * u * s * (1 + g * (1 - s))
        du = dh * g * s
        return (torch.bmm(dg, wg.transpose(1, 2))
                + torch.bmm(du, wu.transpose(1, 2)),
                torch.bmm(x.transpose(1, 2), dg),
                torch.bmm(x.transpose(1, 2), du),
                torch.bmm(h.transpose(1, 2), dy))
    chain_ms = cuda_time(chain, iters=iters)
    return {"name": f"moe_gmm_bwd[{tag}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
            "replaces": "src/repro/kernels/moe_gmm.py:45",
            "replaces_note": "the vjp of that kernel's function: the JAX "
                             "package has no backward Pallas kernel",
            "max_abs_err": max_abs, "rel_fro_err": rels, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes the backward of "
                            "a per-expert fused SwiGLU",
            "cublas_chain_ms": chain_ms,
            "cublas_chain_note": "eight bf16 torch.bmm calls with the "
                                 "elementwise steps, timed as the kernel is: "
                                 "a yardstick of several calls, not "
                                 "library_ms",
            "padded_copies": pad, "ctas": ctas,
            "achieved_tflops": flops / ms / 1e9,
            "shape": {"E": e, "C": c, "d": d, "F": f}}


def small_train_configs():
    """Five small models at the backward kernels' contracts, bf16: a dense
    one at minicpm-2b's head shape (4/4 heads of 64: g 1, tied
    embeddings) and a MoE one at qwen3-30b-a3b's (8/1 heads of 128: g 8;
    a dense first block, then 8 experts top-2 of d_ff 128 under the dense
    dispatch at capacity factor E / k = 4, which drops nothing).  Without
    drops a token that bf16 routes otherwise at a near-tie changes its own
    output only: under capacity drops it also moves the drop ranking of
    the tokens after it (seen: 137 against 136 drops, then block 1 routes
    tokens otherwise at fp32 margins up to 0.015), and the comparison
    would measure that cascade, not the kernels.  The dropping path is
    held by phase 9's qwen3 and deepseek runs against their fp32
    yardsticks.  Then phase 3's small MLA model (K2 at (192, 128); its 8
    experts top-2 at capacity factor 4 for the same reason), its small
    RG-LRU + local model (16/1 heads of 256, window 32 < the 128-token
    sequence: the window binds) and its small whisper model (cross-
    attention over 150 frames: K2 without the causal mask, its last key
    tile partial)."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    base = dict(n_layers=2, d_model=256, d_ff=512, vocab_size=1024,
                max_seq_len=512, dtype="bfloat16", param_dtype="bfloat16")
    mla = small_mla_config()
    return [ModelConfig(name="train-dense-small", family="dense", n_heads=4,
                        n_kv_heads=4, head_dim=64, tie_embeddings=True,
                        **base).validate(),
            ModelConfig(name="train-moe-small", family="moe", n_heads=8,
                        n_kv_heads=1, head_dim=128, dense_block_ids=(0,),
                        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=128,
                                      capacity_factor=4.0),
                        **base).validate(),
            dataclasses.replace(mla, name="train-mla-small",
                                moe=dataclasses.replace(
                                    mla.moe, capacity_factor=4.0)).validate(),
            small_recurrent_configs()[0], small_encdec_configs()[0]]


def _grads_of(model, params, batch, record: list, pinned=None):
    """(metrics, gradient leaves) of ``loss_fn`` at ``params``: each MoE
    block's own (expert ids, probabilities) recorded.  With ``pinned``
    (the expert ids of a model's one MoE block) every token takes those
    experts instead, weighted by its own renormalised router
    probabilities: the routes of another run, so that a comparison of
    gradients does not measure a near-tie's flip."""
    import torch
    from repro_torch.models import moe
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train import loss_fn
    leaves = tree_leaves(params)
    for p_ in leaves:
        p_.requires_grad_(True)
    route = moe.route

    def recorded(*args):
        out = route(*args)
        record.append((out[0].detach().cpu(), out[2].detach().float().cpu()))
        if pinned is not None:
            idx = pinned.to(out[0].device)
            w = out[2].gather(1, idx)
            out = (idx, w / w.sum(dim=-1, keepdim=True), out[2])
        return out
    moe.route = recorded
    try:
        loss, m = loss_fn(model, params, batch["tokens"], batch["targets"],
                          batch["mask"], batch.get("enc_out"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        moe.route = route
        for p_ in leaves:
            p_.requires_grad_(False)
    return ({k: float(v.detach()) for k, v in m.items()},
            [torch.zeros_like(p_) if g is None else g.detach()
             for p_, g in zip(leaves, grads)])


def check_small_training_end_to_end() -> None:
    """Each of ``small_train_configs`` trains 5 steps in bf16 on the card
    (K2 and its backward, and K4 and its backward) and in fp32 on the CPU
    (plain versions) from the same weights and ``PackedDataset`` batches:
    every loss within ``E2E_REL_FRO``; step 1's gradients leaf by leaf
    within ``E2E_REL_FRO`` relative Frobenius, the card's MoE block
    pinned to the fp32 side's routes (a token routed otherwise changes its
    whole contribution to every gradient: 7 of 512 tokens flipped at
    margins under 1e-3 moved the small MLA model's leaves by ~0.1).  Every
    token's own expert set is recorded on both sides (under the remat's
    recompute too): a token routed otherwise must sit at a router near-tie
    (``ROUTER_TIE``), at most one token in 16.  The encoder-decoder model
    takes seeded frames (normal, rounded to bf16), the same on both sides,
    so that its cross-attention's gradients are not zero."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import DecoderModel
    from repro_torch.training.data import PackedDataset, SyntheticCorpus
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train import device_batch, make_train_step
    for cfg in small_train_configs():
        gpu = DecoderModel(cfg, device="cuda", remat=True)
        params = gpu.init_params(torch.Generator(device="cuda").manual_seed(1))
        cpu = DecoderModel(dataclasses.replace(cfg, dtype="float32",
                                               param_dtype="float32"),
                           device="cpu")
        p_cpu = ops.tree_map(lambda a: a.float().cpu(), params)
        ds = iter(PackedDataset(SyntheticCorpus(cfg.vocab_size, seed=0),
                                seq_len=128, batch_size=4, seed=0))
        host = [next(ds) for _ in range(5)]
        ra, rb = [], []
        b_cpu, b_gpu = (device_batch(cpu, *host[0]),
                        device_batch(gpu, *host[0]))
        if cfg.encoder.enabled:
            frames = torch.from_numpy(np.random.default_rng(7).standard_normal(
                tuple(b_cpu["enc_out"].shape)).astype(np.float32)).bfloat16()
            b_cpu["enc_out"] = frames.float()
            b_gpu["enc_out"] = frames.cuda()
        mc, gc_ = _grads_of(cpu, p_cpu, b_cpu, rb)
        if len(rb) > 1:
            raise AssertionError(f"{cfg.name}: pinning takes one MoE block")
        ops.reset_launches()
        mg, gg = _grads_of(gpu, params, b_gpu, ra,
                           pinned=rb[0][0] if rb else None)
        launched = dict(ops.LAUNCHES)
        need = ["prefill_attention", "prefill_attention_bwd"]
        if cfg.moe.enabled:
            need += ["moe_gmm", "moe_gmm_bwd"]
        check_launches(f"{cfg.name} step 1", launched, need, need)
        k = cfg.moe.top_k
        flipped, margins = [], []
        # the forward's routes (the remat's recompute repeats them)
        for (ia, _), (ib, pb) in zip(ra[:len(rb)], rb):
            alike = (ia.sort(-1).values == ib.sort(-1).values).all(-1)
            top = pb.sort(-1, descending=True).values
            margin = top[:, k - 1] - top[:, k]
            flipped += (~alike).nonzero().flatten().tolist()
            margins += margin[~alike].tolist()
        n_tok = host[0][0].size
        rel = {}
        for i, (a, b_) in enumerate(zip(gg, gc_)):
            bf = b_.float()
            rel[i] = ((a.float().cpu() - bf).norm()
                      / max(bf.norm().item(), 1e-30)).item()
        worst = max(rel.values())
        log(f"{cfg.name} step 1, bf16 kernels vs fp32 CPU: loss "
            f"{mg['loss']:.6f} / {mc['loss']:.6f}, dropped {mg['dropped']:.0f}"
            f" / {mc['dropped']:.0f}; gradients rel Frobenius worst {worst:.3e}"
            f" over {len(rel)} leaves (tol {E2E_REL_FRO}); tokens routed "
            f"otherwise {len(flipped)} of {n_tok} per block, fp32 router "
            f"margins {[round(m_, 6) for m_ in margins]} (near-tie below "
            f"{ROUTER_TIE}); launches {launched}")
        if (len(flipped) > max(1, n_tok // 16)
                or any(m_ >= ROUTER_TIE for m_ in margins)):
            raise AssertionError(f"{cfg.name}: tokens routed otherwise, not "
                                 f"at router near-ties: {margins}")
        if not worst <= E2E_REL_FRO:
            raise AssertionError(f"{cfg.name}: step 1 gradients disagree: "
                                 f"{rel}")
        opt = adamw(lr=1e-3, schedule="wsd", total_steps=5, warmup=1)
        losses = []
        for model, p_, dev in ((gpu, params, "cuda"), (cpu, p_cpu, "cpu")):
            step, state, out = (make_train_step(model, opt,
                                                cfg.encoder.enabled),
                                opt.init(p_), [])
            for hb in host:
                p_, state, m = step(p_, state, device_batch(model, *hb))
                out.append(float(m["loss"]))
            losses.append(out)
        rels = [abs(a - b_) / b_ for a, b_ in zip(*losses)]
        log(f"{cfg.name} 5 steps: losses bf16 card {[round(x, 5) for x in losses[0]]}"
            f", fp32 CPU {[round(x, 5) for x in losses[1]]}; worst rel "
            f"{max(rels):.3e} (tol {E2E_REL_FRO})")
        if not (all(math.isfinite(x) for x in losses[0])
                and max(rels) <= E2E_REL_FRO):
            raise AssertionError(f"{cfg.name}: training losses disagree")


def _plain_kernels():
    """The plain versions in place of K2 and K4 on the card, for the fp32
    yardstick (``chip_smoke.py`` only; the trainer's path never does
    this): returns a function that puts the kernels back."""
    from repro_torch.kernels import ops, ref
    saved = ops.prefill_attention, ops.moe_gmm

    def attn(q, k, v, offset, *, window=None, causal=True):
        return ref.prefill_attention_ref(q, k, v, offset, window=window,
                                         causal=causal)
    ops.prefill_attention, ops.moe_gmm = attn, ref.moe_gmm_ref

    def restore():
        ops.prefill_attention, ops.moe_gmm = saved
    return restore


def fp32_yardstick(cfg, params, host_batch):
    """Step 1's loss, ce, aux_loss, dropped and grad norm in fp32 through
    the plain versions on the card, from the same weights (converted) and
    batch, with remat: the yardstick of the bf16 kernel step.  Also the
    indices of the leaves whose gradient is zero (whisper's encoder and
    cross K/V projections: the batch's ``enc_out`` is zeros)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import DecoderModel
    from repro_torch.training.train import device_batch
    model = DecoderModel(dataclasses.replace(cfg, dtype="float32",
                                             param_dtype="float32"),
                         device="cuda", remat=True)
    p32 = ops.tree_map(lambda a: a.float(), params)
    back = _plain_kernels()
    try:
        m, grads = _grads_of(model, p32, device_batch(model, *host_batch), [])
    finally:
        back()
    sq = torch.zeros((), dtype=torch.float32, device="cuda")
    for g in grads:
        sq = sq + torch.sum(torch.square(g.float()))
    m["grad_norm"] = float(torch.sqrt(sq))
    unreached = {i for i, g in enumerate(grads) if not bool(g.any())}
    del p32, grads
    gc.collect()
    torch.cuda.empty_cache()
    return m, unreached


def train_model(arch: str, times: dict, steps: int, n_layers=None,
                ckpt: bool = False, profile: bool = False) -> dict:
    """Phase 9: ``arch`` at full width (``n_layers`` cuts its depth) trains
    ``steps`` steps as ``python -m repro_torch.launch.train`` does (batch 8
    x 256 tokens of ``PackedDataset``, WSD at lr 6e-4, remat on), through
    ``Trainer.fit`` logging every step.  Checks: every loss finite, the
    mean ce over ``TRAIN_HELD_OUT`` batches no step trains on lower after
    the steps than before them, the weight matrices moved, launches of the training
    path's kernels only, host syncs one per logged step, and step 1's
    loss, ce and grad norm against ``fp32_yardstick``.  With ``ckpt``: the
    state after the last step saved and restored, and the next step taken
    from the restored state equal, bit for bit, to the step taken
    without the round trip.  With ``profile``: one more step under
    torch.profiler (``profile_train_step``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import DecoderModel
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.data import PackedDataset, SyntheticCorpus
    from repro_torch.training.optimizer import adamw, tree_leaves
    from repro_torch.training.train import Trainer
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers).validate()
    model = DecoderModel(cfg, device="cuda", remat=True)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p_.numel() for p_ in tree_leaves(params))
    ds = iter(PackedDataset(SyntheticCorpus(cfg.vocab_size, seed=0),
                            seq_len=TRAIN_SEQ, batch_size=TRAIN_B, seed=0))
    host = [next(ds) for _ in range(steps + 1 + TRAIN_HELD_OUT)]
    held = host[steps + 1:]
    torch.cuda.synchronize()
    log(f"train {cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"params ({torch.cuda.memory_allocated() / 1e9:.1f} GB bf16) in "
        f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    yard, unreached = fp32_yardstick(cfg, params, host[0])
    t_yard = time.perf_counter() - t1
    ce_before = held_out_ce(model, params, held)
    opt = adamw(lr=6e-4, schedule="wsd", total_steps=steps + 1,
                warmup=max((steps + 1) // 10, 1))
    trainer = Trainer(model=model, opt=opt, params=params)
    # the first 2^20 elements of every weight matrix the loss reaches (a
    # norm's scale of 1.0 may stay: a step of lr <= 6e-4 moves it by less
    # than half a bf16 ulp, as under JAX; a leaf of zero gradient moves by
    # weight decay alone, less than that)
    probe = {i: p_.reshape(-1)[:1 << 20].clone()
             for i, (name, p_) in enumerate(zip(ck.leaf_names(params),
                                                tree_leaves(params)))
             if p_.dim() >= 2 and not name.endswith(("scale", "bias"))
             and i not in unreached}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    hist, launches, sites = traced(
        lambda: trainer.fit(iter(host[:steps]), steps, log_every=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() / 1e9
    first, last = hist[0], hist[-1]
    s_step = [b_["wall"] - a_["wall"] for a_, b_ in zip(hist, hist[1:])]
    log(f"train {cfg.name}: {steps} steps in {wall:.1f} s, "
        f"{float(np.median(s_step)) if s_step else wall:.3f} s a step "
        f"(median after step 1), peak memory {peak:.1f} GB; host syncs "
        f"{dict(sites)}")
    for h_ in hist:
        log(f"  step {h_['step']:3d} loss {h_['loss']:.5f} ce {h_['ce']:.5f} "
            f"aux {h_['aux_loss']:.5f} dropped {h_['dropped']:.0f} grad_norm "
            f"{h_['grad_norm']:.4f} lr {h_['lr']:.2e}")
    rel = {k: abs(first[k] - yard[k]) / abs(yard[k])
           for k in ("loss", "ce", "grad_norm")}
    log(f"train {cfg.name} step 1 against the fp32 yardstick (plain "
        f"versions on the card, {t_yard:.1f} s): loss {first['loss']:.5f} / "
        f"{yard['loss']:.5f}, ce {first['ce']:.5f} / {yard['ce']:.5f}, "
        f"grad norm {first['grad_norm']:.4f} / {yard['grad_norm']:.4f}, "
        f"dropped {first['dropped']:.0f} / {yard['dropped']:.0f}, leaves of "
        f"zero gradient {len(unreached)}; rel "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tol loss, ce "
        f"{TRAIN_LOSS_REL}, grad norm {TRAIN_GNORM_REL})")
    if not all(math.isfinite(h_["loss"]) for h_ in hist):
        raise AssertionError(f"train {cfg.name}: a loss is not finite")
    ce_after = held_out_ce(model, trainer.params, held)
    log(f"train {cfg.name}: ce over {len(held)} held-out batches "
        f"{ce_before:.5f} before, {ce_after:.5f} after {steps} steps (each "
        f"step's own batch: step 1 {first['ce']:.5f}, the last "
        f"{last['ce']:.5f})")
    if not ce_after < ce_before:
        raise AssertionError(f"train {cfg.name}: ce did not fall over the "
                             f"held-out batches ({ce_before} -> {ce_after})")
    if (rel["loss"] > TRAIN_LOSS_REL or rel["ce"] > TRAIN_LOSS_REL
            or rel["grad_norm"] > TRAIN_GNORM_REL):
        raise AssertionError(f"train {cfg.name}: step 1 off its fp32 "
                             f"yardstick: {rel}")
    now = tree_leaves(trainer.params)
    moved = sum(not torch.equal(p_, now[i].reshape(-1)[:1 << 20])
                for i, p_ in probe.items())
    if moved != len(probe):
        raise AssertionError(f"train {cfg.name}: {len(probe) - moved} of "
                             f"{len(probe)} matrices did not move")
    need = ["prefill_attention", "prefill_attention_bwd"]
    if cfg.moe.enabled:
        need += ["moe_gmm", "moe_gmm_bwd"]
    check_launches(f"train {cfg.name}", launches, need, need)
    if sum(sites.values()) > steps + 2:
        raise AssertionError(f"train {cfg.name}: {sum(sites.values())} host "
                             f"syncs in {steps} logged steps: {dict(sites)}")
    del probe
    run = {"arch": f"{arch} train", "iterations": steps, "launches": launches,
           "host_syncs": sum(sites.values()), "n_layers": cfg.n_layers,
           "params_b": n_params / 1e9, "s_per_step": (float(np.median(s_step))
                                                     if s_step else wall),
           "peak_gb": peak, "step1": first, "last": last, "yardstick": yard,
           "step1_rel": rel, "held_out_ce": (ce_before, ce_after)}
    if ckpt:
        run["checkpoint"] = checkpoint_round_trip(trainer, host[steps])
    if profile:
        run["profile"] = profile_train_step(trainer, host[steps], cfg.name)
    _phase(f"train {arch}", t0, times)
    return run


# the CUDA kernels of the two backward wrappers' launches, by name (each
# in its source's anonymous namespace: PyTorch has a reduce_kernel too)
BWD_KERNELS = {"prefill_attention_bwd": ("rowstat_kernel", "dkdv_kernel",
                                         "reduce_kernel", "dq_kernel"),
               "moe_gmm_bwd": ("gate_up_dh_kernel", "dx_kernel",
                               "wgrad_kernel")}


def profile_train_step(trainer, host_batch, label: str) -> dict:
    """One training step of ``trainer`` on ``host_batch`` under
    torch.profiler: device time by kernel; the share of the step's device
    time in each backward kernel's launches (``BWD_KERNELS``); the
    optimizer update's span on the device (two CUDA events around it: the
    profiler's attribution of kernels to a ``record_function`` range
    counted more device time than the step had at qwen3) as a share of
    the step's wall time; and the device's idle share of that wall time
    (host clock, synchronised, under the profiler).  The step runs through
    a second ``Trainer`` over the same parameters and moments, whose
    optimizer is the trainer's own with its update bracketed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.train import Trainer

    class Marked:
        def __init__(self, opt):
            self.opt = opt
            self.span = [torch.cuda.Event(enable_timing=True)
                         for _ in range(2)]

        def init(self, params):
            return self.opt.init(params)

        def update(self, *args, **kw):
            self.span[0].record()
            out = self.opt.update(*args, **kw)
            self.span[1].record()
            return out

    marked = Trainer(model=trainer.model, opt=Marked(trainer.opt),
                     params=trainer.params, opt_state=trainer.opt_state,
                     step=trainer.step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        marked.fit(iter([host_batch]), 1, log_every=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trainer.params, trainer.opt_state = marked.params, marked.opt_state
    opt_span = marked.opt.span[0].elapsed_time(marked.opt.span[1])
    kernels = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        if e.self_device_time_total > 0:
            kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    if busy <= 0:
        raise AssertionError(f"profile of a {label} training step: the "
                             "profiler recorded no device time")
    bwd = {w: sum(ms for ms, _, k in kernels
                  if any(f"(anonymous namespace)::{n}" in k for n in names))
           for w, names in BWD_KERNELS.items()}
    out = {"wall_ms": wall_ms, "busy_ms": busy,
           "idle_share": 1.0 - busy / wall_ms,
           "bwd_ms": bwd, "bwd_share": {w: v / busy for w, v in bwd.items()},
           "optimizer_span_ms": opt_span,
           "optimizer_share": opt_span / wall_ms,
           "top": [(round(ms, 3), n, k[:90]) for ms, n, k in kernels[:15]]}
    log(f"profile of one {label} training step: {wall_ms:.1f} ms wall under "
        f"the profiler, device busy {busy:.1f} ms (idle share "
        f"{out['idle_share']:.3f}); backward kernels "
        + ", ".join(f"{w} {v:.2f} ms ({out['bwd_share'][w]:.3f})"
                    for w, v in bwd.items())
        + f" of the busy time; the optimizer's span on the device "
        f"{opt_span:.2f} ms ({out['optimizer_share']:.3f} of the wall)")
    for ms, n, k in kernels[:15]:
        log(f"  {ms:10.3f} ms {n:6d} x  {k[:100]}")
    return out


def checkpoint_round_trip(trainer, host_batch) -> dict:
    """Save the trainer's state, take the next step, restore the state
    into fresh tensors and take the same step again: the metrics and every
    parameter must be equal bit for bit."""
    import tempfile
    import torch
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.optimizer import tree_leaves
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    path = str(Path(d) / "state.pt")
    t0 = time.perf_counter()
    ck.save(path, {"params": trainer.params, "opt": trainer.opt_state})
    t_save = time.perf_counter() - t0
    size = Path(path).stat().st_size
    step0 = trainer.step
    template = meta_tree({"params": trainer.params, "opt": trainer.opt_state})
    trainer.fit(iter([host_batch]), 1, log_every=1)
    want_m = trainer.history[-1]
    want_p = [p_.clone() for p_ in tree_leaves(trainer.params)]
    trainer.params = trainer.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state = ck.restore(path, template, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    trainer.params, trainer.opt_state = state["params"], state["opt"]
    trainer.step = step0
    trainer.fit(iter([host_batch]), 1, log_every=1)
    got_m = trainer.history[-1]
    same_p = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(trainer.params), want_p))
    keys = ("loss", "ce", "aux_loss", "dropped", "grad_norm", "lr")
    same_m = all(got_m[k] == want_m[k] for k in keys)
    Path(path).unlink()
    Path(d).rmdir()
    log(f"checkpoint: {size / 1e9:.2f} GB saved in {t_save:.1f} s, restored "
        f"in {t_load:.1f} s; step {step0 + 1} after the round trip: metrics "
        f"{'equal' if same_m else 'DIFFER'} ({ {k: got_m[k] for k in keys} } "
        f"vs { {k: want_m[k] for k in keys} }), parameters "
        f"{'equal' if same_p else 'DIFFER'}")
    if not (same_m and same_p):
        raise AssertionError("checkpoint round trip: the next step differs")
    del want_p
    return {"gb": size / 1e9, "save_s": t_save, "load_s": t_load}


def meta_tree(tree):
    """A tree of ``meta`` tensors shaped like ``tree`` (a restore
    template that holds no memory)."""
    import torch
    if isinstance(tree, dict):
        return {k: meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[meta_tree(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_tree(v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def train_depth(arch: str, period: int = 1) -> int:
    """The layers of ``arch`` one card trains at 12 B a parameter (bf16
    weights and grads, fp32 AdamW moments), embeddings and head included,
    keeping 12 GB for activations (remat), the fp32 logits and the
    optimizer's chunked temporaries: the most a multiple of ``period``
    (a block pattern's length) allows, up to the full depth; the
    reckoning is logged."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    free = torch.cuda.mem_get_info()[0]

    def params(n):
        return dataclasses.replace(cfg, n_layers=n).param_count()

    depth = cfg.n_layers
    while depth > period and 12 * params(depth) + 12e9 > free:
        depth = (depth - 1) // period * period
    log(f"{arch} training depth: {free / 1e9:.2f} GB free, "
        f"{(params(depth) - params(0)) / depth / 1e6:.1f} M params a layer "
        f"on average and {params(0) / 1e6:.1f} M in the embeddings and head, "
        f"12 B a parameter, 12 GB kept: {depth} of {cfg.n_layers} layers "
        f"({12 * params(depth) / 1e9:.1f} GB)")
    return depth


# minicpm-2b trains at 12 of its 40 layers (full depth until phase 10d
# joined: 65.1 s of the script, the checkpoint round trip 32.7 s of it)
MINICPM_TRAIN_LAYERS = 12


def train_models(times: dict) -> dict:
    """Phase 9: minicpm-2b at full width and ``MINICPM_TRAIN_LAYERS``
    layers (K2 and its backward,
    with a checkpoint round trip), then at full width and the depth the
    card holds: qwen3-30b-a3b (K2 at g 8 and K4, with their backwards),
    whisper-base (full depth; K2 causal and over the 1500 frames),
    recurrentgemma-9b (a multiple of its RG-LRU, RG-LRU, local pattern;
    K2 at (256, 256) under the window) and deepseek-v2-236b (its dense
    block 0 and the MoE blocks that fit; K2 at (192, 128) and K4).
    minicpm-2b and qwen3-30b-a3b each profile one more step."""
    import torch
    runs = {}
    # (arch, steps, its depth: full, cut, or the depth the card holds at
    # a multiple of the pattern's period, checkpoint round trip)
    for arch, steps, depth, ckpt in (
            ("minicpm-2b", 20, lambda: MINICPM_TRAIN_LAYERS, True),
            ("qwen3-30b-a3b", 10, lambda: train_depth("qwen3-30b-a3b", 1),
             False),
            # 100 steps: over 20 its held-out ce moves by +-0.015 (no
            # learning to measure), over 100 it falls 0.036-0.050 (PERF.md)
            ("whisper-base", 100, lambda: None, False),
            ("recurrentgemma-9b", 10,
             lambda: train_depth("recurrentgemma-9b", 3), False),
            ("deepseek-v2-236b", 10,
             lambda: train_depth("deepseek-v2-236b", 1), False)):
        runs[f"{arch} train"] = train_model(
            arch, times, steps=steps, ckpt=ckpt,
            profile=arch in ("minicpm-2b", "qwen3-30b-a3b"),
            n_layers=depth())
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- phase 10

SHARD_MESH = (2, 8)                    # (data, model): 16 ranks on one card
SHARD_B, SHARD_S, SHARD_CACHE = 2, 512, 1024
SHARD_DECODES, SHARD_P = 8, 256
SHARD_KERNELS = ("moe_gmm_ragged", "prefill_attention", "decode_attention",
                 "moe_gmm")


# a sharded phase's model: its serve depth, the layered row's block group
# and the deepest training step reckoned beside the pool (a named tuple:
# the card's tests load this file without registering it as a module,
# which a dataclass needs)
ShardPhase = collections.namedtuple(
    "ShardPhase", ("arch", "layers", "group", "train_max_layers", "s",
                   "cache", "dispatches", "kernels", "frames"),
    # the prefill's tokens a row and the cache rows; the MoE dispatches
    # its prefill runs; the kernels every rank must launch; whether the
    # prefill encodes frames (whisper)
    defaults=(SHARD_S, SHARD_CACHE, ("ragged", "dense"), SHARD_KERNELS,
              False))
# phase 10 (qwen3-30b-a3b: 2 of 48 layers since phase 10c joined, 4
# before, 8 before phase 10b; it trains 1, 2 before phase 10c: the card
# holds 3 beside 2 serve layers, at the script's time) and
# phase 10c (deepseek-v2-236b: its dense block 0 and one MoE block; a
# block with routed experts does not train beside the pool,
# ``sharded_train_depth`` reckons it)
QWEN3_SHARD = ShardPhase("qwen3-30b-a3b", 2, (0, 2), 1)
DEEPSEEK_SHARD = ShardPhase("deepseek-v2-236b", 2, (0, 2), 2)
# phase 10d, in the same pool after deepseek: recurrentgemma-9b's two
# RG-LRU blocks and its local-attention block over a 4096-row cache (512
# positions a rank on model 8), 2 x 2816 prompt tokens (JAX's "gqa"
# region: K2 under the window over the gathered cache), decodes at 2816-
# 2823 (the window starts at key 769: slice 0 sees nothing, slice 1 is
# cut; the split softmax, K3 with its log-sum-exp) and the layered row
# (K2 with its log-sum-exp over the slices); xlstm-1.3b's seven mLSTM
# blocks and its sLSTM block (2 x 512: chunkwise; no kernel); whisper-base
# whole (6 + 6), its 2 x 1500 seeded frames through the encoder at the
# prefill (K2 non-causal on each rank's head), decodes over the cross
# cache (one kv head a rank), and its training step at full depth (K2
# and its backward).  recurrentgemma and xlstm train on the CPU against
# JAX and in the dry-run only: a pool step at the three blocks that reach
# the local attention needs about 70 GB (the 2.1 B parameters of
# recurrentgemma's embedding and head, twice whole on the parent)
ATTN_KERNELS = ("prefill_attention", "decode_attention")
RECURRENTGEMMA_SHARD = ShardPhase("recurrentgemma-9b", 3, (0, 3), 0, s=2816,
                                  cache=4096, dispatches=("dense",),
                                  kernels=ATTN_KERNELS)
XLSTM_SHARD = ShardPhase("xlstm-1.3b", 8, (0, 8), 0, dispatches=("dense",),
                         kernels=())
WHISPER_SHARD = ShardPhase("whisper-base", 6, (0, 6), 6,
                           dispatches=("dense",), kernels=ATTN_KERNELS,
                           frames=True)
# the ranks' routes are pinned to the unsharded run's (``_pin_route``):
# each of a rank's MoE tokens takes the expert ids of the reference token
# nearest to it, which must lie within PIN_NEAR of that token's norm and
# at most 1 / PIN_APART as far as the next nearest (tokens of other rows
# or positions lie about 1.4 norms apart)
PIN_NEAR, PIN_APART = 0.25, 2.0
# each block's update (its output less its input), teacher-forced,
# against the unsharded block's, relative Frobenius over every token:
# sound blocks read at most 1.0e-2, planted faults 2.5e-2 to 3.4e-2
# (psum capacity binding despite dropless) and 5.5e-2 (decode lengths
# one short) in the blocks they touched (PERF.md §6)
BLOCK_TOL = 2e-2
# K3 at the sharded decode step's slices: 2 rows over 8 slices of 128
# positions of a 1024-row cache, lengths clamped to the slice (0 where the
# slice lies past the row)
LSE_SLICE = 128
# K3's log-sum-exp (fp32, about ln of the keys seen, 5-8 here) against
# its fp32 plain version: one 16-key tile missed among 1000 keys moves it
# by about 0.016; the first readings were 9.5e-7 (PERF.md §6)
LSE_ATOL = 1e-4
# K3's bf16 output, and the fp32 merge of its slices, against the plain
# version rounded to bf16: one bf16 ulp (2^-7 of the value) apart at most,
# atol for values near 0 (qwen3-30b-a3b's widths).  At MLA's (192, 128)
# the output is held to the kernel's contract, ATTN_TOL, as every other
# K3 row at those widths: K3 rounds P to bf16 before P.V
# (decode_attention.cu:249), which reached 2 ulps there (7.8e-3 over the
# 128-key slices, PERF.md §6)
OUT_TOL = dict(atol=1e-3, rtol=2 ** -7)


def check_decode_lse(gen, tag: str = "qwen3", heads=QWEN3_ATTN,
                     rows=(300, 1000), out_tol=OUT_TOL, s_max=2048,
                     len_range=(601, 1517), cache=SHARD_CACHE,
                     slice_len=LSE_SLICE, window=None) -> dict:
    """K3 with its log-sum-exp output at qwen3-30b-a3b's decode shapes
    (deepseek-v2-236b's: ``heads`` H = Hkv = 128 at (192, 128);
    recurrentgemma-9b's under its ``window``):
    (a) the 8-slot serve step (S_max ``s_max``), where the output must
    keep the bits of the call without the log-sum-exp; (b) the sharded
    decode step's slices (``slice_len`` positions of a ``cache``-row
    cache, two rows of ``rows`` tokens, lengths taken relative to the
    slice: clamped to it without a window, past it under one, so that the
    window's edge stays put; a slice that sees no key gives output 0 and
    log-sum-exp -inf), each against the plain version; and the slices of
    a split row merged from their (o, lse) against the unsplit call."""
    import torch
    from repro_torch.kernels import ops, ref
    h, hkv, hd, hd_v = _heads(heads)
    dev = torch.device("cuda")
    b = 8
    q = torch.randn((b, h, hd), device=dev, generator=gen).to(torch.bfloat16)
    kc, vc = (torch.randn((b, s_max, hkv, w), device=dev, generator=gen)
              .to(torch.bfloat16) for w in (hd, hd_v))
    lens = torch.randint(*len_range, (b,), device=dev, generator=gen,
                         dtype=torch.int32)
    plain_out = ops.decode_attention(q, kc, vc, lens, window=window)
    out, lse = ops.decode_attention(q, kc, vc, lens, window=window,
                                    return_lse=True)
    if not torch.equal(out, plain_out):
        raise AssertionError("decode_attention: asking for the log-sum-exp "
                             "changed the output's bits")
    want = ref.decode_attention_ref(q, kc, vc, lens, window=window)
    want_lse = ref.decode_attention_lse_ref(q, kc, lens, window=window)

    def excess(got, want):
        """max |got - want| and whether it lies within ``out_tol``."""
        d = (got.float() - want.float()).abs()
        ok = bool((d <= out_tol["atol"] + out_tol["rtol"]
                   * want.float().abs()).all())
        return d.max().item(), ok
    err, ok_out = excess(out, want)
    err_lse = (lse - want_lse).abs().max().item()
    # the sharded decode's slices: rank j holds positions [j*slice, ...)
    n_sl = cache // slice_len
    rows = torch.tensor(rows, dtype=torch.int64, device=dev)
    errs, errs_lse, zero_ok = [], [], True
    kq, vq = kc[:2, :cache].contiguous(), vc[:2, :cache].contiguous()
    parts, empty = [], 0
    for j in range(n_sl):
        lo = j * slice_len
        ln = (rows - lo).clamp(0, None if window else slice_len).to(
            torch.int32)
        ks = kq[:, lo:lo + slice_len].contiguous()
        vs = vq[:, lo:lo + slice_len].contiguous()
        o_j, l_j = ops.decode_attention(q[:2], ks, vs, ln, window=window,
                                        return_lse=True)
        e_j, ok_j = excess(o_j, ref.decode_attention_ref(q[:2], ks, vs, ln,
                                                         window=window))
        errs.append(e_j)
        ok_out = ok_out and ok_j
        wl_j = ref.decode_attention_lse_ref(q[:2], ks, ln, window=window)
        fin = torch.isfinite(wl_j)
        if not torch.equal(fin, torch.isfinite(l_j)):
            zero_ok = False
        if fin.any():
            errs_lse.append((l_j[fin] - wl_j[fin]).abs().max().item())
        seen_none = ~fin.any(-1)
        empty += int(seen_none.sum())
        if seen_none.any() and not (o_j[seen_none] == 0).all():
            zero_ok = False
        parts.append((o_j.float(), l_j))
    ls = torch.stack([p_[1] for p_ in parts])
    m = ls.max(0).values
    wts = torch.exp(ls - torch.where(torch.isfinite(m), m, 0.0))
    merged = (wts[..., None] * torch.stack([p_[0] for p_ in parts])).sum(0) \
        / wts.sum(0)[..., None]
    whole = ref.decode_attention_ref(q[:2], kq, vq, rows.to(torch.int32),
                                     window=window)
    err_merge, ok_merge = excess(merged, whole)
    err_lse = max([err_lse] + errs_lse)
    max_abs = max([err, err_lse, err_merge] + errs)
    name = f"decode_attention[{tag} sharded lse]"
    log(f"{name}: serve step B{b} S_max {s_max} window {window}"
        f" out max abs {err:.3e}, lse max abs {err_lse:.3e} over it and the "
        f"slices (tol {LSE_ATOL}; bits of the call without it kept); {n_sl} "
        f"slices of {slice_len}: out max abs {max(errs):.3e}, {empty} "
        f"(row, slice) pairs seeing no key, 0 / -inf: {zero_ok}; merged "
        f"slices vs unsplit {err_merge:.3e} (out and merge tol {out_tol})")
    if not (zero_ok and ok_out and ok_merge and err_lse <= LSE_ATOL):
        raise AssertionError("decode_attention with log-sum-exp disagrees")
    # the keys each row sees: its length (clamped to S_max), from the
    # window's edge on
    used = [min(int(n), s_max) - (max(0, int(n) - window) if window else 0)
            for n in lens.tolist()]
    nbytes = (q.numel() * 2 + out.numel() * 2 + lse.numel() * 4
              + sum(used) * hkv * (hd + hd_v) * 2 + b * 4)
    b_ms, b_by = bound_ms(nbytes, 2 * (hd + hd_v) * h * sum(used))
    # timed as check_decode_attention's ms_hot: CUDA graph replay over
    # one cache copy, beside the serve call without the log-sum-exp
    ms = cuda_time_cold(lambda i: ops.decode_attention(
        q, kc, vc, lens, window=window, return_lse=True), 1, rounds=48)
    ms_serve = cuda_time_cold(lambda i: ops.decode_attention(
        q, kc, vc, lens, window=window), 1, rounds=48)
    plain = cuda_time_cold(lambda i: (
        ref.decode_attention_ref(q, kc, vc, lens, window=window),
        ref.decode_attention_lse_ref(q, kc, lens, window=window)), 1,
        rounds=4)
    # SDPA gives no log-sum-exp: beside the row, timed as the kernel is,
    # on the serve step's output alone
    g = h // hkv
    kt, vt = (t.transpose(1, 2).repeat(1, g, 1, 1) for t in (kc, vc))
    pos = torch.arange(s_max, device=dev)[None, :]
    mask = pos < lens.clamp(max=s_max).long()[:, None]
    if window:
        mask = mask & (pos >= lens.long()[:, None] - window)
    mask = mask[:, None, None, :]
    sdpa = cuda_time_cold(lambda i: _sdpa_gmajor(q[:, :, None], kt, vt, mask),
                          1, rounds=48)
    del kt, vt
    log(f"{name}: {ms:.4f} ms with the "
        f"log-sum-exp, {ms_serve:.4f} ms without (graph, hot); SDPA "
        f"without it {sdpa:.4f} ms")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:85",
            "max_abs_err": max_abs, "ms": ms, "ms_without_lse": ms_serve,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "sdpa_ms_without_lse": sdpa,
            "timing": "CUDA graph replay, hot (one cache copy)",
            "shape": {"B": b, "S_max": s_max,
                      "lengths": [int(n) for n in lens.tolist()],
                      "keys_seen": used, "H": h,
                      "Hkv": hkv, "hd": hd, "hd_v": hd_v, "lse": True,
                      "window": window, "slice": slice_len,
                      "slice_rows": rows.tolist()}}


def _pin_route(route, queue: list, seen: dict):
    """``moe.route`` with each call's expert ids taken from the unsharded
    run's call in the same place: ``queue`` holds that run's (MoE input,
    expert ids) of each call still to come, in order.  Each of this
    rank's tokens takes the ids of the reference token nearest to it,
    weighted by its own renormalised router probabilities (phase 3's
    pinning); ``seen`` keeps the farthest match (relative to the
    reference token's norm) and the least ratio of the next nearest
    reference to the nearest, which the parent holds to ``PIN_NEAR`` and
    ``PIN_APART``."""
    def pinned(cfg, p, x):
        _, _, probs = route(cfg, p, x)
        return _matched(x, probs, *queue.pop(0), seen)
    return pinned


def _matched(x, probs, xr, ir, seen: dict):
    """(ids, weights, probs) of tokens ``x``: each takes the expert ids
    ``ir`` of its nearest reference token in ``xr``, weighted by its own
    renormalised probabilities; ``seen`` keeps the farthest match and the
    least ratio of the next nearest to the nearest (``_pin_route``)."""
    import torch
    d = torch.cdist(x.float(), xr.float())
    near = d.topk(min(2, d.shape[1]), dim=1, largest=False)
    d1 = near.values[:, 0]
    j = near.indices[:, 0]
    seen["near"] = max(seen["near"],
                       (d1 / xr.float().norm(dim=1)[j]).max().item())
    if d.shape[1] > 1:
        seen["apart"] = min(seen["apart"], (
            near.values[:, 1] / d1.clamp(min=1e-30)).min().item())
    idx = ir[j]
    w = probs.gather(1, idx)
    return idx, w / w.sum(dim=-1, keepdim=True), probs


def _teacher_forced(model, lp, mesh, rules, cases, queue, ph) -> dict:
    """Each block of each case run alone over this rank's shards from the
    unsharded run's input to that block (its rows and positions, in the
    residual layout) with that block's MoE calls (none in a dense block)
    pinned: the prefill (dense,
    then ragged, each into a fresh cache; whisper's with the unsharded
    run's encoder output, whose cross K/V are installed after it), the
    first decode step over the dense prefill's cache, and the layered row
    over the unsharded run's slot-0 row as the row found it.  Returns each
    block's output block."""
    import torch
    from repro_torch.convert import shard_cache
    from repro_torch.kernels import ops
    from repro_torch.sharding import spmd
    out = {}
    caches = {}
    for key, case in cases.items():
        b, s = case["b"], case["x"][0].shape[1]
        lay = spmd.layout(mesh, rules, b, s, ph.cache)
        if key.startswith("prefill"):
            cache = caches[key] = shard_cache(
                model.init_cache(SHARD_B, ph.cache), mesh, SHARD_B)
        elif key.startswith("decode"):
            cache = caches["prefill dense"]
        else:
            # the unsharded run's row before it (recurrent state carries
            # every decode step, not only the first replayed here), the
            # rank's own copy: a block of the parent's tensor may be a view
            # of it, which every data rank would write
            cache = ops.tree_map(torch.clone,
                                 shard_cache(case["row"], mesh, 1))
        b_r = b // SHARD_MESH[0] if lay.b_split else b
        r0 = mesh.coords["data"] * b_r if lay.b_split else 0
        pos = case["positions"][r0:r0 + b_r]
        off = case["offset"][r0:r0 + b_r]
        enc = case.get("enc")
        if enc is not None:
            enc = enc[r0:r0 + b_r]
        outs = []
        for i, x, pin in zip(case["blocks"], case["x"], case["pins"]):
            xl = spmd.take_seq(mesh, rules, x[r0:r0 + b_r], lay)
            queue[:] = pin
            y, _, _ = model.run_blocks(
                lp, xl, i, 1, positions=pos, offset=off, cache=cache,
                enc_out=enc, moe_dispatch=case["dispatch"], dropless=True,
                global_batch=b, cache_len=ph.cache)
            if queue:
                raise AssertionError(f"{key} block {i}: {len(queue)} MoE "
                                     "calls of the unsharded run not made")
            outs.append(y.float().cpu())
        if enc is not None:
            model.install_cross_kv(lp, cache, enc)
        out[key] = outs
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------- phase 10b

# one sharded training step of qwen3-30b-a3b at full width in phase 10's
# rank pool: the training launcher's 8 x 256 tokens (attention's "gqa"
# region, the a2a dense MoE), its WSD optimizer at step 1, remat per block
TRAIN_SHARD_B, TRAIN_SHARD_S = 8, 256
# every rank launches K2 and its backward, and where the depth holds a
# block with routed experts K4 and its backward (and no other kernel)
TRAIN_SHARD_KERNELS = ("prefill_attention", "prefill_attention_bwd")
TRAIN_SHARD_MOE_KERNELS = ("moe_gmm", "moe_gmm_bwd")
# per rank beside its shards, gradients and moments and its CUDA context
# (measured on the parent): one block's recompute, the vocab-split logits
# (4 rows x 256 x 18992 fp32) and their temporaries, the experts gathered
# at full width and their gradients, ZeRO-1's update chunks
# (a rank's peak less those read 0.32 GB at 2 layers on an H100; 0.5 GB
# kept)
TRAIN_SHARD_SLACK = 0.5e9
# Tolerances, stated before the first chip run (the sharded step and the
# unsharded one are two bf16 computations of the same step in other
# summation orders, routes pinned alike): each leaf's gradient and first
# moment within 5e-2 relative Frobenius (TRAIN_GNORM_REL's reason: the
# bf16 gradient norm's own spread), the second moment (squares) within
# twice that; parameters: AdamW's first step moves every element by about
# lr (6e-4, ~5 bf16 steps at the init's scale) by its gradient's sign, so
# elements whose gradient lies within the bf16 noise part by up to 2 lr:
# at most 5e-2 of a leaf's elements may lie more than one bf16 step apart
TRAIN_SHARD_GRAD_REL = 5e-2
TRAIN_SHARD_NU_REL = 1e-1
TRAIN_SHARD_PARAM_SHARE = 5e-2
# the seeds of the pool's serve and training weights
SERVE_SEED, TRAIN_SEED = 0, 1


def sharded_train_config(arch: str, n_layers: int):
    """``arch`` at full width, ``n_layers`` deep, its capacity raised to E
    / top_k so that neither the unsharded step nor the sharded one
    (group-wise capacity, JAX's semantics) drops an assignment."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    if not cfg.moe.enabled:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def sharded_train_depth(ph: ShardPhase, pool_alive: bool = False) -> tuple:
    """The depth of ``ph.arch`` the card holds beside phase 10b's (or
    10c's) pool, reckoned from the specs and the card's free memory: each
    rank's parameter blocks and
    bf16 gradients, its ZeRO-1 fp32 gradients and moments, a CUDA context
    (this process's: the card's use less what its allocator reserves) and
    ``TRAIN_SHARD_SLACK``; the parent's two whole copies shared with the
    ranks (the weights and the unsharded step's gradients).  The deepest
    up to ``ph.train_max_layers`` within 0.9 of the free memory.  With the
    pool alive (``pool_alive``: a later model of the pool) the ranks'
    contexts already hold their memory, outside the free memory, and are
    not counted again.  Returns (depth, the reckoning)."""
    import numpy as np
    import torch
    from repro_torch.models.model import DecoderModel
    from repro_torch.sharding.collectives import Mesh
    from repro_torch.sharding.partition import (local_shape, map_with_specs,
                                                moment_specs, param_specs)
    mesh = Mesh(SHARD_MESH, ("data", "model"))
    gc.collect()
    torch.cuda.empty_cache()
    free, card = torch.cuda.mem_get_info()
    ctx = 0 if pool_alive else card - free - torch.cuda.memory_reserved()
    best, rows = 1, []
    for n in range(1, ph.train_max_layers + 1):
        shapes = DecoderModel(sharded_train_config(ph.arch, n),
                              device="cpu").param_shapes()

        def count(specs):
            out = []
            map_with_specs(lambda x, sp: out.append(
                int(np.prod(local_shape(tuple(x.shape), sp, mesh)))),
                shapes, specs)
            return sum(out)
        p_loc = count(param_specs(shapes, mesh))
        m_loc = count(moment_specs(shapes, mesh))
        whole = sum(int(np.prod(x.shape)) for x in _leaves(shapes)) * 2
        rank = 4 * p_loc + 12 * m_loc + ctx + TRAIN_SHARD_SLACK
        need = 2 * whole + world_of(SHARD_MESH) * rank
        rows.append({"layers": n, "rank_GB": rank / 1e9,
                     "shared_GB": 2 * whole / 1e9, "need_GB": need / 1e9})
        if need <= 0.9 * free:
            best = n
    return best, {"card_GB": card / 1e9, "free_GB": free / 1e9,
                  "context_GB": ctx / 1e9, "pool_alive": pool_alive,
                  "rows": rows}


def sharded_train_shapes() -> tuple:
    """What phase 10b's ranks give K2 and K4: (rows a rank, K2's (H, Hkv,
    hd) a rank, K4's widths (E_loc, top-k, d, F), the a2a buffer's C tp),
    from the config, the mesh and the plans' rules."""
    from repro_torch.models import moe
    cfg = sharded_train_config("qwen3-30b-a3b", 1)
    dn, tn = SHARD_MESH
    t_loc = TRAIN_SHARD_B * TRAIN_SHARD_S // (dn * tn)
    e = cfg.moe
    return (TRAIN_SHARD_B // dn, (cfg.n_heads // tn, cfg.n_kv_heads,
                                  cfg.head_dim_),
            (e.n_experts // tn, e.top_k, cfg.d_model, e.expert_d_ff),
            moe.capacity(cfg, t_loc) * tn)


def deepseek_shard_shapes() -> dict:
    """What phase 10c's ranks give the kernels, from the config, the mesh
    and the plans' rules: K2's and K3's heads a rank (H / tp, g 1, (192,
    128)), the serve and training rows a rank, the a2a regime's tokens a
    rank (its experts' share of the call's assignments, for K1's ragged
    row) and dense buffer C (C tp: dropless, all its tokens), the
    gathered decode's C (every rank takes the call's 2 tokens), and K1's
    and K4's widths: (E_loc, top-k, d, F) at full F (the a2a regime
    gathers the F shards) and at the F shard over ``data``."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-236b")
    dn, tn = SHARD_MESH
    e, m = cfg.moe, cfg.mla
    t_loc = SHARD_B * SHARD_S // (dn * tn)
    e_loc = e.n_experts // tn
    return {"heads": (cfg.n_heads // tn, cfg.n_heads // tn,
                      m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim),
            "rows": SHARD_B // dn, "train_rows": TRAIN_SHARD_B // dn,
            "a2a_tokens": t_loc, "a2a_c": t_loc * tn, "decode_c": SHARD_B,
            "moe_full": (e_loc, e.top_k, cfg.d_model, e.expert_d_ff),
            "moe_shard": (e_loc, e.top_k, cfg.d_model, e.expert_d_ff // dn)}


def phase10d_shapes() -> dict:
    """What phase 10d's ranks give K2 and K3, from the configs and the
    mesh: the rows a rank (the batch over ``data``), recurrentgemma-9b's
    heads a rank in JAX's "gqa" region (H / tp over its one kv head of
    256) and its cache slice a rank, whisper-base's heads a rank (its 8
    kv heads over 8 ranks: one, g 1) and the training step's rows a
    rank."""
    from repro_torch.configs import get_config
    dn, tn = SHARD_MESH
    rg, wh = get_config("recurrentgemma-9b"), get_config("whisper-base")
    return {"rows": SHARD_B // dn, "train_rows": TRAIN_SHARD_B // dn,
            "rg_heads": (rg.n_heads // tn, rg.n_kv_heads, rg.head_dim_),
            "rg_slice": RECURRENTGEMMA_SHARD.cache // tn,
            "wh_heads": (wh.n_heads // tn, wh.n_kv_heads // tn,
                         wh.head_dim_)}


def world_of(shape) -> int:
    n = 1
    for k in shape:
        n *= k
    return n


def _recording(opt, sink: list):
    """``opt`` (an ``AdamW``) whose update first appends the gradients it
    is given to ``sink``."""
    cls = type(opt)

    class Recording(cls):
        def update(self, grads, state, params, plan=None):
            sink.append(grads)
            return cls.update(self, grads, state, params, plan)
    return Recording(**{f.name: getattr(opt, f.name)
                        for f in dataclasses.fields(opt)})


def _router_blocks(model, params) -> dict:
    """{data pointer of block b's router: b} over the MoE blocks: a
    route call names its block by its router (a recompute under remat
    calls it again, out of order)."""
    out = {}
    for b, (s_, r, p_) in enumerate(model.index_map):
        blk = params["segments"][s_]["pattern"][p_]
        if "moe" in blk:
            out[blk["moe"]["router"][r].data_ptr()] = b
    return out


def _pin_block_route(route, pins: dict, blocks: dict, seen: dict):
    """``moe.route`` with each token's expert ids taken from the
    unsharded run's call of the same block (``pins[b]``: its MoE input and
    expert ids), the block found by its router (``blocks``)."""
    def pinned(cfg, p, x):
        _, _, probs = route(cfg, p, x)
        return _matched(x, probs, *pins[blocks[p["router"].data_ptr()]],
                        seen)
    return pinned


def _train_opt():
    from repro_torch.training.optimizer import adamw
    # the training launcher's WSD schedule at step 1 (warmup 1 step)
    return adamw(lr=6e-4, schedule="wsd", total_steps=10, warmup=1)


def sharded_train_reference(times: dict, ph: ShardPhase,
                            pool_alive: bool = False) -> dict:
    """Phase 10b's (10c's) yardstick: the unsharded port's train step of
    ``ph.arch`` (remat, the
    dense dispatch) on the card at ``sharded_train_depth``'s depth, seed-1
    bf16 weights, the launcher's first 8 x 256 batch; every MoE block's
    (input, expert ids) recorded for the ranks' pinning.  Returns what the
    ranks read: the weights and the step's gradients (on the card, shared
    with the ranks), its new weights (on the host), its metrics, the pins
    and the batch, the kernels every rank must launch, and the model's
    name."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.config import FFN_MOE
    from repro_torch.models.model import DecoderModel
    from repro_torch.training.data import PackedDataset, SyntheticCorpus
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train import device_batch, make_train_step
    t0 = time.perf_counter()
    depth, reckoning = sharded_train_depth(ph, pool_alive)
    total = get_config(ph.arch).n_layers
    log(f"{ph.arch} sharded training depth: {depth} of {total} layers, "
        f"reckoned " + json.dumps(reckoning))
    cfg = sharded_train_config(ph.arch, depth)
    model = DecoderModel(cfg, device="cuda", remat=True)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(TRAIN_SEED))
    ds = iter(PackedDataset(SyntheticCorpus(vocab_size=cfg.vocab_size,
                                            seed=0),
                            seq_len=TRAIN_SHARD_S, batch_size=TRAIN_SHARD_B,
                            seed=0))
    host = next(ds)
    work = ops.tree_map(torch.clone, params)
    blocks = _router_blocks(model, work)
    route, pins = moe.route, {}

    def recorded(cfg_, p, x):
        out = route(cfg_, p, x)
        pins[blocks[p["router"].data_ptr()]] = (x.detach().clone(),
                                                out[0].detach().clone())
        return out
    grads: list = []
    opt = _recording(_train_opt(), grads)
    state = opt.init(work)
    step = make_train_step(model, opt, cfg.encoder.enabled)
    moe.route = recorded
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        work, state, m = step(work, state, device_batch(model, *host))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        moe.route = route
    del state
    # the new weights go to the host: the ranks send back their blocks
    new = ops.tree_map(lambda t: t.cpu(), work)
    del work
    metrics = {k: float(v) for k, v in m.items()}
    if metrics["dropped"] != 0:
        raise AssertionError(f"unsharded train step dropped {metrics}")
    gc.collect()
    torch.cuda.empty_cache()
    _phase(f"sharded {ph.arch} train reference", t0, times)
    log(f"sharded {ph.arch} train yardstick (unsharded, {depth} layers): "
        + json.dumps(metrics) + f"; step {wall:.3f} s")
    routed = any(sp.ffn == FFN_MOE for sp in cfg.block_specs())
    return {"cfg": cfg, "params": params, "grads": grads[0],
            "new": new, "metrics": metrics, "pins": pins,
            "batch": host, "wall": wall, "depth": depth, "total": total,
            "arch": ph.arch, "leaves": len(tree_leaves(params)),
            "kernels": TRAIN_SHARD_KERNELS
            + (TRAIN_SHARD_MOE_KERNELS if routed else ())}


# a rank's draw of its shards may hold, beside the shards it keeps, this
# many of the model's largest chunks (the one being drawn and cut, and the
# allocator's rounding)
INIT_PEAK_CHUNKS = 3


def _draw_shards(cfg, seed: int, mesh, rules, whole) -> tuple:
    """This rank's shards of ``cfg``'s seed-``seed`` model drawn alone
    (``DecoderModel.init_shards``, timed after a spec pass of its own),
    each leaf held with ``torch.equal`` against its block of the parent's
    whole draw ``whole`` (CUDA IPC; the views are dropped here).  Returns
    (the shards, the draw's seconds, its peak allocated bytes above what
    was allocated before it and what it left allocated (the allocator's
    rounding of the shards), the kept bytes, the reckoning's drawn bytes
    and largest chunk, the leaves that differ)."""
    import torch
    from repro_torch.convert import shard_params
    from repro_torch.launch.train import rank_bytes
    from repro_torch.models.model import DecoderModel
    from repro_torch.training.checkpoint import leaf_names
    from repro_torch.training.optimizer import tree_leaves
    model = DecoderModel(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # the spec pass alone (meta tensors on the host), then the draw
    t0 = time.perf_counter()
    model.param_shapes()
    specs = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lp = model.init_shards(gen, mesh, rules=rules)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    held = torch.cuda.memory_allocated() - before
    want = shard_params(whole, mesh, rules=rules)
    unequal = [name for name, a, b in zip(
        leaf_names(lp), tree_leaves(lp), tree_leaves(want))
        if a.shape != b.shape or not torch.equal(a, b)]
    del want
    need = rank_bytes(cfg, mesh, rules=rules)
    kept = sum(x.numel() * x.element_size() for x in tree_leaves(lp))
    return lp, {"seed": seed, "layers": cfg.n_layers, "s": secs,
                "specs_s": specs, "peak": peak, "held": held, "kept": kept,
                "drawn": need["drawn"], "chunk": need["chunk"],
                "leaves": len(tree_leaves(lp)), "unequal": unequal}


def check_init(arch: str, inits: list, total: int) -> dict:
    """The gate of the ranks' own draws (``_draw_shards``): every leaf of
    every rank equal to its block of the whole draw, each rank's peak
    during its draw within its kept bytes and ``INIT_PEAK_CHUNKS`` chunks;
    logs one line: kept, drawn, seconds and peak a rank."""
    bad = [f"rank {i}: {d['unequal']}" for i, d in enumerate(inits)
           if d["unequal"]]
    over = [(i, d["peak"], d["kept"]) for i, d in enumerate(inits)
            if d["peak"] > d["kept"] + INIT_PEAK_CHUNKS * d["chunk"]]
    d0 = inits[0]
    rep = {"seed": d0["seed"], "layers": d0["layers"], "total": total,
           "leaves": d0["leaves"],
           "kept_GB": max(d["kept"] for d in inits) / 1e9,
           "drawn_GB": max(d["drawn"] for d in inits) / 1e9,
           "s": max(d["s"] for d in inits),
           "specs_s": max(d["specs_s"] for d in inits),
           "peak_GB": max(d["peak"] for d in inits) / 1e9,
           "held_GB": max(d["held"] for d in inits) / 1e9,
           "peak_over_kept_chunks": max((d["peak"] - d["kept"]) / d["chunk"]
                                        for d in inits)}
    log(f"sharded {arch} init (seed {d0['seed']}, {d0['layers']} of {total} "
        f"layers): each of {len(inits)} ranks drew only its shards "
        f"(init_shards), every leaf equal to its block of the whole draw: "
        f"{not bad}; a rank keeps {rep['kept_GB']:.3f} GB, draws "
        f"{rep['drawn_GB']:.3f} GB in {rep['s']:.3f} s (a spec pass before "
        f"it {rep['specs_s']:.3f} s), peak "
        f"{rep['peak_GB']:.3f} GB, held after {rep['held_GB']:.3f} GB "
        f"(peak limit kept + {INIT_PEAK_CHUNKS} chunks of "
        f"{d0['chunk'] / 2 ** 20:.0f} MiB; worst {rep['peak_over_kept_chunks']:.2f} "
        f"chunks over)")
    if bad or over:
        raise AssertionError(f"sharded {arch} init: leaves unequal {bad}; "
                             f"peak over kept + chunks {over}")
    return rep


def _train_rank(mesh, rules, tin, route) -> dict:
    """Phase 10b on this rank: its own copies of its shards of the
    weights, one sharded train step (routes pinned block by block to the
    unsharded step's), launches, collectives, wall time and peak memory;
    and against the unsharded step, on this rank's blocks: squared
    Frobenius sums of each leaf's gradient (the moments' layout) and
    first and second moments against the unsharded step's gradient
    clipped by its norm (AdamW's first step from zero: (1 - b1) g and (1 -
    b2) g^2), each divided by the ranks that hold the same block, so the
    sums over ranks are the whole leaf's; and the new parameter blocks of
    which this rank holds the first copy (to the host), and the card's
    free memory before the step."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import DecoderModel
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding.partition import (local_slices,
                                                sharding_context, spec_axes)
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train import (device_batch, make_train_step,
                                            train_plan)
    cfg = tin["cfg"]
    lp, init = _draw_shards(cfg, TRAIN_SEED, mesh, rules, tin["params"])
    model = DecoderModel(cfg, device="cuda", remat=True)
    seen = {"near": 0.0, "apart": math.inf}
    moe.route = _pin_block_route(route, tin["pins"],
                                 _router_blocks(model, lp), seen)
    grads: list = []
    opt = _recording(_train_opt(), grads)
    batch = device_batch(model, *tin["batch"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with sharding_context(mesh, rules):
        plan = train_plan(model)
        state = opt.init(lp, plan)
        step = make_train_step(model, opt, cfg.encoder.enabled)
        ops.reset_launches()
        col.reset_record()
        torch.cuda.synchronize()
        dist.barrier()
        free = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        lp, state, m = step(lp, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    coll = {k: dict(v) for k, v in col.RECORD.items()}
    mem = torch.cuda.max_memory_allocated()
    moe.route = route
    scale = min(1.0, 1.0 / (tin["metrics"]["grad_norm"] + 1e-9))
    sums = []
    blocks = []
    for i, (g, mu, nu, p_new, whole, lp_) in enumerate(zip(
            tree_leaves(grads[0]), tree_leaves(state.mu),
            tree_leaves(state.nu), tree_leaves(lp),
            tree_leaves(tin["grads"]), tree_leaves(plan))):
        ps = p_new.shape
        spec = lp_.spec
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in spec_axes(spec)):
            blocks.append((i, p_new.cpu()))
        # the moment's block of the whole leaf: the parameter block's,
        # then ZeRO-1's cut
        sl = local_slices(tuple(whole.shape), spec, mesh)
        ref_g = whole[sl]
        if lp_.dim is not None:
            c = ps[lp_.dim] // lp_.n
            ref_g = ref_g.narrow(lp_.dim, lp_.j * c, c)
        ref_g = ref_g.contiguous().view(-1)
        # (grad, mu, nu) x (squared error, squared reference), summed on
        # the card and read back once for every leaf
        row = torch.zeros((3, 2), dtype=torch.float64, device=g.device)
        # in chunks: sixteen ranks compare at once beside their state
        for a in range(0, ref_g.numel(), 1 << 22):
            r = ref_g[a:a + (1 << 22)].float() * scale
            for k, (got, want) in enumerate((
                    (g.view(-1)[a:a + (1 << 22)] * scale, r),
                    (mu.view(-1)[a:a + (1 << 22)], 0.1 * r),
                    (nu.view(-1)[a:a + (1 << 22)], 0.05 * r * r))):
                row[k, 0] += (got - want).double().square().sum()
                row[k, 1] += want.double().square().sum()
        sums.append(row / lp_.copies)
    sums = [{key: tuple(v) for key, v in zip(("grad", "mu", "nu"), row)}
            for row in torch.stack(sums).tolist()]
    return {"metrics": {k: float(v) for k, v in m.items()},
            "launches": launches, "coll": coll, "wall": wall, "mem": mem,
            "free": free, "sums": sums, "pins": seen, "coords": mesh.coords,
            "blocks": blocks, "init": init}


def check_sharded_train(res: list, tin: dict) -> dict:
    """Phase 10b's gate over the ranks' results (``_train_rank``): the
    metrics equal on every rank and against the unsharded step, each
    leaf's gradient and moments and its parameters within the stated
    tolerances, routes pinned within ``PIN_NEAR``/``PIN_APART``, the
    reference's kernels (K2 and its backward, K4 and its backward where
    the depth holds routed experts) launched on every rank and no other
    kernel of the six; logs launches, collectives, wall and peak
    memory."""
    import torch
    world = len(res)
    ref_m = tin["metrics"]
    bad = []
    for r in res:
        m = r["metrics"]
        if m != res[0]["metrics"]:
            bad.append(f"metrics differ between ranks: {m}")
        if m["dropped"] != 0:
            bad.append(f"sharded train step dropped {m['dropped']}")
    m = res[0]["metrics"]
    # aux_loss is 0 where the depth holds no routed experts
    rel = {k: abs(m[k] - ref_m[k]) / (abs(ref_m[k]) or 1.0)
           for k in ("loss", "ce", "aux_loss", "grad_norm")}
    for k, lim in (("loss", TRAIN_LOSS_REL), ("ce", TRAIN_LOSS_REL),
                   ("aux_loss", TRAIN_LOSS_REL),
                   ("grad_norm", TRAIN_GNORM_REL)):
        if not rel[k] <= lim:
            bad.append(f"{k} rel {rel[k]} (limit {lim})")
    worst = {"grad": 0.0, "mu": 0.0, "nu": 0.0, "param": 0.0}
    limits = {"grad": TRAIN_SHARD_GRAD_REL, "mu": TRAIN_SHARD_GRAD_REL,
              "nu": TRAIN_SHARD_NU_REL, "param": TRAIN_SHARD_PARAM_SHARE}
    for i in range(tin["leaves"]):
        for key in ("grad", "mu", "nu"):
            num = sum(r["sums"][i][key][0] for r in res)
            den = sum(r["sums"][i][key][1] for r in res)
            val = (num / den) ** 0.5 if den > 0 else float(num > 0)
            worst[key] = max(worst[key], val)
            if not val <= limits[key]:
                bad.append(f"leaf {i} {key}: {val} (limit {limits[key]})")
    # the new parameters: each block once, against the unsharded step's
    from repro_torch.models.model import DecoderModel
    from repro_torch.sharding.collectives import Mesh
    from repro_torch.sharding.partition import local_slices, zero1_plan
    from repro_torch.training.optimizer import tree_leaves
    mesh = Mesh(SHARD_MESH, ("data", "model"))
    specs = [lp.spec for lp in tree_leaves(zero1_plan(
        DecoderModel(tin["cfg"], device="cpu").param_shapes(), mesh))]
    new = tree_leaves(tin["new"])
    apart, total = [0] * len(new), [0] * len(new)
    for r in res:
        for i, block in r["blocks"]:
            want = new[i][local_slices(tuple(new[i].shape), specs[i], mesh,
                                       r["coords"])]
            apart[i] += int(((block.view(torch.int16).int()
                              - want.view(torch.int16).int()).abs()
                             > 1).sum())
            total[i] += block.numel()
    for i in range(len(new)):
        if total[i] != new[i].numel():
            bad.append(f"leaf {i}: blocks cover {total[i]} of "
                       f"{new[i].numel()} elements")
        share = apart[i] / max(total[i], 1)
        worst["param"] = max(worst["param"], share)
        if not share <= limits["param"]:
            bad.append(f"leaf {i} param share apart: {share} (limit "
                       f"{limits['param']})")
    near = max(r["pins"]["near"] for r in res)
    apart = min(r["pins"]["apart"] for r in res)
    if not (near <= PIN_NEAR and apart >= PIN_APART):
        bad.append(f"train pinning: match {near}, apart {apart}")
    launches = collections.Counter()
    for r in res:
        launches.update(r["launches"])
        for k in tin["kernels"]:
            if not r["launches"][k]:
                bad.append(f"a rank never launched {k}")
        others = {k: v for k, v in r["launches"].items()
                  if k not in tin["kernels"] and v}
        if others:
            bad.append(f"a rank launched other kernels: {others}")
    coll = {k: {"calls": sum(r["coll"][k]["calls"] for r in res),
                "bytes": sum(r["coll"][k]["bytes"] for r in res)}
            for k in res[0]["coll"]}
    wall = max(r["wall"] for r in res)
    mem = max(r["mem"] for r in res)
    free = min(r["free"] for r in res)
    log(f"sharded train step ({tin['arch']}, {tin['depth']} of "
        f"{tin['total']} layers, "
        f"{TRAIN_SHARD_B} x {TRAIN_SHARD_S} tokens, mesh {SHARD_MESH}, "
        f"{world} ranks on one card over gloo, routes pinned) against the "
        f"unsharded step: metrics {json.dumps(m)}; rel "
        f"{json.dumps(rel)}; worst leaf: gradient {worst['grad']:.3e}, "
        f"mu {worst['mu']:.3e}, nu {worst['nu']:.3e} (limits "
        f"{TRAIN_SHARD_GRAD_REL}, {TRAIN_SHARD_GRAD_REL}, "
        f"{TRAIN_SHARD_NU_REL}); parameters more than one bf16 step apart: "
        f"worst share {worst['param']:.3e} (limit {TRAIN_SHARD_PARAM_SHARE}); "
        f"pins {near:.3e} / {apart:.3f}")
    log(f"sharded {tin['arch']} train step: launches {dict(launches)} "
        f"(over {world} "
        f"ranks); collectives forward and backward {json.dumps(coll)}; wall "
        f"{wall:.3f} s (the unsharded step {tin['wall']:.3f} s); peak memory "
        f"a rank {mem / 1e9:.2f} GB (the card's free memory before the step "
        f"{free / 1e9:.2f} GB).  Wall times are the harness ({world} "
        f"processes on one card, gloo through the host), not a cluster")
    if bad:
        raise AssertionError(f"sharded train step disagrees with the "
                             f"unsharded port: {bad}")
    key = f"{tin['arch']} sharded train"
    return {key: {
        "arch": key, "launches": dict(launches),
        "iterations": 1, "wall_s": wall, "peak_rank_GB": mem / 1e9,
        "collectives": coll, "rel": rel, "worst": worst,
        "depth": tin["depth"]}}


def _shard_rank(rank: int, world: int, tmp: str, jobs, drawn, done) -> None:
    """One rank of a sharded pool: every job the parent puts in ``jobs``
    (one copy a rank; None ends the pool) runs over the (2, 8) mesh
    (``_shard_job``), its results go to ``tmp/rank<r>_<i>.pt``, and the
    rank says so in ``done`` (and in ``drawn`` once it has drawn its serve
    shards and dropped the parent's whole draw, which the parent then
    frees).  The jobs' tensors are the
    parent's, on the card (CUDA IPC); the rank drops its references before
    it reports, so that the parent can free them for the next model.  A
    rank's error is printed here (the pool reports only the first rank's
    that it sees, often another's lost connection)."""
    import os
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "rendezvous"), rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import moe
        from repro_torch.sharding.partition import default_rules
        mesh = make_mesh(SHARD_MESH, ("data", "model"), rank=rank,
                         distributed=True)
        rules = default_rules(mesh)
        route0 = moe.route
        i = 0
        while True:
            job = jobs.get()
            if job is None:
                break
            try:
                res = _shard_job(mesh, rules, job, route0,
                                 lambda: drawn.put(rank))
            except BaseException:
                import traceback
                traceback.print_exc()
                raise
            finally:
                moe.route = route0
            del job
            torch.save(res, os.path.join(tmp, f"rank{rank}_{i}.pt"))
            del res
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            done.put(rank)
            i += 1
    finally:
        dist.destroy_process_group()


def _shard_job(mesh, rules, job: dict, route0, drawn) -> dict:
    """One model on this rank (``job``: its phase, config, the parent's
    ``params`` and ``inputs``): its shards of ``params``, the prefill
    (each of the phase's dispatches; whisper's with its frames, then the
    cross K/V installed), the decode steps and the layered step, each MoE
    call's routes pinned to the unsharded run's; the teacher-forced
    blocks; the train step where the phase has one; per step the
    kernels' launches, the collectives and the wall time."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.shapes import InputShape
    from repro_torch.convert import shard_cache
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models.model import DecoderModel
    from repro_torch.sharding import collectives as col
    from repro_torch.sharding import spmd
    from repro_torch.sharding.partition import sharding_context
    marks = {"entered": time.time()}
    ph, cfg = job["ph"], job["cfg"]
    params, inputs = job.pop("params"), job.pop("inputs")
    lp, init = _draw_shards(cfg, SERVE_SEED, mesh, rules, params)
    del params
    drawn()
    marks["shards"] = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = DecoderModel(cfg, device="cuda")
    b_r = SHARD_B // SHARD_MESH[0]
    r0 = mesh.coords["data"] * b_r
    queue, seen = [], {"near": 0.0, "apart": math.inf}
    moe.route = _pin_route(route0, queue, seen)

    def rows(t):
        return t[r0:r0 + b_r].cuda()
    pre = InputShape("prefill", "prefill", ph.cache, SHARD_B)
    dec = InputShape("decode", "decode", ph.cache, SHARD_B)
    stats, out = [], {}

    def timed(label, fn):
        queue[:] = inputs["pins"].get(label, [])
        ops.reset_launches()
        col.reset_record()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dist.barrier()
        stats.append({"step": label,
                      "s": time.perf_counter() - t0,
                      "launches": dict(ops.LAUNCHES),
                      "coll": {k: dict(v) for k, v in
                               col.RECORD.items()}})
        if queue:
            raise AssertionError(f"{label}: {len(queue)} MoE calls of "
                                 "the unsharded run not made")
        return res
    with sharding_context(mesh, rules):
        for disp in ph.dispatches:
            cache = shard_cache(model.init_cache(SHARD_B, ph.cache), mesh,
                                SHARD_B)
            step = steps.make_step_fn(model, pre, moe_dispatch=disp,
                                      dropless=True)
            batch = {"tokens": rows(inputs["tokens"])}
            if ph.frames:
                batch["enc_out"] = rows(inputs["frames"])
            lg, cache, aux = timed(f"prefill {disp}", lambda: step(
                lp, cache, batch))
            out[f"prefill {disp}"] = (lg.float().cpu(),
                                      aux["expert_counts"].cpu())
        if ph.frames:
            def admit():
                enc = model.encode(lp, batch["enc_out"],
                                   global_batch=SHARD_B)
                model.install_cross_kv(lp, cache, enc)
                return enc
            out["encoder"] = (timed("encode, cross K/V",
                                    admit).float().cpu(),)
        dstep = steps.make_step_fn(model, dec, dropless=True)
        for i in range(SHARD_DECODES):
            lg, cache, aux = timed(f"decode {i}", lambda: dstep(
                lp, cache, {"tokens": rows(inputs["decode"][i]),
                            "offsets": rows(inputs["offsets"][i])}))
            out[f"decode {i}"] = (lg.float().cpu(),
                                  aux["expert_counts"].cpu())
        lstep = steps.make_layered_step_fn(
            model, group=ph.group, prefill_len=SHARD_P,
            global_batch=SHARD_B, cache_len=ph.cache, dropless=True)
        lay1 = spmd.layout(mesh, rules, 1, SHARD_P)
        lg, h_out, cache, aux = timed("layered", lambda: lstep(
            lp, cache, {"tokens": rows(inputs["layered_tokens"]),
                        "offsets": rows(inputs["layered_offsets"]),
                        "valid": rows(inputs["valid"]),
                        "hidden": spmd.take_seq(
                            mesh, rules, inputs["hidden"].cuda(), lay1)}))
        out["layered"] = (lg.float().cpu(), aux["expert_counts"].cpu(),
                          h_out.float().cpu(),
                          aux["prefill_expert_counts"].cpu())
        marks["steps"] = time.time()
        out["blocks"] = _teacher_forced(model, lp, mesh, rules,
                                        inputs["blocks"], queue, ph)
        marks["teacher-forced"] = time.time()
    serve_mem = torch.cuda.max_memory_allocated()
    del lp, cache, model
    if inputs.get("train") is not None:
        # the train step in the same pool: the serve weights' shards go
        # first
        out["train"] = _train_rank(mesh, rules, inputs["train"], route0)
        marks["train"] = time.time()
    del inputs
    return {"coords": mesh.coords, "out": out, "stats": stats,
            "marks": marks, "pins": seen, "mem": serve_mem, "init": init}


def _wait_ranks(pool, done, world: int) -> None:
    """Until every rank of ``pool`` has reported in ``done``; a rank that
    failed raises its error here."""
    import queue as queue_
    got = 0
    while got < world:
        try:
            done.get(timeout=5)
            got += 1
        except queue_.Empty:
            if pool.join(timeout=0.1):
                raise AssertionError("the sharded pool ended early")


def serve_sharded(times: dict, ph: ShardPhase, then=()) -> dict:
    """Phase 10 (qwen3-30b-a3b, ``ph``) and, in the same pool (``then``),
    10c (deepseek-v2-236b) and 10d (recurrentgemma-9b, xlstm-1.3b,
    whisper-base): each model at full width, its phase's layers,
    bf16, seed-0 weights made on the card, sharded over the (2, 8)
    mesh by 16 ranks on this one card (gloo: NCCL refuses two ranks on one
    device), one pool for ``ph`` and every model of ``then`` after it,
    each model's weights handed over by CUDA IPC and dropped after use.
    The plans take every regime qwen3-30b-a3b has at serve
    shapes: "gqa" attention over a sequence-split cache and the a2a MoE
    (dense and ragged) at the prefill (2 x 512), the split softmax (K3 with
    its log-sum-exp) and the gathered MoE at the 8 decode steps, and the
    split softmax (K2 with its log-sum-exp) with the psum MoE at the
    layered step's 256-token row; deepseek-v2-236b's MLA gathers the
    sequence-split latent for the prefill and the row, splits the softmax
    at decode (K3 with its log-sum-exp at H = Hkv = 128), and its shared
    experts run column/row-parallel beside the routed ones; phase 10d's
    regimes are at ``RECURRENTGEMMA_SHARD``.  Held against the unsharded
    port on the same card and weights (decode inputs teacher-forced: the
    unsharded run's tokens), with every rank's MoE calls pinned to the
    unsharded run's
    routes (``_pin_route``: at seed-0 random weights the smallest router
    margin over 8 blocks is about 1e-4, the size of the bf16 sums' other
    order over 8 ranks, so unpinned routing parts after a few blocks):
    every step's logits (and the layered row's output, and whisper's
    encoder output) within
    ``E2E_REL_FRO``, expert counts equal, greedy tokens equal except at a
    near-tie of the unsharded logits (``NEAR_TIE_ULPS``); and every block
    of the prefills, the first decode step and the layered row, run alone
    on the ranks from the unsharded run's input to it, with its update
    (output less input) within ``BLOCK_TOL`` of the unsharded block's.
    Per step: the kernels' launches summed over ranks (every rank must
    launch each of the phase's kernels), the collectives by kind and
    bytes, and the wall time: 16 processes on one card over gloo, the
    harness, not a cluster.  The train step of a phase with one
    (``sharded_train_reference``) runs in the same ranks after its serve
    steps."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    world = SHARD_MESH[0] * SHARD_MESH[1]
    runs = {}
    ctx = mp.get_context("spawn")
    jobs, drawn, done = ctx.Queue(), ctx.Queue(), ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        pool = None
        try:
            for i, phase in enumerate((ph,) + tuple(then)):
                job, ref = _shard_reference(times, phase, pool is not None)
                t_ref = time.perf_counter()
                t_spawn = time.time()
                if pool is None:
                    pool = mp.start_processes(
                        _shard_rank, args=(world, tmp, jobs, drawn, done),
                        nprocs=world, start_method="spawn", join=False)
                for _ in range(world):
                    jobs.put(job)
                # the ranks hold their own shards now: the whole draw goes
                _wait_ranks(pool, drawn, world)
                del job["params"]
                gc.collect()
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
                _wait_ranks(pool, done, world)
                res = [torch.load(f"{tmp}/rank{r}_{i}.pt")
                       for r in range(world)]
                t_end = time.time()
                _phase(f"sharded {phase.arch} 16 ranks"
                       + (" (start, serve steps and train step)" if not i
                          else " (serve steps"
                          + (" and train step)" if phase.train_max_layers
                             else ")")), t_ref, times)
                log(f"sharded {phase.arch} pool, seconds from the job (the "
                    f"last rank): " + json.dumps(
                        {k: round(max(r["marks"][k] for r in res) - t_spawn,
                                  1) for k in res[0]["marks"]})
                    + f", results loaded {t_end - t_spawn:.1f}")
                del job
                gc.collect()
                # the weights the ranks opened by CUDA IPC stay held until
                # collected: the next model needs their memory
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
                runs.update(_check_shard(phase, res, ref)["runs"])
                del ref, res
                gc.collect()
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
                log(f"sharded {phase.arch}: the card's free memory after it "
                    f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB")
            for _ in range(world):
                jobs.put(None)
            pool.join()
        finally:
            if pool is not None:
                for p_ in pool.processes:
                    if p_.is_alive():
                        p_.kill()
                        p_.join()
    return {"runs": runs}


def _shard_reference(times: dict, ph: ShardPhase,
                     pool_alive: bool) -> tuple:
    """The unsharded run of ``ph`` on the card, every MoE call's (input,
    expert ids) and every block's (input, output) recorded: (the ranks'
    job, what ``_check_shard`` holds them to); ``pool_alive``: the
    ranks' contexts are already on the card (``sharded_train_depth``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import blocks, moe
    from repro_torch.models.model import DecoderModel
    t0 = time.perf_counter()
    total = get_config(ph.arch).n_layers
    cfg = dataclasses.replace(get_config(ph.arch), n_layers=ph.layers)
    model = DecoderModel(cfg, device="cuda")
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SERVE_SEED))
    g = torch.Generator().manual_seed(3)
    inputs = {"tokens": torch.randint(1, cfg.vocab_size, (SHARD_B, ph.s),
                                      generator=g)}
    enc = None
    if ph.frames:
        # whisper: each row's seeded frames, encoded at the prefill
        inputs["frames"] = torch.randn(
            (SHARD_B, cfg.encoder.n_frames, cfg.d_model),
            generator=g).to(torch.bfloat16)
        enc = model.encode(params, inputs["frames"].cuda())
    # the unsharded reference on the card: every MoE call's (input, expert
    # ids) and every block's (input, output), recorded
    pre = InputShape("prefill", "prefill", ph.cache, SHARD_B)
    dec = InputShape("decode", "decode", ph.cache, SHARD_B)
    route, pins = moe.route, []

    def recorded(*args):
        out = route(*args)
        pins.append((args[2].detach().clone(), out[0].detach().clone()))
        return out

    apply_block, io = blocks.apply_block, []

    def recording_block(*args, **kw):
        x, n0 = args[3], len(pins)
        y = apply_block(*args, **kw)
        io.append((x.detach().clone(), y[0].detach().float().cpu(),
                   pins[n0:]))
        return y

    def run(key, fn):
        """``fn()``, recording its MoE calls as ``key``'s pins."""
        pins.clear()
        io.clear()
        moe.route, blocks.apply_block = recorded, recording_block
        try:
            res = fn()
        finally:
            moe.route, blocks.apply_block = route, apply_block
        inputs["pins"][key] = list(pins)
        return res

    def forced(key, b, positions, offset, dispatch, first=0, enc_out=None):
        """The teacher-forced per-block check's case, from the blocks and
        MoE calls of the run just recorded (from block ``first`` on)."""
        inputs["blocks"][key] = {
            "b": b, "dispatch": dispatch, "positions": positions,
            "offset": offset, "blocks": list(range(first, first + len(io))),
            "x": [x for x, _, _ in io], "pins": [p_ for _, _, p_ in io]}
        if enc_out is not None:
            inputs["blocks"][key]["enc"] = enc_out
        per_block[key] = [(x.float().cpu(), y) for x, y, _ in io]
    want, per_block = {}, {}
    inputs["blocks"], inputs["pins"] = {}, {}
    dev = torch.device("cuda")
    pos_pre = torch.arange(ph.s, device=dev)[None].expand(SHARD_B, -1)
    zeros = torch.zeros((SHARD_B,), dtype=torch.int32, device=dev)
    batch = {"tokens": inputs["tokens"].cuda()}
    if ph.frames:
        batch["enc_out"] = inputs["frames"].cuda()
    for disp in ph.dispatches:
        cache = model.init_cache(SHARD_B, ph.cache)
        step = steps.make_step_fn(model, pre, moe_dispatch=disp,
                                  dropless=True)
        lg, cache, aux = run(f"prefill {disp}", lambda: step(
            params, cache, batch))
        want[f"prefill {disp}"] = (lg.float().cpu(),
                                   aux["expert_counts"].cpu())
        forced(f"prefill {disp}", SHARD_B, pos_pre, zeros, disp,
               enc_out=enc)
    if ph.frames:
        model.install_cross_kv(params, cache, enc)
        want["encoder"] = (enc.float().cpu(),)
    dstep = steps.make_step_fn(model, dec, dropless=True)
    tok = want["prefill dense"][0].argmax(-1)[:, None].to(torch.int32)
    off = torch.full((SHARD_B,), ph.s, dtype=torch.int32)
    inputs["decode"], inputs["offsets"] = [], []
    for i in range(SHARD_DECODES):
        inputs["decode"].append(tok)
        inputs["offsets"].append(off)
        lg, cache, aux = run(f"decode {i}", lambda: dstep(
            params, cache, {"tokens": tok.cuda(), "offsets": off.cuda()}))
        want[f"decode {i}"] = (lg.float().cpu(), aux["expert_counts"].cpu())
        if i == 0:
            forced("decode 0", SHARD_B, off.cuda().long()[:, None],
                   off.cuda(), "dense")
        tok = lg.float().cpu().argmax(-1)[:, None].to(torch.int32)
        off = off + 1
    inputs["layered_tokens"], inputs["layered_offsets"] = tok, off
    inputs["valid"] = torch.tensor([False, True])
    # the row's carry into its first layer group (block 0): the embedded
    # prompt, as the engine gives it (a unit-scale random carry lies far
    # from a residual: an mLSTM block's update is 4e-4 of it, below its
    # bf16 step, so the teacher-forced update measures rounding)
    row_tokens = torch.randint(1, cfg.vocab_size, (1, SHARD_P), generator=g)
    inputs["hidden"] = model.embed(
        params, row_tokens.cuda(),
        positions=torch.arange(SHARD_P, device=dev)[None]).cpu()
    lstep = steps.make_layered_step_fn(model, group=ph.group,
                                       prefill_len=SHARD_P,
                                       global_batch=SHARD_B,
                                       cache_len=ph.cache, dropless=True)
    # slot 0's row as the row's prefill finds it (the step's decode part
    # masks slot 0): recurrent state carries the decodes before it
    row0 = ops.tree_map(lambda a: a[:, :1].clone(), cache)
    lg, h_out, cache, aux = run("layered", lambda: lstep(params, cache, {
        "tokens": tok.cuda(), "offsets": off.cuda(),
        "valid": inputs["valid"].cuda(), "hidden": inputs["hidden"].cuda()}))
    # the decode part's ph.layers blocks, then the row's group
    del io[:ph.layers]
    forced("layered row", 1, torch.arange(SHARD_P, device=dev)[None],
           torch.zeros((1,), dtype=torch.int32, device=dev), "dense",
           first=ph.group[0])
    inputs["blocks"]["layered row"]["row"] = row0
    want["layered"] = (lg.float().cpu(), aux["expert_counts"].cpu(),
                       h_out.float().cpu(),
                       aux["prefill_expert_counts"].cpu())
    del cache, enc
    torch.cuda.synchronize()
    _phase(f"sharded {ph.arch} reference", t0, times)
    inputs["train"] = tin = (sharded_train_reference(times, ph, pool_alive)
                             if ph.train_max_layers else None)
    return ({"ph": ph, "cfg": cfg, "params": params, "inputs": inputs},
            {"want": want, "per_block": per_block, "tin": tin,
             "total": total})


def _check_shard(ph: ShardPhase, res: list, ref: dict) -> dict:
    """``ph``'s ranks' results (``_shard_job``) against the unsharded run
    (``_shard_reference``): the gates of ``serve_sharded``; logs each
    step's launches, collectives and wall time."""
    import torch
    want, per_block, tin = ref["want"], ref["per_block"], ref["tin"]
    total = ref["total"]
    world = len(res)
    inits = {"serve": check_init(ph.arch, [r["init"] for r in res], total)}
    if tin is not None:
        inits["train"] = check_init(
            ph.arch, [r["out"]["train"]["init"] for r in res], total)
    train_run = (check_sharded_train([r["out"]["train"] for r in res], tin)
                 if tin is not None else {})
    bad = []
    near = max(r["pins"]["near"] for r in res)
    apart = min(r["pins"]["apart"] for r in res)
    log(f"sharded {ph.arch} routes pinned: farthest match {near:.3e} of the "
        f"reference token's norm (limit {PIN_NEAR}), next nearest at least "
        f"{apart:.3f} times as far (limit {PIN_APART})")
    if not (near <= PIN_NEAR and apart >= PIN_APART):
        bad.append(f"pinning: match {near}, apart {apart}")
    # each data rank's rows; every rank of a data row holds the same
    by_data = {r["coords"]["data"]: r for r in res
               if r["coords"]["model"] == 0}
    h_parts = sorted(((r["coords"]["model"], r["out"]["layered"][2])
                      for r in res if r["coords"]["data"] == 0),
                     key=lambda x: x[0])
    pairs = {key: (torch.cat([by_data[d]["out"][key][0]
                              for d in range(SHARD_MESH[0])]), want[key][0])
             for key in want}
    pairs["layered h_out"] = (torch.cat([h for _, h in h_parts], dim=1)[0],
                              want["layered"][2][0])
    whole_only = {"layered h_out", "encoder"}
    report, n_tokens, parted = {}, 0, 0
    for key, (got, ref_) in pairs.items():
        rel = ((got - ref_).norm() / ref_.norm()).item()
        rep = {"rel_fro": rel}
        ok = bool(torch.isfinite(got).all()) and rel <= E2E_REL_FRO
        if key not in whole_only:
            a, b_ = got.argmax(-1), ref_.argmax(-1)
            top2 = ref_.topk(2, dim=-1).values
            gaps = [(float(top2[i, 0] - top2[i, 1])
                     / _bf16_ulp(float(top2[i, 0])))
                    for i in torch.nonzero(a != b_).flatten().tolist()]
            rep["greedy_equal"] = int((a == b_).sum())
            rep["greedy"] = int(a.numel())
            rep["parted_gap_ulps"] = gaps
            rep["counts_equal"] = all(torch.equal(r["out"][key][1],
                                                  want[key][1]) for r in res)
            if key == "layered":
                rep["counts_equal"] &= all(torch.equal(
                    r["out"][key][3], want[key][3]) for r in res)
            ok = ok and rep["counts_equal"] and all(
                gap <= NEAR_TIE_ULPS for gap in gaps)
            n_tokens += int(a.numel())
            parted += len(gaps)
        report[key] = rep
        if not ok:
            bad.append(f"{key}: {rep}")
    log(f"sharded {ph.arch} against unsharded, end to end (routes pinned; "
        f"logits "
        f"tol {E2E_REL_FRO}, greedy tokens may part only below "
        f"{NEAR_TIE_ULPS} ulps) " + json.dumps(report))
    # each block alone from the unsharded run's input to it: its update
    forced_rep, worst = {}, 0.0
    for key, xys in per_block.items():
        rows_ = []
        for j, (x, y) in enumerate(xys):
            parts = {}
            for r in res:
                c = r["coords"]
                parts[(c["data"], c["model"])] = r["out"]["blocks"][key][j]
            b_, s_ = y.shape[:2]
            ds = SHARD_MESH[0] if parts[(0, 0)].shape[0] < b_ else 1
            ms_ = SHARD_MESH[1] if parts[(0, 0)].shape[1] < s_ else 1
            got = torch.cat([torch.cat([parts[(d, m)] for m in range(ms_)],
                                       dim=1) for d in range(ds)], dim=0)
            rel = ((got - y).norm() / (y - x).norm()).item()
            rows_.append(rel)
            worst = max(worst, rel)
            if not torch.isfinite(got).all() or not rel <= BLOCK_TOL:
                bad.append(f"{key} block {j}: update rel {rel}")
        forced_rep[key] = rows_
    log(f"sharded {ph.arch} against unsharded, each block teacher-forced: "
        f"update "
        f"rel Frobenius a block (tol {BLOCK_TOL}) " + json.dumps(forced_rep))
    if bad:
        raise AssertionError(f"sharded {ph.arch} disagrees with the "
                             f"unsharded port: {bad}")
    steps_rep, launches = [], collections.Counter()
    for i, st in enumerate(res[0]["stats"]):
        per = collections.Counter()
        for r in res:
            per.update(r["stats"][i]["launches"])
        coll = {k: {"calls": sum(r["stats"][i]["coll"][k]["calls"]
                                 for r in res),
                    "bytes": sum(r["stats"][i]["coll"][k]["bytes"]
                                 for r in res)}
                for k in res[0]["stats"][i]["coll"]}
        wall = max(r["stats"][i]["s"] for r in res)
        steps_rep.append({"step": st["step"], "launches": dict(per),
                          "collectives": coll, "wall_s": wall})
        log(f"sharded {ph.arch} {st['step']}: launches {dict(per)} (over "
            f"{world} "
            f"ranks); collectives {json.dumps(coll)}; wall {wall:.3f} s")
        launches.update(per)
    for r in res:
        for k in ph.kernels:
            if not sum(st["launches"][k] for st in r["stats"]):
                raise AssertionError(f"rank {r['coords']}: {k} never "
                                     "launched in the sharded phase")
        others = {k: sum(st["launches"][k] for st in r["stats"])
                  for k in r["stats"][0]["launches"] if k not in ph.kernels}
        if any(others.values()):
            raise AssertionError(f"rank {r['coords']}: kernels off the "
                                 f"phase's path launched: {others}")
    log(f"sharded {ph.arch} ({ph.layers} of {total} layers, mesh "
        f"{SHARD_MESH}, {world} ranks on one card over gloo): against the "
        f"unsharded port, routes pinned: logits of {len(want)} steps within "
        f"{E2E_REL_FRO}, {parted} of {n_tokens} greedy tokens parted at "
        f"near-ties; every teacher-forced block update within {BLOCK_TOL} "
        f"(worst {worst:.3e}); gloo took every collective on CUDA tensors; "
        f"peak memory a rank {max(r['mem'] for r in res) / 1e9:.2f} GB.  "
        f"Wall times are the harness (16 processes on one card, gloo "
        f"through the host), not a cluster")
    return {"runs": {f"{ph.arch} sharded": {
        "arch": f"{ph.arch} sharded", "launches": dict(launches),
        "iterations": len(steps_rep), "steps": steps_rep,
        "against_unsharded": report, "teacher_forced": forced_rep,
        "pinning": {"near": near, "apart": apart}, "init": inits},
        **train_run}}


# ---------------------------------------------------------------- phase 11

DRYRUNS = (("qwen3-moe-235b-a22b", "prefill_32k", False),
           ("qwen3-moe-235b-a22b", "decode_32k", True),
           ("qwen3-30b-a3b", "train_4k", False),
           ("recurrentgemma-9b", "long_500k", False),
           ("whisper-base", "prefill_32k", True))


def start_dryruns() -> list:
    """Phase 11, on the host: the multi-device dry-run (fake process
    group, fake CUDA tensors, every layer traced) of qwen3-moe-235b-a22b
    at prefill_32k on 16x16 and at decode_32k on 2x16x16, and of
    qwen3-30b-a3b's sharded training step at train_4k on 16x16, each in
    its own process, started beside phase 4's serves (they use no card,
    and the serves keep one core busy)."""
    procs = []
    for arch, shape, multi in DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out",
               str(ROOT / "build" / "dryrun_torch")]
        if multi:
            cmd.append("--multi-pod")
        procs.append((arch, shape, subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "PYTHONPATH": str(SRC)})))
    return procs


def finish_dryruns(procs: list, times: dict, t0: float) -> list:
    """Wait for ``start_dryruns``' processes; print each JSON line."""
    recs = []
    for arch, shape, proc in procs:
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"dry-run {arch} {shape} failed: "
                                 f"{err[-2000:]}")
        for line in out.splitlines():
            if line.startswith("[dryrun] json "):
                rec = json.loads(line[len("[dryrun] json "):])
                if rec.get("status") != "ok":
                    raise AssertionError(f"dry-run {arch} {shape}: {rec}")
                recs.append(rec)
                log("dry-run " + line[len("[dryrun] json "):])
    _phase("dry-runs (beside phases 4-10d)", t0, times)
    return recs


def model_of(row: str) -> str:
    """The model whose serves (or training run) a kernel row's shapes
    come from."""
    for key, arch in (("deepseek sharded train",
                       "deepseek-v2-236b sharded train"),
                      ("recurrentgemma sharded", "recurrentgemma-9b sharded"),
                      ("whisper sharded train", "whisper-base sharded train"),
                      ("whisper sharded cross train",
                       "whisper-base sharded train"),
                      ("whisper sharded", "whisper-base sharded"),
                      ("deepseek sharded", "deepseek-v2-236b sharded"),
                      ("sharded train", "qwen3-30b-a3b sharded train"),
                      ("sharded", "qwen3-30b-a3b sharded"),
                      ("minicpm", "minicpm-2b train"),
                      ("qwen3 train", "qwen3-30b-a3b train"),
                      ("qwen3 P 2048", "qwen3-30b-a3b train"),
                      ("bwd[padded]", "qwen3-30b-a3b train"),
                      ("bwd[qwen3 C", "qwen3-30b-a3b train"),
                      ("recurrentgemma train", "recurrentgemma-9b train"),
                      ("recurrentgemma P 4096", "recurrentgemma-9b train"),
                      ("deepseek train", "deepseek-v2-236b train"),
                      ("whisper cross train", "whisper-base train"),
                      # the training path feeds enc_out and runs no
                      # encoder; whisper-base's serves run it (K2 non-
                      # causal at 1500 frames) at every admission
                      ("whisper encoder train", "whisper-base"),
                      ("recurrentgemma", "recurrentgemma-9b"),
                      ("whisper", "whisper-base"),
                      ("qwen2-vl", "qwen2-vl-72b"),
                      ("gpt-oss", "gpt-oss-20b"), ("phi4", "phi4-mini-3.8b"),
                      ("yi-34b", "yi-34b"), ("deepseek", "deepseek-v2-236b"),
                      ("qwen3-235b", "qwen3-moe-235b-a22b")):
        if key in row:
            return arch
    return "qwen3-30b-a3b"


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
    import numpy as np
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
    # (HGMMA) and their tiles arrive by TMA (UTMALDG); the decode and the
    # paged kernels' on mma.sync (HMMA) fed by cp.async (LDGSTS)
    sass = {k: build.sass_counts(k) for k in (
        "prefill_attention", "moe_gmm_ragged", "moe_gmm",
        "prefill_attention_bwd", "moe_gmm_bwd")}
    mma = {k: build.sass_counts(k, ("HMMA", "LDGSTS", "MOVM"))
           for k in ("decode_attention", "paged_attention")}
    log(f"SASS opcodes: {sass}, {mma}")
    for k in ("moe_gmm_ragged", "moe_gmm", "prefill_attention_bwd",
              "moe_gmm_bwd"):
        if sass[k] is not None and not (sass[k]["HGMMA"] > 0
                                        and sass[k]["UTMALDG"] > 0):
            raise AssertionError(f"{k}: no wgmma or TMA in its SASS: {sass[k]}")
    if mma["paged_attention"] is not None and not mma["paged_attention"]["HMMA"]:
        raise AssertionError(f"paged_attention: no mma.sync in its SASS: "
                             f"{mma['paged_attention']}")

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
    # gpt-oss-20b's shapes, as its serves give them: K1 at the 8-slot
    # decode step and a 2048-token prefill (E 32 top-4, d = F = 2880, off
    # the 128-column d-tile), K2 at hd 64, g 8 at a layered first group
    # and a chunked step, K3 at hd 64 at the long and the short trace's
    # decode step, K4 at the dense decode step and the short trace's
    # packed prefill
    kernels += [check_moe_gmm("gpt-oss decode", 8, gen, GPT_OSS_MOE),
                check_moe_gmm("gpt-oss prefill", 2048, gen, GPT_OSS_MOE),
                check_prefill_attention("gpt-oss layered", gen,
                                        heads=GPT_OSS_ATTN),
                check_prefill_attention("gpt-oss chunked", gen, b=4, p=512,
                                        offsets=[0, 512, 1024, 1536],
                                        heads=GPT_OSS_ATTN),
                check_decode_attention(gen, "gpt-oss long",
                                       heads=GPT_OSS_ATTN),
                check_decode_attention(gen, "gpt-oss short", s_max=512,
                                       len_range=(65, 266),
                                       heads=GPT_OSS_ATTN)]
    torch.cuda.empty_cache()
    kernels += [check_moe_gmm_dense("gpt-oss decode", 8, gen, GPT_OSS_MOE),
                check_moe_gmm_dense("gpt-oss prefill", 1024, gen,
                                    GPT_OSS_MOE)]
    torch.cuda.empty_cache()
    # K2 at group sizes that do not divide its 128 rows: the layered first
    # group of phi4-mini (g 3) and yi-34b (g 7); K2 at the verify window
    # (spec_k 4 plus the bonus token) of 8 qwen3 rows deep in their cache;
    # K3 at g 3 and g 7; and K2 at g 8 bit for bit the kernel before
    # its repair
    offsets = [int(o) for o in np.linspace(700, 2000, 8)]
    kernels += [check_prefill_attention("phi4-mini layered", gen,
                                        heads=PHI4_MINI_ATTN),
                check_prefill_attention("yi-34b layered", gen,
                                        heads=YI_34B_ATTN),
                check_prefill_attention("verify window", gen, b=8, p=5,
                                        offsets=offsets, cold=True),
                check_decode_attention(gen, "phi4-mini long",
                                       heads=PHI4_MINI_ATTN),
                check_decode_attention(gen, "yi-34b long",
                                       heads=YI_34B_ATTN)]
    torch.cuda.empty_cache()
    # K3 with its log-sum-exp (phase 10's split softmax over a sequence-
    # split cache): the serve step's bits kept, the slices' clamped lengths
    kernels.append(check_decode_lse(gen))
    torch.cuda.empty_cache()
    # the large MoE models' shapes: K2 and K3 at MLA's (192, 128) widths
    # (deepseek-v2-236b: H = Hkv = 128) at a layered first group and the
    # long trace's decode step, and at g 16 (qwen3-moe-235b-a22b); K1 at
    # both models' widths and K4 at deepseek's, as at gpt-oss
    kernels += [check_prefill_attention("deepseek layered", gen,
                                        heads=DEEPSEEK_ATTN),
                check_decode_attention(gen, "deepseek long",
                                       len_range=(600, 2050),
                                       heads=DEEPSEEK_ATTN)]
    torch.cuda.empty_cache()
    kernels += [check_prefill_attention("qwen3-235b layered", gen,
                                        heads=QWEN3_235B_ATTN),
                check_decode_attention(gen, "qwen3-235b long",
                                       heads=QWEN3_235B_ATTN)]
    torch.cuda.empty_cache()
    for tag, widths in (("deepseek", DEEPSEEK_MOE),
                        ("qwen3-235b", QWEN3_235B_MOE)):
        kernels += [check_moe_gmm(f"{tag} decode", 8, gen, widths),
                    check_moe_gmm(f"{tag} prefill", 2048, gen, widths)]
        torch.cuda.empty_cache()
    kernels += [check_moe_gmm_dense("deepseek decode", 8, gen, DEEPSEEK_MOE),
                check_moe_gmm_dense("deepseek prefill", 1024, gen,
                                    DEEPSEEK_MOE)]
    torch.cuda.empty_cache()
    # recurrentgemma-9b's local attention: K2 and K3 at (256, 256), g 16,
    # window 2048: a layered first group (4 prompts of 2048 tokens), a
    # chunked step (512-token chunks at offsets 2048-3584 of a 4096-row
    # cache, where the window binds) and the 8-slot decode step of the
    # long trace (lengths 2100-4096, an idle slot at S_max + 1)
    kernels += [check_prefill_attention("recurrentgemma layered", gen,
                                        heads=RECURRENTGEMMA_ATTN,
                                        window=2048),
                check_prefill_attention("recurrentgemma chunked", gen, b=4,
                                        p=512, s_max=4096,
                                        offsets=[2048, 2560, 3072, 3584],
                                        heads=RECURRENTGEMMA_ATTN,
                                        window=2048),
                check_decode_attention(gen, "recurrentgemma long", s_max=4096,
                                       len_range=(2100, 4097),
                                       heads=RECURRENTGEMMA_ATTN,
                                       window=2048)]
    torch.cuda.empty_cache()
    # whisper-base: K2 non-causal at the encoder (1 x 1500 frames over
    # themselves) and at cross-attention prefill (4 x 512 prompt tokens
    # over 1500 frames), K3 at cross decode (8 slots, lengths 1500: 24
    # key tiles, the last of 28 keys), K2 and K3 causal at its decoder's
    # short trace; qwen2-vl-72b's 64/8 heads of 128 at the long trace
    kernels += [check_prefill_attention("whisper encoder", gen, b=1,
                                        p=WHISPER_FRAMES,
                                        s_max=WHISPER_FRAMES,
                                        heads=WHISPER_ATTN, causal=False),
                check_prefill_attention("whisper cross prefill", gen, b=4,
                                        p=512, s_max=WHISPER_FRAMES,
                                        heads=WHISPER_ATTN, causal=False),
                check_decode_attention(gen, "whisper cross decode",
                                       s_max=WHISPER_FRAMES,
                                       heads=WHISPER_ATTN, full=True),
                check_prefill_attention("whisper layered", gen, b=4, p=256,
                                        s_max=512, heads=WHISPER_ATTN),
                check_decode_attention(gen, "whisper short", s_max=512,
                                       len_range=(65, 266),
                                       heads=WHISPER_ATTN),
                check_prefill_attention("qwen2-vl layered", gen,
                                        heads=QWEN2_VL_ATTN),
                check_decode_attention(gen, "qwen2-vl long",
                                       heads=QWEN2_VL_ATTN)]
    torch.cuda.empty_cache()
    # training (phase 9's shapes): K2's forward with the log-sum-exp and
    # its backward at minicpm-2b's (36/36 heads of 64) and qwen3-30b-a3b's
    # (32/4 of 128) heads, at the launcher's 8 x 256 tokens and at 2048-
    # token rows; K4's backward at qwen3's widths (C 160: 2048 tokens; C
    # 130, two real rows past two warpgroups; C 1, one 8-row tile) and at
    # widths off a multiple of 8 (the padded copy)
    kernels += check_prefill_attention_bwd("minicpm train", gen, TRAIN_B,
                                           TRAIN_SEQ, MINICPM_TRAIN_ATTN)
    kernels += check_prefill_attention_bwd("qwen3 train", gen, TRAIN_B,
                                           TRAIN_SEQ, QWEN3_ATTN)
    torch.cuda.empty_cache()
    kernels += check_prefill_attention_bwd("minicpm P 2048", gen, 2, 2048,
                                           MINICPM_TRAIN_ATTN)[1:]
    kernels += check_prefill_attention_bwd("qwen3 P 2048", gen, 2, 2048,
                                           QWEN3_ATTN)[1:]
    torch.cuda.empty_cache()
    kernels += [check_moe_gmm_bwd("qwen3 train", QWEN3_TRAIN_C, gen),
                check_moe_gmm_bwd("qwen3 C 130", 130, gen),
                check_moe_gmm_bwd("qwen3 C 1", 1, gen),
                check_moe_gmm_bwd("padded", 40, gen, (8, 2, 2044, 764))]
    torch.cuda.empty_cache()
    # the other archs' training attention: recurrentgemma-9b's local
    # attention (16/1 heads of 256, window 2048) at the launcher's 8 x 256
    # tokens and at one 4096-token row, where the window binds;
    # deepseek-v2-236b's MLA (128 heads, 192/128); whisper-base's cross-
    # attention (8 x 256 over 1500 frames) and its encoder (1500 over
    # 1500: not on the training path, which feeds enc_out)
    kernels += check_prefill_attention_bwd(
        "recurrentgemma train", gen, TRAIN_B, TRAIN_SEQ, RECURRENTGEMMA_ATTN,
        window=2048)
    kernels += check_prefill_attention_bwd(
        "recurrentgemma P 4096", gen, 1, 4096, RECURRENTGEMMA_ATTN,
        window=2048)
    torch.cuda.empty_cache()
    kernels += check_prefill_attention_bwd("deepseek train", gen, TRAIN_B,
                                           TRAIN_SEQ, DEEPSEEK_ATTN)
    torch.cuda.empty_cache()
    kernels += check_prefill_attention_bwd(
        "whisper cross train", gen, TRAIN_B, TRAIN_SEQ, WHISPER_ATTN,
        s_max=WHISPER_FRAMES, causal=False)
    kernels += check_prefill_attention_bwd(
        "whisper encoder train", gen, 1, WHISPER_FRAMES, WHISPER_ATTN,
        causal=False)
    torch.cuda.empty_cache()
    # phase 10b's shapes on each rank (``sharded_train_shapes``): K2 with
    # its log-sum-exp and its backward over the rank's rows at its heads
    # (the "gqa" region's head block over every kv head), K4 and its
    # backward over the a2a regime's (E_loc, C tp, d) buffer at full F
    b_r, heads, moe_w, c_tp = sharded_train_shapes()
    kernels += check_prefill_attention_bwd("sharded train", gen, b_r,
                                           TRAIN_SHARD_S, heads)
    kernels += [check_moe_gmm_dense(f"sharded train C {c_tp}", c_tp, gen,
                                    moe_w),
                check_moe_gmm_bwd(f"sharded train C {c_tp}", c_tp, gen,
                                  moe_w)]
    torch.cuda.empty_cache()
    # phase 10c's shapes on each rank (``deepseek_shard_shapes``): K3 with
    # its log-sum-exp for all 128 heads over a rank's 128-position slice
    # of the 1024-row latent (rows of 520 and 1000 tokens: some slices
    # empty); K2 at g 1 over a rank's heads, its row of the prefill over
    # the gathered latent, and its backward at the training step's rows;
    # K1 and K4 over a rank's experts: the a2a prefill at full F (the
    # rank's share of the assignments ragged, its dense buffer) and the
    # gathered decode over its F shard
    ds = deepseek_shard_shapes()
    kernels += [check_decode_lse(gen, "deepseek", DEEPSEEK_ATTN,
                                 rows=(520, 1000), out_tol=ATTN_TOL),
                check_prefill_attention("deepseek sharded prefill", gen,
                                        b=ds["rows"], p=SHARD_S,
                                        s_max=SHARD_CACHE, heads=ds["heads"])]
    torch.cuda.empty_cache()
    kernels += [check_moe_gmm("deepseek sharded prefill", ds["a2a_tokens"],
                              gen, ds["moe_full"]),
                check_moe_gmm_dense(f"deepseek sharded prefill C "
                                    f"{ds['a2a_c']}", ds["a2a_c"], gen,
                                    ds["moe_full"]),
                check_moe_gmm_dense("deepseek sharded decode C "
                                    f"{ds['decode_c']}", ds["decode_c"], gen,
                                    ds["moe_shard"])]
    torch.cuda.empty_cache()
    kernels += check_prefill_attention_bwd("deepseek sharded train", gen,
                                           ds["train_rows"], TRAIN_SHARD_S,
                                           ds["heads"])
    torch.cuda.empty_cache()
    # phase 10d's shapes on each rank (``phase10d_shapes``):
    # recurrentgemma-9b's local attention, K2 under the window over the
    # gathered 4096-row cache (a rank's 2 of 16 heads, its row of the
    # 2816-token prefill) and over a 512-position slice (the layered row,
    # all 16 heads, with its log-sum-exp); K3 with its log-sum-exp under
    # the window over the slices, rows at 2817 and 2824 (slice 0 before
    # the window's edge, slice 1 cut by it); whisper-base on a rank's one
    # head: K2 non-causal over 1500 frames (the encoder) and for its row
    # of the cross prefill, K3 over the cross cache, K2 and its backward
    # at the training step's rows (self-attention and cross-attention)
    sh = phase10d_shapes()
    kernels += [check_prefill_attention(
                    "recurrentgemma sharded prefill", gen, b=sh["rows"],
                    p=RECURRENTGEMMA_SHARD.s, s_max=RECURRENTGEMMA_SHARD.cache,
                    heads=sh["rg_heads"], window=2048),
                check_decode_lse(gen, "recurrentgemma", RECURRENTGEMMA_ATTN,
                                 rows=(RECURRENTGEMMA_SHARD.s + 1,
                                       RECURRENTGEMMA_SHARD.s + SHARD_DECODES),
                                 out_tol=ATTN_TOL, s_max=4096,
                                 len_range=(2100, 4097),
                                 cache=RECURRENTGEMMA_SHARD.cache,
                                 slice_len=sh["rg_slice"], window=2048)]
    kernels += check_prefill_attention_bwd(
        "recurrentgemma sharded layered", gen, 1, SHARD_P,
        RECURRENTGEMMA_ATTN, window=2048, s_max=sh["rg_slice"])[:1]
    torch.cuda.empty_cache()
    kernels += [check_prefill_attention("whisper sharded encoder", gen, b=sh["rows"],
                                        p=WHISPER_FRAMES, s_max=WHISPER_FRAMES,
                                        heads=sh["wh_heads"], causal=False),
                check_prefill_attention("whisper sharded cross prefill", gen,
                                        b=sh["rows"], p=SHARD_S,
                                        s_max=WHISPER_FRAMES,
                                        heads=sh["wh_heads"], causal=False),
                check_decode_attention(gen, "whisper sharded cross decode",
                                       b=sh["rows"], s_max=WHISPER_FRAMES,
                                       heads=sh["wh_heads"], full=True)]
    kernels += check_prefill_attention_bwd("whisper sharded train", gen,
                                           sh["train_rows"], TRAIN_SHARD_S,
                                           sh["wh_heads"])
    kernels += check_prefill_attention_bwd(
        "whisper sharded cross train", gen, sh["train_rows"], TRAIN_SHARD_S,
        sh["wh_heads"], s_max=WHISPER_FRAMES, causal=False)
    torch.cuda.empty_cache()
    digest = k2_bwd_digest()
    log(f"prefill_attention_bwd at (64, 64) and (128, 128): gradients sha256 "
        f"{digest} (pinned: {K2_BWD_SHA256})")
    if digest != K2_BWD_SHA256:
        raise AssertionError("prefill_attention_bwd no longer gives the bits "
                             "pinned in K2_BWD_SHA256")
    digest = k2_g8_digest()
    log(f"prefill_attention at g 8: outputs sha256 {digest} (the kernel "
        f"before its repair: {K2_G8_SHA256})")
    if digest != K2_G8_SHA256:
        raise AssertionError("prefill_attention at g 8 no longer gives the "
                             "bits it gave before it took every group size")
    for k in kernels:
        k["bound_share"] = k["bound_ms"] / k["ms"]
    check_small_model_end_to_end()
    check_small_mla_end_to_end()
    check_small_recurrent_end_to_end()
    check_small_encdec_end_to_end()
    check_small_training_end_to_end()
    torch.cuda.empty_cache()
    times: dict = {}
    _phase("build and kernel checks", t_start, times)
    if "--skip-serve" in sys.argv[1:]:
        print(json.dumps({"kernels": kernels}))
        raise SystemExit("[chip_smoke] --skip-serve: stopped after the kernel "
                         "checks; no result")

    # the dry-runs use the host only: they start beside the serves, which
    # each keep one core busy, and are read after phase 10d
    t_dry = time.perf_counter()
    dry_procs = start_dryruns()
    try:
        qwen = serve_qwen3(times,
                           explain="--explain-divergence" in sys.argv[1:])
        gc.collect()
        torch.cuda.empty_cache()
        oss = serve_gpt_oss(times)
        gc.collect()
        torch.cuda.empty_cache()
        large = serve_large_moe(times)
        gc.collect()
        torch.cuda.empty_cache()
        dense = serve_dense(times)
        gc.collect()
        torch.cuda.empty_cache()
        recurrent = serve_recurrent(times)
        gc.collect()
        torch.cuda.empty_cache()
        whisper = serve_whisper(times)
        vl = serve_qwen2_vl(times)
        gc.collect()
        torch.cuda.empty_cache()
        train = train_models(times)
        gc.collect()
        torch.cuda.empty_cache()
        # phases 10, 10b, 10c and 10d: one pool of 16 ranks, one model
        # after the other
        sharded = serve_sharded(times, QWEN3_SHARD, then=(
            DEEPSEEK_SHARD, RECURRENTGEMMA_SHARD, XLSTM_SHARD,
            WHISPER_SHARD))
        dry = finish_dryruns(dry_procs, times, t_dry)
    finally:
        for _, _, proc in dry_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    runs = {**qwen["runs"], **oss["runs"], **large["runs"], **dense["runs"],
            **recurrent["runs"], **whisper["runs"], **vl["runs"], **train,
            **sharded["runs"]}
    # each kernel row's launches: the sum over its own model's serves,
    # each counted from 0 just before it and read just after
    launches, iters = {}, collections.Counter()
    for r in runs.values():
        per = launches.setdefault(r["arch"], collections.Counter())
        per.update(r["launches"])
        iters[r["arch"]] += r["iterations"]
    for k in kernels:
        k["launches_of"] = model_of(k["name"])
        k["launches"] = launches[k["launches_of"]][k["name"].split("[")[0]]
        k["iterations_of"] = iters[k["launches_of"]]
    drop = ("outputs", "prompts", "max_new", "plans", "admission_log")
    log("serve summary " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk not in drop}
         for k, v in runs.items()}))
    if qwen["divergence"] is not None:
        log("bf16 divergence " + json.dumps(qwen["divergence"]))
    log("spec streams against spec off " + json.dumps(
        {**qwen["spec"], "phi4-mini ngram": dense["spec"]}))
    log("two-pool and chaos streams " + json.dumps(qwen["disagg"]))
    log("live, per-slice and simulator " + json.dumps(qwen["live"]))
    log("large MoE depths " + json.dumps(large["depths"]))
    log("recurrentgemma partings from the requests served alone "
        + json.dumps(recurrent["parted"]))
    log("whisper partings " + json.dumps(whisper["parted"]))
    log(f"qwen2-vl-72b depth {vl['depth']}")
    log("dry-run summary " + json.dumps(
        [{k: r[k] for k in ("arch", "shape", "mesh", "peak_memory_per_device",
                            "hlo_flops", "hlo_bytes", "collective_bytes",
                            "bottleneck")} for r in dry]))
    log("phase seconds " + json.dumps({k: round(v, 1)
                                       for k, v in times.items()}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
