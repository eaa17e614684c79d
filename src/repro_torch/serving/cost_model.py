"""Analytic hardware cost model for the discrete-event simulator — the
port's copy of the JAX package's ``serving/cost_model.py``.

Roofline-style: each iteration's duration is
    max(flops / (eff_c * FLOPS), hbm_bytes / (eff_m * BW)) + fixed overhead
and its energy is
    P_static * duration + hbm_bytes * e_hbm + flops * e_flop.

Two presets ship: ``H100X2`` approximates the paper's testbed (2xH100
NVLink, TP=2) so the reproduction can be compared against the paper's
absolute numbers; ``TPU_V5E`` is the JAX package's TPU preset, kept so
that ``--hw tpu_v5e`` selects the same model in both packages.  Every
constant here is a MODEL INPUT: nothing the simulator prints is a time
measured on any device.

MoE expert-touch modelling uses the uniform-routing coverage expectation
    E[unique experts | n tokens] = E * (1 - (1 - k/E)^n)
with a correlated-routing exponent fitted to the paper's Table 1.
"""

from __future__ import annotations

import numpy as np

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.plan import IterationPlan, PrefillSlice, Request
from repro_torch.models.config import FFN_MOE, ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    n_chips: int
    flops_per_chip: float          # bf16 FLOP/s
    hbm_bw_per_chip: float         # bytes/s
    link_bw: float                 # bytes/s per link (ICI / NVLink)
    hbm_capacity_per_chip: float   # bytes
    static_power_w: float          # per chip, idle+base
    e_hbm_pj_per_byte: float
    e_flop_pj: float
    compute_eff: float = 0.65      # achievable fraction of peak
    mem_eff: float = 0.75
    iter_overhead_s: float = 250e-6
    # fixed per-block cost (kernel sequence / MoE dispatch machinery);
    # dominates small-batch decode iterations on the paper's GPU testbed.
    block_overhead_s: float = 30e-6
    # host <-> HBM DMA path (PCIe / DMA engines), aggregate across the
    # chips that share the host link — what swap-to-host preemption pays
    # per direction.  e_host covers the end-to-end byte move (PCIe PHY +
    # host DRAM touch), an order of magnitude above the on-package HBM
    # path.  host_dma_latency_s is the fixed per-transfer setup cost
    # (descriptor build, submission, completion interrupt) paid
    # once per direction regardless of size — the term that makes tiny
    # swaps more expensive than their byte count suggests.
    host_bw: float = 50e9          # bytes/s
    e_host_pj_per_byte: float = 60.0
    host_dma_latency_s: float = 50e-6
    # inter-pool link (the disaggregated prefill→decode KV handoff path):
    # ``link_bw`` above is the raw per-link bandwidth; e_link covers the
    # end-to-end byte move over the serdes + remote HBM touch, and
    # link_latency_s the fixed per-transfer setup cost (one RDMA/ICI
    # descriptor per handoff chunk).
    e_link_pj_per_byte: float = 20.0
    link_latency_s: float = 5e-6

    @property
    def flops(self) -> float:
        return self.n_chips * self.flops_per_chip * self.compute_eff

    @property
    def hbm_bw(self) -> float:
        return self.n_chips * self.hbm_bw_per_chip * self.mem_eff

    @property
    def ridge_op_per_byte(self) -> float:
        return self.flops_per_chip / self.hbm_bw_per_chip


# The paper's testbed: 2 × H100-80GB SXM, NVLink, tensor parallel.
# compute_eff / mem_eff calibrated against the paper's microbenchmarks
# (Fig. 2: chunk-512 hybrid iteration ≈ 30 ms on Qwen3-30B-A3B; Table 6:
# decode-batch ≈ 16–32 iterations ≈ 21–33 ms) — grouped-GEMM at ~64 tokens
# per expert plus per-layer TP all-reduce lands well under peak HBM bw.
# Energy constants are WHOLE-GPU (NVML-style, as the paper measures):
# e_hbm is the system-level energy per byte moved through the memory path
# (~150 W incremental per chip at full stream ≈ 100 pJ/B), not bare HBM
# cell energy; static covers idle+clocking.
H100X2 = HardwareSpec(
    name="h100x2", n_chips=2,
    flops_per_chip=989e12, hbm_bw_per_chip=3.35e12, link_bw=450e9,
    hbm_capacity_per_chip=80e9, static_power_w=150.0,
    e_hbm_pj_per_byte=100.0, e_flop_pj=0.4,
    compute_eff=0.55, mem_eff=0.50, iter_overhead_s=300e-6,
    block_overhead_s=300e-6,
    # 2 x PCIe gen5 x16 (~55 GB/s usable each) to host DRAM
    host_bw=110e9, e_host_pj_per_byte=60.0, host_dma_latency_s=50e-6,
    # NVLink pool-to-pool: cheap per byte, microsecond-class setup
    e_link_pj_per_byte=15.0, link_latency_s=3e-6,
)

# The JAX package's TPU preset (selectable with --hw tpu_v5e).
TPU_V5E = HardwareSpec(
    name="tpu_v5e", n_chips=1,
    flops_per_chip=197e12, hbm_bw_per_chip=819e9, link_bw=50e9,
    hbm_capacity_per_chip=16e9, static_power_w=90.0,
    e_hbm_pj_per_byte=6.0, e_flop_pj=0.45,
    # PCIe gen3-class host attach on v5e boards; runtime-mediated DMA
    # submission carries a higher fixed latency than the GPU's path
    host_bw=16e9, e_host_pj_per_byte=80.0, host_dma_latency_s=100e-6,
    # ICI pool-to-pool: lower bandwidth than NVLink, runtime-mediated
    # descriptor submission carries a higher fixed latency
    e_link_pj_per_byte=25.0, link_latency_s=10e-6,
)


def kv_pool_pages(cfg: ModelConfig, hw: HardwareSpec, page_size: int = 16,
                  bytes_per_param: int = 2, bytes_per_act: int = 2,
                  util: float = 0.9) -> int:
    """Pages the hardware's HBM can dedicate to the paged KV pool: total
    capacity × ``util`` minus model weights, divided by the per-page KV
    footprint.  This is how the simulator (and a TPU deployment) sizes
    ``PagedKVAllocator`` so the paper-scale sweeps run under the SAME
    memory bound the engine would face."""
    cap = hw.n_chips * hw.hbm_capacity_per_chip * util
    weights = cfg.param_count() * bytes_per_param
    kv_per_page = max(cfg.kv_bytes_per_token(bytes_per_act), 1) * page_size
    pages = int((cap - weights) // kv_per_page)
    # models bigger than the modeled chip count would be sharded wider in
    # reality — keep the analytic pool at a 5%-of-capacity floor instead
    # of refusing to simulate
    floor = max(1, int(cap * 0.05 // kv_per_page))
    return max(pages, floor)


# Real routing is CORRELATED (tokens in a batch favour similar experts), so
# the uniform model overestimates mid-range coverage. We model this with an
# effective-token exponent n_eff = n^alpha; alpha = 0.785 is the minimax fit
# to the paper's measured Table 1 (Qwen3-30B-A3B on ShareGPT, <19% rel err
# at every batch size, exact at n=1). alpha=1.0 recovers uniform routing.
COVERAGE_CORRELATION_ALPHA = 0.785


def expected_coverage(n_experts: int, top_k: int, n_tokens: float,
                      alpha: float = COVERAGE_CORRELATION_ALPHA) -> float:
    """E[#unique experts] activated by n tokens routed top-k, under the
    Table-1-calibrated correlated-routing model."""
    if n_experts <= 0:
        return 0.0
    if n_tokens <= 0:
        return 0.0
    n_eff = n_tokens ** alpha
    return n_experts * (1.0 - (1.0 - top_k / n_experts) ** n_eff)


@dataclass
class BlockCost:
    flops: float = 0.0
    weight_bytes: float = 0.0
    kv_bytes: float = 0.0
    expert_bytes: float = 0.0      # subset of weight_bytes, tracked separately

    def add(self, o: "BlockCost") -> None:
        self.flops += o.flops
        self.weight_bytes += o.weight_bytes
        self.kv_bytes += o.kv_bytes
        self.expert_bytes += o.expert_bytes


class CostModel:
    """``moe_dispatch`` mirrors the engine's MoE data path:

    - "ragged" (default): expert GMM rows scale with the routed work
      (top_k per token) and expert weight traffic with the coverage
      expectation — the analytic twin of the ragged dropless pipeline
      (models/moe.py + kernels/moe_gmm_ragged.py).
    - "dense": the worst-case dropless capacity buffer — every expert
      computes a full (T, d) slab, so GMM flops carry an E/top_k
      amplification and ALL E experts' weights stream each pass.
    """

    def __init__(self, cfg: ModelConfig, hw: HardwareSpec,
                 bytes_per_param: int = 2, bytes_per_act: int = 2,
                 moe_dispatch: str = "ragged"):
        self.cfg = cfg
        self.hw = hw
        self.bp = bytes_per_param
        self.ba = bytes_per_act
        if moe_dispatch not in ("dense", "ragged"):
            raise ValueError(f"unknown moe_dispatch {moe_dispatch!r}")
        self.moe_dispatch = moe_dispatch
        self.specs = cfg.block_specs()
        # per-block static sizes
        self._attn_params = [cfg.attn_param_count(s) for s in self.specs]
        self._ffn_params = [cfg.ffn_param_count(s) for s in self.specs]
        self._expert_bytes = cfg.expert_bytes(bytes_per_param)
        e = cfg.moe
        # "dense" FFN traffic per block: full MLP for dense blocks; for MoE
        # blocks only the always-touched parts (router + shared experts).
        self._dense_ffn_bytes = []
        for i, s in enumerate(self.specs):
            if s.ffn == FFN_MOE:
                shared = e.n_shared_experts * 3 * cfg.d_model * e.shared_d_ff
                router = cfg.d_model * e.n_experts
                self._dense_ffn_bytes.append((shared + router) * bytes_per_param)
            else:
                self._dense_ffn_bytes.append(self._ffn_params[i] * bytes_per_param)
        self._kv_per_tok_block = (cfg.kv_bytes_per_token(bytes_per_act)
                                  / max(cfg.n_layers, 1))
        self._embed_bytes = cfg.vocab_size * cfg.d_model * bytes_per_param
        self._swap_cmp_cache: Dict[int, bool] = {}

        # -- vectorized per-block tables (iteration_cost hot path) ----------
        L = len(self.specs)
        self._np_attn_params = np.array(self._attn_params, float)
        self._np_dense_ffn_bytes = np.array(self._dense_ffn_bytes, float)
        self._np_is_moe = np.array([s.ffn == FFN_MOE for s in self.specs])
        # experts computed per routed token: top_k for the ragged pipeline,
        # ALL E for the dense dropless capacity buffer (empty slab rows are
        # still GEMMed)
        self._experts_per_tok = (e.top_k if moe_dispatch == "ragged"
                                 else e.n_experts)
        lin = np.zeros(L)
        for b, s_ in enumerate(self.specs):
            lin[b] = 2.0 * self._attn_params[b]
            if s_.ffn == FFN_MOE:
                lin[b] += 2.0 * (self._experts_per_tok * 3 * cfg.d_model
                                 * e.expert_d_ff
                                 + e.n_shared_experts * 3 * cfg.d_model
                                 * e.shared_d_ff + cfg.d_model * e.n_experts)
            else:
                lin[b] += 2.0 * self._ffn_params[b]
        self._np_lin_flops = lin                  # per-token matmul flops
        self._np_lin_cum = np.concatenate([[0.0], np.cumsum(lin)])
        # attention blocks grouped by window; prefix counts per group
        self._attn_groups = []                    # (window_or_None, prefix)
        wins = {}
        for b, s_ in enumerate(self.specs):
            if s_.is_attention():
                wins.setdefault(s_.window, []).append(b)
        for w, blks in wins.items():
            member = np.zeros(L)
            member[blks] = 1.0
            prefix = np.concatenate([[0.0], np.cumsum(member)])
            self._attn_groups.append((w, prefix))

    def block_prefill_costs(self, n_tokens: int = 512):
        """Per-block prefill weight-bytes at a reference token count — the
        weights for LayeredPrefillScheduler(block_costs=...) adaptive
        grouping (paper §7 future work)."""
        return [self.block_weight_bytes(b, n_tokens).weight_bytes
                for b in range(len(self.specs))]

    # -- per-block cost pieces ---------------------------------------------------

    def block_flops(self, b: int, n_tokens: float, ctx_len: float) -> float:
        """Matmul + attention flops for n_tokens new tokens attending over
        ctx_len context in block b."""
        cfg = self.cfg
        s = self.specs[b]
        f = 2.0 * n_tokens * self._attn_params[b]
        if s.ffn == FFN_MOE:
            e = cfg.moe
            active = (self._experts_per_tok * 3 * cfg.d_model * e.expert_d_ff
                      + e.n_shared_experts * 3 * cfg.d_model * e.shared_d_ff
                      + cfg.d_model * e.n_experts)
            f += 2.0 * n_tokens * active
        else:
            f += 2.0 * n_tokens * self._ffn_params[b]
        if s.is_attention():
            win = s.window
            eff_ctx = min(ctx_len, win) if win else ctx_len
            hd = cfg.head_dim_
            f += 4.0 * n_tokens * eff_ctx * cfg.n_heads * hd
        return f

    def block_weight_bytes(self, b: int, n_tokens: float) -> BlockCost:
        """Weight traffic for a block processing n_tokens (>=1 real tokens
        => all dense weights stream once; MoE experts by coverage)."""
        c = BlockCost()
        if n_tokens <= 0:
            return c
        cfg = self.cfg
        s = self.specs[b]
        c.weight_bytes += self._attn_params[b] * self.bp
        if s.ffn == FFN_MOE:
            e = cfg.moe
            cov = (expected_coverage(e.n_experts, e.top_k, n_tokens)
                   if self.moe_dispatch == "ragged" else float(e.n_experts))
            c.expert_bytes = cov * self._expert_bytes
            c.weight_bytes += c.expert_bytes + self._dense_ffn_bytes[b]
        else:
            c.weight_bytes += self._dense_ffn_bytes[b]
        return c

    def moe_gmm_cost(self, n_tokens: float, dispatch: Optional[str] = None,
                     m_blk: Optional[int] = None) -> Dict[str, float]:
        """Modeled cost of ONE MoE block's routed-expert GMM at n_tokens.

        ragged: rows = routed assignments (top_k per token) plus expected
        tile-alignment padding (~half an m_blk row tile per active expert),
        with m_blk defaulting to the tile size the runtime dispatch would
        pick (models.moe.ragged_tile_rows — small tiles at decode scale);
        weight traffic = active_experts × bytes_per_expert — exactly the
        engine's ``expert_load_bytes`` counter and what the scalar-prefetch
        kernel streams. dense: the dropless worst-case capacity buffer —
        E × n_tokens rows, all E experts' weights.

        act_bytes covers the GMM row buffer (read + write) plus the
        dispatch gather / weighted combine on the (T·k, d) assignments."""
        dispatch = dispatch or self.moe_dispatch
        cfg = self.cfg
        e = cfg.moe
        if not e.enabled or n_tokens <= 0:
            return {"rows": 0.0, "flops": 0.0, "weight_bytes": 0.0,
                    "act_bytes": 0.0, "active_experts": 0.0}
        routed = n_tokens * e.top_k
        if m_blk is None:
            # lazy import: models.moe pulls torch, which the analytic
            # model otherwise never needs
            from repro_torch.models.moe import ragged_tile_rows
            m_blk, _ = ragged_tile_rows(int(routed), e.n_experts)
        cov = expected_coverage(e.n_experts, e.top_k, n_tokens)
        if dispatch == "ragged":
            rows = routed + cov * (m_blk - 1) / 2.0
            weight_bytes = cov * self._expert_bytes
        else:
            rows = float(e.n_experts) * n_tokens
            weight_bytes = float(e.n_experts) * self._expert_bytes
        flops = 2.0 * rows * 3.0 * cfg.d_model * e.expert_d_ff
        act_bytes = (2.0 * rows + 2.0 * routed) * cfg.d_model * self.ba
        return {"rows": rows, "flops": flops, "weight_bytes": weight_bytes,
                "act_bytes": act_bytes, "active_experts": cov}

    Q_TILE = 256  # flash-attention query tile: K/V streams once per tile

    def block_kv_bytes(self, b: int, n_new: float, ctx_len: float) -> float:
        """KV-cache read traffic for attention over ``ctx_len`` context.
        FlashAttention streams the block's K/V once per query TILE, not per
        query token (decode: n_new=1 -> one pass over the context)."""
        s = self.specs[b]
        if not s.is_attention():
            return 0.0
        eff = min(ctx_len, s.window) if s.window else ctx_len
        passes = max(1.0, n_new / self.Q_TILE)
        return passes * eff * self._kv_per_tok_block

    # -- swap-vs-recompute pricing ---------------------------------------------

    def kv_swap_bytes(self, n_tokens: float) -> float:
        """Bytes moved over the host link to swap ``n_tokens`` of KV one
        direction (the block-table metadata is noise at page granularity)."""
        return n_tokens * self.cfg.kv_bytes_per_token(self.ba)

    def swap_transfer(self, n_tokens: float) -> Dict[str, float]:
        """Time/energy to move ``n_tokens`` of KV across the host link in
        ONE direction (swap-out and swap-in each pay this once): a fixed
        DMA setup latency plus the byte stream."""
        b = self.kv_swap_bytes(n_tokens)
        return {"bytes": b,
                "duration": self.hw.host_dma_latency_s + b / self.hw.host_bw,
                "energy": b * self.hw.e_host_pj_per_byte * 1e-12}

    def link_transfer(self, n_tokens: float) -> Dict[str, float]:
        """Time/energy to stream ``n_tokens`` of KV over the inter-pool
        link (the disaggregated prefill→decode handoff): a fixed setup
        latency per transfer plus the byte stream at ``link_bw``.  The
        simulator overlaps this against remaining prefill compute and only
        charges ``stall = max(0, transfer − remaining_compute)``."""
        b = self.kv_swap_bytes(n_tokens)
        return {"bytes": b,
                "duration": self.hw.link_latency_s + b / self.hw.link_bw,
                "energy": b * self.hw.e_link_pj_per_byte * 1e-12}

    def recompute_cost(self, n_tokens: int) -> Dict[str, float]:
        """Cost of re-running a full-stack prefill over ``n_tokens`` — what
        a recompute-restored victim pays instead of the DMA-back.  Priced
        as a dedicated iteration (fixed overheads + full weight stream):
        the worst case, but the one the oversubscribed regime approaches
        as recompute epochs stop overlapping with other work."""
        plan = IterationPlan(prefill=[PrefillSlice(
            req_id=-1, token_start=0, token_end=int(n_tokens),
            block_start=0, block_end=len(self.specs),
            emits_first_token=True)])
        return self.iteration_cost(plan, {})

    def swap_beats_recompute(self, n_tokens: int) -> bool:
        """True iff the swap round-trip (DMA out + back, each paying the
        fixed setup latency) is cheaper in time than recomputing the
        victim's prefill — the per-victim crossover the "auto" preemption
        mode evaluates.  Both sides carry a fixed term (2x DMA setup vs
        iteration + per-block overheads) and a linear term (KV bytes over
        the host link vs prefill flops + weight re-stream).  On the
        shipped calibrations the recompute side's fixed cost and — for
        MoE models — the expert re-stream dominate, so swap wins from the
        smallest contexts up; the hook earns its keep on calibrations
        with fatter recompute batches or thinner host links (memoized:
        the pressure pass may evaluate it per victim per iteration)."""
        if n_tokens <= 0:
            return False
        hit = self._swap_cmp_cache.get(n_tokens)
        if hit is None:
            swap = 2.0 * self.swap_transfer(n_tokens)["duration"]
            hit = swap < self.recompute_cost(n_tokens)["duration"]
            if len(self._swap_cmp_cache) < 65536:
                self._swap_cmp_cache[n_tokens] = hit
        return hit

    # -- iteration-level costs ------------------------------------------------------

    def iteration_cost(self, plan: IterationPlan,
                       requests: Dict[int, Request]) -> Dict[str, float]:
        """Aggregate flops/bytes for one iteration. Per block, weight traffic
        is charged ONCE for the union of work touching it (fused hybrid
        batch semantics — same union rule as the engine's real counter).
        Fully vectorized over blocks (the simulator calls this per
        iteration for hundreds of thousands of iterations)."""
        cfg = self.cfg
        L = len(self.specs)
        hd4 = 4.0 * cfg.n_heads * cfg.head_dim_
        tokens_per_block = np.zeros(L)
        flops = 0.0
        kv_bytes = 0.0

        n_dec = len(plan.decode_ids)
        q_tokens = 0.0
        if n_dec:
            # speculative verify-k widens the decode query per request to
            # w_i = 1 + k_i tokens (plan.verify_len).  The acceptance
            # amortization is structural: the extra query tokens join
            # tokens_per_block, so each touched block's weight stream —
            # and, for MoE, its expert coverage — is charged ONCE for the
            # whole window instead of once per committed token.
            ws = np.array([1.0 + plan.verify_len.get(r, 0)
                           for r in plan.decode_ids], float)
            q_tokens = float(ws.sum())
            tokens_per_block += q_tokens
            flops += q_tokens * self._np_lin_cum[L]
            # true KV length: the recompute prompt already contains the
            # n_folded generated tokens of any earlier preemption
            ctxs = np.array([requests[r].prompt_len + requests[r].n_generated
                             - requests[r].n_folded
                             for r in plan.decode_ids], float)
            for w, prefix in self._attn_groups:
                cnt = prefix[L]
                eff = np.minimum(ctxs, w) if w else ctxs
                # one KV pass per row regardless of window width (w_i <=
                # k+1 << Q_TILE); attention flops scale with the width
                total_eff = float(eff.sum())
                kv_bytes += cnt * total_eff * self._kv_per_tok_block
                flops += cnt * hd4 * float((ws * eff).sum())

        act_bytes = 0.0
        for sl in plan.prefill:
            b0, b1, n = sl.block_start, sl.block_end, sl.n_tokens
            ctx0 = sl.token_start
            tokens_per_block[b0:b1] += n
            flops += n * (self._np_lin_cum[b1] - self._np_lin_cum[b0])
            for w, prefix in self._attn_groups:
                cnt = prefix[b1] - prefix[b0]
                if not cnt:
                    continue
                ctx_f = ctx0 + n / 2.0          # avg ctx for flops
                ctx_kv = ctx0 + n               # full ctx for kv stream
                eff_f = min(ctx_f, w) if w else ctx_f
                eff_kv = min(ctx_kv, w) if w else ctx_kv
                flops += cnt * hd4 * n * eff_f
                passes = max(1.0, n / self.Q_TILE)
                kv_bytes += cnt * passes * eff_kv * self._kv_per_tok_block
            # boundary activation stash write+read (layered-specific traffic)
            if b0 > 0:
                act_bytes += n * cfg.d_model * self.ba
            if b1 < L:
                act_bytes += n * cfg.d_model * self.ba

        touched = tokens_per_block > 0
        weight_bytes = float(
            ((self._np_attn_params * self.bp + self._np_dense_ffn_bytes)
             * touched).sum())
        e = cfg.moe
        if e.enabled:
            if self.moe_dispatch == "ragged":
                n_eff = np.where(self._np_is_moe & touched,
                                 np.maximum(tokens_per_block, 1e-9), 0.0) \
                    ** COVERAGE_CORRELATION_ALPHA
                cov = e.n_experts * (1.0
                                     - (1.0 - e.top_k / e.n_experts) ** n_eff)
                cov = np.where(self._np_is_moe & touched, cov, 0.0)
            else:
                # dense dropless buffer GEMMs (and streams) every expert
                cov = np.where(self._np_is_moe & touched,
                               float(e.n_experts), 0.0)
            expert_bytes = float(cov.sum()) * self._expert_bytes
        else:
            expert_bytes = 0.0
        weight_bytes += expert_bytes

        emits = sum(1 for s_ in plan.prefill if s_.emits_first_token)
        if n_dec + emits > 0:
            weight_bytes += self._embed_bytes          # unembedding stream
            # every verify-window position is argmaxed, not just the last
            flops += 2.0 * (q_tokens + emits) * self._embed_bytes / self.bp

        total_bytes = weight_bytes + kv_bytes + act_bytes
        t_compute = flops / self.hw.flops
        t_memory = total_bytes / self.hw.hbm_bw
        blocks_touched = int(touched.sum())
        duration = (max(t_compute, t_memory) + self.hw.iter_overhead_s
                    + blocks_touched * self.hw.block_overhead_s)
        energy = (duration * self.hw.static_power_w * self.hw.n_chips
                  + total_bytes * self.hw.e_hbm_pj_per_byte * 1e-12
                  + flops * self.hw.e_flop_pj * 1e-12)
        return {
            "duration": duration,
            "flops": flops,
            "hbm_bytes": total_bytes,
            "weight_bytes": weight_bytes,
            "expert_bytes": expert_bytes,
            "kv_bytes": kv_bytes,
            "energy": energy,
            "bound": "compute" if t_compute >= t_memory else "memory",
        }
