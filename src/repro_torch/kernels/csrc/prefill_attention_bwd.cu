// Backward of the GQA prefill attention (prefill_attention.cu) at every
// contract its forward takes, by hand for Hopper (sm_90a): wgmma products
// on TMA-fed tiles, warp-specialised.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel
// (its training path lets XLA differentiate the jnp masked_attention,
// src/repro/models/attention.py).  It computes the vjp of the forward
// kernel's contract (the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_pallas): q (B, P, H, dk) at positions offset[b] + i over
// k (B, S_max, Hkv, dk) and v (B, S_max, Hkv, dv), at (dk, dv) in (32, 32),
// (64, 64), (128, 128), (192, 128) (multi-head latent attention) and (256,
// 256).  Causal: key j is visible to query i when j <= offset + i, j <
// S_max and, with a window, j > offset + i - window (the training path:
// offset 0, S_max = P; recurrentgemma-9b's local attention has window
// 2048).  Non-causal (causal = 0: whisper's encoder and its decoder's
// cross-attention over 1500 frames): every key j < S_max is visible to
// every query, and offset and window are ignored.  From the forward's
// output O and its per-row log-sum-exp L (B, H, P; fp32, natural log,
// written by the forward kernel on request) and dO:
//
//   D  = rowsum(dO o O)                                  (rowstat_kernel)
//   P  = exp(S - L), S = Q K^T / sqrt(dk)     dV = sum over rows P^T dO
//   dP = dO V^T   dS = P o (dP - D)           dK = sum over rows dS^T Q / sqrt(dk)
//                                                        (dkdv_kernel)
//   dQ = dS K / sqrt(dk)                                 (dq_kernel)
//
// Query head h reads kv head h % Hkv (g-major grouping); dK and dV sum the
// g query heads of their kv head.  No atomics: every output element is
// written by one thread of one CTA after a fixed-order sum, and a sum
// across CTAs (the split below) is a launch of its own, so two calls give
// the same bits (PERF.md §6: a cross-CTA reduction is a second launch,
// never float atomics).  Keys no query sees get zero gradients; no row at
// or past S_max is written.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the vjp
// needs five products per visible (query head, key) pair, 2 (3 dk + 2 dv)
// flops (S, dK and dQ over dk; dP and dV over dv), against the forward's
// two; this kernel does seven (its dQ pass recomputes S and dP), eight
// past dk 128 (the dV warpgroup recomputes S^T too).  minicpm-2b's
// training step (B 8, P 256, 36 heads of 64; causal) is 8 * 36 * 256 *
// 257 / 2 = 9.47 M pairs, 6.1 GFLOP (6.1 us) against q, k, v, o, dO in
// and dq, dk, dv out, 8 tensors of 9.4 MB = 75 MB (22.5 us): bytes-bound
// at P 256, as are recurrentgemma-9b's (16/1 heads of 256: 71 MB, 21 us,
// against 10.8 GFLOP) and whisper-base's cross-attention (8 x 256 queries
// over 1500 frames, 8/8 of 64: 58 MB, 17 us, against 15.7 GFLOP).
// deepseek-v2-236b's (128 heads, dk 192, dv 128) moves 671 MB (200 us)
// against 56 GFLOP.  qwen3-30b-a3b at P 2048 (32/4 heads of 128) is
// operations-bound.
//
// Design.  Both passes are the forward's shape: one CTA of three
// warpgroups; warpgroup 2 gives its registers away (setmaxnreg) and one
// of its threads keeps TMA loads in flight on mbarriers (128-byte swizzle,
// 64-byte at width 32; 4-D maps over (width, heads, rows, B), so rows past
// P or S_max arrive as zeros, never as the next row's); warpgroups 0 and
// 1 run wgmma with both operands in shared memory for the products that
// make S and dP, keep P and dS in registers in the accumulator layout —
// the layout of wgmma's A-from-registers operand — and feed them to the
// products that accumulate a gradient, whose B operand is the MN-major
// tile already in shared memory.  The gradients stay in fp32 registers
// until one store.
//  * rowstat_kernel writes, per (b, h) row padded to 128 queries, D and
//    L log2(e) (+inf past P, so padding queries get P = 0 without a
//    mask): the passes bring both in by bulk copies beside their tiles.
//  * dkdv_kernel: one CTA per (key tile, kv head, b, head group).  The
//    producer loads the CTA's K and V once and streams the Q, dO, L and D
//    tiles (64 queries) of every query head of its group through a ring.
//    Up to dk 128 a key tile is 128 keys, 64 per consumer warpgroup, each
//    computing S^T = K Q^T and dP^T = V dO^T, P^T = exp2(S^T - L) and
//    dS^T = P^T o (dP^T - D), then dV += P^T dO and dK += dS^T Q (dK and dV
//    are 2 x 64 fp32 registers a thread at 128).  At (192, 128) and (256,
//    256) both sums do not fit one warpgroup beside S^T and dP^T (160 and
//    256 registers), so a key tile is 64 keys and the two warpgroups
//    split the work: warpgroup 0 computes S^T, P^T and dV (S^T 32 + dV 64
//    or 128 registers), warpgroup 1 S^T, dP^T, dS^T and dK (32 + 32 + 96
//    or 128): S^T is computed twice.  Only blocks that cross the
//    diagonal or the window's edge evaluate the mask.
//  * Fill the card: where (S_max / key tile) x Hkv x B CTAs are fewer
//    than the SMs (one kv head: recurrentgemma-9b), the host splits the
//    g query heads of a kv head into ``split`` groups (ops.bwd_split,
//    from shapes only); each group's CTA writes fp32 partial dK and dV to
//    scratch, and reduce_kernel sums the groups in a fixed order and
//    rounds once to bf16.
//  * dq_kernel: one CTA per (128-query tile, head, b), 64 rows per
//    consumer warpgroup; Q, dO, L and D load once, and K/V tiles (64
//    keys, 32 at (256, 256), where Q and dO take 128 KB) stream through
//    the ring over the keys any of its rows sees.  S = Q K^T and dP = dO
//    V^T, then dQ += dS K with K as the MN-major B operand.  It stays a
//    pass of its own (no atomics); writing dS to memory for it instead
//    would cost B H P S_max x 2 bytes.
//  * Both grids put the tile on blockIdx.z, the slowest axis of the
//    order in which CTAs start, so that under the causal mask every
//    head's longest CTAs start before any shorter one (the dK/dV pass's
//    first key tiles see the most queries; the dQ pass walks its query
//    tiles from the last, which sees the most keys).  With the tile on
//    blockIdx.x each head's short tiles started before the next head's
//    long ones, and the last wave ran long CTAs alone.
// P and dS are rounded to bf16 for the tensor cores, as the forward rounds P.
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;       // consumers: warpgroups 0, 1; producer: 2
constexpr int kConsumerWarps = 8;
constexpr int QR = 128;             // dQ pass: query rows a CTA
constexpr int ROW_PAD = 128;        // L and D rows padded to a multiple of this
constexpr int kSmemMax = 232448;    // shared memory a block can use
constexpr int kMaxStages = 4;

template <int DK, int DV>
struct Cfg {
  static_assert(DK == DV || (DK % 64 == 0 && DV % 64 == 0), "box widths");
  static constexpr bool WIDE = DK > 128;            // (192, 128), (256, 256)
  static constexpr int EB = DV < 64 ? DV : 64;      // elements per box row
  static constexpr int SWZ = EB * 2;                // row bytes = swizzle span
  static constexpr int NBK = DK / EB, NBV = DV / EB;
  // dK/dV pass: KT keys, one ring stage = Q and dO of QT queries + L, D
  static constexpr int KT = WIDE ? 64 : 128;
  static constexpr int QT = 64;
  static constexpr int KV_BYTES = KT * (DK + DV) * 2;
  static constexpr int QO_BYTES = QT * (DK + DV) * 2;
  static constexpr int LD1 = 2 * QT * 4;
  static constexpr int S1_FIT = (kSmemMax - 1024 - KV_BYTES - 128) / (QO_BYTES + LD1 + 16);
  static constexpr int S1 = S1_FIT < kMaxStages ? S1_FIT : kMaxStages;
  static constexpr int SMEM1 = 1024 + KV_BYTES + S1 * (QO_BYTES + LD1) + (2 * S1 + 1) * 8;
  // dQ pass: QR rows of Q and dO + L, D; one ring stage = K and V of KTQ keys
  static constexpr int KTQ = DK + DV > 384 ? 32 : 64;
  static constexpr int QO2_BYTES = QR * (DK + DV) * 2;
  static constexpr int LD2 = 2 * QR * 4;
  static constexpr int KVQ_BYTES = KTQ * (DK + DV) * 2;
  static constexpr int S2_FIT = (kSmemMax - 1024 - QO2_BYTES - LD2 - 128) / KVQ_BYTES;
  static constexpr int S2 = S2_FIT < kMaxStages ? S2_FIT : kMaxStages;
  static constexpr int SMEM2 = 1024 + QO2_BYTES + LD2 + S2 * KVQ_BYTES + (2 * S2 + 1) * 8;
  static_assert(S1 >= 2 && S2 >= 2 && SMEM1 <= kSmemMax && SMEM2 <= kSmemMax, "smem");
};

// The keys below S_max that query i sees run up to i + hi (causal: hi =
// offset; without the causal mask, all of them) and, under a window (a
// build of its own, WINDOW), from i + lo, lo = offset - window + 1.
template <bool WINDOW>
struct Visible {
  int lo, hi;
  __device__ Visible(int off, int window, int causal)
      : lo(off - window + 1), hi(causal ? off : (1 << 30)) {}
  __device__ __forceinline__ bool operator()(int key, int i) const {
    return key <= i + hi && (!WINDOW || key >= i + lo);
  }
};

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// d (64 x N) (+)= A (64 x 16) B (N x 16), both K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_ss_m64n64(d, da, db, acc);
  else wgmma_ss_m64n32(d, da, db, acc);
}
// d (64 x EB) += A (64 x 16, registers) B (16 x EB, shared, MN-major)
template <int EB>
__device__ __forceinline__ void mma_rs(float (&d)[EB / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (EB == 64) wgmma_rs_m64n64(d, a, db);
  else wgmma_rs_m64n32(d, a, db);
}

// stat[0][b][h][i] = L[b, h, i] log2(e) and stat[1][b][h][i] = D[b, h, i] =
// sum_d dO[b, i, h, d] O[b, i, h, d] for i < P; +inf and 0 for P <= i <
// Ppad.  One warp per (b, h, i), lanes over the width in a fixed order.
template <int DV>
__global__ void __launch_bounds__(128)
rowstat_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o,
               const float* __restrict__ lse, float* __restrict__ stat, long rows, int P,
               int Ppad, int H) {
  const long row = static_cast<long>(blockIdx.x) * 4 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long bh = row / Ppad;
  const int i = static_cast<int>(row - bh * Ppad);
  if (i >= P) {
    if (lane == 0) {
      stat[row] = INFINITY;
      stat[rows + row] = 0.0f;
    }
    return;
  }
  const long at = ((bh / H * P + i) * H + bh % H) * DV;   // (b, i, h) of O and dO
  float s = 0.0f;
  for (int c = lane * 2; c < DV; c += 64) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(o + at + c);
    const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(d_o + at + c);
    s += __bfloat162float(x.x) * __bfloat162float(y.x) +
         __bfloat162float(x.y) * __bfloat162float(y.y);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
  if (lane == 0) {
    stat[row] = lse[bh * P + i] * kLog2e;
    stat[rows + row] = s;
  }
}

// out[i] = mul * sum over s < split of part[s][i], in that order, rounded
// once to bf16; four elements a thread (n a multiple of 4)
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, bf16* __restrict__ out, long n, int split,
              float mul) {
  const long i = (static_cast<long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < split; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * n + i);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  uint2 r;
  r.x = pack_bf16(a.x * mul, a.y * mul);
  r.y = pack_bf16(a.z * mul, a.w * mul);
  *reinterpret_cast<uint2*>(out + i) = r;
}

// What one step of the dK/dV pass reads: the query head and first query
// of step t of this CTA (the group's heads in order, each over its query
// tiles from i_begin)
struct Steps {
  int nq, i_begin, head0, Hkv, kh, qt;
  __device__ __forceinline__ void at(int t, int& h, int& i0) const {
    const int gi = head0 + t / nq;
    h = gi * Hkv + kh;
    i0 = i_begin + (t % nq) * qt;
  }
};

// One consumer warpgroup of the dK/dV pass over its 64 key rows ka.. of
// the CTA's tile (key row offset kr in shared memory): per step, S^T = K
// Q^T and (DO_DK) dP^T = V dO^T; P^T = exp2(S^T - L) and dS^T = P^T o
// (dP^T - D) in registers; then (DO_DV) dV += P^T dO and (DO_DK) dK +=
// dS^T Q.  Stores its sums at the end: bf16 (dK scaled) or, with a split,
// fp32 partials.
template <int DK, int DV, bool WINDOW, bool DO_DV, bool DO_DK>
__device__ __forceinline__ void dkdv_consume(
    const bf16* ks, const bf16* vs, const bf16* qring, const bf16* oring, const float* ldring,
    uint64_t* full, uint64_t* empty, uint64_t* kvbar, const Steps& steps, int n_steps, int ka,
    int kr, int off, const Visible<WINDOW>& seen, int window, int causal, float scale_log2,
    float scale, long kv_row0, int S_max, int Hkv, bf16* dk, bf16* dv, float* pdk, float* pdv) {
  using C = Cfg<DK, DV>;
  constexpr int EB = C::EB, NBK = C::NBK, NBV = C::NBV, KT = C::KT, S1 = C::S1, QT = C::QT;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float dva[DO_DV ? NBV : 1][EB / 2], dka[DO_DK ? NBK : 1][EB / 2];
#pragma unroll
  for (int bx = 0; bx < (DO_DV ? NBV : 1); ++bx)
#pragma unroll
    for (int i = 0; i < EB / 2; ++i) dva[bx][i] = 0.0f;
#pragma unroll
  for (int bx = 0; bx < (DO_DK ? NBK : 1); ++bx)
#pragma unroll
    for (int i = 0; i < EB / 2; ++i) dka[bx][i] = 0.0f;

  if (n_steps > 0) mbar_wait(kvbar, 0);
  for (int t = 0; t < n_steps; ++t) {
    const int st = t % S1;
    mbar_wait(&full[st], (t / S1) & 1);
    int h, i0;
    steps.at(t, h, i0);
    const bf16* qst = qring + st * NBK * QT * EB;
    const bf16* ost = oring + st * NBV * QT * EB;
    const float* lst = ldring + st * 2 * QT;

    // S^T (64 keys x QT queries) = K Q^T over dk; dP^T = V dO^T over dv
    float s[QT / 2], dp[DO_DK ? QT / 2 : 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const int bx = kk / (EB / 16), within = (kk % (EB / 16)) * 16;
      mma_ss<QT>(s, wgmma_desc(ks + (bx * KT + kr) * EB + within, C::SWZ),
                 wgmma_desc(qst + bx * QT * EB + within, C::SWZ), kk > 0);
    }
    if constexpr (DO_DK) {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const int bx = kk / (EB / 16), within = (kk % (EB / 16)) * 16;
        mma_ss<QT>(dp, wgmma_desc(vs + (bx * KT + kr) * EB + within, C::SWZ),
                   wgmma_desc(ost + bx * QT * EB + within, C::SWZ), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (DO_DK) fence_regs(dp);

    // element i: key ka + warp * 16 + lane / 4 + 8 ((i >> 1) & 1), query
    // i0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1)
    const bool masked = causal && (ka + 63 > i0 + off ||
                                   (WINDOW && ka <= i0 + QT - 1 + off - window));
    uint32_t pa[QT / 16][4], da[DO_DK ? QT / 16 : 1][4];
#pragma unroll
    for (int j = 0; j < QT / 8; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(lst + j * 8 + (lane % 4) * 2);
      const float2 dd = *reinterpret_cast<const float2*>(lst + QT + j * 8 + (lane % 4) * 2);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        p[e] = exp2f(s[i] * scale_log2 - ((e & 1) ? lv.y : lv.x));
        if (masked) {
          const int key = ka + warp * 16 + lane / 4 + 8 * (e >> 1);
          const int qi = i0 + j * 8 + (lane % 4) * 2 + (e & 1);
          if (!seen(key, qi)) p[e] = 0.0f;
        }
        if constexpr (DO_DK) ds[e] = p[e] * (dp[i] - ((e & 1) ? dd.y : dd.x));
      }
      // accumulator pairs (8kk..8kk+7) are the A fragment of k-step kk
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      if constexpr (DO_DK) {
        da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
    }

    // dV (64 x dv) += P^T dO, dK (64 x dk) += dS^T Q; k over the QT queries
    if constexpr (DO_DV) {
#pragma unroll
      for (int bx = 0; bx < NBV; ++bx) fence_regs(dva[bx]);
    }
    if constexpr (DO_DK) {
#pragma unroll
      for (int bx = 0; bx < NBK; ++bx) fence_regs(dka[bx]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      if constexpr (DO_DV) {
#pragma unroll
        for (int bx = 0; bx < NBV; ++bx)
          mma_rs<EB>(dva[bx], pa[kk], wgmma_desc(ost + (bx * QT + kk * 16) * EB, C::SWZ));
      }
      if constexpr (DO_DK) {
#pragma unroll
        for (int bx = 0; bx < NBK; ++bx)
          mma_rs<EB>(dka[bx], da[kk], wgmma_desc(qst + (bx * QT + kk * 16) * EB, C::SWZ));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (DO_DV) {
#pragma unroll
      for (int bx = 0; bx < NBV; ++bx) fence_regs(dva[bx]);
    }
    if constexpr (DO_DK) {
#pragma unroll
      for (int bx = 0; bx < NBK; ++bx) fence_regs(dka[bx]);
    }
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // rows ka + warp * 16 + lane / 4 (+ 8) below S_max; keys no query sees
  // keep their zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = ka + warp * 16 + lane / 4 + 8 * r;
    if (key >= S_max) continue;
    const long row = kv_row0 + static_cast<long>(key) * Hkv;
    const int c0 = (lane % 4) * 2;
#pragma unroll
    for (int bx = 0; bx < (DO_DV ? NBV : 0); ++bx)
#pragma unroll
      for (int c = 0; c < EB / 8; ++c) {
        const float x = dva[bx][c * 4 + 2 * r], y = dva[bx][c * 4 + 2 * r + 1];
        const long at = row * DV + bx * EB + c * 8 + c0;
        if (pdv != nullptr) *reinterpret_cast<float2*>(pdv + at) = make_float2(x, y);
        else *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(x, y);
      }
#pragma unroll
    for (int bx = 0; bx < (DO_DK ? NBK : 0); ++bx)
#pragma unroll
      for (int c = 0; c < EB / 8; ++c) {
        const float x = dka[bx][c * 4 + 2 * r], y = dka[bx][c * 4 + 2 * r + 1];
        const long at = row * DK + bx * EB + c * 8 + c0;
        if (pdk != nullptr) *reinterpret_cast<float2*>(pdk + at) = make_float2(x, y);
        else *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(x * scale, y * scale);
      }
  }
}

// Grid (Hkv * split, B, S_max / KT).  pdk, pdv: null, or the fp32 partials
// of this CTA's head group (split > 1), (B, S_max, Hkv, width) each.
template <int DK, int DV, bool WINDOW>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
            const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
            const float* __restrict__ stat, const int* __restrict__ offset,
            bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part, int B,
            int P, int Ppad, int H, int Hkv, int S_max, int window, int causal, int split,
            float scale_log2, float scale) {
  using C = Cfg<DK, DV>;
  constexpr int EB = C::EB, NBK = C::NBK, NBV = C::NBV, KT = C::KT, S1 = C::S1, QT = C::QT;
  const int k0 = blockIdx.z * KT;
  const int kh = blockIdx.x % Hkv, sp = blockIdx.x / Hkv;
  const int b = blockIdx.y;
  const int gs = H / Hkv / split;                  // query heads of this CTA's group
  const int off = offset[b];
  // the queries that see a key of this tile: causal, from the first that
  // sees key k0 (at k0 - offset) to, with a window, the last that still
  // sees key k0 + KT - 1 (before k0 + KT - 1 - offset + window)
  int i_begin = 0, i_end = P;
  if (causal) {
    i_begin = max(0, k0 - off) / QT * QT;
    if (WINDOW) i_end = min(P, k0 + KT - 1 - off + window);
  }
  const int nq = i_end > i_begin ? (i_end - i_begin + QT - 1) / QT : 0;
  const int n_steps = nq * gs;
  const Steps steps{nq > 0 ? nq : 1, i_begin, sp * gs, Hkv, kh, QT};

  unsigned char* base = smem_base();
  bf16* ks = reinterpret_cast<bf16*>(base);                       // NBK x [KT][EB]
  bf16* vs = ks + NBK * KT * EB;                                  // NBV x [KT][EB]
  bf16* qring = vs + NBV * KT * EB;                               // S1 x NBK x [QT][EB]
  bf16* oring = qring + S1 * NBK * QT * EB;                       // S1 x NBV x [QT][EB]
  float* ldring = reinterpret_cast<float*>(oring + S1 * NBV * QT * EB);  // S1 x (L, D)
  uint64_t* full = reinterpret_cast<uint64_t*>(ldring + S1 * 2 * QT);
  uint64_t* empty = full + S1;
  uint64_t* kvbar = empty + S1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S1; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256 && n_steps > 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&omap);
      mbar_expect_tx(kvbar, C::KV_BYTES);
      for (int bx = 0; bx < NBK; ++bx)
        tma_load_4d(ks + bx * KT * EB, &kmap, kvbar, bx * EB, kh, k0, b);
      for (int bx = 0; bx < NBV; ++bx)
        tma_load_4d(vs + bx * KT * EB, &vmap, kvbar, bx * EB, kh, k0, b);
      const long rows = static_cast<long>(B) * H * Ppad;
      for (int t = 0; t < n_steps; ++t) {
        const int st = t % S1;
        mbar_wait(&empty[st], ((t / S1) & 1) ^ 1);
        int h, i0;
        steps.at(t, h, i0);
        mbar_expect_tx(&full[st], C::QO_BYTES + C::LD1);
        for (int bx = 0; bx < NBK; ++bx)
          tma_load_4d(qring + (st * NBK + bx) * QT * EB, &qmap, &full[st], bx * EB, h, i0, b);
        for (int bx = 0; bx < NBV; ++bx)
          tma_load_4d(oring + (st * NBV + bx) * QT * EB, &omap, &full[st], bx * EB, h, i0, b);
        const float* src = stat + (static_cast<long>(b) * H + h) * Ppad + i0;
        bulk_load(ldring + st * 2 * QT, src, QT * 4, &full[st]);
        bulk_load(ldring + st * 2 * QT + QT, src + rows, QT * 4, &full[st]);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const Visible<WINDOW> seen(off, window, causal);
    const long kv_row0 = static_cast<long>(b) * S_max * Hkv + kh;
    const long n_dk = static_cast<long>(B) * S_max * Hkv * DK;
    const long n_dv = static_cast<long>(B) * S_max * Hkv * DV;
    float* pdk = part != nullptr ? part + sp * n_dk : nullptr;
    float* pdv = part != nullptr ? part + split * n_dk + sp * n_dv : nullptr;
    const float sl2 = scale_log2;
    if constexpr (!C::WIDE) {
      dkdv_consume<DK, DV, WINDOW, true, true>(ks, vs, qring, oring, ldring, full, empty, kvbar,
                                               steps, n_steps, k0 + wg * 64, wg * 64, off, seen,
                                               window, causal, sl2, scale, kv_row0, S_max, Hkv,
                                               dk, dv, pdk, pdv);
    } else if (wg == 0) {
      dkdv_consume<DK, DV, WINDOW, true, false>(ks, vs, qring, oring, ldring, full, empty,
                                                kvbar, steps, n_steps, k0, 0, off, seen, window,
                                                causal, sl2, scale, kv_row0, S_max, Hkv, dk, dv,
                                                pdk, pdv);
    } else {
      dkdv_consume<DK, DV, WINDOW, false, true>(ks, vs, qring, oring, ldring, full, empty,
                                                kvbar, steps, n_steps, k0, 0, off, seen, window,
                                                causal, sl2, scale, kv_row0, S_max, Hkv, dk, dv,
                                                pdk, pdv);
    }
  }
}

// Grid (H, B, P / QR).
template <int DK, int DV, bool WINDOW>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
          const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
          const float* __restrict__ stat, const int* __restrict__ offset, bf16* __restrict__ dq,
          int B, int P, int Ppad, int H, int Hkv, int S_max, int window, int causal,
          float scale_log2, float scale, int n_qtiles) {
  using C = Cfg<DK, DV>;
  constexpr int EB = C::EB, NBK = C::NBK, NBV = C::NBV, KTQ = C::KTQ, S2 = C::S2;
  const int i0 = (n_qtiles - 1 - blockIdx.z) * QR;     // most expensive first
  const int h = blockIdx.x, kh = h % Hkv, b = blockIdx.y;
  const int off = offset[b];
  // the keys any row sees: causal, up to the last row's position and, with
  // a window, from the first row's first key (rounded down to a tile)
  int kv_begin = 0, kv_end = S_max;
  if (causal) {
    kv_end = min(off + min(i0 + QR, P), S_max);
    if (WINDOW) kv_begin = max(0, off + i0 - window + 1) / KTQ * KTQ;
  }
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + KTQ - 1) / KTQ : 0;

  unsigned char* base = smem_base();
  bf16* qs = reinterpret_cast<bf16*>(base);                       // NBK x [QR][EB]
  bf16* os = qs + NBK * QR * EB;                                  // NBV x [QR][EB]
  float* ld = reinterpret_cast<float*>(os + NBV * QR * EB);      // L[QR], D[QR]
  bf16* kring = reinterpret_cast<bf16*>(ld + 2 * QR);             // S2 x NBK x [KTQ][EB]
  bf16* vring = kring + S2 * NBK * KTQ * EB;                      // S2 x NBV x [KTQ][EB]
  uint64_t* full = reinterpret_cast<uint64_t*>(vring + S2 * NBV * KTQ * EB);
  uint64_t* empty = full + S2;
  uint64_t* qbar = empty + S2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(qbar, C::QO2_BYTES + C::LD2);
      for (int bx = 0; bx < NBK; ++bx)
        tma_load_4d(qs + bx * QR * EB, &qmap, qbar, bx * EB, h, i0, b);
      for (int bx = 0; bx < NBV; ++bx)
        tma_load_4d(os + bx * QR * EB, &omap, qbar, bx * EB, h, i0, b);
      const float* src = stat + (static_cast<long>(b) * H + h) * Ppad + i0;
      bulk_load(ld, src, QR * 4, qbar);
      bulk_load(ld + QR, src + static_cast<long>(B) * H * Ppad, QR * 4, qbar);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % S2;
        mbar_wait(&empty[st], ((t / S2) & 1) ^ 1);
        mbar_expect_tx(&full[st], C::KVQ_BYTES);
        const int key0 = kv_begin + t * KTQ;
        for (int bx = 0; bx < NBK; ++bx)
          tma_load_4d(kring + (st * NBK + bx) * KTQ * EB, &kmap, &full[st], bx * EB, kh, key0,
                      b);
        for (int bx = 0; bx < NBV; ++bx)
          tma_load_4d(vring + (st * NBV + bx) * KTQ * EB, &vmap, &full[st], bx * EB, kh, key0,
                      b);
      }
    }
    return;
  }
  // -------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int wr = wg * 64;                          // this warpgroup's rows
  const int r0 = wr + warp * 16 + lane / 4;        // rows r0 and r0 + 8
  const Visible<WINDOW> seen(off, window, causal);
  float dqa[NBK][EB / 2];
#pragma unroll
  for (int bx = 0; bx < NBK; ++bx)
#pragma unroll
    for (int i = 0; i < EB / 2; ++i) dqa[bx][i] = 0.0f;
  float lrow[2] = {0.0f, 0.0f}, drow[2] = {0.0f, 0.0f};
  if (n_tiles > 0) {
    mbar_wait(qbar, 0);
    lrow[0] = ld[r0];
    lrow[1] = ld[r0 + 8];
    drow[0] = ld[QR + r0];
    drow[1] = ld[QR + r0 + 8];
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % S2;
    mbar_wait(&full[st], (t / S2) & 1);
    const bf16* kst = kring + st * NBK * KTQ * EB;
    const bf16* vst = vring + st * NBV * KTQ * EB;

    // S (64 x KTQ) = Q K^T over dk; dP = dO V^T over dv
    float s[KTQ / 2], dp[KTQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const int bx = kk / (EB / 16), within = (kk % (EB / 16)) * 16;
      mma_ss<KTQ>(s, wgmma_desc(qs + (bx * QR + wr) * EB + within, C::SWZ),
                  wgmma_desc(kst + bx * KTQ * EB + within, C::SWZ), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      const int bx = kk / (EB / 16), within = (kk % (EB / 16)) * 16;
      mma_ss<KTQ>(dp, wgmma_desc(os + (bx * QR + wr) * EB + within, C::SWZ),
                  wgmma_desc(vst + bx * KTQ * EB + within, C::SWZ), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // element i: row r0 + 8 ((i >> 1) & 1), key key0 + (i / 4) * 8 +
    // (lane % 4) * 2 + (i & 1); the last tile also masks keys past S_max,
    // which load as zeros
    const int key0 = kv_begin + t * KTQ;
    const bool masked = key0 + KTQ > S_max ||
                        (causal && (key0 + KTQ - 1 > i0 + wr + off ||
                                    (WINDOW && key0 <= i0 + wr + 63 + off - window)));
    uint32_t da[KTQ / 16][4];
#pragma unroll
    for (int i = 0; i < KTQ / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = exp2f(s[i + e] * scale_log2 - lrow[r]);
        if (masked) {
          const int key = key0 + (i / 4) * 8 + (lane % 4) * 2 + e;
          if (!(key < S_max && seen(key, i0 + r0 + 8 * r))) p = 0.0f;
        }
        ds[e] = p * (dp[i + e] - drow[r]);
      }
      da[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dQ (64 x dk) += dS K, k over the tile's keys
#pragma unroll
    for (int bx = 0; bx < NBK; ++bx) fence_regs(dqa[bx]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KTQ / 16; ++kk)
#pragma unroll
      for (int bx = 0; bx < NBK; ++bx)
        mma_rs<EB>(dqa[bx], da[kk], wgmma_desc(kst + (bx * KTQ + kk * 16) * EB, C::SWZ));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < NBK; ++bx) fence_regs(dqa[bx]);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + 8 * r;
    if (i >= P) continue;
    bf16* dst = dq + ((static_cast<long>(b) * P + i) * H + h) * DK + (lane % 4) * 2;
#pragma unroll
    for (int bx = 0; bx < NBK; ++bx)
#pragma unroll
      for (int c = 0; c < EB / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + bx * EB + c * 8) =
            pack_bf16(dqa[bx][c * 4 + 2 * r] * scale, dqa[bx][c * 4 + 2 * r + 1] * scale);
  }
}

// a 4-D map over (width, heads, rows, B) of a (B, rows, heads, width) bf16
// tensor, read in boxes of (EB, 1, box_rows, 1)
template <int DK, int DV>
int encode_rows(CUtensorMap* map, const void* base, int width, int heads, int rows, int B,
                int box_rows) {
  using C = Cfg<DK, DV>;
  const cuuint64_t e = 2;
  const cuuint64_t w = static_cast<cuuint64_t>(width);
  const cuuint64_t dims[4] = {w, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {w * e, static_cast<cuuint64_t>(heads) * w * e,
                                 static_cast<cuuint64_t>(rows) * heads * w * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::EB), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  return encode_bf16_map(map, 4, base, dims, strides, box, C::SWZ);
}

template <int DK, int DV, bool WINDOW>
int launch_passes(const void* q, const void* k, const void* v, const void* d_o,
                  const float* stat, const int* offset, bf16* dq, bf16* dk, bf16* dv,
                  float* part, int B, int P, int Ppad, int H, int Hkv, int S_max, int window,
                  int causal, int split, float scale, int* grid, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  CUtensorMap q1, o1, k1, v1, q2, o2, k2, v2;
  int err = encode_rows<DK, DV>(&q1, q, DK, H, P, B, C::QT);
  if (!err) err = encode_rows<DK, DV>(&o1, d_o, DV, H, P, B, C::QT);
  if (!err) err = encode_rows<DK, DV>(&k1, k, DK, Hkv, S_max, B, C::KT);
  if (!err) err = encode_rows<DK, DV>(&v1, v, DV, Hkv, S_max, B, C::KT);
  if (!err) err = encode_rows<DK, DV>(&q2, q, DK, H, P, B, QR);
  if (!err) err = encode_rows<DK, DV>(&o2, d_o, DV, H, P, B, QR);
  if (!err) err = encode_rows<DK, DV>(&k2, k, DK, Hkv, S_max, B, C::KTQ);
  if (!err) err = encode_rows<DK, DV>(&v2, v, DV, Hkv, S_max, B, C::KTQ);
  if (err) return err;
  cudaError_t e = allow_smem(dkdv_kernel<DK, DV, WINDOW>, C::SMEM1);
  if (e == cudaSuccess) e = allow_smem(dq_kernel<DK, DV, WINDOW>, C::SMEM2);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float sl2 = scale * kLog2e;
  const dim3 g1(Hkv * split, B, (S_max + C::KT - 1) / C::KT);
  dkdv_kernel<DK, DV, WINDOW><<<g1, kThreads, C::SMEM1, stream>>>(
          q1, o1, k1, v1, stat, offset, dk, dv, split > 1 ? part : nullptr, B, P, Ppad, H, Hkv,
          S_max, window, causal, split, sl2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (split > 1) {
    // the head groups' partials, summed in a fixed order
    const long n_dk = static_cast<long>(B) * S_max * Hkv * DK;
    const long n_dv = static_cast<long>(B) * S_max * Hkv * DV;
    const auto r_dk = static_cast<unsigned>((n_dk / 4 + 255) / 256);
    const auto r_dv = static_cast<unsigned>((n_dv / 4 + 255) / 256);
    reduce_kernel<<<r_dk, 256, 0, stream>>>(part, dk, n_dk, split, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    reduce_kernel<<<r_dv, 256, 0, stream>>>(part + split * n_dk, dv, n_dv, split, 1.0f);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    if (grid) grid[1] = static_cast<int>(r_dk + r_dv);
  }
  const int n_qtiles = (P + QR - 1) / QR;
  const dim3 g2(H, B, n_qtiles);
  dq_kernel<DK, DV, WINDOW><<<g2, kThreads, C::SMEM2, stream>>>(
      q2, o2, k2, v2, stat, offset, dq, B, P, Ppad, H, Hkv, S_max, window, causal, sl2, scale,
      n_qtiles);
  if (grid) {
    grid[0] = static_cast<int>(g1.x * g1.y * g1.z);
    grid[2] = static_cast<int>(g2.x * g2.y * g2.z);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* d_o, const int* offset, bf16* dq, bf16* dk, bf16* dv, float* stat,
           float* part, int B, int P, int H, int Hkv, int S_max, int window, int causal,
           int split, int key_tile, float scale, int* grid, cudaStream_t stream) {
  // the caller chose the split for this key tile (``ops.bwd_split``)
  if (key_tile != Cfg<DK, DV>::KT) return static_cast<int>(cudaErrorInvalidValue);
  const int Ppad = (P + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const long rows = static_cast<long>(B) * H * Ppad;
  rowstat_kernel<DV><<<static_cast<unsigned>((rows + 3) / 4), 128, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(d_o), lse, stat, rows, P, Ppad, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (causal && window > 0)
    return launch_passes<DK, DV, true>(q, k, v, d_o, stat, offset, dq, dk, dv, part, B, P,
                                       Ppad, H, Hkv, S_max, window, causal, split, scale,
                                       grid, stream);
  return launch_passes<DK, DV, false>(q, k, v, d_o, stat, offset, dq, dk, dv, part, B, P, Ppad,
                                      H, Hkv, S_max, window, causal, split, scale, grid,
                                      stream);
}

}  // namespace

// (hd, hd_v) in (32, 32), (64, 64), (128, 128), (192, 128), (256, 256), the
// forward's pairs; any g = H / Hkv; window 0 for none; causal 1, or 0 for
// the bidirectional mask (offset and window ignored); every pointer
// 16-byte aligned.  Scratch: ``stat`` holds 2 * B * H * Ppad floats, Ppad
// = P rounded up to a multiple of 128; with ``split`` > 1 (a divisor of g:
// the dK/dV pass's query-head groups) ``part`` holds split * B * S_max *
// Hkv * (hd + hd_v) floats, else it may be null.  ``key_tile`` is the
// dK/dV pass's keys per CTA that the split was chosen for: the call fails
// unless it is this build's (128 up to hd 128, else 64).  ``grid``, where
// not null, receives the CTAs the call launched: dK/dV, the two sums of
// the split's partials together (0 unsplit), dQ.
extern "C" int prefill_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* d_o,
                                          const void* offset, void* dq, void* dk, void* dv,
                                          void* stat, void* part, int B, int P, int H, int Hkv,
                                          int S_max, int hd, int hd_v, int window, int causal,
                                          int split, int key_tile, float scale, int* grid,
                                          void* stream) {
  if (grid) grid[0] = grid[1] = grid[2] = 0;
  if (B == 0 || H == 0 || S_max == 0) return 0;
  // grid limits: B on y, the key and query tiles on z (64 keys, 128 queries)
  if (Hkv <= 0 || H % Hkv != 0 || split < 1 || (H / Hkv) % split != 0 || B > 65535 ||
      S_max > 64L * 65535 || P > 128L * 65535 || (split > 1 && part == nullptr) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(d_o) | reinterpret_cast<uintptr_t>(stat) |
       reinterpret_cast<uintptr_t>(part)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (P == 0) {
    // no query: every key's gradient is zero
    const size_t rows = static_cast<size_t>(B) * S_max * Hkv;
    cudaMemsetAsync(dk, 0, rows * hd * 2, st);
    cudaMemsetAsync(dv, 0, rows * hd_v * 2, st);
    return static_cast<int>(cudaGetLastError());
  }
#define ARGS                                                                               \
  q, k, v, o, static_cast<const float*>(lse), d_o, static_cast<const int*>(offset),        \
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),              \
      static_cast<float*>(stat), static_cast<float*>(part), B, P, H, Hkv, S_max, window,    \
      causal, split, key_tile, scale, grid, st
  if (hd == 32 && hd_v == 32) return launch<32, 32>(ARGS);
  if (hd == 64 && hd_v == 64) return launch<64, 64>(ARGS);
  if (hd == 128 && hd_v == 128) return launch<128, 128>(ARGS);
  if (hd == 192 && hd_v == 128) return launch<192, 128>(ARGS);
  if (hd == 256 && hd_v == 256) return launch<256, 256>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
