// Backward of the GQA prefill attention (prefill_attention.cu) at every
// contract its forward takes, by hand for Hopper (sm_90a): FlashAttention-2's
// scheme on mma.sync.
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
//   D  = rowsum(dO o O)                                  (delta_kernel)
//   P  = exp(S - L), S = Q K^T / sqrt(dk)     dV = sum over rows P^T dO
//   dP = dO V^T   dS = P o (dP - D)           dK = sum over rows dS^T Q / sqrt(dk)
//                                                        (dkdv_kernel)
//   dQ = dS K / sqrt(dk)                                 (dq_kernel)
//
// Query head h reads kv head h % Hkv (g-major grouping); dK and dV sum the
// g query heads of their kv head.  Three launches and no atomics: every
// output element is written by one thread of one CTA after a fixed-order
// sum, so two calls give the same bits (PERF.md §6: a cross-CTA reduction
// is a second launch, never float atomics).  Keys no query sees get zero
// gradients; no row at or past S_max is written.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the vjp
// needs five products per visible (query head, key) pair, 2 (3 dk + 2 dv)
// flops (S, dK and dQ over dk; dP and dV over dv), against the forward's
// two; this kernel does seven (its dQ pass recomputes S and dP).
// minicpm-2b's training step (B 8, P 256, 36 heads of 64; causal) is 8 *
// 36 * 256 * 257 / 2 = 9.47 M pairs, 6.1 GFLOP (6.1 us) against q, k, v,
// o, dO in and dq, dk, dv out, 8 tensors of 9.4 MB = 75 MB (22.5 us):
// bytes-bound at P 256, as are recurrentgemma-9b's (16/1 heads of 256:
// 71 MB, 21 us, against 10.8 GFLOP) and whisper-base's cross-attention (8
// x 256 queries over 1500 frames, 8/8 of 64: 58 MB, 17 us, against 15.7
// GFLOP).  deepseek-v2-236b's (128 heads, dk 192, dv 128) moves 671 MB
// (200 us) against 56 GFLOP.  qwen3-30b-a3b at P 2048 (32/4 heads of 128)
// is operations-bound.
//
// Design (simple first; a wgmma redesign is later work).  128 threads, 4
// warps; mma.sync m16n8k16 from shared memory through ldmatrix
// (tiles.cuh), tiles loaded by cp.async:
//  * dkdv_kernel: one CTA per (key tile, kv head, b).  K and V stay in
//    shared memory; the CTA walks the g query heads of its kv head and,
//    for each, the query tiles that see its keys: from the first (causal:
//    the tile of query k0 - offset; else 0) to the last (with a window:
//    the last query that still sees key k0 + KT - 1; else P).  It
//    computes S^T = K Q^T (keys as rows), so P^T and dS^T come out of the
//    accumulators already in the layout of mma's A operand for dV += P^T
//    dO and dK += dS^T Q.  dK and dV stay in fp32 registers until one
//    store.  Each warp owns 16 key rows.  Up to dk 128 a tile is 64 keys
//    (one warp a row block) and its query tiles 64 rows at dk <= 64, 32
//    at 128 (dK and dV are 2 x 64 fp32 registers a thread at 128: ptxas
//    229).  At (192, 128) and (256, 256) the two accumulators would need
//    160 and 256 registers a thread, so a tile there is 32 keys and the
//    two warps of a row block split the columns of dK and dV between them
//    (80 and 128 a thread), each computing its rows' S^T and dP^T whole:
//    those two products run twice, the price of keeping the sums in
//    registers without spills.
//  * dq_kernel: one CTA per (64-query tile, head, b); Q and dO stay in
//    shared memory, K/V tiles (64 keys, 32 past dk 128, where dQ alone is
//    96 or 128 registers a thread) stream over the keys any of its rows
//    sees; dQ stays in fp32 registers.
// Every tile evaluates the mask (cheap beside the products): it also
// zeroes the keys past S_max of a last, partial key tile, which load as
// zeros and would otherwise score 0, not -inf.  P and dS are rounded to
// bf16 for the tensor cores, as the forward rounds P.
#include "tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int QR = 64;          // query rows per CTA (dq)
constexpr int kThreads = 128;   // 4 warps

template <int DK, int DV>
struct Cfg {
  static constexpr bool WIDE = DK > 128;              // (192, 128), (256, 256)
  static constexpr int LDK = DK + 8, LDV = DV + 8;    // tile rows, elements
  static constexpr int KT = WIDE ? 32 : 64;           // dkdv: keys per CTA
  static constexpr int RG = KT / 16;                  // warps along the keys
  static constexpr int CS = 4 / RG;                   // warps along dK/dV's columns
  static constexpr int QT = DK <= 64 ? 64 : 32;       // dkdv: queries a step
  static constexpr int KTQ = WIDE ? 32 : 64;          // dq: keys a step
  static constexpr int DKDV_SMEM = (KT + QT) * (LDK + LDV) * 2 + 2 * QT * 4;
  static constexpr int DQ_SMEM = (QR + KTQ) * (LDK + LDV) * 2 + 2 * QR * 4;
  static_assert(DK % (16 * CS) == 0 && DV % (16 * CS) == 0, "column split");
};

// The keys below S_max that query i sees run up to i + hi (causal: hi =
// offset; without the causal mask, all of them) and, under a window (a
// build of its own, WINDOW), from i + lo, lo = offset - window + 1.  The
// per-element test stays one compare without a window, as before windows
// were taken: testing the flags per element branched, and a second
// compare in every build cost the (64, 64) dK/dV pass 30% at P 2048.
template <bool WINDOW>
struct Visible {
  int lo, hi;
  __device__ Visible(int off, int window, int causal)
      : lo(off - window + 1), hi(causal ? off : (1 << 30)) {}
  __device__ __forceinline__ bool operator()(int key, int i) const {
    return key <= i + hi && (!WINDOW || key >= i + lo);
  }
};

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]: one warp per row, lanes
// over the width in a fixed order
template <int DV>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o, float* __restrict__ delta,
             long rows, int P, int H) {
  const long row = static_cast<long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int c = lane * 2; c < DV; c += 64) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(o + row * DV + c);
    const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(d_o + row * DV + c);
    s += __bfloat162float(x.x) * __bfloat162float(y.x) +
         __bfloat162float(x.y) * __bfloat162float(y.y);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) s += __shfl_xor_sync(0xffffffffu, s, sh);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long bi = row / H;                    // b * P + i
    delta[(bi / P * H + h) * P + bi % P] = s;
  }
}

template <int DK, int DV, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ d_o, const float* __restrict__ lse,
            const float* __restrict__ delta, const int* __restrict__ offset,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int P, int H, int Hkv, int S_max,
            int window, int causal, float scale_log2, float scale) {
  using C = Cfg<DK, DV>;
  constexpr int LDK = C::LDK, LDV = C::LDV, KT = C::KT, QT = C::QT;
  constexpr int WK = DK / C::CS, WV = DV / C::CS;    // this warp's dK / dV columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + KT * LDK;
  bf16* qs = vs + KT * LDV;
  bf16* dos = qs + QT * LDK;
  float* lse_s = reinterpret_cast<float*>(dos + QT * LDV);
  float* del_s = lse_s + QT;

  const int k0 = blockIdx.x * KT, kh = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv, off = offset[b];
  const Visible<WINDOW> seen(off, window, causal);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this warp's key rows and dK / dV columns (all of them without a split)
  const int kw = (C::CS == 1 ? warp : warp % C::RG) * 16;
  const int cs = C::CS == 1 ? 0 : warp / C::RG;
  const int ck = cs * WK, cv = cs * WV;
  const long k_ld = static_cast<long>(Hkv) * DK, v_ld = static_cast<long>(Hkv) * DV;
  const long q_ld = static_cast<long>(H) * DK, o_ld = static_cast<long>(H) * DV;
  const long kv_row0 = static_cast<long>(b) * S_max * Hkv + kh;
  tiles::load_box<KT, DK>(ks, k + kv_row0 * DK, k0, 0, k_ld, S_max, DK);
  tiles::load_box<KT, DV>(vs, v + kv_row0 * DV, k0, 0, v_ld, S_max, DV);
  cp_async_commit();

  float dk_acc[WK / 8][4], dv_acc[WV / 8][4];
#pragma unroll
  for (int t = 0; t < WK / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = 0.0f;
#pragma unroll
  for (int t = 0; t < WV / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[t][e] = 0.0f;

  // the queries that see a key of this tile: causal, from the first that
  // sees key k0 (at k0 - offset) to, with a window, the last that still
  // sees key k0 + KT - 1 (before k0 + KT - 1 - offset + window)
  int i_begin = 0, i_end = P;
  if (causal) {
    i_begin = max(0, k0 - off) / QT * QT;
    if (WINDOW) i_end = min(P, k0 + KT - 1 - off + window);
  }
  for (int gi = 0; gi < g; ++gi) {
    const int h = gi * Hkv + kh;
    const bf16* qb = q + (static_cast<long>(b) * P * H + h) * DK;
    const bf16* dob = d_o + (static_cast<long>(b) * P * H + h) * DV;
    const float* lse_b = lse + (static_cast<long>(b) * H + h) * P;
    const float* del_b = delta + (static_cast<long>(b) * H + h) * P;
    for (int i0 = i_begin; i0 < i_end; i0 += QT) {
      __syncthreads();                           // the last tile's readers are done
      tiles::load_box<QT, DK>(qs, qb, i0, 0, q_ld, P, DK);
      tiles::load_box<QT, DV>(dos, dob, i0, 0, o_ld, P, DV);
      cp_async_commit();
      if (threadIdx.x < QT) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < P ? lse_b[i] * kLog2e : 0.0f;
        del_s[threadIdx.x] = i < P ? del_b[i] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T (16 keys x QT queries) = K Q^T over dk and dP^T = V dO^T over
      // dv, then P^T = exp(S^T - L)
      float p[QT / 8][4], dp[QT / 8][4];
#pragma unroll
      for (int t = 0; t < QT / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[t][e] = dp[t][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < (DK > DV ? DK : DV); kk += 16) {
        uint32_t ak[4], av[4];
        if (kk < DK) tiles::frag_a_mk(ak, ks, LDK, kw, kk);
        if (kk < DV) tiles::frag_a_mk(av, vs, LDV, kw, kk);
#pragma unroll
        for (int n = 0; n < QT; n += 16) {
          uint32_t bq[4], bo[4];
          if (kk < DK) {
            tiles::frag_b_nk(bq, qs, LDK, n, kk);
            tiles::mma_pair(p[n / 8], p[n / 8 + 1], ak, bq);     // S^T
          }
          if (kk < DV) {
            tiles::frag_b_nk(bo, dos, LDV, n, kk);
            tiles::mma_pair(dp[n / 8], dp[n / 8 + 1], av, bo);   // dP^T = V dO^T
          }
        }
      }
#pragma unroll
      for (int t = 0; t < QT / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + lane / 4 + 8 * (e >> 1);
          const int qi = t * 8 + (lane % 4) * 2 + (e & 1);
          const int i = i0 + qi;
          const bool vis = i < P && key < S_max && seen(key, i);
          const float pr = vis ? exp2f(p[t][e] * scale_log2 - lse_s[qi]) : 0.0f;
          p[t][e] = pr;
          dp[t][e] = pr * (dp[t][e] - del_s[qi]);              // dS^T
        }
      // dV += P^T dO and dK += dS^T Q over this warp's columns, k over the
      // QT queries
#pragma unroll
      for (int kq = 0; kq < QT / 16; ++kq) {
        uint32_t ap[4], as[4];
        tiles::acc_to_a(ap, p[2 * kq], p[2 * kq + 1]);
        tiles::acc_to_a(as, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int n = 0; n < WV; n += 16) {
          uint32_t bo[4];
          tiles::frag_b_kn(bo, dos, LDV, cv + n, kq * 16);
          tiles::mma_pair(dv_acc[n / 8], dv_acc[n / 8 + 1], ap, bo);
        }
#pragma unroll
        for (int n = 0; n < WK; n += 16) {
          uint32_t bq[4];
          tiles::frag_b_kn(bq, qs, LDK, ck + n, kq * 16);
          tiles::mma_pair(dk_acc[n / 8], dk_acc[n / 8 + 1], as, bq);
        }
      }
    }
  }
  cp_async_wait<0>();   // no K/V load left in flight (a CTA whose keys no query sees)

  // store rows k0 + kw + lane / 4 (+ 8) below S_max; keys no query sees
  // get zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw + lane / 4 + 8 * r;
    if (key >= S_max) continue;
    const long row = (static_cast<long>(b) * S_max + key) * Hkv + kh;
    bf16* dkp = dk + row * DK + ck + (lane % 4) * 2;
    bf16* dvp = dv + row * DV + cv + (lane % 4) * 2;
#pragma unroll
    for (int t = 0; t < WK / 8; ++t)
      *reinterpret_cast<uint32_t*>(dkp + t * 8) =
          pack_bf16(dk_acc[t][2 * r] * scale, dk_acc[t][2 * r + 1] * scale);
#pragma unroll
    for (int t = 0; t < WV / 8; ++t)
      *reinterpret_cast<uint32_t*>(dvp + t * 8) =
          pack_bf16(dv_acc[t][2 * r], dv_acc[t][2 * r + 1]);
  }
}

template <int DK, int DV, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ d_o, const float* __restrict__ lse,
          const float* __restrict__ delta, const int* __restrict__ offset,
          bf16* __restrict__ dq, int P, int H, int Hkv, int S_max, int window, int causal,
          float scale_log2, float scale) {
  using C = Cfg<DK, DV>;
  constexpr int LDK = C::LDK, LDV = C::LDV, KT = C::KTQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + QR * LDK;
  bf16* ks = dos + QR * LDV;
  bf16* vs = ks + KT * LDK;
  float* lse_s = reinterpret_cast<float*>(vs + KT * LDV);
  float* del_s = lse_s + QR;

  const int i0 = blockIdx.x * QR, h = blockIdx.y, b = blockIdx.z;
  const int kh = h % Hkv, off = offset[b];
  const Visible<WINDOW> seen(off, window, causal);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp * 16;                      // this warp's query rows
  const long k_ld = static_cast<long>(Hkv) * DK, v_ld = static_cast<long>(Hkv) * DV;
  const long q_ld = static_cast<long>(H) * DK, o_ld = static_cast<long>(H) * DV;
  tiles::load_box<QR, DK>(qs, q + (static_cast<long>(b) * P * H + h) * DK, i0, 0, q_ld, P, DK);
  tiles::load_box<QR, DV>(dos, d_o + (static_cast<long>(b) * P * H + h) * DV, i0, 0, o_ld, P,
                          DV);
  cp_async_commit();
  if (threadIdx.x < QR) {
    const int i = i0 + threadIdx.x;
    const long at = (static_cast<long>(b) * H + h) * P + i;
    lse_s[threadIdx.x] = i < P ? lse[at] * kLog2e : 0.0f;
    del_s[threadIdx.x] = i < P ? delta[at] : 0.0f;
  }
  const long kv_row0 = static_cast<long>(b) * S_max * Hkv + kh;
  const bf16* kb = k + kv_row0 * DK;
  const bf16* vb = v + kv_row0 * DV;

  float dq_acc[DK / 8][4];
#pragma unroll
  for (int t = 0; t < DK / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[t][e] = 0.0f;
  // the keys any row sees: causal, up to the last row's position and, with
  // a window, from the first row's first key (rounded down to a tile)
  int kv_begin = 0, kv_end = S_max;
  if (causal) {
    kv_end = min(off + min(i0 + QR, P), S_max);
    if (WINDOW) kv_begin = max(0, off + i0 - window + 1) / KT * KT;
  }
  for (int j0 = kv_begin; j0 < kv_end; j0 += KT) {
    __syncthreads();                             // the last tile's readers are done
    tiles::load_box<KT, DK>(ks, kb, j0, 0, k_ld, S_max, DK);
    tiles::load_box<KT, DV>(vs, vb, j0, 0, v_ld, S_max, DV);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float p[KT / 8][4], ds[KT / 8][4];
#pragma unroll
    for (int t = 0; t < KT / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = ds[t][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < (DK > DV ? DK : DV); kk += 16) {
      uint32_t aq[4], ao[4];
      if (kk < DK) tiles::frag_a_mk(aq, qs, LDK, qw, kk);
      if (kk < DV) tiles::frag_a_mk(ao, dos, LDV, qw, kk);
#pragma unroll
      for (int n = 0; n < KT; n += 16) {
        uint32_t bk[4], bv[4];
        if (kk < DK) {
          tiles::frag_b_nk(bk, ks, LDK, n, kk);
          tiles::mma_pair(p[n / 8], p[n / 8 + 1], aq, bk);     // S = Q K^T
        }
        if (kk < DV) {
          tiles::frag_b_nk(bv, vs, LDV, n, kk);
          tiles::mma_pair(ds[n / 8], ds[n / 8 + 1], ao, bv);   // dP = dO V^T
        }
      }
    }
#pragma unroll
    for (int t = 0; t < KT / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qw + lane / 4 + 8 * (e >> 1);
        const int i = i0 + qi;
        const int key = j0 + t * 8 + (lane % 4) * 2 + (e & 1);
        const bool vis = i < P && key < S_max && seen(key, i);
        const float pr = vis ? exp2f(p[t][e] * scale_log2 - lse_s[qi]) : 0.0f;
        ds[t][e] = pr * (ds[t][e] - del_s[qi]);
      }
    // dQ += dS K, k over the tile's keys
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t as[4];
      tiles::acc_to_a(as, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DK; n += 16) {
        uint32_t bk[4];
        tiles::frag_b_kn(bk, ks, LDK, n, kk * 16);
        tiles::mma_pair(dq_acc[n / 8], dq_acc[n / 8 + 1], as, bk);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + qw + lane / 4 + 8 * r;
    if (i >= P) continue;
    const long at = ((static_cast<long>(b) * P + i) * H + h) * DK + (lane % 4) * 2;
#pragma unroll
    for (int t = 0; t < DK / 8; ++t)
      *reinterpret_cast<uint32_t*>(dq + at + t * 8) =
          pack_bf16(dq_acc[t][2 * r] * scale, dq_acc[t][2 * r + 1] * scale);
  }
}

// the dK/dV and dQ passes, after delta_kernel
template <int DK, int DV, bool WINDOW>
int launch_passes(const bf16* q, const bf16* k, const bf16* v, const float* lse,
                  const bf16* d_o, const int* offset, bf16* dq, bf16* dk, bf16* dv,
                  const float* delta, int B, int P, int H, int Hkv, int S_max, int window,
                  int causal, float scale, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  cudaError_t err = allow_smem(dkdv_kernel<DK, DV, WINDOW>, C::DKDV_SMEM);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<DK, DV, WINDOW>, C::DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sl2 = scale * kLog2e;
  dkdv_kernel<DK, DV, WINDOW>
      <<<dim3((S_max + C::KT - 1) / C::KT, Hkv, B), kThreads, C::DKDV_SMEM, stream>>>(
          q, k, v, d_o, lse, delta, offset, dk, dv, P, H, Hkv, S_max, window, causal, sl2,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<DK, DV, WINDOW><<<dim3((P + QR - 1) / QR, H, B), kThreads, C::DQ_SMEM, stream>>>(
      q, k, v, d_o, lse, delta, offset, dq, P, H, Hkv, S_max, window, causal, sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const float* lse,
           const bf16* d_o, const int* offset, bf16* dq, bf16* dk, bf16* dv, float* delta,
           int B, int P, int H, int Hkv, int S_max, int window, int causal, float scale,
           cudaStream_t stream) {
  const long rows = static_cast<long>(B) * P * H;
  delta_kernel<DV><<<static_cast<unsigned>((rows + 3) / 4), kThreads, 0, stream>>>(
      o, d_o, delta, rows, P, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (causal && window > 0)
    return launch_passes<DK, DV, true>(q, k, v, lse, d_o, offset, dq, dk, dv, delta, B, P, H,
                                       Hkv, S_max, window, causal, scale, stream);
  return launch_passes<DK, DV, false>(q, k, v, lse, d_o, offset, dq, dk, dv, delta, B, P, H,
                                      Hkv, S_max, window, causal, scale, stream);
}

}  // namespace

// (hd, hd_v) in (32, 32), (64, 64), (128, 128), (192, 128), (256, 256), the
// forward's pairs; any g = H / Hkv; window 0 for none; causal 1, or 0 for
// the bidirectional mask (offset and window ignored); every pointer
// 16-byte aligned; delta holds B * H * P floats (scratch).
extern "C" int prefill_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* d_o,
                                          const void* offset, void* dq, void* dk, void* dv,
                                          void* delta, int B, int P, int H, int Hkv,
                                          int S_max, int hd, int hd_v, int window,
                                          int causal, float scale, void* stream) {
  if (B == 0 || H == 0 || S_max == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(d_o)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define ARGS                                                                             \
  static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), \
      static_cast<const bf16*>(o), static_cast<const float*>(lse),                      \
      static_cast<const bf16*>(d_o), static_cast<const int*>(offset),                   \
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),          \
      static_cast<float*>(delta), B, P, H, Hkv, S_max, window, causal, scale, st
  if (P == 0) {
    // no query: every key's gradient is zero
    const size_t rows = static_cast<size_t>(B) * S_max * Hkv;
    cudaMemsetAsync(dk, 0, rows * hd * 2, st);
    cudaMemsetAsync(dv, 0, rows * hd_v * 2, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (hd == 32 && hd_v == 32) return launch<32, 32>(ARGS);
  if (hd == 64 && hd_v == 64) return launch<64, 64>(ARGS);
  if (hd == 128 && hd_v == 128) return launch<128, 128>(ARGS);
  if (hd == 192 && hd_v == 128) return launch<192, 128>(ARGS);
  if (hd == 256 && hd_v == 256) return launch<256, 256>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
