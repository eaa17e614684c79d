// Backward of the GQA prefill attention (prefill_attention.cu), causal,
// by hand for Hopper (sm_90a): FlashAttention-2's scheme on mma.sync.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel
// (its training path lets XLA differentiate the jnp masked_attention,
// src/repro/models/attention.py).  It computes the vjp of the forward
// kernel's contract (the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_pallas), causal, no window: q (B, P, H, hd) at positions
// offset[b] + i over k, v (B, S_max, Hkv, hd); key j visible to query i
// when j <= offset + i and j < S_max (the training path: offset 0, S_max
// = P).  From the forward's output O and its per-row log-sum-exp L (B, H,
// P; fp32, natural log, written by the forward kernel on request) and dO:
//
//   D  = rowsum(dO o O)                                  (delta_kernel)
//   P  = exp(S - L), S = Q K^T / sqrt(hd)     dV = sum over rows P^T dO
//   dP = dO V^T   dS = P o (dP - D)           dK = sum over rows dS^T Q / sqrt(hd)
//                                                        (dkdv_kernel)
//   dQ = dS K / sqrt(hd)                                 (dq_kernel)
//
// Query head h reads kv head h % Hkv (g-major grouping); dK and dV sum the
// g query heads of their kv head.  Three launches and no atomics: every
// output element is written by one thread of one CTA after a fixed-order
// sum, so two calls give the same bits (PERF.md §6: a cross-CTA reduction
// is a second launch, never float atomics).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the vjp
// needs five products of 2 hd flops per visible (query head, key) pair
// (S, dP, dV, dK, dQ), against the forward's two; this kernel does seven
// (its dQ pass recomputes S and dP).  minicpm-2b's training step (B 8, P
// 256, 36 heads of 64; causal) is 8 * 36 * 256 * 257 / 2 = 9.47 M pairs,
// 10 * 64 * 9.47 M = 6.1 GFLOP (6.1 us) against q, k, v, o, dO in and dq,
// dk, dv out, 8 tensors of 9.4 MB = 75 MB (22.5 us): bytes-bound at P 256.
// qwen3-30b-a3b at P 2048 (32/4 heads of 128) is operations-bound.
//
// Design (simple first; a wgmma redesign is later work).  128 threads, 4
// warps, each owning 16 rows of the CTA's 64; mma.sync m16n8k16 from
// shared memory through ldmatrix (tiles.cuh), tiles loaded by cp.async:
//  * dkdv_kernel: one CTA per (64-key tile, kv head, b).  K and V stay in
//    shared memory; the CTA walks the g query heads of its kv head and,
//    for each, the query tiles from the first that sees its keys to P.  It
//    computes S^T = K Q^T (keys as rows), so P^T and dS^T come out of the
//    accumulators already in the layout of mma's A operand for dV += P^T
//    dO and dK += dS^T Q.  dK and dV stay in fp32 registers until one
//    store.  Query tiles of 64 rows at hd 64 and 32 at hd 128 (registers:
//    dK and dV are 2 x 64 a thread at hd 128).
//  * dq_kernel: one CTA per (64-query tile, head, b); Q and dO stay in
//    shared memory, K/V tiles of 64 keys stream from the first to the
//    last any of its rows sees; dQ stays in fp32 registers.
// Every tile evaluates the mask (cheap beside the products).  P and dS
// are rounded to bf16 for the tensor cores, as the forward rounds P.
#include "tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int KT = 64;          // keys per CTA (dkdv) or per tile (dq)
constexpr int QR = 64;          // query rows per CTA (dq)
constexpr int kThreads = 128;   // 4 warps x 16 rows

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 8;                  // tile row, elements
  static constexpr int QT = HD <= 64 ? 64 : 32;      // dkdv: queries a step
  static constexpr int DKDV_SMEM = (2 * KT + 2 * QT) * LD * 2 + 2 * QT * 4;
  static constexpr int DQ_SMEM = (2 * QR + 2 * KT) * LD * 2 + 2 * QR * 4;
};

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]: one warp per row, lanes
// over the width in a fixed order
template <int HD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ d_o, float* __restrict__ delta,
             long rows, int P, int H) {
  const long row = static_cast<long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int c = lane * 2; c < HD; c += 64) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(o + row * HD + c);
    const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(d_o + row * HD + c);
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ d_o, const float* __restrict__ lse,
            const float* __restrict__ delta, const int* __restrict__ offset,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int P, int H, int Hkv, int S_max,
            float scale_log2, float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, QT = C::QT, NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + KT * LD;
  bf16* qs = vs + KT * LD;
  bf16* dos = qs + QT * LD;
  float* lse_s = reinterpret_cast<float*>(dos + QT * LD);
  float* del_s = lse_s + QT;

  const int k0 = blockIdx.x * KT, kh = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv, off = offset[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = warp * 16;                      // this warp's key rows
  const long kv_ld = static_cast<long>(Hkv) * HD, q_ld = static_cast<long>(H) * HD;
  const bf16* kb = k + (static_cast<long>(b) * S_max * Hkv + kh) * HD;
  const bf16* vb = v + (static_cast<long>(b) * S_max * Hkv + kh) * HD;
  tiles::load_box<KT, HD>(ks, kb, k0, 0, kv_ld, S_max, HD);
  tiles::load_box<KT, HD>(vs, vb, k0, 0, kv_ld, S_max, HD);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.0f;

  // the first query that sees key k0 sits at k0 - offset
  const int i_begin = max(0, k0 - off) / QT * QT;
  for (int gi = 0; gi < g; ++gi) {
    const int h = gi * Hkv + kh;
    const bf16* qb = q + (static_cast<long>(b) * P * H + h) * HD;
    const bf16* dob = d_o + (static_cast<long>(b) * P * H + h) * HD;
    const float* lse_b = lse + (static_cast<long>(b) * H + h) * P;
    const float* del_b = delta + (static_cast<long>(b) * H + h) * P;
    for (int i0 = i_begin; i0 < P; i0 += QT) {
      __syncthreads();                           // the last tile's readers are done
      tiles::load_box<QT, HD>(qs, qb, i0, 0, q_ld, P, HD);
      tiles::load_box<QT, HD>(dos, dob, i0, 0, q_ld, P, HD);
      cp_async_commit();
      if (threadIdx.x < QT) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < P ? lse_b[i] * kLog2e : 0.0f;
        del_s[threadIdx.x] = i < P ? del_b[i] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T (16 keys x QT queries) = K Q^T, then P^T = exp(S^T - L)
      float p[QT / 8][4], dp[QT / 8][4];
#pragma unroll
      for (int t = 0; t < QT / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[t][e] = dp[t][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t ak[4], av[4];
        tiles::frag_a_mk(ak, ks, LD, kw, kk);
        tiles::frag_a_mk(av, vs, LD, kw, kk);
#pragma unroll
        for (int n = 0; n < QT; n += 16) {
          uint32_t bq[4], bo[4];
          tiles::frag_b_nk(bq, qs, LD, n, kk);
          tiles::frag_b_nk(bo, dos, LD, n, kk);
          tiles::mma_pair(p[n / 8], p[n / 8 + 1], ak, bq);     // S^T
          tiles::mma_pair(dp[n / 8], dp[n / 8 + 1], av, bo);   // dP^T = V dO^T
        }
      }
#pragma unroll
      for (int t = 0; t < QT / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + lane / 4 + 8 * (e >> 1);
          const int qi = t * 8 + (lane % 4) * 2 + (e & 1);
          const int i = i0 + qi;
          const bool vis = i < P && key <= off + i && key < S_max;
          const float pr = vis ? exp2f(p[t][e] * scale_log2 - lse_s[qi]) : 0.0f;
          p[t][e] = pr;
          dp[t][e] = pr * (dp[t][e] - del_s[qi]);              // dS^T
        }
      // dV += P^T dO and dK += dS^T Q, k over the QT queries
#pragma unroll
      for (int kq = 0; kq < QT / 16; ++kq) {
        uint32_t ap[4], as[4];
        tiles::acc_to_a(ap, p[2 * kq], p[2 * kq + 1]);
        tiles::acc_to_a(as, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int n = 0; n < HD; n += 16) {
          uint32_t bo[4], bq[4];
          tiles::frag_b_kn(bo, dos, LD, n, kq * 16);
          tiles::frag_b_kn(bq, qs, LD, n, kq * 16);
          tiles::mma_pair(dv_acc[n / 8], dv_acc[n / 8 + 1], ap, bo);
          tiles::mma_pair(dk_acc[n / 8], dk_acc[n / 8 + 1], as, bq);
        }
      }
    }
  }
  cp_async_wait<0>();   // no K/V load left in flight (a CTA whose keys no query sees)

  // store rows k0 + kw + lane / 4 (+ 8); keys no query sees get zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw + lane / 4 + 8 * r;
    if (key >= S_max) continue;
    const long at = ((static_cast<long>(b) * S_max + key) * Hkv + kh) * HD + (lane % 4) * 2;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      *reinterpret_cast<uint32_t*>(dk + at + t * 8) =
          pack_bf16(dk_acc[t][2 * r] * scale, dk_acc[t][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + t * 8) =
          pack_bf16(dv_acc[t][2 * r], dv_acc[t][2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ d_o, const float* __restrict__ lse,
          const float* __restrict__ delta, const int* __restrict__ offset,
          bf16* __restrict__ dq, int P, int H, int Hkv, int S_max, float scale_log2,
          float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + QR * LD;
  bf16* ks = dos + QR * LD;
  bf16* vs = ks + KT * LD;
  float* lse_s = reinterpret_cast<float*>(vs + KT * LD);
  float* del_s = lse_s + QR;

  const int i0 = blockIdx.x * QR, h = blockIdx.y, b = blockIdx.z;
  const int kh = h % Hkv, off = offset[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = warp * 16;                      // this warp's query rows
  const long kv_ld = static_cast<long>(Hkv) * HD, q_ld = static_cast<long>(H) * HD;
  tiles::load_box<QR, HD>(qs, q + (static_cast<long>(b) * P * H + h) * HD, i0, 0, q_ld, P, HD);
  tiles::load_box<QR, HD>(dos, d_o + (static_cast<long>(b) * P * H + h) * HD, i0, 0, q_ld, P,
                          HD);
  cp_async_commit();
  if (threadIdx.x < QR) {
    const int i = i0 + threadIdx.x;
    const long at = (static_cast<long>(b) * H + h) * P + i;
    lse_s[threadIdx.x] = i < P ? lse[at] * kLog2e : 0.0f;
    del_s[threadIdx.x] = i < P ? delta[at] : 0.0f;
  }
  const bf16* kb = k + (static_cast<long>(b) * S_max * Hkv + kh) * HD;
  const bf16* vb = v + (static_cast<long>(b) * S_max * Hkv + kh) * HD;

  float dq_acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[t][e] = 0.0f;
  // keys up to the last row's position
  const int kv_end = min(off + min(i0 + QR, P), S_max);
  for (int j0 = 0; j0 < kv_end; j0 += KT) {
    __syncthreads();                             // the last tile's readers are done
    tiles::load_box<KT, HD>(ks, kb, j0, 0, kv_ld, S_max, HD);
    tiles::load_box<KT, HD>(vs, vb, j0, 0, kv_ld, S_max, HD);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float p[KT / 8][4], ds[KT / 8][4];
#pragma unroll
    for (int t = 0; t < KT / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][e] = ds[t][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t aq[4], ao[4];
      tiles::frag_a_mk(aq, qs, LD, qw, kk);
      tiles::frag_a_mk(ao, dos, LD, qw, kk);
#pragma unroll
      for (int n = 0; n < KT; n += 16) {
        uint32_t bk[4], bv[4];
        tiles::frag_b_nk(bk, ks, LD, n, kk);
        tiles::frag_b_nk(bv, vs, LD, n, kk);
        tiles::mma_pair(p[n / 8], p[n / 8 + 1], aq, bk);     // S = Q K^T
        tiles::mma_pair(ds[n / 8], ds[n / 8 + 1], ao, bv);   // dP = dO V^T
      }
    }
#pragma unroll
    for (int t = 0; t < KT / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qw + lane / 4 + 8 * (e >> 1);
        const int i = i0 + qi;
        const int key = j0 + t * 8 + (lane % 4) * 2 + (e & 1);
        const bool vis = i < P && key <= off + i && key < S_max;
        const float pr = vis ? exp2f(p[t][e] * scale_log2 - lse_s[qi]) : 0.0f;
        ds[t][e] = pr * (ds[t][e] - del_s[qi]);
      }
    // dQ += dS K, k over the tile's keys
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t as[4];
      tiles::acc_to_a(as, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < HD; n += 16) {
        uint32_t bk[4];
        tiles::frag_b_kn(bk, ks, LD, n, kk * 16);
        tiles::mma_pair(dq_acc[n / 8], dq_acc[n / 8 + 1], as, bk);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + qw + lane / 4 + 8 * r;
    if (i >= P) continue;
    const long at = ((static_cast<long>(b) * P + i) * H + h) * HD + (lane % 4) * 2;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<uint32_t*>(dq + at + t * 8) =
          pack_bf16(dq_acc[t][2 * r] * scale, dq_acc[t][2 * r + 1] * scale);
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const float* lse,
           const bf16* d_o, const int* offset, bf16* dq, bf16* dk, bf16* dv, float* delta,
           int B, int P, int H, int Hkv, int S_max, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  cudaError_t err = allow_smem(dkdv_kernel<HD>, C::DKDV_SMEM);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<HD>, C::DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long rows = static_cast<long>(B) * P * H;
  delta_kernel<HD><<<static_cast<unsigned>((rows + 3) / 4), kThreads, 0, stream>>>(
      o, d_o, delta, rows, P, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sl2 = scale * kLog2e;
  dkdv_kernel<HD><<<dim3((S_max + KT - 1) / KT, Hkv, B), kThreads, C::DKDV_SMEM, stream>>>(
      q, k, v, d_o, lse, delta, offset, dk, dv, P, H, Hkv, S_max, sl2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<HD><<<dim3((P + QR - 1) / QR, H, B), kThreads, C::DQ_SMEM, stream>>>(
      q, k, v, d_o, lse, delta, offset, dq, P, H, Hkv, S_max, sl2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hd = hd_v in 64, 128; any g = H / Hkv; causal, no window; every pointer
// 16-byte aligned; delta holds B * H * P floats (scratch).
extern "C" int prefill_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* d_o,
                                          const void* offset, void* dq, void* dk, void* dv,
                                          void* delta, int B, int P, int H, int Hkv,
                                          int S_max, int hd, float scale, void* stream) {
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
      static_cast<float*>(delta), B, P, H, Hkv, S_max, scale, st
  if (P == 0) {
    // no query: every key's gradient is zero
    cudaMemsetAsync(dk, 0, static_cast<size_t>(B) * S_max * Hkv * hd * 2, st);
    cudaMemsetAsync(dv, 0, static_cast<size_t>(B) * S_max * Hkv * hd * 2, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (hd == 64) return launch<64>(ARGS);
  if (hd == 128) return launch<128>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
