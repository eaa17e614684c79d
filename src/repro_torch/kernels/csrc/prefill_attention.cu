// Causal GQA prefill attention over the slot-row KV cache, by hand for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (body _flash_kernel), but to the serving path's contract rather than the
// Pallas kernel's: q (B, P, H, hd) holds P new tokens per row at positions
// offset[b] + i; k/v are the row's whole cache (B, S_max, Hkv, hd) with the
// new keys already written.  Key j is visible to query i when
// j < offset + P, j <= offset + i and, with a window, j > offset + i -
// window (the masks of models/attention.py apply_gqa).  Query head h reads
// kv head h % Hkv (g-major grouping).  A query row that sees no key
// outputs 0.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the causal
// products QK^T and PV, 4 * hd flops per visible (query head, key) pair;
// a 2048-token prompt on an empty row at qwen3-30b-a3b (32 heads, hd 128)
// is 4 * 128 * 32 * 2048 * 2049 / 2 = 34 GFLOP, about 35 us per row —
// operations-bound.  Reading q, the visible K/V once and writing the
// output is 2 * 2048 * (32 + 2 * 4) * 128 * 2 B = 42 MB, about 12.5 us.
//
// Design.  One CTA per (q tile, kv head, row b).  A CTA holds QT = 64 / g
// positions of all g query heads that share its kv head — 64 query rows —
// so each K/V tile is read once for g heads.  It walks kv tiles of KT keys
// over [max(0, first_q - window + 1), min(offset + P, last_q + 1)) with an
// online softmax: S = Q K^T and O += P V run on the tensor cores through
// WMMA (mma.sync 16x16x16 bf16 -> fp32); the running max, denominator and
// the O accumulator stay in fp32 in shared memory.  No wgmma or TMA yet;
// K/V tiles are re-read from L2 by the CTAs of other q tiles.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int R = 64;           // query rows per CTA (QT positions x g heads)
constexpr int KT = 64;          // keys per kv tile
constexpr int HD_MAX = 128;
constexpr int LDS = KT + 4;     // fp32 scores
constexpr int LDP = KT + 8;     // bf16 probabilities
constexpr float kNegInf = -1e30f;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Smem {
  size_t qs, ks, vs, ss, ps, os, m, l, alpha, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Smem smem_layout(int hd) {
  const int ldh = hd + 8, ldo = hd + 4;
  Smem s;
  size_t o = 0;
  s.qs = o; o = align128(o + sizeof(bf16) * R * ldh);
  s.ks = o; o = align128(o + sizeof(bf16) * KT * ldh);
  s.vs = o; o = align128(o + sizeof(bf16) * KT * ldh);
  s.ss = o; o = align128(o + sizeof(float) * R * LDS);
  s.ps = o; o = align128(o + sizeof(bf16) * R * LDP);
  s.os = o; o = align128(o + sizeof(float) * R * ldo);
  s.m = o; o = align128(o + sizeof(float) * R);
  s.l = o; o = align128(o + sizeof(float) * R);
  s.alpha = o; o = align128(o + sizeof(float) * R);
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(kThreads)
prefill_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ offset,
                         bf16* __restrict__ out, int P, int H, int Hkv, int S_max,
                         int hd, int window, float scale) {
  const int g = H / Hkv;
  const int qt = R / g;                       // positions per CTA
  const int q0 = blockIdx.x * qt;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int off = offset[b];
  const int ldh = hd + 8, ldo = hd + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(hd);
  bf16* qs = reinterpret_cast<bf16*>(smem + L.qs);
  bf16* ks = reinterpret_cast<bf16*>(smem + L.ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.vs);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  bf16* ps = reinterpret_cast<bf16*>(smem + L.ps);
  float* os = reinterpret_cast<float*>(smem + L.os);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* a_s = reinterpret_cast<float*>(smem + L.alpha);

  // query row r <-> (position q0 + r / g, head (r % g) * Hkv + kh)
  const int chunks = hd / 8;
  for (int i = threadIdx.x; i < R * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    const int qi = q0 + r / g;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (qi < P) {
      const int h = (r % g) * Hkv + kh;
      val = *reinterpret_cast<const uint4*>(q + ((static_cast<long>(b) * P + qi) * H + h) * hd + c);
    }
    *reinterpret_cast<uint4*>(qs + r * ldh + c) = val;
  }
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    os[r * ldo + c] = 0.0f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }

  const int q_first = off + q0;
  const int q_last = off + min(q0 + qt, P) - 1;
  const int kv_end = min(min(off + P, q_last + 1), S_max);
  const int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const long kv_row = static_cast<long>(Hkv) * hd;   // elements between keys
  const bf16* kb = k + (static_cast<long>(b) * S_max * Hkv + kh) * hd;
  const bf16* vb = v + (static_cast<long>(b) * S_max * Hkv + kh) * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t0 = kv_begin; t0 < kv_end; t0 += KT) {
    const int n = min(KT, kv_end - t0);
    __syncthreads();   // previous tile consumed; Q/O/m/l initialised
    load_tile_bf16(ks, ldh, kb + t0 * kv_row, kv_row, KT, hd, n, hd);
    load_tile_bf16(vs, ldh, vb + t0 * kv_row, kv_row, KT, hd, n, hd);
    __syncthreads();

    // S = Q K^T: (R x KT) = 4 x 4 fragments, two per warp
    for (int f = warp; f < (R / 16) * (KT / 16); f += kWarps) {
      const int rb = f / (KT / 16), cb = f % (KT / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < hd; kk += 16) {
        FragA a;
        FragBCol bk;
        wmma::load_matrix_sync(a, qs + rb * 16 * ldh + kk, ldh);
        wmma::load_matrix_sync(bk, ks + cb * 16 * ldh + kk, ldh);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(ss + rb * 16 * LDS + cb * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per row, two keys per lane
    for (int r = warp; r < R; r += kWarps) {
      const int q_pos = off + q0 + r / g;
      float s[2];
      bool vis[2];
      float tmax = kNegInf;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const int kp = t0 + j;
        vis[u] = j < n && kp <= q_pos && (window <= 0 || kp > q_pos - window);
        s[u] = vis[u] ? ss[r * LDS + j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[u]);
      }
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = vis[u] ? expf(s[u] - m_new) : 0.0f;
        psum += p;
        ps[r * LDP + lane + 32 * u] = __float2bfloat16(p);
      }
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      os[r * ldo + c] *= a_s[r];
    }
    __syncthreads();

    // O += P V: (R x hd) = 4 x hd/16 fragments
    for (int f = warp; f < (R / 16) * (hd / 16); f += kWarps) {
      const int rb = f / (hd / 16), cb = f % (hd / 16);
      FragC acc;
      wmma::load_matrix_sync(acc, os + rb * 16 * ldo + cb * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < KT; kk += 16) {
        FragA a;
        FragBRow bv;
        wmma::load_matrix_sync(a, ps + rb * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(bv, vs + kk * ldh + cb * 16, ldh);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + rb * 16 * ldo + cb * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    const int qi = q0 + r / g;
    if (qi >= P) continue;
    const int h = (r % g) * Hkv + kh;
    const float l = l_s[r];
    const float o = l > 0.0f ? os[r * ldo + c] / l : 0.0f;
    out[((static_cast<long>(b) * P + qi) * H + h) * hd + c] = __float2bfloat16(o);
  }
}

}  // namespace

extern "C" int prefill_attention_bf16(const void* q, const void* k, const void* v,
                                      const void* offset, void* out, int B, int P,
                                      int H, int Hkv, int S_max, int hd, int window,
                                      float scale, void* stream) {
  if (B == 0 || P == 0) return 0;
  if (hd % 16 != 0 || hd > HD_MAX || H % Hkv != 0 || R % (H / Hkv) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_layout(hd).total;
  cudaError_t err = allow_smem(prefill_attention_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qt = R / (H / Hkv);
  dim3 grid((P + qt - 1) / qt, Hkv, B);
  prefill_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(offset), static_cast<bf16*>(out), P, H, Hkv, S_max, hd,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}
