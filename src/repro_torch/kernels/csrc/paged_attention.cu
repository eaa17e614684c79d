// GQA decode attention over the paged KV pool, and its speculative
// verify-window variant, by hand for Hopper (sm_90a).  One kernel and one
// C entry point; paged decode attention is the verify window W = 1.
//
// Replaces: src/repro/kernels/decode_attention.py,
// paged_decode_attention_pallas (body _paged_decode_kernel) and
// paged_verify_attention_pallas (body _paged_verify_kernel).  Same contract:
// q (B, W, H, hd) — the W newest tokens of each sequence, oldest first;
// k/v pages (n_pages, page_size, Hkv, hd), the global pool; block_tables
// (B, max_pages) int32 physical page ids in logical order; lengths (B,)
// valid tokens including the window's K/V.  Window query w sees keys
// < length - W + 1 + w (with a window, also >= that minus ``window``).
// Query head h reads kv head h % Hkv (g-major grouping).  Block-table
// entries past a sequence's pages are never read (only positions <
// min(length, max_pages * page_size) are), and a row that sees no key —
// length 0 — outputs 0 (the Pallas kernel clamps its denominator at 1e-30).
//
// Bound on an H100 SXM (3.35 TB/s): each sequence's valid K and V rows
// must be read once, 2 * Hkv * hd * 2 B = 2 KB per cached token at
// qwen3-30b-a3b (Hkv 4, hd 128); with g = 8 query heads per kv head the
// work is 2 W flops per byte read — far below the ~295 the tensor cores
// need — so bytes bound both kernels at any W a speculative decoder uses.
//
// Design.  As the contiguous decode kernel (decode_attention.cu): one CTA
// per (kv head, sequence) streams that head's keys once, in KT-key tiles
// through shared memory, for all R = W * g query rows that read it (rows
// packed w-major, row r <-> window token r / g, head-in-group r % g, as
// the Pallas wrapper packs them).  The CTA reads its own block table: key
// position t lives in page block_tables[b][t / page_size] at offset
// t % page_size, loaded 8 elements (16 bytes) at a time; a tile of 32 keys
// spans two 16-token pages at the engine's default page size.  Scores, the
// online softmax (one warp per row, one lane per key) and the PV sum run on
// the CUDA cores in fp32.  The running max, denominator and the R x hd
// output sums live in shared memory rather than registers, so R is bounded
// only by shared memory (R = 40 at W = 5, g = 8, hd = 128 takes 79 KB) —
// the contiguous kernel's per-thread accumulators stop at g * hd = 4096.
// At 8 sequences and 4 kv heads that is 32 CTAs on 132 SMs: a split over
// the key axis is the later fix, as for decode_attention.cu.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KT = 32;            // keys per tile: one lane per key in the softmax
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t smem_bytes(int rows, int hd) {
  // q and the output sums (rows x hd), K tile (KT x hd+1, padded against
  // bank conflicts), V tile (KT x hd), probabilities (rows x KT), running
  // max, denominator and rescale factor (rows each)
  return sizeof(float) * (2 * static_cast<size_t>(rows) * hd + KT * (hd + 1) +
                          KT * hd + rows * KT + 3 * rows);
}

__device__ __forceinline__ bool visible(int pos, int row_len, int window) {
  return pos < row_len && (window <= 0 || pos >= row_len - window);
}

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                       const bf16* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, bf16* __restrict__ out,
                       int W, int H, int Hkv, int page_size, int max_pages, int hd,
                       int window, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hkv;
  const int R = W * g;
  extern __shared__ float sm[];
  float* qs = sm;                  // R x hd (pre-scaled)
  float* acc = qs + R * hd;        // R x hd output sums
  float* ks = acc + R * hd;        // KT x (hd + 1)
  float* vs = ks + KT * (hd + 1);  // KT x hd
  float* ps = vs + KT * hd;        // R x KT
  float* ms = ps + R * KT;         // R running max
  float* ls = ms + R;              // R running denominator
  float* as = ls + R;              // R rescale factor of the current tile

  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    const int w = r / g, gi = r - w * g;
    qs[i] = __bfloat162float(q[((static_cast<long>(b) * W + w) * H + gi * Hkv + kh) * hd + c]) *
            scale;
    acc[i] = 0.0f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.0f;
  }
  const int length = lengths[b];
  const int n_keys = min(length, max_pages * page_size);   // keys the table holds
  // the oldest window row has the lowest horizon, so it bounds a sliding
  // window from below
  const int lo = window > 0 ? max(0, length - W + 1 - window) : 0;
  const int* bt = block_tables + static_cast<long>(b) * max_pages;
  const long kv_tok = static_cast<long>(Hkv) * hd;   // elements between two tokens
  const int chunks = hd / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t0 = lo; t0 < n_keys; t0 += KT) {
    const int n = min(KT, n_keys - t0);
    __syncthreads();   // q loaded / the previous tile consumed
    for (int i = threadIdx.x; i < KT * chunks; i += kThreads) {
      const int j = i / chunks, c = (i - j * chunks) * 8;
      union { uint4 u; unsigned short h[8]; } kv, vv;
      kv.u = make_uint4(0u, 0u, 0u, 0u);
      vv.u = kv.u;
      if (j < n) {
        const int pos = t0 + j;
        const long off = (static_cast<long>(bt[pos / page_size]) * page_size + pos % page_size) *
                             kv_tok + static_cast<long>(kh) * hd + c;
        kv.u = *reinterpret_cast<const uint4*>(k_pages + off);
        vv.u = *reinterpret_cast<const uint4*>(v_pages + off);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ks[j * (hd + 1) + c + e] = __bfloat162float(__ushort_as_bfloat16(kv.h[e]));
        vs[j * hd + c + e] = __bfloat162float(__ushort_as_bfloat16(vv.h[e]));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * KT; i += kThreads) {
      const int r = i / KT, j = i - r * KT;
      const int row_len = length - W + 1 + r / g;
      float s = kNegInf;
      if (j < n && visible(t0 + j, row_len, window)) {
        s = 0.0f;
        for (int c = 0; c < hd; ++c) s += qs[r * hd + c] * ks[j * (hd + 1) + c];
      }
      ps[i] = s;
    }
    __syncthreads();
    // online softmax: warp w takes rows w, w + 8, ...; lane j key j
    for (int r = warp; r < R; r += kWarps) {
      const int row_len = length - W + 1 + r / g;
      const bool ok = lane < n && visible(t0 + lane, row_len, window);
      const float s = ok ? ps[r * KT + lane] : kNegInf;
      const float m_old = ms[r], l_old = ls[r];
      float tmax = s;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_old, tmax);
      const float p = ok ? expf(s - m_new) : 0.0f;
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = expf(m_old - m_new);
      ps[r * KT + lane] = p;
      __syncwarp();   // every lane has read ms[r] / ls[r]
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = alpha * l_old + psum;
        as[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      float sum = 0.0f;
      for (int j = 0; j < n; ++j) sum += ps[r * KT + j] * vs[j * hd + c];
      acc[i] = acc[i] * as[r] + sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    const int w = r / g, gi = r - w * g;
    const float l = ls[r];
    out[((static_cast<long>(b) * W + w) * H + gi * Hkv + kh) * hd + c] =
        __float2bfloat16(l > 0.0f ? acc[i] / l : 0.0f);
  }
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages, const void* block_tables,
                                    const void* lengths, void* out, int B, int W, int H,
                                    int Hkv, int page_size, int max_pages, int hd,
                                    int window, float scale, void* stream) {
  if (B == 0 || W == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || hd % 8 != 0 || page_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(W * (H / Hkv), hd);
  cudaError_t err = allow_smem(paged_attention_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hkv, B);
  paged_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), W, H, Hkv, page_size,
      max_pages, hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}
