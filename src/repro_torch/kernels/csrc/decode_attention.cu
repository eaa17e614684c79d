// Single-token GQA decode attention over the contiguous slot-row cache, by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _decode_kernel).  Same contract: q (B, H, hd), caches (B, S_max,
// Hkv, hd), lengths (B,) = valid entries including the new token's K/V;
// with a window the query sees keys >= length - window.  Query head h reads
// kv head h % Hkv (g-major grouping).  ``length`` is clamped to S_max: an
// idle slot of the engine's full-pool decode step may carry a stale offset
// equal to max_len.
//
// Bound on an H100 SXM (3.35 TB/s): the valid K and V rows must be read
// once, 2 * Hkv * hd * 2 B = 2 KB per cached token at qwen3-30b-a3b (Hkv 4,
// hd 128): 8 slots at 2048 tokens move 33.6 MB, about 10 us.  With g = 8
// query heads per kv head the work is 2 flops per byte read — far below
// the ~295 the tensor cores need — so bytes bound it.
//
// Design.  One CTA per (kv head, slot) streams that head's rows once, in
// KT-key tiles through shared memory, for all g query heads that read it;
// scores, the online softmax and the PV sum run on the CUDA cores in fp32
// (the work per byte is too small for tensor cores to matter).  At 8 slots
// and 4 kv heads that is only 32 CTAs on 132 SMs: splitting the key axis
// across CTAs (split-K, with a second pass to merge the softmax partials)
// is the later fix.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KT = 32;            // keys per tile
constexpr int ACC_MAX = 16;       // accumulators per thread: g * hd <= 4096
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t smem_bytes(int g, int hd) {
  // q (g x hd), K tile (KT x hd+1, padded against bank conflicts),
  // V tile (KT x hd), probabilities (g x KT), alpha (g)
  return sizeof(float) * (static_cast<size_t>(g) * hd + KT * (hd + 1) + KT * hd +
                          g * KT + g);
}

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ lengths,
                        bf16* __restrict__ out, int H, int Hkv, int S_max, int hd,
                        int window, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hkv;
  extern __shared__ float sm[];
  float* qs = sm;                          // g x hd (pre-scaled)
  float* ks = qs + g * hd;                 // KT x (hd + 1)
  float* vs = ks + KT * (hd + 1);          // KT x hd
  float* ps = vs + KT * hd;                // g x KT
  float* as = ps + g * KT;                 // g

  for (int i = threadIdx.x; i < g * hd; i += kThreads) {
    const int gi = i / hd, c = i - gi * hd;
    qs[i] = __bfloat162float(q[(static_cast<long>(b) * H + gi * Hkv + kh) * hd + c]) * scale;
  }
  const int length = min(lengths[b], S_max);
  const int lo = window > 0 ? max(0, length - window) : 0;

  float acc[ACC_MAX];
#pragma unroll
  for (int i = 0; i < ACC_MAX; ++i) acc[i] = 0.0f;
  // warp w keeps the running max / denominator of heads w, w + 8, ...
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

  const long kv_row = static_cast<long>(Hkv) * hd;
  const bf16* kb = k + (static_cast<long>(b) * S_max * Hkv + kh) * hd;
  const bf16* vb = v + (static_cast<long>(b) * S_max * Hkv + kh) * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t0 = lo; t0 < length; t0 += KT) {
    const int n = min(KT, length - t0);
    __syncthreads();   // q loaded / previous tile consumed
    for (int i = threadIdx.x; i < KT * hd; i += kThreads) {
      const int j = i / hd, c = i - j * hd;
      float kv = 0.0f, vv = 0.0f;
      if (j < n) {
        kv = __bfloat162float(kb[(t0 + j) * kv_row + c]);
        vv = __bfloat162float(vb[(t0 + j) * kv_row + c]);
      }
      ks[j * (hd + 1) + c] = kv;
      vs[j * hd + c] = vv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < g * KT; i += kThreads) {
      const int gi = i / KT, j = i - gi * KT;
      float s = kNegInf;
      if (j < n) {
        s = 0.0f;
        for (int c = 0; c < hd; ++c) s += qs[gi * hd + c] * ks[j * (hd + 1) + c];
      }
      ps[i] = s;
    }
    __syncthreads();
    // online softmax: lane j of warp w handles key j of heads w, w + 8
    for (int u = 0; u * kWarps + warp < g && u < 2; ++u) {
      const int gi = u * kWarps + warp;
      const bool ok = lane < n;
      const float s = ok ? ps[gi * KT + lane] : kNegInf;
      float tmax = s;
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_run[u], tmax);
      const float p = ok ? expf(s - m_new) : 0.0f;
      float psum = p;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = expf(m_run[u] - m_new);
      l_run[u] = alpha * l_run[u] + psum;
      m_run[u] = m_new;
      ps[gi * KT + lane] = p;
      if (lane == 0) as[gi] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC_MAX; ++a) {
      const int i = threadIdx.x + a * kThreads;
      if (i < g * hd) {
        const int gi = i / hd, c = i - gi * hd;
        float sum = 0.0f;
        for (int j = 0; j < KT; ++j) sum += ps[gi * KT + j] * vs[j * hd + c];
        acc[a] = acc[a] * as[gi] + sum;
      }
    }
  }
  // publish the denominators, then normalise
  __syncthreads();
  for (int u = 0; u * kWarps + warp < g && u < 2; ++u)
    if (lane == 0) as[u * kWarps + warp] = l_run[u];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < ACC_MAX; ++a) {
    const int i = threadIdx.x + a * kThreads;
    if (i < g * hd) {
      const int gi = i / hd, c = i - gi * hd;
      const float l = as[gi];
      const float o = l > 0.0f ? acc[a] / l : 0.0f;
      out[(static_cast<long>(b) * H + gi * Hkv + kh) * hd + c] = __float2bfloat16(o);
    }
  }
}

}  // namespace

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, int B, int H,
                                     int Hkv, int S_max, int hd, int window, float scale,
                                     void* stream) {
  if (B == 0) return 0;
  const int g = H / Hkv;
  // KT == 32 keys per tile: one lane per key in the softmax; <= 16 heads
  // per kv head (two per warp); <= 16 accumulators per thread
  if (H % Hkv != 0 || g > 2 * kWarps || g * hd > ACC_MAX * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(g, hd);
  cudaError_t err = allow_smem(decode_attention_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hkv, B);
  decode_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), H, Hkv, S_max, hd, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}
