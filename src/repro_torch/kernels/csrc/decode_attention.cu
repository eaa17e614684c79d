// Single-token GQA decode attention over the contiguous slot-row cache, by
// hand for Hopper (sm_90a): split-K over the key axis.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _decode_kernel).  Same contract: q (B, H, dk), caches k (B, S_max,
// Hkv, dk) and v (B, S_max, Hkv, dv), out (B, H, dv), lengths (B,) = valid
// entries including the new token's K/V; the query/key width dk equals the
// value width dv for GQA (any multiple of 16 up to 128, or 256 at
// recurrentgemma-9b's local attention) and is 192 against 128 for
// multi-head latent attention (its decompressed keys and values, H = Hkv,
// models/attention.py apply_mla);
// with a window the query sees keys >= length - window.  On request (``lse``
// not null) each (slot, head)'s natural-log log-sum-exp of its scaled scores
// goes to lse (B, H) fp32, -inf where the query sees no key: the partial
// softmax statistic a rank's slice of a sequence-sharded cache gives its
// merge (models/attention.py); serve calls pass null and keep their bits.
// Query head h reads
// kv head h % Hkv (g-major grouping).  ``length`` is clamped to S_max: an
// idle slot of the engine's full-pool decode step may carry a stale offset
// equal to max_len, and a rank's slice of a sequence-split cache passes
// the query's position relative to the slice, past S_max where the query
// lies beyond it.  The window counts back from that unclamped length, so
// the query sees keys [max(0, length - window), min(length, S_max)): a
// slice wholly before the window sees none, one cut by it sees its keys
// from the window's edge on.  A query that sees no key outputs 0 (and
// -inf as its log-sum-exp).
//
// Bound on an H100 SXM (3.35 TB/s): the valid K and V rows must be read
// once, 2 * Hkv * hd * 2 B = 2 KB per cached token at qwen3-30b-a3b (Hkv 4,
// hd 128): 8 slots at 2048 tokens move 33.6 MB, about 10 us.  With g = 8
// query heads per kv head the work is 2 flops per byte read, far below the
// ~295 the tensor cores need, so bytes bound it.  Multi-head latent
// attention at deepseek-v2-236b reads (192 + 128) * 128 * 2 B = 80 KB of
// decompressed K/V per token (g 1: half a flop per byte), 1.34 GB at 8 x
// 2048 tokens, about 400 us.  recurrentgemma-9b (one kv head of 256, g 16,
// window 2048) reads at most 2048 * 2 * 256 * 2 B = 2 MB a slot: 8 slots
// move 16.8 MB, about 5 us; 8 flops per byte, still bytes-bound.
//
// Design.
//  * Grid (split, Hkv, B).  The host picks ``split`` from the shapes it
//    knows (ops.decode_split: two waves on 132 SMs, 9 at 8 slots x 4 kv
//    heads).  Lengths stay on the card: each CTA reads lengths[b] itself
//    and takes its share of that row's own [lo, length), in 16-key units;
//    a CTA whose share is empty writes an empty partial.
//  * K/V stream through a two-stage ring of 64-key tiles in shared memory
//    with 16-byte cp.async (zero-filled past the share), so the next
//    tile's copy is in flight while the current one is computed.
//  * Each of the 4 warps owns 16 keys of a tile and keeps its own online
//    softmax (m, l, O) for the g heads: S^T = K Q^T is one mma.sync
//    m16n8k16 per 16 of dk (the g <= 8 query heads fill n = 8; g <= 16
//    takes two; at g 1 seven of the eight columns are idle), P^T goes to
//    bf16 and through movmatrix into the B fragment of O^T += V^T P^T
//    (V^T by ldmatrix.trans), one m-tile per 16 of dv.  The
//    query fragments are sized by the widest dk built (128, or 192), the
//    accumulator by dv (128).  The (256, 256) build keeps Q in shared
//    memory instead (g x (dk + 8) bf16, 8.4 KB after the ring, read as B
//    fragments per k-step without bank conflicts): at g 16 its fragments
//    would take 64 registers a thread beside the 128 of O^T.  Its ring is
//    2 x 64 x (264 + 264) x 2 B = 135 KB.  exp2f with log2(e) folded
//    into the scale.  No barrier between warps inside the tile loop.
//  * At the end the 4 warps' partials merge through shared memory; with
//    split > 1 the CTA writes (O, m, l) for its split to fp32 scratch and a
//    second launch merges the splits in a fixed order: no float atomics,
//    the same result from run to run.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;            // 4 warps, 16 keys each per tile
constexpr int kWarps = kThreads / 32;
constexpr int KT = 16 * kWarps;          // keys per tile
constexpr int STAGES = 2;
constexpr int G_MAX = 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// natural-log log-sum-exp from the base-2 running max m and sum l
__device__ inline float lse_of(float m, float l) {
  return l > 0.0f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

// the ring (later the merge area), then, with Q in shared memory, Q
__host__ __device__ inline size_t ring_bytes(int dk, int dv) {
  const size_t ring = sizeof(bf16) * STAGES * KT * ((dk + 8) + (dv + 8));
  const size_t merge = sizeof(float) * kWarps * G_MAX * (dv + 2);
  return ring > merge ? ring : merge;
}
__host__ __device__ inline size_t smem_bytes(int dk, int dv, bool q_smem) {
  return ring_bytes(dk, dv) + (q_smem ? sizeof(bf16) * G_MAX * (dk + 8) : 0);
}

// NT: n-tiles of 8 query heads (g <= 8 * NT); DK_MAX, DV_MAX: the widest
// dk and dv this build takes (dv <= dk <= DK_MAX, dv <= DV_MAX); from dk
// 256 on, Q's B fragments are read from shared memory
template <int NT, int DK_MAX, int DV_MAX>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ lengths,
                    bf16* __restrict__ out, float* __restrict__ part,
                    float* __restrict__ lse, int H, int Hkv, int S_max, int dk, int dv,
                    int window, float scale_log2, int split) {
  constexpr bool QS = DK_MAX >= 256;
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int dk16 = dk / 16, dv16 = dv / 16;
  // padded rows: ldmatrix reads 8 rows without bank conflicts
  const int ldk = dk + 8, ldv = dv + 8;

  // this CTA's share of the row's visible keys [lo, length); the window
  // counts back from the query's own position, lengths[b] - 1, before the
  // clamp (an idle slot's stale length is S_max + 1)
  const int length = min(lengths[b], S_max);
  const int lo = window > 0 ? max(0, lengths[b] - window) : 0;
  const int n = max(length - lo, 0);
  const int chunk = ((n + split - 1) / split + 15) & ~15;
  const int start = lo + s * chunk;
  const int end = min(start + chunk, length);
  const int n_tiles = end > start ? (end - start + KT - 1) / KT : 0;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [STAGES][KT][ldk]
  bf16* vs = ks + STAGES * KT * ldk;           // [STAGES][KT][ldv]
  const long k_row = static_cast<long>(Hkv) * dk, v_row = static_cast<long>(Hkv) * dv;
  const bf16* kb = k + (static_cast<long>(b) * S_max * Hkv + kh) * dk;
  const bf16* vb = v + (static_cast<long>(b) * S_max * Hkv + kh) * dv;
  const int chunks = dk / 8;   // of K; V's dv / 8 are the first of them

  auto load_tile = [&](int t, int st) {
    const int t0 = start + t * KT;
    for (int i = threadIdx.x; i < KT * chunks; i += kThreads) {
      const int j = i / chunks, c = (i - j * chunks) * 8;
      const bool ok = t0 + j < end;
      const long row = ok ? t0 + j : start;
      cp_async16(ks + (st * KT + j) * ldk + c, kb + row * k_row + c, ok);
      if (c < dv) cp_async16(vs + (st * KT + j) * ldv + c, vb + row * v_row + c, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();
  }

  // B fragments of Q^T: lane holds heads nt * 8 + gid, hd pairs tig * 2 (+8)
  uint32_t qf[NT][QS ? 1 : DK_MAX / 16][2];
  const int ldq = dk + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem + ring_bytes(dk, dv));   // [NT * 8][ldq]
  if constexpr (QS) {
    // Q rows of the g heads (zeros past g), in 16-byte chunks; the tile
    // loop's first barrier publishes them
    const int qchunks = dk / 8;
    for (int i = threadIdx.x; i < NT * 8 * qchunks; i += kThreads) {
      const int head = i / qchunks, c = (i - head * qchunks) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (head < g)
        val = *reinterpret_cast<const uint4*>(
            q + (static_cast<long>(b) * H + head * Hkv + kh) * dk + c);
      *reinterpret_cast<uint4*>(qs + head * ldq + c) = val;
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int head = nt * 8 + gid;
      const bf16* qr = q + (static_cast<long>(b) * H + head * Hkv + kh) * dk + tig * 2;
#pragma unroll
      for (int kk = 0; kk < DK_MAX / 16; ++kk) {
        const bool ok = head < g && kk < dk16;
        qf[nt][kk][0] = ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16) : 0u;
        qf[nt][kk][1] = ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8) : 0u;
      }
    }
  }

  // per warp: O^T (dv x heads) fragments, running max and sum per head
  float o[NT][DV_MAX / 16][4];
  float m_run[NT][2], l_run[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < DV_MAX / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][mt][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_run[nt][j] = -INFINITY;
      l_run[nt][j] = 0.0f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t visible to all; tile t - 1's stage free
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    const int st = t % STAGES;
    const bf16* kt = ks + (st * KT + warp * 16) * ldk;
    const bf16* vt = vs + (st * KT + warp * 16) * ldv;
    const int key0 = start + t * KT + warp * 16;

    // S^T (16 keys x 8 heads) = K (16 x dk) Q^T (dk x 8)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DK_MAX / 16; ++kk) {
      if (kk < dk16) {
        uint32_t a[4];
        ldmatrix_x4(a, kt + ((lane % 8) + ((lane / 8) & 1) * 8) * ldk + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if constexpr (QS) {
            const bf16* qr = qs + (nt * 8 + gid) * ldq + kk * 16 + tig * 2;
            mma_m16n8k16(sc[nt], a, *reinterpret_cast<const uint32_t*>(qr),
                         *reinterpret_cast<const uint32_t*>(qr + 8));
          } else {
            mma_m16n8k16(sc[nt], a, qf[nt][kk][0], qf[nt][kk][1]);
          }
        }
      }
    }

    // online softmax per head column; lanes of one tig share a head
    const bool ok0 = key0 + gid < end, ok1 = key0 + gid + 8 < end;
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x0 = ok0 ? sc[nt][j] * scale_log2 : -INFINITY;
        const float x1 = ok1 ? sc[nt][2 + j] * scale_log2 : -INFINITY;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[nt][j], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(m_run[nt][j] - m_use);
        const float p0 = exp2f(x0 - m_use), p1 = exp2f(x1 - m_use);
        l_run[nt][j] = l_run[nt][j] * alpha + p0 + p1;
        m_run[nt][j] = m_new;
        sc[nt][j] = p0;
        sc[nt][2 + j] = p1;
#pragma unroll
        for (int mt = 0; mt < DV_MAX / 16; ++mt) {
          o[nt][mt][j] *= alpha;
          o[nt][mt][2 + j] *= alpha;
        }
      }
      // P^T (keys x heads) -> B fragment (k = key, n = head)
      pb[nt][0] = movmatrix_trans(pack_bf16(sc[nt][0], sc[nt][1]));
      pb[nt][1] = movmatrix_trans(pack_bf16(sc[nt][2], sc[nt][3]));
    }

    // O^T (dv x heads) += V^T (dv x 16 keys) P^T (16 keys x heads)
#pragma unroll
    for (int mt = 0; mt < DV_MAX / 16; ++mt) {
      if (mt < dv16) {
        const int mat = lane / 8;
        uint32_t a[4];
        ldmatrix_x4_trans(a, vt + ((mat >> 1) * 8 + lane % 8) * ldv + mt * 16 + (mat & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_m16n8k16(o[nt][mt], a, pb[nt][0], pb[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring becomes the merge area

  // merge the 4 warps' partials through shared memory
  float* wm = reinterpret_cast<float*>(smem);   // [kWarps][G_MAX]
  float* wl = wm + kWarps * G_MAX;
  float* wo = wl + kWarps * G_MAX;              // [kWarps][G_MAX][dv]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float l = l_run[nt][j];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      const int head = nt * 8 + tig * 2 + j;
      if (gid == 0) {
        wm[warp * G_MAX + head] = m_run[nt][j];
        wl[warp * G_MAX + head] = l;
      }
      float* row = wo + (warp * G_MAX + head) * dv;
#pragma unroll
      for (int mt = 0; mt < DV_MAX / 16; ++mt) {
        if (mt < dv16) {
          row[mt * 16 + gid] = o[nt][mt][j];
          row[mt * 16 + gid + 8] = o[nt][mt][2 + j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * dv; i += kThreads) {
    const int gi = i / dv, c = i - gi * dv;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G_MAX + gi]);
    const float m_use = mx == -INFINITY ? 0.0f : mx;
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * G_MAX + gi] - m_use);
      l += wl[w * G_MAX + gi] * f;
      acc += wo[(w * G_MAX + gi) * dv + c] * f;
    }
    const long bh = static_cast<long>(b) * H + gi * Hkv + kh;
    if (split == 1) {
      out[bh * dv + c] = __float2bfloat16(l > 0.0f ? acc / l : 0.0f);
      if (lse != nullptr && c == 0) lse[bh] = lse_of(m_use, l);
    } else {
      const long ps = bh * split + s;
      part[ps * dv + c] = acc;
      if (c == 0) {
        float* ml = part + static_cast<long>(gridDim.z) * H * split * dv;
        ml[ps * 2] = mx;
        ml[ps * 2 + 1] = l;
      }
    }
  }
}

// One CTA per (query head, slot), one thread per output column (hd = dv):
// merge the splits' (O, m, l) in split order.
__global__ void decode_merge_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                    float* __restrict__ lse, int B, int H, int hd, int split) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const long bh = static_cast<long>(b) * H + h;
  const float* po = part + bh * split * hd;
  const float* ml = part + static_cast<long>(B) * H * split * hd + bh * split * 2;
  float mx = -INFINITY;
  for (int s = 0; s < split; ++s) mx = fmaxf(mx, ml[s * 2]);
  const float m_use = mx == -INFINITY ? 0.0f : mx;
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < split; ++s) {
    const float f = exp2f(ml[s * 2] - m_use);
    l += ml[s * 2 + 1] * f;
    acc += po[s * hd + c] * f;
  }
  out[bh * hd + c] = __float2bfloat16(l > 0.0f ? acc / l : 0.0f);
  if (lse != nullptr && c == 0) lse[bh] = lse_of(m_use, l);
}

template <int NT, int DK_MAX, int DV_MAX>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const int* lengths, bf16* out,
                   float* part, float* lse, int B, int H, int Hkv, int S_max, int dk, int dv,
                   int window, float scale, int split, cudaStream_t stream) {
  const size_t smem = smem_bytes(dk, dv, DK_MAX >= 256);
  cudaError_t err = allow_smem(decode_split_kernel<NT, DK_MAX, DV_MAX>, smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<NT, DK_MAX, DV_MAX><<<dim3(split, Hkv, B), kThreads, smem, stream>>>(
      q, k, v, lengths, out, part, lse, H, Hkv, S_max, dk, dv, window, scale * kLog2e, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  decode_merge_kernel<<<dim3(H, B), dv, 0, stream>>>(part, out, lse, B, H, dv, split);
  return cudaGetLastError();
}

template <int DK_MAX, int DV_MAX>
cudaError_t launch_g(const bf16* q, const bf16* k, const bf16* v, const int* lengths,
                     bf16* out, float* part, float* lse, int B, int H, int Hkv, int S_max,
                     int dk, int dv, int window, float scale, int split,
                     cudaStream_t stream) {
  return H / Hkv <= 8 ? launch<1, DK_MAX, DV_MAX>(q, k, v, lengths, out, part, lse, B, H, Hkv,
                                                  S_max, dk, dv, window, scale, split, stream)
                      : launch<2, DK_MAX, DV_MAX>(q, k, v, lengths, out, part, lse, B, H, Hkv,
                                                  S_max, dk, dv, window, scale, split, stream);
}

}  // namespace

// (dk, dv): dk = dv a multiple of 16 up to 128, (192, 128) or (256, 256).
// ``scratch``: split > 1 needs B * H * split * (dv + 2) fp32 (unused, and
// may be null, at split 1).  ``lse``: null, or (B, H) fp32 for each query's
// log-sum-exp.  Two CUDA launches when split > 1.
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, void* out, void* scratch, int B,
                                     int H, int Hkv, int S_max, int dk, int dv, int window,
                                     float scale, int split, void* lse, void* stream) {
  if (B == 0) return 0;
  const int g = Hkv > 0 ? H / Hkv : 0;
  const bool equal = dk == dv && dk % 16 == 0 && dk > 0 && dk <= 128;
  const bool mla = dk == 192 && dv == 128;
  const bool wide = dk == 256 && dv == 256;
  if (Hkv <= 0 || H % Hkv != 0 || g > G_MAX || !(equal || mla || wide) || split < 1 ||
      split > 65535 || (split > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto qq = static_cast<const bf16*>(q);
  auto kk = static_cast<const bf16*>(k);
  auto vv = static_cast<const bf16*>(v);
  auto ln = static_cast<const int*>(lengths);
  auto oo = static_cast<bf16*>(out);
  auto part = static_cast<float*>(scratch);
  auto ls = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      equal  ? launch_g<128, 128>(qq, kk, vv, ln, oo, part, ls, B, H, Hkv, S_max, dk, dv, window,
                                  scale, split, st)
      : mla  ? launch_g<192, 128>(qq, kk, vv, ln, oo, part, ls, B, H, Hkv, S_max, dk, dv, window,
                                  scale, split, st)
             : launch_g<256, 256>(qq, kk, vv, ln, oo, part, ls, B, H, Hkv, S_max, dk, dv, window,
                                  scale, split, st);
  return static_cast<int>(err);
}
