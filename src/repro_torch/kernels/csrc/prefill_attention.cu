// GQA prefill attention (causal, or bidirectional) over the slot-row KV cache, by hand for
// Hopper (sm_90a): wgmma products on TMA-fed tiles, warp-specialised.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (body _flash_kernel), but to the serving path's contract rather than the
// Pallas kernel's: q (B, P, H, dk) holds P new tokens per row at positions
// offset[b] + i; k (B, S_max, Hkv, dk) and v (B, S_max, Hkv, dv) are the
// row's whole cache with the new keys already written; out is (B, P, H, dv).
// The query/key width dk and the value width dv are equal for GQA (32, 64,
// 128, or 256 at recurrentgemma-9b's local attention) and differ for
// multi-head latent attention (dk 192 = 128 nope + 64 rope, dv 128, H =
// Hkv: the decompressed keys and values of models/attention.py apply_mla).  Key j is visible to query i when
// j < offset + P, j < S_max, j <= offset + i and, with a window,
// j > offset + i - window (the masks of models/attention.py apply_gqa).
// With causal = 0 every key j < S_max is visible to every query, and offset
// and window are ignored: whisper's bidirectional encoder self-attention
// and cross-attention over the encoder frames (models/attention.py
// apply_cross_attn; JAX's flash_attention_pallas(causal=False)).
// Query head h reads kv head h % Hkv (g-major grouping).  A query row that
// sees no key outputs 0.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the causal
// products QK^T and PV, 2 * (dk + dv) flops per visible (query head, key)
// pair; a 2048-token prompt on an empty row at qwen3-30b-a3b (32 heads,
// hd 128) is 4 * 128 * 32 * 2048 * 2049 / 2 = 34 GFLOP, about 35 us per
// row — operations-bound.  Reading q, the visible K/V once and writing the
// output is 2 * 2048 * (32 + 2 * 4) * 128 * 2 B = 42 MB, about 12.5 us.
// At deepseek-v2-236b (128 heads, dk 192, dv 128) a row is 2 * 320 * 128 *
// 2048 * 2049 / 2 = 172 GFLOP, about 174 us, against 335 MB (100 us).
// At recurrentgemma-9b (16 heads, one kv head, hd 256, window 2048) a
// 2048-token row is 2 * 512 * 16 * 2048 * 2049 / 2 = 17 GFLOP, about
// 17.4 us, against 2 * 2048 * 17 * 256 * 2 B = 35.7 MB (10.7 us).
// Non-causal at whisper-base's encoder (8 heads, hd 64, 1500 frames) is
// 2 * 128 * 8 * 1500 * 1500 = 4.6 GFLOP, about 4.7 us, against 4 * 1500 *
// 8 * 64 * 2 B = 6.1 MB (1.8 us): operations-bound, and its grid is 12
// query tiles x 8 heads = 96 CTAs on 132 SMs.
//
// Design.  One CTA per (q tile, kv head, row b), 3 warpgroups:
//  * 128 query rows per CTA, as (position, head-of-group) pairs of one kv
//    head: qt = 128 / g positions (rounded down) x g heads (16 x 8 at
//    qwen3, 42 x 3 at phi4-mini, 18 x 7 at yi-34b, 8 x 16 at
//    recurrentgemma-9b), so each K/V tile is
//    read once for all g heads (at g 1, multi-head latent attention's
//    H = Hkv, 128 positions of one head).  Q (B, P, H, dk) is described
//    to TMA as (dk, Hkv, g, P, B): one box lands in exactly that row
//    order.  Where g does not divide 128, rows qt * g .. 127 are padding: zeroed once
//    before the Q load, masked from every key and never stored.
//  * Warpgroup 2 is the producer: after setmaxnreg gives its registers
//    away, one thread loads Q once and keeps a two-stage ring of K/V
//    tiles full with TMA (4-D maps over (width, Hkv, S_max, B): keys past
//    S_max arrive as zeros, never as the next row's keys), each stage
//    signalled on a "full" mbarrier and freed on an "empty" one.  Shared
//    memory: Q 128 x dk plus two stages of K (KT x dk) and V (KT x dv);
//    tiles of KT = 128 keys up to (192, 128), 48 + 2 x (48 + 32) KB = 208
//    KB of the 227 available.  At (256, 256) 128-key tiles would need 64
//    + 2 x (64 + 64) = 320 KB, so tiles there are 64 keys: 64 + 2 x (32 +
//    32) = 192 KB.
//  * Warpgroups 0 and 1 consume 64 rows each: S = Q K^T is a wgmma
//    m64nKTk16 with both operands in shared memory (128-byte swizzle, or
//    64-byte at width 32; a 128-wide bf16 row is two TMA boxes, a 192-wide
//    one three, each spanning one swizzle atom) and S stays in
//    registers; the online softmax runs there (row max and sum by quad
//    shuffles, exp2f with log2(e) in the scale); P goes to bf16 in
//    registers, in the accumulator's own layout, which is the layout of
//    wgmma's A-from-registers operand; O += P V is a wgmma with V as the
//    MN-major B operand from shared memory (one m64n64, or n32, per
//    64-column box).  O stays in fp32 registers until one final
//    normalisation and store.  At dv 256 that accumulator is 128 fp32
//    registers a thread; the consumers' setmaxnreg (232) leaves room for
//    it beside the 64-key S tile's 32.
//  * Only tiles that cross the diagonal, the window's edge or the end of
//    the keys evaluate the mask (non-causal: only the last tile, whose
//    keys past S_max arrive as zeros and must score -inf, not 0).  blockIdx.x walks q tiles from the last
//    (most keys) to the first, so the longest CTAs start first.
#include "hopper.cuh"

namespace {

constexpr int ROWS = 128;        // query rows per CTA (2 consumer warpgroups)
constexpr int STAGES = 2;
constexpr int kThreads = 384;    // consumers: warpgroups 0, 1; producer: 2
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <int HDK, int HDV>
struct Tile {
  static_assert(HDK == HDV || (HDK % 64 == 0 && HDV % 64 == 0), "box widths");
  static constexpr int EB = HDV < 64 ? HDV : 64;     // elements per box row
  static constexpr int SWZ = EB * 2;                 // row bytes = swizzle span
  static constexpr int NBOX_K = HDK / EB;            // boxes across dk (Q, K)
  static constexpr int NBOX_V = HDV / EB;            // boxes across dv (V, O)
  static constexpr int KT = HDK + HDV > 384 ? 64 : 128;  // keys per tile
  static constexpr int Q_BYTES = ROWS * HDK * 2;     // the Q tile's room
  static constexpr int K_BYTES = KT * HDK * 2;       // K, one stage
  static constexpr int V_BYTES = KT * HDV * 2;       // V, one stage
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 64;
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

template <int HDK, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const int* __restrict__ offset, bf16* __restrict__ out, int P, int H,
                         int Hkv, int S_max, int window, int causal, float scale_log2,
                         int n_qtiles) {
  using T = Tile<HDK, HDV>;
  constexpr int KT = T::KT;
  const int g = H / Hkv;
  const int qt = ROWS / g;                              // positions per CTA
  const int rows_q = qt * g;                            // rows TMA fills
  const int q0 = (n_qtiles - 1 - blockIdx.x) * qt;      // most expensive first
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int off = offset[b];
  const int q_last = min(q0 + qt, P) - 1;
  const int kv_end = causal ? min(off + q_last + 1, S_max) : S_max;
  const int kv_begin = causal && window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT : 0;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* qs = reinterpret_cast<bf16*>(base);                        // NBOX_K x [ROWS][EB]
  bf16* ks = reinterpret_cast<bf16*>(base + T::Q_BYTES);           // STAGES x NBOX_K x [KT][EB]
  bf16* vs = reinterpret_cast<bf16*>(base + T::Q_BYTES + STAGES * T::K_BYTES);  // NBOX_V
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + T::Q_BYTES +
                                               STAGES * (T::K_BYTES + T::V_BYTES));
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* qbar = bars + 2 * STAGES;

  if (rows_q < ROWS) {
    // padding rows of every Q box: zero once, then order these generic
    // stores before wgmma's (async-proxy) reads of the tile
    constexpr int kChunksPerRow = T::EB * 2 / 16;
    const int pad_chunks = (ROWS - rows_q) * kChunksPerRow;
    for (int i = threadIdx.x; i < T::NBOX_K * pad_chunks; i += kThreads) {
      const int bx = i / pad_chunks, c = i % pad_chunks;
      reinterpret_cast<uint4*>(qs + (bx * ROWS + rows_q) * T::EB)[c] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
    if (threadIdx.x == 256) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(qbar, rows_q * HDK * 2);           // what the boxes bring
      for (int bx = 0; bx < T::NBOX_K; ++bx)
        tma_load_5d(qs + bx * ROWS * T::EB, &qmap, qbar, bx * T::EB, kh, 0, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], T::K_BYTES + T::V_BYTES);
        const int key0 = kv_begin + t * KT;
        for (int bx = 0; bx < T::NBOX_V; ++bx) {
          tma_load_4d(ks + (st * T::NBOX_K + bx) * KT * T::EB, &kmap, &full[st], bx * T::EB,
                      kh, key0, b);
          tma_load_4d(vs + (st * T::NBOX_V + bx) * KT * T::EB, &vmap, &full[st], bx * T::EB,
                      kh, key0, b);
        }
        for (int bx = T::NBOX_V; bx < T::NBOX_K; ++bx)
          tma_load_4d(ks + (st * T::NBOX_K + bx) * KT * T::EB, &kmap, &full[st], bx * T::EB,
                      kh, key0, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;       // rows r0 and r0 + 8
    // query positions; a padding row's -1 sees no key of a masked tile
    const int qp[2] = {r0 < rows_q ? off + q0 + r0 / g : -1,
                       r0 + 8 < rows_q ? off + q0 + (r0 + 8) / g : -1};

    float o[T::NBOX_V][T::EB / 2];
#pragma unroll
    for (int bx = 0; bx < T::NBOX_V; ++bx)
#pragma unroll
      for (int i = 0; i < T::EB / 2; ++i) o[bx][i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      mbar_wait(&full[st], (t / STAGES) & 1);
      const bf16* kst = ks + st * T::NBOX_K * KT * T::EB;
      const bf16* vst = vs + st * T::NBOX_V * KT * T::EB;

      // S (64 x KT) = Q (64 x dk) K^T
      float sacc[KT / 2];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) sacc[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDK / 16; ++kk) {
        const int bx = kk / (T::EB / 16), within = (kk % (T::EB / 16)) * 16;
        const uint64_t da = wgmma_desc(qs + (bx * ROWS + wg * 64) * T::EB + within, T::SWZ);
        const uint64_t db = wgmma_desc(kst + bx * KT * T::EB + within, T::SWZ);
        if constexpr (KT == 128) wgmma_ss_m64n128(sacc, da, db, kk > 0);
        else wgmma_ss_m64n64(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // online softmax in registers: element i is row r0 + 8 * ((i >> 1) & 1),
      // key key0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1)
      const int key0 = kv_begin + t * KT;
      const bool masked = causal ? key0 + KT > kv_end || key0 + KT - 1 > off + q0 ||
                                       (window > 0 && key0 <= off + q0 + qt - 1 - window)
                                 : key0 + KT > kv_end;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        float s = sacc[i] * scale_log2;
        if (masked) {
          const int key = key0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
          const int p = qp[(i >> 1) & 1];
          const bool vis = key < kv_end &&
                           (!causal || (key <= p && (window <= 0 || key > p - window)));
          s = vis ? s : -INFINITY;
        }
        sacc[i] = s;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s);
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
        alpha[r] = exp2f(m_run[r] - m_use[r]);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int i = 0; i < KT / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = exp2f(sacc[i] - m_use[r]);
        const float p1 = exp2f(sacc[i + 1] - m_use[r]);
        l_run[r] += p0 + p1;
        // accumulator pairs (8kk..8kk+7) are the A fragment of k-step kk
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int bx = 0; bx < T::NBOX_V; ++bx)
#pragma unroll
        for (int i = 0; i < T::EB / 2; ++i) o[bx][i] *= alpha[(i >> 1) & 1];

      // O (64 x dv) += P (64 x KT) V (KT x dv)
#pragma unroll
      for (int bx = 0; bx < T::NBOX_V; ++bx) fence_regs(o[bx]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int bx = 0; bx < T::NBOX_V; ++bx) {
          const uint64_t db = wgmma_desc(vst + (bx * KT + kk * 16) * T::EB, T::SWZ);
          if constexpr (T::EB == 64) wgmma_rs_m64n64(o[bx], pa[kk], db);
          else wgmma_rs_m64n32(o[bx], pa[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int bx = 0; bx < T::NBOX_V; ++bx) fence_regs(o[bx]);
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // normalise once and store: rows r0, r0 + 8 -> (position, head)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.0f ? 1.0f / l : 0.0f;
      const int row = r0 + 8 * r;
      const int pos = q0 + row / g;
      if (row >= rows_q || pos >= P) continue;
      const int h = (row % g) * Hkv + kh;
      bf16* dst = out + ((static_cast<long>(b) * P + pos) * H + h) * HDV + (lane % 4) * 2;
#pragma unroll
      for (int bx = 0; bx < T::NBOX_V; ++bx)
#pragma unroll
        for (int c = 0; c < T::EB / 8; ++c)
          *reinterpret_cast<uint32_t*>(dst + bx * T::EB + c * 8) =
              pack_bf16(o[bx][c * 4 + 2 * r] * inv, o[bx][c * 4 + 2 * r + 1] * inv);
    }
  }
}

template <int HDK, int HDV>
int launch(const void* q, const void* k, const void* v, const int* offset, bf16* out, int B,
           int P, int H, int Hkv, int S_max, int window, int causal, float scale,
           cudaStream_t stream) {
  using T = Tile<HDK, HDV>;
  constexpr int KT = T::KT;
  const int g = H / Hkv;
  const cuuint64_t e = 2;   // bytes per element
  CUtensorMap qmap, kmap, vmap;
  {
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(HDK), static_cast<cuuint64_t>(Hkv),
                                static_cast<cuuint64_t>(g), static_cast<cuuint64_t>(P),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[4] = {HDK * e, Hkv * HDK * e, H * HDK * e,
                                   static_cast<cuuint64_t>(P) * H * HDK * e};
    const cuuint32_t box[5] = {T::EB, 1, static_cast<cuuint32_t>(g),
                               static_cast<cuuint32_t>(ROWS / g), 1};
    const int err = encode_bf16_map(&qmap, 5, q, dims, strides, box, T::SWZ);
    if (err) return err;
  }
  const cuuint32_t box[4] = {T::EB, 1, KT, 1};
  for (int kv = 0; kv < 2; ++kv) {   // K at width dk, V at width dv
    const cuuint64_t hd = kv == 0 ? HDK : HDV;
    const cuuint64_t dims[4] = {hd, static_cast<cuuint64_t>(Hkv),
                                static_cast<cuuint64_t>(S_max), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {hd * e, Hkv * hd * e,
                                   static_cast<cuuint64_t>(S_max) * Hkv * hd * e};
    const int err = encode_bf16_map(kv == 0 ? &kmap : &vmap, 4, kv == 0 ? k : v, dims,
                                    strides, box, T::SWZ);
    if (err) return err;
  }
  cudaError_t err = allow_smem(prefill_attention_kernel<HDK, HDV>, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qt = ROWS / g;
  const int n_qtiles = (P + qt - 1) / qt;
  prefill_attention_kernel<HDK, HDV><<<dim3(n_qtiles, Hkv, B), kThreads, T::SMEM, stream>>>(
      qmap, kmap, vmap, offset, out, P, H, Hkv, S_max, window, causal, scale * kLog2e,
      n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (dk, dv) in (32, 32), (64, 64), (128, 128), (192, 128), (256, 256); any g = H / Hkv
// up to 128; q, k, v 16-byte aligned; causal 1, or 0 for the bidirectional mask.
extern "C" int prefill_attention_bf16(const void* q, const void* k, const void* v,
                                      const void* offset, void* out, int B, int P,
                                      int H, int Hkv, int S_max, int dk, int dv,
                                      int window, int causal, float scale, void* stream) {
  if (B == 0 || P == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > ROWS || B > 65535 || Hkv > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto off = static_cast<const int*>(offset);
  auto o = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (dk == 32 && dv == 32)
    return launch<32, 32>(q, k, v, off, o, B, P, H, Hkv, S_max, window, causal, scale, st);
  if (dk == 64 && dv == 64)
    return launch<64, 64>(q, k, v, off, o, B, P, H, Hkv, S_max, window, causal, scale, st);
  if (dk == 128 && dv == 128)
    return launch<128, 128>(q, k, v, off, o, B, P, H, Hkv, S_max, window, causal, scale, st);
  if (dk == 192 && dv == 128)
    return launch<192, 128>(q, k, v, off, o, B, P, H, Hkv, S_max, window, causal, scale, st);
  if (dk == 256 && dv == 256)
    return launch<256, 256>(q, k, v, off, o, B, P, H, Hkv, S_max, window, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
