// Ragged grouped fused SwiGLU for dropless MoE, by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/moe_gmm_ragged.py, moe_gmm_ragged_pallas
// (body _gmm_ragged_kernel).  Same contract: ``rows`` (n_rows, d) holds the
// token assignments sorted by expert in groups padded to ``m_blk``-row
// tiles; tile t belongs to expert ``tile_expert[t]`` (E = alignment padding,
// which outputs zeros); every tile computes
//     out = (silu(x @ Wg[e]) * (x @ Wu[e])) @ Wd[e].
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): the weights of
// every active expert must be read once, 3 * d * F * 2 B = 9.44 MB per
// expert at qwen3-30b-a3b (d 2048, F 768).  A decode step at 8 slots has at
// most 64 active experts: <= 604 MB, about 0.18 ms, bytes-bound (8 rows per
// tile do ~16 flops per weight byte).  A 2048-token prefill touches all 128
// experts (1.2 GB, 0.36 ms) for 16384 assignments (155 GFLOP, 0.16 ms), so
// it is still bytes-bound at that size.
//
// Design.  One CTA per (row tile, d-output tile of DT columns); blockIdx.x
// runs over the d-tiles so that the CTAs of one expert tile run together
// and share its weights through the 50 MB L2.  A CTA loops over F in FT
// chunks: it computes G = X Wg[:, f] and U = X Wu[:, f] (looping over d in
// KT chunks), forms H = silu(G) * U in fp32 in registers, rounds H to bf16
// for the tensor cores and accumulates O += H Wd[f, d-tile] in fp32
// accumulators that live across the whole F loop; O is rounded to bf16
// once at the end.  (The Pallas kernel rounds its running sum to the output
// dtype after every F step; this kernel does not, so in bf16 the two differ
// by design — chip_smoke.py holds it to a relative Frobenius error <= 1e-2
// against the fp32 plain version.)  The gate/up products are recomputed for
// each d-tile: d/DT = 16 times at qwen widths — the price of keeping H out
// of device memory in this first, simple kernel.  Products use the
// tensor cores through WMMA (mma.sync, 16x16x16 bf16 -> fp32); no wgmma or
// TMA yet.  Decode tiles (m_blk 8) are below wgmma's M = 64: they are
// padded to one 16-row WMMA tile here, and a decode-specialised kernel
// (or split over F) is the later fix.  A sentinel tile writes zeros and
// returns before touching any weight.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int DT = 128;         // d-output columns per CTA
constexpr int FT = 64;          // F chunk
constexpr int KT = 64;          // d (reduction) chunk for gate/up
constexpr int MP_MAX = 128;     // largest row tile (ragged_tile_rows caps m_blk)
constexpr int LDX = KT + 8;     // smem leading dims (bf16: multiple of 8;
constexpr int LDW = FT + 8;     //  keeps 16-row blocks 32-byte aligned)
constexpr int LDH = FT + 8;
constexpr int LDD = DT + 8;
constexpr int LDHF = FT + 4;    // fp32 leading dims (multiple of 4)
constexpr int LDO = DT + 4;
constexpr int MAX_PAIRS = (MP_MAX / 16) * (FT / 16) / kWarps;   // 4
constexpr int MAX_OFRAG = (MP_MAX / 16) * (DT / 16) / kWarps;   // 8

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Smem {
  // byte offsets of each region inside the dynamic shared buffer
  size_t xs, wg, wu, hf, hs, wd, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Smem smem_layout(int mp) {
  Smem s;
  size_t o = 0;
  s.xs = o; o = align128(o + sizeof(bf16) * mp * LDX);
  s.wg = o; o = align128(o + sizeof(bf16) * KT * LDW);
  s.wu = o; o = align128(o + sizeof(bf16) * KT * LDW);
  s.hf = o; o = align128(o + sizeof(float) * mp * LDHF);
  s.hs = o; o = align128(o + sizeof(bf16) * mp * LDH);
  s.wd = o; o = align128(o + sizeof(bf16) * FT * LDD);
  // the fp32 output staging tile reuses the buffer after the F loop
  size_t out = align128(sizeof(float) * mp * LDO);
  s.total = o > out ? o : out;
  return s;
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
moe_gmm_ragged_kernel(const bf16* __restrict__ rows, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                      const int* __restrict__ tile_expert, bf16* __restrict__ out,
                      int d, int F, int E, int m_blk) {
  const int d0 = blockIdx.x * DT;
  const int tile = blockIdx.y;
  const long row0 = static_cast<long>(tile) * m_blk;
  const int e = tile_expert[tile];
  const int ncols = min(DT, d - d0);

  if (e >= E) {   // alignment-padding tile: zeros, no weight traffic
    for (int i = threadIdx.x; i < m_blk * ncols; i += kThreads) {
      const int r = i / ncols, c = i - r * ncols;
      out[(row0 + r) * d + d0 + c] = __float2bfloat16(0.0f);
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const int mp = m_blk < 16 ? 16 : m_blk;   // rows padded to WMMA's 16
  const Smem L = smem_layout(mp);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* wgs = reinterpret_cast<bf16*>(smem + L.wg);
  bf16* wus = reinterpret_cast<bf16*>(smem + L.wu);
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* wds = reinterpret_cast<bf16*>(smem + L.wd);

  const int warp = threadIdx.x / 32;
  const int rb_n = mp / 16;
  const int n_pairs = rb_n * (FT / 16);     // (G, U) fragment pairs per F chunk
  const int n_ofrag = rb_n * (DT / 16);     // output fragments

  const bf16* wg_e = wg + static_cast<long>(e) * d * F;
  const bf16* wu_e = wu + static_cast<long>(e) * d * F;
  const bf16* wd_e = wd + static_cast<long>(e) * F * d;

  FragC o_acc[MAX_OFRAG];
#pragma unroll
  for (int i = 0; i < MAX_OFRAG; ++i) wmma::fill_fragment(o_acc[i], 0.0f);

  for (int f0 = 0; f0 < F; f0 += FT) {
    FragC g_acc[MAX_PAIRS], u_acc[MAX_PAIRS];
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      wmma::fill_fragment(g_acc[i], 0.0f);
      wmma::fill_fragment(u_acc[i], 0.0f);
    }
    for (int k0 = 0; k0 < d; k0 += KT) {
      __syncthreads();   // the previous chunk's tiles are consumed
      load_tile_bf16(xs, LDX, rows + row0 * d + k0, d, mp, KT, m_blk, d - k0);
      load_tile_bf16(wgs, LDW, wg_e + static_cast<long>(k0) * F + f0, F, KT, FT,
                     d - k0, F - f0);
      load_tile_bf16(wus, LDW, wu_e + static_cast<long>(k0) * F + f0, F, KT, FT,
                     d - k0, F - f0);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MAX_PAIRS; ++i) {
        const int p = warp + i * kWarps;
        if (p < n_pairs) {
          const int rb = p / (FT / 16), cb = p % (FT / 16);
#pragma unroll
          for (int kk = 0; kk < KT; kk += 16) {
            FragA a;
            FragB b;
            wmma::load_matrix_sync(a, xs + rb * 16 * LDX + kk, LDX);
            wmma::load_matrix_sync(b, wgs + kk * LDW + cb * 16, LDW);
            wmma::mma_sync(g_acc[i], a, b, g_acc[i]);
            wmma::load_matrix_sync(b, wus + kk * LDW + cb * 16, LDW);
            wmma::mma_sync(u_acc[i], a, b, u_acc[i]);
          }
        }
      }
    }
    // H = silu(G) * U, elementwise in fp32: fragments of one type share
    // their element layout, so G and U of the same tile line up.
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = warp + i * kWarps;
      if (p < n_pairs) {
        const int rb = p / (FT / 16), cb = p % (FT / 16);
#pragma unroll
        for (int t = 0; t < g_acc[i].num_elements; ++t)
          g_acc[i].x[t] = silu(g_acc[i].x[t]) * u_acc[i].x[t];
        wmma::store_matrix_sync(hf + rb * 16 * LDHF + cb * 16, g_acc[i], LDHF,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < mp * FT; i += kThreads) {
      const int r = i / FT, c = i - r * FT;
      hs[r * LDH + c] = __float2bfloat16(hf[r * LDHF + c]);
    }
    load_tile_bf16(wds, LDD, wd_e + static_cast<long>(f0) * d + d0, d, FT, DT,
                   F - f0, d - d0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_OFRAG; ++i) {
      const int q = warp + i * kWarps;
      if (q < n_ofrag) {
        const int rb = q / (DT / 16), cb = q % (DT / 16);
#pragma unroll
        for (int kk = 0; kk < FT; kk += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, hs + rb * 16 * LDH + kk, LDH);
          wmma::load_matrix_sync(b, wds + kk * LDD + cb * 16, LDD);
          wmma::mma_sync(o_acc[i], a, b, o_acc[i]);
        }
      }
    }
  }

  // stage O through shared memory, round once to bf16, write real rows
  __syncthreads();
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MAX_OFRAG; ++i) {
    const int q = warp + i * kWarps;
    if (q < n_ofrag) {
      const int rb = q / (DT / 16), cb = q % (DT / 16);
      wmma::store_matrix_sync(os + rb * 16 * LDO + cb * 16, o_acc[i], LDO,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m_blk * ncols; i += kThreads) {
    const int r = i / ncols, c = i - r * ncols;
    out[(row0 + r) * d + d0 + c] = __float2bfloat16(os[r * LDO + c]);
  }
}

}  // namespace

extern "C" int moe_gmm_ragged_bf16(const void* rows, const void* w_gate,
                                   const void* w_up, const void* w_down,
                                   const void* tile_expert, void* out,
                                   int n_rows, int d, int F, int E, int m_blk,
                                   void* stream) {
  if (n_rows == 0) return 0;
  const int mp = m_blk < 16 ? 16 : m_blk;
  const size_t smem = smem_layout(mp).total;
  cudaError_t err = allow_smem(moe_gmm_ragged_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((d + DT - 1) / DT, n_rows / m_blk);
  moe_gmm_ragged_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rows), static_cast<const bf16*>(w_gate),
      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down),
      static_cast<const int*>(tile_expert), static_cast<bf16*>(out), d, F, E, m_blk);
  return static_cast<int>(cudaGetLastError());
}
