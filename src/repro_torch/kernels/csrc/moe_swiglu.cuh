// The fused SwiGLU tile body shared by the two MoE kernels
// (moe_gmm_ragged.cu: expert-sorted rows; moe_gmm.cu: the dense (E, C, d)
// capacity buffer).  Each kernel picks its CTA's rows and expert; this file
// computes, for one CTA of kThreads threads,
//     out[r, d0:d0+DT] = (silu(x[r] @ Wg) * (x[r] @ Wu)) @ Wd[:, d0:d0+DT]
// for the rvalid rows r of its tile.
//
// The CTA loops over F in FT chunks: it computes G = X Wg[:, f] and
// U = X Wu[:, f] (looping over d in KT chunks), forms H = silu(G) * U in
// fp32 in registers, rounds H to bf16 for the tensor cores and accumulates
// O += H Wd[f, d-tile] in fp32 accumulators that live across the whole F
// loop; O is rounded to bf16 once at the end.  Products use the tensor
// cores through WMMA (mma.sync, 16x16x16 bf16 -> fp32); no wgmma or TMA
// yet.  Rows are padded to a multiple of WMMA's 16 with zeros; columns of
// d and F past the matrix edge are zero-filled by load_tile_bf16, so any
// d and F work.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace moe_swiglu {

using namespace nvcuda;

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int DT = 128;         // d-output columns per CTA
constexpr int FT = 64;          // F chunk
constexpr int KT = 64;          // d (reduction) chunk for gate/up
constexpr int MP_MAX = 128;     // largest row tile
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

// rows a tile of ``rows`` real rows computes in: a multiple of 16, >= 16
__host__ __device__ inline int padded_rows(int rows) { return rows < 16 ? 16 : (rows + 15) / 16 * 16; }

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

// One CTA's tile: rows [0, rvalid) of ``x`` (rows d apart; rvalid <=
// MP_MAX), expert weights wg_e/wu_e (d, F) and wd_e (F, d), output columns
// [d0, d0 + DT) of ``out`` (rows d apart).  ``smem`` holds at least
// smem_layout(padded_rows(rvalid)).total bytes.
__device__ __forceinline__ void swiglu_tile(
    const bf16* __restrict__ x, int rvalid, const bf16* __restrict__ wg_e,
    const bf16* __restrict__ wu_e, const bf16* __restrict__ wd_e, int d, int F,
    int d0, bf16* __restrict__ out, unsigned char* smem) {
  const int mp = padded_rows(rvalid);
  const int ncols = min(DT, d - d0);
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
      load_tile_bf16(xs, LDX, x + k0, d, mp, KT, rvalid, d - k0);
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
  for (int i = threadIdx.x; i < rvalid * ncols; i += kThreads) {
    const int r = i / ncols, c = i - r * ncols;
    out[static_cast<long>(r) * d + d0 + c] = __float2bfloat16(os[r * LDO + c]);
  }
}

}  // namespace moe_swiglu
