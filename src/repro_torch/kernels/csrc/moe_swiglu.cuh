// The fused SwiGLU shared by the two MoE kernels (moe_gmm_ragged.cu:
// expert-sorted rows; moe_gmm.cu: the dense (E, C, d) capacity buffer), as
// a two-phase grouped GEMM on wgmma fed by TMA:
//
//   phase A (gate_up_kernel): H[rows, f-tile] = silu(X Wg[e][:, f-tile])
//       * (X Wu[e][:, f-tile]), reduced over d; one CTA per (row tile,
//       FT-column F-tile); H is rounded once to bf16 into a scratch buffer
//       (n_rows, F) that the wrapper allocates.
//   phase B (down_kernel): out[rows, d-tile] = H[rows, :] Wd[e][:, d-tile],
//       reduced over F; one CTA per (row tile, DT-column d-tile); the sum
//       stays in fp32 and is rounded once to bf16.
//
// Each kernel picks its tiles through a Tiles policy (RaggedTiles,
// DenseTiles below): a tile is m rows of one expert, m a power of two in
// [8, 128].  The grid is 1-D with the column tiles of a row tile
// innermost (cta_tile).
//
// Inside a CTA: one producer warp keeps a ring of TMA loads (4 stages deep
// for tiles of up to 64 rows, 3 for 128) in flight on mbarriers.  A stage
// holds an activation box of m rows x KC columns, K-major, and two weight
// boxes of KC rows x NB columns, MN-major: the weights are (E, d, F) and
// (E, F, d) with N contiguous, and are read in that layout.  All boxes use
// the 128-byte swizzle.  One or two consumer warpgroups (MB = 1 for
// m <= 64, MB = 2 for m = 128) run wgmma m64n64k16 with A = 64 activation
// rows and B = one 64-column weight box: every operand spans one swizzle
// atom across its rows (hopper.cuh, wgmma_desc).  A tile shorter than 64
// rows is computed in the same m64 instruction: the TMA box holds only
// its m rows, the rest of the 64 shared-memory rows is stale and feeds
// accumulator rows that are never stored (an output row depends on its
// own A row alone).  So the
// arithmetic of a row — instruction, K order, rounding points — does not
// depend on the tile height or on the kernel, and K1 and K4 give the same
// bits for the same row.  The consumers retire a stage to the producer
// once the wgmmas of the next stage are in flight (wgmma.wait_group 1).
//
// Edges: TMA zero-fills whatever lies outside a tensor map (columns of d
// and F past the edge, rows past C in a dense group), so the products see
// zeros there; stores are masked to real rows and columns.  Row strides
// must be multiples of 16 bytes: d and F multiples of 8 (ops.moe_gmm pads
// other widths).  A padding tile of the ragged kernel (tile_expert == E)
// does nothing in phase A and writes zeros in phase B, reading no weight.
#pragma once

#include "hopper.cuh"

namespace moe_swiglu {

constexpr int KC = 64;         // reduction columns per stage (one 128-byte row)
constexpr int NB = 64;         // columns of one weight box (one swizzle atom)
constexpr int FT = NB;         // phase A: F columns per CTA (gate and up boxes)
constexpr int DT = 2 * NB;     // phase B: d columns per CTA (two Wd boxes)
constexpr int M_MAX = 128;     // largest row tile
constexpr int WBOX_BYTES = KC * NB * 2;

// The row tile and column tile of this CTA of a 1-D grid: column tiles
// run innermost, so the CTAs of one row tile run together and read its
// activation (X or H) rows from device memory once, and the few row tiles
// of one expert that run together share its weights through the L2.
// (Row tiles innermost would stream each weight tile once per wave but
// re-read every row tile once per column tile: 12 times for X, 16 for H,
// long after L2 has dropped them.)
__device__ __forceinline__ void cta_tile(int n_col, int& tile, int& col) {
  tile = blockIdx.x / n_col;
  col = blockIdx.x - tile * n_col;
}

// MB 64-row warpgroups per CTA; the ring is sized so that two CTAs fit
// on an SM (97 KB of shared memory each)
template <int MB>
struct Cfg {
  static constexpr int kThreads = 128 * MB + 32;    // consumers, then the producer warp
  static constexpr int STAGES = MB == 1 ? 4 : 3;
  static constexpr int A_BYTES = MB * 64 * KC * 2;  // activation rows of one stage
  static constexpr int STAGE_BYTES = A_BYTES + 2 * WBOX_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

// One row tile: expert e; TMA row coordinate ``row`` inside group ``grp``
// of the activation / H maps; ``rvalid`` real rows starting at flat row
// ``flat_row0`` of H and of the output.
struct Tile {
  int e, row, grp, rvalid;
  long flat_row0;
};

// K1: tile t is rows [t m, t m + m) of the expert-sorted buffer, owned by
// tile_expert[t]; E marks a padding tile.
struct RaggedTiles {
  const int* tile_expert;
  int m, E;
  __device__ bool locate(int t, Tile& tl) const {
    tl.e = tile_expert[t];
    tl.row = t * m;
    tl.grp = 0;
    tl.rvalid = m;
    tl.flat_row0 = static_cast<long>(t) * m;
    return tl.e < E;
  }
};

// K4: expert e owns C rows of the (E, C, d) buffer, cut into n_ct tiles
// of m rows; the last may be partial.
struct DenseTiles {
  int C, m, n_ct;
  __device__ bool locate(int t, Tile& tl) const {
    tl.e = t / n_ct;
    tl.row = (t - tl.e * n_ct) * m;
    tl.grp = tl.e;
    tl.rvalid = min(m, C - tl.row);
    tl.flat_row0 = static_cast<long>(tl.e) * C + tl.row;
    return true;
  }
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// the ring's barriers, after its stages: ``full`` (the producer's
// transaction count) and ``empty`` (one arrival per consumer warp)
template <int MB>
__device__ __forceinline__ void init_ring(unsigned char* base, uint64_t*& full, uint64_t*& empty) {
  full = reinterpret_cast<uint64_t*>(base + Cfg<MB>::STAGES * Cfg<MB>::STAGE_BYTES);
  empty = full + Cfg<MB>::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg<MB>::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * MB);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The consumers' main loop, shared by both phases: over nk >= 1 stages,
// each 64-row warpgroup computes acc0 = A B0 and acc1 = A B1, where A is
// its 64 rows of a stage's activation box and B0, B1 the stage's two
// weight boxes.  The first product overwrites the accumulators (scale-d
// 0): accumulators set by other instructions while a wgmma of the ring is
// in flight would make ptxas serialise the wgmmas (warning C7515).
template <int MB>
__device__ __forceinline__ void consume(unsigned char* base, uint64_t* full, uint64_t* empty,
                                        int nk, float (&acc0)[32], float (&acc1)[32]) {
  using T = Cfg<MB>;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  for (int t = 0; t < nk; ++t) {
    const int st = t % T::STAGES;
    mbar_wait(&full[st], (t / T::STAGES) & 1);
    const unsigned char* sb = base + st * T::STAGE_BYTES;
    const bf16* a = reinterpret_cast<const bf16*>(sb) + wg * 64 * KC;
    const bf16* b0 = reinterpret_cast<const bf16*>(sb + T::A_BYTES);
    const bf16* b1 = b0 + KC * NB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint64_t da = wgmma_desc(a + kk * 16, 128);
      const int accumulate = t > 0 || kk > 0;
      wgmma_ss_m64n64_mn(acc0, da, wgmma_desc(b0 + kk * 16 * NB, 128), accumulate);
      wgmma_ss_m64n64_mn(acc1, da, wgmma_desc(b1 + kk * 16 * NB, 128), accumulate);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: free it
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % T::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
}

// Accumulator element i of a thread of warpgroup wg sits at row
// wg * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1) and column
// (i / 4) * 8 + (lane % 4) * 2 + (i & 1) of the 64 x 64 product.
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x / 128) * 64 + (threadIdx.x % 128) / 32 * 16 + (threadIdx.x % 32) / 4 +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return (i / 4) * 8 + (threadIdx.x % 4) * 2; }

// Phase A.  Grid: tiles x F / FT.
template <int MB, class Tiles>
__global__ void __launch_bounds__(Cfg<MB>::kThreads, 2)
gate_up_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wgmap,
               const __grid_constant__ CUtensorMap wumap, Tiles tiles, bf16* __restrict__ h,
               int d, int F) {
  using T = Cfg<MB>;
  int tile, col;
  cta_tile((F + FT - 1) / FT, tile, col);
  Tile tl;
  if (!tiles.locate(tile, tl)) return;   // padding tile: phase B writes its zeros
  const int f0 = col * FT;
  const int nk = (d + KC - 1) / KC;
  unsigned char* base = smem_base();
  uint64_t *full, *empty;
  init_ring<MB>(base, full, empty);

  if (threadIdx.x >= 128 * MB) {
    if (threadIdx.x == 128 * MB) {   // producer
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&wgmap);
      tma_prefetch_map(&wumap);
      const uint32_t bytes = tiles.m * KC * 2 + 2 * WBOX_BYTES;
      for (int t = 0; t < nk; ++t) {
        const int st = t % T::STAGES;
        mbar_wait(&empty[st], ((t / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        unsigned char* sb = base + st * T::STAGE_BYTES;
        tma_load_3d(sb, &xmap, &full[st], t * KC, tl.row, tl.grp);
        tma_load_3d(sb + T::A_BYTES, &wgmap, &full[st], f0, t * KC, tl.e);
        tma_load_3d(sb + T::A_BYTES + WBOX_BYTES, &wumap, &full[st], f0, t * KC, tl.e);
      }
    }
    return;
  }

  float g[32], u[32];
  consume<MB>(base, full, empty, nk, g, u);
  // H = silu(G) * U in fp32, rounded once to bf16
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i), c = f0 + acc_col(i);
    if (r < tl.rvalid && c < F)
      *reinterpret_cast<uint32_t*>(h + (tl.flat_row0 + r) * F + c) =
          pack_bf16(silu(g[i]) * u[i], silu(g[i + 1]) * u[i + 1]);
  }
}

// Phase B.  Grid: tiles x d / DT.
template <int MB, class Tiles>
__global__ void __launch_bounds__(Cfg<MB>::kThreads, 2)
down_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wdmap,
            Tiles tiles, bf16* __restrict__ out, int d, int F) {
  using T = Cfg<MB>;
  int tile, col;
  cta_tile((d + DT - 1) / DT, tile, col);
  Tile tl;
  const int d0 = col * DT;
  if (!tiles.locate(tile, tl)) {   // padding tile: zeros, no weight traffic
    const int chunks = min(DT, d - d0) / 8;
    for (int i = threadIdx.x; i < tl.rvalid * chunks; i += blockDim.x) {
      const int r = i / chunks, c = (i - r * chunks) * 8;
      *reinterpret_cast<uint4*>(out + (tl.flat_row0 + r) * d + d0 + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int nk = (F + KC - 1) / KC;
  unsigned char* base = smem_base();
  uint64_t *full, *empty;
  init_ring<MB>(base, full, empty);

  if (threadIdx.x >= 128 * MB) {
    if (threadIdx.x == 128 * MB) {   // producer
      tma_prefetch_map(&hmap);
      tma_prefetch_map(&wdmap);
      // the second box of the last d-tile may lie wholly past d: it is not
      // loaded, and the columns it would feed are not stored
      const bool second = d0 + NB < d;
      const uint32_t bytes = tiles.m * KC * 2 + (second ? 2 : 1) * WBOX_BYTES;
      for (int t = 0; t < nk; ++t) {
        const int st = t % T::STAGES;
        mbar_wait(&empty[st], ((t / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        unsigned char* sb = base + st * T::STAGE_BYTES;
        tma_load_3d(sb, &hmap, &full[st], t * KC, tl.row, tl.grp);
        tma_load_3d(sb + T::A_BYTES, &wdmap, &full[st], d0, t * KC, tl.e);
        if (second)
          tma_load_3d(sb + T::A_BYTES + WBOX_BYTES, &wdmap, &full[st], d0 + NB, t * KC, tl.e);
      }
    }
    return;
  }

  float o0[32], o1[32];
  consume<MB>(base, full, empty, nk, o0, o1);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i), c = d0 + acc_col(i);
    if (r < tl.rvalid) {
      bf16* dst = out + (tl.flat_row0 + r) * d + c;
      if (c < d) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0[i], o0[i + 1]);
      if (c + NB < d) *reinterpret_cast<uint32_t*>(dst + NB) = pack_bf16(o1[i], o1[i + 1]);
    }
  }
}

// Host side: a 3-D bf16 map over (cols, rows, groups), rows ``cols``
// elements apart and groups ``rows`` rows apart, read in boxes of
// (KC or NB columns, box_rows rows, one group), 128-byte swizzle.
__host__ inline int encode_3d(CUtensorMap* map, const void* base, long cols, long rows, long groups,
                              int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1};
  return encode_bf16_map(map, 3, base, dims, strides, box, 128);
}

template <int MB, class Tiles>
__host__ int run(const Tiles& tiles, int n_tiles, const CUtensorMap& xmap, const CUtensorMap& wgmap,
                 const CUtensorMap& wumap, const CUtensorMap& hmap, const CUtensorMap& wdmap,
                 bf16* h, bf16* out, int d, int F, cudaStream_t stream) {
  using T = Cfg<MB>;
  cudaError_t err = allow_smem(gate_up_kernel<MB, Tiles>, T::SMEM);
  if (err == cudaSuccess) err = allow_smem(down_kernel<MB, Tiles>, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_up_kernel<MB, Tiles><<<n_tiles * ((F + FT - 1) / FT), T::kThreads, T::SMEM, stream>>>(
      xmap, wgmap, wumap, tiles, h, d, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_kernel<MB, Tiles><<<n_tiles * ((d + DT - 1) / DT), T::kThreads, T::SMEM, stream>>>(
      hmap, wdmap, tiles, out, d, F);
  return static_cast<int>(cudaGetLastError());
}

// Both phases over ``n_tiles`` tiles of ``tiles.m`` rows.  x and h are
// (groups, rows, d) and (groups, rows, F) for the maps; weights (E, d, F)
// and (E, F, d).  d and F multiples of 8, every pointer 16-byte aligned.
template <class Tiles>
__host__ int launch(const Tiles& tiles, int n_tiles, const void* x, long rows, long groups,
                    const void* wg, const void* wu, const void* wd, void* h, void* out, int E,
                    int d, int F, cudaStream_t stream) {
  const int m = tiles.m;
  if (n_tiles == 0) return 0;
  if (m < 8 || m > M_MAX || (m & (m - 1)) || d <= 0 || F <= 0 || d % 8 || F % 8 ||
      static_cast<long>(n_tiles) * (((d > F ? d : F) + FT - 1) / FT) > 0x7FFFFFFFL ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wg) |
       reinterpret_cast<uintptr_t>(wu) | reinterpret_cast<uintptr_t>(wd) |
       reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wgmap, wumap, hmap, wdmap;
  int err = encode_3d(&xmap, x, d, rows, groups, KC, m);
  if (!err) err = encode_3d(&wgmap, wg, F, d, E, NB, KC);
  if (!err) err = encode_3d(&wumap, wu, F, d, E, NB, KC);
  if (!err) err = encode_3d(&hmap, h, F, rows, groups, KC, m);
  if (!err) err = encode_3d(&wdmap, wd, d, F, E, NB, KC);
  if (err) return err;
  auto hp = static_cast<bf16*>(h);
  auto op = static_cast<bf16*>(out);
  return m <= 64 ? run<1>(tiles, n_tiles, xmap, wgmap, wumap, hmap, wdmap, hp, op, d, F, stream)
                 : run<2>(tiles, n_tiles, xmap, wgmap, wumap, hmap, wdmap, hp, op, d, F, stream);
}

}  // namespace moe_swiglu
