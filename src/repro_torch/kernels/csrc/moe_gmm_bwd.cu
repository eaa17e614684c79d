// Backward of the dense-dispatch fused SwiGLU (moe_gmm.cu), by hand for
// Hopper (sm_90a): four wgmma launches on TMA-fed tiles.
//
// Replaces no TPU kernel: the JAX package has no backward Pallas kernel
// (its training path lets XLA differentiate expert_ffn_ref,
// src/repro/models/moe.py).  It computes the vjp of the forward kernel's
// contract (the TPU kernel src/repro/kernels/moe_gmm.py, moe_gmm_pallas):
// x (E, C, d), Wg/Wu (E, d, F), Wd (E, F, d), out = (silu(x Wg) o (x Wu))
// Wd per expert; from dY (E, C, d):
//
//   1 gate_up_dh:  G = X Wg, U = X Wu, dH = dY Wd^T (fp32), then
//                  H = silu(G) U, dG = dH o U o silu'(G), dU = dH o silu(G),
//                  each rounded once to bf16 into the scratch h, dg, du
//                  (E, C, F), as the forward rounds its H
//   2 dx:          dX = dG Wg^T + dU Wu^T                  (E, C, d)
//   3 wgrad:       dWg = X^T dG, dWu = X^T dU              (E, d, F)
//   4 wgrad:       dWd = H^T dY                            (E, F, d)
//
// Every output tile is one CTA's, summed over its whole reduction axis in
// a fixed order (the weight grads loop over the C rows of their expert):
// no atomics, so two calls give the same bits.  Grads come out in bf16,
// the parameters' dtype, as jax.grad gives them.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// qwen3-30b-a3b's training step (E 128, C 160 at 2048 tokens, d 2048, F
// 768) the three weight grads are 1.21 GB of writes and the three weights
// 1.21 GB of reads, with x, dY and dX 0.25 GB more: 0.80 ms, bytes-bound
// (the eight products of 2 E C d F flops each — G, U, dH, dX twice, dWg,
// dWu, dWd — 0.52 TFLOP, take 0.52 ms at peak).
//
// Design.  Every launch is the forward's shape (moe_swiglu.cuh): a
// producer warp keeps a ring of TMA loads (128-byte swizzle) in flight on
// mbarriers and consumer warpgroups run wgmma m64n64k16 with both
// operands in shared memory.
//  * Kernels 1 and 2 cut each expert's C rows into the forward's
//    DenseTiles: up to C 64 one tile of m rows, the power of two in [8,
//    64] at or above C, on one consumer warpgroup; past that tiles of 64
//    W rows on W = 2 or 3 warpgroups (C 160: one tile of 192 rows, 160
//    real).  A stage's weight boxes feed all W warpgroups, so at C <= 192
//    each weight crosses the L2 once per expert and column tile: with
//    one warpgroup of 64 rows the three 64-row tiles of C 160 read 5.9 GB
//    through the L2 in kernel 1, with 192-row tiles 3.2 GB.  Kernel 1 is
//    the forward's phase A (X K-major, MN-major Wg and Wu boxes) plus
//    the third product dH over the same d steps: a dY box beside the X box
//    and a Wd box of 64 F rows x 64 d columns, K-major.  Its epilogue
//    rounds H, dG and dU once each.  Kernel 2 is phase B's shape over F
//    twice (dG with Wg, then dU with Wu): the weight boxes are the same
//    (64 F columns x 64 d rows), read K-major.
//  * Kernels 3 and 4 (wgrad_kernel) reduce over the C rows of one
//    expert.  A CTA owns a 128-row output tile of two outputs of 128
//    columns (dWg and dWu at the same (d, F) tile; or two halves of a
//    256-column tile of dWd), two consumer warpgroups of 64 rows and 2 x
//    128 fp32 columns each (four m64n64 accumulators).  The ring brings
//    64 rows of C a stage: two A boxes (X or H) and four B boxes (dG and
//    dU, or dY), all as they lie in memory ([c][column]): A read MN-major
//    (transposed A, which wgmma takes for bf16) and B MN-major.  At C <=
//    256 the whole reduction is at most four stages, too few to hide a
//    tile's loads and store, so the grid is persistent: one CTA an SM
//    walks the tiles, its producer loading the next tile's stages while
//    the consumers store the last one's.  The epilogue writes each 64 x
//    64 bf16 box into shared memory in the 128-byte swizzle and stores it
//    with one TMA store, so every write to device memory is a whole line.
//    Tiles run expert-major, so an expert's X, H, dG, dU and dY boxes are
//    re-read from the L2.
// Edges: TMA zero-fills whatever lies outside a tensor map (rows past C,
// columns of d and F past the edge), and a TMA store writes nothing
// outside its map; d and F must be multiples of 8 (16-byte rows;
// ops.moe_gmm_bwd pads other widths), any C >= 1.
#include "moe_swiglu.cuh"

namespace {

using namespace moe_swiglu;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ void init_bars(uint64_t* full, uint64_t* empty, int stages,
                                          int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// ------------------------------------------------------- kernels 1 and 2

// W consumer warpgroups of 64 rows each; a row tile is m <= 64 W rows of
// one expert.  Kernel 1's stage: X and dY boxes (m rows x KC), Wg and Wu
// boxes (KC d rows x NB F columns, MN-major) and a Wd box (NB F rows x KC d
// columns, K-major).  Kernel 2's: a dG or dU box (m rows x KC) and two
// weight boxes (64 d rows x KC F columns, K-major).  At W 1 two CTAs share
// an SM.
template <int W>
struct RowCfg {
  static constexpr int kThreads = 128 * W + 32;   // consumers, then the producer warp
  static constexpr int A_BYTES = W * 64 * KC * 2;
  static constexpr int STAGE1 = 2 * A_BYTES + 3 * WBOX_BYTES;
  static constexpr int STAGES1 = W == 1 ? 2 : 3;
  static constexpr int SMEM1 = 1024 + STAGES1 * STAGE1 + 2 * STAGES1 * 8;
  static constexpr int STAGE2 = A_BYTES + 2 * WBOX_BYTES;
  static constexpr int STAGES2 = 4;
  static constexpr int SMEM2 = 1024 + STAGES2 * STAGE2 + 2 * STAGES2 * 8;
  static_assert(SMEM1 <= 232448 && SMEM2 <= 232448, "shared memory of one CTA");
};

// Kernel 1.  Grid: tiles x F / FT.
template <int W>
__global__ void __launch_bounds__(RowCfg<W>::kThreads, W == 1 ? 2 : 1)
gate_up_dh_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap dymap,
                  const __grid_constant__ CUtensorMap wgmap,
                  const __grid_constant__ CUtensorMap wumap,
                  const __grid_constant__ CUtensorMap wdmap, DenseTiles tiles,
                  bf16* __restrict__ h, bf16* __restrict__ dg, bf16* __restrict__ du, int d,
                  int F) {
  using R = RowCfg<W>;
  constexpr int S = R::STAGES1;
  int tile, col;
  cta_tile((F + FT - 1) / FT, tile, col);
  Tile tl;
  tiles.locate(tile, tl);
  const int f0 = col * FT;
  const int nk = (d + KC - 1) / KC;
  unsigned char* base = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * R::STAGE1);
  uint64_t* empty = full + S;
  init_bars(full, empty, S, 4 * W);

  if (threadIdx.x >= 128 * W) {
    if (threadIdx.x == 128 * W) {   // producer
      tma_prefetch_map(&xmap);
      tma_prefetch_map(&dymap);
      tma_prefetch_map(&wgmap);
      tma_prefetch_map(&wumap);
      tma_prefetch_map(&wdmap);
      const uint32_t bytes = 2 * tiles.m * KC * 2 + 3 * WBOX_BYTES;
      for (int t = 0; t < nk; ++t) {
        const int st = t % S;
        mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        unsigned char* sb = base + st * R::STAGE1;
        tma_load_3d(sb, &xmap, &full[st], t * KC, tl.row, tl.grp);
        tma_load_3d(sb + R::A_BYTES, &dymap, &full[st], t * KC, tl.row, tl.grp);
        tma_load_3d(sb + 2 * R::A_BYTES, &wgmap, &full[st], f0, t * KC, tl.e);
        tma_load_3d(sb + 2 * R::A_BYTES + WBOX_BYTES, &wumap, &full[st], f0, t * KC, tl.e);
        tma_load_3d(sb + 2 * R::A_BYTES + 2 * WBOX_BYTES, &wdmap, &full[st], t * KC, f0, tl.e);
      }
    }
    return;
  }

  // G = X Wg, U = X Wu, dH = dY Wd^T over d for this warpgroup's 64 rows;
  // the first product of each overwrites its accumulator (scale-d 0), so
  // no other instruction writes one while the ring's wgmmas are in flight
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  float g[32], u[32], dh[32];
  for (int t = 0; t < nk; ++t) {
    const int st = t % S;
    mbar_wait(&full[st], (t / S) & 1);
    const unsigned char* sb = base + st * R::STAGE1;
    const bf16* xa = reinterpret_cast<const bf16*>(sb) + wg * 64 * KC;
    const bf16* ya = reinterpret_cast<const bf16*>(sb + R::A_BYTES) + wg * 64 * KC;
    const bf16* b0 = reinterpret_cast<const bf16*>(sb + 2 * R::A_BYTES);
    const bf16* b1 = b0 + KC * NB;
    const bf16* b2 = b1 + KC * NB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint64_t dx = wgmma_desc(xa + kk * 16, 128);
      const int accumulate = t > 0 || kk > 0;
      wgmma_ss_m64n64_mn(g, dx, wgmma_desc(b0 + kk * 16 * NB, 128), accumulate);
      wgmma_ss_m64n64_mn(u, dx, wgmma_desc(b1 + kk * 16 * NB, 128), accumulate);
      wgmma_ss_m64n64(dh, wgmma_desc(ya + kk * 16, 128), wgmma_desc(b2 + kk * 16, 128),
                      accumulate);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: free it
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs(g);
  fence_regs(u);
  fence_regs(dh);
  // H = silu(G) U, dG = dH U silu'(G), dU = dH silu(G) in fp32, each
  // rounded once to bf16
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i), c = f0 + acc_col(i);
    if (r >= tl.rvalid || c >= F) continue;
    float hv[2], dgv[2], duv[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float gv = g[i + q], uv = u[i + q], dhv = dh[i + q];
      const float sg = sigmoid(gv), act = gv * sg;
      hv[q] = act * uv;
      dgv[q] = dhv * uv * (sg * (1.0f + gv * (1.0f - sg)));
      duv[q] = dhv * act;
    }
    const long at = (tl.flat_row0 + r) * F + c;
    *reinterpret_cast<uint32_t*>(h + at) = pack_bf16(hv[0], hv[1]);
    *reinterpret_cast<uint32_t*>(dg + at) = pack_bf16(dgv[0], dgv[1]);
    *reinterpret_cast<uint32_t*>(du + at) = pack_bf16(duv[0], duv[1]);
  }
}

// Kernel 2: dX = dG Wg^T + dU Wu^T.  Grid: tiles x d / DT.
template <int W>
__global__ void __launch_bounds__(RowCfg<W>::kThreads, W == 1 ? 2 : 1)
dx_kernel(const __grid_constant__ CUtensorMap dgmap, const __grid_constant__ CUtensorMap dumap,
          const __grid_constant__ CUtensorMap wgmap, const __grid_constant__ CUtensorMap wumap,
          DenseTiles tiles, bf16* __restrict__ dx, int d, int F) {
  using R = RowCfg<W>;
  constexpr int S = R::STAGES2;
  int tile, col;
  cta_tile((d + DT - 1) / DT, tile, col);
  Tile tl;
  tiles.locate(tile, tl);
  const int d0 = col * DT;
  const int nkf = (F + KC - 1) / KC, nk = 2 * nkf;
  unsigned char* base = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S * R::STAGE2);
  uint64_t* empty = full + S;
  init_bars(full, empty, S, 4 * W);

  if (threadIdx.x >= 128 * W) {
    if (threadIdx.x == 128 * W) {   // producer
      tma_prefetch_map(&dgmap);
      tma_prefetch_map(&dumap);
      tma_prefetch_map(&wgmap);
      tma_prefetch_map(&wumap);
      // the second box of the last d-tile may lie wholly past d: it is not
      // loaded, and the columns it would feed are not stored
      const bool second = d0 + NB < d;
      const uint32_t bytes = tiles.m * KC * 2 + (second ? 2 : 1) * WBOX_BYTES;
      for (int t = 0; t < nk; ++t) {
        const int st = t % S;
        const bool up = t >= nkf;
        const int f = (up ? t - nkf : t) * KC;
        mbar_wait(&empty[st], ((t / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        unsigned char* sb = base + st * R::STAGE2;
        tma_load_3d(sb, up ? &dumap : &dgmap, &full[st], f, tl.row, tl.grp);
        const CUtensorMap* w = up ? &wumap : &wgmap;
        tma_load_3d(sb + R::A_BYTES, w, &full[st], f, d0, tl.e);
        if (second) tma_load_3d(sb + R::A_BYTES + WBOX_BYTES, w, &full[st], f, d0 + NB, tl.e);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  float o0[32], o1[32];
  for (int t = 0; t < nk; ++t) {
    const int st = t % S;
    mbar_wait(&full[st], (t / S) & 1);
    const unsigned char* sb = base + st * R::STAGE2;
    const bf16* a = reinterpret_cast<const bf16*>(sb) + wg * 64 * KC;
    const bf16* b0 = reinterpret_cast<const bf16*>(sb + R::A_BYTES);
    const bf16* b1 = b0 + KC * NB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint64_t da = wgmma_desc(a + kk * 16, 128);
      const int accumulate = t > 0 || kk > 0;
      wgmma_ss_m64n64(o0, da, wgmma_desc(b0 + kk * 16, 128), accumulate);
      wgmma_ss_m64n64(o1, da, wgmma_desc(b1 + kk * 16, 128), accumulate);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs(o0);
  fence_regs(o1);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i), c = d0 + acc_col(i);
    if (r < tl.rvalid) {
      bf16* dst = dx + (tl.flat_row0 + r) * d + c;
      if (c < d) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0[i], o0[i + 1]);
      if (c + NB < d) *reinterpret_cast<uint32_t*>(dst + NB) = pack_bf16(o1[i], o1[i + 1]);
    }
  }
}

// ------------------------------------------------------- kernels 3 and 4

// a stage: 64 rows of C of two A boxes and four B boxes, 64 columns each;
// the output staging: 2 warpgroups x 4 boxes of 64 x 64 bf16
struct RingW {
  static constexpr int kThreads = 256 + 32;
  static constexpr int CK = 64;                  // rows of C a stage
  static constexpr int BOX = CK * 64 * 2;
  static constexpr int STAGES = 3;
  static constexpr int STAGE_BYTES = 6 * BOX;
  static constexpr int OUT_BYTES = 8 * 64 * 64 * 2;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + OUT_BYTES + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

// Which of a wgrad tile's boxes lie inside the maps: A's two 64-column
// boxes (rows m0.. and m0 + 64.. of the output), then B0's two, then B1's.
struct WTile {
  int e, m0, n0;
  bool in[6];
  __device__ WTile(int tile, int M, int N, int off, int n_mt, int n_nt) {
    const int ni = tile % n_nt;
    const int mi = (tile / n_nt) % n_mt;
    e = tile / n_nt / n_mt;
    m0 = mi * 128;
    n0 = ni * (128 + off);
    in[0] = true;
    in[1] = m0 + 64 < M;
    in[2] = true;
    in[3] = n0 + 64 < N;
    in[4] = n0 + off < N;
    in[5] = n0 + off + 64 < N;
  }
};

// out0[e][m0 + r][n0 + c] = sum_k A[e][k][m0 + r] B0[e][k][n0 + c] and
// out1[e][m0 + r][n0 + off + c] = sum_k A[e][k][m0 + r] B1[e][k][n0 + off +
// c], k over the C rows, for r, c < 128: dWg and dWu (B0 = dG, B1 = dU,
// off 0) or dWd (B0 = B1 = dY, off 128).  A is (E, C, M), B0 and B1 (E, C,
// N), the outputs (E, M, N).  Tiles are numbered experts, then M tiles,
// then N tiles of 128 + off columns, innermost; the grid is persistent
// (one CTA an SM, tiles blockIdx.x, + gridDim.x, ...), so the producer
// loads a tile's stages while the consumers store the last one's.
__global__ void __launch_bounds__(RingW::kThreads, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap b0map,
             const __grid_constant__ CUtensorMap b1map, const __grid_constant__ CUtensorMap o0map,
             const __grid_constant__ CUtensorMap o1map, int C, int M, int N, int off,
             int n_mt, int n_nt, int n_tiles) {
  using R = RingW;
  const int nk = (C + R::CK - 1) / R::CK;
  unsigned char* base = smem_base();
  unsigned char* out = base + R::STAGES * R::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + R::OUT_BYTES);
  uint64_t* empty = full + R::STAGES;
  init_bars(full, empty, R::STAGES, 8);

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {   // producer
      tma_prefetch_map(&amap);
      tma_prefetch_map(&b0map);
      tma_prefetch_map(&b1map);
      int s = 0;   // stages loaded so far, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const WTile w(tile, M, N, off, n_mt, n_nt);
        uint32_t bytes = 0;
        for (int j = 0; j < 6; ++j) bytes += w.in[j] ? R::BOX : 0;
        for (int t = 0; t < nk; ++t, ++s) {
          const int st = s % R::STAGES;
          mbar_wait(&empty[st], ((s / R::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[st], bytes);
          unsigned char* sb = base + st * R::STAGE_BYTES;
          const int k0 = t * R::CK;
          for (int j = 0; j < 2; ++j) {
            if (w.in[j]) tma_load_3d(sb + j * R::BOX, &amap, &full[st], w.m0 + 64 * j, k0, w.e);
            if (w.in[2 + j])
              tma_load_3d(sb + (2 + j) * R::BOX, &b0map, &full[st], w.n0 + 64 * j, k0, w.e);
            if (w.in[4 + j])
              tma_load_3d(sb + (4 + j) * R::BOX, &b1map, &full[st], w.n0 + off + 64 * j, k0,
                          w.e);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg.. of both outputs; acc[0], [1]
  // the two 64-column halves of out0, acc[2], [3] those of out1.  A box
  // that was not loaded feeds only accumulators that are not stored.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool issuer = threadIdx.x % 128 == 0;
  unsigned char* ob = out + wg * 4 * 64 * 64 * 2;
  float acc[4][32];
  int s = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const WTile w(tile, M, N, off, n_mt, n_nt);
    for (int t = 0; t < nk; ++t, ++s) {
      const int st = s % R::STAGES;
      mbar_wait(&full[st], (s / R::STAGES) & 1);
      const bf16* sb = reinterpret_cast<const bf16*>(base + st * R::STAGE_BYTES);
      const bf16* a = sb + wg * R::CK * 64;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R::CK / 16; ++kk) {
        // A (64 x 16) and B (16 x 64) are k rows kk * 16.. of [k][64] boxes
        const uint64_t da = wgmma_desc(a + kk * 16 * 64, 128);
        const int accumulate = t > 0 || kk > 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_ss_m64n64_tt(acc[j], da,
                             wgmma_desc(sb + (2 + j) * R::CK * 64 + kk * 16 * 64, 128),
                             accumulate);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (t > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % R::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_regs(acc[j]);
    if (lane == 0) mbar_arrive(&empty[(s - 1) % R::STAGES]);

    // each 64 x 64 accumulator -> a bf16 box in the 128-byte swizzle
    // (16-byte chunk c of row r at chunk c ^ (r % 8)), once the last
    // tile's stores have read the staging; then one TMA store a box
    if (issuer) bulk_wait_read();
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
        const int at = r * 128 + (((i / 4) ^ (r % 8)) << 4) + (lane % 4) * 4;
        *reinterpret_cast<uint32_t*>(ob + j * 64 * 64 * 2 + at) =
            pack_bf16(acc[j][i], acc[j][i + 1]);
      }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (issuer && w.in[wg]) {
      for (int j = 0; j < 4; ++j) {
        if (!w.in[2 + j]) continue;
        const int col = j < 2 ? w.n0 + 64 * j : w.n0 + off + 64 * (j - 2);
        tma_store_3d(j < 2 ? &o0map : &o1map, ob + j * 64 * 64 * 2, col, w.m0 + 64 * wg, w.e);
      }
      bulk_commit();
    }
  }
  if (issuer) bulk_wait_read();
}

// kernels 1 and 2 at W consumer warpgroups
template <int W>
int run_rows(const DenseTiles& tiles, int n_tiles, const CUtensorMap& xm, const CUtensorMap& dym,
             const CUtensorMap& wgm, const CUtensorMap& wum, const CUtensorMap& wdm,
             const CUtensorMap& dgm, const CUtensorMap& dum, bf16* h, bf16* dg, bf16* du,
             bf16* dx, int d, int F, cudaStream_t st) {
  using R = RowCfg<W>;
  cudaError_t e = allow_smem(gate_up_dh_kernel<W>, R::SMEM1);
  if (e == cudaSuccess) e = allow_smem(dx_kernel<W>, R::SMEM2);
  if (e != cudaSuccess) return static_cast<int>(e);
  gate_up_dh_kernel<W><<<static_cast<unsigned>(n_tiles) * ((F + FT - 1) / FT), R::kThreads,
                         R::SMEM1, st>>>(xm, dym, wgm, wum, wdm, tiles, h, dg, du, d, F);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  dx_kernel<W><<<static_cast<unsigned>(n_tiles) * ((d + DT - 1) / DT), R::kThreads, R::SMEM2,
                 st>>>(dgm, dum, wgm, wum, tiles, dx, d, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d and F multiples of 8, any C >= 1; every pointer 16-byte aligned; h, dg,
// du scratch of E * C * F each.  ``grid``, where not null, receives what
// the call launched: the CTAs of kernel 1, kernel 2, dWg with dWu and dWd;
// the row tile; the output tiles of dWg with dWu and of dWd (0 where it
// launched nothing).
extern "C" int moe_gmm_bwd_bf16(const void* x, const void* w_gate, const void* w_up,
                                const void* w_down, const void* dy, void* h, void* dg,
                                void* du, void* dx, void* dw_gate, void* dw_up, void* dw_down,
                                int E, int C, int d, int F, int* grid, void* stream) {
  if (grid)
    for (int i = 0; i < 7; ++i) grid[i] = 0;
  if (E == 0 || d == 0 || F == 0) return 0;
  if (d % 8 || F % 8 || C < 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_gate) |
       reinterpret_cast<uintptr_t>(w_up) | reinterpret_cast<uintptr_t>(w_down) |
       reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(h) |
       reinterpret_cast<uintptr_t>(dg) | reinterpret_cast<uintptr_t>(du) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dw_gate) |
       reinterpret_cast<uintptr_t>(dw_up) | reinterpret_cast<uintptr_t>(dw_down)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (C == 0) {
    // no row: every weight's gradient is zero
    const size_t w = static_cast<size_t>(E) * d * F * 2;
    cudaMemsetAsync(dw_gate, 0, w, st);
    cudaMemsetAsync(dw_up, 0, w, st);
    cudaMemsetAsync(dw_down, 0, w, st);
    return static_cast<int>(cudaGetLastError());
  }
  // row tiles of kernels 1 and 2: up to 64 rows, the power of two in [8,
  // 64] at or above C on one warpgroup; past 64, 64 W rows on W <= 3
  // warpgroups (C 160: one tile of 192 rows)
  const int W = C <= 64 ? 1 : C <= 128 ? 2 : 3;
  int m = 8;
  while (m < C && m < 64) m *= 2;
  if (W > 1) m = 64 * W;
  const int n_ct = (C + m - 1) / m;
  const int n_dm = (d + 127) / 128, n_fm = (F + 127) / 128, n_d2 = (d + 255) / 256;
  const long rows_grid = static_cast<long>(E) * n_ct * ((d > F ? d : F) / FT + 1);
  const long wg_tiles = static_cast<long>(E) * n_dm * n_fm;
  const long wd_tiles = static_cast<long>(E) * n_fm * n_d2;
  if (rows_grid > 0x7FFFFFFFL || wg_tiles > 0x7FFFFFFFL || wd_tiles > 0x7FFFFFFFL)
    return static_cast<int>(cudaErrorInvalidValue);
  // kernels 1 and 2: row boxes of m rows, weight boxes of 64 x 64; 3 and
  // 4: boxes of 64 rows of C (or of the output) x 64 columns
  CUtensorMap xm, dym, wgm, wum, wdm, dgm, dum, x64, dg64, du64, h64, dy64, dwgm, dwum, dwdm;
  int err = encode_3d(&xm, x, d, C, E, KC, m);
  if (!err) err = encode_3d(&dym, dy, d, C, E, KC, m);
  if (!err) err = encode_3d(&wgm, w_gate, F, d, E, NB, KC);
  if (!err) err = encode_3d(&wum, w_up, F, d, E, NB, KC);
  if (!err) err = encode_3d(&wdm, w_down, d, F, E, KC, NB);
  if (!err) err = encode_3d(&dgm, dg, F, C, E, KC, m);
  if (!err) err = encode_3d(&dum, du, F, C, E, KC, m);
  if (!err) err = encode_3d(&x64, x, d, C, E, 64, RingW::CK);
  if (!err) err = encode_3d(&dg64, dg, F, C, E, 64, RingW::CK);
  if (!err) err = encode_3d(&du64, du, F, C, E, 64, RingW::CK);
  if (!err) err = encode_3d(&h64, h, F, C, E, 64, RingW::CK);
  if (!err) err = encode_3d(&dy64, dy, d, C, E, 64, RingW::CK);
  if (!err) err = encode_3d(&dwgm, dw_gate, F, d, E, 64, 64);
  if (!err) err = encode_3d(&dwum, dw_up, F, d, E, 64, 64);
  if (!err) err = encode_3d(&dwdm, dw_down, d, F, E, 64, 64);
  if (err) return err;
  const DenseTiles tiles{C, m, n_ct};
  const int n_tiles = E * n_ct;
  auto H = static_cast<bf16*>(h);
  auto DG = static_cast<bf16*>(dg);
  auto DU = static_cast<bf16*>(du);
  auto DX = static_cast<bf16*>(dx);
  err = W == 1 ? run_rows<1>(tiles, n_tiles, xm, dym, wgm, wum, wdm, dgm, dum, H, DG, DU, DX, d,
                             F, st)
        : W == 2 ? run_rows<2>(tiles, n_tiles, xm, dym, wgm, wum, wdm, dgm, dum, H, DG, DU, DX,
                               d, F, st)
                 : run_rows<3>(tiles, n_tiles, xm, dym, wgm, wum, wdm, dgm, dum, H, DG, DU, DX,
                               d, F, st);
  if (err) return err;
  cudaError_t e = allow_smem(wgrad_kernel, RingW::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto wg_ctas = static_cast<unsigned>(wg_tiles < sms ? wg_tiles : sms);
  const auto wd_ctas = static_cast<unsigned>(wd_tiles < sms ? wd_tiles : sms);
  wgrad_kernel<<<wg_ctas, RingW::kThreads, RingW::SMEM, st>>>(
      x64, dg64, du64, dwgm, dwum, C, d, F, 0, n_dm, n_fm, static_cast<int>(wg_tiles));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  wgrad_kernel<<<wd_ctas, RingW::kThreads, RingW::SMEM, st>>>(
      h64, dy64, dy64, dwdm, dwdm, C, F, d, 128, n_fm, n_d2, static_cast<int>(wd_tiles));
  if (grid) {
    const int got[7] = {n_tiles * ((F + FT - 1) / FT), n_tiles * ((d + DT - 1) / DT),
                        static_cast<int>(wg_ctas), static_cast<int>(wd_ctas), m,
                        static_cast<int>(wg_tiles), static_cast<int>(wd_tiles)};
    for (int i = 0; i < 7; ++i) grid[i] = got[i];
  }
  return static_cast<int>(cudaGetLastError());
}
