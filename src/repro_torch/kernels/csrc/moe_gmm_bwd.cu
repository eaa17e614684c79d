// Backward of the dense-dispatch fused SwiGLU (moe_gmm.cu), by hand for
// Hopper (sm_90a): four tiled GEMM launches on mma.sync.
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
//   3 dwgu:        dWg = X^T dG, dWu = X^T dU              (E, d, F)
//   4 dwd:         dWd = H^T dY                            (E, F, d)
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
// Design (simple first).  One CTA of 128 threads (4 warps, 2 x 2, each 32 x
// 32 of the CTA's 64 x 64 output tile) per (N tile, M tile, expert);
// k-steps of 32 through a two-stage cp.async ring in shared memory; each
// operand tile kept in its source's layout and read by the ldmatrix
// variant that layout needs (tiles.cuh): X and dY as [m][k], the weights
// as [k][n] (Wg, Wu in kernel 1) or [n][k] (Wd in 1; Wg, Wu in 2), and
// X^T, H^T as [k][m] (kernels 3, 4).  d and F must be multiples of 8
// (ops.moe_gmm_bwd pads others); C is any (rows past C are zero-filled and
// never stored).
#include "tiles.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int kThreads = 128;
constexpr int LDK = BK + 8;   // a [rows][BK] tile
constexpr int LDW = BN + 8;   // a [BK][64] tile (BM = BN)
constexpr int MK_TILE = BM * LDK;   // elements of a [64][BK] tile
constexpr int KN_TILE = BK * LDW;   // elements of a [BK][64] tile

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

typedef float Acc[2][4][4];   // a warp's 32 x 32: [m16 block][n8 tile][fragment]

__device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0f;
}

// c += A B over one BK stage; A stored [m][k] (A_KM false) or [k][m], B
// stored [k][n] (B_NK false) or [n][k]
template <bool A_KM, bool B_NK>
__device__ __forceinline__ void mma_stage(Acc& c, const bf16* sa, const bf16* sb) {
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (A_KM) tiles::frag_a_km(a[i], sa, LDW, wm + 16 * i, kk);
      else tiles::frag_a_mk(a[i], sa, LDK, wm + 16 * i, kk);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (B_NK) tiles::frag_b_nk(b[j], sb, LDK, wn + 16 * j, kk);
      else tiles::frag_b_kn(b[j], sb, LDW, wn + 16 * j, kk);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) tiles::mma_pair(c[i][2 * j], c[i][2 * j + 1], a[i], b[j]);
  }
}

// accumulator element (i, j, e) of this thread: row and column in the
// CTA's 64 x 64 tile
__device__ __forceinline__ int acc_row(int i, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 2) * 32 + 16 * i + lane / 4 + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 2) * 32 + 8 * j + (lane % 4) * 2;
}

// c (fp32) -> out[m0 + row][n0 + col] (bf16, row-major, ld = N), rows < M
__device__ __forceinline__ void store(const Acc& c, bf16* out, long m0, int n0, long M, int N) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long r = m0 + acc_row(i, 2 * hf);
        const int col = n0 + acc_col(j);
        if (r < M && col < N)
          *reinterpret_cast<uint32_t*>(out + r * N + col) =
              pack_bf16(c[i][j][2 * hf], c[i][j][2 * hf + 1]);
      }
}

// 1: grid (F / BN, C / BM, E).  Stage: X, dY [m][k] and Wd [n][k] tiles
// (64 x LDK), Wg, Wu [k][n] tiles (BK x LDW).
constexpr int STAGE1 = 3 * MK_TILE + 2 * KN_TILE;
__global__ void __launch_bounds__(kThreads)
gate_up_dh_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                  const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                  const bf16* __restrict__ dy, bf16* __restrict__ h, bf16* __restrict__ dg,
                  bf16* __restrict__ du, int C, int d, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const bf16* xe = x + static_cast<long>(e) * C * d;
  const bf16* dye = dy + static_cast<long>(e) * C * d;
  const bf16* wge = wg + static_cast<long>(e) * d * F;
  const bf16* wue = wu + static_cast<long>(e) * d * F;
  const bf16* wde = wd + static_cast<long>(e) * F * d;
  auto load = [&](int st, int k0) {
    bf16* s = sm + st * STAGE1;
    tiles::load_box<BM, BK>(s, xe, m0, k0, d, C, d);
    tiles::load_box<BM, BK>(s + MK_TILE, dye, m0, k0, d, C, d);
    tiles::load_box<BN, BK>(s + 2 * MK_TILE, wde, n0, k0, d, F, d);
    tiles::load_box<BK, BN>(s + 3 * MK_TILE, wge, k0, n0, F, d, F);
    tiles::load_box<BK, BN>(s + 3 * MK_TILE + KN_TILE, wue, k0, n0, F, d, F);
    cp_async_commit();
  };
  Acc g, u, dh;
  zero(g);
  zero(u);
  zero(dh);
  const int nk = (d + BK - 1) / BK;
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load((t + 1) % 2, (t + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* s = sm + (t % 2) * STAGE1;
    mma_stage<false, false>(g, s, s + 3 * MK_TILE);
    mma_stage<false, false>(u, s, s + 3 * MK_TILE + KN_TILE);
    mma_stage<false, true>(dh, s + MK_TILE, s + 2 * MK_TILE);
    __syncthreads();
  }
  const long base = static_cast<long>(e) * C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + acc_row(i, 2 * hf);
        const int col = n0 + acc_col(j);
        if (r >= C || col >= F) continue;
        float hv[2], dgv[2], duv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float gv = g[i][j][2 * hf + q], uv = u[i][j][2 * hf + q];
          const float dhv = dh[i][j][2 * hf + q];
          const float sg = sigmoid(gv), act = gv * sg;
          hv[q] = act * uv;
          dgv[q] = dhv * uv * (sg * (1.0f + gv * (1.0f - sg)));
          duv[q] = dhv * act;
        }
        const long at = (base + r) * F + col;
        *reinterpret_cast<uint32_t*>(h + at) = pack_bf16(hv[0], hv[1]);
        *reinterpret_cast<uint32_t*>(dg + at) = pack_bf16(dgv[0], dgv[1]);
        *reinterpret_cast<uint32_t*>(du + at) = pack_bf16(duv[0], duv[1]);
      }
}

// 2: dX = dG Wg^T + dU Wu^T; grid (d / BN, C / BM, E); the reduction runs
// over F twice (dG with Wg, then dU with Wu).  Stage: [m][k] and [n][k].
constexpr int STAGE2 = 2 * MK_TILE;
__global__ void __launch_bounds__(kThreads)
dx_kernel(const bf16* __restrict__ dg, const bf16* __restrict__ du,
          const bf16* __restrict__ wg, const bf16* __restrict__ wu, bf16* __restrict__ dx,
          int C, int d, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const long ce = static_cast<long>(e) * C * F, we = static_cast<long>(e) * d * F;
  const int nkf = (F + BK - 1) / BK, nk = 2 * nkf;
  auto load = [&](int st, int t) {
    bf16* s = sm + st * STAGE2;
    const bool up = t >= nkf;
    const int k0 = (up ? t - nkf : t) * BK;
    tiles::load_box<BM, BK>(s, (up ? du : dg) + ce, m0, k0, F, C, F);
    tiles::load_box<BN, BK>(s + MK_TILE, (up ? wu : wg) + we, n0, k0, F, d, F);
    cp_async_commit();
  };
  Acc c;
  zero(c);
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load((t + 1) % 2, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* s = sm + (t % 2) * STAGE2;
    mma_stage<false, true>(c, s, s + MK_TILE);
    __syncthreads();
  }
  store(c, dx + static_cast<long>(e) * C * d, m0, n0, C, d);
}

// 3: dWg = X^T dG, dWu = X^T dU; grid (F / BN, d / BM, E); the reduction
// runs over the expert's C rows.  Stage: X as [k][m], dG and dU as [k][n].
constexpr int STAGE3 = 3 * KN_TILE;
__global__ void __launch_bounds__(kThreads)
dwgu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dg,
            const bf16* __restrict__ du, bf16* __restrict__ dwg, bf16* __restrict__ dwu, int C,
            int d, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const bf16* xe = x + static_cast<long>(e) * C * d;
  const long ce = static_cast<long>(e) * C * F;
  auto load = [&](int st, int k0) {
    bf16* s = sm + st * STAGE3;
    tiles::load_box<BK, BM>(s, xe, k0, m0, d, C, d);
    tiles::load_box<BK, BN>(s + KN_TILE, dg + ce, k0, n0, F, C, F);
    tiles::load_box<BK, BN>(s + 2 * KN_TILE, du + ce, k0, n0, F, C, F);
    cp_async_commit();
  };
  Acc cg, cu;
  zero(cg);
  zero(cu);
  const int nk = (C + BK - 1) / BK;
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load((t + 1) % 2, (t + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* s = sm + (t % 2) * STAGE3;
    mma_stage<true, false>(cg, s, s + KN_TILE);
    mma_stage<true, false>(cu, s, s + 2 * KN_TILE);
    __syncthreads();
  }
  const long we = static_cast<long>(e) * d * F;
  store(cg, dwg + we, m0, n0, d, F);
  store(cu, dwu + we, m0, n0, d, F);
}

// 4: dWd = H^T dY; grid (d / BN, F / BM, E).  Stage: H as [k][m], dY as
// [k][n].
constexpr int STAGE4 = 2 * KN_TILE;
__global__ void __launch_bounds__(kThreads)
dwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ dy, bf16* __restrict__ dwd,
           int C, int d, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const bf16* he = h + static_cast<long>(e) * C * F;
  const bf16* dye = dy + static_cast<long>(e) * C * d;
  auto load = [&](int st, int k0) {
    bf16* s = sm + st * STAGE4;
    tiles::load_box<BK, BM>(s, he, k0, m0, F, C, F);
    tiles::load_box<BK, BN>(s + KN_TILE, dye, k0, n0, d, C, d);
    cp_async_commit();
  };
  Acc c;
  zero(c);
  const int nk = (C + BK - 1) / BK;
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load((t + 1) % 2, (t + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* s = sm + (t % 2) * STAGE4;
    mma_stage<true, false>(c, s, s + KN_TILE);
    __syncthreads();
  }
  store(c, dwd + static_cast<long>(e) * F * d, m0, n0, F, d);
}

}  // namespace

// d and F multiples of 8, any C >= 1; every pointer 16-byte aligned; h, dg,
// du scratch of E * C * F each.
extern "C" int moe_gmm_bwd_bf16(const void* x, const void* w_gate, const void* w_up,
                                const void* w_down, const void* dy, void* h, void* dg,
                                void* du, void* dx, void* dw_gate, void* dw_up, void* dw_down,
                                int E, int C, int d, int F, void* stream) {
  if (E == 0 || d == 0 || F == 0) return 0;
  if (E > 65535 || d % 8 || F % 8 || C < 0 ||
      (d + BM - 1) / BM > 65535 || (F + BM - 1) / BM > 65535 || (C + BM - 1) / BM > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_gate) |
       reinterpret_cast<uintptr_t>(w_up) | reinterpret_cast<uintptr_t>(w_down) |
       reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(h) |
       reinterpret_cast<uintptr_t>(dg) | reinterpret_cast<uintptr_t>(du)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const bf16*>(x);
  auto WG = static_cast<const bf16*>(w_gate);
  auto WU = static_cast<const bf16*>(w_up);
  auto WD = static_cast<const bf16*>(w_down);
  auto DY = static_cast<const bf16*>(dy);
  auto H = static_cast<bf16*>(h);
  auto DG = static_cast<bf16*>(dg);
  auto DU = static_cast<bf16*>(du);
  if (C == 0) {
    // no row: every weight's gradient is zero
    const size_t w = static_cast<size_t>(E) * d * F * 2;
    cudaMemsetAsync(dw_gate, 0, w, st);
    cudaMemsetAsync(dw_up, 0, w, st);
    cudaMemsetAsync(dw_down, 0, w, st);
    return static_cast<int>(cudaGetLastError());
  }
  const int s1 = STAGE1 * 2 * 2, s2 = STAGE2 * 2 * 2, s3 = STAGE3 * 2 * 2, s4 = STAGE4 * 2 * 2;
  cudaError_t err = allow_smem(gate_up_dh_kernel, s1);
  if (err == cudaSuccess) err = allow_smem(dx_kernel, s2);
  if (err == cudaSuccess) err = allow_smem(dwgu_kernel, s3);
  if (err == cudaSuccess) err = allow_smem(dwd_kernel, s4);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tc = (C + BM - 1) / BM, td = (d + BN - 1) / BN, tf = (F + BN - 1) / BN;
  gate_up_dh_kernel<<<dim3(tf, tc, E), kThreads, s1, st>>>(X, WG, WU, WD, DY, H, DG, DU, C, d,
                                                            F);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dx_kernel<<<dim3(td, tc, E), kThreads, s2, st>>>(DG, DU, WG, WU, static_cast<bf16*>(dx), C, d,
                                                    F);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dwgu_kernel<<<dim3(tf, td, E), kThreads, s3, st>>>(X, DG, DU, static_cast<bf16*>(dw_gate),
                                                      static_cast<bf16*>(dw_up), C, d, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dwd_kernel<<<dim3(td, tf, E), kThreads, s4, st>>>(H, DY, static_cast<bf16*>(dw_down), C, d,
                                                     F);
  return static_cast<int>(cudaGetLastError());
}
