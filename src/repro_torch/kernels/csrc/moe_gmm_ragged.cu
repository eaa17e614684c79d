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
// and share its weights through the 50 MB L2.  The tile body
// (moe_swiglu.cuh, shared with moe_gmm.cu) loops over F inside the CTA and
// keeps the down-projection sum in fp32 until one final rounding.  (The
// Pallas kernel rounds its running sum to the output dtype after every F
// step; this kernel does not, so in bf16 the two differ by design —
// chip_smoke.py holds it to a relative Frobenius error <= 1e-2 against the
// fp32 plain version.)  The gate/up products are recomputed for each
// d-tile: d/DT = 16 times at qwen widths — the price of keeping H out of
// device memory in this first, simple kernel.  Decode tiles (m_blk 8) are
// below wgmma's M = 64: they are padded to one 16-row WMMA tile here, and a
// decode-specialised kernel (or split over F) is the later fix.  A
// sentinel tile writes zeros and returns before touching any weight.
#include "moe_swiglu.cuh"

using namespace moe_swiglu;

namespace {

__global__ void __launch_bounds__(kThreads)
moe_gmm_ragged_kernel(const bf16* __restrict__ rows, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                      const int* __restrict__ tile_expert, bf16* __restrict__ out,
                      int d, int F, int E, int m_blk) {
  const int d0 = blockIdx.x * DT;
  const int tile = blockIdx.y;
  const long row0 = static_cast<long>(tile) * m_blk;
  const int e = tile_expert[tile];

  if (e >= E) {   // alignment-padding tile: zeros, no weight traffic
    const int ncols = min(DT, d - d0);
    for (int i = threadIdx.x; i < m_blk * ncols; i += kThreads) {
      const int r = i / ncols, c = i - r * ncols;
      out[(row0 + r) * d + d0 + c] = __float2bfloat16(0.0f);
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const long w_off = static_cast<long>(e) * d * F;
  swiglu_tile(rows + row0 * d, m_blk, wg + w_off, wu + w_off, wd + w_off, d, F,
              d0, out + row0 * d, smem);
}

}  // namespace

extern "C" int moe_gmm_ragged_bf16(const void* rows, const void* w_gate,
                                   const void* w_up, const void* w_down,
                                   const void* tile_expert, void* out,
                                   int n_rows, int d, int F, int E, int m_blk,
                                   void* stream) {
  if (n_rows == 0) return 0;
  const size_t smem = smem_layout(padded_rows(m_blk)).total;
  cudaError_t err = allow_smem(moe_gmm_ragged_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((d + DT - 1) / DT, n_rows / m_blk);
  moe_gmm_ragged_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rows), static_cast<const bf16*>(w_gate),
      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down),
      static_cast<const int*>(tile_expert), static_cast<bf16*>(out), d, F, E, m_blk);
  return static_cast<int>(cudaGetLastError());
}
