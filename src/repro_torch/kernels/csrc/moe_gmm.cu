// Batched per-expert fused SwiGLU over the dense (E, C, d) capacity buffer,
// by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/moe_gmm.py, moe_gmm_pallas (body
// _gmm_kernel).  Same contract: x (E, C, d), Wg/Wu (E, d, F), Wd (E, F, d),
// bf16 in and out, fp32 accumulation;
//     out[e] = (silu(x[e] @ Wg[e]) * (x[e] @ Wu[e])) @ Wd[e].
// Any C, d and F: the kernel masks the ragged edges itself (the JAX
// wrapper pads C and F to 128-multiples with a copy instead).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): every expert
// computes all C rows, so all E experts' weights are read, 3 * d * F * 2 B
// = 9.44 MB each at qwen3-30b-a3b (d 2048, F 768): 1.21 GB per launch.  At
// the engine's full-pool decode step (dropless, C = n_slots = 8) that is
// 0.361 ms, bytes-bound; a packed prefill of 4 x 256 tokens (C = 1024,
// 131072 rows) does 1.24 TFLOP, 1.25 ms, operations-bound.
//
// Design.  The Pallas kernel walks an (E, C/c_blk, F/f_blk) grid in order
// and carries the down-projection sum in its output block, rounded to bf16
// after each F step.  Here one CTA owns a (row tile of m_tile rows, d-tile
// of DT columns) of one expert — grid (d-tiles, C-tiles, E), so the CTAs of
// one expert are adjacent and share its weights through the 50 MB L2 — and
// runs the tile body of moe_swiglu.cuh (shared with moe_gmm_ragged.cu):
// the F loop inside the CTA, the sum in fp32 until one final rounding.
// m_tile is the power of two in [8, 128] at or above C (the wrapper picks
// it), so a decode buffer is one 8-row tile per expert padded to WMMA's 16
// rows, and the last C-tile computes only its real rows (rounded up to 16).
// Experts on grid.z and C-tiles on grid.y keep both within the launch
// limit of 65535 up to C = 8.4 M.  Like K1, the gate/up products are
// recomputed for each of the d/DT = 16 d-tiles; wgmma, TMA and a split over
// F for decode are later work.
#include "moe_swiglu.cuh"

using namespace moe_swiglu;

namespace {

__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
               const bf16* __restrict__ wu, const bf16* __restrict__ wd,
               bf16* __restrict__ out, int C, int d, int F, int m_tile) {
  const int d0 = blockIdx.x * DT;
  const int c0 = blockIdx.y * m_tile;
  const int e = blockIdx.z;
  const long row0 = static_cast<long>(e) * C + c0;
  const long w_off = static_cast<long>(e) * d * F;
  extern __shared__ __align__(128) unsigned char smem[];
  swiglu_tile(x + row0 * d, min(m_tile, C - c0), wg + w_off, wu + w_off,
              wd + w_off, d, F, d0, out + row0 * d, smem);
}

}  // namespace

extern "C" int moe_gmm_bf16(const void* x, const void* w_gate, const void* w_up,
                            const void* w_down, void* out, int E, int C, int d,
                            int F, int m_tile, void* stream) {
  if (E == 0 || C == 0 || d == 0) return 0;
  if (m_tile < 8 || m_tile > MP_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_layout(padded_rows(m_tile)).total;
  cudaError_t err = allow_smem(moe_gmm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((d + DT - 1) / DT, (C + m_tile - 1) / m_tile, E);
  moe_gmm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_gate),
      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down),
      static_cast<bf16*>(out), C, d, F, m_tile);
  return static_cast<int>(cudaGetLastError());
}
