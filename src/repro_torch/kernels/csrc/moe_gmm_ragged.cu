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
// Design: the two-phase grouped GEMM of moe_swiglu.cuh (shared with
// moe_gmm.cu), with the tile's expert read from tile_expert.  Phase A
// writes H (n_rows, F) in bf16 to the scratch ``h``; phase B reads it back
// (H of a 2048-token prefill is 50 MB, against 1.2 GB of weights).  Each
// CTA reads a weight tile once, so a decode step streams each active
// expert's weights once instead of once per output tile.  The Pallas
// kernel rounds its running sum to the output dtype after every F step;
// this kernel keeps it in fp32 to one final rounding, so in bf16 the two
// differ by design (chip_smoke.py holds it to a relative Frobenius error
// <= 1e-2 against the fp32 plain version).  Two CUDA launches per call.
#include "moe_swiglu.cuh"

// d and F multiples of 8; m_blk a power of two in [8, 128]; n_rows a
// multiple of m_blk; every pointer 16-byte aligned; h holds n_rows * F.
extern "C" int moe_gmm_ragged_bf16(const void* rows, const void* w_gate,
                                   const void* w_up, const void* w_down,
                                   const void* tile_expert, void* h, void* out,
                                   int n_rows, int d, int F, int E, int m_blk,
                                   void* stream) {
  if (n_rows == 0) return 0;
  if (m_blk <= 0 || n_rows % m_blk) return static_cast<int>(cudaErrorInvalidValue);
  const moe_swiglu::RaggedTiles tiles{static_cast<const int*>(tile_expert), m_blk, E};
  return moe_swiglu::launch(tiles, n_rows / m_blk, rows, n_rows, 1, w_gate, w_up, w_down, h, out,
                            E, d, F, static_cast<cudaStream_t>(stream));
}
