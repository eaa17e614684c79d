// Batched per-expert fused SwiGLU over the dense (E, C, d) capacity buffer,
// by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/moe_gmm.py, moe_gmm_pallas (body
// _gmm_kernel).  Same contract: x (E, C, d), Wg/Wu (E, d, F), Wd (E, F, d),
// bf16 in and out, fp32 accumulation;
//     out[e] = (silu(x[e] @ Wg[e]) * (x[e] @ Wu[e])) @ Wd[e].
// Any C; d and F multiples of 8 (ops.moe_gmm zero-pads other widths, as
// the JAX wrapper pads C and F to 128-multiples with a copy).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): every expert
// computes all C rows, so all E experts' weights are read, 3 * d * F * 2 B
// = 9.44 MB each at qwen3-30b-a3b (d 2048, F 768): 1.21 GB per launch.  At
// the engine's full-pool decode step (dropless, C = n_slots = 8) that is
// 0.361 ms, bytes-bound; a packed prefill of 4 x 256 tokens (C = 1024,
// 131072 rows) does 1.24 TFLOP, 1.25 ms, operations-bound.
//
// Design: the two-phase grouped GEMM of moe_swiglu.cuh (shared with
// moe_gmm_ragged.cu).  Expert e's C rows are cut into tiles of m_tile rows
// (the power of two in [8, 128] at or above C, picked by the wrapper); the
// activation and H maps are 3-D over (d or F, C, E), so the rows past C of
// an expert's last tile arrive as zeros and are not stored.  Phase A
// writes H (E * C, F) in bf16 to the scratch ``h``; phase B reads it back.
// Tiles are numbered expert-major, so the tiles of one expert run close
// together and share its weights through the 50 MB L2.  Two CUDA launches
// per call.
#include "moe_swiglu.cuh"

// d and F multiples of 8; m_tile a power of two in [8, 128]; every pointer
// 16-byte aligned; h holds E * C * F.
extern "C" int moe_gmm_bf16(const void* x, const void* w_gate, const void* w_up,
                            const void* w_down, void* h, void* out, int E, int C, int d,
                            int F, int m_tile, void* stream) {
  if (E == 0 || C == 0 || d == 0) return 0;
  if (m_tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ct = (C + m_tile - 1) / m_tile;
  if (static_cast<long>(E) * n_ct > 0x7FFFFFFFL) return static_cast<int>(cudaErrorInvalidValue);
  const moe_swiglu::DenseTiles tiles{C, m_tile, n_ct};
  return moe_swiglu::launch(tiles, E * n_ct, x, C, E, w_gate, w_up, w_down, h, out, E, d, F,
                            static_cast<cudaStream_t>(stream));
}
