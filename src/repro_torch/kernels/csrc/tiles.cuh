// Shared-memory tiles and mma.sync fragments for the port's backward
// kernels (prefill_attention_bwd.cu, moe_gmm_bwd.cu): a cp.async loader of
// a bounded box of a row-major bf16 matrix, and the four ldmatrix loads of
// mma.m16n8k16's operands from a tile kept in its source's own layout.
//
// A tile holds ROWS x COLS elements, ``ld`` = COLS + 8 elements a row: a
// 16-byte pad, so the eight rows that one ldmatrix phase reads start in
// eight different 16-byte bank groups (row strides of 80 and 144 bytes).
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16): lane l holds, of A (16 x 16),
// rows l/4 and l/4 + 8 at columns 2(l%4) + {0, 1} and + 8; of B (16 x 8),
// rows 2(l%4) + {0, 1} and + 8 at column l/4; of the fp32 accumulator
// (16 x 8), c[0], c[1] at row l/4 and c[2], c[3] at row l/4 + 8, columns
// 2(l%4) + {0, 1}.  So the accumulators of two neighbouring n-tiles, packed
// to bf16 in pairs, are the A fragment of the next product over that
// 16-wide k block (``acc_to_a``): FlashAttention-2's P and dS never leave
// registers.
#pragma once

#include "hopper.cuh"

namespace tiles {

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a row-major
// matrix at ``base`` (``ld`` elements a row) -> dst[ROWS][COLS + 8],
// zero-filled past ``rows`` and ``cols`` (``cols`` a multiple of 8: a
// 16-byte chunk is wholly inside or outside).  Asynchronous (cp.async):
// the caller commits and waits.  A chunk outside reads nothing (``base``
// itself stands in as the mapped source address the instruction needs).
template <int ROWS, int COLS>
__device__ __forceinline__ void load_box(bf16* dst, const bf16* base, long row0, long col0,
                                         long ld, long rows, long cols) {
  constexpr int CH = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = row0 + r < rows && col0 + c < cols;
    cp_async16(dst + r * (COLS + 8) + c, ok ? base + (row0 + r) * ld + col0 + c : base, ok);
  }
}

// A at rows m0.., k columns k0.. of a tile stored [m][k]
__device__ __forceinline__ void frag_a_mk(uint32_t (&a)[4], const bf16* s, int ld, int m0,
                                          int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, s + (m0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}
// A at rows m0.., k columns k0.. of a tile stored [k][m] (A transposed)
__device__ __forceinline__ void frag_a_km(uint32_t (&a)[4], const bf16* s, int ld, int m0,
                                          int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(a, s + (k0 + lane % 8 + (lane / 16) * 8) * ld + m0 + ((lane / 8) % 2) * 8);
}
// B of the two n-tiles n0 and n0 + 8 at k rows k0..: b[0], b[1] feed n0,
// b[2], b[3] feed n0 + 8; tile stored [n][k]
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* s, int ld, int n0,
                                          int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, s + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8);
}
// the same from a tile stored [k][n]
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* s, int ld, int n0,
                                          int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, s + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8);
}

// acc[j][0..3] += A * (b[0], b[1]); acc[j + 1] += A * (b[2], b[3])
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
  mma_m16n8k16(c0, a, b[0], b[1]);
  mma_m16n8k16(c1, a, b[2], b[3]);
}

// the A fragment of k block j from the fp32 accumulators of n-tiles 2j
// and 2j + 1, rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

}  // namespace tiles
