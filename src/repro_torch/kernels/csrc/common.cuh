// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel is built on its own by kernels/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so <name>.cu
// and bound with ctypes.  Each C entry point launches on the stream it is
// given (PyTorch's current stream), allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Copy an (nr x nc) tile of a row-major bf16 matrix into shared memory in
// 16-byte chunks of 8 elements.  ``src`` points at the tile's first
// element, rows ``src_ld`` elements apart; rows >= rvalid and columns >=
// cvalid are zero-filled (cvalid and nc are multiples of 8, so a chunk is
// wholly in or out).  Zero-filling matters: a stale NaN in a padding row
// of V or W would poison the products it meets (0 * NaN = NaN).
__device__ __forceinline__ void load_tile_bf16(
    bf16* dst, int dst_ld, const bf16* src, long src_ld,
    int nr, int nc, int rvalid, int cvalid) {
  const int chunks = nc / 8;
  for (int i = threadIdx.x; i < nr * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rvalid && c < cvalid) {
      v = *reinterpret_cast<const uint4*>(src + r * src_ld + c);
    }
    *reinterpret_cast<uint4*>(dst + r * dst_ld + c) = v;
  }
}

// Allow a kernel more than 48 KB of dynamic shared memory (up to the
// 227 KB a block can use on Hopper).
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
