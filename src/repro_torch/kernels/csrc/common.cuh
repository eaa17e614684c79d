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
// chunks of 8 elements (nc a multiple of 8).  ``src`` points at the tile's
// first element, rows ``src_ld`` elements apart; rows >= rvalid and
// columns >= cvalid are zero-filled.  A chunk is one 16-byte load when it
// lies wholly inside the valid columns and the source rows are 16-byte
// aligned; otherwise (a ragged edge, or rows whose length is not a
// multiple of 8) its elements are read one by one.  Zero-filling matters:
// a stale NaN in a padding row of V or W would poison the products it
// meets (0 * NaN = NaN).
__device__ __forceinline__ void load_tile_bf16(
    bf16* dst, int dst_ld, const bf16* src, long src_ld,
    int nr, int nc, int rvalid, int cvalid) {
  const int chunks = nc / 8;
  const bool vec = src_ld % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int i = threadIdx.x; i < nr * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    union { uint4 u; unsigned short h[8]; } v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
    if (r < rvalid && c < cvalid) {
      const bf16* p = src + r * src_ld + c;
      if (vec && c + 8 <= cvalid) {
        v.u = *reinterpret_cast<const uint4*>(p);
      } else {
        const unsigned short* ph = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c + j < cvalid) v.h[j] = ph[j];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * dst_ld + c) = v.u;
  }
}

// Allow a kernel more than 48 KB of dynamic shared memory (up to the
// 227 KB a block can use on Hopper).  A refusal is returned, and cleared
// from the runtime's last-error slot so that the next launch's
// cudaGetLastError() does not report it again.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}
