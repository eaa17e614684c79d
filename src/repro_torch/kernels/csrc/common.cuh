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
