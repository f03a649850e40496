// What every kernel of csrc/ shares: the block size of the probes, the
// complex product, and the opt-in to more than 48 KB of dynamic shared
// memory.  The FFT itself is the register FFT of fft_warp.cuh.
#pragma once

#include <cuda_runtime.h>

namespace ofdm {

constexpr int kThreads = 256;  // threads per block of the io probes

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Above 48 KB a kernel must opt in to its dynamic shared memory.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ofdm
