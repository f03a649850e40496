// Block-level F-point complex FFT in shared memory (radix-2 Stockham).
//
// Used by pilot_ls.cu (the data kernels run the register FFT of
// fft_warp.cuh).  A group of NT threads (the whole block of kThreads in
// pilot_ls.cu) transforms one row of F complex samples held in shared
// memory as float2 (re, im):
// log2(F) radix-2 Stockham stages ping-pong between two F-long buffers, so
// the output lands in natural frequency order with no bit-reversal pass.
// The transform is the unnormalized forward DFT (== np.fft.fft).
//
// Twiddles come from a table of F/2 values exp(-2*pi*i*m/F), m < F/2,
// computed on the host in float64 and stored as float32 (no __sinf/__cosf,
// no fast-math), which keeps the transform fp32-grade: the kernels agree
// with torch.fft to a few 1e-7 of the peak.
//
// Stage with half-span p (p = 1, 2, 4, ..., F/2), for each butterfly
// i in [0, F/2):
//   k = i mod p,  w = exp(-2*pi*i*k / (2p)) = tw[k * F/(2p)]
//   u0 = a[i],  u1 = a[i + F/2] * w
//   b[2i - k] = u0 + u1,  b[2i - k + p] = u0 - u1
#pragma once

#include <cuda_runtime.h>

namespace ofdm {

constexpr int kThreads = 256;  // threads per block of every kernel

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Loads F/2 twiddles from device memory into shared memory.
template <int F>
__device__ __forceinline__ void load_twiddles(float2* __restrict__ tw_s,
                                              const float2* __restrict__ tw) {
  for (int i = threadIdx.x; i < F / 2; i += kThreads) tw_s[i] = tw[i];
}

// Loads one row of F samples from planar re/im device memory into a,
// scaled by `scale` (1/32767 for int16 sc16 planes, 1 for float32).  The
// NT threads of a group share the row; `lane` is the thread's index in it.
template <int F, int NT, typename T>
__device__ __forceinline__ void load_row_lanes(float2* __restrict__ a,
                                               const T* __restrict__ re,
                                               const T* __restrict__ im,
                                               float scale, int lane) {
  for (int i = lane; i < F; i += NT) {
    a[i] = make_float2(static_cast<float>(re[i]) * scale,
                       static_cast<float>(im[i]) * scale);
  }
}

template <int F, typename T>
__device__ __forceinline__ void load_row(float2* __restrict__ a,
                                         const T* __restrict__ re,
                                         const T* __restrict__ im, float scale) {
  load_row_lanes<F, kThreads, T>(a, re, im, scale, threadIdx.x);
}

// Transforms the row in a, using b as scratch, with the NT threads of a
// group.  Every thread of the block calls it (it holds block barriers), so
// groups of one block transform their rows side by side.  Call with a
// fully written and synchronised; returns the buffer (a or b) that holds
// the result, synchronised and ready to read.
template <int F, int NT>
__device__ __forceinline__ float2* stockham_fft_lanes(float2* a, float2* b,
                                                      const float2* __restrict__ tw_s,
                                                      int lane) {
  int tstride = F / 2;
#pragma unroll
  for (int p = 1; p < F; p <<= 1) {
    for (int i = lane; i < F / 2; i += NT) {
      const int k = i & (p - 1);
      const float2 u0 = a[i];
      const float2 u1 = cmul(a[i + F / 2], tw_s[k * tstride]);
      const int j = (i << 1) - k;
      b[j] = make_float2(u0.x + u1.x, u0.y + u1.y);
      b[j + p] = make_float2(u0.x - u1.x, u0.y - u1.y);
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    tstride >>= 1;
  }
  return a;
}

template <int F>
__device__ __forceinline__ float2* stockham_fft(float2* a, float2* b,
                                                const float2* __restrict__ tw_s) {
  return stockham_fft_lanes<F, kThreads>(a, b, tw_s, threadIdx.x);
}

// Dynamic shared memory of one block: two F-long row buffers + F/2 twiddles.
template <int F>
constexpr size_t smem_bytes() {
  return (2 * F + F / 2) * sizeof(float2);
}

// Above 48 KB a kernel must opt in to its dynamic shared memory.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ofdm
