// The column pass of the split form (fft_split.cuh): for every antenna row
// of a chunk of symbols, the n1-point DFT over i1 of each column i2 of
// x[i1, i2] = x[128 i1 + i2], times exp(-2 pi i k1 i2 / F), into the
// scratch row B[k1][i2].  The first half of the four-step FFT that the
// exact pilots run at F = 16384 and 32768 and the speed kernels at 8192
// to 32768 (their stage 1: the TPU kernel's n1-point DFT and twiddle); the
// exact data kernels run the same body (fft_split.cuh column_load,
// column_run) as the column tiles of their ring.
//
// Grid (128 / C, n A): a block of 256 threads is one column tile
// (fft_split.cuh column_load + column_run), C = 256 / T
// consecutive columns of one antenna row (the n1-point register FFT's team
// of T lanes, one a column: 32 columns at n1 = 64 and 128, 16 at 256), two
// blocks an SM.
//
// Bound: bytes.  A 16 x 32768 f32 symbol reads 4.2 MB and writes 4.2 MB of
// scratch; 5 n1 log2 n1 + 6 FLOP a column sample is far under the fp32
// rate.  ptxas: see chip_smoke.py phase 15.

#include <cstdint>

#include "fft_split.cuh"

namespace ofdm {
namespace split {

template <int N1, typename E>
__global__ void __launch_bounds__(kColumnThreads, kColumnBlocks)
column_pass_kernel(const E* __restrict__ y_re, const E* __restrict__ y_im,
                   long long stride_k, long long stride_s, long long stride_a, int S, int A,
                   long long item0, const float2* __restrict__ tw, float* __restrict__ b_re,
                   float* __restrict__ b_im) {
  constexpr int F = N1 * kN2;
  extern __shared__ float4 smem4[];
  const long long r = blockIdx.y;  // row of the chunk: (item - item0) A + a
  const long long item = item0 + r / A;
  const int a = static_cast<int>(r % A);
  const long long off = (item / S) * stride_k + (item % S) * stride_s + a * stride_a;
  float* const smem = reinterpret_cast<float*>(smem4);
  const int c0 = blockIdx.x * columns<N1>();
  if (threadIdx.x < wfft::Geo<N1>::kTwiddles * 8 / 128) {  // the FFT's pass twiddles into L1
    asm volatile("prefetch.global.L1 [%0];" ::"l"(tw + 16 * threadIdx.x));
  }
  float2 fw[3];
  column_load<N1, E, false>(y_re + off, y_im + off, c0, tw + four_tw_offset<N1>(), fw, smem, 0);
  column_run<N1>(c0, tw, fw, b_re + r * F, b_im + r * F, smem, []() {}, []() {}, []() {});
}

template <int N1, typename E>
cudaError_t launch_column(const void* y_re, const void* y_im, long long stride_k,
                          long long stride_s, long long stride_a, int S, int A,
                          long long item0, int n, const float2* tw, float* b_re, float* b_im,
                          cudaStream_t stream) {
  auto kernel = column_pass_kernel<N1, E>;
  constexpr size_t bytes = column_smem_bytes<N1>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(n) * A > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(kN2 / columns<N1>(), n * A), kColumnThreads, bytes, stream>>>(
      static_cast<const E*>(y_re), static_cast<const E*>(y_im), stride_k, stride_s, stride_a,
      S, A, item0, tw, b_re, b_im);
  return cudaGetLastError();
}

cudaError_t column_pass(int n1, bool int16, const void* y_re, const void* y_im,
                        long long stride_k, long long stride_s, long long stride_a, int S,
                        int A, long long item0, int n, const float2* tw, float* b_re,
                        float* b_im, cudaStream_t stream) {
#define OFDM_COLUMN_CASE(N)                                                                \
  case N:                                                                                  \
    return int16 ? launch_column<N, int16_t>(y_re, y_im, stride_k, stride_s, stride_a, S, \
                                             A, item0, n, tw, b_re, b_im, stream)          \
                 : launch_column<N, float>(y_re, y_im, stride_k, stride_s, stride_a, S,   \
                                           A, item0, n, tw, b_re, b_im, stream);
  switch (n1) {
    OFDM_COLUMN_CASE(64)
    OFDM_COLUMN_CASE(128)
    OFDM_COLUMN_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_COLUMN_CASE
}

}  // namespace split
}  // namespace ofdm
