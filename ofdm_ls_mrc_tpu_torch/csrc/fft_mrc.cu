// Data symbols of K frames: per symbol, FFT every antenna row, combine
// num = sum_a Y_a * conj(h_a), equalize eq = num * inv, and store the
// (F-1)-wide row in the reference's output order.
//
// Replaces ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:_kernel (wrapper
// fused_pipeline, default schedule g2, exact) together with its XLA epilogue
// to_reference_order.  Grid (S, K): one block per data symbol of one frame.
// The block loops over the A antennas: it loads the row (float32, or int16
// sc16 planes widened and scaled on load) through the caller's strides, so
// a frame that still carries its cyclic prefix, or whose pilot row comes
// first, is read in place and never copied; it FFTs the row in shared
// memory (csrc/fft.cuh) and accumulates num in registers, F/256 bins per
// thread.  The store writes out[j] = eq[1 + (j + (F-1)/2) mod (F-1)]: the
// DC drop and the output ifftshift (shiftOneRow, cpuLS.hpp:368).
//
// Bound on this card: a data symbol's input is 64 KB in sc16 (128 KB in
// f32), read from device memory once; a frame (16 antennas x 1024 x 100
// data symbols) is 6.6 MB of sc16 in and 0.82 MB out, about 2.2 us at
// 3.35 TB/s.  The FFT work is ~80 MFLOP per frame, far under the fp32 rate,
// but each row makes 10 passes through shared memory with a barrier each,
// and one frame gives only 100 blocks for 132 SMs, so K frames go through
// one launch (UplinkReceiver.demod_capture).  The channel estimate h
// (16 x 1024 x 8 B = 128 KB per frame) is read from L2 by every block of
// the frame: the first thing a later optimisation looks at, together with
// overlapping the next row's load with the current row's FFT.

#include <cstdint>

#include "fft.cuh"

namespace ofdm {

template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
fft_mrc_kernel(const T* __restrict__ y_re, const T* __restrict__ y_im,
               long long stride_k, long long stride_s, long long stride_a,
               float scale, int A, const float* __restrict__ h_re,
               const float* __restrict__ h_im, const float* __restrict__ inv,
               const float2* __restrict__ tw, float* __restrict__ out_re,
               float* __restrict__ out_im) {
  constexpr int kBins = F / kThreads;  // bins a thread accumulates
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + F;
  float2* tw_s = smem + 2 * F;
  const int s = blockIdx.x;
  const int k = blockIdx.y;
  const long long sym = k * stride_k + s * stride_s;
  const float* hr_k = h_re + static_cast<long long>(k) * A * F;
  const float* hi_k = h_im + static_cast<long long>(k) * A * F;

  load_twiddles<F>(tw_s, tw);
  float num_re[kBins], num_im[kBins];
#pragma unroll
  for (int r = 0; r < kBins; ++r) num_re[r] = num_im[r] = 0.0f;

  for (int ant = 0; ant < A; ++ant) {
    const long long off = sym + ant * stride_a;
    load_row<F, T>(a, y_re + off, y_im + off, scale);
    __syncthreads();
    const float2* y = stockham_fft<F>(a, b, tw_s);
    const float* hr = hr_k + static_cast<long long>(ant) * F;
    const float* hi = hi_k + static_cast<long long>(ant) * F;
#pragma unroll
    for (int r = 0; r < kBins; ++r) {
      const int t = threadIdx.x + r * kThreads;
      const float2 v = y[t];
      const float cr = hr[t], ci = hi[t];
      num_re[r] += v.x * cr + v.y * ci;  // Y * conj(h)
      num_im[r] += v.y * cr - v.x * ci;
    }
    __syncthreads();  // the next row's load overwrites a
  }

  const float* inv_k = inv + static_cast<long long>(k) * F;
  const long long row = (static_cast<long long>(k) * gridDim.x + s) * (F - 1);
#pragma unroll
  for (int r = 0; r < kBins; ++r) {
    const int t = threadIdx.x + r * kThreads;
    if (t == 0) continue;  // DC bin
    int j = t - F / 2;
    if (j < 0) j += F - 1;
    const float g = inv_k[t];
    out_re[row + j] = num_re[r] * g;
    out_im[row + j] = num_im[r] * g;
  }
}

template <int F, typename T>
cudaError_t launch_fft_mrc(const void* y_re, const void* y_im, long long stride_k,
                           long long stride_s, long long stride_a, float scale,
                           int K, int S, int A, const float* h_re,
                           const float* h_im, const float* inv, const float* tw,
                           float* out_re, float* out_im, cudaStream_t stream) {
  auto kernel = fft_mrc_kernel<F, T>;
  const size_t smem = smem_bytes<F>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(S, K), kThreads, smem, stream>>>(
      static_cast<const T*>(y_re), static_cast<const T*>(y_im), stride_k, stride_s,
      stride_a, scale, A, h_re, h_im, inv, reinterpret_cast<const float2*>(tw),
      out_re, out_im);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fft_mrc(int F, const void* y_re, const void* y_im,
                             long long stride_k, long long stride_s,
                             long long stride_a, float scale, int K, int S, int A,
                             const float* h_re, const float* h_im,
                             const float* inv, const float* tw, float* out_re,
                             float* out_im, cudaStream_t stream) {
#define OFDM_FFT_MRC_CASE(N)                                                  \
  case N:                                                                     \
    return launch_fft_mrc<N, T>(y_re, y_im, stride_k, stride_s, stride_a,     \
                                scale, K, S, A, h_re, h_im, inv, tw, out_re,  \
                                out_im, stream);
  switch (F) {
    OFDM_FFT_MRC_CASE(256)
    OFDM_FFT_MRC_CASE(512)
    OFDM_FFT_MRC_CASE(1024)
    OFDM_FFT_MRC_CASE(2048)
    OFDM_FFT_MRC_CASE(4096)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_FFT_MRC_CASE
}

}  // namespace ofdm

// Data rows: y_re/y_im point at row (k=0, s=0, a=0) of K x S x A rows of F
// samples, row (k, s, a) at element offset k*stride_k + s*stride_s +
// a*stride_a; int16 when in_int16 (scaled by `scale`), float32 otherwise.
// h_re/h_im: [K, A, F] unconjugated estimate, inv: [K, F], natural order.
// tw: [F/2] float2 twiddles.  Outputs out_re/out_im: [K, S, F-1] in
// reference order.  Returns the cudaError_t of the launch.
extern "C" int ofdm_fft_mrc(const void* y_re, const void* y_im, int in_int16,
                            long long stride_k, long long stride_s,
                            long long stride_a, float scale, int K, int S, int A,
                            int F, const float* h_re, const float* h_im,
                            const float* inv, const float* tw, float* out_re,
                            float* out_im, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      in_int16 ? ofdm::dispatch_fft_mrc<int16_t>(F, y_re, y_im, stride_k, stride_s,
                                                 stride_a, scale, K, S, A, h_re,
                                                 h_im, inv, tw, out_re, out_im, st)
               : ofdm::dispatch_fft_mrc<float>(F, y_re, y_im, stride_k, stride_s,
                                               stride_a, scale, K, S, A, h_re, h_im,
                                               inv, tw, out_re, out_im, st);
  return static_cast<int>(err);
}
