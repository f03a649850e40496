// Pilot LS channel estimate for K frames: FFT of each pilot row, then
// h = Y * conj(X) / |X|^2 and inv = 1 / sum_a |h|^2.
//
// Replaces ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:_pilot_kernel (wrapper
// estimate_pilot_fused).  The TPU kernel ran one program over all antennas
// and reduced sum_a |h|^2 in VMEM; blocks on the GPU cannot carry a sum
// across each other, so the work is two launches of this one kernel:
//   launch 1, grid (A, K): one block FFTs one pilot row in shared memory
//     (csrc/fft.cuh) and writes h[k, a, :], unconjugated, natural order;
//   launch 2, grid (F/256, K): one thread per bin sums |h|^2 over the A
//     antennas and writes inv[k, :].
// As in the TPU fused path the DC bin is not masked: X[0] = 1 and the data
// kernel drops that bin at its store.
//
// Bound on this card: tiny.  At 16 antennas x 1024 bins one frame reads
// 128 KB of f32 pilot (64 KB sc16) and writes 132 KB, in 16 + 4 blocks, so
// the cost is launch latency and one block's serial FFT (10 stages with a
// barrier each).  Design: the pilot is read in place from the frame through
// its strides (no slice copy), and int16 planes are widened on load.

#include <cstdint>

#include "fft.cuh"

namespace ofdm {

template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
pilot_ls_kernel(const T* __restrict__ y_re, const T* __restrict__ y_im,
                long long stride_k, long long stride_a, float scale,
                const float* __restrict__ x_re, const float* __restrict__ x_im,
                const float2* __restrict__ tw, float* __restrict__ h_re,
                float* __restrict__ h_im) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + F;
  float2* tw_s = smem + 2 * F;
  const int ant = blockIdx.x;
  const int k = blockIdx.y;
  const long long off = k * stride_k + ant * stride_a;

  load_twiddles<F>(tw_s, tw);
  load_row<F, T>(a, y_re + off, y_im + off, scale);
  __syncthreads();
  const float2* y = stockham_fft<F>(a, b, tw_s);

  const long long row = (static_cast<long long>(k) * gridDim.x + ant) * F;
  for (int t = threadIdx.x; t < F; t += kThreads) {
    const float2 v = y[t];
    const float xr = x_re[t], xi = x_im[t];
    const float den = 1.0f / (xr * xr + xi * xi);
    h_re[row + t] = (v.x * xr + v.y * xi) * den;
    h_im[row + t] = (v.y * xr - v.x * xi) * den;
  }
}

__global__ void __launch_bounds__(kThreads)
inv_norm_kernel(const float* __restrict__ h_re, const float* __restrict__ h_im,
                int A, int F, float* __restrict__ inv) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (t >= F) return;
  const float* hr = h_re + static_cast<long long>(k) * A * F + t;
  const float* hi = h_im + static_cast<long long>(k) * A * F + t;
  float s = 0.0f;
  for (int ant = 0; ant < A; ++ant) {
    const float r = hr[static_cast<long long>(ant) * F];
    const float i = hi[static_cast<long long>(ant) * F];
    s += r * r + i * i;
  }
  inv[static_cast<long long>(k) * F + t] = 1.0f / s;
}

template <int F, typename T>
cudaError_t launch_pilot(const void* y_re, const void* y_im, long long stride_k,
                         long long stride_a, float scale, int K, int A,
                         const float* x_re, const float* x_im, const float* tw,
                         float* h_re, float* h_im, cudaStream_t stream) {
  auto kernel = pilot_ls_kernel<F, T>;
  const size_t smem = smem_bytes<F>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(A, K), kThreads, smem, stream>>>(
      static_cast<const T*>(y_re), static_cast<const T*>(y_im), stride_k, stride_a,
      scale, x_re, x_im, reinterpret_cast<const float2*>(tw), h_re, h_im);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pilot(int F, const void* y_re, const void* y_im,
                           long long stride_k, long long stride_a, float scale,
                           int K, int A, const float* x_re, const float* x_im,
                           const float* tw, float* h_re, float* h_im,
                           cudaStream_t stream) {
#define OFDM_PILOT_CASE(N)                                                         \
  case N:                                                                          \
    return launch_pilot<N, T>(y_re, y_im, stride_k, stride_a, scale, K, A, x_re, \
                              x_im, tw, h_re, h_im, stream);
  switch (F) {
    OFDM_PILOT_CASE(256)
    OFDM_PILOT_CASE(512)
    OFDM_PILOT_CASE(1024)
    OFDM_PILOT_CASE(2048)
    OFDM_PILOT_CASE(4096)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_PILOT_CASE
}

}  // namespace ofdm

// Pilot rows: y_re/y_im point at row (k=0, a=0) of K x A rows of F samples,
// row (k, a) at element offset k*stride_k + a*stride_a; int16 when in_int16
// (scaled by `scale`), float32 otherwise.  x_re/x_im: [F] padded pilot,
// natural order.  tw: [F/2] float2 twiddles.  Outputs h_re/h_im [K, A, F] and
// inv [K, F].  Returns the cudaError_t of the launches.
extern "C" int ofdm_pilot_ls(const void* y_re, const void* y_im, int in_int16,
                             long long stride_k, long long stride_a, float scale,
                             int K, int A, int F, const float* x_re,
                             const float* x_im, const float* tw, float* h_re,
                             float* h_im, float* inv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      in_int16 ? ofdm::dispatch_pilot<int16_t>(F, y_re, y_im, stride_k, stride_a,
                                               scale, K, A, x_re, x_im, tw, h_re,
                                               h_im, s)
               : ofdm::dispatch_pilot<float>(F, y_re, y_im, stride_k, stride_a,
                                             scale, K, A, x_re, x_im, tw, h_re,
                                             h_im, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  ofdm::inv_norm_kernel<<<dim3((F + ofdm::kThreads - 1) / ofdm::kThreads, K),
                          ofdm::kThreads, 0, s>>>(h_re, h_im, A, F, inv);
  return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t returned by the entry points.
extern "C" const char* ofdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
