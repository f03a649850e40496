// Split-phase data demod: per data symbol, FFT every antenna row, combine
// num = sum_a Y_a * hconj_a with the estimate ALREADY conjugated, and
// equalize eq = num * (1 / hsqrd).  The row is stored full width, [S, F],
// in true frequency order (DC bin included and meaningless); the caller
// finalizes it (mrc.finalize: DC drop + output ifftshift).
//
// Replaces ofdm_ls_mrc_tpu/ops/pallas_mrc.py:_fused_kernel (wrapper
// fused_demod), the reference's firstVector + demodOneSymbol data half.
// The TPU kernel ran a four-step DFT as fp32-HIGHEST MXU dots over
// antenna chunks sized to scoped VMEM and kept its output in a permuted
// [k1, k2] order, gathered back outside.  Here a group of NT threads runs
// the radix-2 Stockham FFT of csrc/fft.cuh on one row in shared memory,
// in natural order, and accumulates num in registers, F/NT bins per
// thread; there is no permutation to undo.
//
// Block shape: kThreads (256) threads hold G = 256/NT symbols, with
// NT = min(F/2, 256) threads per symbol: one butterfly per thread and
// stage up to F = 512.  At F = 64 a block holds 8 symbols (8 rows side by
// side), at F >= 512 one.  Grid: ceil(S / G) blocks; the groups of a
// ragged last block that hold no symbol run the barriers and store nothing.
// Rows are read through the caller's strides (a frame's data[..., cp:] is
// never copied); int16 sc16 planes are widened and scaled on load.
//
// Bound on this card: bytes.  At 16 antennas x 1024 x 100 symbols of f32
// a call reads 13.1 MB of rows plus 132 KB of estimate and writes 0.82 MB,
// about 4.2 us at 3.35 TB/s; its ~95 MFLOP (5 F log2 F per row FFT plus 8
// per MRC term) take 1.4 us at 67 TFLOP/s fp32.  As in fft_mrc.cu each row
// makes log2(F) barrier-separated passes through shared memory and 100
// symbols give 100 blocks for 132 SMs: a simple kernel first.

#include <cstdint>

#include "fft.cuh"

namespace ofdm {

// Threads per symbol row at size F.
template <int F>
__host__ __device__ constexpr int row_threads() {
  return F / 2 < kThreads ? F / 2 : kThreads;
}

template <int F>
__host__ __device__ constexpr size_t demod_smem_bytes() {
  return (static_cast<size_t>(kThreads / row_threads<F>()) * 2 * F + F / 2) *
         sizeof(float2);
}

template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
mrc_demod_kernel(const T* __restrict__ y_re, const T* __restrict__ y_im,
                 long long stride_s, long long stride_a, float scale, int S,
                 int A, const float* __restrict__ hc_re,
                 const float* __restrict__ hc_im, const float* __restrict__ hsqrd,
                 const float2* __restrict__ tw, float* __restrict__ out_re,
                 float* __restrict__ out_im) {
  constexpr int NT = row_threads<F>();
  constexpr int G = kThreads / NT;  // symbols per block
  constexpr int kBins = F / NT;     // bins a thread accumulates
  extern __shared__ float2 smem[];
  const int g = threadIdx.x / NT;
  const int lane = threadIdx.x % NT;
  float2* a = smem + g * 2 * F;
  float2* b = a + F;
  float2* tw_s = smem + G * 2 * F;
  const int s = blockIdx.x * G + g;
  const bool live = s < S;
  const long long sym = live ? s * stride_s : 0;

  load_twiddles<F>(tw_s, tw);
  float num_re[kBins], num_im[kBins];
#pragma unroll
  for (int r = 0; r < kBins; ++r) num_re[r] = num_im[r] = 0.0f;

  for (int ant = 0; ant < A; ++ant) {
    if (live) {
      const long long off = sym + ant * stride_a;
      load_row_lanes<F, NT, T>(a, y_re + off, y_im + off, scale, lane);
    }
    __syncthreads();
    const float2* y = stockham_fft_lanes<F, NT>(a, b, tw_s, lane);
    const float* hr = hc_re + static_cast<long long>(ant) * F;
    const float* hi = hc_im + static_cast<long long>(ant) * F;
#pragma unroll
    for (int r = 0; r < kBins; ++r) {
      const int t = lane + r * NT;
      const float2 v = y[t];
      const float cr = hr[t], ci = hi[t];
      num_re[r] += v.x * cr - v.y * ci;  // Y * hconj (already conjugated)
      num_im[r] += v.x * ci + v.y * cr;
    }
    __syncthreads();  // the next row's load overwrites a
  }

  if (!live) return;
  const long long row = static_cast<long long>(s) * F;
#pragma unroll
  for (int r = 0; r < kBins; ++r) {
    const int t = lane + r * NT;
    const float g_inv = 1.0f / hsqrd[t];
    out_re[row + t] = num_re[r] * g_inv;
    out_im[row + t] = num_im[r] * g_inv;
  }
}

template <int F, typename T>
cudaError_t launch_mrc_demod(const void* y_re, const void* y_im, long long stride_s,
                             long long stride_a, float scale, int S, int A,
                             const float* hc_re, const float* hc_im,
                             const float* hsqrd, const float* tw, float* out_re,
                             float* out_im, cudaStream_t stream) {
  auto kernel = mrc_demod_kernel<F, T>;
  constexpr int G = kThreads / row_threads<F>();
  const size_t smem = demod_smem_bytes<F>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(S + G - 1) / G, kThreads, smem, stream>>>(
      static_cast<const T*>(y_re), static_cast<const T*>(y_im), stride_s, stride_a,
      scale, S, A, hc_re, hc_im, hsqrd, reinterpret_cast<const float2*>(tw), out_re,
      out_im);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mrc_demod(int F, const void* y_re, const void* y_im,
                               long long stride_s, long long stride_a, float scale,
                               int S, int A, const float* hc_re, const float* hc_im,
                               const float* hsqrd, const float* tw, float* out_re,
                               float* out_im, cudaStream_t stream) {
#define OFDM_MRC_DEMOD_CASE(N)                                                    \
  case N:                                                                         \
    return launch_mrc_demod<N, T>(y_re, y_im, stride_s, stride_a, scale, S, A,    \
                                  hc_re, hc_im, hsqrd, tw, out_re, out_im, stream);
  switch (F) {
    OFDM_MRC_DEMOD_CASE(64)
    OFDM_MRC_DEMOD_CASE(128)
    OFDM_MRC_DEMOD_CASE(256)
    OFDM_MRC_DEMOD_CASE(512)
    OFDM_MRC_DEMOD_CASE(1024)
    OFDM_MRC_DEMOD_CASE(2048)
    OFDM_MRC_DEMOD_CASE(4096)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_MRC_DEMOD_CASE
}

}  // namespace ofdm

// Data rows: y_re/y_im point at row (s=0, a=0) of S x A rows of F samples,
// row (s, a) at element offset s*stride_s + a*stride_a; int16 when in_int16
// (scaled by `scale`), float32 otherwise.  hc_re/hc_im: [A, F] conjugated
// estimate, hsqrd: [F], true order.  tw: [F/2] float2 twiddles.  Outputs
// out_re/out_im: [S, F], true order.  Returns the cudaError_t of the launch.
extern "C" int ofdm_mrc_demod(const void* y_re, const void* y_im, int in_int16,
                              long long stride_s, long long stride_a, float scale,
                              int S, int A, int F, const float* hc_re,
                              const float* hc_im, const float* hsqrd, const float* tw,
                              float* out_re, float* out_im, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      in_int16 ? ofdm::dispatch_mrc_demod<int16_t>(F, y_re, y_im, stride_s, stride_a,
                                                   scale, S, A, hc_re, hc_im, hsqrd,
                                                   tw, out_re, out_im, st)
               : ofdm::dispatch_mrc_demod<float>(F, y_re, y_im, stride_s, stride_a,
                                                 scale, S, A, hc_re, hc_im, hsqrd,
                                                 tw, out_re, out_im, st);
  return static_cast<int>(err);
}
