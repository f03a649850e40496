// Split-phase data demod: per data symbol, FFT every antenna row, combine
// num = sum_a Y_a * hconj_a with the estimate ALREADY conjugated, and
// equalize eq = num * (1 / hsqrd).  The row is stored full width, [S, F],
// in true frequency order (DC bin included and meaningless); the caller
// finalizes it (mrc.finalize: DC drop + output ifftshift).
//
// Replaces ofdm_ls_mrc_tpu/ops/pallas_mrc.py:_fused_kernel (:62, wrapper
// fused_demod :136), the reference's firstVector + demodOneSymbol data half.
// The TPU kernel ran a four-step DFT as fp32-HIGHEST MXU dots over antenna
// chunks sized to scoped VMEM and kept its output in a permuted [k1, k2]
// order, gathered back outside.  Here the rows go through the register FFT
// of csrc/fft_warp.cuh (the same teams, pipeline and exchange as
// fft_mrc.cu), whose bins land in natural order: no permutation to undo.
// F from 64 to 4096: below F = 1024 a team is 8 or 16 lanes and a block of
// 128 threads holds 2 (F = 256, 512) or 4 (F = 64, 128) symbols, so each
// h row a team reads serves that many symbols from L1.
//
// Bound on this card: bytes, as fft_mrc.cu: 16 antennas x 1024 x 100 f32
// symbols read 13.1 MB of rows plus 0.13 MB of estimate and write 0.82 MB,
// 4.2 us at 3.35 TB/s; ~95 MFLOP, 1.4 us at 67 TFLOP/s, but ~1,650
// instructions a row and thread, so issue and latency set the time.  h is
// 12.8 MB of L2 reads per frame at F = 1024 (one symbol per block).  ptxas
// (sm_90a): 222-227 registers at F = 1024, no spills,
// 75,776 B a block; F = 64: 80-85 registers, 19,456 B, 4 symbols a block;
// F = 2048 with aligned rows spills 220-280 B at 255 registers.

#include <cstdint>

#include "fft_warp.cuh"

namespace ofdm {

template <int F, typename T, bool kAligned>
__global__ void __launch_bounds__(wfft::Plan<F>::kBlock, wfft::Plan<F>::kMinBlocks)
mrc_demod_kernel(const T* __restrict__ y_re, const T* __restrict__ y_im,
                 long long stride_s, long long stride_a, float scale, int S,
                 int A, const float* __restrict__ hc_re,
                 const float* __restrict__ hc_im, const float* __restrict__ hsqrd,
                 const float2* __restrict__ tw, float* __restrict__ out_re,
                 float* __restrict__ out_im) {
  using G_ = wfft::Geo<F>;
  extern __shared__ float4 smem4[];
  const wfft::Smem<F> sm(smem4);
  const wfft::Team<G_::T> team;
  const int g = team.id / G_::P;  // symbol of the block
  const int p = team.id % G_::P;  // team of the symbol
  const int s = blockIdx.x * G_::G + g;
  const bool live = s < S;
  const long long sym = static_cast<long long>(live ? s : 0) * stride_s;

  wfft::team_rows<F, T, kAligned, false>(y_re + sym, y_im + sym, stride_a, A, p, live,
                                         hc_re, hc_im, tw, sm, team);
  __syncthreads();
  if (!live) return;

  const long long row = static_cast<long long>(s) * F;
  for (int t = p * G_::T + team.j; t < F; t += G_::P * G_::T) {
    const float2 num = wfft::partial_sum<F>(sm, g, t);
    const float gain = scale / hsqrd[t];
    out_re[row + t] = num.x * gain;
    out_im[row + t] = num.y * gain;
  }
}

template <int F, typename T, bool kAligned>
cudaError_t launch_mrc_demod(const void* y_re, const void* y_im, long long stride_s,
                             long long stride_a, float scale, int S, int A,
                             const float* hc_re, const float* hc_im,
                             const float* hsqrd, const float* tw, float* out_re,
                             float* out_im, cudaStream_t stream) {
  using G_ = wfft::Geo<F>;
  auto kernel = mrc_demod_kernel<F, T, kAligned>;
  cudaError_t err = allow_smem(kernel, G_::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(S + G_::G - 1) / G_::G, G_::kBlock, G_::kSmemBytes, stream>>>(
      static_cast<const T*>(y_re), static_cast<const T*>(y_im), stride_s, stride_a,
      scale, S, A, hc_re, hc_im, hsqrd,
      reinterpret_cast<const float2*>(tw), out_re, out_im);
  return cudaGetLastError();
}

template <typename T, bool kAligned>
cudaError_t dispatch_mrc_demod(int F, const void* y_re, const void* y_im,
                               long long stride_s, long long stride_a, float scale,
                               int S, int A, const float* hc_re, const float* hc_im,
                               const float* hsqrd, const float* tw, float* out_re,
                               float* out_im, cudaStream_t stream) {
#define OFDM_MRC_DEMOD_CASE(N)                                                   \
  case N:                                                                        \
    return launch_mrc_demod<N, T, kAligned>(y_re, y_im, stride_s, stride_a,      \
                                            scale, S, A, hc_re, hc_im, hsqrd,    \
                                            tw, out_re, out_im, stream);
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
// (scaled by `scale`), float32 otherwise.  aligned: every row starts 16-byte
// aligned (bases and strides in bytes multiples of 16), which selects the
// cp.async load path.  hc_re/hc_im: [A, F] conjugated estimate, hsqrd: [F],
// true order.  tw: the pass twiddles of ops/fft_plan.py.  Outputs
// out_re/out_im: [S, F], true order.  Returns the cudaError_t of the launch.
extern "C" int ofdm_mrc_demod(const void* y_re, const void* y_im, int in_int16,
                              int aligned, long long stride_s, long long stride_a,
                              float scale, int S, int A, int F, const float* hc_re,
                              const float* hc_im, const float* hsqrd, const float* tw,
                              float* out_re, float* out_im, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto dispatch) {
    return dispatch(F, y_re, y_im, stride_s, stride_a, scale, S, A, hc_re, hc_im, hsqrd,
                    tw, out_re, out_im, st);
  };
  cudaError_t err;
  if (in_int16) {
    err = aligned ? run(ofdm::dispatch_mrc_demod<int16_t, true>)
                  : run(ofdm::dispatch_mrc_demod<int16_t, false>);
  } else {
    err = aligned ? run(ofdm::dispatch_mrc_demod<float, true>)
                  : run(ofdm::dispatch_mrc_demod<float, false>);
  }
  return static_cast<int>(err);
}
