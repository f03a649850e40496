// Data symbols of K frames: per symbol, FFT every antenna row, combine
// num = sum_a Y_a * conj(h_a), equalize eq = num * inv, and store the
// (F-1)-wide row in the reference's output order.
//
// Replaces ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:_kernel (:320, wrapper
// fused_pipeline :753, default schedule g2, exact) together with its XLA
// epilogue to_reference_order (:682).  Grid (ceil(S / G), K); the row
// mapping, the register FFT and the load pipeline are csrc/fft_warp.cuh's.
// At F = 1024 a block of 128 threads is one symbol: four one-warp teams, team
// p taking antennas p, p + 4, ... (four rows each at 16 antennas).  Rows are
// read in place through the caller's strides (a frame that still carries its
// cyclic prefix or its pilot row is never copied); an odd prefix takes the
// element-by-element load path.  The store writes
// out[j] = eq[1 + (j + (F-1)/2) mod (F-1)]: the DC drop and the output
// ifftshift (shiftOneRow, cpuLS.hpp:368), and scales by inv (and 1/32767
// for sc16 rows, taken out of the row reads).
//
// Bound on this card: bytes.  One f32 frame (16 x 1024 x 100 symbols) reads
// 13.1 MB of rows and 0.13 MB of estimate and writes 0.82 MB: 4.2 us at
// 3.35 TB/s, 5.0 us at the measured io floor; an sc16 frame 7.4 MB, 2.2 us.
// Its ~95 MFLOP take 1.4 us at 67 TFLOP/s, but the FFT's additions do not
// pair into FMAs: a row costs ~1,650 instructions a thread (3,872 SASS
// instructions in the <1024, int16> kernel, which holds the row body
// twice), ~2.6 M warp-instructions a frame, ~2.5 us at one issue per
// scheduler and clock, so issue and latency, not bytes, set the time.
// What the design does, against the previous kernel (one block of 256
// threads per symbol, the 16 rows in sequence through the shared-memory
// radix-2 FFT of fft.cuh):
//   - the antennas run on four teams side by side, not in sequence;
//   - a row pays four __syncwarp and no block barrier (before: eleven block
//     barriers a row); a symbol pays two __syncthreads;
//   - row i+1's cp.async copy is in flight during row i's FFT, and h's row
//     is prefetched into L1 with it;
//   - the exchange slot e + e / M makes each pass's transpose free of bank
//     conflicts, and the twiddle reads are consecutive (before: 4- to 16-way
//     conflicts on tw_s[k * tstride]);
//   - h: every block still reads all A rows of its frame, 12.8 MB of L2
//     reads per f32 frame, as before.  Two symbols per block would halve
//     that, but measured slower (PERF.md);
//   - one frame still gives 100 blocks for 132 SMs; a symbol's 16 rows are 4
//     per team in sequence, also at S = 1 (the streaming shape).
// ptxas (sm_90a): 223-226 registers at F = 1024 (254 for f32 rows on the
// element path), no spills; 75,776 B of dynamic shared memory a block, so 2 blocks (8 warps)
// per SM.  F = 4096: 256 threads, 172,032 B, 1 block per SM.

#include <cstdint>

#include "fft_warp.cuh"

namespace ofdm {

template <int F, typename T, bool kAligned>
__global__ void __launch_bounds__(wfft::Plan<F>::kBlock, wfft::Plan<F>::kMinBlocks)
fft_mrc_kernel(const T* __restrict__ y_re, const T* __restrict__ y_im,
               long long stride_k, long long stride_s, long long stride_a,
               float scale, int S, int A, const float* __restrict__ h_re,
               const float* __restrict__ h_im, const float* __restrict__ inv,
               const float2* __restrict__ tw, float* __restrict__ out_re,
               float* __restrict__ out_im) {
  using G_ = wfft::Geo<F>;
  extern __shared__ float4 smem4[];
  const wfft::Smem<F> sm(smem4);
  const wfft::Team<G_::T> team;
  const int g = team.id / G_::P;  // symbol of the block
  const int p = team.id % G_::P;  // team of the symbol
  const int s = blockIdx.x * G_::G + g;
  const int k = blockIdx.y;
  const bool live = s < S;
  const long long sym = k * stride_k + static_cast<long long>(live ? s : 0) * stride_s;
  const long long hk = static_cast<long long>(k) * A * F;

  wfft::team_rows<F, T, kAligned, true>(y_re + sym, y_im + sym, stride_a, A, p, live,
                                        h_re + hk, h_im + hk, tw, sm, team);
  __syncthreads();
  if (!live) return;

  // eq = num * scale * inv, stored as out[j] = eq[1 + (j + (F-1)/2) mod (F-1)].
  const float* inv_k = inv + static_cast<long long>(k) * F;
  const long long row = (static_cast<long long>(k) * S + s) * (F - 1);
  for (int t = p * G_::T + team.j; t < F; t += G_::P * G_::T) {
    if (t == 0) continue;  // DC bin
    int j = t - F / 2;
    if (j < 0) j += F - 1;
    const float2 num = wfft::partial_sum<F>(sm, g, t);
    const float gain = inv_k[t] * scale;
    out_re[row + j] = num.x * gain;
    out_im[row + j] = num.y * gain;
  }
}

template <int F, typename T, bool kAligned>
cudaError_t launch_fft_mrc(const void* y_re, const void* y_im, long long stride_k,
                           long long stride_s, long long stride_a, float scale,
                           int K, int S, int A, const float* h_re,
                           const float* h_im, const float* inv, const float* tw,
                           float* out_re, float* out_im, cudaStream_t stream) {
  using G_ = wfft::Geo<F>;
  auto kernel = fft_mrc_kernel<F, T, kAligned>;
  cudaError_t err = allow_smem(kernel, G_::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((S + G_::G - 1) / G_::G, K), G_::kBlock, G_::kSmemBytes, stream>>>(
      static_cast<const T*>(y_re), static_cast<const T*>(y_im), stride_k, stride_s,
      stride_a, scale, S, A, h_re, h_im, inv,
      reinterpret_cast<const float2*>(tw), out_re, out_im);
  return cudaGetLastError();
}

template <typename T, bool kAligned>
cudaError_t dispatch_fft_mrc(int F, const void* y_re, const void* y_im,
                             long long stride_k, long long stride_s,
                             long long stride_a, float scale, int K, int S, int A,
                             const float* h_re, const float* h_im,
                             const float* inv, const float* tw, float* out_re,
                             float* out_im, cudaStream_t stream) {
#define OFDM_FFT_MRC_CASE(N)                                                     \
  case N:                                                                        \
    return launch_fft_mrc<N, T, kAligned>(y_re, y_im, stride_k, stride_s,        \
                                          stride_a, scale, K, S, A, h_re, h_im,  \
                                          inv, tw, out_re, out_im, stream);
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
// aligned: every row starts 16-byte aligned (the bases and the three strides
// in bytes are multiples of 16), which selects the cp.async load path.
// h_re/h_im: [K, A, F] unconjugated estimate, inv: [K, F], natural order.
// tw: the pass twiddles of ops/fft_plan.py.  Outputs out_re/out_im:
// [K, S, F-1] in reference order.  Returns the cudaError_t of the launch.
extern "C" int ofdm_fft_mrc(const void* y_re, const void* y_im, int in_int16,
                            int aligned, long long stride_k, long long stride_s,
                            long long stride_a, float scale, int K, int S, int A,
                            int F, const float* h_re, const float* h_im,
                            const float* inv, const float* tw, float* out_re,
                            float* out_im, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto dispatch) {
    return dispatch(F, y_re, y_im, stride_k, stride_s, stride_a, scale, K, S, A, h_re,
                    h_im, inv, tw, out_re, out_im, st);
  };
  cudaError_t err;
  if (in_int16) {
    err = aligned ? run(ofdm::dispatch_fft_mrc<int16_t, true>)
                  : run(ofdm::dispatch_fft_mrc<int16_t, false>);
  } else {
    err = aligned ? run(ofdm::dispatch_fft_mrc<float, true>)
                  : run(ofdm::dispatch_fft_mrc<float, false>);
  }
  return static_cast<int>(err);
}
