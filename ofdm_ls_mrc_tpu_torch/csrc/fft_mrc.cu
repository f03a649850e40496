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
//
// F = 8192: fft_mrc_spread_kernel below on fft_spread.cuh's spread_rows:
// the launch's K S A antenna rows spread over one block an SM in
// contiguous ranges (12 or 13 rows a block for a 16 x 8192 x 100 frame),
// each block's rows in sequence on one 256-thread team of the register FFT,
// the sum over a symbol's antennas in registers and, where a symbol's rows
// span blocks, through partials in L2 and a count per symbol; stored as
// above (ops/fft_plan.py spread_plan; ptxas and the times: chip_smoke.py
// phase 15, PERF.md).  It replaces a grid of one block a symbol (204,800 B:
// one block an SM, a 16 x 8192 x 100 frame on 100 of the 132 SMs, 16 rows
// in series each, ~83 us on an H100 against 33.6 us of bytes at 3.35
// TB/s).
//
// F = 16384 and 32768: the split form (fft_split.cuh) as one persistent
// launch, fft_mrc_ring_kernel below: column tiles (the column pass of C
// columns of one antenna row) and row tiles (the 128-point FFT of kK1 = 8
// bins k1 of one symbol over every antenna, 4 antenna teams at 16
// antennas, 256 threads, Y conj(h) folded from the estimate slice staged in
// shared memory, stored as above: eq = num * inv * scale in reference
// order) taken by ticket, meeting in a ring of symbol slots that L2 holds
// (ops/fft_plan.py split_ring).  Its device traffic is the rows' read and
// the output's write (a 16 x 32768 x 100 f32 frame: 445 MB, 134 us at
// 3.35 TB/s), where the two-launch form before it also wrote and read a
// 419 MB scratch; ptxas and the times: chip_smoke.py phase 15, PERF.md.

#include <cstdint>

#include "fft_split.cuh"
#include "fft_spread.cuh"

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
    OFDM_FFT_MRC_CASE(64)
    OFDM_FFT_MRC_CASE(128)
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

// F = 8192 (fft_spread.cuh spread_rows): eq = num * inv * scale of each
// symbol the block ends, stored in reference order as above.
template <typename E, bool kAligned>
__global__ void __launch_bounds__(spread::kT, 1)
fft_mrc_spread_kernel(const spread::Args p) {
  constexpr int F = spread::kF;
  auto store = [&](long long item, const float2 (&v)[spread::kM], const float (&inv)[spread::kM],
                   int j) {
    const long long row = item * (F - 1);
#pragma unroll
    for (int m = 0; m < spread::kM; ++m) {
      const int t = j + spread::kT * m;
      if (t == 0) continue;  // DC bin
      const int o = t < F / 2 ? t + F / 2 - 1 : t - F / 2;
      const float gain = inv[m] * p.scale;
      __stcs(p.out_re + row + o, v[m].x * gain);
      __stcs(p.out_im + row + o, v[m].y * gain);
    }
  };
  spread::spread_rows<E, kAligned, true>(p, store);
}

// F = 16384 and 32768 (fft_split.cuh ring_loop): one launch over the K S
// symbols; a row tile folds Y conj(h) of its frame's estimate over every
// antenna, then stores eq = num * inv * scale in reference order.
template <int N1, typename E>
__global__ void __launch_bounds__(split::kRowThreads, split::kRingBlocks)
fft_mrc_ring_kernel(const split::RingArgs p) {
  constexpr int F = N1 * split::kN2;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int P = split::data_teams(p.A);
  float2* const tw = reinterpret_cast<float2*>(smem + split::ring_gain_offset() +
                                             split::kGainFloats);
  split::ring_loop<N1, E, split::kK1>(
      p, smem, tw, [&](long long, int item, int q, const float* b_re, const float* b_im,
                       const float2* row_tw, uint64_t policy, auto gate, auto done) {
    const int k = item / p.S;
    const int k1_0 = q * split::kK1;
    const long long hk = static_cast<long long>(k) * p.A * F;
    float* const gs = smem + split::ring_gain_offset();
    split::stage_gain<N1>(gs, p.gain + static_cast<long long>(k) * F, k1_0);
    split::row_pass<N1, true>(b_re, b_im, p.h_re + hk, p.h_im + hk, p.A, P, k1_0, row_tw, smem,
                              gate);
    __syncthreads();
    done();
    const long long orow = static_cast<long long>(item) * (F - 1);
    for (int i = threadIdx.x; i < split::kK1 * split::kN2; i += split::kRowThreads) {
      const int g = i % split::kK1, k2 = i / split::kK1;
      const int bin = k1_0 + g + N1 * k2;
      if (bin == 0) continue;  // DC bin
      int j = bin - F / 2;
      if (j < 0) j += F - 1;
      const float2 num = split::row_sum(smem, P, g, k2);
      const float gain = gs[i] * p.scale;
      split::st_evict_first(p.out_re + orow + j, num.x * gain, policy);
      split::st_evict_first(p.out_im + orow + j, num.y * gain, policy);
    }
  });
}

template <int N1>
cudaError_t ring_fft_mrc(bool int16, const split::RingArgs& p, cudaStream_t stream) {
  return int16 ? split::launch_ring<N1>(fft_mrc_ring_kernel<N1, int16_t>, p, stream)
               : split::launch_ring<N1>(fft_mrc_ring_kernel<N1, float>, p, stream);
}

}  // namespace ofdm

// Data rows: y_re/y_im point at row (k=0, s=0, a=0) of K x S x A rows of F
// samples, row (k, s, a) at element offset k*stride_k + s*stride_s +
// a*stride_a; int16 when in_int16 (scaled by `scale`), float32 otherwise.
// aligned: every row starts 16-byte aligned (the bases and the three strides
// in bytes are multiples of 16), which selects the cp.async load path.
// h_re/h_im: [K, A, F] unconjugated estimate, inv: [K, F], natural order.
// tw: the pass twiddles of ops/fft_plan.py, at F = 16384 and 32768 its
// split table.  Outputs out_re/out_im: [K, S, F-1] in reference order.
// scratch, slots, lag, counters: at F = 16384 and 32768 the ring [2, slots,
// A, F] float32, the schedule's lag and its zeroed counters [1 + 2 K S]
// (ops/fft_plan.py split_ring); at F = 8192 the partials [slots, 2, F, 2]
// float32, the plan's blocks (slots) and dynamic shared memory (lag) of
// ops/fft_plan.py spread_plan, checked against the kernel's own with h's
// planes 16-byte aligned (cudaErrorInvalidValue otherwise), and the zeroed
// counts [K S] (left zero); unused below.  Returns the cudaError_t of the
// launch.
extern "C" int ofdm_fft_mrc(const void* y_re, const void* y_im, int in_int16,
                            int aligned, long long stride_k, long long stride_s,
                            long long stride_a, float scale, int K, int S, int A,
                            int F, const float* h_re, const float* h_im,
                            const float* inv, const float* tw, float* out_re,
                            float* out_im, float* scratch, int slots, int lag,
                            unsigned* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 16384 || F == 32768) {
    const long long items = static_cast<long long>(K) * S;
    if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const ofdm::split::RingArgs p{y_re, y_im, stride_k, stride_s, stride_a, S, A,
                                  static_cast<int>(items), slots, lag, scale,
                                  reinterpret_cast<const float2*>(tw), scratch, counters,
                                  h_re, h_im, inv, out_re, out_im};
    return static_cast<int>(F == 16384 ? ofdm::ring_fft_mrc<128>(in_int16 != 0, p, st)
                                       : ofdm::ring_fft_mrc<256>(in_int16 != 0, p, st));
  }
  if (F == ofdm::spread::kF) {
    const long long rows = static_cast<long long>(K) * S * A;
    if (K < 1 || S < 1 || A < 1 || !ofdm::spread::plan_ok(rows, slots, lag, h_re, h_im) ||
        scratch == nullptr || counters == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const ofdm::spread::Args p{y_re, y_im, stride_k, stride_s, stride_a, rows, S, A, slots,
                               scale, h_re, h_im, inv, F, reinterpret_cast<const float2*>(tw),
                               out_re, out_im, scratch, counters};
    using ofdm::fft_mrc_spread_kernel;
    return static_cast<int>(
        in_int16 ? (aligned ? ofdm::spread::launch(fft_mrc_spread_kernel<int16_t, true>, p, st)
                            : ofdm::spread::launch(fft_mrc_spread_kernel<int16_t, false>, p, st))
                 : (aligned ? ofdm::spread::launch(fft_mrc_spread_kernel<float, true>, p, st)
                            : ofdm::spread::launch(fft_mrc_spread_kernel<float, false>, p, st)));
  }
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

#ifdef OFDM_SPREAD_TRACE
// The stamp buffer of a traced build (fft_spread.cuh spread_trace), or null.
extern "C" int ofdm_spread_trace_set(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(ofdm::spread::spread_trace, &buf, sizeof(buf)));
}
#endif

#ifdef OFDM_RING_TRACE
// The stamp buffer of a traced build (fft_split.cuh ring_trace), or null.
extern "C" int ofdm_ring_trace_set(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(ofdm::split::ring_trace, &buf, sizeof(buf)));
}
#endif
