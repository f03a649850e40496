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
// F from 64 to 32768: at F = 64 and 128 a team is 8 or 16 lanes and a block
// of 128 threads holds 4 symbols, so each h row a team reads serves that
// many symbols from L1; F = 256, 512, 2048 and 4096 run
// mrc_demod_side_kernel below on fft_side.cuh's side_rows (16 values a
// thread, the S A rows in contiguous ranges over teams side by side on the
// card, a symbol split over teams added in shared memory in team order, over
// blocks through partials in L2 and a count per symbol; ops/fft_plan.py
// side_plan), where 2 symbols of 4 teams a block (256, 512) and a symbol's
// rows 8 a team in sequence on 100 SMs (2048, 4096) ran before; F = 8192 runs
// mrc_demod_spread_kernel below on fft_spread.cuh's spread_rows (the S A
// rows spread over one block an SM in contiguous ranges, one 256-thread
// team a block, the sums over a symbol's antennas in registers and across
// blocks through partials in L2 and a count per symbol; ops/fft_plan.py
// spread_plan), where one team of 256 threads a symbol ran before (204,800
// B, one SM a symbol, one SM at S = 1); F = 16384 and 32768 run the split form (fft_split.cuh) as one persistent launch,
// mrc_demod_ring_kernel below: column tiles and row tiles (8 bins k1 of one
// symbol over every antenna, Y hc folded from the estimate slice staged in
// shared memory) taken by ticket, meeting in a ring of symbol slots that L2
// holds, as fft_mrc.cu's (ptxas: chip_smoke.py phase 15).
//
// Bound on this card: bytes, as fft_mrc.cu: 16 antennas x 1024 x 100 f32
// symbols read 13.1 MB of rows plus 0.13 MB of estimate and write 0.82 MB,
// 4.2 us at 3.35 TB/s; ~95 MFLOP, 1.4 us at 67 TFLOP/s, but ~1,650
// instructions a row and thread, so issue and latency set the time.  h is
// 12.8 MB of L2 reads per frame at F = 1024 (one symbol per block).  ptxas
// (sm_90a): 222-227 registers at F = 1024, no spills,
// 75,776 B a block; F = 64: 80-85 registers, 19,456 B, 4 symbols a block.
// The side kernel: at most 128 registers (512 threads a block; 256 at F =
// 256, two blocks an SM), none spilled at 2048 and 4096 (the register
// kernel spilled 220-280 B at 2048 at 255 registers; chip_smoke.py phase 2).

#include <cstdint>

#include "fft_side.cuh"
#include "fft_split.cuh"
#include "fft_spread.cuh"

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
    OFDM_MRC_DEMOD_CASE(1024)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_MRC_DEMOD_CASE
}

// F = 256, 512, 2048, 4096 (fft_side.cuh side_rows): eq = num * scale / hsqrd
// of bin t of a symbol, true order.
template <int F, typename E, bool kAligned>
__global__ void __launch_bounds__(side::Shape<F>::kBlock, side::Shape<F>::kBlocksPerSm)
mrc_demod_side_kernel(const spread::Args p) {
  auto gain = [&](int, int t) { return p.scale / __ldg(p.gain + t); };
  auto store = [&](int item, int t, float2 v, float g) {
    const long long row = static_cast<long long>(item) * F;
    __stcs(p.out_re + row + t, v.x * g);
    __stcs(p.out_im + row + t, v.y * g);
  };
  side::side_rows<F, E, kAligned, false>(p, gain, store);
}

template <int F>
cudaError_t side_mrc_demod(bool int16, bool aligned, const spread::Args& p, cudaStream_t st) {
  return int16 ? (aligned ? side::launch<F>(mrc_demod_side_kernel<F, int16_t, true>, p, st)
                          : side::launch<F>(mrc_demod_side_kernel<F, int16_t, false>, p, st))
               : (aligned ? side::launch<F>(mrc_demod_side_kernel<F, float, true>, p, st)
                          : side::launch<F>(mrc_demod_side_kernel<F, float, false>, p, st));
}

// F = 8192 (fft_spread.cuh spread_rows): eq = num * scale / hsqrd of each
// symbol the block ends, true order.
template <typename E, bool kAligned>
__global__ void __launch_bounds__(spread::kT, 1)
mrc_demod_spread_kernel(const spread::Args p) {
  auto store = [&](long long item, const float2 (&v)[spread::kM],
                   const float (&hsqrd)[spread::kM], int j) {
    const long long row = item * spread::kF;
#pragma unroll
    for (int m = 0; m < spread::kM; ++m) {
      const int t = j + spread::kT * m;
      const float gain = p.scale / hsqrd[m];
      __stcs(p.out_re + row + t, v[m].x * gain);
      __stcs(p.out_im + row + t, v[m].y * gain);
    }
  };
  spread::spread_rows<E, kAligned, false>(p, store);
}

// F = 16384 and 32768 (fft_split.cuh ring_loop): one launch over the S
// symbols; a row tile folds Y hc over every antenna, then stores
// eq = num * scale / hsqrd, true order.
template <int N1, typename E>
__global__ void __launch_bounds__(split::kRowThreads, split::kRingBlocks)
mrc_demod_ring_kernel(const split::RingArgs p) {
  constexpr int F = N1 * split::kN2;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int P = split::data_teams(p.A);
  float2* const tw = reinterpret_cast<float2*>(smem + split::ring_gain_offset() +
                                             split::kGainFloats);
  split::ring_loop<N1, E, split::kK1>(
      p, smem, tw, [&](long long, int item, int q, const float* b_re, const float* b_im,
                       const float2* row_tw, uint64_t policy, auto gate, auto done) {
    const int k1_0 = q * split::kK1;
    float* const gs = smem + split::ring_gain_offset();
    split::stage_gain<N1>(gs, p.gain, k1_0);
    split::row_pass<N1, false>(b_re, b_im, p.h_re, p.h_im, p.A, P, k1_0, row_tw, smem, gate);
    __syncthreads();
    done();
    const long long row = static_cast<long long>(item) * F;
    for (int i = threadIdx.x; i < split::kK1 * split::kN2; i += split::kRowThreads) {
      const int g = i % split::kK1, k2 = i / split::kK1;
      const int bin = k1_0 + g + N1 * k2;
      const float2 num = split::row_sum(smem, P, g, k2);
      const float gain = p.scale / gs[i];
      split::st_evict_first(p.out_re + row + bin, num.x * gain, policy);
      split::st_evict_first(p.out_im + row + bin, num.y * gain, policy);
    }
  });
}

template <int N1>
cudaError_t ring_mrc_demod(bool int16, const split::RingArgs& p, cudaStream_t stream) {
  return int16 ? split::launch_ring<N1>(mrc_demod_ring_kernel<N1, int16_t>, p, stream)
               : split::launch_ring<N1>(mrc_demod_ring_kernel<N1, float>, p, stream);
}

}  // namespace ofdm

// Data rows: y_re/y_im point at row (s=0, a=0) of S x A rows of F samples,
// row (s, a) at element offset s*stride_s + a*stride_a; int16 when in_int16
// (scaled by `scale`), float32 otherwise.  aligned: every row starts 16-byte
// aligned (bases and strides in bytes multiples of 16), which selects the
// cp.async load path.  hc_re/hc_im: [A, F] conjugated estimate, hsqrd: [F],
// true order.  tw: the pass twiddles of ops/fft_plan.py, at F = 16384 and
// 32768 its split table.  Outputs out_re/out_im: [S, F], true order.
// scratch, slots, lag, counters: at F = 16384 and 32768 the ring [2, slots,
// A, F] float32, the schedule's lag and its zeroed counters [1 + 2 S]
// (ops/fft_plan.py split_ring); at F = 8192 the partials [slots, 2, F, 2]
// float32, the plan's blocks (slots) and dynamic shared memory (lag) of
// ops/fft_plan.py spread_plan, checked against the kernel's own with h's
// planes 16-byte aligned (cudaErrorInvalidValue otherwise), and the zeroed
// counts [S] (left zero); at F = 256, 512, 2048 and 4096 the same with the
// partials [slots, 2 + teams, F, 2] and the plan of ops/fft_plan.py
// side_plan; unused at 64, 128 and 1024.  Returns the cudaError_t of the
// launch.
extern "C" int ofdm_mrc_demod(const void* y_re, const void* y_im, int in_int16,
                              int aligned, long long stride_s, long long stride_a,
                              float scale, int S, int A, int F, const float* hc_re,
                              const float* hc_im, const float* hsqrd, const float* tw,
                              float* out_re, float* out_im, float* scratch, int slots,
                              int lag, unsigned* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 16384 || F == 32768) {
    const ofdm::split::RingArgs p{y_re, y_im, 0, stride_s, stride_a, S, A, S, slots, lag,
                                  scale, reinterpret_cast<const float2*>(tw), scratch,
                                  counters, hc_re, hc_im, hsqrd, out_re, out_im};
    return static_cast<int>(F == 16384 ? ofdm::ring_mrc_demod<128>(in_int16 != 0, p, st)
                                       : ofdm::ring_mrc_demod<256>(in_int16 != 0, p, st));
  }
  if (ofdm::side::covers(F)) {
    const long long rows = static_cast<long long>(S) * A;
    if (S < 1 || A < 1 || !ofdm::side::plan_ok(F, rows, A, slots, lag, hc_re, hc_im) ||
        scratch == nullptr || counters == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const ofdm::spread::Args p{y_re, y_im, 0, stride_s, stride_a, rows, S, A, slots, scale,
                               hc_re, hc_im, hsqrd, 0, reinterpret_cast<const float2*>(tw),
                               out_re, out_im, scratch, counters};
    const bool i16 = in_int16 != 0, al = aligned != 0;
    return static_cast<int>(F == 256    ? ofdm::side_mrc_demod<256>(i16, al, p, st)
                            : F == 512  ? ofdm::side_mrc_demod<512>(i16, al, p, st)
                            : F == 2048 ? ofdm::side_mrc_demod<2048>(i16, al, p, st)
                                        : ofdm::side_mrc_demod<4096>(i16, al, p, st));
  }
  if (F == ofdm::spread::kF) {
    const long long rows = static_cast<long long>(S) * A;
    if (S < 1 || A < 1 || !ofdm::spread::plan_ok(rows, slots, lag, hc_re, hc_im) ||
        scratch == nullptr || counters == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const ofdm::spread::Args p{y_re, y_im, 0, stride_s, stride_a, rows, S, A, slots, scale,
                               hc_re, hc_im, hsqrd, 0, reinterpret_cast<const float2*>(tw),
                               out_re, out_im, scratch, counters};
    using ofdm::mrc_demod_spread_kernel;
    return static_cast<int>(
        in_int16 ? (aligned ? ofdm::spread::launch(mrc_demod_spread_kernel<int16_t, true>, p, st)
                            : ofdm::spread::launch(mrc_demod_spread_kernel<int16_t, false>, p, st))
                 : (aligned ? ofdm::spread::launch(mrc_demod_spread_kernel<float, true>, p, st)
                            : ofdm::spread::launch(mrc_demod_spread_kernel<float, false>, p, st)));
  }
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
