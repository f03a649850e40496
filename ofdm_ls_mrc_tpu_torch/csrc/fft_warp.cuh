// Register FFT of antenna rows, with the antennas of a symbol spread over
// teams of threads and the next row's load in flight during the current
// row's FFT.  Shared by fft_mrc.cu and mrc_demod.cu (team_rows below) and
// pilot_ls.cu (its own row loop on stage_row and row_fft).
//
// The FFT.  A team of T = F / M threads transforms one row; each thread
// holds M complex values in registers.  The row goes through a mixed-radix
// Stockham FFT of two or three passes (Plan<F> below; ops/fft_plan.py holds
// the same factorization and the host tables, and the CPU tests emulate it):
//   pass with radix R, Ns = product of the radices before it: butterfly
//   b < F/R takes x[b + (F/R) r], multiplies input r by
//   exp(-2 pi i (b mod Ns) r / (Ns R)), runs an R-point DFT in registers, and
//   writes output r to (b / Ns) Ns R + (b mod Ns) + Ns r.
// Thread j runs the butterflies b = j + T q, so every pass reads positions
// j + T m into register m: the first pass straight from the staged row, the
// later ones from an exchange buffer that the previous pass wrote.  After
// the last pass register m holds bin j + T m, which is what the MAC reads of
// h and the store write.  A team is a warp (F = 1024), part of a warp (F <
// 1024: several teams per warp, __syncwarp with the team's lanes) or a few
// warps (F >= 2048: a named barrier per team; at F = 8192 one team of 256
// threads a block runs fft_spread.cuh's rows), so no block-wide barrier
// falls inside a row.  The exact data kernels at F = 256, 512, 2048 and 4096
// run the same passes on fft_side.cuh's plans (SidePlan<F>: 16 values a
// thread, a launch's rows over teams side by side on the card): the pass
// helpers below take the plan as PL, Plan<F> by default.  Past
// 8192 a row does not fit one SM's registers beside its sums: fft_split.cuh
// runs F = 16384 and 32768 as two passes of this FFT at F = n1 and 128.  Exchange slot e + e / M spreads every pass's transpose over
// the 32 banks.  The inter-pass twiddles come from a float32 table computed
// in float64 on the host (ops/fft_plan.py pass_twiddles), held in shared
// memory; the R-point DFTs use the exact constants cos(pi k / 16) below.  No
// __sinf, no recurrence, no fast-math.
//
// The rows.  A block holds G symbols of P teams each; team p of a symbol
// takes antennas p, p + P, ... and accumulates sum Y * conj(h) (or Y * hc) for
// its bins in registers.  Each team double-buffers its rows in shared memory:
// the copy of row i+1 is issued (cp.async, 16 B a thread) before the FFT of
// row i, and h's row is prefetched into L1 with it.  Rows whose base or
// strides are not 16-byte aligned (an odd cyclic prefix) take the
// per-element path (kAligned = false): plain loads into the same buffer.  int16 rows are staged as int16 and widened when
// read; the sc16 scale multiplies the sums in the epilogue.  After the last
// row each team writes its partial sums into its buffer, one __syncthreads,
// and the P partials of a bin are added by the symbol's threads in the
// kernel's epilogue.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fft.cuh"

namespace ofdm {
namespace wfft {

// F -> radices (R0 = M, the values a thread holds; R2 = 1 for two passes),
// teams per symbol P, threads per block, and the blocks an SM should hold
// (__launch_bounds__).  Mirrored by ops/fft_plan.py PLANS.  At F = 8192 the
// kernels take the radices and the team (T = 256) only: fft_spread.cuh runs
// the team in a block of its own layout.  The data kernels at 256, 512, 2048
// and 4096 take fft_side.cuh's SidePlan<F> instead; the pilot runs these.
template <int F>
struct Plan;
template <int F>
struct SidePlan;  // fft_side.cuh's plans (F = 256, 512, 2048, 4096)
#define OFDM_WARP_PLAN(F_, R0_, R1_, R2_, P_, BLOCK_, MINB_)              \
  template <>                                                            \
  struct Plan<F_> {                                                      \
    static constexpr int R0 = R0_, R1 = R1_, R2 = R2_, P = P_;           \
    static constexpr int kBlock = BLOCK_, kMinBlocks = MINB_;            \
  };
OFDM_WARP_PLAN(64, 8, 8, 1, 4, 128, 4)
OFDM_WARP_PLAN(128, 16, 8, 1, 4, 128, 4)
OFDM_WARP_PLAN(256, 16, 16, 1, 4, 128, 4)
OFDM_WARP_PLAN(512, 32, 16, 1, 4, 128, 2)
OFDM_WARP_PLAN(1024, 32, 32, 1, 4, 128, 2)
OFDM_WARP_PLAN(2048, 32, 8, 8, 2, 128, 1)
OFDM_WARP_PLAN(4096, 32, 16, 8, 2, 256, 1)
OFDM_WARP_PLAN(8192, 32, 16, 16, 1, 256, 1)
#undef OFDM_WARP_PLAN

// The exchange's padding of a plan: one float after every kPad positions,
// M unless the plan sets kPad (fft_side.cuh: 32 where a team is a warp or
// more and M = 16, so that a warp's 32 consecutive positions stay in one run).
template <typename PL, typename = void>
struct PadOf {
  static constexpr int value = PL::R0;
};
template <typename PL>
struct PadOf<PL, decltype(void(PL::kPad))> {
  static constexpr int value = PL::kPad;
};

// The row geometry of a plan PL (Plan<F>, or fft_side.cuh's SidePlan<F>).
template <int F, typename PL = Plan<F>>
struct Geo {
  using P_ = PL;
  static constexpr int M = P_::R0;
  static constexpr int kPad = PadOf<PL>::value;   // exchange padding stride
  static constexpr int T = F / M;                  // threads per row
  static constexpr int P = P_::P;                  // teams per symbol
  static constexpr int kBlock = P_::kBlock;
  static constexpr int kTeams = kBlock / T;        // teams per block
  static constexpr int G = kTeams / P;             // symbols per block
  static constexpr int kPlane = (F + F / kPad + 3) / 4 * 4;  // floats per plane
  static constexpr int kNeed = 4 * kPlane;         // two buffers of two planes
  static constexpr int kTeamFloats =
      kNeed + (T < 32 ? ((T - kNeed % 32) % 32 + 32) % 32 : 0);
  static constexpr int kTw1 = P_::R1 * P_::R0;     // pass-1 twiddles
  static constexpr int kTwiddles = kTw1 + (P_::R2 > 1 ? P_::R2 * P_::R0 * P_::R1 : 0);
  static constexpr size_t kSmemBytes =
      (static_cast<size_t>(kTwiddles) * 2 + static_cast<size_t>(kTeams) * kTeamFloats) *
      sizeof(float);
  static_assert(M * T == F && kTeams * T == kBlock && G * P == kTeams, "plan");
  static_assert(T <= 32 || kTeams <= 15, "one named barrier per team");
};

// ---------------------------------------------------------------------------
// Exact small-DFT constants
// ---------------------------------------------------------------------------

// cos(pi k / 16), k = 0..8, as float literals (float64 values, rounded).
__host__ __device__ constexpr float cos_pi16(int k) {
  return k == 0   ? 1.0f
         : k == 1 ? 0.98078528040323044913f
         : k == 2 ? 0.92387953251128675613f
         : k == 3 ? 0.83146961230254523708f
         : k == 4 ? 0.70710678118654752440f
         : k == 5 ? 0.55557023301960222474f
         : k == 6 ? 0.38268343236508977173f
         : k == 7 ? 0.19509032201612826785f
                  : 0.0f;
}

// exp(-2 pi i e / 32) = (w32_re(e), w32_im(e)), e in [0, 32).
__host__ __device__ constexpr float w32_re(int e) {
  return e <= 8 ? cos_pi16(e) : e <= 16 ? -cos_pi16(16 - e) : e <= 24 ? -cos_pi16(e - 16)
                                                               : cos_pi16(32 - e);
}
__host__ __device__ constexpr float w32_im(int e) { return -w32_re((e + 24) & 31); }

__host__ __device__ constexpr int bit_reverse(int r, int n) {
  int out = 0;
  for (int b = 1; b < n; b <<= 1) {
    out = (out << 1) | (r & 1);
    r >>= 1;
  }
  return out;
}

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// b * exp(-2 pi i e / 32), exact for e = 0 and e = 8.
__device__ __forceinline__ float2 mul_w32(float2 b, int e) {
  if (e == 0) return b;
  if (e == 8) return make_float2(b.y, -b.x);
  return cmul(b, make_float2(w32_re(e), w32_im(e)));
}

// In-register R-point DFT of v[q + S r], r < R, S = M / R, natural order in
// and out: radix-2 decimation in time on a bit-reversed copy.  Every index
// is a constant once the callers' loops are unrolled.
template <int R, int M>
__device__ __forceinline__ void dft(float2 (&v)[M], int q) {
  constexpr int S = M / R;
  float2 x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[bit_reverse(r, R)] = v[q + S * r];
#pragma unroll
  for (int s = 0; s < log2i(R); ++s) {
    const int h = 1 << s;
#pragma unroll
    for (int g = 0; g < R; g += 2 * h) {
#pragma unroll
      for (int k = 0; k < h; ++k) {
        const float2 a = x[g + k];
        const float2 b = mul_w32(x[g + k + h], k * (16 >> s));
        x[g + k] = cadd(a, b);
        x[g + k + h] = csub(a, b);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) v[q + S * r] = x[r];
}

// ---------------------------------------------------------------------------
// Team synchronisation and row staging
// ---------------------------------------------------------------------------

template <int T>
struct Team {
  int id;          // team index in the block
  int j;           // thread index in the team
  unsigned mask;   // the team's lanes (T <= 32)

  __device__ __forceinline__ Team() : id(threadIdx.x / T), j(threadIdx.x % T) {
    const int lane = threadIdx.x & 31;
    mask = T >= 32 ? 0xffffffffu : ((1u << (T & 31)) - 1u) << (lane / T * T);
  }

  __device__ __forceinline__ void sync() const {
    if constexpr (T <= 32) {
      __syncwarp(mask);
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + id), "r"(T) : "memory");
    }
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage one row (planes re, im of element type E) into buf: re at buf[0..),
// im at buf[kPlane..), raw.  Aligned: 16-byte cp.async chunks, thread j
// taking chunks j, j + T, ...; otherwise element copies.
template <int F, typename E, bool kAligned, typename PL = Plan<F>>
__device__ __forceinline__ void stage_row(float* buf, const E* __restrict__ re,
                                          const E* __restrict__ im, int j) {
  using G_ = Geo<F, PL>;
  E* dre = reinterpret_cast<E*>(buf);
  E* dim = reinterpret_cast<E*>(buf + G_::kPlane);
  if constexpr (kAligned) {
    constexpr int kPer = 16 / sizeof(E);
    constexpr int kChunks = F / kPer;  // a multiple of T
#pragma unroll
    for (int u = 0; u < kChunks / G_::T; ++u) {
      const int c = j + u * G_::T;
      cp_async16(dre + c * kPer, re + c * kPer);
      cp_async16(dim + c * kPer, im + c * kPer);
    }
  } else {
    E r[G_::M], i[G_::M];
#pragma unroll
    for (int m = 0; m < G_::M; ++m) {
      r[m] = re[j + G_::T * m];
      i[m] = im[j + G_::T * m];
    }
#pragma unroll
    for (int m = 0; m < G_::M; ++m) {
      dre[j + G_::T * m] = r[m];
      dim[j + G_::T * m] = i[m];
    }
  }
}

// ---------------------------------------------------------------------------
// The row FFT
// ---------------------------------------------------------------------------

// Exchange slot of position e >= 0: e + e / kPad (kPad = M unless the plan
// sets it).  For the positions a thread touches, slot(base + d) = slot(base)
// + d + d / kPad with d a constant (below), so every access is one base
// register plus an immediate offset.
template <int F, typename PL = Plan<F>>
__device__ __forceinline__ int slot(int e) {
  return e + (e >> log2i(Geo<F, PL>::kPad));
}
template <int F, typename PL = Plan<F>>
__host__ __device__ constexpr int slot_step(int d) {
  return d + d / Geo<F, PL>::kPad;
}

// Pass with radix R and stride NS on v; twiddles tw (this pass's block of
// the table) unless it is the first pass.
template <int F, int R, int NS, typename PL = Plan<F>>
__device__ __forceinline__ void run_pass(float2 (&v)[Geo<F, PL>::M],
                                         const float2* __restrict__ tw, int j) {
  constexpr int M = Geo<F, PL>::M, T = Geo<F, PL>::T, Q = M / R;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if constexpr (NS > 1) {
      const float2* w = tw + ((j + T * q) & (NS - 1));
#pragma unroll
      for (int r = 1; r < R; ++r) v[q + Q * r] = cmul(v[q + Q * r], w[r * NS]);
    }
    dft<R, M>(v, q);
  }
}

// Writes pass (R, NS)'s output into the exchange planes ex (re) and
// ex + kPlane (im): output r of butterfly b to position base(b) + NS r.
// base(b) is a multiple of M when NS = 1 (then R = M), and NS r a multiple
// of M otherwise, so slot(base + NS r) = slot(base) + slot_step(NS r).
template <int F, int R, int NS, typename PL = Plan<F>>
__device__ __forceinline__ void write_exchange(const float2 (&v)[Geo<F, PL>::M], float* ex,
                                               int j) {
  constexpr int M = Geo<F, PL>::M, T = Geo<F, PL>::T, Q = M / R;
  static_assert((NS == 1 && R == M) || NS % M == 0, "affine exchange slots");
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int b = j + T * q;
    float* out = ex + slot<F, PL>((b / NS) * NS * R + (b & (NS - 1)));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      out[slot_step<F, PL>(NS * r)] = v[q + Q * r].x;
      out[Geo<F, PL>::kPlane + slot_step<F, PL>(NS * r)] = v[q + Q * r].y;
    }
  }
}

// Reads positions j + T m (j < T; T a multiple or a divisor of M), so
// slot(j + T m) = slot(j) + slot_step(T m).
template <int F, typename PL = Plan<F>>
__device__ __forceinline__ void read_exchange(float2 (&v)[Geo<F, PL>::M], const float* ex,
                                              int j) {
  constexpr int M = Geo<F, PL>::M, T = Geo<F, PL>::T;
  const float* in = ex + slot<F, PL>(j);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    v[m] = make_float2(in[slot_step<F, PL>(T * m)],
                       in[Geo<F, PL>::kPlane + slot_step<F, PL>(T * m)]);
  }
}

// A staged sample as float: int16 through the exact 1.5 * 2^23 bias (an
// integer add and a float subtract, both full rate, where a conversion
// instruction runs at a quarter of it); the sc16 scale is applied to the
// sums in the epilogue, the transform being linear.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(int16_t x) {
  return __int_as_float(0x4B400000 + static_cast<int>(x)) - 12582912.0f;
}

// L1 prefetch of estimate row a (two planes of F floats), 128-byte lines
// spread over the team.
template <int F>
__device__ __forceinline__ void prefetch_row(const float* h_re, const float* h_im, int a,
                                             int j) {
  const float* re = h_re + static_cast<long long>(a) * F;
  const float* im = h_im + static_cast<long long>(a) * F;
  for (int l = j; l < F / 32; l += Geo<F>::T) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(re + 32 * l));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(im + 32 * l));
  }
}

// FFT of the row whose positions j + T m the team's lanes hold in v
// (register m), unscaled; buf is the exchange buffer.  On return register m
// holds bin j + T m and the team is done with buf only after its next sync.
template <int F>
__device__ __forceinline__ void row_fft_regs(float2 (&v)[Geo<F>::M], float* buf,
                                             const float2* __restrict__ tw,
                                             const Team<Geo<F>::T>& team) {
  using G_ = Geo<F>;
  using P_ = Plan<F>;
  const int j = team.j;
  run_pass<F, P_::R0, 1>(v, tw, j);
  team.sync();  // a row staged in buf has been read by every thread
  write_exchange<F, P_::R0, 1>(v, buf, j);
  team.sync();
  read_exchange<F>(v, buf, j);
  run_pass<F, P_::R1, P_::R0>(v, tw, j);
  if constexpr (P_::R2 > 1) {
    team.sync();
    write_exchange<F, P_::R1, P_::R0>(v, buf, j);
    team.sync();
    read_exchange<F>(v, buf, j);
    run_pass<F, P_::R2, P_::R0 * P_::R1>(v, tw + G_::kTw1, j);
  }
}

// FFT of the row staged (raw, element type E) in buf, unscaled; buf is then
// the exchange buffer.  On return register m holds bin j + T m and the team is
// done reading buf only after its next sync.
template <int F, typename E>
__device__ __forceinline__ void row_fft(float2 (&v)[Geo<F>::M], float* buf,
                                        const float2* __restrict__ tw,
                                        const Team<Geo<F>::T>& team) {
  using G_ = Geo<F>;
  constexpr int M = G_::M, T = G_::T;
  const E* sre = reinterpret_cast<const E*>(buf);
  const E* sim = reinterpret_cast<const E*>(buf + G_::kPlane);
  const int j = team.j;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    v[m] = make_float2(widen(sre[j + T * m]), widen(sim[j + T * m]));
  }
  row_fft_regs<F>(v, buf, tw, team);
}

// ---------------------------------------------------------------------------
// A team's rows of one symbol
// ---------------------------------------------------------------------------

// The block's shared memory: the pass twiddles, then each team's buffers.
template <int F>
struct Smem {
  float2* tw;
  float* teams;
  __device__ __forceinline__ explicit Smem(float4* raw)
      : tw(reinterpret_cast<float2*>(raw)),
        teams(reinterpret_cast<float*>(raw) + 2 * Geo<F>::kTwiddles) {}
  __device__ __forceinline__ float* team(int id) const {
    return teams + static_cast<long long>(id) * Geo<F>::kTeamFloats;
  }
};

template <int F>
__device__ __forceinline__ void load_pass_twiddles(float2* tw_s,
                                                   const float2* __restrict__ tw) {
  for (int i = threadIdx.x; i < Geo<F>::kTwiddles; i += Geo<F>::kBlock) tw_s[i] = tw[i];
}

// Runs the rows a = p, p + P, ... < A of one symbol (row a at
// y + a * stride_a), accumulating sum_a Y_a * conj(h_a) (kConjugate) or
// sum_a Y_a * h_a into registers, Y unscaled (each row's h is prefetched
// into L1 when the row is staged), and writes the team's
// partial sums (bin t at part[t], part[kPlane + t]) into its first buffer.
// live = false runs no row and writes zeros.  Every thread of the block
// calls it: the block loads the pass twiddles tw into shared memory (one
// __syncthreads) while the first rows are in flight.
template <int F, typename E, bool kAligned, bool kConjugate>
__device__ __forceinline__ void team_rows(const E* __restrict__ y_re,
                                          const E* __restrict__ y_im,
                                          long long stride_a, int A, int p,
                                          bool live, const float* __restrict__ h_re,
                                          const float* __restrict__ h_im,
                                          const float2* __restrict__ tw,
                                          const Smem<F>& sm,
                                          const Team<Geo<F>::T>& team) {
  using G_ = Geo<F>;
  constexpr int M = G_::M, T = G_::T;
  const int j = team.j;
  float* const bufs = sm.team(team.id);
  float* const buf0 = bufs;
  float* const buf1 = bufs + 2 * G_::kPlane;
  const int n = live && p < A ? (A - p + G_::P - 1) / G_::P : 0;

  float acc_re[M], acc_im[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc_re[m] = acc_im[m] = 0.0f;

  if (n > 0) {
    const long long off = static_cast<long long>(p) * stride_a;
    stage_row<F, E, kAligned>(buf0, y_re + off, y_im + off, j);
    prefetch_row<F>(h_re, h_im, p, j);
  }
  cp_async_commit();
  load_pass_twiddles<F>(sm.tw, tw);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      const int a = p + (i + 1) * G_::P;
      const long long off = static_cast<long long>(a) * stride_a;
      stage_row<F, E, kAligned>((i & 1) ? buf0 : buf1, y_re + off, y_im + off, j);
      prefetch_row<F>(h_re, h_im, a, j);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    team.sync();  // row i has landed for every thread of the team
    float2 v[M];
    row_fft<F, E>(v, (i & 1) ? buf1 : buf0, sm.tw, team);
    const long long hrow = static_cast<long long>(p + i * G_::P) * F;
    const float* hr = h_re + hrow;
    const float* hi = h_im + hrow;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float cr = __ldg(hr + j + T * m), ci = __ldg(hi + j + T * m);
      if constexpr (kConjugate) {  // Y * conj(h)
        acc_re[m] += v[m].x * cr + v[m].y * ci;
        acc_im[m] += v[m].y * cr - v[m].x * ci;
      } else {  // Y * hc, hc already conjugated
        acc_re[m] += v[m].x * cr - v[m].y * ci;
        acc_im[m] += v[m].x * ci + v[m].y * cr;
      }
    }
    team.sync();  // row i's buffer is free for row i + 2
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    buf0[j + T * m] = acc_re[m];
    buf0[G_::kPlane + j + T * m] = acc_im[m];
  }
}

// Sum over the P partials of bin t of symbol group g.
template <int F>
__device__ __forceinline__ float2 partial_sum(const Smem<F>& sm, int g, int t) {
  float re = 0.0f, im = 0.0f;
#pragma unroll
  for (int p = 0; p < Geo<F>::P; ++p) {
    const float* part = sm.team(g * Geo<F>::P + p);
    re += part[t];
    im += part[Geo<F>::kPlane + t];
  }
  return make_float2(re, im);
}

}  // namespace wfft
}  // namespace ofdm
