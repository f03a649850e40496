// The exact data kernels at F = 256, 512, 2048 and 4096, each symbol's
// antenna rows side by side over the card: fft_mrc.cu fft_mrc_side_kernel
// and mrc_demod.cu mrc_demod_side_kernel run side_rows below, each with its
// own store.
//
// The rows.  A launch has N = K S A antenna rows (symbol item = k S + s,
// row g = item A + a) and a grid of B blocks of kTeams teams (plan_blocks;
// ops/fft_plan.py side_plan): at most kBlocksPerSm an SM and one for each
// kTeams rows, and of the grids whose teams' chain of rows is at most one
// row longer than that fullest one's, the largest whose blocks take whole
// symbols (a symbol split over blocks costs ~1.5 rows of finish).  Team u of
// the U = B kTeams takes the contiguous rows [u N / U, (u + 1) N / U), so
// block b takes [b N / B, (b + 1) N / B) as fft_spread.cuh's blocks do.
// One 16 x F x 100 frame is 100 blocks of one symbol: 16 one-row teams at
// F = 256 and 512 (every row of the frame in flight at once), four
// 128-thread teams of 4 rows at 2048, two 256-thread teams of 8 rows at
// 4096; a streamed symbol (S = 1) is one block at 256 and 512, four at 2048,
// eight at 4096, one row a team.  Where the register plans (fft_warp.cuh
// Plan<F>) hold 32 values a thread at 512-4096, the side form holds 16
// (SidePlan<F>: radices 16, 16 at 256; 16, 16, 2 at 512; 16, 16, 8 at 2048;
// 16, 16, 16 at 4096), so that a thread's row and sums fit 128 registers
// and an SM holds 16 warps.  A team runs its rows in sequence on
// fft_warp.cuh's passes: row i + 1 is copied into the second of two buffers
// (cp.async, or element copies where the rows are not 16-byte aligned)
// while row i is transformed; once row i's last exchange is read, h's row
// for it is copied into row i's buffer (cp.async through L1, stage_h),
// landing while the last pass runs (a team's last row takes its h into the
// other buffer with the row's own copy), and Y conj(h) (mrc_demod: Y hc) is
// added into the team's sums in registers: a team reads h only for the rows
// it takes.  The pass twiddles are the float32 table computed in float64
// (ops/fft_plan.py side_twiddles_np), copied into shared memory by
// cp.async.  No __sinf, no fast-math.
//
// The sum over the antennas, in a fixed order (no float atomics):
//   - a symbol whose rows all fall in one team is stored by it from its
//     registers;
//   - otherwise each of its teams keeps a partial: of the team's last
//     symbol in its first buffer (shared memory), of its first symbol (when
//     the team goes on past it) in the scratch's team slot (L2).  After one
//     __syncthreads the block adds, for each such symbol, the partials of
//     its teams in team order;
//   - a symbol whose rows span blocks is then handed in as fft_spread.cuh's
//     are: the block's partial into the scratch's block slot (0 for its
//     first symbol, 1 for its last), a device-scope count per symbol, and
//     the last block to count (or one that finds every other counted) adds
//     the partials of blocks first .. last in block order, sets the count
//     back to 0 for the next launch on the stream, and stores.
// The finish runs once a block, from a cold instruction cache: its loops
// stay rolled and every integer division is done once (the team
// boundaries, and each shared symbol's teams, before the barrier).

#pragma once

#include <cstdint>

#include "fft_spread.cuh"
#include "fft_warp.cuh"

namespace ofdm {
namespace wfft {

// F -> radices (R0 = M = 16, R2 = 1 for two passes), teams per symbol (1:
// the side form's teams take rows, not antennas), threads per block, blocks
// an SM (__launch_bounds__) and the exchange's padding stride (32 where a
// team is a warp or more: a warp's 32 consecutive positions in one run).
// Mirrored by ops/fft_plan.py SIDE_PLANS.
#define OFDM_SIDE_PLAN(F_, R0_, R1_, R2_, BLOCK_, MINB_, PAD_)            \
  template <>                                                            \
  struct SidePlan<F_> {                                                  \
    static constexpr int R0 = R0_, R1 = R1_, R2 = R2_, P = 1;            \
    static constexpr int kBlock = BLOCK_, kMinBlocks = MINB_, kPad = PAD_; \
  };
OFDM_SIDE_PLAN(256, 16, 16, 1, 256, 2, 16)
OFDM_SIDE_PLAN(512, 16, 16, 2, 512, 1, 32)
OFDM_SIDE_PLAN(2048, 16, 16, 8, 512, 1, 32)
OFDM_SIDE_PLAN(4096, 16, 16, 16, 512, 1, 32)
#undef OFDM_SIDE_PLAN

}  // namespace wfft

namespace side {

__host__ __device__ constexpr bool covers(int F) {
  return F == 256 || F == 512 || F == 2048 || F == 4096;
}

template <int F>
struct Shape {
  using PL = wfft::SidePlan<F>;
  using G = wfft::Geo<F, PL>;
  static constexpr int kM = G::M;                  // 16 values a thread
  static constexpr int kT = G::T;                  // threads of a team
  static constexpr int kTeams = G::kTeams;         // teams of a block
  static constexpr int kBlock = G::kBlock;
  static constexpr int kBlocksPerSm = PL::kMinBlocks;
  static constexpr int kPlane = G::kPlane;
  static constexpr int kBins = F / kBlock;         // a thread's bins in the block's sums
  static constexpr int kSlots = 2 + kTeams;        // a block's partials in the scratch
  // Dynamic shared memory, in floats: the pass twiddles, each team's two
  // row buffers (two planes each, fft_warp.cuh kTeamFloats), a flag padded
  // to 16 bytes, the block's kTeams + 1 team boundaries padded to 16 bytes,
  // then an int4 for each boundary (ops/fft_plan.py side_smem_bytes).
  static constexpr int kTeamOffset = 2 * G::kTwiddles;
  static constexpr int kFlagOffset = kTeamOffset + kTeams * G::kTeamFloats;
  static constexpr int kBoundInts = (kTeams + 4) / 4 * 4;
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kFlagOffset + 4 + kBoundInts + 4 * (kTeams + 1)) * sizeof(float);
  static_assert(kM == 16 && kBins >= 1 && kBins * kBlock == F, "side plan");
  // slot(base + d) = slot(base) + slot_step(d) for every exchange access:
  // with kPad = 32 the bases are multiples of 16 (pass 1) or below 16 mod 32
  // (pass 2, Ns = 16) and a warp reads 32 consecutive positions (T % 32 == 0).
  static_assert(G::kPad == kM || (G::kPad == 2 * kM && kT % 32 == 0 && PL::R1 == kM),
                "affine exchange slots");
  static_assert(kTeamOffset % 4 == 0 && G::kTeamFloats % 4 == 0 && G::kTwiddles % 2 == 0,
                "16-byte twiddle pieces and row buffers");
};

// First row of team u of U (ops/fft_plan.py side_team_rows); block b's
// first row is team_lo(rows, blocks kTeams, b kTeams) = spread::block_lo.
// 32-bit division where the product fits (a 64-bit one is a long call).
__host__ __device__ __forceinline__ int team_lo(long long rows, long long teams, long long u) {
  const unsigned long long x = static_cast<unsigned long long>(rows) * u;
  return static_cast<int>(x >> 32 ? x / teams
                                  : static_cast<unsigned>(x) / static_cast<unsigned>(teams));
}

// The block whose rows hold row g (spread::block_of): the largest b with
// team_lo(rows, blocks, b) <= g, by the same 32-bit path.
__device__ __forceinline__ int block_of(long long rows, int blocks, int g) {
  const unsigned long long x = static_cast<unsigned long long>(g + 1) * blocks - 1;
  return static_cast<int>(x >> 32 ? x / rows
                                  : static_cast<unsigned>(x) / static_cast<unsigned>(rows));
}

// Blocks of a launch of N rows of A antennas on a card of `sms` SMs
// (ops/fft_plan.py side_plan): at most kBlocksPerSm an SM and one for each
// kTeams rows; of those, the most blocks that each take whole symbols (B
// divides the N / A symbols) where their teams' chain of rows is at most
// one row longer than the fullest grid's, since a symbol split over blocks
// costs its blocks ~1.5 rows of finish (tools/spread_trace.py, PERF.md).
template <int F>
__host__ inline int plan_blocks(long long rows, int A, int sms) {
  constexpr long long kTeams = Shape<F>::kTeams;
  const long long most = (rows + kTeams - 1) / kTeams;
  const long long fit = static_cast<long long>(Shape<F>::kBlocksPerSm) * sms;
  const long long full = most < fit ? most : fit;
  const long long chain = (rows + full * kTeams - 1) / (full * kTeams);
  for (long long b = full; b >= 1 && (rows + b * kTeams - 1) / (b * kTeams) <= chain + 1; --b) {
    if ((rows / A) % b == 0) return static_cast<int>(b);
  }
  return static_cast<int>(full);
}

// The plan the wrapper passed (blocks, dynamic shared memory) against the
// kernel's own for N rows on the current device, and h's planes 16-byte
// aligned (its rows are copied in 16-byte pieces).
template <int F>
__host__ inline bool plan_ok(long long rows, int A, int blocks, long long smem,
                             const float* h_re, const float* h_im) {
  int sms = 0;
  if (rows < 1 || rows >= (1LL << 31) || sm_count(&sms) != cudaSuccess) return false;
  if (reinterpret_cast<uintptr_t>(h_re) % 16 || reinterpret_cast<uintptr_t>(h_im) % 16) {
    return false;
  }
  return blocks == plan_blocks<F>(rows, A, sms) &&
         smem == static_cast<long long>(Shape<F>::kSmemBytes);
}

// plan_ok<F> for F at run time; false for an F the side form does not take.
__host__ inline bool plan_ok(int F, long long rows, int A, int blocks, long long smem,
                             const float* h_re, const float* h_im) {
  switch (F) {
    case 256:
      return plan_ok<256>(rows, A, blocks, smem, h_re, h_im);
    case 512:
      return plan_ok<512>(rows, A, blocks, smem, h_re, h_im);
    case 2048:
      return plan_ok<2048>(rows, A, blocks, smem, h_re, h_im);
    case 4096:
      return plan_ok<4096>(rows, A, blocks, smem, h_re, h_im);
    default:
      return false;
  }
}

// Partial `slot` of block b in the scratch [blocks, kSlots, F] (float2):
// 0 and 1 the block's first and last symbol, 2 + t team t's first symbol.
template <int F>
__device__ __forceinline__ float2* partial(const spread::Args& p, int b, int slot) {
  return reinterpret_cast<float2*>(p.partials) +
         (static_cast<long long>(b) * Shape<F>::kSlots + slot) * F;
}

// h's row (two planes of F floats) into buf in 16-byte pieces through L1
// (cp.async.ca): the rows of a frame share its h, which L1 holds at the
// smaller F.
template <int F>
__device__ __forceinline__ void stage_h(float* buf, const float* __restrict__ h_re,
                                        const float* __restrict__ h_im, int j) {
  using S = Shape<F>;
#pragma unroll
  for (int u = 0; u < F / 4 / S::kT; ++u) {
    const int c = 4 * (j + u * S::kT);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(buf + plane * S::kPlane + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"((plane ? h_im : h_re) + c)
                   : "memory");
    }
  }
}

// FFT of the row staged (raw, element type E) in buf; on return register m
// holds bin j + kT m.  With with_h, once every thread has read the last
// exchange, the row's h (h_re, h_im: F floats each) is copied into buf
// (cp.async, committed, not waited for): it lands while the last pass runs.
template <int F, typename E>
__device__ __forceinline__ void row_fft(float2 (&v)[Shape<F>::kM], float* buf,
                                        const float2* __restrict__ tw,
                                        const float* __restrict__ h_re,
                                        const float* __restrict__ h_im, bool with_h,
                                        const wfft::Team<Shape<F>::kT>& team) {
  using S = Shape<F>;
  using PL = typename S::PL;
  const int j = team.j;
  const E* const sre = reinterpret_cast<const E*>(buf);
  const E* const sim = reinterpret_cast<const E*>(buf + S::kPlane);
#pragma unroll
  for (int m = 0; m < S::kM; ++m) {
    v[m] = make_float2(wfft::widen(sre[j + S::kT * m]), wfft::widen(sim[j + S::kT * m]));
  }
  wfft::run_pass<F, PL::R0, 1, PL>(v, tw, j);
  team.sync();  // the staged row has been read
  wfft::write_exchange<F, PL::R0, 1, PL>(v, buf, j);
  team.sync();
  wfft::read_exchange<F, PL>(v, buf, j);
  if constexpr (PL::R2 > 1) {
    wfft::run_pass<F, PL::R1, PL::R0, PL>(v, tw, j);
    team.sync();
    wfft::write_exchange<F, PL::R1, PL::R0, PL>(v, buf, j);
    team.sync();
    wfft::read_exchange<F, PL>(v, buf, j);
  }
  if (with_h) {
    team.sync();  // the buffer is free
    stage_h<F>(buf, h_re, h_im, j);
    wfft::cp_async_commit();
  }
  if constexpr (PL::R2 > 1) {
    wfft::run_pass<F, PL::R2, PL::R0 * PL::R1, PL>(v, tw + S::G::kTw1, j);
  } else {
    wfft::run_pass<F, PL::R1, PL::R0, PL>(v, tw, j);
  }
}

// Built with -DOFDM_SPREAD_TRACE (tools/spread_trace.py --fft F), thread 0
// of each block (team 0's lane 0) stamps %globaltimer into fft_spread.cuh's
// spread_trace [blocks][64][8]: for each of team 0's first 62 rows 0 its
// start, 1 its copy landed, 2 its FFT and h's copy done, 3 its
// multiply-add done, 4 (a row that ends a symbol the team goes on past) the
// symbol stored or handed to the team slot; row slot 63: 0 the block's
// start, 1 team 0's last row done, 2 the block's partials barrier passed, 3
// the block's shared symbols stored or handed in; row slot 62, for each of
// the block's first two shared symbols (4 s + k): 0 its turn began, 1 its
// teams' partials added, 2 its blocks' added (or none to add), 3 stored.
#ifdef OFDM_SPREAD_TRACE
#define OFDM_SIDE_STAMP(i, k) spread::stamp(b, i, k, threadIdx.x)
#else
#define OFDM_SIDE_STAMP(i, k)
#endif

// The launch's rows: FFT, Y conj(h) (kConjugate) or Y hc, the sum over each
// symbol's antennas, and store(item, t, value, g) of each bin t of every
// symbol (value: the sum, unscaled; g = gain(item, t), every gain of a store
// loaded before its first write, which the compiler cannot move the loads
// past).  Integer division is kept off the
// chains: the block's team boundaries are computed once (64-bit products),
// and the partials of other blocks are read kInFlight blocks at a time.
template <int F, typename E, bool kAligned, bool kConjugate, typename Gain, typename Store>
__device__ __forceinline__ void side_rows(const spread::Args& p, Gain gain, Store store) {
  using S = Shape<F>;
  constexpr int kInFlight = S::kBins < 8 ? 8 / S::kBins : 1;  // blocks' partials read at once
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float2* const tw = reinterpret_cast<float2*>(smem);
  int* const flag = reinterpret_cast<int*>(smem + S::kFlagOffset);
  int* const bound = flag + 4;  // the block's team boundaries e_0 .. e_kTeams
  // Per boundary e: the symbol it is the first to split (or -1), its first
  // and last team in the block, its count as read after the rows.
  int4* const info = reinterpret_cast<int4*>(bound + S::kBoundInts);
  const wfft::Team<S::kT> team;
  const int j = team.j, t = team.id;
  const int b = blockIdx.x;
  OFDM_SIDE_STAMP(63, 0);
  const long long teams = static_cast<long long>(p.blocks) * S::kTeams;
  const long long t0 = static_cast<long long>(b) * S::kTeams;
  const int lo = team_lo(p.rows, teams, t0 + t);
  const int n = team_lo(p.rows, teams, t0 + t + 1) - lo;
  const int A = p.A;
  const E* const y_re = static_cast<const E*>(p.y_re);
  const E* const y_im = static_cast<const E*>(p.y_im);
  float* const bufs = smem + S::kTeamOffset + t * S::G::kTeamFloats;
  auto buf = [&](int i) { return bufs + (i & 1) * 2 * S::kPlane; };

  // Row g -> its symbol, antenna, sample offset and h row.
  struct Row {
    int item, a;
    long long off, hrow;
  };
  auto row_of = [&](int g) {
    Row r;
    r.item = g / A;
    r.a = g - r.item * A;
    const int k = r.item / p.S;
    r.off = k * p.stride_k + static_cast<long long>(r.item - k * p.S) * p.stride_s +
            r.a * p.stride_a;
    r.hrow = (static_cast<long long>(k) * A + r.a) * F;
    return r;
  };
  auto stage = [&](int i) {
    const Row r = row_of(lo + i);
    wfft::stage_row<F, E, kAligned, typename S::PL>(buf(i), y_re + r.off, y_im + r.off, j);
  };
  // h's row of the team's last row, into the buffer no next row needs.
  auto stage_last_h = [&](int i) {
    const Row r = row_of(lo + i);
    stage_h<F>(buf(i + 1), p.h_re + r.hrow, p.h_im + r.hrow, j);
  };

  // The pass twiddles (16-byte pieces, their own group), then row 0.
  for (int i = threadIdx.x; i < S::G::kTwiddles / 2; i += S::kBlock) {
    wfft::cp_async16(tw + 2 * i, p.tw + 2 * i);
  }
  wfft::cp_async_commit();
  if (n > 0) {
    stage(0);
    // The gains of the block's stores (its team's first frame), into L1
    // while the rows run.
    const float* const gain = p.gain + static_cast<long long>(lo / A / p.S) * p.gain_stride;
#pragma unroll
    for (int c = 0; c < S::kBins; ++c) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(gain + threadIdx.x + S::kBlock * c));
    }
  }
  wfft::cp_async_commit();
  if (j == 0) {
    bound[t] = lo;
    if (t == S::kTeams - 1) bound[S::kTeams] = lo + n;
  }
  wfft::cp_async_wait<1>();  // this thread's twiddles (row 0 may be in flight)
  __syncthreads();           // every thread's twiddles, the boundaries

  float2 s[S::kM];
  for (int i = 0; i < n; ++i) {
    OFDM_SIDE_STAMP(i, 0);
    const bool more = i + 1 < n;
    if (more) {
      stage(i + 1);
    } else {
      stage_last_h(i);
    }
    wfft::cp_async_commit();
    wfft::cp_async_wait<1>();
    team.sync();  // row i has landed for every thread of the team
    OFDM_SIDE_STAMP(i, 1);
    const Row r = row_of(lo + i);
    float2 v[S::kM];
    row_fft<F, E>(v, buf(i), tw, p.h_re + r.hrow, p.h_im + r.hrow, more, team);
    wfft::cp_async_wait<0>();
    team.sync();  // h's row has landed for every thread
    OFDM_SIDE_STAMP(i, 2);
    const float* const hr = buf(more ? i : i + 1) + j;
    const float* const hi = hr + S::kPlane;
    const bool first = i == 0 || r.a == 0;  // the symbol's first row in the team
#pragma unroll
    for (int m = 0; m < S::kM; ++m) {
      const float2 x = spread::mac<kConjugate>(v[m], make_float2(hr[S::kT * m], hi[S::kT * m]));
      s[m] = first ? x : make_float2(s[m].x + x.x, s[m].y + x.y);
    }
    OFDM_SIDE_STAMP(i, 3);
    if (i < n - 1 && r.a == A - 1) {  // the team ends this symbol and goes on
      if (r.item * A >= lo) {  // all its rows in the team: stored
        float g[S::kM];
#pragma unroll
        for (int m = 0; m < S::kM; ++m) g[m] = gain(r.item, j + S::kT * m);
#pragma unroll
        for (int m = 0; m < S::kM; ++m) store(r.item, j + S::kT * m, s[m], g[m]);
      } else {  // the team's first symbol, begun before it: its team slot
        float2* const part = partial<F>(p, b, 2 + t) + j;
#pragma unroll
        for (int m = 0; m < S::kM; ++m) __stcg(part + S::kT * m, s[m]);
      }
      OFDM_SIDE_STAMP(i, 4);
    }
    team.sync();  // buffer i is free for row i + 2
  }
  OFDM_SIDE_STAMP(63, 1);
  const int blo = bound[0], bhi = bound[S::kTeams];
  if (threadIdx.x <= S::kTeams) {
    // The symbol holding boundary e strictly inside (where e is the first
    // boundary in it): its first and last team in the block, and where its
    // rows span blocks its count as read now (as fft_spread.cuh reads it
    // early: a block that finds every other block counted hands nothing in).
    const int e = threadIdx.x, at = bound[e], item = at / A;
    int4 in = make_int4(-1, 0, 0, 0);
    if (at % A != 0 && (e == 0 || bound[e - 1] <= item * A)) {
      const int r0 = max(item * A, blo), r1 = min(item * A + A, bhi) - 1;
      in.x = item;
      for (int q = 0; q < S::kTeams; ++q) {  // the team of a row: the last q with bound[q] <= row
        if (bound[q] <= r0) in.y = q;
        if (bound[q] <= r1) in.z = q;
      }
      if (item * A < blo || item * A + A > bhi) {
        unsigned seen;
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(p.counters + item));
        in.w = static_cast<int>(seen);
      }
    }
    info[e] = in;
  }
  if (n == 0) {  // no row: zeros, which the block's sum adds for a team between qa and qb
#pragma unroll
    for (int m = 0; m < S::kM; ++m) bufs[j + S::kT * m] = bufs[S::kPlane + j + S::kT * m] = 0.0f;
  } else {  // the team's last symbol: stored if all its rows are the team's, else kept
    const int item = (lo + n - 1) / A;
    if (item * A >= lo && item * A + A <= lo + n) {
      float g[S::kM];
#pragma unroll
      for (int m = 0; m < S::kM; ++m) g[m] = gain(item, j + S::kT * m);
#pragma unroll
      for (int m = 0; m < S::kM; ++m) store(item, j + S::kT * m, s[m], g[m]);
    } else {
#pragma unroll
      for (int m = 0; m < S::kM; ++m) {
        bufs[j + S::kT * m] = s[m].x;
        bufs[S::kPlane + j + S::kT * m] = s[m].y;
      }
    }
  }
  __syncthreads();  // every team's partials, the shared symbols
  OFDM_SIDE_STAMP(63, 2);

  // The symbols whose rows span teams (they hold a team boundary of the
  // block, e_0 = its first row .. e_kTeams = its end, strictly inside): a
  // compact loop, as the block runs this code once, from a cold
  // instruction cache.
  int shared_symbols = 0;  // (traced builds: the first two get slot 62's stamps)
  for (int e = 0; e <= S::kTeams; ++e) {
    const int4 in = info[e];
    const int item = in.x, qa = in.y, qb = in.z;
    if (item < 0) continue;
    OFDM_SIDE_STAMP(62, shared_symbols < 2 ? 4 * shared_symbols : 7);
    const int first_row = item * A;
    float g[S::kBins];  // its gains, loading while its partials are added
#pragma unroll
    for (int c = 0; c < S::kBins; ++c) g[c] = gain(item, threadIdx.x + S::kBlock * c);
    // Its teams' partials in team order: a team's last symbol from its
    // buffer, its first (where it goes on past it: only team qb) from its
    // team slot; the teams between qa and qb hold no other symbol, or no
    // row (their buffers hold zeros).
    auto kept = [&](int q, int bin) {
      const float* const qbuf = smem + S::kTeamOffset + q * S::G::kTeamFloats;
      return make_float2(qbuf[bin], qbuf[S::kPlane + bin]);
    };
    auto part = [&](int q, int bin) {
      return bound[q + 1] <= first_row + A ? kept(q, bin) : __ldcg(partial<F>(p, b, 2 + q) + bin);
    };
    auto add = [](float2 a, float2 x) { return make_float2(a.x + x.x, a.y + x.y); };
    float2 acc[S::kBins];
#pragma unroll
    for (int c = 0; c < S::kBins; ++c) acc[c] = part(qa, threadIdx.x + S::kBlock * c);
    int q = qa + 1;
    for (; q + 4 <= qb; q += 4) {  // four middle teams' loads at once
#pragma unroll
      for (int c = 0; c < S::kBins; ++c) {
        const int bin = threadIdx.x + S::kBlock * c;
        const float2 x0 = kept(q, bin), x1 = kept(q + 1, bin), x2 = kept(q + 2, bin),
                     x3 = kept(q + 3, bin);
        acc[c] = add(add(add(add(acc[c], x0), x1), x2), x3);
      }
    }
    for (; q < qb; ++q) {
#pragma unroll
      for (int c = 0; c < S::kBins; ++c) acc[c] = add(acc[c], kept(q, threadIdx.x + S::kBlock * c));
    }
    if (qb > qa) {
#pragma unroll
      for (int c = 0; c < S::kBins; ++c) acc[c] = add(acc[c], part(qb, threadIdx.x + S::kBlock * c));
    }
    OFDM_SIDE_STAMP(62, shared_symbols < 2 ? 4 * shared_symbols + 1 : 7);
    bool mine = true;
    if (first_row < blo || first_row + A > bhi) {  // its rows span blocks
      const int b0 = block_of(p.rows, p.blocks, first_row);
      const int b1 = block_of(p.rows, p.blocks, first_row + A - 1);
      unsigned* const count = p.counters + item;
      if (in.w == b1 - b0) {  // every other block has counted: this one adds, hands nothing in
        if (threadIdx.x == 0) {
          __threadfence();  // the others' partials after the count
          *count = 0u;      // 0 for the next launch
        }
        __syncthreads();
      } else {  // hand in the block's partial and count in
        float2* const own = partial<F>(p, b, first_row <= blo ? 0 : 1);  // its first: slot 0
#pragma unroll
        for (int c = 0; c < S::kBins; ++c) __stcg(own + threadIdx.x + S::kBlock * c, acc[c]);
        __syncthreads();  // the block's partial is written
        if (threadIdx.x == 0) {
          __threadfence();  // the partial before the count
          const bool last = atomicAdd(count, 1u) == static_cast<unsigned>(b1 - b0);
          if (last) {
            __threadfence();  // the others' partials after the count
            *count = 0u;      // every block has counted: 0 for the next launch
          }
          *flag = last;
        }
        __syncthreads();
        mine = *flag;
      }
      if (mine) {  // the partials of blocks b0 .. b1 in block order, this one's from registers
        // Block q's slot: 0 where the symbol is its first (every block after
        // b0; b0 where its rows begin with the symbol's), else 1.
        const int slot0 = team_lo(p.rows, p.blocks, b0) == first_row ? 0 : 1;
        float2 sum[S::kBins];
        for (int bq = b0; bq <= b1; bq += kInFlight) {
          float2 x[kInFlight][S::kBins];
#pragma unroll
          for (int f = 0; f < kInFlight; ++f) {
            if (bq + f <= b1 && bq + f != b) {
              const float2* const src =
                  partial<F>(p, bq + f, bq + f == b0 ? slot0 : 0) + threadIdx.x;
#pragma unroll
              for (int c = 0; c < S::kBins; ++c) x[f][c] = __ldcg(src + S::kBlock * c);
            }
          }
#pragma unroll
          for (int f = 0; f < kInFlight; ++f) {
            if (bq + f <= b1) {
#pragma unroll
              for (int c = 0; c < S::kBins; ++c) {
                const float2 y = bq + f == b ? acc[c] : x[f][c];
                sum[c] = bq + f == b0 ? y : add(sum[c], y);
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < S::kBins; ++c) acc[c] = sum[c];
      }
      __syncthreads();  // the flag is read before the next symbol's
    }
    OFDM_SIDE_STAMP(62, shared_symbols < 2 ? 4 * shared_symbols + 2 : 7);
    if (mine) {
#pragma unroll
      for (int c = 0; c < S::kBins; ++c) store(item, threadIdx.x + S::kBlock * c, acc[c], g[c]);
    }
    OFDM_SIDE_STAMP(62, shared_symbols < 2 ? 4 * shared_symbols + 3 : 7);
    ++shared_symbols;
  }
  OFDM_SIDE_STAMP(63, 3);
}

// Launch of kernel over the plan's blocks.
template <int F, typename Kernel>
cudaError_t launch(Kernel kernel, const spread::Args& p, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, Shape<F>::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, Shape<F>::kBlock, Shape<F>::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace side
}  // namespace ofdm
