// Pilot LS channel estimate for K frames in one launch: FFT of each pilot
// row, h = Y * conj(X) / |X|^2 and inv = 1 / sum_a |h|^2 -- or, with
// invert = 0, the sum itself: an antenna shard's partial sum, which the
// sharded receiver adds over the shards before it divides
// (parallel/sharded.py; the TPU's sharded body took this sum outside its
// kernel, ofdm_ls_mrc_tpu/parallel/sharded.py:112-114).
//
// Replaces ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:_pilot_kernel (:222,
// wrapper estimate_pilot_fused :264).  The TPU kernel ran one program over
// all antennas and reduced sum_a |h|^2 in VMEM.  Here each frame's antenna
// rows spread over teams of a register FFT on one or more blocks, and the
// sum over the antennas is added in shared memory, across blocks through
// distributed shared memory, in a fixed order (no float atomics).  As in
// the TPU fused path the DC bin is not masked: X[0] = 1 and the data kernel
// drops that bin at its store.  Rows are read in place through the
// caller's strides (cp.async for 16-byte aligned rows, element loads for an
// odd cyclic prefix).  The geometry is ops/fft_plan.py pilot_plan, passed
// in by the wrapper and checked here.
//
// Bound on this card: one 16 x F f32 pilot reads 128 F bytes of rows and
// 8 F of X and writes 128 F of h and 4 F of inv (0.27 MB at F = 1024),
// 0.02-0.33 us at 3.35 TB/s for F = 256-4096, and its ~5 F log2 F FLOP a
// row are far under the fp32 rate: it is latency-bound, a chain of a row
// load, a row FFT, the LS and stores, the sum over the antennas and the
// stores of inv, each one SM deep.
//
// F = 64, 128, 256, 512, 2048 and 4096: the push form (pilot_ls_push_kernel
// below).  What bound the cluster form here (tools/spread_trace.py --pilot,
// PERF.md): the row FFT's twiddles read through L1 from device memory, a
// cold miss on each pass's first read; at 512-4096 32 values a thread, at
// 2048-4096 (64 antennas) 4 rows a team in series; a cluster barrier of
// ~0.5 us even where the cluster was one block, and a second one before the
// exit.  The push form: one row a team on as many blocks of up to 4 warps
// (one team where a team is more) as the rows need, up to a cluster of 16
// (the non-portable size; larger blocks only where 16 do not hold every
// row: 64 x 2048, 64 x 4096), 16 values a thread from 256 (fft_side.cuh's
// plans; fft_warp.cuh's at 64 and 128); each team's row 0 and the first
// passes' twiddles in one cp.async group, X and the last pass's twiddles
// in a second, waited for before row 0's last pass, so no pass reads a
// twiddle from device memory; a frame that one block holds launches with
// no cluster and adds its teams' sums after one __syncthreads; in a
// cluster each block pushes its partial of each bin into the owner rank's
// shared memory (16-byte distributed shared memory stores), one cluster
// barrier, and the owner adds the blocks' slots in rank order.  16 warps
// on one SM (one 512-thread block of every row at 512, four four-warp
// teams a block at 2048) measured slower than the parent at 512 and 2048
// (PERF.md, PR 20): the passes ran 1.2 us each.  What is left: the
// row load (~0.9-1.2 us from the launch), and in a cluster the push, the
// barrier and the owner's sum (~1.3-2.0 us).
//
// F = 1024: the cluster form (pilot_ls_kernel below; PR 4): grid (C, K),
// cluster (C, 1, 1), each block a few one-warp teams of the register FFT
// of csrc/fft_warp.cuh.  Team g of the cluster (g = rank * teams + team)
// takes antenna rows g, g + C * teams, ...; a team's row goes through
// row_fft, after which register m holds bin t = j + T m; the LS divide, the
// sc16 scale, the coalesced store of h and the sum of |h_t|^2 over the
// team's rows all happen in registers.  The block adds its teams' sums in
// shared memory; after cluster.sync() rank r adds its share of the bins
// (fft_plan.pilot_rank_bins) over the C blocks' shared memory (distributed
// shared memory) and writes inv; a second cluster.sync() keeps every block
// resident until its peers have read it.  X is staged in shared memory
// with the first row; the pass twiddles are read through L1.  A team per
// row (16 warps on 4 SMs at A = 16), no block barrier inside a row, and no
// second launch.  (The kernel it replaced ran a 256-thread block per row
// through a shared-memory radix-2 FFT with a block barrier at each of its
// 10 stages, then a second kernel read all of h back to sum |h|^2.)
// F = 8192 (pilot_ls_row_kernel below): 4 blocks per antenna row, F = 64 x
// 128 split across them, a thread block cluster of G rows (G = 4, 2 or 1,
// the largest dividing A; grid (4 A, K)): block r of a row runs the column
// FFT of columns 32 r .. 32 r + 31 (fft_split.cuh column_load +
// column_fft, the four-step twiddle in), and after a cluster barrier the
// 128-point FFT of rows k1 = 16 r .. 16 r + 15, each gathered from its
// row's four blocks' columns through distributed shared memory, then h =
// Y conj(X) scale / |X|^2 stored as it is formed and |h|^2 kept in shared
// memory.  Sum_a |h|^2 is a tree with no float atomics (the same sums every
// run): the cluster's G blocks of rank r add their rows' |h|^2 through
// distributed shared memory, each a G-th of the rank's bins, in row order,
// into the cluster's partial; per frame and block slot a device-scope count
// of the A / G clusters' blocks, and the block that completes it adds the
// partials of its bins in cluster order and writes inv (or the sum),
// setting the count back to 0 for the next launch on the stream (with one
// cluster, A = G, it writes inv at once).  So a 16 x 8192 pilot runs on 64
// SMs, no SM with more than a 64-point and a 128-point FFT in its chain,
// where the register plan before it ran 8 blocks of two 8192-point rows in
// series (~12.9 us on an H100).  (The sum's first level through device
// memory, the last block of a group of four rows reading their h from L2,
// cost ~4 of 11.6 us; PERF.md.)
// F = 16384 and 32768: the split form (fft_split.cuh): the column pass, then
// pilot_ls_rows_kernel below, a cluster of up to 8 blocks for each 8 bins
// k1 of a frame, the antennas spread over its blocks (16 x 16384: 16
// clusters of 8 blocks of two one-row antenna teams; 16 x 32768: 32 of 2
// blocks of four two-row teams, so that the card holds every block at
// once), h stored as it is formed, sum |h|^2 added over the cluster in
// distributed shared memory as above; ptxas 176-179 registers, no spills.
// In the F = 1024 and split forms, loops whose trip count depends on the
// launch are bounded by constants (kMaxTeams, kMaxCluster) so that their
// loads issue together; their pass twiddles are read through L1.

#include <cooperative_groups.h>

#include <cstdint>

#include "fft_side.cuh"
#include "fft_split.cuh"

namespace ofdm {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the portable cluster size

// Built with -DOFDM_PILOT_TRACE (tools/spread_trace.py --pilot), thread 0 of
// each block stamps %globaltimer into pilot_trace [blocks][kPilotStamps]
// (block blockIdx.y gridDim.x + blockIdx.x): 0 its start, 1 row 0 landed
// (F = 1024: with X; the push form: with the first passes' twiddles), 2
// and 3 the first and second pass of row 0's FFT done (the push form), 4
// row 0's FFT done, 5 the team's rows' LS and stores done, 6 the teams'
// sums in the block's shared memory, 7 the barrier before the cross-block
// sum passed (the push form: the block's partials handed to their owners
// first; with one block a frame, its sum and inv stored), 8 inv stored.
// The port's build never defines it.
constexpr int kPilotStamps = 16;
#ifdef OFDM_PILOT_TRACE
static __device__ long long* pilot_trace;
__device__ __forceinline__ void pilot_stamp(int k) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (threadIdx.x == 0 && pilot_trace != nullptr) {
    pilot_trace[(static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kPilotStamps +
                k] = now;
  }
}
#define OFDM_PILOT_STAMP(k) pilot_stamp(k)
#else
#define OFDM_PILOT_STAMP(k)
#endif

// Most threads a pilot block of the register plans (F <= 4096) holds: 128,
// or two teams where a team is more than 64 threads (F = 4096: 256).
// Mirrored by ops/fft_plan.py pilot_max_threads.
template <int F>
__host__ __device__ constexpr int pilot_max_threads() {
  return 2 * wfft::Geo<F>::T > 128 ? 2 * wfft::Geo<F>::T : 128;
}

// Dynamic shared memory of a block of `teams` teams: the teams' buffers, X
// (two planes of F floats), then the block's sum over its teams (F floats;
// one team sums into its first buffer).
template <int F>
__host__ __device__ constexpr size_t pilot_smem_bytes(int teams) {
  return (static_cast<size_t>(teams) * wfft::Geo<F>::kTeamFloats + 2 * F + (teams > 1 ? F : 0)) *
         sizeof(float);
}

template <int F, typename T, bool kAligned>
__global__ void __launch_bounds__(pilot_max_threads<F>())
pilot_ls_kernel(const T* __restrict__ y_re, const T* __restrict__ y_im,
                long long stride_k, long long stride_a, float scale, int A,
                const float* __restrict__ x_re, const float* __restrict__ x_im,
                const float2* __restrict__ tw, float* __restrict__ h_re,
                float* __restrict__ h_im, float* __restrict__ inv, int invert) {
  using G_ = wfft::Geo<F>;
  constexpr int M = G_::M, TT = G_::T;
  constexpr int kMaxTeams = pilot_max_threads<F>() / TT;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const wfft::Team<TT> team;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int teams = static_cast<int>(blockDim.x) / TT;
  const int k = blockIdx.y;
  const int j = team.j;
  float* const xs = smem + teams * G_::kTeamFloats;  // X: re [F], im [F]
  float* const bsum = teams > 1 ? xs + 2 * F : smem;  // the block's sum [F]
  OFDM_PILOT_STAMP(0);

  // This team's rows: g, g + step, ... < A.
  const int g = rank * teams + team.id;
  const int step = C * teams;
  const int n = g < A ? (A - g + step - 1) / step : 0;
  const T* const yr = y_re + k * stride_k;
  const T* const yi = y_im + k * stride_k;
  float* const buf0 = smem + team.id * G_::kTeamFloats;
  float* const buf1 = buf0 + 2 * G_::kPlane;

  // Row 0 of each team and X, in one copy group; X is shared by the block.
  if (n > 0) {
    const long long off = static_cast<long long>(g) * stride_a;
    wfft::stage_row<F, T, kAligned>(buf0, yr + off, yi + off, j);
  }
  for (int c = threadIdx.x; c < F / 2; c += blockDim.x) {  // 16-byte chunks of both planes
    const int off = (c % (F / 4)) * 4;
    wfft::cp_async16(xs + (c < F / 4 ? 0 : F) + off, (c < F / 4 ? x_re : x_im) + off);
  }
  wfft::cp_async_commit();
  wfft::cp_async_wait<0>();
  __syncthreads();  // X and every team's row 0 have landed
  OFDM_PILOT_STAMP(1);

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      const long long off = static_cast<long long>(g + (i + 1) * step) * stride_a;
      wfft::stage_row<F, T, kAligned>((i & 1) ? buf0 : buf1, yr + off, yi + off, j);
      wfft::cp_async_commit();
      wfft::cp_async_wait<1>();
    } else {
      wfft::cp_async_wait<0>();
    }
    team.sync();  // row i has landed for every thread of the team
    float2 v[M];
    // The pass twiddles are read from device memory through L1: no staging
    // in shared memory.
    wfft::row_fft<F, T>(v, (i & 1) ? buf1 : buf0, tw, team);
    if (i == 0) {
      OFDM_PILOT_STAMP(4);
    }
    const long long row = (static_cast<long long>(k) * A + g + i * step) * F;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int t = j + TT * m;
      const float xr = xs[t], xi = xs[F + t];
      // scale / |X|^2 by the fast reciprocal (2 ulp): the IEEE division
      // costs a dozen instructions a bin.
      const float den = __fdividef(scale, xr * xr + xi * xi);
      const float hr = (v[m].x * xr + v[m].y * xi) * den;
      const float hi = (v[m].y * xr - v[m].x * xi) * den;
      h_re[row + t] = hr;
      h_im[row + t] = hi;
      acc[m] += hr * hr + hi * hi;
    }
    team.sync();  // row i's buffer is free for row i + 2
  }
  OFDM_PILOT_STAMP(5);

  // The team's sums into its first buffer, the block's sum into bsum (a
  // block of one team: the buffer is bsum).
#pragma unroll
  for (int m = 0; m < M; ++m) buf0[j + TT * m] = acc[m];
  __syncthreads();
  for (int t = threadIdx.x; teams > 1 && t < F; t += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < kMaxTeams; ++p) {
      if (p < teams) s += smem[p * G_::kTeamFloats + t];
    }
    bsum[t] = s;
  }
  OFDM_PILOT_STAMP(6);
  cluster.sync();  // every block's bsum is written and visible to the cluster
  OFDM_PILOT_STAMP(7);

  // Rank r: bins [r F / C, (r + 1) F / C), summed over the C blocks.
  const int lo = rank * F / C, hi = (rank + 1) * F / C;
  float* const inv_k = inv + static_cast<long long>(k) * F;
  for (int t = lo + static_cast<int>(threadIdx.x); t < hi; t += blockDim.x) {
    float part[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      part[c] = c < C ? cluster.map_shared_rank(bsum, c)[t] : 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) s += part[c];
    inv_k[t] = invert ? 1.0f / s : s;
  }
  OFDM_PILOT_STAMP(8);
  cluster.sync();  // no block leaves while a peer still reads its bsum
}

// ---------------------------------------------------------------------------
// The push form: F = 64, 128, 256, 512, 2048 and 4096
// ---------------------------------------------------------------------------

// The row FFT of the push form at F: fft_warp.cuh's Plan<F> at 64 and 128
// (8 lanes a row, radices 8, 8 / 16, 8), fft_side.cuh's SidePlan<F> (16
// values a thread: radices 16, 16 / 16, 16, 2 / 16, 16, 8 / 16, 16, 16)
// from 256.  Mirrored by ops/fft_plan.py pilot_geometry.
template <int F>
struct PushPlanOf {
  using type = wfft::Plan<F>;
};
template <>
struct PushPlanOf<256> {
  using type = wfft::SidePlan<256>;
};
template <>
struct PushPlanOf<512> {
  using type = wfft::SidePlan<512>;
};
template <>
struct PushPlanOf<2048> {
  using type = wfft::SidePlan<2048>;
};
template <>
struct PushPlanOf<4096> {
  using type = wfft::SidePlan<4096>;
};

// Threads of a push block, at most, and blocks of a frame's cluster, at
// most: the non-portable size (ops/fft_plan.py PILOT_PUSH_THREADS,
// PILOT_PUSH_MAX_CLUSTER).
constexpr int kPushMaxThreads = 512;
constexpr int kPushMaxCluster = 16;

template <int F>
struct Push {
  using PL = typename PushPlanOf<F>::type;
  using G = wfft::Geo<F, PL>;
  static constexpr int M = G::M, T = G::T;
  static constexpr bool kThreePass = PL::R2 > 1;
  static constexpr int kTwFloats = 2 * G::kTwiddles;  // the pass twiddles, (cos, sin) pairs
  // The floats of the table the first copy group brings: every pass's at
  // two passes; at three the second pass's block (the last pass's block
  // and X come in the second group, waited for before row 0's last pass).
  static constexpr int kTwFirst = kThreePass ? 2 * G::kTw1 : kTwFloats;
  // A team's one row buffer (two planes), padded so that the teams sharing
  // a warp (T < 32) start T banks apart, as fft_warp.cuh's kTeamFloats.
  static constexpr int kNeed = 2 * G::kPlane;
  static constexpr int kTeamFloats =
      kNeed + (T < 32 ? ((T - kNeed % 32) % 32 + 32) % 32 : 0);
  static_assert(kTwFloats % 4 == 0 && kTwFirst % 4 == 0 && kTeamFloats % 4 == 0 && T % 4 == 0,
                "16-byte twiddle pieces, X, row buffers and float4 bins");
  // Floats of a block's slot of the sums at a rank: the most bins a rank
  // owns (T registers' worth for each of its ceil(M / C) registers).
  __host__ __device__ static constexpr int width(int clusters) {
    return T * ((M + clusters - 1) / clusters);
  }
  // Dynamic shared memory of a block of `teams` teams in a cluster of
  // `clusters`: the twiddles, X (two planes of F floats), each team's row
  // buffer, then, where the cluster is more than one block, a slot of the
  // sums for each of its blocks (ops/fft_plan.py pilot_smem_bytes).
  __host__ __device__ static constexpr size_t smem_bytes(int teams, int clusters) {
    return static_cast<size_t>(kTwFloats + 2 * F + teams * kTeamFloats +
                               (clusters > 1 ? clusters * width(clusters) : 0)) *
           sizeof(float);
  }
};

// FFT of the row staged (raw, element type E) in buf on the push form's
// plan, the twiddles tw in shared memory; on return register m holds bin
// j + T m.  Once every thread has read the last exchange, last() runs (row
// 0: the second copy group's wait and block barrier) and then next() may
// copy the team's next row into buf (it lands while the last pass runs).
// Row 0 of a team stamps its passes in a traced build.
template <int F, typename E, typename Last, typename Next>
__device__ __forceinline__ void push_row_fft(float2 (&v)[Push<F>::M], float* buf,
                                             const float2* __restrict__ tw,
                                             const wfft::Team<Push<F>::T>& team, bool first,
                                             Last last, Next next) {
  using S = Push<F>;
  using PL = typename S::PL;
  const int j = team.j;
  const E* const sre = reinterpret_cast<const E*>(buf);
  const E* const sim = reinterpret_cast<const E*>(buf + S::G::kPlane);
#pragma unroll
  for (int m = 0; m < S::M; ++m) {
    v[m] = make_float2(wfft::widen(sre[j + S::T * m]), wfft::widen(sim[j + S::T * m]));
  }
  wfft::run_pass<F, PL::R0, 1, PL>(v, tw, j);
  team.sync();  // the staged row has been read
  wfft::write_exchange<F, PL::R0, 1, PL>(v, buf, j);
  team.sync();
  wfft::read_exchange<F, PL>(v, buf, j);
  if (first) {
    OFDM_PILOT_STAMP(2);
  }
  if constexpr (S::kThreePass) {
    wfft::run_pass<F, PL::R1, PL::R0, PL>(v, tw, j);
    team.sync();
    wfft::write_exchange<F, PL::R1, PL::R0, PL>(v, buf, j);
    team.sync();
    wfft::read_exchange<F, PL>(v, buf, j);
    if (first) {
      OFDM_PILOT_STAMP(3);
    }
    last();
    next();
    wfft::run_pass<F, PL::R2, PL::R0 * PL::R1, PL>(v, tw + S::G::kTw1, j);
  } else {
    next();
    wfft::run_pass<F, PL::R1, PL::R0, PL>(v, tw, j);
  }
}

// The push form.  Grid (C, K): C blocks for each of the K frames, a thread
// block cluster of C where C > 1 (no cluster and no cluster barrier where
// one block holds every row); a block of `teams` teams of T threads.  Team
// g = rank teams + team of the frame takes antenna rows g, g + C teams, ...
// (one where the card has teams for every row; ops/fft_plan.py pilot_plan).
// The first cp.async group brings each team's row 0 and the twiddles of
// the first passes; the second X and, at three passes, the last pass's
// block of the table, waited for (one block barrier) once row 0's last
// exchange is read.  Each row's FFT reads the twiddles from shared memory,
// and each bin gives h = Y conj(X) scale / |X|^2, stored at once, and
// |h|^2 into the lane's sums.  After the rows each team writes its sums
// into its row buffer and, after one block barrier, the block adds its
// teams' sums in team order, 16 bytes (four bins) a thread at a time.  With
// one block a frame that is the sum: it writes inv (or the sum).  In a
// cluster, rank r owns the bins [T (r M / C), T ((r + 1) M / C)) (the
// registers [r M / C, (r + 1) M / C) of every lane): each block writes its
// partial of each bin into its slot of the owner's shared memory
// (distributed shared memory, 16-byte stores), one cluster barrier (its
// arrive releases the remote stores), and each rank adds its bins' C slots
// in rank order and writes inv.  No block reads another's shared memory
// after the barrier, so no second barrier keeps a block resident.  No float
// atomics: the same sums every run.  (Tried on the card and not kept,
// PERF.md: remote st.async stores counted on the owner's mbarrier in place
// of the barrier, 0.1-0.2 us faster on one frame but 1.3-3.4x slower on a
// capture of many frames; the last row's h stored after the arrive, slower.)
template <int F, typename E, bool kAligned>
__global__ void __launch_bounds__(kPushMaxThreads, 1)
pilot_ls_push_kernel(const E* __restrict__ y_re, const E* __restrict__ y_im,
                     long long stride_k, long long stride_a, float scale, int A,
                     const float* __restrict__ x_re, const float* __restrict__ x_im,
                     const float2* __restrict__ tw_g, float* __restrict__ h_re,
                     float* __restrict__ h_im, float* __restrict__ inv, int invert) {
  using S = Push<F>;
  using PL = typename S::PL;
  constexpr int M = S::M, TT = S::T;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float2* const tw = reinterpret_cast<float2*>(smem);
  float* const xs = smem + S::kTwFloats;  // X: re [F], im [F]
  const int teams = static_cast<int>(blockDim.x) / TT;
  float* const bufs = xs + 2 * F;  // the teams' row buffers
  float* const slots = bufs + teams * S::kTeamFloats;  // the cluster's blocks' slots [C][W]
  const wfft::Team<TT> team;
  const int C = static_cast<int>(gridDim.x);  // the cluster is the frame's blocks
  const int rank = static_cast<int>(blockIdx.x);
  const int k = blockIdx.y;
  const int j = team.j;
  OFDM_PILOT_STAMP(0);

  // This team's rows: g, g + step, ... < A.
  const int g = rank * teams + team.id;
  const int step = C * teams;
  const int n = g < A ? (A - g + step - 1) / step : 0;
  const E* const yr = y_re + k * stride_k;
  const E* const yi = y_im + k * stride_k;
  float* const buf = bufs + team.id * S::kTeamFloats;

  // Group 1: each team's row 0 and the first passes' twiddles; group 2: X
  // and the last pass's twiddles (at two passes: every copy in group 1).
  const float* const twf = reinterpret_cast<const float*>(tw_g);
  if (n > 0) {
    const long long off = static_cast<long long>(g) * stride_a;
    wfft::stage_row<F, E, kAligned, PL>(buf, yr + off, yi + off, j);
  }
  for (int c = threadIdx.x; c < S::kTwFirst / 4; c += blockDim.x) {
    wfft::cp_async16(smem + 4 * c, twf + 4 * c);
  }
  if constexpr (S::kThreePass) wfft::cp_async_commit();
  for (int c = S::kTwFirst / 4 + threadIdx.x; c < S::kTwFloats / 4; c += blockDim.x) {
    wfft::cp_async16(smem + 4 * c, twf + 4 * c);
  }
  for (int c = threadIdx.x; c < F / 2; c += blockDim.x) {  // 16-byte chunks of both planes
    const int off = (c % (F / 4)) * 4;
    wfft::cp_async16(xs + (c < F / 4 ? 0 : F) + off, (c < F / 4 ? x_re : x_im) + off);
  }
  wfft::cp_async_commit();
  if constexpr (S::kThreePass) {
    wfft::cp_async_wait<1>();
  } else {
    wfft::cp_async_wait<0>();
  }
  __syncthreads();  // row 0 and the first twiddles have landed for every thread
  OFDM_PILOT_STAMP(1);
  if constexpr (S::kThreePass) {
    if (n == 0) {  // a team without rows still meets row 0's barrier
      wfft::cp_async_wait<0>();
      __syncthreads();
    }
  }

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;
  for (int i = 0; i < n; ++i) {
    if (i > 0) {
      wfft::cp_async_wait<0>();
      team.sync();  // row i has landed for every thread of the team
    }
    float2 v[M];
    push_row_fft<F, E>(
        v, buf, tw, team, i == 0,
        [&]() {
          if (i == 0) {  // X and the last pass's twiddles have landed for every thread
            wfft::cp_async_wait<0>();
            __syncthreads();
          }
        },
        [&]() {  // row i + 1 into the buffer once row i's last exchange is read
          if (i + 1 < n) {
            const long long off = static_cast<long long>(g + (i + 1) * step) * stride_a;
            team.sync();  // every thread has read the exchange
            wfft::stage_row<F, E, kAligned, PL>(buf, yr + off, yi + off, j);
            wfft::cp_async_commit();
          }
        });
    if (i == 0) {
      OFDM_PILOT_STAMP(4);
    }
    const long long row = (static_cast<long long>(k) * A + g + i * step) * F;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int t = j + TT * m;
      const float xr = xs[t], xi = xs[F + t];
      // scale / |X|^2 by the fast reciprocal (2 ulp), as the other plans.
      const float den = __fdividef(scale, xr * xr + xi * xi);
      const float hr = (v[m].x * xr + v[m].y * xi) * den;
      const float hi = (v[m].y * xr - v[m].x * xi) * den;
      h_re[row + t] = hr;
      h_im[row + t] = hi;
      acc[m] += hr * hr + hi * hi;
    }
  }
  OFDM_PILOT_STAMP(5);

  // The team's sums into its row buffer (bin t at buf[t]), then the block's
  // sum of four bins at a time over its teams in team order.
  team.sync();  // the team is done with its buffer
#pragma unroll
  for (int m = 0; m < M; ++m) buf[j + TT * m] = acc[m];
  __syncthreads();  // every team's sums are in shared memory
  OFDM_PILOT_STAMP(6);
  auto block_sum = [&](int t) {
    float4 s = *reinterpret_cast<const float4*>(bufs + t);
    for (int p = 1; p < teams; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(bufs + p * S::kTeamFloats + t);
      s = make_float4(s.x + x.x, s.y + x.y, s.z + x.z, s.w + x.w);
    }
    return s;
  };
  auto store = [&](float* out, float4 s) {
    *reinterpret_cast<float4*>(out) =
        invert ? make_float4(1.0f / s.x, 1.0f / s.y, 1.0f / s.z, 1.0f / s.w) : s;
  };
  float* const inv_k = inv + static_cast<long long>(k) * F;
  if (C == 1) {
    for (int t = 4 * static_cast<int>(threadIdx.x); t < F; t += 4 * blockDim.x) {
      store(inv_k + t, block_sum(t));
    }
    OFDM_PILOT_STAMP(7);
  } else {
    // Bin t is register m = t / T's: rank o = ((m + 1) C - 1) / M owns it,
    // at position t - T (o M / C) of its slots.
    const int width = S::width(C);
    cg::cluster_group cluster = cg::this_cluster();
    for (int t = 4 * static_cast<int>(threadIdx.x); t < F; t += 4 * blockDim.x) {
      const int o = static_cast<int>(static_cast<unsigned>((t / TT + 1) * C - 1) / M);
      float* const dst = cluster.map_shared_rank(slots, o) + rank * width + t - TT * (o * M / C);
      *reinterpret_cast<float4*>(dst) = block_sum(t);
    }
    // The arrive releases the remote stores, the wait acquires the peers'.
    asm volatile("barrier.cluster.arrive;" ::: "memory");
    asm volatile("barrier.cluster.wait;" ::: "memory");
    OFDM_PILOT_STAMP(7);
    // This rank's bins [T m0, T m1): each the sum of the C blocks' slots in
    // rank order.
    const int m0 = rank * M / C, m1 = (rank + 1) * M / C;
    for (int u = 4 * static_cast<int>(threadIdx.x); u < TT * (m1 - m0); u += 4 * blockDim.x) {
      float4 s = *reinterpret_cast<const float4*>(slots + u);
      for (int b = 1; b < C; ++b) {
        const float4 x = *reinterpret_cast<const float4*>(slots + b * width + u);
        s = make_float4(s.x + x.x, s.y + x.y, s.z + x.z, s.w + x.w);
      }
      store(inv_k + TT * m0 + u, s);
    }
  }
  OFDM_PILOT_STAMP(8);
}

// F = 8192: the blocks of an antenna row, the row's columns and bins k1 of
// a block (ops/fft_plan.py PILOT_ROW_BLOCKS and pilot_plan), and the most
// rows a cluster holds (a cluster of 16 blocks, past the portable 8).
constexpr int kRowBlocks = 4;
constexpr int kRowN1 = 64;                       // F = 8192 = 64 x 128
constexpr int kRowK1 = kRowN1 / kRowBlocks;      // 16 rows k1 of stage 2 a block
constexpr int kRowBins = kRowK1 * split::kN2;    // 2048 bins a block
constexpr int kRowMaxRows = 4;
static_assert(split::columns<kRowN1>() * kRowBlocks == split::kN2, "a row's columns");

// Rows of a cluster: 4, 2 or 1, the largest dividing A (ops/fft_plan.py
// pilot_row_rows).
__host__ __device__ constexpr int row_rows(int A) { return A % 4 == 0 ? 4 : A % 2 == 0 ? 2 : 1; }

// Dynamic shared memory of an F = 8192 block: the column buffers (read by the
// row's blocks), one 8-lane team buffer for each of its kRowK1 rows k1,
// then |h|^2 of its kRowBins bins (read by the cluster) (ops/fft_plan.py
// pilot_smem_bytes).
__host__ __device__ constexpr size_t row_pilot_smem_bytes() {
  return split::column_smem_bytes<kRowN1>() +
         static_cast<size_t>(kRowK1) * split::RowGeo::kTeamFloats * sizeof(float) +
         static_cast<size_t>(kRowBins) * sizeof(float);
}

template <typename E>
__global__ void __launch_bounds__(split::kColumnThreads, 2)
pilot_ls_row_kernel(const E* __restrict__ y_re, const E* __restrict__ y_im, long long stride_k,
                    long long stride_a, float scale, int A, const float* __restrict__ x_re,
                    const float* __restrict__ x_im, const float2* __restrict__ tw,
                    float* __restrict__ h_re, float* __restrict__ h_im, float* __restrict__ inv,
                    int invert, float* __restrict__ partials, unsigned* __restrict__ counters) {
  using RG = split::RowGeo;
  constexpr int F = kRowN1 * split::kN2, M = RG::M, L = split::kRowLanes;
  constexpr int kStride = split::column_stride<kRowN1>();
  constexpr int kPlane1 = wfft::Geo<kRowN1>::kPlane;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const abs2 = smem + (row_pilot_smem_bytes() / sizeof(float) - kRowBins);
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int slot = static_cast<int>(cluster.block_rank());  // kRowBlocks i + r
  const int G = static_cast<int>(cluster.num_blocks()) / kRowBlocks;
  const int rank = slot % kRowBlocks, i = slot / kRowBlocks;  // block of its row, row of the cluster
  const int a = static_cast<int>(blockIdx.x) / kRowBlocks;
  const long long k = blockIdx.y;
  const long long off = k * stride_k + a * stride_a;
  if (threadIdx.x < wfft::Geo<kRowN1>::kTwiddles * 8 / 128) {  // the column FFT's twiddles into L1
    asm volatile("prefetch.global.L1 [%0];" ::"l"(tw + 16 * threadIdx.x));
  }
  float2 fw[3];
  split::column_load<kRowN1, E, false>(y_re + off, y_im + off, split::columns<kRowN1>() * rank,
                                       tw + split::four_tw_offset<kRowN1>(), fw, smem, 0);
  // Stage 2's threads (16 teams of 8 lanes): row k1 of the block, X and
  // scale / |X|^2 of its bins k1 + 64 (j + 8 m), loaded during stage 1.
  const bool rows = threadIdx.x < kRowK1 * L;
  const wfft::Team<L> team;
  const int j = team.j;
  const int k1 = kRowK1 * rank + team.id;
  float xr[M], xi[M];
  if (rows) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      xr[m] = __ldg(x_re + k1 + kRowN1 * (j + L * m));
      xi[m] = __ldg(x_im + k1 + kRowN1 * (j + L * m));
    }
  }
  split::column_fft<kRowN1>(tw, fw, smem, []() {}, []() {});
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  asm volatile("barrier.cluster.wait;" ::: "memory");  // every block's columns are in
  if (rows) {
    // Position i2 = j + 8 m of row k1: column i2 % 32 of the row's block
    // i2 / 32 = m / 4.
    float2 v[M];
    const float* peer[kRowBlocks];
#pragma unroll
    for (int r = 0; r < kRowBlocks; ++r) {
      peer[r] = cluster.map_shared_rank(smem, kRowBlocks * i + r);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* col = peer[m / 4] + (j + L * (m % 4)) * kStride + k1;
      v[m] = make_float2(col[0], col[kPlane1]);
    }
    float* const buf = smem + split::column_smem_bytes<kRowN1>() / sizeof(float) +
                       team.id * RG::kTeamFloats;
    wfft::row_fft_regs<split::kN2>(v, buf, tw + split::row_tw_offset<kRowN1>(), team);
    const long long row = (k * A + a) * F + k1;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // scale / |X|^2 by the fast reciprocal (2 ulp), as the other plans.
      const float den = __fdividef(scale, xr[m] * xr[m] + xi[m] * xi[m]);
      const float hr = (v[m].x * xr[m] + v[m].y * xi[m]) * den;
      const float hi = (v[m].y * xr[m] - v[m].x * xi[m]) * den;
      h_re[row + kRowN1 * (j + L * m)] = hr;
      h_im[row + kRowN1 * (j + L * m)] = hi;
      abs2[(j + L * m) * kRowK1 + team.id] = hr * hr + hi * hi;  // bin entry k2 kRowK1 + k1 % 16
    }
  }
  // The peers' columns are read and this block's |h|^2 is written.
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  asm volatile("barrier.cluster.wait;" ::: "memory");
  // The cluster's rows' |h|^2 of this rank's entries [i E, (i + 1) E), E =
  // kRowBins / G, in row order: thread u takes 8 consecutive entries (k2 =
  // e / 16, k1 % 16 = e % 16) when 8 u < E.
  const int per = kRowBins / G, e = per * i + 8 * static_cast<int>(threadIdx.x);
  const bool mine = 8 * static_cast<int>(threadIdx.x) < per;
  float4 s[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  if (mine) {
    float4 part[kRowMaxRows][2];
#pragma unroll
    for (int b = 0; b < kRowMaxRows; ++b) {
      if (b < G) {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(abs2, kRowBlocks * b + rank) + e);
        part[b][0] = src[0];
        part[b][1] = src[1];
      }
    }
#pragma unroll
    for (int b = 0; b < kRowMaxRows; ++b) {
      if (b < G) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h].x += part[b][h].x;
          s[h].y += part[b][h].y;
          s[h].z += part[b][h].z;
          s[h].w += part[b][h].w;
        }
      }
    }
  }
  asm volatile("barrier.cluster.arrive;" ::: "memory");  // the peers' |h|^2 is read
  // Entry e's bin: k1 = 16 rank + e % 16, k2 = e / 16 (8 consecutive k1).
  const long long bin = kRowN1 * (e / kRowK1) + kRowK1 * rank + e % kRowK1;
  const int clusters = A / G, c = a / G;
  bool store = clusters == 1;  // this block writes inv of its entries
  if (clusters > 1) {  // the cluster's partial; the last cluster adds them
    if (mine) {
      float4* const dst = reinterpret_cast<float4*>(partials + (k * clusters + c) * F + bin);
      dst[0] = s[0];
      dst[1] = s[1];
    }
    __syncthreads();
    unsigned* const count = counters + k * kRowBlocks * kRowMaxRows + slot;
    if (threadIdx.x == 0) {
      __threadfence();  // the block's partial before its count
      last = atomicAdd(count, 1u) == static_cast<unsigned>(clusters - 1);
      if (last) atomicExch(count, 0u);  // every cluster has counted: 0 for the next launch
    }
    __syncthreads();
    store = last;
    if (store && mine) {
      __threadfence();
      s[0] = s[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float* const pk = partials + k * clusters * F + bin;
      for (int c0 = 0; c0 < clusters; c0 += kRowMaxRows) {
        float4 pg[kRowMaxRows][2];
#pragma unroll
        for (int b = 0; b < kRowMaxRows; ++b) {
          if (c0 + b < clusters) {
            pg[b][0] = __ldcg(reinterpret_cast<const float4*>(pk + (c0 + b) * F));
            pg[b][1] = __ldcg(reinterpret_cast<const float4*>(pk + (c0 + b) * F) + 1);
          }
        }
#pragma unroll
        for (int b = 0; b < kRowMaxRows; ++b) {
          if (c0 + b < clusters) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              s[h].x += pg[b][h].x;
              s[h].y += pg[b][h].y;
              s[h].z += pg[b][h].z;
              s[h].w += pg[b][h].w;
            }
          }
        }
      }
    }
  }
  if (store && mine) {
    float4* const out = reinterpret_cast<float4*>(inv + k * F + bin);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      out[h] = invert ? make_float4(1.0f / s[h].x, 1.0f / s[h].y, 1.0f / s[h].z, 1.0f / s[h].w)
                      : s[h];
    }
  }
  asm volatile("barrier.cluster.wait;" ::: "memory");  // no block leaves while a peer reads it
}

template <typename E>
cudaError_t row_pilot(const void* y_re, const void* y_im, long long stride_k, long long stride_a,
                      float scale, int K, int A, const float* x_re, const float* x_im,
                      const float* tw, float* h_re, float* h_im, float* inv, int invert,
                      float* partials, unsigned* counters, cudaStream_t stream) {
  auto kernel = pilot_ls_row_kernel<E>;
  constexpr size_t smem = row_pilot_smem_bytes();
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess && row_rows(A) * kRowBlocks > kMaxCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = row_rows(A) * kRowBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRowBlocks * A, K);
  cfg.blockDim = dim3(split::kColumnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const E*>(y_re), static_cast<const E*>(y_im),
                           stride_k, stride_a, scale, A, x_re, x_im,
                           reinterpret_cast<const float2*>(tw), h_re, h_im, inv, invert, partials,
                           counters);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Dynamic shared memory of a split pilot block of `teams` antenna teams: the
// row pass's buffers, then X of its kK1 x 128 bins (ops/fft_plan.py
// pilot_smem_bytes).
inline size_t split_pilot_smem_bytes(int teams) {
  return split::row_smem_bytes(teams) + 2 * split::kK1 * split::kN2 * sizeof(float);
}

// A pilot plan the kernels can launch (ops/fft_plan.py pilot_plan): a
// cluster of at most `max_cluster` blocks (the portable size unless named),
// at most `max_teams` teams, the rows each team needs, no team slot idle
// for a whole row, and a row for every block.
inline bool pilot_plan_ok(int A, int clusters, int teams, int rows, int max_teams,
                          int max_cluster = kMaxCluster) {
  return clusters >= 1 && clusters <= max_cluster && teams >= 1 && teams <= max_teams &&
         rows == (A + clusters * teams - 1) / (clusters * teams) &&
         teams == (A + clusters * rows - 1) / (clusters * rows) && (clusters - 1) * teams < A;
}

template <int F, typename T, bool kAligned>
cudaError_t launch_pilot(const void* y_re, const void* y_im, long long stride_k,
                         long long stride_a, float scale, int K, int A, int clusters,
                         int teams, int rows, long long smem, const float* x_re,
                         const float* x_im, const float* tw, float* h_re, float* h_im,
                         float* inv, int invert, cudaStream_t stream) {
  using G_ = wfft::Geo<F>;
  const int threads = teams * G_::T;
  if (K < 1 || K > 65535 || A < 1 ||
      !pilot_plan_ok(A, clusters, teams, rows, pilot_max_threads<F>() / G_::T) ||
      smem != static_cast<long long>(pilot_smem_bytes<F>(teams))) {
    return cudaErrorInvalidValue;
  }
  auto kernel = pilot_ls_kernel<F, T, kAligned>;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(y_re),
                           static_cast<const T*>(y_im), stride_k, stride_a, scale, A,
                           x_re, x_im, reinterpret_cast<const float2*>(tw), h_re, h_im,
                           inv, invert);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A push plan the card can launch: the plan rules above with clusters of up
// to kPushMaxCluster blocks, and past the portable size one the card can
// co-schedule at the block's threads and shared memory
// (cudaOccupancyMaxActiveClusters), checked once a shape.
template <int F, typename T, bool kAligned>
cudaError_t launch_push(const void* y_re, const void* y_im, long long stride_k,
                        long long stride_a, float scale, int K, int A, int clusters, int teams,
                        int rows, long long smem, const float* x_re, const float* x_im,
                        const float* tw, float* h_re, float* h_im, float* inv, int invert,
                        cudaStream_t stream) {
  using S = Push<F>;
  if (K < 1 || K > 65535 || A < 1 ||
      !pilot_plan_ok(A, clusters, teams, rows, kPushMaxThreads / S::T, kPushMaxCluster) ||
      smem != static_cast<long long>(S::smem_bytes(teams, clusters))) {
    return cudaErrorInvalidValue;
  }
  auto kernel = pilot_ls_push_kernel<F, T, kAligned>;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err == cudaSuccess && clusters > kMaxCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, K);
  cfg.blockDim = dim3(teams * S::T);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = clusters > 1 ? 1 : 0;  // one block a frame: a plain launch
  if (clusters > kMaxCluster) {
    static long long checked = -1;  // the last shape the card was found to co-schedule
    const long long shape = (smem << 16) | (clusters << 10) | teams;
    if (shape != checked) {
      int active = 0;
      err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (active < 1) return cudaErrorInvalidConfiguration;
      checked = shape;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(y_re),
                           static_cast<const T*>(y_im), stride_k, stride_a, scale, A, x_re,
                           x_im, reinterpret_cast<const float2*>(tw), h_re, h_im, inv, invert);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool kAligned>
cudaError_t dispatch_pilot(int F, const void* y_re, const void* y_im,
                           long long stride_k, long long stride_a, float scale, int K,
                           int A, int clusters, int teams, int rows, long long smem,
                           const float* x_re, const float* x_im, const float* tw,
                           float* h_re, float* h_im, float* inv, int invert,
                           cudaStream_t stream) {
#define OFDM_PILOT_CASE(N, LAUNCH)                                                \
  case N:                                                                         \
    return LAUNCH<N, T, kAligned>(y_re, y_im, stride_k, stride_a, scale, K, A,    \
                                  clusters, teams, rows, smem, x_re, x_im, tw, h_re, \
                                  h_im, inv, invert, stream);
  switch (F) {
    OFDM_PILOT_CASE(64, launch_push)
    OFDM_PILOT_CASE(128, launch_push)
    OFDM_PILOT_CASE(256, launch_push)
    OFDM_PILOT_CASE(512, launch_push)
    OFDM_PILOT_CASE(1024, launch_pilot)
    OFDM_PILOT_CASE(2048, launch_push)
    OFDM_PILOT_CASE(4096, launch_push)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_PILOT_CASE
}

// F = 16384 and 32768 (fft_split.cuh): the row pass of frames [item0,
// item0 + gridDim.y) of the scratch b [n, A, n1, 128], a thread block
// cluster of C blocks for each kK1 bins k1 of a frame: grid (n1 / kK1 x C,
// n), cluster (C, 1, 1).  Block rank r holds `teams` antenna teams of kK1
// 8-lane row teams; antenna team p takes rows g, g + C teams, ... (g =
// r teams + p, as the register plan's teams), so the cluster takes every
// antenna once.  X of the block's kK1 x 128 bins lands in shared memory by
// 16-byte cp.async ahead of the first rows (kK1 consecutive bins a k2), and
// a lane takes X and scale / |X|^2 of its 16 bins k1 + n1 (j + 8 m) from
// there into registers (each lane loading its own from device memory took
// 32 scattered loads a lane); each row (staged one ahead by cp.async) goes
// through the 128-point register FFT and each bin gives h =
// Y conj(X) scale / |X|^2, stored at once (natural order), and |h|^2 into
// the lane's sums (the last row's h is stored after the cluster barrier's
// arrive).  Each team's sums stay in its first buffer; after the cluster
// barrier rank r adds its share of the cluster's kK1 x 128 bins (entry i =
// (k2 = i / kK1, k1 = i % kK1); fft_plan.py split_pilot_rank_bins) over the
// C blocks' teams in their shared memory (distributed shared memory) and
// writes inv (or the sum); a second cluster.sync() keeps every block
// resident until its peers have read it.  The plan
// (ops/fft_plan.py pilot_plan) is checked by pilot_plan_ok.
template <int N1>
__global__ void __launch_bounds__(split::kRowThreads)
pilot_ls_rows_kernel(const float* __restrict__ b_re, const float* __restrict__ b_im,
                     long long item0, int A, float scale, const float* __restrict__ x_re,
                     const float* __restrict__ x_im, const float2* __restrict__ tw,
                     float* __restrict__ h_re, float* __restrict__ h_im,
                     float* __restrict__ inv, int invert) {
  using RG = split::RowGeo;
  constexpr int F = N1 * split::kN2, M = RG::M, L = split::kRowLanes;
  constexpr int kBins = split::kK1 * split::kN2;  // bins of a cluster
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = static_cast<int>(blockDim.x) / (split::kK1 * L);
  const split::RowTeam rt;
  const int j = rt.team.j;
  const int k1_0 = static_cast<int>(blockIdx.x) / C * split::kK1;
  const int k1 = k1_0 + rt.g;
  const long long il = blockIdx.y;
  const long long k = item0 + il;
  // This antenna team's rows: g, g + step, ... < A.
  const int g = rank * P + rt.p;
  const int step = C * P;
  const int n = g < A ? (A - g + step - 1) / step : 0;
  const float* const yr = b_re + il * A * F;
  const float* const yi = b_im + il * A * F;
  auto row = [&](int a) { return (static_cast<long long>(a) * N1 + k1) * split::kN2; };
  float* const buf0 = smem + rt.team.id * RG::kTeamFloats;
  float* const buf1 = buf0 + 2 * RG::kPlane;
  float* const xs = smem + P * split::kK1 * RG::kTeamFloats;  // X: [2][128][kK1]
  if (threadIdx.x < RG::kTwiddles * 8 / 128) {  // the row FFT's twiddles into L1, a line a thread
    asm volatile("prefetch.global.L1 [%0];" ::"l"(tw + 16 * threadIdx.x));
  }

  for (int c = threadIdx.x; c < 2 * split::kN2 * (split::kK1 / 4); c += blockDim.x) {
    const int plane = c / (split::kN2 * split::kK1 / 4), k2 = (c / (split::kK1 / 4)) % split::kN2;
    const int e = 4 * (c % (split::kK1 / 4));
    wfft::cp_async16(xs + plane * kBins + k2 * split::kK1 + e,
                     (plane ? x_im : x_re) + k1_0 + N1 * k2 + e);
  }
  wfft::cp_async_commit();
  if (n > 0) wfft::stage_row<split::kN2, float, true>(buf0, yr + row(g), yi + row(g), j);
  wfft::cp_async_commit();
  wfft::cp_async_wait<1>();  // X has landed (row 0 may not have)
  __syncthreads();           // ... for every thread
  float xr[M], xi[M], den[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    xr[m] = xs[(j + L * m) * split::kK1 + rt.g];
    xi[m] = xs[kBins + (j + L * m) * split::kK1 + rt.g];
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    // scale / |X|^2 by the fast reciprocal (2 ulp), as the register plan.
    den[m] = __fdividef(scale, xr[m] * xr[m] + xi[m] * xi[m]);
  }
  float acc[M];
  float last_re[M], last_im[M];  // the last row's h, stored after the cluster arrive
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.0f;
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      const long long at = row(g + (i + 1) * step);
      wfft::stage_row<split::kN2, float, true>((i & 1) ? buf0 : buf1, yr + at, yi + at, j);
      wfft::cp_async_commit();
      wfft::cp_async_wait<1>();
    } else {
      wfft::cp_async_wait<0>();
    }
    rt.team.sync();  // row i has landed for every lane of the team
    float2 v[M];
    wfft::row_fft<split::kN2, float>(v, (i & 1) ? buf1 : buf0, tw, rt.team);
    const long long at = (k * A + g + i * step) * F + k1;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float hr = (v[m].x * xr[m] + v[m].y * xi[m]) * den[m];
      const float hi = (v[m].y * xr[m] - v[m].x * xi[m]) * den[m];
      if (i + 1 < n) {
        h_re[at + N1 * (j + L * m)] = hr;
        h_im[at + N1 * (j + L * m)] = hi;
      } else {
        last_re[m] = hr;
        last_im[m] = hi;
      }
      acc[m] += hr * hr + hi * hi;
    }
    rt.team.sync();  // row i's buffer is free for row i + 2
  }

  // The team's sums into its first buffer.
#pragma unroll
  for (int m = 0; m < M; ++m) buf0[j + L * m] = acc[m];
  // The arrive releases the teams' sums; the last row's h is stored after
  // it (a release waits for the stores before it to land), in flight during
  // the wait and the reduce.
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  if (n > 0) {
    const long long at = (k * A + g + (n - 1) * step) * F + k1;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      h_re[at + N1 * (j + L * m)] = last_re[m];
      h_im[at + N1 * (j + L * m)] = last_im[m];
    }
  }
  asm volatile("barrier.cluster.wait;" ::: "memory");  // every block's sums are visible

  // Rank r: entries [r kBins / C, (r + 1) kBins / C), each the sum over
  // the C blocks (in rank order) of each block's antenna teams (in team
  // order); kK1 consecutive entries are kK1 consecutive bins.
  const int lo = rank * kBins / C, hi = (rank + 1) * kBins / C;
  float* const inv_k = inv + k * F;
#pragma unroll 4
  for (int i = lo + static_cast<int>(threadIdx.x); i < hi; i += blockDim.x) {
    const int gi = i % split::kK1, k2 = i / split::kK1;
    float part[kMaxCluster][split::kMaxTeams];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      const float* peer = cluster.map_shared_rank(smem, c < C ? c : rank);
#pragma unroll
      for (int p = 0; p < split::kMaxTeams; ++p) {
        part[c][p] = c < C && p < P ? peer[split::row_team_id(gi, p) * RG::kTeamFloats + k2]
                                    : 0.0f;
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      float b = 0.0f;
#pragma unroll
      for (int p = 0; p < split::kMaxTeams; ++p) b += part[c][p];
      s += b;
    }
    inv_k[k1_0 + gi + N1 * k2] = invert ? 1.0f / s : s;
  }
  cluster.sync();  // no block leaves while a peer still reads its sums
}

template <int N1>
cudaError_t split_pilot(bool int16, const void* y_re, const void* y_im, long long stride_k,
                        long long stride_a, float scale, int K, int A, int clusters, int teams,
                        const float* x_re, const float* x_im, const float* tw, float* h_re,
                        float* h_im, float* inv, int invert, float* scratch, int chunk,
                        cudaStream_t stream) {
  const size_t smem = split_pilot_smem_bytes(teams);
  auto kernel = pilot_ls_rows_kernel<N1>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const float2* row_tw = reinterpret_cast<const float2*>(tw) + split::row_tw_offset<N1>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(teams * split::kK1 * split::kRowLanes);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return split::run_split<N1>(
      int16, y_re, y_im, stride_k, 0, stride_a, 1, A, K, tw, scratch, chunk, stream,
      [&](const float* b_re, const float* b_im, long long i0, int n) {
        cfg.gridDim = dim3(N1 / split::kK1 * clusters, n);
        cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, b_re, b_im, i0, A, scale, x_re, x_im,
                                           row_tw, h_re, h_im, inv, invert);
        return e != cudaSuccess ? e : cudaGetLastError();
      });
}

}  // namespace ofdm

// Pilot rows: y_re/y_im point at row (k=0, a=0) of K x A rows of F samples,
// row (k, a) at element offset k*stride_k + a*stride_a; int16 when in_int16
// (scaled by `scale`), float32 otherwise.  aligned: every row starts 16-byte
// aligned (the cp.async load path).  clusters, teams, rows, smem: the launch
// geometry of ops/fft_plan.py pilot_plan(A, F), checked against the kernel's
// own (cudaErrorInvalidValue when it differs; in the push form a cluster
// past the portable 8 the card cannot co-schedule is
// cudaErrorInvalidConfiguration).  x_re/x_im: [F] padded pilot, natural
// order, 16-byte aligned.  tw: the pass twiddles of ops/fft_plan.py (at F =
// 64-512, 2048 and 4096 pilot_twiddles, 16-byte aligned), from F = 8192
// its split table.  Outputs h_re/h_im [K, A, F] and inv [K, F]: 1 / sum_a |h|^2,
// or the sum itself when invert is 0.  scratch, chunk: at F = 16384 and
// 32768 the split form's scratch [2, chunk, A, F] float32 and the frames of
// one chunk; at F = 8192 the sum's partials [K, A / G, F] float32 (G the
// rows of a cluster, ops/fft_plan.py pilot_row_rows; none where A = G).
// counters: at F = 8192 [K, 16] unsigned, zero (the kernel leaves them
// zero: a launch may reuse them once the last is done); unused elsewhere.
// Returns the cudaError_t of the launches.
extern "C" int ofdm_pilot_ls(const void* y_re, const void* y_im, int in_int16,
                             int aligned, long long stride_k, long long stride_a,
                             float scale, int K, int A, int F, int clusters, int teams,
                             int rows, long long smem, const float* x_re,
                             const float* x_im, const float* tw, float* h_re,
                             float* h_im, float* inv, int invert, float* scratch, int chunk,
                             unsigned* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 8192) {
    if (K < 1 || K > 65535 || A < 1 || clusters != ofdm::row_rows(A) * ofdm::kRowBlocks ||
        teams != 1 || rows != 1 || smem != static_cast<long long>(ofdm::row_pilot_smem_bytes()) ||
        counters == nullptr || (A > ofdm::row_rows(A) && scratch == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(
        in_int16 ? ofdm::row_pilot<int16_t>(y_re, y_im, stride_k, stride_a, scale, K, A, x_re,
                                            x_im, tw, h_re, h_im, inv, invert, scratch, counters,
                                            st)
                 : ofdm::row_pilot<float>(y_re, y_im, stride_k, stride_a, scale, K, A, x_re,
                                          x_im, tw, h_re, h_im, inv, invert, scratch, counters,
                                          st));
  }
  if (F == 16384 || F == 32768) {
    if (K < 1 || A < 1 ||
        !ofdm::pilot_plan_ok(A, clusters, teams, rows, ofdm::split::kMaxTeams) ||
        smem != static_cast<long long>(ofdm::split_pilot_smem_bytes(teams))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto run_split = [&](auto fn) {
      return static_cast<int>(fn(in_int16 != 0, y_re, y_im, stride_k, stride_a, scale, K, A,
                                clusters, teams, x_re, x_im, tw, h_re, h_im, inv, invert,
                                scratch, chunk, st));
    };
    return F == 16384 ? run_split(ofdm::split_pilot<128>) : run_split(ofdm::split_pilot<256>);
  }
  auto run = [&](auto dispatch) {
    return dispatch(F, y_re, y_im, stride_k, stride_a, scale, K, A, clusters, teams, rows,
                    smem, x_re, x_im, tw, h_re, h_im, inv, invert, st);
  };
  cudaError_t err;
  if (in_int16) {
    err = aligned ? run(ofdm::dispatch_pilot<int16_t, true>)
                  : run(ofdm::dispatch_pilot<int16_t, false>);
  } else {
    err = aligned ? run(ofdm::dispatch_pilot<float, true>)
                  : run(ofdm::dispatch_pilot<float, false>);
  }
  return static_cast<int>(err);
}

#ifdef OFDM_PILOT_TRACE
// The stamp buffer of a traced build (pilot_trace above), or null.
extern "C" int ofdm_pilot_trace_set(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(ofdm::pilot_trace, &buf, sizeof(buf)));
}
#endif

// Text of a cudaError_t returned by the entry points.
extern "C" const char* ofdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
