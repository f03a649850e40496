// The split form of the FFT: the exact kernels at F = 16384 and 32768
// (fft_mrc.cu, mrc_demod.cu, pilot_ls.cu), the exact pilot at F = 8192
// across a cluster (pilot_ls.cu, column_fft) and the bf16 speed kernels'
// stage 1 at F = 8192 to 32768 (fft_mrc_bf16.cu).
//
// Why two passes.  Up to F = 8192 a row lives in the registers of one team
// (fft_warp.cuh: 256 threads of 32 complex values at 8192) beside its sums
// over the antennas.  At 16384 the row alone is 128 KB of registers and the
// sums as much again, half the SM's file at 512 threads of at most 128
// registers (the register FFT needs 223-255 at M = 32); at 32768 the row is
// the whole file.  So the row is split, F = n1 x 128, x[i1, i2] =
// x[128 i1 + i2]:
//   1. the column pass (column_tile below): the n1-point DFT over i1 of
//      every column i2 -- the register FFT at F = n1, one team a column,
//      the columns of a block loaded and stored as rows of consecutive
//      samples and transposed in shared memory -- times the four-step
//      twiddle exp(-2 pi i k1 i2 / F) (a float32 table computed in float64),
//      into a scratch row B[k1][i2] of its antenna;
//   2. the row pass (row_pass below, each kernel's own epilogue): the
//      128-point DFT of every B[k1][:] -- the register FFT at F = 128, one
//      8-lane team a row, rows staged by cp.async one ahead as in
//      fft_warp.cuh team_rows -- gives bin k1 + n1 k2 in register k2 / 8 of
//      lane k2 % 8.  A data block takes kK1 = 8 bins k1 of one symbol and
//      all of its antennas over up to kMaxTeams = 4 antenna teams, so the
//      MRC numerator's sum over the antennas stays inside the block: no
//      cluster, no second reduction.  The pilot (one frame, n1 / 8 such
//      blocks) spreads its antennas over a thread block cluster of up to 8
//      blocks and adds sum |h|^2 in distributed shared memory
//      (pilot_ls.cu pilot_ls_rows_kernel).  Warp w holds the teams
//      of four consecutive k1 (g = (id & 3) + 4 (w & 1)) of antenna team
//      p = w / 2.
//
// Where the passes meet.  The split pilots (exact at 16384 and 32768, bf16
// from 8192) run the column pass (fft_split.cu column_pass, one launch)
// into a scratch [2, chunk, A, F] in device memory and their row pass after
// it, chunk by chunk (run_split below, ops/fft_plan.py split_chunk): a
// frame's scratch costs a write and a read of every sample beside the
// input's read.
//
// The data kernels (the exact fft_mrc and mrc_demod, the bf16 fft_mrc_bf16)
// run both passes in ONE persistent launch (ring_loop below; the bf16
// kernel's row tiles, stage 2 on wgmma, and its bf16 slots in
// fft_mrc_bf16.cu): a grid of the blocks the card holds
// (kRingBlocks an SM, 256 threads, one block shape for both kinds of tile)
// takes tiles by ticket, an atomicAdd on a counter:
//   - a column tile: the column pass of C columns of one antenna row of
//     one symbol (the work of one column-pass block), A 128 / C a symbol;
//   - a row tile: the row pass of kK1 bins k1 (the bf16 kernel's: 16) over
//     every antenna of one symbol, its fold and its epilogue, n1 / kK1 a
//     symbol.
// Tickets run in steps: step t holds the column tiles of symbol t, then the
// row tiles of symbol t - L (the lag), so a tile only ever waits on tiles
// with smaller tickets, which are done or running on resident blocks: no
// deadlock, whatever the grid.  The passes meet in a ring of R symbol slots
// ([2, R, A, F], R > L, symbol s in slot s % R) that L2 holds
// (ops/fft_plan.py split_ring: 40 MiB where that holds 8 slots or more;
// at 64 antennas a ring of the chunked form's size in device memory): a row
// tile waits until its symbol's A 128 / C column tiles are in, and the
// column tiles of symbol s wait until the n1 / kK1 row tiles of symbol
// s - R have read the slot.  The hand-offs are per-symbol counters in
// device memory (the wrapper zeroes them): the writer's threads store,
// __syncthreads, one thread fences and adds (fence.acq_rel.gpu + red); the
// reader's thread 0 spins on ld.acquire.gpu, then __syncthreads.  Slots are
// rewritten inside the launch, so every scratch read bypasses L1
// (cp.async.cg).  Input rows and output stores carry an L2::evict_first
// policy; the ring and the estimate keep the default, so L2 holds them.
// The row tile stages its estimate slice (kK1 k1 x 128 k2 of one antenna, an
// antenna team's 8 KB, whole 32-byte sectors by cp.async.cg) into shared
// memory beside the row, so the fold reads shared memory and the slice's
// L2 latency hides under the row's FFT; its gains (inv or hsqrd) come the
// same way, and both FFTs' pass twiddles sit in shared memory for the
// whole launch.  Where the time goes (tools/ring_trace.py, PERF.md): the
// tiles' own instructions and latencies at 16 warps an SM, not the bytes.
//
// ops/fft_plan.py holds the same geometry (the split section), and
// tests/test_torch_large_fft.py and tests/test_torch_split_ring.py emulate
// both passes and the ring's schedule in numpy on its tables.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fft_warp.cuh"

namespace ofdm {
namespace split {

constexpr int kN2 = 128;             // the row pass's length
constexpr int kK1 = 8;               // bins k1 of a row-pass block
constexpr int kMaxTeams = 4;         // antenna teams of a row-pass block, at most
constexpr int kColumnThreads = 256;  // threads of a column-pass block
constexpr int kColumnBlocks = 2;     // column-pass blocks an SM should hold (__launch_bounds__)
constexpr int kRingBlocks = 2;       // ring-kernel blocks an SM (__launch_bounds__)
using RowGeo = wfft::Geo<kN2>;       // 16 values, 8 lanes a row
constexpr int kRowLanes = RowGeo::T;
constexpr int kRowThreads = kMaxTeams * kK1 * kRowLanes;  // 256
constexpr int kTeamThreads = kK1 * kRowLanes;              // an antenna team: 64
constexpr int kHStageFloats = 2 * kK1 * kN2;  // an antenna team's estimate slice, both planes
static_assert(kRowThreads == kColumnThreads, "one block shape for both kinds of ring tile");

// Antenna teams of the data kernels' row pass (ops/fft_plan.py split_teams);
// the pilot takes pilot_plan's.
__host__ __device__ constexpr int data_teams(int A) { return A < kMaxTeams ? A : kMaxTeams; }

// Dynamic shared memory of a row-pass block of `teams` antenna teams
// (ops/fft_plan.py split_smem_bytes).
__host__ __device__ constexpr size_t row_smem_bytes(int teams) {
  return static_cast<size_t>(teams) * kK1 * RowGeo::kTeamFloats * sizeof(float);
}

// Offsets in the table of ops/fft_plan.py split_tables: the column FFT's
// pass twiddles, the row FFT's, then the [n1][128] four-step twiddles.
template <int N1>
__host__ __device__ constexpr int row_tw_offset() {
  return wfft::Geo<N1>::kTwiddles;
}
template <int N1>
__host__ __device__ constexpr int four_tw_offset() {
  return wfft::Geo<N1>::kTwiddles + RowGeo::kTwiddles;
}

// Columns of a column tile: one a team of the n1-point register FFT (32 at
// n1 = 64 and 128, 16 at 256; 32 columns at 256, two a team, measured
// slower).
template <int N1>
__host__ __device__ constexpr int columns() {
  return kColumnThreads / wfft::Geo<N1>::T;
}
// Floats of a column's buffer: the FFT's two planes, padded so that the
// transposes spread a warp over the 32 banks (a warp takes one run of 32
// columns, or two runs of 16).
template <int N1>
__host__ __device__ constexpr int column_stride() {
  return 2 * wfft::Geo<N1>::kPlane + (columns<N1>() >= 32 ? 1 : 2);
}
template <int N1>
__host__ __device__ constexpr size_t column_smem_bytes() {
  return static_cast<size_t>(columns<N1>()) * column_stride<N1>() * sizeof(float);
}

// Dynamic shared memory of a ring-kernel block (ops/fft_plan.py
// split_ring_smem_bytes): the row pass's buffers of kMaxTeams antenna teams,
// their estimate slices, the row tile's gains (kGainFloats) and the pass
// twiddles of both FFTs (the split table's first ring_twiddles<N1>()
// entries, loaded once a launch); a column tile uses the first
// column_smem_bytes of it.
constexpr int kGainFloats = kK1 * kN2;
__host__ __device__ constexpr size_t ring_gain_offset() {
  return row_smem_bytes(kMaxTeams) / sizeof(float) +
         static_cast<size_t>(kMaxTeams) * kHStageFloats;
}
template <int N1>
__host__ __device__ constexpr int ring_twiddles() {
  return wfft::Geo<N1>::kTwiddles + RowGeo::kTwiddles;
}
template <int N1>
__host__ __device__ constexpr size_t ring_smem_bytes() {
  return (ring_gain_offset() + kGainFloats) * sizeof(float) +
         static_cast<size_t>(ring_twiddles<N1>()) * sizeof(float2);
}

// The column pass of items [item0, item0 + n) (item i: k = i / S, s = i % S,
// its A rows at y + k stride_k + s stride_s + a stride_a, int16 or float32)
// into b_re/b_im [n, A, n1, 128], tw the split table.  One launch; defined
// in fft_split.cu.  cudaErrorInvalidValue for an n1 it does not instantiate.
cudaError_t column_pass(int n1, bool int16, const void* y_re, const void* y_im,
                        long long stride_k, long long stride_s, long long stride_a, int S,
                        int A, long long item0, int n, const float2* tw, float* b_re,
                        float* b_im, cudaStream_t stream);

// ---------------------------------------------------------------------------
// Cache policies and the ring's hand-offs
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An L2 policy that evicts its lines first: input rows and output stores.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// One float of an input row into shared memory, through L1, evict-first in L2.
__device__ __forceinline__ void cp_async4_evict_first(float* smem, const float* gmem,
                                                      uint64_t policy) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "l"(policy)
               : "memory");
}

// One int16 input sample, evict-first in L2, widened exactly.
__device__ __forceinline__ float ld_evict_first(const int16_t* p, uint64_t policy) {
  int v;
  asm("ld.global.L2::cache_hint.s16 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return wfft::widen(static_cast<int16_t>(v));
}

// An output store, evict-first in L2.
__device__ __forceinline__ void st_evict_first(float* p, float v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(p), "f"(v), "l"(policy)
               : "memory");
}

// The writer's side of a hand-off, by one thread after the block's
// __syncthreads: its stores (and every thread's, ordered by the barrier)
// before the count.
__device__ __forceinline__ void arrive(unsigned* count) {
  asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(count)
               : "memory");
}

// The reader's side, by one thread before the block's __syncthreads: spin
// until count >= target.
__device__ __forceinline__ void wait_count(const unsigned* count, unsigned target) {
  for (;;) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(count) : "memory");
    if (v >= target) return;
    __nanosleep(64);
  }
}

// ---------------------------------------------------------------------------
// The column pass
// ---------------------------------------------------------------------------

// The column pass of C = columns<N1>() columns c0 .. c0 + C - 1 of one
// antenna row (samples xr/xi, int16 or float32) into its scratch row
// o_re/o_im [n1][128], by a block of kColumnThreads, in two calls:
// column_load requests the [n1][C] samples as n1 runs of C consecutive
// samples (coalesced; float32 by 4-byte cp.async straight into place in one
// commit group, int16 through registers, widened exactly) into one buffer a
// column (stride 2 kPlane + 1 floats, odd, or at 16 columns 2 kPlane + 2,
// twice odd: a warp's 32 samples fall in 32 banks), and behind them the
// lane's three four-step twiddle entries fw (four: the split table's
// four-step part); column_run waits for them, runs each column's FFT (tw:
// its pass twiddles, the table's first part, in global or shared memory),
// applies the twiddle of bin k1 (register m of lane j holds
// k1 = j + T m), writes the result back into the column's buffer in
// natural order and stores the block's [n1][C] as runs of C consecutive
// floats.  kEvictFirst loads the samples under `policy`.
// column_run calls, on every thread, publish() before its first
// __syncthreads, loaded() after it (the samples are in), gate() after the
// FFT and before the __syncthreads that precedes the stores (the ring's
// wait for a free slot).
//
// The twiddle of bin k1 = j + T m is formed from three entries of the table,
// loaded with the samples: k1 = j, and the step of k1 = T over the k1 = 0
// entry (which carries the sc16 scale of the speed kernels' table), by
// products in float32 (a few ulp from the table at m = M - 1), in place of
// loading all M entries a lane; with two blocks an SM in place of three,
// nothing spills (three spilled 48-60 B at n1 = 128 and 256).  On the H100
// this made the data kernels' column pass 13-29% faster and kept the
// pilots' (64 or 128 blocks, one block's chain) as fast as a form of their
// own (PERF.md).
template <int N1, typename E, bool kEvictFirst>
__device__ __forceinline__ void column_load(const E* __restrict__ xr, const E* __restrict__ xi,
                                            int c0, const float2* __restrict__ four,
                                            float2 (&fw)[3], float* smem, uint64_t policy) {
  using G = wfft::Geo<N1>;
  constexpr int T = G::T, C = columns<N1>(), kStride = column_stride<N1>();
  constexpr int kLoads = N1 * C / kColumnThreads;  // samples of a thread, each plane
  static_assert(C * T == kColumnThreads && kN2 % C == 0 && kLoads * kColumnThreads == N1 * C,
                "column geometry");
  const int i2 = c0 + static_cast<int>(threadIdx.x) / T, j = static_cast<int>(threadIdx.x) % T;
  auto load_twiddles = [&]() {  // the entries k1 = j, T and 0, loaded behind the samples
    fw[0] = __ldg(four + j * kN2 + i2);
    fw[1] = __ldg(four + T * kN2 + i2);
    fw[2] = __ldg(four + i2);
  };
  if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kColumnThreads;
      const int at = (idx / C) * kN2 + c0 + idx % C;
      float* col = smem + (idx % C) * kStride + idx / C;
      if constexpr (kEvictFirst) {
        cp_async4_evict_first(col, reinterpret_cast<const float*>(xr) + at, policy);
        cp_async4_evict_first(col + G::kPlane, reinterpret_cast<const float*>(xi) + at, policy);
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(col)),
                     "l"(xr + at) : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(col + G::kPlane)),
                     "l"(xi + at) : "memory");
      }
    }
    wfft::cp_async_commit();
    load_twiddles();
  } else {
    float lr[kLoads], li[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kColumnThreads;
      const int at = (idx / C) * kN2 + c0 + idx % C;
      if constexpr (kEvictFirst) {
        lr[u] = ld_evict_first(xr + at, policy);
        li[u] = ld_evict_first(xi + at, policy);
      } else {
        lr[u] = wfft::widen(xr[at]);
        li[u] = wfft::widen(xi[at]);
      }
    }
    load_twiddles();
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kColumnThreads;
      float* col = smem + (idx % C) * kStride;
      col[idx / C] = lr[u];
      col[G::kPlane + idx / C] = li[u];
    }
  }
}

// column_run's first half: waits for the samples (publish() before the
// barrier, loaded() after it), runs each column's FFT and the twiddle of
// bin k1, and leaves B[k1][c0 + c] in column c's buffer, natural order (re
// at smem + c kStride + k1, im kPlane floats on).  The buffers are read by
// other teams (column_store) or, through distributed shared memory, by
// other blocks (pilot_ls.cu at F = 8192) only after a barrier.
template <int N1, typename Publish, typename Loaded>
__device__ __forceinline__ void column_fft(const float2* __restrict__ tw, const float2 (&fw)[3],
                                           float* smem, Publish publish, Loaded loaded) {
  using G = wfft::Geo<N1>;
  constexpr int T = G::T, M = G::M, kStride = column_stride<N1>();
  const wfft::Team<T> team;
  wfft::cp_async_wait<0>();
  publish();
  __syncthreads();
  loaded();

  float* const buf = smem + team.id * kStride;
  float2 v[M];
  wfft::row_fft<N1, float>(v, buf, tw, team);
  team.sync();  // every lane has read the column's exchange buffer
  const float s0 = 1.0f / fw[2].x;  // the k1 = 0 entry is real: 1, or the sc16 scale
  const float2 step = make_float2(fw[1].x * s0, fw[1].y * s0);
  float2 w = fw[0];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int k1 = team.j + T * m;
    const float2 b = cmul(v[m], w);
    w = cmul(w, step);
    buf[k1] = b.x;
    buf[G::kPlane + k1] = b.y;
  }
}

// A column pass output value: float32, or rounded to bf16 (nearest even;
// the bf16 ring's slots).
__device__ __forceinline__ void put(float* o, float v) { *o = v; }
__device__ __forceinline__ void put(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// Where row k1 of an antenna's plane starts in a scratch or ring slot, in
// values from the antenna's first row: float32, [n1][128] (each plane its
// own array); bf16 (the bf16 ring), [n1 / 8][2][8][128], the planes
// interleaved by 8 rows from the re plane's row (the im plane's row k1 is
// 8 rows on), so that a bf16 row tile's 32 rows k1 of both planes are one
// run of 64 rows in the order its tile holds them.
template <typename S>
__host__ __device__ constexpr int slot_row(int k1) {
  return sizeof(S) == 4 ? k1 * kN2 : (k1 >> 3) * 16 * kN2 + (k1 & 7) * kN2;
}

// [n1][C] out of the column buffers, as runs of C values of the row's
// scratch (o_re, o_im: row 0 of each plane), after a __syncthreads.
template <int N1, typename S>
__device__ __forceinline__ void column_store(int c0, S* __restrict__ o_re, S* __restrict__ o_im,
                                             const float* smem) {
  using G = wfft::Geo<N1>;
  constexpr int C = columns<N1>(), kStride = column_stride<N1>();
  constexpr int kLoads = N1 * C / kColumnThreads;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int idx = threadIdx.x + u * kColumnThreads;
    const float* col = smem + (idx % C) * kStride;
    const int at = slot_row<S>(idx / C) + c0 + idx % C;
    put(o_re + at, col[idx / C]);
    put(o_im + at, col[G::kPlane + idx / C]);
  }
}

template <int N1, typename S, typename Publish, typename Loaded, typename Gate>
__device__ __forceinline__ void column_run(int c0, const float2* __restrict__ tw,
                                           const float2 (&fw)[3], S* __restrict__ o_re,
                                           S* __restrict__ o_im, float* smem,
                                           Publish publish, Loaded loaded, Gate gate) {
  column_fft<N1>(tw, fw, smem, publish, loaded);
  gate();
  __syncthreads();
  column_store<N1>(c0, o_re, o_im, smem);
}

// ---------------------------------------------------------------------------
// The row pass
// ---------------------------------------------------------------------------

// A row-pass team: its index in the block, its k1 in the block and its
// antenna team.
struct RowTeam {
  wfft::Team<kRowLanes> team;
  int g, p;
  __device__ __forceinline__ RowTeam() {
    const int w = team.id >> 2;
    g = (team.id & 3) + 4 * (w & 1);
    p = w >> 1;
  }
};

// The team index of (k1 g, antenna team p).
__device__ __forceinline__ int row_team_id(int g, int p) {
  return 4 * (2 * p + (g >> 2)) + (g & 3);
}

// The estimate slice of antenna a for bins k1_0 .. k1_0 + kK1 - 1 into an
// antenna team's stage hs, [plane][k2][kK1] floats, the two 16-byte halves
// of row k2 swapped when bit 2 of k2 is set (so the fold's reads, 4
// consecutive k1 by 8 lanes, fall in 32 banks): 512 chunks of 16 bytes, 8
// a thread (u: the thread's index in its antenna team), each pair of
// neighbour threads one whole 32-byte sector, through L2 only.
template <int N1>
__device__ __forceinline__ void stage_h(float* hs, const float* h_re, const float* h_im, int a,
                                        int k1_0, int u) {
  constexpr int F = N1 * kN2;
  const int half = u & 1, swap = (u >> 3) & 1;  // bit 2 of k2 = (u >> 1) + 32 v
  const long long row = static_cast<long long>(a) * F + k1_0 + 4 * half;
#pragma unroll
  for (int v = 0; v < 2 * kN2 * 2 / kTeamThreads; ++v) {
    const int plane = v / (kN2 * 2 / kTeamThreads);
    const int k2 = (u >> 1) + (kTeamThreads / 2) * (v % (kN2 * 2 / kTeamThreads));
    wfft::cp_async16(hs + plane * (kK1 * kN2) + k2 * kK1 + 4 * (half ^ swap),
                     (plane ? h_im : h_re) + row + static_cast<long long>(N1) * k2);
  }
}

// A row tile's gain slice gain[k1_0 + i % kK1 + n1 (i / kK1)], i < kK1
// 128, into gs[i] (one 16-byte chunk a thread of kRowThreads, one commit
// group), read by the epilogue after the row pass.
template <int N1>
__device__ __forceinline__ void stage_gain(float* gs, const float* gain, int k1_0) {
  static_assert(kRowThreads * 4 == kGainFloats, "one chunk a thread");
  const int i = threadIdx.x;
  wfft::cp_async16(gs + 4 * i, gain + k1_0 + 4 * (i & 1) + static_cast<long long>(N1) * (i >> 1));
  wfft::cp_async_commit();
}

// The row pass of one ring tile: the 128-point FFT of the scratch rows
// b[a][k1][:] (b points at the symbol's slot [A][n1][128]) for k1 = k1_0 + g
// and a = p, p + P, ... < A, each bin k1 + n1 k2 folded with the estimate
// h[a][k1 + n1 k2] (h: [A][F]) into the team's sums, Y * conj(h)
// (kConjugate) or Y * h (h conjugated already).  Each antenna team stages
// its next row's estimate slice (stage_h) while it transforms the current
// row, so the fold reads shared memory.  Rows and slices go through
// cp.async.cg (the slot is rewritten inside the launch: never through L1).
// gate() runs on every thread after the first slice is in flight and before
// a __syncthreads that precedes the first row read (the ring's wait for the
// symbol's columns).  The sums end in the team's first buffer (re at [k2],
// im at [kPlane + k2]); the caller's __syncthreads() then makes them
// readable by row_sum.  tw: the row FFT's pass twiddles (shared memory).
template <int N1, bool kConjugate, typename Gate>
__device__ __forceinline__ void row_pass(const float* b_re, const float* b_im, const float* h_re,
                                         const float* h_im, int A, int P, int k1_0,
                                         const float2* __restrict__ tw, float* smem, Gate gate) {
  constexpr int M = RowGeo::M;
  const RowTeam rt;
  const int j = rt.team.j;
  const int k1 = k1_0 + rt.g;
  float* const buf0 = smem + rt.team.id * RowGeo::kTeamFloats;
  float* const buf1 = buf0 + 2 * RowGeo::kPlane;
  float* const hs = smem + kMaxTeams * kK1 * RowGeo::kTeamFloats + rt.p * kHStageFloats;
  // This lane's estimate values: k2 = j + 8 m at hs[k2 kK1 + (g ^ 4 swap)].
  const float* const hl = hs + j * kK1 + (rt.g ^ (4 * ((j >> 2) & 1)));
  const int u = threadIdx.x % kTeamThreads;
  const int n = rt.p < A ? (A - rt.p + P - 1) / P : 0;
  auto row = [&](int a) { return (static_cast<long long>(a) * N1 + k1) * kN2; };
  auto sync_team = [&]() {  // the antenna team's 64 threads (two warps)
    asm volatile("bar.sync %0, %1;" ::"r"(1 + rt.p), "n"(kTeamThreads) : "memory");
  };

  float acc_re[M], acc_im[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc_re[m] = acc_im[m] = 0.0f;
  if (n > 0) stage_h<N1>(hs, h_re, h_im, rt.p, k1_0, u);
  wfft::cp_async_commit();  // slice 0
  gate();
  __syncthreads();
  if (n > 0) wfft::stage_row<kN2, float, true>(buf0, b_re + row(rt.p), b_im + row(rt.p), j);
  wfft::cp_async_commit();  // row 0
  // In flight, oldest first: ..., row i, slice i, row i + 1 (row 0: slice 0
  // before it).
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      const long long at = row(rt.p + (i + 1) * P);
      wfft::stage_row<kN2, float, true>((i & 1) ? buf0 : buf1, b_re + at, b_im + at, j);
    }
    wfft::cp_async_commit();  // row i + 1 (empty at the last row)
    if (i == 0) {
      wfft::cp_async_wait<1>();
    } else {
      wfft::cp_async_wait<2>();
    }
    rt.team.sync();  // row i has landed for every lane of the team
    float2 v[M];
    wfft::row_fft<kN2, float>(v, (i & 1) ? buf1 : buf0, tw, rt.team);
    wfft::cp_async_wait<1>();  // slice i, this thread's part
    sync_team();               // ... every thread's
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float cr = hl[kK1 * kRowLanes * m], ci = hl[kK1 * kN2 + kK1 * kRowLanes * m];
      if constexpr (kConjugate) {  // Y * conj(h)
        acc_re[m] += v[m].x * cr + v[m].y * ci;
        acc_im[m] += v[m].y * cr - v[m].x * ci;
      } else {  // Y * hc, hc already conjugated
        acc_re[m] += v[m].x * cr - v[m].y * ci;
        acc_im[m] += v[m].x * ci + v[m].y * cr;
      }
    }
    sync_team();  // the slice and row i's buffer are free
    if (i + 1 < n) stage_h<N1>(hs, h_re, h_im, rt.p + (i + 1) * P, k1_0, u);
    wfft::cp_async_commit();  // slice i + 1
  }
  wfft::cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    buf0[j + kRowLanes * m] = acc_re[m];
    buf0[RowGeo::kPlane + j + kRowLanes * m] = acc_im[m];
  }
}

// Sum over the block's P antenna teams of bin (k1 g, k2), after the
// row pass and a __syncthreads().
__device__ __forceinline__ float2 row_sum(const float* smem, int P, int g, int k2) {
  float re = 0.0f, im = 0.0f;
#pragma unroll
  for (int p = 0; p < kMaxTeams; ++p) {
    if (p < P) {
      const float* part = smem + row_team_id(g, p) * RowGeo::kTeamFloats;
      re += part[k2];
      im += part[RowGeo::kPlane + k2];
    }
  }
  return make_float2(re, im);
}

// ---------------------------------------------------------------------------
// The chunk loop (the split pilots)
// ---------------------------------------------------------------------------

// The chunk loop of the split pilots' entry points: items (frames) [i0, i0
// + n), n <= chunk, go through
// the column pass into the scratch [2, chunk, A, N1 * 128] (its planes b_re,
// b_im), then rows(b_re, b_im, i0, n) launches the caller's row pass.  The
// rows as for column_pass.
template <int N1, typename Rows>
cudaError_t run_split(bool int16, const void* y_re, const void* y_im, long long stride_k,
                      long long stride_s, long long stride_a, int S, int A, long long items,
                      const float* tw, float* scratch, int chunk, cudaStream_t stream,
                      Rows rows) {
  if (scratch == nullptr || chunk < 1) return cudaErrorInvalidValue;
  float* const b_re = scratch;
  float* const b_im = scratch + static_cast<long long>(chunk) * A * N1 * kN2;
  for (long long i0 = 0; i0 < items; i0 += chunk) {
    const int n = static_cast<int>(items - i0 < chunk ? items - i0 : chunk);
    cudaError_t err = column_pass(N1, int16, y_re, y_im, stride_k, stride_s, stride_a, S, A,
                                  i0, n, reinterpret_cast<const float2*>(tw), b_re, b_im,
                                  stream);
    if (err == cudaSuccess) err = rows(b_re, b_im, i0, n);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The ring (fft_mrc, mrc_demod)
// ---------------------------------------------------------------------------

// Built with -DOFDM_RING_TRACE, each ticket's block stamps %globaltimer
// into ring_trace [tickets][kRingStamps]: 0 the tile's start; a column tile
// 1 its samples loaded, 2 and 3 around its wait for the slot (after the
// FFT), 4 stored and handed on; a row tile 1 and 2 around its wait for the
// columns, 3 its rows read (the slot handed on), 4 its epilogue stored; 5
// the block, kind and item; 6 .. 11 a kernel's own phase sums of a row
// tile in nanoseconds (the bf16 ring: fft_mrc_bf16.cu).
constexpr int kRingStamps = 12;
#ifdef OFDM_RING_TRACE
static __device__ unsigned long long* ring_trace;
__device__ __forceinline__ unsigned long long ring_now() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}
// Entry k of ticket t, written by thread `by` of the block.
__device__ __forceinline__ void ring_put(long long t, int k, unsigned long long v, int by = 0) {
  if (static_cast<int>(threadIdx.x) == by && ring_trace != nullptr) {
    ring_trace[kRingStamps * t + k] = v;
  }
}
__device__ __forceinline__ void ring_stamp(long long t, int k) { ring_put(t, k, ring_now()); }
__device__ __forceinline__ void ring_note(long long t, bool column, int item) {
  ring_put(t, 5, (static_cast<unsigned long long>(blockIdx.x) << 32) |
                     (static_cast<unsigned long long>(column) << 31) | item);
}
#else
__device__ __forceinline__ unsigned long long ring_now() { return 0; }
__device__ __forceinline__ void ring_put(long long, int, unsigned long long, int = 0) {}
__device__ __forceinline__ void ring_stamp(long long, int) {}
__device__ __forceinline__ void ring_note(long long, bool, int) {}
#endif

// One ring launch's arguments.  Item i (a symbol): frame k = i / S, symbol
// i % S, its A rows at y + k stride_k + (i % S) stride_s + a stride_a.
struct RingArgs {
  const void* y_re;
  const void* y_im;
  long long stride_k, stride_s, stride_a;
  int S, A, items;
  int slots, lag;          // R and L (ops/fft_plan.py split_ring)
  float scale;             // 1, or 1 / 32767 for int16 rows
  const float2* tw;        // the split table
  float* ring;             // [2, slots, A, F] float32 (the bf16 ring: bf16)
  unsigned* counters;      // [1 + 2 items], zeroed: the ticket, columns done, rows done
  const float* h_re;       // fft_mrc: [K, A, F] h; mrc_demod: [A, F] hc
  const float* h_im;
  const float* gain;       // fft_mrc: [K, F] inv; mrc_demod: [F] hsqrd
  float* out_re;
  float* out_im;
  const void* w_image;     // the bf16 ring: W's shared-memory image (fft_mrc_bf16.cu)
};

// Ticket t -> (column or row tile, item, tile index).  Steps [0, lag) hold
// ct column tiles each, steps [lag, items) ct column tiles and rt row
// tiles (of item step - lag) each, steps [items, items + lag) rt row tiles
// each (ops/fft_plan.py ring_ticket).
struct Ticket {
  bool column;
  int item, index;
};
__host__ __device__ inline Ticket ring_ticket(long long t, int items, int lag, int ct, int rt) {
  const long long head = static_cast<long long>(lag) * ct;
  if (t < head) return {true, static_cast<int>(t / ct), static_cast<int>(t % ct)};
  t -= head;
  const long long both = static_cast<long long>(items - lag) * (ct + rt);
  if (t < both) {
    const int step = lag + static_cast<int>(t / (ct + rt)), r = static_cast<int>(t % (ct + rt));
    return r < ct ? Ticket{true, step, r} : Ticket{false, step - lag, r - ct};
  }
  t -= both;
  return {false, items - lag + static_cast<int>(t / rt), static_cast<int>(t % rt)};
}

// Column tiles of a symbol: A rows x 128 / C column groups.
template <int N1>
__host__ __device__ constexpr int ring_column_groups() {
  return kN2 / columns<N1>();
}

// Row tiles of a symbol: n1 / kRowK1, kRowK1 bins k1 a tile (ops/fft_plan.py
// split_ring_tiles): the exact kernels' kK1 = 8, the bf16 kernel's 32.
template <int N1, int kRowK1>
__host__ __device__ constexpr int ring_row_tiles() {
  return N1 / kRowK1;
}

// The persistent loop of a ring kernel (one launch a call, a 1-D grid of
// kRowThreads blocks): load the pass twiddles of both FFTs into tw (shared
// memory), then take tickets until they run out.  A column tile runs
// column_load + column_run into its symbol's slot (elements of S: float32,
// or the bf16 ring's bf16), in the first column_smem_bytes of smem; a row
// tile calls rows(t, item, q, b_re, b_im, tw, policy, gate, done) for
// ticket t, bins k1 = kRowK1 q .. kRowK1 q + kRowK1 - 1
// (tw: the row FFT's pass twiddles in shared memory): the caller runs gate()
// on every thread before a __syncthreads that precedes its first read of the
// slot, done() once its reads of the slot are over (the slot is free), and
// its epilogue.  Thread 0 takes the block's next ticket as a tile starts and
// publishes it in shared memory just before one of the tile's barriers, so
// the atomic's latency hides under the tile.
template <int N1, typename E, int kRowK1, typename S = float, bool kLateRowTicket = false,
          typename Rows>
__device__ __forceinline__ void ring_loop(const RingArgs& p, float* smem, float2* tw, Rows rows) {
  constexpr int F = N1 * kN2, CB = ring_column_groups<N1>(), RT = ring_row_tiles<N1, kRowK1>();
  const int ct = p.A * CB;
  const long long total = static_cast<long long>(p.items) * (ct + RT);
  unsigned* const cols_done = p.counters + 1;
  unsigned* const rows_done = p.counters + 1 + p.items;
  const uint64_t policy = evict_first_policy();
  for (int i = threadIdx.x; i < ring_twiddles<N1>(); i += kRowThreads) tw[i] = p.tw[i];
  const float2* const four = p.tw + four_tw_offset<N1>();
  __shared__ unsigned next[2];  // the block's ticket, and the one after it
  if (threadIdx.x == 0) next[0] = atomicAdd(p.counters, 1u);
  __syncthreads();
  for (int it = 0;; ++it) {
    const unsigned t = next[it & 1];
    if (t >= total) break;
    const Ticket tk = ring_ticket(t, p.items, p.lag, ct, RT);
    // The next ticket, taken as this tile starts: a block holds at most two,
    // the larger one idle, so the smallest ticket not done always runs.
    // With kLateRowTicket a row tile takes it as it ends instead, so no
    // column tile waits idle behind a long row tile.
    const bool early = !(kLateRowTicket && !tk.column);
    unsigned after = 0;
    if (threadIdx.x == 0 && early) after = atomicAdd(p.counters, 1u);
    auto publish = [&]() {
      if (threadIdx.x == 0 && early) next[(it + 1) & 1] = after;
    };
    ring_stamp(t, 0);
    ring_note(t, tk.column, tk.item);
    const long long slot = tk.item % p.slots;
    // The slot's planes: float32 [2][R][A][n1][128], each plane an array;
    // bf16 [R][A][n1 / 8][2][8][128] (slot_row), b_im 8 rows after b_re.
    constexpr bool kSplitPlanes = sizeof(S) == 4;
    S* const b_re = reinterpret_cast<S*>(p.ring) + slot * p.A * F * (kSplitPlanes ? 1 : 2);
    S* const b_im =
        kSplitPlanes ? b_re + static_cast<long long>(p.slots) * p.A * F : b_re + 8 * kN2;
    if (tk.column) {
      const int a = tk.index / CB, c0 = (tk.index % CB) * columns<N1>();
      const long long off = (tk.item / p.S) * p.stride_k + (tk.item % p.S) * p.stride_s +
                            a * p.stride_a;
      const long long row = static_cast<long long>(a) * F * (kSplitPlanes ? 1 : 2);
      float2 fw[3];
      column_load<N1, E, true>(static_cast<const E*>(p.y_re) + off,
                               static_cast<const E*>(p.y_im) + off, c0, four, fw, smem, policy);
      column_run<N1>(c0, tw, fw, b_re + row, b_im + row, smem, publish,
                     [&]() { ring_stamp(t, 1); },
                     [&]() {
                       ring_stamp(t, 2);
                       if (threadIdx.x == 0 && tk.item >= p.slots) {
                         wait_count(rows_done + tk.item - p.slots, RT);
                       }
                       ring_stamp(t, 3);
                     });
      // Every thread's reads of shared memory are done and its stores
      // issued before the count: the next tile may fill shared memory (no
      // second barrier).
      __syncthreads();
      if (threadIdx.x == 0) arrive(cols_done + tk.item);
      ring_stamp(t, 4);
      continue;
    }
    rows(t, tk.item, tk.index, b_re, b_im, tw + wfft::Geo<N1>::kTwiddles, policy,
         [&]() {
           ring_stamp(t, 1);
           if (threadIdx.x == 0) wait_count(cols_done + tk.item, ct);
           publish();
           ring_stamp(t, 2);
         },
         [&]() {
           if (threadIdx.x == 0) arrive(rows_done + tk.item);
           ring_stamp(t, 3);
         });
    if (threadIdx.x == 0 && !early) next[(it + 1) & 1] = atomicAdd(p.counters, 1u);
    __syncthreads();  // the epilogue's reads of shared memory are done
    ring_stamp(t, 4);
  }
}

// Launch a ring kernel (fft_mrc.cu, mrc_demod.cu; fft_mrc_bf16.cu with
// kRowK1 = 32, its own shared memory and a tensor map of its ring after
// the arguments): check the schedule (ops/fft_plan.py split_ring), then a
// grid of the blocks the card holds, no more than there are tiles.
// cudaErrorInvalidValue for a schedule the kernel cannot run.
template <int N1, int kRowK1 = kK1, typename Kernel, typename... Extra>
cudaError_t launch_ring(Kernel kernel, const RingArgs& p, cudaStream_t stream,
                        size_t bytes = ring_smem_bytes<N1>(), const Extra&... extra) {
  constexpr int CB = ring_column_groups<N1>(), RT = ring_row_tiles<N1, kRowK1>();
  if (p.ring == nullptr || p.counters == nullptr || p.items < 1 || p.A < 1 || p.S < 1 ||
      p.slots < 1 || p.lag < 1 || p.lag > p.items || (p.items > p.slots && p.lag >= p.slots)) {
    return cudaErrorInvalidValue;
  }
  const long long total = static_cast<long long>(p.items) * (static_cast<long long>(p.A) * CB + RT);
  if (total >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, bytes);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long grid = static_cast<long long>(per_sm) * sms < total
                             ? static_cast<long long>(per_sm) * sms
                             : total;
  kernel<<<static_cast<unsigned>(grid), kRowThreads, bytes, stream>>>(p, extra...);
  return cudaGetLastError();
}

}  // namespace split
}  // namespace ofdm
