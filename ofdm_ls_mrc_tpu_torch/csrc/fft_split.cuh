// The split form of the FFT: the exact kernels at F = 16384 and 32768
// (fft_mrc.cu, mrc_demod.cu, pilot_ls.cu) and the bf16 speed kernels' stage
// 1 at F = 8192 to 32768 (fft_mrc_bf16.cu).
//
// Why two passes.  Up to F = 8192 a row lives in the registers of one team
// (fft_warp.cuh: 256 threads of 32 complex values at 8192) beside its sums
// over the antennas.  At 16384 the row alone is 128 KB of registers and the
// sums as much again, half the SM's file at 512 threads of at most 128
// registers (the register FFT needs 223-255 at M = 32); at 32768 the row is
// the whole file.  So the row is split, F = n1 x 128, x[i1, i2] =
// x[128 i1 + i2]:
//   1. the column pass (fft_split.cu, column_pass): the n1-point DFT over i1
//      of every column i2 -- the register FFT at F = n1, one team a column,
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
//      p = w / 2, so a warp's estimate reads take 16 bytes of each of eight
//      32-byte sectors and its neighbour warp the other 16.
// The passes meet in a scratch [2, chunk, A, F] of float32 in device memory:
// the symbols (the pilot: frames) go through in chunks of up to 512 MB of
// scratch, each the column pass then the row pass (ops/fft_plan.py
// split_chunk; fewer, larger launches beat a scratch that L2 would hold).
// The scratch costs a write and a read of every sample beside the input's
// read (PERF.md has the times against the bound).  A cluster form that
// passes the transpose through distributed shared memory (a symbol a
// cluster of n1 / 64 blocks, one block an SM, a cluster barrier a row)
// measured slower on the H100: each block's load, FFT, barrier, gather and
// fold run in turn.
//
// ops/fft_plan.py holds the same geometry (the split section), and
// tests/test_torch_large_fft.py emulates both passes in numpy on its tables.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fft_warp.cuh"

namespace ofdm {
namespace split {

constexpr int kN2 = 128;             // the row pass's length
constexpr int kK1 = 8;               // bins k1 of a row-pass block
constexpr int kMaxTeams = 4;         // antenna teams of a row-pass block, at most
constexpr int kColumnThreads = 256;  // threads of a column-pass block
using RowGeo = wfft::Geo<kN2>;       // 16 values, 8 lanes a row
constexpr int kRowLanes = RowGeo::T;
constexpr int kRowThreads = kMaxTeams * kK1 * kRowLanes;  // 256

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

// The column pass of items [item0, item0 + n) (item i: k = i / S, s = i % S,
// its A rows at y + k stride_k + s stride_s + a stride_a, int16 or float32)
// into b_re/b_im [n, A, n1, 128], tw the split table.  One launch; defined
// in fft_split.cu.  cudaErrorInvalidValue for an n1 it does not instantiate.
cudaError_t column_pass(int n1, bool int16, const void* y_re, const void* y_im,
                        long long stride_k, long long stride_s, long long stride_a, int S,
                        int A, long long item0, int n, const float2* tw, float* b_re,
                        float* b_im, cudaStream_t stream);

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

// The row pass of one block: the 128-point FFT of the scratch rows
// b[a][k1][:] (b points at the symbol's [A][n1][128]) for k1 = k1_0 + g and
// a = p, p + P, ... < A; op(a, k1, k2, y, acc_re, acc_im) folds bin
// k1 + n1 k2 of row a into the team's sums.  The sums end in the team's
// first buffer (re at [k2], im at [kPlane + k2]); the caller's
// __syncthreads() then makes them readable by row_sum.  tw: the row FFT's
// pass twiddles, read through L1.  (An L1 prefetch of the estimate one row
// ahead measured slower on the H100.)
template <int N1, typename Op>
__device__ __forceinline__ void row_pass(const float* __restrict__ b_re,
                                         const float* __restrict__ b_im, int A, int P,
                                         int k1_0, const float2* __restrict__ tw,
                                         float* smem, Op op) {
  constexpr int M = RowGeo::M;
  const RowTeam rt;
  const int j = rt.team.j;
  const int k1 = k1_0 + rt.g;
  float* const buf0 = smem + rt.team.id * RowGeo::kTeamFloats;
  float* const buf1 = buf0 + 2 * RowGeo::kPlane;
  const int n = rt.p < A ? (A - rt.p + P - 1) / P : 0;
  auto row = [&](int a) { return (static_cast<long long>(a) * N1 + k1) * kN2; };

  float acc_re[M], acc_im[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc_re[m] = acc_im[m] = 0.0f;
  if (n > 0) wfft::stage_row<kN2, float, true>(buf0, b_re + row(rt.p), b_im + row(rt.p), j);
  wfft::cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      const long long at = row(rt.p + (i + 1) * P);
      wfft::stage_row<kN2, float, true>((i & 1) ? buf0 : buf1, b_re + at, b_im + at, j);
      wfft::cp_async_commit();
      wfft::cp_async_wait<1>();
    } else {
      wfft::cp_async_wait<0>();
    }
    rt.team.sync();  // row i has landed for every lane of the team
    float2 v[M];
    wfft::row_fft<kN2, float>(v, (i & 1) ? buf1 : buf0, tw, rt.team);
    const int a = rt.p + i * P;
#pragma unroll
    for (int m = 0; m < M; ++m) op(a, k1, j + kRowLanes * m, v[m], acc_re[m], acc_im[m]);
    rt.team.sync();  // row i's buffer is free for row i + 2
  }
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

// The chunk loop of every split entry point: items (symbols; the pilot:
// frames) [i0, i0 + n), n <= chunk, go through the column pass into the
// scratch [2, chunk, A, N1 * 128] (its planes b_re, b_im), then rows(b_re,
// b_im, i0, n) launches the caller's row pass.  The rows as for column_pass.
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

}  // namespace split
}  // namespace ofdm
