// The column pass of the split form (fft_split.cuh): for every antenna row
// of a chunk of symbols, the n1-point DFT over i1 of each column i2 of
// x[i1, i2] = x[128 i1 + i2], times exp(-2 pi i k1 i2 / F), into the
// scratch row B[k1][i2].  The first half of the four-step FFT that the
// exact kernels run at F = 16384 and 32768 and the speed kernels at 8192
// to 32768 (their stage 1: the TPU kernel's n1-point DFT and twiddle).
//
// Grid (128 / C, n A): a block of 256 threads takes C consecutive columns
// of one antenna row, C = 256 / T (the n1-point register FFT's team of T
// lanes, one a column: 32 columns at n1 = 64 and 128, 16 at 256), two
// blocks an SM.  It loads its [n1][C] samples as n1 runs of C consecutive
// samples (coalesced; float32 by 4-byte cp.async into place, int16 through
// registers, widened exactly), transposes them into one buffer a column
// (stride 2 kPlane + 1 floats, odd, or at 16 columns 2 kPlane + 2, twice
// odd: a warp's 32 samples fall in 32 banks), runs each column's FFT,
// applies the twiddle of bin k1 (register m of lane j holds k1 = j + T m),
// writes the result back into the column's buffer in natural order and
// stores the block's [n1][C] as runs of C consecutive floats.
//
// Bound: bytes.  A 16 x 32768 f32 symbol reads 4.2 MB and writes 4.2 MB of
// scratch; 5 n1 log2 n1 + 6 FLOP a column sample is far under the fp32
// rate.  ptxas: see chip_smoke.py phase 15.
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

#include <cstdint>

#include "fft_split.cuh"

namespace ofdm {
namespace split {

constexpr int kColumnBlocks = 2;  // blocks an SM should hold (__launch_bounds__)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Columns of a block: one a team of the n1-point register FFT (32 at n1 =
// 64 and 128, 16 at 256; 32 columns at 256, two a team, measured slower).
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

template <int N1, typename E>
__global__ void __launch_bounds__(kColumnThreads, kColumnBlocks)
column_pass_kernel(const E* __restrict__ y_re, const E* __restrict__ y_im,
                   long long stride_k, long long stride_s, long long stride_a, int S, int A,
                   long long item0, const float2* __restrict__ tw, float* __restrict__ b_re,
                   float* __restrict__ b_im) {
  using G = wfft::Geo<N1>;
  constexpr int T = G::T, M = G::M, C = columns<N1>(), kStride = column_stride<N1>();
  constexpr int kLoads = N1 * C / kColumnThreads;  // samples of a thread, each plane
  constexpr int F = N1 * kN2;
  static_assert(C * T == kColumnThreads && kN2 % C == 0 && kLoads * kColumnThreads == N1 * C,
                "column geometry");
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const wfft::Team<T> team;
  const int c0 = blockIdx.x * C;
  const long long r = blockIdx.y;  // row of the chunk: (item - item0) A + a
  const long long item = item0 + r / A;
  const int a = static_cast<int>(r % A);
  const long long off = (item / S) * stride_k + (item % S) * stride_s + a * stride_a;
  const E* const xr = y_re + off;
  const E* const xi = y_im + off;
  const float2* const four = tw + four_tw_offset<N1>();
  const int i2 = c0 + team.id;
  if (threadIdx.x < G::kTwiddles * 8 / 128) {  // the FFT's pass twiddles into L1
    asm volatile("prefetch.global.L1 [%0];" ::"l"(tw + 16 * threadIdx.x));
  }
  float2 fw[3];  // the twiddle entries k1 = j, T and 0, loaded behind the samples
  auto load_twiddles = [&]() {
    fw[0] = __ldg(four + team.j * kN2 + i2);
    fw[1] = __ldg(four + T * kN2 + i2);
    fw[2] = __ldg(four + i2);
  };

  // [n1][C] in, as runs of C samples; column c's i1 into its buffer: float
  // rows by 4-byte cp.async straight into place (no registers held), int16
  // rows through registers, widened.
  if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kColumnThreads;
      const int at = (idx / C) * kN2 + c0 + idx % C;
      float* col = smem + (idx % C) * kStride + idx / C;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(col)),
                   "l"(xr + at) : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(col + G::kPlane)),
                   "l"(xi + at) : "memory");
    }
    wfft::cp_async_commit();
    load_twiddles();
    wfft::cp_async_wait<0>();
  } else {
    float lr[kLoads], li[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int idx = threadIdx.x + u * kColumnThreads;
      const int at = (idx / C) * kN2 + c0 + idx % C;
      lr[u] = wfft::widen(xr[at]);
      li[u] = wfft::widen(xi[at]);
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
  __syncthreads();

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
  __syncthreads();

  // [n1][C] out, as runs of C floats of the row's scratch.
  float* const o_re = b_re + r * F;
  float* const o_im = b_im + r * F;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int idx = threadIdx.x + u * kColumnThreads;
    const float* col = smem + (idx % C) * kStride;
    const int at = (idx / C) * kN2 + c0 + idx % C;
    o_re[at] = col[idx / C];
    o_im[at] = col[G::kPlane + idx / C];
  }
}

template <int N1, typename E>
cudaError_t launch_column(const void* y_re, const void* y_im, long long stride_k,
                          long long stride_s, long long stride_a, int S, int A,
                          long long item0, int n, const float2* tw, float* b_re, float* b_im,
                          cudaStream_t stream) {
  auto kernel = column_pass_kernel<N1, E>;
  constexpr size_t bytes = column_smem_bytes<N1>();
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(n) * A > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(kN2 / columns<N1>(), n * A), kColumnThreads, bytes, stream>>>(
      static_cast<const E*>(y_re), static_cast<const E*>(y_im), stride_k, stride_s, stride_a,
      S, A, item0, tw, b_re, b_im);
  return cudaGetLastError();
}

cudaError_t column_pass(int n1, bool int16, const void* y_re, const void* y_im,
                        long long stride_k, long long stride_s, long long stride_a, int S,
                        int A, long long item0, int n, const float2* tw, float* b_re,
                        float* b_im, cudaStream_t stream) {
#define OFDM_COLUMN_CASE(N)                                                                \
  case N:                                                                                  \
    return int16 ? launch_column<N, int16_t>(y_re, y_im, stride_k, stride_s, stride_a, S, \
                                             A, item0, n, tw, b_re, b_im, stream)          \
                 : launch_column<N, float>(y_re, y_im, stride_k, stride_s, stride_a, S,   \
                                           A, item0, n, tw, b_re, b_im, stream);
  switch (n1) {
    OFDM_COLUMN_CASE(64)
    OFDM_COLUMN_CASE(128)
    OFDM_COLUMN_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_COLUMN_CASE
}

}  // namespace split
}  // namespace ofdm
