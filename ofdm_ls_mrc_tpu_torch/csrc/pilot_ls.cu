// Pilot LS channel estimate for K frames in one launch: FFT of each pilot
// row, h = Y * conj(X) / |X|^2 and inv = 1 / sum_a |h|^2.
//
// Replaces ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:_pilot_kernel (:222,
// wrapper estimate_pilot_fused :264).  The TPU kernel ran one program over
// all antennas and reduced sum_a |h|^2 in VMEM.  Here a thread block cluster
// does it for each frame: grid (C, K), cluster (C, 1, 1), each block a few
// teams of the register FFT of csrc/fft_warp.cuh (a team is one warp at
// F = 1024).  Team g of the cluster (g = rank * teams + team) takes antenna
// rows g, g + C * teams, ...; the geometry is ops/fft_plan.py pilot_plan,
// passed in by the wrapper and checked here.  A team's row goes through
// row_fft, after which register m holds bin t = j + T m; the LS divide, the
// sc16 scale, the coalesced store of h and the sum of |h_t|^2 over the
// team's rows all happen in registers.  The block adds its teams' sums in
// shared memory; after cluster.sync() rank r adds its share of the bins
// (fft_plan.pilot_rank_bins) over the C blocks' shared memory (distributed
// shared memory) and writes inv; a second cluster.sync() keeps every block
// resident until its peers have read it.  As in the TPU fused path the DC
// bin is not masked: X[0] = 1 and the data kernel drops that bin at its
// store.  Rows are read in place through the caller's strides (cp.async for
// 16-byte aligned rows, element loads for an odd cyclic prefix); X is
// staged in shared memory with the first row.
//
// Bound on this card: one 16 x 1024 f32 pilot reads 128 KB of rows and 8 KB
// of X and writes 128 KB of h and 4 KB of inv (0.274 MB), and does 1.1
// MFLOP: 0.08 us at 3.35 TB/s.  So it is latency-bound, and the design cuts
// latency: a team per row (16 warps on 4 SMs at A = 16), no block barrier
// inside a row, and no second launch.  (The kernel it replaces ran a
// 256-thread block per row through a shared-memory radix-2 FFT with a block
// barrier at each of its 10 stages, then a second kernel read all of h back
// to sum |h|^2, since blocks could not share the sum.)  What is left
// (PERF.md): the row load, one warp's row FFT with no other warp on
// its scheduler to hide latency, and the cluster tail with its two barriers.
// Loops whose trip count depends on the launch are bounded by constants
// (kMaxTeams, kMaxCluster) so that their loads issue together; the pass
// twiddles are read through L1.

#include <cooperative_groups.h>

#include <cstdint>

#include "fft_warp.cuh"

namespace ofdm {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the portable cluster size

// Most threads a pilot block holds: 128, or two teams where a team is more
// than 64 threads (F = 4096).  Mirrored by ops/fft_plan.py pilot_max_threads.
template <int F>
__host__ __device__ constexpr int pilot_max_threads() {
  return 2 * wfft::Geo<F>::T > 128 ? 2 * wfft::Geo<F>::T : 128;
}

// Dynamic shared memory of a block of `teams` teams: the teams' buffers, X
// (two planes of F floats), then the block's sum over its teams (F floats).
template <int F>
__host__ __device__ constexpr size_t pilot_smem_bytes(int teams) {
  return (static_cast<size_t>(teams) * wfft::Geo<F>::kTeamFloats + 3 * F) * sizeof(float);
}

template <int F, typename T, bool kAligned>
__global__ void __launch_bounds__(pilot_max_threads<F>())
pilot_ls_kernel(const T* __restrict__ y_re, const T* __restrict__ y_im,
                long long stride_k, long long stride_a, float scale, int A,
                const float* __restrict__ x_re, const float* __restrict__ x_im,
                const float2* __restrict__ tw, float* __restrict__ h_re,
                float* __restrict__ h_im, float* __restrict__ inv) {
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
  float* const bsum = xs + 2 * F;                    // the block's sum [F]

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

  // The team's sums into its first buffer, the block's sum into bsum.
#pragma unroll
  for (int m = 0; m < M; ++m) buf0[j + TT * m] = acc[m];
  __syncthreads();
  for (int t = threadIdx.x; t < F; t += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < kMaxTeams; ++p) {
      if (p < teams) s += smem[p * G_::kTeamFloats + t];
    }
    bsum[t] = s;
  }
  cluster.sync();  // every block's bsum is written and visible to the cluster

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
    inv_k[t] = 1.0f / s;
  }
  cluster.sync();  // no block leaves while a peer still reads its bsum
}

template <int F, typename T, bool kAligned>
cudaError_t launch_pilot(const void* y_re, const void* y_im, long long stride_k,
                         long long stride_a, float scale, int K, int A, int clusters,
                         int teams, int rows, long long smem, const float* x_re,
                         const float* x_im, const float* tw, float* h_re, float* h_im,
                         float* inv, cudaStream_t stream) {
  using G_ = wfft::Geo<F>;
  const int threads = teams * G_::T;
  if (K < 1 || K > 65535 || A < 1 || clusters < 1 || clusters > kMaxCluster ||
      teams < 1 || threads > pilot_max_threads<F>() ||
      rows != (A + clusters * teams - 1) / (clusters * teams) ||
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
                           inv);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool kAligned>
cudaError_t dispatch_pilot(int F, const void* y_re, const void* y_im,
                           long long stride_k, long long stride_a, float scale, int K,
                           int A, int clusters, int teams, int rows, long long smem,
                           const float* x_re, const float* x_im, const float* tw,
                           float* h_re, float* h_im, float* inv, cudaStream_t stream) {
#define OFDM_PILOT_CASE(N)                                                             \
  case N:                                                                              \
    return launch_pilot<N, T, kAligned>(y_re, y_im, stride_k, stride_a, scale, K, A, \
                                        clusters, teams, rows, smem, x_re, x_im, tw, \
                                        h_re, h_im, inv, stream);
  switch (F) {
    OFDM_PILOT_CASE(256)
    OFDM_PILOT_CASE(512)
    OFDM_PILOT_CASE(1024)
    OFDM_PILOT_CASE(2048)
    OFDM_PILOT_CASE(4096)
    default:
      return cudaErrorInvalidValue;
  }
#undef OFDM_PILOT_CASE
}

}  // namespace ofdm

// Pilot rows: y_re/y_im point at row (k=0, a=0) of K x A rows of F samples,
// row (k, a) at element offset k*stride_k + a*stride_a; int16 when in_int16
// (scaled by `scale`), float32 otherwise.  aligned: every row starts 16-byte
// aligned (the cp.async load path).  clusters, teams, rows, smem: the launch
// geometry of ops/fft_plan.py pilot_plan(A, F), checked against the kernel's
// own (cudaErrorInvalidValue when it differs).  x_re/x_im: [F] padded pilot,
// natural order.  tw: the pass twiddles of ops/fft_plan.py.  Outputs
// h_re/h_im [K, A, F] and inv [K, F].  Returns the cudaError_t of the launch.
extern "C" int ofdm_pilot_ls(const void* y_re, const void* y_im, int in_int16,
                             int aligned, long long stride_k, long long stride_a,
                             float scale, int K, int A, int F, int clusters, int teams,
                             int rows, long long smem, const float* x_re,
                             const float* x_im, const float* tw, float* h_re,
                             float* h_im, float* inv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto dispatch) {
    return dispatch(F, y_re, y_im, stride_k, stride_a, scale, K, A, clusters, teams, rows,
                    smem, x_re, x_im, tw, h_re, h_im, inv, st);
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

// Text of a cudaError_t returned by the entry points.
extern "C" const char* ofdm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
