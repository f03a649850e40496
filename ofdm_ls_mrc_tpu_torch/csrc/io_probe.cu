// Input-delivery probes: the io floor of the card for the data kernels'
// input.  For y [S, A, F] float32 planes (F a multiple of 128):
//   out_re[s, f] = sum_a y_re[s, a, f] + bias[f] (+ 1e-9 * burn term)
//   out_im[s, f] = sum_a y_im[s, a, f] + bias[f]
// With compute = N > 0 the burn term is sum_a burn_N(y_re[s, a, row]) over
// each 128-wide row: N chained products of the row with a 128 x 128 matrix,
// operands rounded to bf16, fp32 accumulation, the result rounded to bf16
// after each product (a simple CUDA-core loop; tensor cores are later
// work).  It is the overlap experiment: total time ~ max(io, compute) when
// the copies hide behind the compute, ~ io + compute when they serialize.
//
// Replaces tools/dma_probe.py:make_io_fn, both TPU kernels:
//   io_auto_kernel   <- variant "auto" (:62-93), the BlockSpec
//     auto-pipelined input.  Here a plain load-reduce-store: grid
//     (F/128, S), thread (plane, column) sums its column over the antennas
//     straight from device memory, coalesced across the warp.
//   io_manual_kernel <- variants "manualN"/"manualNs" (:95-209), the
//     N-deep hand-rolled DMA ring.  The TPU window (ts symbols x A x F,
//     1 MB at ts=8, 16 x 1024) fit in 16 MB of scoped VMEM but not in a
//     block's 227 KB of shared memory, so a work item is one window of TS
//     symbols x A antennas x 128 columns (whole burn rows), TS*A*1 KB per
//     plane.  One persistent block per SM walks the items b, b + grid, ...;
//     it keeps a DEPTH-stage ring of shared-memory slots filled by cp.async
//     and issues item i+DEPTH-1 before it reduces item i.  The "s" form
//     commits one cp.async group per symbol and reduces symbol k as soon as
//     its group has landed; the plain form commits one group per item.  The
//     ragged last window is clamped to start at S - TS (dma_probe.py:103-106):
//     rows it re-covers are rewritten with the same values.
//
// Bound on this card: bytes.  A frame of 16 x 1024 x 101 f32 is 13.2 MB in
// and 0.83 MB out, 4.2 us at 3.35 TB/s; without the burn the kernels do one
// add per input element.  What they measure is how close a kernel's input
// path comes to that: the io floor that every other kernel's time is read
// against.

#include <cuda_bf16.h>

#include <cstdint>

#include "fft.cuh"

namespace ofdm {

constexpr int kCols = 128;  // column tile: one burn row (the TPU's n2)
constexpr float kBurnScale = 1e-9f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Burn scratch after the rows: W [128][128] bf16, two ping-pong row buffers
// for each half of the block, and extra [rows_of_symbols][128].
__host__ __device__ constexpr size_t burn_smem_bytes(int symbols) {
  return kCols * kCols * sizeof(__nv_bfloat16) + 4 * kCols * sizeof(float) +
         static_cast<size_t>(symbols) * kCols * sizeof(float);
}

__device__ __forceinline__ void load_w(__nv_bfloat16* __restrict__ w_s,
                                       const float* __restrict__ w) {
  for (int i = threadIdx.x; i < kCols * kCols; i += kThreads) {
    w_s[i] = __float2bfloat16(w[i]);
  }
}

// Adds burn_n(row r) into extra[r / A][:] for the R rows (row stride 128) of
// `rows`, row r = k*A + a.  The two halves of the block take rows r0 and
// r0 + 1; thread j of a half computes column j of each product.  Every
// thread of the block calls it (block barriers).
__device__ void burn_rows(const float* __restrict__ rows, int R, int A, int n,
                          const __nv_bfloat16* __restrict__ w_s, float* buf,
                          float* extra) {
  const int h = threadIdx.x / kCols;
  const int j = threadIdx.x % kCols;
  for (int r0 = 0; r0 < R; r0 += 2) {
    const int r = r0 + h;
    const bool live = r < R;
    float* x = buf + h * 2 * kCols;
    float* y = x + kCols;
    x[j] = live ? bf16_round(rows[r * kCols + j]) : 0.0f;
    __syncthreads();
    for (int step = 0; step < n; ++step) {
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < kCols; ++i) {
        acc = fmaf(x[i], __bfloat162float(w_s[i * kCols + j]), acc);
      }
      y[j] = bf16_round(acc);
      __syncthreads();
      float* t = x;
      x = y;
      y = t;
    }
    if (live) atomicAdd(&extra[(r / A) * kCols + j], x[j]);
    __syncthreads();  // the next pair of rows overwrites the buffers
  }
}

// ---------------------------------------------------------------------------
// auto: plain load-reduce-store
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
io_auto_kernel(const float* __restrict__ y_re, const float* __restrict__ y_im,
               int A, int F, const float* __restrict__ bias,
               const float* __restrict__ w, int n, float* __restrict__ out_re,
               float* __restrict__ out_im) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // [A][128] re plane, burn only
  const int c = blockIdx.x;
  const long long s = blockIdx.y;
  const int p = threadIdx.x / kCols;
  const int j = threadIdx.x % kCols;
  const int col = c * kCols + j;
  const float* y = (p == 0 ? y_re : y_im) + s * A * F + col;
  float acc = 0.0f;
  for (int a = 0; a < A; ++a) {
    const float v = y[static_cast<long long>(a) * F];
    acc += v;
    if (n > 0 && p == 0) rows[a * kCols + j] = v;
  }
  float out = acc + bias[col];
  if (n > 0) {
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(rows + A * kCols);
    float* buf = reinterpret_cast<float*>(w_s + kCols * kCols);
    float* extra = buf + 4 * kCols;
    load_w(w_s, w);
    if (p == 0) extra[j] = 0.0f;
    __syncthreads();
    burn_rows(rows, A, A, n, w_s, buf, extra);
    if (p == 0) out += extra[j] * kBurnScale;
  }
  (p == 0 ? out_re : out_im)[s * F + col] = out;
}

// ---------------------------------------------------------------------------
// manualN / manualNs: a DEPTH-stage cp.async ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same with a count known only after unrolling (0..31; the kernels'
// DEPTH <= 4 and TS <= 8 keep it there).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
#define OFDM_WAIT_CASE(N) \
  case N:                 \
    cp_async_wait<N>();   \
    break;
    OFDM_WAIT_CASE(0) OFDM_WAIT_CASE(1) OFDM_WAIT_CASE(2) OFDM_WAIT_CASE(3)
    OFDM_WAIT_CASE(4) OFDM_WAIT_CASE(5) OFDM_WAIT_CASE(6) OFDM_WAIT_CASE(7)
    OFDM_WAIT_CASE(8) OFDM_WAIT_CASE(9) OFDM_WAIT_CASE(10) OFDM_WAIT_CASE(11)
    OFDM_WAIT_CASE(12) OFDM_WAIT_CASE(13) OFDM_WAIT_CASE(14) OFDM_WAIT_CASE(15)
    OFDM_WAIT_CASE(16) OFDM_WAIT_CASE(17) OFDM_WAIT_CASE(18) OFDM_WAIT_CASE(19)
    OFDM_WAIT_CASE(20) OFDM_WAIT_CASE(21) OFDM_WAIT_CASE(22) OFDM_WAIT_CASE(23)
    OFDM_WAIT_CASE(24) OFDM_WAIT_CASE(25) OFDM_WAIT_CASE(26) OFDM_WAIT_CASE(27)
    OFDM_WAIT_CASE(28) OFDM_WAIT_CASE(29) OFDM_WAIT_CASE(30) OFDM_WAIT_CASE(31)
#undef OFDM_WAIT_CASE
    default:
      asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

__host__ __device__ constexpr size_t manual_ring_bytes(int depth, int ts, int A) {
  return static_cast<size_t>(depth) * 2 * ts * A * kCols * sizeof(float);
}

template <int DEPTH, int TS, bool PER_SYMBOL>
__global__ void __launch_bounds__(kThreads)
io_manual_kernel(const float* __restrict__ y_re, const float* __restrict__ y_im,
                 int S, int A, int F, const float* __restrict__ bias,
                 const float* __restrict__ w, int n, float* __restrict__ out_re,
                 float* __restrict__ out_im) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [DEPTH][2][TS][A][128]
  const int stage = 2 * TS * A * kCols;           // floats per slot
  const int tiles = F / kCols;
  const int items = ((S + TS - 1) / TS) * tiles;
  const int grid = static_cast<int>(gridDim.x);
  const int mine = (items - 1 - static_cast<int>(blockIdx.x)) / grid + 1;
  const int p = threadIdx.x / kCols;
  const int j = threadIdx.x % kCols;
  const int chunks = A * (kCols / 4);  // 16-byte copies per symbol and plane

  // The it-th item of this block: window start (clamped) and column tile.
  auto window = [&](int it, int& st, int& c) {
    const int item = static_cast<int>(blockIdx.x) + it * grid;
    st = min((item / tiles) * TS, S - TS);
    c = item % tiles;
  };

  // Copies the it-th item into slot it % DEPTH: one commit group per symbol
  // (PER_SYMBOL) or per item.  Past the last item the groups are empty, so
  // every item owns the same number of groups and the waits below count
  // right to the end.
  auto issue = [&](int it) {
    const bool real = it < mine;
    int st = 0, c = 0;
    if (real) window(it, st, c);
    float* slot = ring + (it % DEPTH) * stage;
#pragma unroll
    for (int k = 0; k < TS; ++k) {
      if (real) {
        for (int q = threadIdx.x; q < 2 * chunks; q += kThreads) {
          const int plane = q / chunks;
          const int a = (q % chunks) / (kCols / 4);
          const int v = q % (kCols / 4);
          const float* src = (plane ? y_im : y_re) +
                             (static_cast<long long>(st + k) * A + a) * F +
                             c * kCols + v * 4;
          cp_async16(slot + ((plane * TS + k) * A + a) * kCols + v * 4, src);
        }
      }
      if (PER_SYMBOL) cp_async_commit();
    }
    if (!PER_SYMBOL) cp_async_commit();
  };

  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(ring + DEPTH * stage);
  float* buf = reinterpret_cast<float*>(w_s + kCols * kCols);
  float* extra = buf + 4 * kCols;  // [TS][128]
  if (n > 0) load_w(w_s, w);       // visible after the first barrier below

  for (int it = 0; it < DEPTH - 1; ++it) issue(it);
  for (int it = 0; it < mine; ++it) {
    issue(it + DEPTH - 1);  // into the slot item it-1 freed
    int st, c;
    window(it, st, c);
    const float* slot = ring + (it % DEPTH) * stage;
    const int col = c * kCols + j;
    const float b = bias[col];
    float sum[TS];
    if (!PER_SYMBOL) cp_async_wait<DEPTH - 1>();
#pragma unroll
    for (int k = 0; k < TS; ++k) {
      // Groups committed after symbol k of item it: the rest of this item's
      // symbols and the DEPTH-1 items issued ahead.
      if (PER_SYMBOL) cp_async_wait_dyn((DEPTH - 1) * TS + TS - 1 - k);
      __syncthreads();
      const float* col_rows = slot + (p * TS + k) * A * kCols + j;
      float acc = 0.0f;
      for (int a = 0; a < A; ++a) acc += col_rows[a * kCols];
      sum[k] = acc + b;
    }
    if (n > 0) {
#pragma unroll
      for (int k = 0; k < TS; ++k) {
        if (p == 0) extra[k * kCols + j] = 0.0f;
      }
      __syncthreads();
      burn_rows(slot, TS * A, A, n, w_s, buf, extra);  // the re plane's rows
#pragma unroll
      for (int k = 0; k < TS; ++k) {
        if (p == 0) sum[k] += extra[k * kCols + j] * kBurnScale;
      }
    }
    float* out = p == 0 ? out_re : out_im;
#pragma unroll
    for (int k = 0; k < TS; ++k) out[static_cast<long long>(st + k) * F + col] = sum[k];
    __syncthreads();  // the slot is refilled by the next iteration's issue
  }
  cp_async_wait<0>();
}

template <int DEPTH, int TS, bool PER_SYMBOL>
cudaError_t launch_manual(const float* y_re, const float* y_im, int S, int A, int F,
                          const float* bias, const float* w, int n, float* out_re,
                          float* out_im, cudaStream_t stream) {
  auto kernel = io_manual_kernel<DEPTH, TS, PER_SYMBOL>;
  const size_t smem = manual_ring_bytes(DEPTH, TS, A) + (n > 0 ? burn_smem_bytes(TS) : 0);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int items = ((S + TS - 1) / TS) * (F / kCols);
  const int grid = items < sms ? items : sms;
  kernel<<<grid, kThreads, smem, stream>>>(y_re, y_im, S, A, F, bias, w, n, out_re,
                                           out_im);
  return cudaGetLastError();
}

template <int DEPTH, bool PER_SYMBOL>
cudaError_t dispatch_ts(int ts, const float* y_re, const float* y_im, int S, int A,
                        int F, const float* bias, const float* w, int n,
                        float* out_re, float* out_im, cudaStream_t stream) {
  switch (ts) {
    case 1:
      return launch_manual<DEPTH, 1, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n,
                                                 out_re, out_im, stream);
    case 2:
      return launch_manual<DEPTH, 2, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n,
                                                 out_re, out_im, stream);
    case 4:
      return launch_manual<DEPTH, 4, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n,
                                                 out_re, out_im, stream);
    case 8:
      return launch_manual<DEPTH, 8, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n,
                                                 out_re, out_im, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool PER_SYMBOL>
cudaError_t dispatch_depth(int depth, int ts, const float* y_re, const float* y_im,
                           int S, int A, int F, const float* bias, const float* w,
                           int n, float* out_re, float* out_im, cudaStream_t stream) {
  switch (depth) {
    case 2:
      return dispatch_ts<2, PER_SYMBOL>(ts, y_re, y_im, S, A, F, bias, w, n, out_re,
                                        out_im, stream);
    case 3:
      return dispatch_ts<3, PER_SYMBOL>(ts, y_re, y_im, S, A, F, bias, w, n, out_re,
                                        out_im, stream);
    case 4:
      return dispatch_ts<4, PER_SYMBOL>(ts, y_re, y_im, S, A, F, bias, w, n, out_re,
                                        out_im, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ofdm

// y_re/y_im: [S, A, F] contiguous float32, 16-byte aligned, F a multiple of
// 128.  bias: [F].  w: [128, 128] float32 (rounded to bf16 on load), read
// only when compute > 0.  Outputs out_re/out_im: [S, F].  Return the
// cudaError_t of the launch.
extern "C" int ofdm_io_auto(const float* y_re, const float* y_im, int S, int A, int F,
                            const float* bias, const float* w, int compute,
                            float* out_re, float* out_im, void* stream) {
  const size_t smem = compute > 0 ? static_cast<size_t>(A) * ofdm::kCols * sizeof(float) +
                                        ofdm::burn_smem_bytes(1)
                                  : 0;
  cudaError_t err = ofdm::allow_smem(ofdm::io_auto_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ofdm::io_auto_kernel<<<dim3(F / ofdm::kCols, S), ofdm::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      y_re, y_im, A, F, bias, w, compute, out_re, out_im);
  return static_cast<int>(cudaGetLastError());
}

// depth in {2, 3, 4}, ts in {1, 2, 4, 8}, S >= ts; per_symbol selects the
// "s" form.  The ring (depth * ts * A KB) plus, with compute > 0, the burn
// scratch must fit the 227 KB a block may use.
extern "C" int ofdm_io_manual(const float* y_re, const float* y_im, int S, int A,
                              int F, const float* bias, const float* w, int compute,
                              int depth, int ts, int per_symbol, float* out_re,
                              float* out_im, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      per_symbol ? ofdm::dispatch_depth<true>(depth, ts, y_re, y_im, S, A, F, bias, w,
                                              compute, out_re, out_im, st)
                 : ofdm::dispatch_depth<false>(depth, ts, y_re, y_im, S, A, F, bias, w,
                                               compute, out_re, out_im, st);
  return static_cast<int>(err);
}
