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
//     N-deep hand-rolled DMA ring with a semaphore per slot (per symbol in
//     the "s" form).  The TPU window (ts symbols x A x F, 1 MB at ts=8,
//     16 x 1024) fit in 16 MB of scoped VMEM but not in a block's 227 KB of
//     shared memory, so a work item is one window of TS symbols x A
//     antennas x 128 columns (whole burn rows), TS*A/2 KB per plane.
//     Persistent blocks (one per SM) walk the items b, b + grid, ... in
//     a DEPTH-stage ring.  Its Hopper form: one producer warp, whose
//     elected lane refills a stage once the stage's "empty" mbarrier says
//     its consumers are done, with one TMA tensor copy (cp.async.bulk.tensor
//     of a box of TS symbols x A antennas x 128 columns) a plane, after an
//     arrival that arms the stage's "full" mbarrier with the bytes to come;
//     the "s" form has a full barrier and a copy a plane per symbol (the
//     TPU's per-symbol semaphores, dma_probe.py:111-118).  8 consumer warps
//     wait on "full", reduce, arrive on "empty" and store.  Phase parity per
//     stage as in a TMA pipeline.  The ragged last window is clamped to
//     start at S - TS (dma_probe.py:103-106): rows it re-covers are
//     rewritten with the same values.
//     What held the previous ring (cp.async, all 256 threads) back, read
//     from the code: four 16-byte copies per thread per symbol and plane,
//     each thread's address arithmetic and issue slots spent on them; a
//     __syncthreads per symbol and another per item, so the refill, the
//     reduce and the stores took turns.  Here one thread issues 2 copies a
//     window (2 TS in the "s" form), nothing block-wide runs in the steady
//     state (the burn's barriers are named, over the consumers only), and a
//     warp releases its slot before it stores.  Tensor copies, not one
//     512-byte bulk copy (cp.async.bulk) per (plane, symbol, antenna): with
//     those, 64 a window at TS = 2, A = 16, a block stayed at ~70% of the
//     io floor at any depth, whether one lane or the whole warp issued them,
//     and reached it only at two blocks per SM (PERF.md).  The tensor
//     maps are encoded on the host for each launch (two per call).
//
// Bound on this card: bytes.  A frame of 16 x 1024 x 101 f32 is 13.2 MB in
// and 0.83 MB out (14.07 MB with the bias), 4.20 us at 3.35 TB/s; without
// the burn the kernels do one add per input element.  What they measure is
// how close a kernel's input path comes to that: the io floor that every
// other kernel's time is read against.

#include <cuda.h>  // CUtensorMap and its encoder's types; no libcuda link
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

// Barrier over the kThreads computing threads (threads 0..255), named so
// that the io_manual kernel's producer warp takes no part in it.
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

// Adds burn_n(row r) into extra[r / A][:] for the R rows (row stride 128) of
// `rows`, row r = k*A + a.  The two halves of the kThreads computing threads
// take rows r0 and r0 + 1; thread j of a half computes column j of each
// product.  Every computing thread calls it (compute_sync barriers).  Out of
// line, so that every kernel runs the same code: inlined, its chain of
// products compiled differently in each io_manual instantiation, and ran
// at up to twice the time (PERF.md).
__device__ __noinline__ void burn_rows(const float* __restrict__ rows, int R, int A, int n,
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
    compute_sync();
    for (int step = 0; step < n; ++step) {
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < kCols; ++i) {
        acc = fmaf(x[i], __bfloat162float(w_s[i * kCols + j]), acc);
      }
      y[j] = bf16_round(acc);
      compute_sync();
      float* t = x;
      x = y;
      y = t;
    }
    if (live) atomicAdd(&extra[(r / A) * kCols + j], x[j]);
    compute_sync();  // the next pair of rows overwrites the buffers
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
// manualN / manualNs: a DEPTH-stage ring fed by TMA tensor copies
// ---------------------------------------------------------------------------

constexpr int kConsumerWarps = kThreads / 32;   // thread (plane, column) each
constexpr int kManualThreads = kThreads + 32;   // and one producer warp

// Full barriers of one ring stage: one per symbol in the "s" form.
__host__ __device__ constexpr int full_barriers(int ts, bool per_symbol) {
  return per_symbol ? ts : 1;
}

// The barriers at the start of shared memory (8 bytes each: DEPTH stages of
// full barriers, then DEPTH empty barriers), rounded up to 128 bytes so the
// ring after them is 128-byte aligned for the tensor copies.
__host__ __device__ constexpr size_t ring_barrier_bytes(int depth, int ts, bool per_symbol) {
  return (static_cast<size_t>(depth) * (full_barriers(ts, per_symbol) + 1) * 8 + 127) / 128 *
         128;
}

__host__ __device__ constexpr size_t manual_ring_bytes(int depth, int ts, int A) {
  return static_cast<size_t>(depth) * 2 * ts * A * kCols * sizeof(float);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also raises the phase's expected transaction bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA copy of the box of `map` at (column c0, antenna c1, symbol c2) into
// shared memory, completed on `bar` as transaction bytes.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor map of one plane, [S, A, F] f32, with a box of box_s symbols x A
// antennas x 128 columns: one TMA copy lands it as [box_s][A][128] in
// shared memory.  The encoder is libcuda's cuTensorMapEncodeTiled, looked
// up through the runtime's entry-point query, so nothing links against
// libcuda.
__host__ cudaError_t plane_map(CUtensorMap* map, const float* plane, int S, int A, int F,
                               int box_s) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(A),
                              static_cast<cuuint64_t>(S)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(F) * sizeof(float),
                                 static_cast<cuuint64_t>(A) * F * sizeof(float)};
  const cuuint32_t box[3] = {kCols, static_cast<cuuint32_t>(A), static_cast<cuuint32_t>(box_s)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(plane),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Item it of a block: stage it % DEPTH, its barriers waited on with parity
// (it / DEPTH) & 1 (the full barriers by the consumers; the empty barrier
// with the other parity by the producer, so the first DEPTH waits pass).
// Mirrored by tools/dma_probe.py ring_schedule.
template <int DEPTH, int TS, bool PER_SYMBOL>
__global__ void __launch_bounds__(kManualThreads)
io_manual_kernel(const __grid_constant__ CUtensorMap map_re,
                 const __grid_constant__ CUtensorMap map_im, int S, int A, int F,
                 const float* __restrict__ bias, const float* __restrict__ w, int n,
                 float* __restrict__ out_re, float* __restrict__ out_im) {
  constexpr int kFull = full_barriers(TS, PER_SYMBOL);
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring_smem);  // [DEPTH][kFull]
  uint64_t* const empty = full + DEPTH * kFull;                   // [DEPTH]
  float* const ring = reinterpret_cast<float*>(                   // [DEPTH][2][TS][A][128]
      ring_smem + ring_barrier_bytes(DEPTH, TS, PER_SYMBOL));
  const int stage = 2 * TS * A * kCols;  // floats per slot
  const int tiles = F / kCols;
  const int items = ((S + TS - 1) / TS) * tiles;
  const int grid = static_cast<int>(gridDim.x);
  const int mine = (items - 1 - static_cast<int>(blockIdx.x)) / grid + 1;

  // The it-th item of this block: window start (clamped) and column tile.
  auto window = [&](int it, int& st, int& c) {
    const int item = static_cast<int>(blockIdx.x) + it * grid;
    st = min((item / tiles) * TS, S - TS);
    c = item % tiles;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < DEPTH * kFull; ++i) mbar_init(full + i, 1);
    for (int i = 0; i < DEPTH; ++i) mbar_init(empty + i, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the block's only barrier over all its threads

  if (threadIdx.x >= kThreads) {
    // Producer: one elected lane refills a stage once its consumers have
    // released it, one TMA copy a plane (a plane and symbol in the "s"
    // form), each after the arrival that arms its full barrier.
    if (threadIdx.x != kThreads) return;
    const unsigned sym_bytes = 2u * A * kCols * sizeof(float);
    for (int it = 0; it < mine; ++it) {
      const int s = it % DEPTH;
      mbar_wait(empty + s, ((it / DEPTH) & 1) ^ 1);
      int st, c;
      window(it, st, c);
      float* const slot = ring + s * stage;
      for (int b = 0; b < kFull; ++b) {
        uint64_t* const bar = full + s * kFull + b;
        mbar_arrive_expect_tx(bar, (TS / kFull) * sym_bytes);
        tensor_copy(slot + b * A * kCols, &map_re, c * kCols, 0, st + b, bar);
        tensor_copy(slot + (TS + b) * A * kCols, &map_im, c * kCols, 0, st + b, bar);
      }
    }
    // Every copy issued here completes on a full barrier that the consumers
    // wait on before they exit, so none is in flight when the block ends.
    return;
  }

  // Consumers: thread (plane p, column j) of the 256.
  const int p = threadIdx.x / kCols;
  const int j = threadIdx.x % kCols;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(ring + DEPTH * stage);
  float* buf = reinterpret_cast<float*>(w_s + kCols * kCols);
  float* extra = buf + 4 * kCols;  // [TS][128]
  if (n > 0) load_w(w_s, w);       // visible after burn_rows' first barrier

  for (int it = 0; it < mine; ++it) {
    const int s = it % DEPTH;
    const unsigned parity = (it / DEPTH) & 1;
    int st, c;
    window(it, st, c);
    const float* slot = ring + s * stage;
    const int col = c * kCols + j;
    const float b = bias[col];
    float sum[TS];
    if (!PER_SYMBOL) mbar_wait(full + s, parity);
#pragma unroll
    for (int k = 0; k < TS; ++k) {
      if (PER_SYMBOL) mbar_wait(full + s * kFull + k, parity);  // symbol k has landed
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
      burn_rows(slot, TS * A, A, n, w_s, buf, extra);  // the re plane's rows
#pragma unroll
      for (int k = 0; k < TS; ++k) {
        if (p == 0) sum[k] += extra[k * kCols + j] * kBurnScale;
      }
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);  // this warp is done with the slot
    float* out = p == 0 ? out_re : out_im;
#pragma unroll
    for (int k = 0; k < TS; ++k) out[static_cast<long long>(st + k) * F + col] = sum[k];
  }
}

template <int DEPTH, int TS, bool PER_SYMBOL>
cudaError_t launch_manual(const float* y_re, const float* y_im, int S, int A, int F,
                          const float* bias, const float* w, int n, float* out_re,
                          float* out_im, cudaStream_t stream) {
  auto kernel = io_manual_kernel<DEPTH, TS, PER_SYMBOL>;
  const size_t smem = ring_barrier_bytes(DEPTH, TS, PER_SYMBOL) +
                      manual_ring_bytes(DEPTH, TS, A) + (n > 0 ? burn_smem_bytes(TS) : 0);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int box_s = full_barriers(TS, PER_SYMBOL) == 1 ? TS : 1;
  CUtensorMap map_re, map_im;
  err = plane_map(&map_re, y_re, S, A, F, box_s);
  if (err != cudaSuccess) return err;
  err = plane_map(&map_im, y_im, S, A, F, box_s);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int items = ((S + TS - 1) / TS) * (F / kCols);
  const int grid = items < sms ? items : sms;  // one persistent block per SM
  kernel<<<grid, kManualThreads, smem, stream>>>(map_re, map_im, S, A, F, bias, w, n, out_re,
                                                 out_im);
  return cudaGetLastError();
}

template <int DEPTH, bool PER_SYMBOL>
cudaError_t dispatch_ts(int ts, const float* y_re, const float* y_im, int S, int A,
                        int F, const float* bias, const float* w, int n, float* out_re,
                        float* out_im, cudaStream_t stream) {
  switch (ts) {
    case 1:
      return launch_manual<DEPTH, 1, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n, out_re,
                                                 out_im, stream);
    case 2:
      return launch_manual<DEPTH, 2, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n, out_re,
                                                 out_im, stream);
    case 4:
      return launch_manual<DEPTH, 4, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n, out_re,
                                                 out_im, stream);
    case 8:
      return launch_manual<DEPTH, 8, PER_SYMBOL>(y_re, y_im, S, A, F, bias, w, n, out_re,
                                                 out_im, stream);
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
// "s" form.  The grid is one persistent block per SM.  The barriers, the
// ring (depth * ts * A KB) and, with compute > 0, the burn scratch must fit
// the 227 KB a block may use.
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
