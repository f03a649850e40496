// The bf16 speed mode (exact=False): the pilot LS estimate and the data
// path (FFT + MRC + equalize + reference-order store) with the four-step
// transform's stage 2 on Hopper's warpgroup tensor-core product (wgmma) in
// bf16, float32 accumulation.
//
// Replaces the exact=False branches of ofdm_ls_mrc_tpu/ops/pallas_pipeline.py:
//   pilot_ls_bf16 <- _pilot_kernel (:222, wrapper estimate_pilot_fused :264):
//     _stage2_dots(..., exact=False) (:205-210), the hi x hi product alone;
//   fft_mrc_bf16  <- _kernel (:320, wrapper fused_pipeline :753) under its
//     default schedule g2: stage2_group (:554-590) with exact=False, one bf16
//     dot against [Wr | Wi] and no lo correction; with its XLA epilogue
//     to_reference_order (:682) in the store.
//
// What it computes (ops/fft_plan.py speed plan, ops/pipeline.py speed_dft):
// a row of F = n1 x 128 samples, x[i1, i2] = x[128 i1 + i2], goes through
//   1. the n1-point DFT over i1 in float32 (fft_warp.cuh's register DFT),
//      times the twiddle exp(-2 pi i k1 i2 / F) in float32 (the wrapper
//      folds 1/32767 into it for int16 rows, as the TPU kernel does): B;
//   2. B's planes rounded to bf16, nearest even;
//   3. C = B W with W = [cos | sin](-2 pi j k / 128) in bf16, four wgmma
//      m64n64k16 products with float32 accumulation: bin n1 k2 + k1 =
//      C[k1, k2];
//   4. in float32, as the exact kernels: the pilot's h = C conj(X) / |X|^2
//      and 1/sum_a |h|^2; the data path's sum_a C_a conj(h_a) times inv,
//      the DC bin dropped and the output ifftshift applied in the store.
//
// Bound on this card (one frame, 16 x 1024 x 100 data symbols): bytes, 13.1
// MB of f32 rows in and 0.82 MB out, 4.20 us at 3.35 TB/s (an sc16 frame
// 6.6 MB, 2.0 us).  Stage 2 is 1.68 GFLOP of bf16 products, 1.70 us at the
// 989 TFLOP/s dense bf16 rate (16.8 MFLOP, 2.2 us of one SM, a symbol);
// stage 1, the twiddle and the MRC about 48 MFLOP of float32, 0.7 us at 67
// TFLOP/s.  The earlier design (mma.sync, one block a symbol) lost its time
// to (a) a symbol's chunks run in series in one block, (b) every warp
// re-reading each tile and W's fragments by ldmatrix (786 KB of
// shared-memory traffic a 64-row chunk), (c) stage 1 and stage 2 taking
// turns behind block barriers and (d) h read through L1 by scalar loads.
//
// The design.  A "chunk" is 32 complex rows r = a n1 + k1 of a symbol (32 /
// n1 antennas): one m64 bf16 tile, complex row q = r % 32 in tile row
// 16 (q / 8) + q % 8 (real part) and 8 rows below (imaginary part), K =
// i2 = 128, 128-byte-swizzled K-major (wgmma.cuh).  The B operand is W in
// four quarters (rows 64 Q .. 64 Q + 63: Wr's rows 32 Q .. 32 Q + 31, then
// Wi's; W is symmetric, so row n is column n), 64 KB, copied once a block.
// A data block is three warpgroups, one block an SM (168 registers a
// thread); a pilot block two (one chunk a block at the main shape; 255
// registers, so its fold loads X ahead of each quarter's wait):
//   - warpgroup 0 (b): stage 2 as four wgmma.m64n64k16 products a chunk,
//     both operands through descriptors (the tensor cores read the 16 KB
//     tile and W once a warpgroup: 80 KB a chunk against 786 KB for 64
//     rows before), two quarters in flight (commit_group / wait_group 1),
//     so each quarter's fold runs while the next multiplies.  Thread
//     (w, g, t4) holds Br Wr, Bi Wr, Br Wi and Bi Wi of complex row
//     8 w + g at k2 = 32 Q + 8 j + 2 t4 + c: C needs no exchange between
//     lanes and the antenna sums stay in its registers;
//   - warpgroups 1 and 2 (c; the pilot: 1): stage 1 on alternate chunks,
//     beside stage 2, on a ring of two tiles with "full" and "empty"
//     mbarriers in place of block barriers.  Each owns a row stage: it reads
//     chunk i's rows there, then copies chunk i + 2's (16-byte cp.async
//     where every row starts 16-byte aligned, e.g. cp 72 in f32 or int16;
//     4-byte cp.async or element copies otherwise; rows past A never read,
//     completion by cp.async.mbarrier.arrive) while it transforms chunk i
//     in registers: the n1-point DFT, the twiddle (by recurrence from the
//     table's k1 = 1 entry) and the bf16 pack.  The pilot loads its rows
//     into registers;
//   - (d) the data path's h: warpgroup 0's elected thread copies a chunk's
//     h rows (its antennas, both planes) by two TMA bulk copies (16-byte
//     aligned) into one of two h stages, one chunk ahead: h is read once a
//     symbol a block, 16 bytes at a time, A F 8 bytes a symbol from L2
//     (12.8 MB for a 16 x 1024 x 100 frame, the same bytes as before).
// (a) A symbol's chunks spread over a thread block cluster of CL blocks
// (rank r takes chunks r, r + CL, ...; up to 2 for the data path, 8 for the
// pilot) when the symbols leave SMs idle: a streaming symbol, a pilot (one
// 16 x 1024 pilot is a cluster of 4).  Each block writes its sums by bin in
// natural order into a free stage (the last chunk's h stage, or the pilot's
// h staging), and after a cluster barrier rank r adds the CL blocks' values
// of bins [r F / CL, (r + 1) F / CL) through distributed shared memory and
// stores them (data: times inv, reference order; pilot: 1 / sum).  The
// barrier is split (arrive, wait later), so stage 1 runs on into the next
// symbol while warpgroup 0 reduces.  With many symbols (a frame, a
// capture) CL is 1: a block takes whole symbols.
//
// Shared memory (ops/fft_plan.py speed_smem_bytes): data 230,480 B (W, two
// tiles, two row stages, two h stages, barriers); pilot 145,488 B at F =
// 1024, 182,352 B at 4096 (W, two tiles, h staging, X and 1/|X|^2).
//
// F = 8192 to 32768 (n1 = 64 to 256): stage 1 is the split form's column
// pass (fft_split.cuh) and stage 2 a row pass of 32 bins k1 (near the end of
// this file).  The data path is one persistent launch,
// fft_mrc_bf16_ring_kernel, on the exact kernels' ring of L2-resident symbol
// slots (fft_split.cuh ring_loop): column tiles and bf16 row tiles, a
// loading and a multiplying warpgroup a block, W's image resident, two
// blocks an SM (105,512 B at 32768).  The pilot runs the column pass into a
// scratch and pilot_rows_kernel, its antennas spread over a cluster that
// takes W by one TMA multicast, two warpgroups a block (201,744 B: a tile
// and a row stage each, X).
//
// What it leaves for later: below F = 8192 W is copied by every block, not
// multicast to the cluster by TMA; rows by cp.async, not TMA tensor copies; warpgroup 0
// alone folds every chunk, and with two stage-1 warpgroups it is the
// slower role (its fold, not the product, sets the pace); the pilot's
// chain (W copy, one chunk, cluster reduce) is latency-bound.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its encoder's types; no libcuda link
#include <cuda_bf16.h>

#include <cstdint>

#include "dft_mma.cuh"
#include "fft_split.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

#ifdef OFDM_SPEED_TRACE
__device__ unsigned long long g_trace[512][32];
#define TRACE(slot)                                                              \
  do {                                                                           \
    unsigned long long ns_;                                                      \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns_));                      \
    if (blockIdx.x < 512 && (threadIdx.x & 127) == 0) g_trace[blockIdx.x][slot] = ns_; \
  } while (0)
// tools/speed_trace.py builds this file alone with OFDM_SPEED_TRACE: each
// block's first thread of each warpgroup stamps %globaltimer at the points
// TRACE names (its first 512 blocks).
extern "C" int ofdm_speed_trace(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));
}
extern "C" int ofdm_speed_trace_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_trace);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_trace));
  return static_cast<int>(err);
}
#else
#define TRACE(slot) \
  do {              \
  } while (0)
#endif

namespace ofdm {
namespace speed {

constexpr int kN2 = 128;           // stage-2 length (the contraction K)
constexpr int kChunkRows = 32;     // complex rows of a chunk: one m64 tile
constexpr int kTileRows = 64;      // bf16 rows of the tile (re over im per 8)
constexpr int kWRows = 256;        // B operand rows: four quarters of [Wr; Wi]
constexpr int kQuarters = 4;       // stage 2 in four products of 32 bins k2
constexpr int kStages = 2;         // the ring of chunk tiles, and of the data path's h
// Warpgroup 0: product + epilogue; the rest stage 1: two warpgroups for
// the data path, one for the pilot (one chunk a block at the main shape,
// so it gains nothing from a second and keeps 255 registers a thread).
template <bool kPilot>
constexpr int kThreads = kPilot ? 256 : 384;
constexpr int kDataCluster = 2;    // blocks a data symbol is spread over (at most)
constexpr int kPilotCluster = 8;   // blocks a pilot is spread over (at most)
constexpr int kTileBytes = kTileRows * kN2 * 2;         // 16,384
constexpr int kWBytes = kWRows * kN2 * 2;               // 65,536
constexpr int kRowBytes = 2 * kChunkRows * kN2 * 4;     // 32,768: a chunk's rows, or its h
constexpr int kHstStride = kN2 + 4;                     // floats a row of the pilot's h staging
constexpr int kHstBytes = 2 * kChunkRows * kHstStride * 4;  // 33,792
constexpr int kAlign = 1024;                            // the swizzle atom

// Byte offsets in the (1024-aligned) shared memory of a block.  The data
// path: W, two tiles, two row stages (one a stage-1 warpgroup), two h
// stages (the last chunk's also takes the symbol's sums in natural order);
// the pilot: W, two tiles, the chunk's h in tile order (then the sums), X
// and 1/|X|^2.
template <int F, bool kPilot>
struct Smem {
  static constexpr int kW = 0;
  static constexpr int kTiles = kWBytes;
  static constexpr int kRows = kTiles + kStages * kTileBytes;   // data
  static constexpr int kH = kRows + kStages * kRowBytes;        // data
  static constexpr int kHst = kRows;                            // pilot
  static constexpr int kX = kHst + kHstBytes;                   // pilot
  static constexpr int kBar = kPilot ? kX + 12 * F : kH + kStages * kRowBytes;
  static constexpr int kBars = 5 * kStages;  // full, empty, rows_in, h_in (data), spare
  static constexpr int kBytes = kBar + kBars * 8 + kAlign;      // + alignment slack
};

struct Params {
  const void* y_re;        // rows (f32 or int16): data y[k, s, a], pilot p[k, a]
  const void* y_im;
  long long stride_k, stride_s, stride_a;
  int K, S, A;             // the pilot: S = 1
  const float* h_re;       // data: estimate [K, A, F]
  const float* h_im;
  const float* inv;        // data: [K, F]
  const float* x_re;       // pilot: [F] padded pilot, natural order
  const float* x_im;
  const float2* tw;        // [n1, 128] stage-1 twiddles
  const uint4* w;          // [128, 256] bf16 [Wr | Wi]
  float* out_re;           // data: [K, S, F-1]; pilot: h [K, A, F]
  float* out_im;
  float* inv_out;          // pilot: [K, F]
  int align;               // bytes (16, 4 or 2) every row start is aligned to
};

// -- barriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// An arrival once every cp.async this thread issued before has landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
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
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completed on `bar` as transaction bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Generic-proxy shared-memory writes made visible to the tensor cores.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
// Warpgroup 0 alone; warpgroup 1 + s alone.
__device__ __forceinline__ void wg0_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }
__device__ __forceinline__ void wg_sync(int s) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + s) : "memory");
}

// -- stage 1 -------------------------------------------------------------------

// Tile row of the real part of complex row q of a chunk (the imaginary part
// is 8 rows below).
__host__ __device__ constexpr int tile_row(int q) { return 16 * (q >> 3) + (q & 7); }

// A row sample, streamed past L1 (the twiddles stay there).
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const int16_t* p) {
  short v;
  asm volatile("ld.global.nc.L1::no_allocate.s16 %0, [%1];" : "=h"(v) : "l"(p));
  return static_cast<float>(v);
}

// The pilot's rows of one chunk (antennas a0 .. a0 + 32 / n1 - 1) into
// registers, thread i2's column; a row past A reads antenna 0 (and
// write_chunk writes zeros for it).
template <int N1, typename T>
__device__ __forceinline__ void load_chunk(float2 (&v)[kChunkRows / N1][N1],
                                           const T* __restrict__ y_re,
                                           const T* __restrict__ y_im, long long base,
                                           long long stride_a, int a0, int A, int i2) {
#pragma unroll
  for (int q = 0; q < kChunkRows / N1; ++q) {
    const int a = a0 + q;
    const long long off = base + static_cast<long long>(a < A ? a : 0) * stride_a + i2;
#pragma unroll
    for (int i1 = 0; i1 < N1; ++i1) {
      v[q][i1] = make_float2(ld_stream(y_re + off + i1 * kN2), ld_stream(y_im + off + i1 * kN2));
    }
  }
}

// The data path's row ring: a chunk's rows as [antenna q][plane][i1][i2]
// elements of T.  copy_chunk issues (and does not wait for) the copies of
// rows below A, by the 128 threads of a stage-1 warpgroup: 16-byte
// cp.async pieces when every row starts 16-byte aligned (any cyclic prefix
// whose bytes are a multiple of 16, e.g. 72), else one 4-byte cp.async a
// column (f32) or a 2-byte load and store a column (int16).  read_chunk
// takes thread i2's column.
template <int N1, typename T>
__device__ __forceinline__ void copy_chunk(T* raw, const T* __restrict__ y_re,
                                           const T* __restrict__ y_im, long long base,
                                           long long stride_a, int a0, int A, int i2,
                                           int align) {
  constexpr int kSegs = 2 * kChunkRows;               // (q, plane, i1) segments of 128 samples
  constexpr int kPieces = kN2 * sizeof(T) / 16;       // 16-byte pieces of a segment
  auto seg_src = [&](int sg) {
    const int q = sg / (2 * N1), plane = (sg / N1) % 2, i1 = sg % N1;
    return (plane ? y_im : y_re) + base + static_cast<long long>(a0 + q) * stride_a + i1 * kN2;
  };
  if (align >= 16) {
#pragma unroll 4
    for (int i = i2; i < kSegs * kPieces; i += 128) {
      const int sg = i / kPieces, pc = i % kPieces;
      if (a0 + sg / (2 * N1) < A) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     ::"r"(smem_u32(raw + sg * kN2 + pc * (16 / sizeof(T)))),
                     "l"(seg_src(sg) + pc * (16 / sizeof(T)))
                     : "memory");
      }
    }
    return;
  }
#pragma unroll 4
  for (int sg = 0; sg < kSegs; ++sg) {
    if (a0 + sg / (2 * N1) >= A) continue;
    const T* src = seg_src(sg);
    T* dst = raw + sg * kN2;
    if constexpr (sizeof(T) == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst + i2)),
                   "l"(src + i2)
                   : "memory");
    } else {
      dst[i2] = src[i2];
    }
  }
}

template <int N1, typename T>
__device__ __forceinline__ void read_chunk(float2 (&v)[kChunkRows / N1][N1], const T* raw,
                                           int i2) {
#pragma unroll
  for (int q = 0; q < kChunkRows / N1; ++q) {
#pragma unroll
    for (int i1 = 0; i1 < N1; ++i1) {
      v[q][i1] = make_float2(static_cast<float>(raw[((2 * q) * N1 + i1) * kN2 + i2]),
                             static_cast<float>(raw[((2 * q + 1) * N1 + i1) * kN2 + i2]));
    }
  }
}

// DFT over i1, twiddle, bf16 pairs into the tile (rows past A as zeros).
// The twiddles of the thread's column come from the table's k1 = 1 entry,
// w^k1 by products in float32 (a few ulp from the table at k1 = 31; the
// sc16 scale rides in the k1 = 0 entry), so stage 1 waits on no load for
// them.
template <int N1>
__device__ __forceinline__ void write_chunk(float2 (&v)[kChunkRows / N1][N1], int a0, int A,
                                            const float2 (&tw)[2], unsigned char* tile, int i2) {
#pragma unroll
  for (int q = 0; q < kChunkRows / N1; ++q) {
    const bool live = a0 + q < A;
    if (live) wfft::dft<N1, N1>(v[q], 0);
    float2 wk = tw[0];
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
      const float2 b = live ? cmul(v[q][k1], wk) : make_float2(0.0f, 0.0f);
      wk = cmul(wk, tw[1]);
      const int m = tile_row(q * N1 + k1);
      *reinterpret_cast<__nv_bfloat16*>(tile + wg::sw128_offset(kTileRows, m, i2)) =
          __float2bfloat16_rn(b.x);
      *reinterpret_cast<__nv_bfloat16*>(tile + wg::sw128_offset(kTileRows, m + 8, i2)) =
          __float2bfloat16_rn(b.y);
    }
  }
}

// -- stage 2 -------------------------------------------------------------------

// W ([128][256] bf16 [Wr | Wi], global) -> the B operand: quarter Q (rows
// 64 Q .. 64 Q + 63) is Wr's rows 32 Q .. 32 Q + 31, then Wi's (W is
// symmetric, so row n is column n), by cp.async in 16-byte pieces, by
// warpgroup 0.
__host__ __device__ constexpr int w_row(int n) {  // operand row n -> 2 (W row) + (Wi?)
  return 2 * (32 * (n >> 6) + (n & 31)) + ((n >> 5) & 1);
}
__device__ __forceinline__ void load_w(unsigned char* w_s, const uint4* __restrict__ w, int t) {
  for (int i = t; i < kWRows * 16; i += 128) {
    const int n = i >> 4, pc = i & 15, src_row = w_row(n);
    const uint4* src = w + (src_row >> 1) * 32 + (src_row & 1) * 16 + pc;
    const unsigned dst = smem_u32(w_s + wg::sw128_offset(kWRows, n, 8 * pc));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  }
}

// Quarter Q of stage 2 (k2 = 32 Q .. 32 Q + 31): d = tile [64][128] x B
// rows 64 Q .. 64 Q + 63, issued and committed, not waited for.
__device__ __forceinline__ void issue_quarter(float (&d)[32], unsigned tile, unsigned w_s,
                                              int Q) {
  wg::fence_operands(d);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < kN2 / 16; ++kk) {
    const unsigned ka = (kk >> 2) * kTileRows * 128 + (kk & 3) * 32;
    const unsigned kb = (kk >> 2) * kWRows * 128 + Q * 64 * 128 + (kk & 3) * 32;
    wg::mma_m64n64k16(d, wg::sw128_desc(tile + ka), wg::sw128_desc(w_s + kb), kk > 0);
  }
  wg::commit();
}

// -- the cluster's phases --------------------------------------------------------

// The cluster barrier's phases alternate "sums written" and "sums read".  A
// stage-1 warpgroup arrives for a symbol's first phase once it has no more
// chunks of it and completes the pair after its first chunk of the next
// symbol (or at once, if it has none), so it runs ahead while warpgroup 0
// reduces.
struct Phases {
  bool pend = false, fpend = false;
  __device__ __forceinline__ void settle() {
    if (pend) {
      cluster_wait();
      cluster_arrive();
      pend = false;
      fpend = true;
    }
  }
  __device__ __forceinline__ void end_symbol() {
    settle();
    if (fpend) {
      cluster_wait();
      fpend = false;
    }
    cluster_arrive();
    pend = true;
  }
  __device__ __forceinline__ void finish() {
    if (pend) {
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
  }
};

template <int N1, typename T, bool kPilot>
__device__ __forceinline__ void speed_body(const Params& p) {
  constexpr int F = N1 * kN2;
  constexpr int kAnts = kChunkRows / N1;
  constexpr int kMaxCl = kPilot ? kPilotCluster : kDataCluster;
  constexpr int kNatPad = F < 4096 ? 32 : 0;  // natural-order sums: bin + bin / 32
  using L = Smem<F, kPilot>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::kBar);  // tiles written
  uint64_t* const empty = full + kStages;                              // tiles read
  uint64_t* const rows_in = empty + kStages;                           // row copies landed
  uint64_t* const h_in = rows_in + kStages;                            // h copies landed
  int* const nat_stage = reinterpret_cast<int*>(h_in + kStages);       // data: where the sums are
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x) / CL;
  const int ncl = static_cast<int>(gridDim.x) / CL;
  const int nc = (p.A * N1 + kChunkRows - 1) / kChunkRows;  // chunks of a symbol
  const int mc = (nc - rank + CL - 1) / CL;                 // ... this block takes (CL <= nc)
  const long long items = static_cast<long long>(p.K) * p.S;
  const long long total = cid < items ? (items - 1 - cid) / ncl + 1 : 0;
  const long long chunks = total * mc;                      // the block's chunks
  // Chunk i of the block: symbol cid + (i / mc) ncl, chunk rank + (i % mc) CL.
  auto where = [&](long long i, int& k, long long& base, int& a0) {
    const long long item = cid + (i / mc) * ncl;
    k = static_cast<int>(item / p.S);
    base = k * p.stride_k + (item % p.S) * p.stride_s;
    a0 = (rank + static_cast<int>(i % mc) * CL) * kAnts;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, 128);
      mbar_init(rows_in + s, 128);
      mbar_init(h_in + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- warpgroups 1 and 2: stage 1 ---------------------------------------
    // Warpgroup 1 + s takes the chunks i = s mod 2 and owns tile stage s
    // and (data path) row stage s: it copies chunk i + 2's rows there as
    // soon as it has read chunk i's, so the copy runs while chunk i is
    // transformed and the other warpgroup's chunk is multiplied.
    constexpr int kProducers = kThreads<kPilot> / 128 - 1;
    const int s = (threadIdx.x >> 7) - 1;
    const int i2 = threadIdx.x & 127;
    TRACE(26);
    const T* const yr = static_cast<const T*>(p.y_re);
    const T* const yi = static_cast<const T*>(p.y_im);
    // Column i2's twiddle at k1 = 0 (1, or the sc16 scale) and the step
    // exp(-2 pi i i2 / F) (the k1 = 1 entry over the k1 = 0 one).
    float2 tw[2];
    tw[0] = __ldg(p.tw + i2);
    {
      const float2 t1 = __ldg(p.tw + kN2 + i2);
      const float s0 = 1.0f / tw[0].x;  // the k1 = 0 entry is real
      tw[1] = make_float2(t1.x * s0, t1.y * s0);
    }
    T* const raw = reinterpret_cast<T*>(smem + L::kRows + s * kRowBytes);
    auto copy_rows = [&](long long i) {
      int k, a0;
      long long base;
      where(i, k, base, a0);
      copy_chunk<N1, T>(raw, yr, yi, base, p.stride_a, a0, p.A, i2, p.align);
      if (sizeof(T) == 2 && p.align < 16) {
        mbar_arrive(rows_in + s);  // the int16 element copies were plain stores
      } else {
        mbar_arrive_on_copies(rows_in + s);
      }
    };
    if constexpr (!kPilot) {
      if (s < chunks) copy_rows(s);
    }
    Phases ph;
    for (long long item = cid, i0 = 0; item < items; item += ncl, i0 += mc) {
      for (long long i = i0 + ((i0 % kProducers) != s); i < i0 + mc; i += kProducers) {
        int k, a0;
        long long base;
        where(i, k, base, a0);
        float2 v[kAnts][N1];
        if constexpr (kPilot) {
          load_chunk<N1, T>(v, yr, yi, base, p.stride_a, a0, p.A, i2);
        } else {
          mbar_wait(rows_in + s, static_cast<unsigned>((i >> 1) & 1));
          read_chunk<N1, T>(v, raw, i2);
          if (i + 2 < chunks) {
            wg_sync(s);  // the warpgroup's reads of the stage are done
            copy_rows(i + 2);
          }
        }
        if (i < 4) TRACE(18 + 2 * static_cast<int>(i));
        const int st = static_cast<int>(i & 1);  // the tile stage (data: s)
        mbar_wait(empty + st, static_cast<unsigned>((i >> 1) & 1) ^ 1u);
        write_chunk<N1>(v, a0, p.A, tw, smem + L::kTiles + st * kTileBytes, i2);
        fence_proxy_async();
        mbar_arrive(full + st);
        if (i < 4) TRACE(19 + 2 * static_cast<int>(i));
        ph.settle();
      }
      ph.end_symbol();
    }
    ph.finish();
    TRACE(27);
    return;
  }

  // ---- warpgroup 0: stage 2 and the epilogue ---------------------------------
  const int t = threadIdx.x;
  TRACE(0);
  // Data: chunk i's h rows (its antennas, both planes) into h stage i % 2 by
  // two TMA bulk copies (16-byte aligned), from the elected thread.
  auto copy_h = [&](long long i) {
    if constexpr (!kPilot) {
      if (t == 0 && i < chunks) {
        int k, a0;
        long long base;
        where(i, k, base, a0);
        const int hs = static_cast<int>(i & 1);
        const unsigned bytes = static_cast<unsigned>(min(kAnts, p.A - a0)) * F * 4;
        float* dst = reinterpret_cast<float*>(smem + L::kH + hs * kRowBytes);
        const long long row = (static_cast<long long>(k) * p.A + a0) * F;
        mbar_arrive_expect_tx(h_in + hs, 2 * bytes);
        bulk_copy(dst, p.h_re + row, bytes, h_in + hs);
        bulk_copy(dst + kChunkRows * kN2, p.h_im + row, bytes, h_in + hs);
      }
    }
  };
  copy_h(0);
  copy_h(1);
  const unsigned w_s = smem_u32(smem + L::kW);
  load_w(smem + L::kW, p.w, t);
  if constexpr (kPilot) {
    float* xs = reinterpret_cast<float*>(smem + L::kX);
    for (int i = t; i < F / 2; i += 128) {
      const int plane = i / (F / 4), off = (i % (F / 4)) * 4;
      wfft::cp_async16(xs + plane * F + off, (plane ? p.x_im : p.x_re) + off);
    }
  }
  wfft::cp_async_commit();
  wfft::cp_async_wait<0>();
  fence_proxy_async();
  wg0_sync();
  if constexpr (kPilot) {  // 1/|X|^2 once a block, as the plain version's cdiv rounds it
    float* xs = reinterpret_cast<float*>(smem + L::kX);
    for (int i = t; i < F; i += 128) xs[2 * F + i] = 1.0f / (xs[i] * xs[i] + xs[F + i] * xs[F + i]);
    wg0_sync();
  }
  TRACE(1);

  const int q = 8 * (t >> 5) + ((t & 31) >> 2);  // the thread's complex row of a chunk
  const int t4 = t & 3;
  const int k1 = q % N1;
  const int al = q / N1;
  const float* __restrict__ const xs_re = reinterpret_cast<const float*>(smem + L::kX);
  const float* __restrict__ const xs_im = xs_re + F;
  const float* __restrict__ const xs_den = xs_re + 2 * F;
  float* __restrict__ const hst_re = reinterpret_cast<float*>(smem + L::kHst);  // pilot
  float* __restrict__ const hst_im = hst_re + kChunkRows * kHstStride;
  float da[32], db[32];
  int it = 0;
  for (long long item = cid; item < items; item += ncl) {
    const int k = static_cast<int>(item / p.S);
    // Row q's running sums for k2 = 32 Q + 8 j + 2 t4 + cc at [8 Q + 2 j + cc].
    float sums[32][2];
#pragma unroll
    for (int i = 0; i < 32; ++i) sums[i][0] = sums[i][1] = 0.0f;
    int hs = 0;  // the h stage of the symbol's last chunk
    for (int c = rank; c < nc; c += CL, ++it) {
      const int st = it & 1;
      hs = st;
      mbar_wait(full + st, (it >> 1) & 1);
      if (it < 4) TRACE(2 + 3 * it);
      const unsigned tile = smem_u32(smem + L::kTiles + st * kTileBytes);
      const int a = c * kAnts + al;
      const bool live = a < p.A;
      const float* __restrict__ hs_re = reinterpret_cast<const float*>(smem + L::kH + st * kRowBytes);
      const float* __restrict__ hs_im = hs_re + kChunkRows * kN2;
      // Quarters 0 and 1 in flight; each fold is followed by the issue of
      // the quarter two on, so the tensor cores run while the lanes fold.
      issue_quarter(da, tile, w_s, 0);
      issue_quarter(db, tile, w_s, 1);
      if constexpr (!kPilot) mbar_wait(h_in + st, (it >> 1) & 1);
#pragma unroll
      for (int Q = 0; Q < kQuarters; ++Q) {
        // Pilot: X and 1/|X|^2 at the thread's 8 bins of the quarter, loaded
        // before its product is waited for (the data path's registers
        // have no room for its h).
        float xq[kPilot ? 8 : 1][3];
        if constexpr (kPilot) {
#pragma unroll
          for (int jc = 0; jc < 8; ++jc) {
            const int bin = N1 * (32 * Q + 8 * (jc >> 1) + 2 * t4 + (jc & 1)) + k1;
            xq[jc][0] = xs_re[bin];
            xq[jc][1] = xs_im[bin];
            xq[jc][2] = xs_den[bin];
          }
        }
        if (Q < kQuarters - 1) {
          wg::wait<1>();
        } else {
          wg::wait<0>();
        }
        float(&d)[32] = (Q & 1) ? db : da;
        wg::fence_operands(d);
        if (Q == kQuarters - 1) {
          if (it < 4) TRACE(3 + 3 * it);
          mbar_arrive(empty + st);  // the tile is read
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float cre = d[4 * j + cc] - d[4 * (j + 4) + 2 + cc];  // Br Wr - Bi Wi
            const float cim = d[4 * (j + 4) + cc] + d[4 * j + 2 + cc];  // Br Wi + Bi Wr
            const int k2 = 32 * Q + 8 * j + 2 * t4 + cc;
            const int bin = N1 * k2 + k1;
            const int ix = 8 * Q + 2 * j + cc;
            if constexpr (kPilot) {
              const float xr = xq[2 * j + cc][0], xi = xq[2 * j + cc][1], den = xq[2 * j + cc][2];
              const float hr = (cre * xr + cim * xi) * den;
              const float hi = (cim * xr - cre * xi) * den;
              hst_re[q * kHstStride + k2] = hr;
              hst_im[q * kHstStride + k2] = hi;
              if (live) sums[ix][0] += hr * hr + hi * hi;
            } else if (live) {
              const float hr = hs_re[al * F + bin], hi = hs_im[al * F + bin];
              sums[ix][0] += cre * hr + cim * hi;
              sums[ix][1] += cim * hr - cre * hi;
            }
          }
        }
        if (Q + 2 < kQuarters) issue_quarter(d, tile, w_s, Q + 2);
      }
      if constexpr (kPilot) {
        wg0_sync();
        // The chunk's h rows in natural order, coalesced, 4 at a time.
        const int a0 = c * kAnts;
        for (int i0 = t; i0 < kAnts * F; i0 += 4 * 128) {
          float vr[4], vi[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * 128, ai = i / F, bin = i % F;
            const int at = (ai * N1 + bin % N1) * kHstStride + bin / N1;
            vr[u] = i < kAnts * F ? hst_re[at] : 0.0f;
            vi[u] = i < kAnts * F ? hst_im[at] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * 128, ai = i / F, bin = i % F;
            if (i < kAnts * F && a0 + ai < p.A) {
              const long long at = (static_cast<long long>(k) * p.A + a0 + ai) * F + bin;
              p.out_re[at] = vr[u];
              p.out_im[at] = vi[u];
            }
          }
        }
        wg0_sync();
      } else if (c + CL < nc) {
        wg0_sync();     // every lane has read h stage st
        copy_h(it + 2);
      }
      if (it < 4) TRACE(4 + 3 * it);
    }
    // The block's sums by bin, in natural order at bin + bin / 32 (F < 4096;
    // no bank conflicts as the cluster reads consecutive bins), through the
    // pilot's h staging or the data path's last h stage, free now: each row
    // q's sums to [q][k2], then thread t adds the rows q = a n1 + k1 of
    // k2 = t (antenna order) for every k1 and stores bins n1 t .. n1 t + n1 - 1.
    constexpr int kRowF = kPilot ? kHstStride : kN2;  // floats a row of the row buffer
    constexpr int kNatIm = kPilot ? 0 : F + (kNatPad ? F / 32 : 0);  // the im plane's offset
    float* const nat_re = kPilot ? hst_re : reinterpret_cast<float*>(smem + L::kH + hs * kRowBytes);
    float* const nat_im = nat_re + kNatIm;
    float* const row_im = nat_re + kChunkRows * kRowF;
    if (t == 0) *nat_stage = hs;  // a peer's h stages may alternate otherwise
    wg0_sync();  // the stage is read (pilot: copied out)
#pragma unroll
    for (int ix = 0; ix < 32; ix += 2) {
      const int k2 = 32 * (ix >> 3) + 8 * ((ix >> 1) & 3) + 2 * t4;
      *reinterpret_cast<float2*>(nat_re + q * kRowF + k2) = make_float2(sums[ix][0], sums[ix + 1][0]);
      if constexpr (!kPilot) {
        *reinterpret_cast<float2*>(row_im + q * kRowF + k2) =
            make_float2(sums[ix][1], sums[ix + 1][1]);
      }
    }
    wg0_sync();
    {
      float vr[N1], vi[N1];
#pragma unroll
      for (int r = 0; r < N1; ++r) {
        vr[r] = vi[r] = 0.0f;
#pragma unroll
        for (int ai = 0; ai < kAnts; ++ai) {
          vr[r] += nat_re[(ai * N1 + r) * kRowF + t];
          if constexpr (!kPilot) vi[r] += row_im[(ai * N1 + r) * kRowF + t];
        }
      }
      wg0_sync();
#pragma unroll
      for (int r = 0; r < N1; ++r) {
        const int bin = N1 * t + r;
        nat_re[bin + (kNatPad ? bin / 32 : 0)] = vr[r];
        if constexpr (!kPilot) nat_im[bin + (kNatPad ? bin / 32 : 0)] = vi[r];
      }
    }
    if (item == cid) TRACE(14);
    cluster_arrive();
    cluster_wait();
    if (item == cid) TRACE(15);
    // Rank r: bins [r F / CL, (r + 1) F / CL), each the sum over the
    // cluster's blocks in rank order; every rank's value loaded at once (a
    // rank past CL reads this block's own buffer and is not added).
    const int lo = rank * F / CL, hi = (rank + 1) * F / CL;
    constexpr int kU = kPilot ? 2 : 4;  // bins a thread reads at once
    for (int b0 = lo + t; b0 < hi; b0 += kU * 128) {
      float gain[kU];  // data: inv of the bins, in flight beside the cluster's loads
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        gain[u] = kPilot ? 1.0f
                         : __ldg(p.inv + static_cast<long long>(k) * F + min(b0 + u * 128, hi - 1));
      }
      float vr[kMaxCl][kU], vi[kMaxCl][kU];
#pragma unroll
      for (int r = 0; r < kMaxCl; ++r) {
        const int rr = r < CL ? r : rank;
        float* base = nat_re;
        if constexpr (!kPilot) {
          base = reinterpret_cast<float*>(smem + L::kH +
                                          *cluster.map_shared_rank(nat_stage, rr) * kRowBytes);
        }
        const float* pr = cluster.map_shared_rank(base, rr);
        const float* pi = pr + kNatIm;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int bin = min(b0 + u * 128, hi - 1);
          const int at = bin + (kNatPad ? bin / 32 : 0);
          vr[r][u] = pr[at];
          vi[r][u] = kPilot ? 0.0f : pi[at];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int bin = b0 + u * 128;
        if (bin >= hi) continue;
        float sr = 0.0f, si = 0.0f;
#pragma unroll
        for (int r = 0; r < kMaxCl; ++r) {
          if (r < CL) {
            sr += vr[r][u];
            si += vi[r][u];
          }
        }
        if constexpr (kPilot) {
          p.inv_out[static_cast<long long>(k) * F + bin] = 1.0f / sr;
        } else if (bin != 0) {  // the DC bin is dropped
          int jo = bin - F / 2;
          if (jo < 0) jo += F - 1;
          const long long orow = item * (F - 1);
          p.out_re[orow + jo] = sr * gain[u];
          p.out_im[orow + jo] = si * gain[u];
        }
      }
    }
    if (item == cid) TRACE(16);
    cluster_arrive();
    cluster_wait();  // the peers have read this block's sums: the stage is free
    if constexpr (!kPilot) copy_h(it + 1);  // the next chunk of this h stage
  }
  TRACE(17);
}

template <int N1, typename T>
__global__ void __launch_bounds__(kThreads<false>, 1) fft_mrc_bf16_kernel(const Params p) {
  speed_body<N1, T, false>(p);
}

template <int N1, typename T>
__global__ void __launch_bounds__(kThreads<true>, 1) pilot_ls_bf16_kernel(const Params p) {
  speed_body<N1, T, true>(p);
}

// -- F = 8192 to 32768: n1 = 64 to 256 ------------------------------------------
//
// A thread's column of n1 values no longer fits stage 1's registers (the
// chunk layout above gives each thread v[32 / n1][n1]: no antenna at all past
// n1 = 32).  Stage 1 is the split form's column pass (fft_split.cuh: the
// n1-point DFT in float32 and the twiddle, the sc16 scale folded into it, into
// B[a][k1][i2]), and stage 2 takes 32 bins k1 of one symbol (the pilot:
// frame), k1 = 32 g + q: for each antenna it rounds B's 32 rows (a chunk of
// 32 complex rows, r = a n1 + k1, as above) to bf16 into the tile and runs
// the same four wgmma quarters against W.  The data path
// (fft_mrc_bf16_ring_kernel, below) runs both on one persistent launch, the
// exact kernels' ring (fft_split.cuh ring_loop); the pilot runs the column
// pass into a scratch and then pilot_rows_kernel, its antennas spread over
// a cluster (below).
struct RowsParams {
  const float* b_re;       // the column pass's scratch [n, A, n1, 128]
  const float* b_im;
  long long item0;         // the chunk's first frame
  int A;
  const float* x_re;       // [F] padded pilot, natural order
  const float* x_im;
  const uint4* w;          // the operand's image (ops/fft_plan.py speed_w_image)
  float* out_re;           // h [K, A, F]
  float* out_im;
  float* inv_out;          // [K, F]
};

constexpr int kRowsK1 = kChunkRows;  // bins k1 of a pilot row-pass block, one chunk an antenna
constexpr int kRingK1 = kChunkRows / 2;  // bins k1 of a bf16 ring row tile: two antennas a chunk
constexpr int kRowsBytes = kWBytes + kTileBytes + kAlign;
constexpr int kWPiece = 4096;                       // bytes of one copy of W's image
constexpr int kNatStride = kChunkRows + 1;          // floats a bin k2 of the pilot's sums
constexpr int kXsStride = kChunkRows + 4;           // floats a bin k2 of the pilot's X staging
constexpr int kXsBytes = 2 * kN2 * kXsStride * 4;   // 36,864: X / |X|^2, two planes
// The pilot's row pass: two warpgroups; W, a tile each, the X staging, a row
// stage each (an antenna's 32 rows, f32), the barrier of W's multicast.
constexpr int kPilotRowsThreads = 256;
constexpr int kPilotRowsBytes = kRowsBytes + kTileBytes + kXsBytes + 2 * kRowBytes + 16;

// Stage 1's output for rows k1 = 32 g .. 32 g + 31 of one antenna (b points
// at row k1 = 32 g of antenna 0) into a row stage [plane][32][128] by
// 16-byte cp.async, issued by the 128 threads of a warpgroup (t), not
// waited for.
template <int N1>
__device__ __forceinline__ void stage_rows(float* stage, const float* __restrict__ b_re,
                                           const float* __restrict__ b_im, int a, int t) {
  const long long rows = static_cast<long long>(a) * N1 * kN2;
#pragma unroll
  for (int i = t; i < 2 * kChunkRows * kN2 / 4; i += 128) {
    const int plane = i / (kChunkRows * kN2 / 4), e = 4 * (i % (kChunkRows * kN2 / 4));
    wfft::cp_async16(stage + plane * kChunkRows * kN2 + e, (plane ? b_im : b_re) + rows + e);
  }
}

// A row stage's column t, rounded to bf16, into the tile.
__device__ __forceinline__ void write_stage(const float* stage, unsigned char* tile, int t) {
#pragma unroll
  for (int r = 0; r < kChunkRows; ++r) {
    const int m = tile_row(r);
    *reinterpret_cast<__nv_bfloat16*>(tile + wg::sw128_offset(kTileRows, m, t)) =
        __float2bfloat16_rn(stage[r * kN2 + t]);
    *reinterpret_cast<__nv_bfloat16*>(tile + wg::sw128_offset(kTileRows, m + 8, t)) =
        __float2bfloat16_rn(stage[(kChunkRows + r) * kN2 + t]);
  }
}

// -- the data path from F = 8192: one persistent launch on the ring ---------------
//
// fft_mrc_bf16_ring_kernel runs fft_split.cuh ring_loop with the exact
// kernels' column tiles (column_load + column_run into a symbol slot, the
// sc16 scale in the table's four-step twiddles), storing B rounded to bf16
// (the rounding stage 2 takes anyway: the ring holds half the bytes), and
// row tiles of kRingK1 = 16 bins k1 of one symbol over every antenna (n1 /
// 16 a symbol), the bf16 stage 2 in place of the exact row FFT.  A row
// tile's chunk of 32 complex rows is 16 rows k1 of two antennas (complex
// row q: antenna 2 b + q / 16, k1_0 + q % 16), so a tile runs A / 2
// products, and takes them in turn on a ring of two bf16 tiles handed over
// by "full" and "empty" mbarriers:
//   - thread 0 copies pair b + 1's rows into tile (b + 1) % 2 by TMA as
//     soon as the tile is free: the column tiles store a slot with its
//     planes interleaved by 8 rows (fft_split.cuh slot_row), so an
//     antenna's 16 rows k1 of both planes are one run of 32 rows in tile
//     order (re and im rows in alternate groups of 8), a box of 32 rows x
//     64 bf16 a K half, landing in the 128-byte-swizzled K-major layout
//     wgmma reads -- no thread loads or packs a row;
//   - warpgroup w runs quarters 2 w and 2 w + 1 of the pair's product
//     against W (wgmma.m64n64k16 x 8 each, one after the other) and folds
//     each quarter's C conj(h) of the thread's antenna into its 16 bins'
//     sums in registers, each quarter's h loaded one pair ahead of its fold;
//     after the last pair the two antenna halves' sums meet in shared
//     memory and the first half stores sum * inv in reference order, as the
//     exact ring does.
// (The first forms, 32 bins k1 and one antenna a product: a loading
// warpgroup beside a multiplying one left the multiplying one all four
// quarters in 128 registers, 312-352 B spilled, 3.5 us an antenna; both
// warpgroups loading a half of the next antenna's f32 rows into registers
// and packing them, ~3 us an antenna.  Their row tiles held a slot 45-60 us
// and stalled the ring's column tiles: 470-610 us at 8192 on an H100; PERF.md.)
// W stays in shared memory for the launch: one TMA copy of its image
// (ops/fft_plan.py speed_w_image, the operand byte for byte) as the block
// starts, behind the first tiles.  Shared memory (ops/fft_plan.py
// speed_ring_smem_bytes): the column tile's buffers overlaid on the two
// tiles, W, the pass twiddles, the barriers: two blocks an SM, as the exact
// ring.  The slot is handed on (done()) once the last pair's copy has
// landed.  A row tile takes the block's next ticket as it ends (ring_loop's
// kLateRowTicket): a ticket held idle behind a row tile stalled the
// symbol's column tiles and, behind them, its row tiles.  Built with
// -DOFDM_RING_TRACE, a row tile records thread 0's phase sums in entries 6
// .. 11 of its ticket (fft_split.cuh): the copies' issue, the wait for a
// free tile, the wait for a full tile, the products (issue to wait), the
// folds (with the next pair's h loads), and of the products the second
// quarter's.
template <int N1>
struct RingSmem {
  static constexpr int kColumn = static_cast<int>(split::column_smem_bytes<N1>());
  static constexpr int kW = ((kColumn > 2 * kTileBytes ? kColumn : 2 * kTileBytes) + kAlign - 1) /
                            kAlign * kAlign;
  static constexpr int kTw = kW + kWBytes;
  static constexpr int kBar = kTw + split::ring_twiddles<N1>() * 8;
  static constexpr int kBars = 5;  // full, empty (two each), W in
  static constexpr int kBytes = kBar + kBars * 8 + kAlign;  // + alignment slack
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor map of the bf16 ring [slots, A, n1 / 8, 2, 8, 128] (fft_split.cuh
// slot_row) as rows of 128 bf16, a box of 32 rows x 64 bf16 (128 bytes,
// the 128-byte swizzle): one K half of an antenna's 16 rows k1.  libcuda's
// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (nothing links against libcuda).
__host__ cudaError_t ring_map(CUtensorMap* map, void* ring, int slots, int A, int n1) {
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
  const cuuint64_t dims[2] = {kN2, 2ull * slots * A * n1};
  const cuuint64_t strides[1] = {kN2 * 2};
  const cuuint32_t box[2] = {64, 2 * kRingK1};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ring, dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The box of `map` at (column c0, row c1) into shared memory, completed on
// `bar` as transaction bytes.
__device__ __forceinline__ void box_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// One bf16 row tile on the block's 256 threads (bins k1 = k1_0 .. k1_0 + 15
// of item `item` in slot `slot`; tile stage (n0 + b) % 2 for pair b): thread
// 0 copies each pair's tile by TMA one ahead, warpgroup w multiplies and
// folds quarters 2 w, 2 w + 1, done() once every copy has landed, then eq =
// sum * inv in reference order (the DC bin dropped).
template <int N1, typename Done>
__device__ __forceinline__ void ring_rows(const split::RingArgs& p, const CUtensorMap* map,
                                          long long item, int k1_0, int n0, int slot,
                                          unsigned char* tiles, unsigned w_s, uint64_t* full,
                                          uint64_t* empty, uint64_t* w_in, uint64_t policy,
                                          long long t, Done done) {
  constexpr int F = N1 * kN2;
  constexpr int kRun = 2 * kRingK1;  // rows of an antenna's run: kRingK1 k1, both planes
  const int wgi = threadIdx.x >> 7, u = threadIdx.x & 127;
  const int q = 8 * (u >> 5) + ((u & 31) >> 2);  // the thread's complex row of the tile
  const int par = q / kRingK1;                    // its antenna of the pair
  const int t4 = u & 3;
  const int k1 = k1_0 + q % kRingK1;
  const int k = static_cast<int>(item / p.S);
  const int pairs = (p.A + 1) / 2;
  // Row of antenna 0's run (re and im of k1_0 .. k1_0 + 15).
  const int row0 = static_cast<int>(static_cast<long long>(slot) * p.A * 2 * N1 + 2 * k1_0);
  float sums[16][2];
#pragma unroll
  for (int i = 0; i < 16; ++i) sums[i][0] = sums[i][1] = 0.0f;
  unsigned long long ns_issue = 0, ns_empty = 0, ns_full = 0, ns_product = 0, ns_fold = 0,
                     ns_second = 0;
  // Thread 0: pair b's runs into tile stage (n0 + b) % 2 once the tile is
  // free, a copy an antenna and K half (antenna 2 b + 1's rows at tile row
  // 32; a pair past A copies one run).
  auto copy = [&](int b) {
    const int n = n0 + b, st = n & 1, live = 2 * b + 1 < p.A ? 2 : 1;
    const unsigned long long c0 = split::ring_now();
    mbar_wait(empty + st, static_cast<unsigned>((n >> 1) & 1) ^ 1u);
    const unsigned long long c1 = split::ring_now();
    mbar_arrive_expect_tx(full + st, live * kTileBytes / 2);
    for (int i = 0; i < live; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        box_copy(tiles + st * kTileBytes + half * (kTileBytes / 2) + i * kRun * 128, map,
                 64 * half, row0 + (2 * b + i) * 2 * N1, full + st);
      }
    }
    ns_empty += c1 - c0;
    ns_issue += split::ring_now() - c1;
  };
  // h of the thread's antenna of pair b at its 8 bins of quarter Q: N1 (32 Q
  // + 8 j + 2 t4 + cc) + k1 (none past A).
  auto load_h = [&](float (&h)[8][2], int b, int Q) {
    const int a = 2 * b + par;
    if (a >= p.A) return;
    const long long hrow = (static_cast<long long>(k) * p.A + a) * F + 2 * t4 * N1 + k1;
#pragma unroll
    for (int jc = 0; jc < 8; ++jc) {
      const int off = N1 * (32 * Q + 8 * (jc >> 1) + (jc & 1));
      h[jc][0] = __ldg(p.h_re + hrow + off);
      h[jc][1] = __ldg(p.h_im + hrow + off);
    }
  };
  if (threadIdx.x == 0) {
    // The slot's column tiles stored through the generic proxy; the copies
    // read it through the async proxy.
    asm volatile("fence.proxy.async.global;" ::: "memory");
    copy(0);
  }
  __syncwarp();  // warp 0 converged again before its products
  // Each quarter's h one pair ahead of its fold.
  float hq[2][8][2];
  load_h(hq[0], 0, 2 * wgi);
  load_h(hq[1], 0, 2 * wgi + 1);
  mbar_wait(w_in, 0);  // W has landed (the first row tile; at once after it)
  for (int b = 0; b < pairs; ++b) {
    const int n = n0 + b, st = n & 1;
    const bool live = 2 * b + par < p.A;
    if (threadIdx.x == 0 && b + 1 < pairs) copy(b + 1);  // tile (b + 1) % 2: pair b - 1 is done
    __syncwarp();
    const unsigned tile_s = smem_u32(tiles + st * kTileBytes);
    const unsigned long long f0 = split::ring_now();
    mbar_wait(full + st, static_cast<unsigned>((n >> 1) & 1));
    ns_full += split::ring_now() - f0;
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
      const unsigned long long q0 = split::ring_now();
      float d[32];
      issue_quarter(d, tile_s, w_s, 2 * wgi + qq);
      wg::wait<0>();
      wg::fence_operands(d);
      if (qq == 1) mbar_arrive(empty + st);  // this thread's products of the tile are done
      const unsigned long long q1 = split::ring_now();
      if (live) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float cre = d[4 * j + cc] - d[4 * (j + 4) + 2 + cc];  // Br Wr - Bi Wi
            const float cim = d[4 * (j + 4) + cc] + d[4 * j + 2 + cc];  // Br Wi + Bi Wr
            const int jc = 2 * j + cc;
            const float hr = hq[qq][jc][0], hi = hq[qq][jc][1];
            sums[8 * qq + jc][0] += cre * hr + cim * hi;
            sums[8 * qq + jc][1] += cim * hr - cre * hi;
          }
        }
      }
      if (b + 1 < pairs) load_h(hq[qq], b + 1, 2 * wgi + qq);
#ifdef OFDM_RING_TRACE
      asm volatile("" ::"f"(sums[8 * qq][0]));
#endif
      const unsigned long long q2 = split::ring_now();
      ns_product += q1 - q0;
      ns_fold += q2 - q1;
      if (qq == 1) ns_second += q1 - q0;
    }
  }
  split::ring_put(t, 6, ns_issue);
  split::ring_put(t, 7, ns_empty);
  split::ring_put(t, 8, ns_full);
  split::ring_put(t, 9, ns_product);
  split::ring_put(t, 10, ns_fold);
  split::ring_put(t, 11, ns_second);
  __syncthreads();  // every copy has landed and every product is done: the tiles are free
  done();
  // The second antenna half's sums to the first through the tiles' memory
  // (value i of thread u at [i][u], 128 threads' worth): thread u + 64 of a
  // warpgroup (its warps 2 and 3) holds the same bins as thread u.
  float* const half = reinterpret_cast<float*>(tiles) + wgi * 64 + (u & 63);
  if (par) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      half[(2 * i) * 128] = sums[i][0];
      half[(2 * i + 1) * 128] = sums[i][1];
    }
  }
  __syncthreads();
  if (par) return;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sums[i][0] += half[(2 * i) * 128];
    sums[i][1] += half[(2 * i + 1) * 128];
  }
  // eq = num * inv in reference order (the DC bin dropped).
  const float* const inv_k = p.gain + static_cast<long long>(k) * F;
  float gain[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int Q = 2 * wgi + (i >> 3), jc = i & 7;
    gain[i] = __ldg(inv_k + N1 * (32 * Q + 8 * (jc >> 1) + 2 * t4 + (jc & 1)) + k1);
  }
  const long long orow = item * (F - 1);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int Q = 2 * wgi + (i >> 3), jc = i & 7;
    const int bin = N1 * (32 * Q + 8 * (jc >> 1) + 2 * t4 + (jc & 1)) + k1;
    if (bin != 0) {
      int jo = bin - F / 2;
      if (jo < 0) jo += F - 1;
      split::st_evict_first(p.out_re + orow + jo, sums[i][0] * gain[i], policy);
      split::st_evict_first(p.out_im + orow + jo, sums[i][1] * gain[i], policy);
    }
  }
}

template <int N1, typename E>
__global__ void __launch_bounds__(split::kRowThreads, split::kRingBlocks)
fft_mrc_bf16_ring_kernel(const split::RingArgs p, const __grid_constant__ CUtensorMap map) {
  using L = RingSmem<N1>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* const empty = full + 2;
  uint64_t* const w_in = empty + 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, split::kRowThreads);
    }
    mbar_init(w_in, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
    mbar_arrive_expect_tx(w_in, kWBytes);
    for (int i = 0; i < kWBytes / kWPiece; ++i) {
      bulk_copy(smem + L::kW + i * kWPiece,
                static_cast<const unsigned char*>(p.w_image) + i * kWPiece, kWPiece, w_in);
    }
  }
  // (ring_loop's first __syncthreads publishes the barriers to every thread.)
  const unsigned w_s = smem_u32(smem + L::kW);
  int n = 0;  // antenna pairs the block's row tiles have taken: tile stage n % 2
  split::ring_loop<N1, E, kRingK1, __nv_bfloat16, true>(
      p, reinterpret_cast<float*>(smem), reinterpret_cast<float2*>(smem + L::kTw),
      [&](long long t, int item, int g, const __nv_bfloat16*, const __nv_bfloat16*,
          const float2*, uint64_t policy, auto gate, auto done) {
        gate();
        __syncthreads();  // the symbol's column tiles are in its slot
        ring_rows<N1>(p, &map, item, kRingK1 * g, n, item % p.slots, smem, w_s, full, empty,
                      w_in, policy, t, done);
        n += (p.A + 1) / 2;
      });
}

// One TMA bulk copy of `bytes` into the same offset of the shared memory of
// every block of `mask` in the cluster, completed on the barrier at the same
// offset in each (the W multicast of pilot_rows_kernel).
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, unsigned bytes,
                                                    uint64_t* bar, unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// The bf16 pilot's row pass: grid (n1 / 32 x CL, n), cluster (CL, 1, 1)
// (ops/fft_plan.py speed_cluster: one block an antenna up to 8, fewer while
// the launch would hold more blocks than SMs).  The cluster's blocks take
// the same 32 bins k1 = 32 g + q of a frame; rank r takes antennas r, r +
// CL, ..., and its two warpgroups take them in turn (warpgroup w antennas
// r + CL w, r + CL (w + 2), ...), each on its own tile: one chunk of 32
// complex rows an antenna through the four wgmma quarters and a fold that
// forms h = C conj(X) / |X|^2, stores it at once and adds |h|^2 into the
// thread's 32 sums; its rows come by cp.async into a row stage of its own,
// the next antenna's during the product (rows held in registers instead
// left too few for the accumulators, and ptxas serialized the products).
// (One warpgroup a block left each scheduler one warp, and the fold's chain
// of dependent instructions set the pace.)  W is copied once a cluster:
// every block's elected thread expects 64 KB on its barrier and rank r
// issues the pieces r, r + CL, ... of W's shared-memory image
// (ops/fft_plan.py speed_w_image), each a TMA multicast into every block of
// the cluster, after one cluster barrier that makes every peer's barrier
// initialised.  X of the cluster's 32 x 128 bins is staged in shared memory
// by cp.async (bin (k2, q) at k2 (32 + 4) + q, the fold's reads free of bank
// conflicts) and scaled to X / |X|^2 in place while the first products run,
// so no fold waits on a global load.  The warpgroups' sums then go to shared
// memory (entry (k2, q) at k2 (32 + 1) + q, in the region of the block's W,
// free once its last product is done; warpgroup 0's, then warpgroup 1's
// added), and after a cluster barrier rank r adds its share of the
// cluster's 32 x 128 bins (entry i = (k2 = i / 32, q = i % 32); fft_plan.py
// speed_pilot_rank_bins) over the CL blocks through distributed shared
// memory and writes 1 / sum; a last cluster barrier keeps each block
// resident until its peers have read it.
template <int N1>
__global__ void __launch_bounds__(kPilotRowsThreads, 1) pilot_rows_kernel(const RowsParams p) {
  constexpr int F = N1 * kN2;
  constexpr int kBins = kRowsK1 * kN2;  // bins of a cluster
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  const int t = threadIdx.x;
  const int wgi = t >> 7;  // the warpgroup
  const int u = t & 127;   // its thread
  unsigned char* const tile = smem + kWBytes + wgi * kTileBytes;
  float* const xs_re = reinterpret_cast<float*>(smem + kWBytes + 2 * kTileBytes);
  float* const xs_im = xs_re + kN2 * kXsStride;
  uint64_t* const w_in = reinterpret_cast<uint64_t*>(smem + kWBytes + 2 * kTileBytes + kXsBytes +
                                                     2 * kRowBytes);
  const unsigned w_s = smem_u32(smem), tile_s = smem_u32(tile);
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = static_cast<int>(blockIdx.x) / CL;
  const long long il = blockIdx.y;
  const long long k = p.item0 + il;
  const int q = 8 * (u >> 5) + ((u & 31) >> 2);  // the thread's complex row of a chunk
  const int t4 = u & 3;
  const int k1 = kRowsK1 * grp + q;
  const float* const b_re = p.b_re + (il * p.A * N1 + kRowsK1 * grp) * kN2;
  const float* const b_im = p.b_im + (il * p.A * N1 + kRowsK1 * grp) * kN2;
  if (t == 0) {
    mbar_init(w_in, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Rounds of the block, the same for both warpgroups (no product sits in a
  // branch on the warpgroup, so the compiler keeps them asynchronous): round
  // i takes antenna rank + CL (2 i + w) of warpgroup w, where there is one.
  const int rounds = ((p.A - rank + CL - 1) / CL + 1) / 2;
  const int step = 2 * CL;
  int a = rank + CL * wgi;  // the warpgroup's antenna
  float* const stage = reinterpret_cast<float*>(smem + kWBytes + 2 * kTileBytes + kXsBytes +
                                                wgi * kRowBytes);
  stage_rows<N1>(stage, b_re, b_im, a < p.A ? a : rank, u);
  wfft::cp_async_commit();
  // X, entry (k2, q) = bin n1 k2 + 32 g + q, by 16-byte cp.async (four bins
  // of one plane a piece, 8 pieces a thread), behind the first rows.
#pragma unroll
  for (int i = t; i < 2 * kN2 * (kRowsK1 / 4); i += kPilotRowsThreads) {
    const int plane = i / (kN2 * kRowsK1 / 4), k2 = (i / (kRowsK1 / 4)) % kN2;
    const int c = 4 * (i % (kRowsK1 / 4));
    wfft::cp_async16((plane ? xs_im : xs_re) + k2 * kXsStride + c,
                     (plane ? p.x_im : p.x_re) + N1 * k2 + kRowsK1 * grp + c);
  }
  wfft::cp_async_commit();
  // Relaxed: the barrier's initialisation is released by its own fence, and
  // a release here would wait for the copies above.
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  cluster_wait();  // every block's barrier is initialised
  if (t == 0) {
    mbar_arrive_expect_tx(w_in, kWBytes);
    const unsigned short all = static_cast<unsigned short>((1u << CL) - 1u);
    for (int i = rank; i < kWBytes / kWPiece; i += CL) {
      bulk_copy_multicast(smem + i * kWPiece, reinterpret_cast<const unsigned char*>(p.w) +
                          i * kWPiece, kWPiece, w_in, all);
    }
  }
  float sums[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sums[i] = 0.0f;
  float da[32], db[32];
  // Antenna a's tile from the row stage and its first two quarters (past A:
  // the last rows again, the product unused), then the warpgroup's next
  // antenna's rows into the stage, in flight during a's product and fold.
  auto begin = [&](bool first) {
    if (first) {
      wfft::cp_async_wait<1>();  // the first rows; X may still be in flight
    } else {
      wfft::cp_async_wait<0>();
    }
    wg_sync(wgi);  // the stage has landed for the warpgroup
    write_stage(stage, tile, u);
    fence_proxy_async();
    wg_sync(wgi);  // the warpgroup's tile is written and its stage read
    issue_quarter(da, tile_s, w_s, 0);
    issue_quarter(db, tile_s, w_s, 1);
    if (a + step < p.A) stage_rows<N1>(stage, b_re, b_im, a + step, u);
    wfft::cp_async_commit();
  };
  mbar_wait(w_in, 0);  // W has landed (written by the async proxy, read by it)
  begin(true);
  wfft::cp_async_wait<0>();
  __syncthreads();  // every piece of X has landed
  for (int i = t; i < kBins; i += kPilotRowsThreads) {  // X / |X|^2, an entry a thread
    const int at = (i >> 5) * kXsStride + (i & 31);
    const float xr = xs_re[at], xi = xs_im[at];
    const float den = __frcp_rn(xr * xr + xi * xi);  // as 1.0f / |X|^2
    xs_re[at] = xr * den;
    xs_im[at] = xi * den;
  }
  __syncthreads();  // X / |X|^2 is published
  for (int i = 0; i < rounds; ++i) {
    const bool live = a < p.A;
    const long long hrow = (k * p.A + a) * F;
#pragma unroll
    for (int Q = 0; Q < kQuarters; ++Q) {
      if (Q < kQuarters - 1) {
        wg::wait<1>();
      } else {
        wg::wait<0>();
      }
      float(&d)[32] = (Q & 1) ? db : da;
      wg::fence_operands(d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float cre = d[4 * j + cc] - d[4 * (j + 4) + 2 + cc];  // Br Wr - Bi Wi
          const float cim = d[4 * (j + 4) + cc] + d[4 * j + 2 + cc];  // Br Wi + Bi Wr
          const int k2 = 32 * Q + 8 * j + 2 * t4 + cc;
          const float xr = xs_re[k2 * kXsStride + q], xi = xs_im[k2 * kXsStride + q];
          const float hr = cre * xr + cim * xi;
          const float hi = cim * xr - cre * xi;
          if (live) {
            p.out_re[hrow + N1 * k2 + k1] = hr;
            p.out_im[hrow + N1 * k2 + k1] = hi;
            sums[8 * Q + 2 * j + cc] += hr * hr + hi * hi;
          }
        }
      }
      if (Q + 2 < kQuarters) issue_quarter(d, tile_s, w_s, Q + 2);
    }
    a += step;
    if (i + 1 < rounds) {
      wg_sync(wgi);  // every thread of the warpgroup is past its products: the tile is free
      begin(false);
    }
  }
  // The block's sums, entry (k2, q) at k2 kNatStride + q of W's region:
  // warpgroup 0's, then warpgroup 1's added (the same entries, thread by
  // thread).
  __syncthreads();  // every product of the block is done: W is free
  float* const nat = reinterpret_cast<float*>(smem);
  for (int w = 0; w < 2; ++w) {
    if (wgi == w) {
#pragma unroll
      for (int ix = 0; ix < 32; ++ix) {
        const int k2 = 32 * (ix >> 3) + 8 * ((ix >> 1) & 3) + 2 * t4 + (ix & 1);
        nat[k2 * kNatStride + q] = w ? nat[k2 * kNatStride + q] + sums[ix] : sums[ix];
      }
    }
    __syncthreads();
  }
  cluster_arrive();
  cluster_wait();  // every block's sums are written and visible to the cluster
  // Rank r: entries [r kBins / CL, (r + 1) kBins / CL); 32 consecutive
  // entries are 32 consecutive bins.
  const int lo = rank * kBins / CL, hi = (rank + 1) * kBins / CL;
  float* const inv_k = p.inv_out + k * F;
#pragma unroll 4
  for (int i = lo + t; i < hi; i += kPilotRowsThreads) {
    const int at = (i >> 5) * kNatStride + (i & 31);
    float part[kPilotCluster];
#pragma unroll
    for (int c = 0; c < kPilotCluster; ++c) {
      part[c] = c < CL ? cluster.map_shared_rank(nat, c)[at] : 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kPilotCluster; ++c) s += part[c];
    inv_k[N1 * (i >> 5) + kRowsK1 * grp + (i & 31)] = 1.0f / s;
  }
  cluster_arrive();
  cluster_wait();  // no block leaves while a peer still reads its sums
}

// One launch of the bf16 ring (fft_split.cuh launch_ring: the schedule
// checked, two blocks an SM), the tensor map of its ring beside it.
template <int N1>
cudaError_t ring_fft_mrc_bf16(bool int16, const split::RingArgs& p, cudaStream_t stream) {
  constexpr size_t bytes = RingSmem<N1>::kBytes;
  if (p.ring == nullptr || p.slots < 1 || p.A < 1) return cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t err = ring_map(&map, p.ring, p.slots, p.A, N1);
  if (err != cudaSuccess) return err;
  return int16 ? split::launch_ring<N1, kRingK1>(fft_mrc_bf16_ring_kernel<N1, int16_t>, p,
                                                 stream, bytes, map)
               : split::launch_ring<N1, kRingK1>(fft_mrc_bf16_ring_kernel<N1, float>, p,
                                                 stream, bytes, map);
}

// The column pass and pilot_rows_kernel over chunks of `chunk` frames: a
// cluster of `cl` blocks for each 32 bins k1 of a frame (ops/fft_plan.py
// speed_cluster: one block an antenna up to kPilotCluster, fewer with K
// frames); p.w is W's shared-memory image.
template <int N1>
cudaError_t launch_pilot_rows(bool int16, const Params& p, int cl, const float* tw,
                              float* scratch, int chunk, cudaStream_t stream) {
  if (cl < 1 || cl > kPilotCluster || cl > p.A) return cudaErrorInvalidValue;
  auto kernel = pilot_rows_kernel<N1>;
  cudaError_t err = allow_smem(kernel, kPilotRowsBytes);
  if (err != cudaSuccess) return err;
  constexpr int kGroups = N1 / kRowsK1;
  RowsParams r = {nullptr, nullptr, 0, p.A, p.x_re, p.x_im, p.w, p.out_re, p.out_im,
                  p.inv_out};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kPilotRowsThreads);
  cfg.dynamicSmemBytes = kPilotRowsBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return split::run_split<N1>(
      int16, p.y_re, p.y_im, p.stride_k, p.stride_s, p.stride_a, 1, p.A, p.K, tw, scratch,
      chunk, stream, [&](const float* b_re, const float* b_im, long long i0, int n) {
        r.b_re = b_re;
        r.b_im = b_im;
        r.item0 = i0;
        cfg.gridDim = dim3(kGroups * cl, n);
        cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, r);
        return e != cudaSuccess ? e : cudaGetLastError();
      });
}

// One launch: clusters of min(chunks of a symbol, max_cluster) blocks, at
// most one block an SM, walking `items` symbols (the pilot: frames).
template <int N1, bool kPilot, typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, long long items, int max_cluster,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<N1 * kN2, kPilot>::kBytes;
  cudaError_t err = allow_smem(kernel, bytes);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int nc = (p.A * N1 + kChunkRows - 1) / kChunkRows;
  // A cluster splits one symbol's chain; it pays only when the symbols
  // alone leave SMs idle (a streaming symbol, a pilot, a short frame).
  // Otherwise a block that takes whole symbols finishes sooner: no peer to
  // wait for and one cluster reduce fewer (PERF.md, "Findings").
  int cl = nc < max_cluster ? nc : max_cluster;
  while (cl > 1 && items * cl > sms) --cl;
#ifdef OFDM_SPEED_MAX_CLUSTER  // tools/speed_trace.py --cluster
  cl = nc < OFDM_SPEED_MAX_CLUSTER ? nc : OFDM_SPEED_MAX_CLUSTER;
#endif
  const long long most = sms / cl;
  const int clusters = static_cast<int>(items < most ? items : most);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * cl);
  cfg.blockDim = dim3(kThreads<kPilot>);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// F -> n1 = F / 128 of the instantiations; 0 for any other F.
inline int n1_of(int F) {
  switch (F) {
    case 256: return 2;
    case 512: return 4;
    case 1024: return 8;
    case 2048: return 16;
    case 4096: return 32;
    default: return 0;
  }
}

template <typename T>
cudaError_t dispatch(int F, bool pilot, const Params& p, int rows_cluster, const float* split_tw,
                     float* scratch, int chunk, cudaStream_t st) {
  const long long items = static_cast<long long>(p.K) * p.S;
  constexpr bool int16 = sizeof(T) == 2;
  switch (F) {  // the pilot's split form (the data path's: its C entry, the ring)
    case 8192:
      return pilot ? launch_pilot_rows<64>(int16, p, rows_cluster, split_tw, scratch, chunk, st)
                   : cudaErrorInvalidValue;
    case 16384:
      return pilot ? launch_pilot_rows<128>(int16, p, rows_cluster, split_tw, scratch, chunk, st)
                   : cudaErrorInvalidValue;
    case 32768:
      return pilot ? launch_pilot_rows<256>(int16, p, rows_cluster, split_tw, scratch, chunk, st)
                   : cudaErrorInvalidValue;
    default:
      break;
  }
#define OFDM_CALL(N1)                                                                  \
  return pilot ? launch<N1, true>(pilot_ls_bf16_kernel<N1, T>, p, items, kPilotCluster, st) \
               : launch<N1, false>(fft_mrc_bf16_kernel<N1, T>, p, items, kDataCluster, st)
  switch (n1_of(F)) {
    case 2: OFDM_CALL(2);
    case 4: OFDM_CALL(4);
    case 8: OFDM_CALL(8);
    case 16: OFDM_CALL(16);
    case 32: OFDM_CALL(32);
    default: return cudaErrorInvalidValue;
  }
#undef OFDM_CALL
}

}  // namespace speed
}  // namespace ofdm

// Data rows: y_re/y_im at row (k=0, s=0, a=0) of K x S x A rows of F
// samples, row (k, s, a) at element k*stride_k + s*stride_s + a*stride_a,
// int16 when in_int16, float32 otherwise (any strides: the rows are read
// element by element).  h_re/h_im [K, A, F] unconjugated estimate (16-byte
// aligned: below F = 8192 the kernel copies a chunk's rows in bulk) and inv
// [K, F], natural order.  tw: [F/128, 128] (re, im) float32 stage-1
// twiddles, the sc16 scale folded in for int16 rows; from F = 8192 the split
// table of ops/fft_plan.py (split_tables) with the same fold.  Below F =
// 8192: w [128, 256] bf16 [Wr | Wi], 16-byte aligned, w_image null, ring and
// counters null.  From F = 8192: w null, w_image W's shared-memory image
// (ops/fft_plan.py speed_w_image, 64 KB, 16-byte aligned), ring [2, slots,
// A, F] bf16, the schedule's lag and its zeroed counters [1 + 2 K S]
// (ops/fft_plan.py split_ring with the bf16 row tiles).  Outputs
// out_re/out_im [K, S, F-1] in reference order.  Returns the cudaError_t of
// the launch.
extern "C" int ofdm_fft_mrc_bf16(const void* y_re, const void* y_im, int in_int16,
                                 long long stride_k, long long stride_s, long long stride_a,
                                 int K, int S, int A, int F, const float* h_re,
                                 const float* h_im, const float* inv, const float* tw,
                                 const void* w, const void* w_image, float* out_re,
                                 float* out_im, void* ring, int slots, int lag,
                                 unsigned* counters, void* stream) {
  const bool split = F == 8192 || F == 16384 || F == 32768;
  const long long items = static_cast<long long>(K) * S;
  if (K < 1 || S < 1 || A < 1 || items >= (1LL << 31) ||
      (split ? w != nullptr || w_image == nullptr : w == nullptr || w_image != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split) {
    const ofdm::split::RingArgs r{y_re, y_im, stride_k, stride_s, stride_a, S, A,
                                  static_cast<int>(items), slots, lag, 1.0f,
                                  reinterpret_cast<const float2*>(tw), static_cast<float*>(ring),
                                  counters, h_re, h_im, inv, out_re, out_im, w_image};
    const bool int16 = in_int16 != 0;
    return static_cast<int>(F == 8192    ? ofdm::speed::ring_fft_mrc_bf16<64>(int16, r, st)
                            : F == 16384 ? ofdm::speed::ring_fft_mrc_bf16<128>(int16, r, st)
                                         : ofdm::speed::ring_fft_mrc_bf16<256>(int16, r, st));
  }
  const long long esize = in_int16 ? 2 : 4;
  int align = 16;
  for (long long v : {static_cast<long long>(reinterpret_cast<uintptr_t>(y_re)),
                      static_cast<long long>(reinterpret_cast<uintptr_t>(y_im)), stride_k * esize,
                      stride_s * esize, stride_a * esize}) {
    while (v % align) align /= 2;
  }
  ofdm::speed::Params p = {y_re, y_im, stride_k, stride_s, stride_a, K, S, A, h_re, h_im,
                           inv, nullptr, nullptr, reinterpret_cast<const float2*>(tw),
                           static_cast<const uint4*>(w), out_re, out_im, nullptr, align};
  return static_cast<int>(
      in_int16 ? ofdm::speed::dispatch<int16_t>(F, false, p, 0, nullptr, nullptr, 0, st)
               : ofdm::speed::dispatch<float>(F, false, p, 0, nullptr, nullptr, 0, st));
}

#ifdef OFDM_RING_TRACE
// The stamp buffer of a traced build (fft_split.cuh ring_trace), or null.
extern "C" int ofdm_ring_trace_set(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(ofdm::split::ring_trace, &buf, sizeof(buf)));
}
#endif

// Pilot rows: p_re/p_im at row (k=0, a=0) of K x A rows, row (k, a) at
// element k*stride_k + a*stride_a, int16 or float32.  x_re/x_im: [F]
// padded pilot, natural order, 16-byte aligned.  tw as for
// ofdm_fft_mrc_bf16.  scratch, chunk: from F = 8192 the split form's
// scratch [2, chunk, A, F] float32 and the frames of one chunk.  Below F = 8192: w as there,
// w_image null and clusters 0.  From F = 8192: w null, w_image W's
// shared-memory image (ops/fft_plan.py speed_w_image, 64 KB, 16-byte
// aligned) and clusters the row pass's cluster (ops/fft_plan.py
// speed_cluster, 1 to min(A, 8)).  Outputs h_re/h_im [K, A, F] and inv
// [K, F] = 1/sum_a |h|^2, natural order.
extern "C" int ofdm_pilot_ls_bf16(const void* p_re, const void* p_im, int in_int16,
                                  long long stride_k, long long stride_a, int K, int A, int F,
                                  const float* x_re, const float* x_im, const float* tw,
                                  const void* w, const void* w_image, int clusters,
                                  float* h_re, float* h_im, float* inv, float* scratch,
                                  int chunk, void* stream) {
  const bool split = F == 8192 || F == 16384 || F == 32768;
  if (K < 1 || A < 1 || (split ? w != nullptr || w_image == nullptr
                               : w == nullptr || w_image != nullptr || clusters != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ofdm::speed::Params p = {p_re, p_im, stride_k, 0, stride_a, K, 1, A, nullptr, nullptr,
                           nullptr, x_re, x_im, reinterpret_cast<const float2*>(tw),
                           static_cast<const uint4*>(split ? w_image : w), h_re, h_im, inv, 2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_int16 ? ofdm::speed::dispatch<int16_t>(F, true, p, clusters, tw, scratch, chunk, st)
               : ofdm::speed::dispatch<float>(F, true, p, clusters, tw, scratch, chunk, st));
}
