// The exact data kernels at F = 8192, spread over the card: fft_mrc.cu
// fft_mrc_spread_kernel and mrc_demod.cu mrc_demod_spread_kernel run
// spread_rows below, each with its own store.
//
// The rows.  A launch has N = K S A antenna rows (symbol item = k S + s,
// row g = item A + a) and a grid of B = min(SMs, ceil(N / kMinRows))
// blocks (plan_blocks; ops/fft_plan.py spread_plan): block b takes the
// contiguous rows [b N / B, (b + 1) N / B), so one 16 x 8192 x 100 frame,
// 1,600 rows, is 12 or 13 rows on each of the 132 SMs, where the kernel
// before it ran a symbol's 16 rows on each of 100.  A block is one team of
// 256 threads of the register FFT of fft_warp.cuh at F = 8192 (32 values a
// thread, radices 32, 16, 16), its rows in sequence: row i + 1 is copied
// into the second of two buffers (cp.async, or element copies where the
// rows are not 16-byte aligned) while row i is transformed; once row i's
// last exchange is read, h's row for it is copied (cp.async) into row i's
// buffer, landing while the last pass runs, and Y conj(h) (mrc_demod:
// Y hc) is added into the block's sums in registers: a block reads h only
// for the rows it takes.  (Read straight from L2 at the multiply-add, h
// took 1.1 us of a 16-antenna row and 2.0 of a 64-antenna one on the H100,
// tools/spread_trace.py.)
//
// The twiddles.  The first two passes read theirs from pass_twiddles's
// first block in shared memory.  The last pass (radix 16, Ns = 512) takes
// the table's rows r = 1, 2, 4, 8 and forms the other 11 as their products
// in float32 (3 products at most): the block holds 20 KB of twiddles where
// the whole table took 68 KB, 155,664 B of shared memory in all.  With the
// whole table (204,816 B) the same kernel's FFT took 3.5-3.8 us a float32
// row on the H100, with the products 2.9-3.0 (tools/spread_trace.py,
// PERF.md).
// No __sinf, no fast-math.
//
// The sum over the antennas.  A symbol whose rows all fall in the block is
// stored from its registers.  Otherwise the block writes its partial sum
// to partials[b][slot] (slot 0 for the block's first symbol, 1 for its
// last) and a device-scope count per symbol finds the last of the symbol's
// blocks to finish: that block (which, finding every other block counted,
// skips writing its own) adds the partials of blocks first .. last in
// block order (the same float32 sums whatever the order the blocks finish
// in, no float atomics), sets the count back to 0 for the next launch on
// the stream and stores.

#pragma once

#include <cstdint>

#include "fft_warp.cuh"

namespace ofdm {
namespace spread {

constexpr int kF = 8192;
using Geo = wfft::Geo<kF>;
using PlanF = wfft::Plan<kF>;
constexpr int kT = Geo::T;                       // 256 threads: the block's team
constexpr int kM = Geo::M;                       // 32 values a thread
constexpr int kMinRows = 4;                      // rows a block, at least (ops/fft_plan.py SPREAD_MIN_ROWS)
constexpr int kNs = PlanF::R0 * PlanF::R1;       // 512: Ns of the last pass
constexpr int kR = PlanF::R2;                    // 16: its radix
constexpr int kPowers = 4;                       // its table rows r = 1, 2, 4, 8 in shared memory
constexpr int kChunk = 8;                        // a thread's bins a step of the partials' sum
constexpr int kInFlight = 4;                     // partials read at once in that step
constexpr int kPlane = Geo::kPlane;              // floats of a buffer's plane
// Dynamic shared memory, in floats: pass 2's twiddles, the last pass's rows
// r = 1, 2, 4, 8, two row buffers (two planes each), a flag (ops/fft_plan.py
// spread_smem_bytes).
constexpr int kBufOffset = 2 * (Geo::kTw1 + kPowers * kNs);
constexpr int kFlagOffset = kBufOffset + 2 * 2 * kPlane;
constexpr size_t kSmemBytes = static_cast<size_t>(kFlagOffset + 4) * sizeof(float);
static_assert(PlanF::R0 == 32 && PlanF::R1 == 16 && kR == 16 && kM == 2 * kR, "radices 32, 16, 16");
static_assert(kT * 2 == kNs, "the last pass's butterflies j + 256 q, q < 2, are its columns c");

struct Args {
  const void* y_re;
  const void* y_im;
  long long stride_k, stride_s, stride_a;  // elements
  long long rows;                          // N = K S A, below 2^31
  int S, A, blocks;
  float scale;
  const float* h_re;       // [K, A, F]: h (fft_mrc) or hc (mrc_demod), 16-byte aligned
  const float* h_im;
  const float* gain;       // inv [K, F] (fft_mrc) or hsqrd [F] (mrc_demod)
  long long gain_stride;   // F (fft_mrc) or 0 (mrc_demod)
  const float2* tw;        // ops/fft_plan.py pass_twiddles(8192)
  float* out_re;
  float* out_im;
  float* partials;         // [blocks, 2, F] complex (re, im interleaved)
  unsigned* counters;      // [K S], zero; left zero
};

// First row of block b (ops/fft_plan.py spread_block_rows).
__host__ __device__ __forceinline__ long long block_lo(long long rows, int blocks, int b) {
  return rows * b / blocks;
}

// The block whose rows hold row g: the largest b with block_lo(b) <= g.
__host__ __device__ __forceinline__ int block_of(long long rows, int blocks, long long g) {
  return static_cast<int>(((g + 1) * blocks - 1) / rows);
}

// Blocks of a launch of N rows on a card of `sms` SMs: one an SM, at most
// one for each kMinRows rows (ops/fft_plan.py spread_plan).
__host__ inline int plan_blocks(long long rows, int sms) {
  const long long most = (rows + kMinRows - 1) / kMinRows;
  return static_cast<int>(most < sms ? most : sms);
}

// The plan the wrapper passed (blocks, dynamic shared memory) against the
// kernel's own for N rows on the current device, and h's planes 16-byte
// aligned (its rows are copied in 16-byte pieces).
__host__ inline bool plan_ok(long long rows, int blocks, long long smem, const float* h_re,
                             const float* h_im) {
  int sms = 0;
  if (rows < 1 || rows >= (1LL << 31) || sm_count(&sms) != cudaSuccess) return false;
  if (reinterpret_cast<uintptr_t>(h_re) % 16 || reinterpret_cast<uintptr_t>(h_im) % 16) {
    return false;
  }
  return blocks == plan_blocks(rows, sms) && smem == static_cast<long long>(kSmemBytes);
}

// The last pass: radix kR, Ns = kNs.  Input r of butterfly b = j + kT q
// (its column c = b < kNs) is multiplied by exp(-2 pi i c r / F): the
// table's rows r = 1, 2, 4, 8 (pw, kNs entries each) and their products.
__device__ __forceinline__ void last_pass(float2 (&v)[kM], const float2* __restrict__ pw, int j) {
  constexpr int Q = kM / kR;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int c = j + kT * q;
    float2 w[kR];
    w[1] = pw[c];
    w[2] = pw[kNs + c];
    w[4] = pw[2 * kNs + c];
    w[8] = pw[3 * kNs + c];
    w[3] = cmul(w[2], w[1]);
    w[5] = cmul(w[4], w[1]);
    w[6] = cmul(w[4], w[2]);
    w[7] = cmul(w[4], w[3]);
#pragma unroll
    for (int r = 1; r < 8; ++r) w[8 + r] = cmul(w[8], w[r]);
#pragma unroll
    for (int r = 1; r < kR; ++r) v[q + Q * r] = cmul(v[q + Q * r], w[r]);
    wfft::dft<kR, kM>(v, q);
  }
}

// FFT of the row staged (raw, element type E) in buf; on return register m
// holds bin j + kT m.  Once every thread has read the last exchange, the
// row's h (h_re, h_im: F floats each) is copied into buf (cp.async,
// committed, not waited for): it lands while the last pass runs.
template <typename E>
__device__ __forceinline__ void row_fft(float2 (&v)[kM], float* buf,
                                        const float2* __restrict__ tw1,
                                        const float2* __restrict__ pw,
                                        const float* __restrict__ h_re,
                                        const float* __restrict__ h_im,
                                        const wfft::Team<kT>& team) {
  const int j = team.j;
  const E* const sre = reinterpret_cast<const E*>(buf);
  const E* const sim = reinterpret_cast<const E*>(buf + kPlane);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    v[m] = make_float2(wfft::widen(sre[j + kT * m]), wfft::widen(sim[j + kT * m]));
  }
  wfft::run_pass<kF, PlanF::R0, 1>(v, tw1, j);
  team.sync();  // the staged row has been read
  wfft::write_exchange<kF, PlanF::R0, 1>(v, buf, j);
  team.sync();
  wfft::read_exchange<kF>(v, buf, j);
  wfft::run_pass<kF, PlanF::R1, PlanF::R0>(v, tw1, j);
  team.sync();
  wfft::write_exchange<kF, PlanF::R1, PlanF::R0>(v, buf, j);
  team.sync();
  wfft::read_exchange<kF>(v, buf, j);
  team.sync();  // the buffer is free
  wfft::stage_row<kF, float, true>(buf, h_re, h_im, j);
  wfft::cp_async_commit();
  last_pass(v, pw, j);
}

// Y conj(h) (kConjugate) or Y hc of bin value y and h.
template <bool kConjugate>
__device__ __forceinline__ float2 mac(float2 y, float2 h) {
  return kConjugate ? make_float2(y.x * h.x + y.y * h.y, y.y * h.x - y.x * h.y)
                    : make_float2(y.x * h.x - y.y * h.y, y.x * h.y + y.y * h.x);
}

// Block b's partial of symbol `item`: slot 0 for the block's first symbol,
// 1 for its last.
__device__ __forceinline__ float2* partial(const Args& p, int b, int item) {
  const int slot = item == block_lo(p.rows, p.blocks, b) / p.A ? 0 : 1;
  return reinterpret_cast<float2*>(p.partials) + (2LL * b + slot) * kF;
}

// s, block `me`'s partial of `item`, becomes the sum of the partials of
// blocks b0 .. b1 in block order, the others' read from L2.  With two
// blocks the sum is one addition (the same bits in either order).
__device__ __forceinline__ void add_partials(const Args& p, int item, int b0, int b1, int me,
                                             float2 (&s)[kM], int j) {
  if (b1 - b0 == 1) {
    const float2* const other = partial(p, me == b0 ? b1 : b0, item) + j;
    float2 x[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) x[m] = __ldcg(other + kT * m);
#pragma unroll
    for (int m = 0; m < kM; ++m) s[m] = make_float2(s[m].x + x[m].x, s[m].y + x[m].y);
    return;
  }
#pragma unroll
  for (int c = 0; c < kM; c += kChunk) {
    float2 sum[kChunk];
    for (int b = b0; b <= b1; b += kInFlight) {
      float2 x[kInFlight][kChunk];
#pragma unroll
      for (int f = 0; f < kInFlight; ++f) {
        if (b + f <= b1 && b + f != me) {
          const float2* const part = partial(p, b + f, item) + j + kT * c;
#pragma unroll
          for (int u = 0; u < kChunk; ++u) x[f][u] = __ldcg(part + kT * u);
        }
      }
#pragma unroll
      for (int f = 0; f < kInFlight; ++f) {
        if (b + f <= b1) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const float2 y = b + f == me ? s[c + u] : x[f][u];
            sum[u] = b + f == b0 ? y : make_float2(sum[u].x + y.x, sum[u].y + y.y);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) s[c + u] = sum[u];
  }
}

// Built with -DOFDM_SPREAD_TRACE (tools/spread_trace.py), thread 0 of each
// block stamps %globaltimer into spread_trace [blocks][64][8] for each of
// its first 64 rows: 0 the row's start, 1 its copy landed and the block's
// barrier passed, 2 its FFT done, 3 its multiply-add done, 4 (a row that
// ends a symbol) the symbol handed in or stored.
#ifdef OFDM_SPREAD_TRACE
static __device__ long long* spread_trace;
__device__ __forceinline__ void stamp(int b, int i, int k, int j) {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (j == 0 && spread_trace != nullptr && i < 64) spread_trace[(b * 64 + i) * 8 + k] = now;
}
#define OFDM_STAMP(k) stamp(b, i, k, j)
#else
#define OFDM_STAMP(k)
#endif

// The block's rows: FFT, Y conj(h) (kConjugate) or Y hc, the sum over each
// symbol's antennas, and store(item, s, g, j) of every symbol this block
// ends (register m of s holds bin j + kT m of the sum, unscaled, and of g
// the gain array's entry of that bin: inv, or hsqrd).
template <typename E, bool kAligned, bool kConjugate, typename Store>
__device__ __forceinline__ void spread_rows(const Args& p, Store store) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float2* const tw1 = reinterpret_cast<float2*>(smem);
  float2* const pw = tw1 + Geo::kTw1;
  int* const flag = reinterpret_cast<int*>(smem + kFlagOffset);
  const wfft::Team<kT> team;
  const int j = team.j;
  const int b = blockIdx.x;
  const int lo = static_cast<int>(block_lo(p.rows, p.blocks, b));
  const int n = static_cast<int>(block_lo(p.rows, p.blocks, b + 1)) - lo;
  const E* const y_re = static_cast<const E*>(p.y_re);
  const E* const y_im = static_cast<const E*>(p.y_im);
  auto buf = [&](int i) { return smem + kBufOffset + (i & 1) * 2 * kPlane; };

  // Row g -> its symbol, antenna, sample offset and h row.
  struct Row {
    int item, a;
    long long off, hrow;
  };
  auto row_of = [&](int g) {
    Row r;
    r.item = g / p.A;
    r.a = g - r.item * p.A;
    const int k = r.item / p.S;
    r.off = k * p.stride_k + static_cast<long long>(r.item - k * p.S) * p.stride_s +
            r.a * p.stride_a;
    r.hrow = (static_cast<long long>(k) * p.A + r.a) * kF;
    return r;
  };
  // Row i into its buffer.
  auto stage = [&](int i) {
    const Row r = row_of(lo + i);
    wfft::stage_row<kF, E, kAligned>(buf(i), y_re + r.off, y_im + r.off, j);
    wfft::cp_async_commit();
  };

  stage(0);
  for (int i = threadIdx.x; i < Geo::kTw1; i += kT) tw1[i] = p.tw[i];
  for (int i = threadIdx.x; i < kPowers * kNs; i += kT) {
    pw[i] = p.tw[Geo::kTw1 + (1 << (i / kNs)) * kNs + i % kNs];
  }

  float2 s[kM];
  for (int i = 0; i < n; ++i) {
    OFDM_STAMP(0);
    if (i + 1 < n) {
      stage(i + 1);
      wfft::cp_async_wait<1>();
    } else {
      wfft::cp_async_wait<0>();
    }
    __syncthreads();  // row i (and at i = 0 the twiddles) have landed for every thread
    OFDM_STAMP(1);
    const Row r = row_of(lo + i);
    const bool ends = i == n - 1 || r.a == p.A - 1;  // the block ends symbol r.item
    const int first_row = r.item * p.A;
    const bool split = first_row < lo || first_row + p.A > lo + n;  // its rows span blocks
    unsigned seen = 0;  // the symbol's count, read while the row is transformed
    if (ends && split && j == 0) {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(p.counters + r.item));
    }
    float2 v[kM];
    row_fft<E>(v, buf(i), tw1, pw, p.h_re + r.hrow, p.h_im + r.hrow, team);
    wfft::cp_async_wait<0>();
    team.sync();  // h's row has landed for every thread
    const float* const hr = buf(i) + j;
    const float* const hi = buf(i) + kPlane + j;
    OFDM_STAMP(2);
    // As a branch, not a select: with h read from L2 the select let the
    // compiler move h's loads up into the last pass, a slower kernel on the
    // H100.
    if (i == 0 || r.a == 0) {  // the symbol's first row in the block sets the sums
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        s[m] = mac<kConjugate>(v[m], make_float2(hr[kT * m], hi[kT * m]));
      }
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const float2 x = mac<kConjugate>(v[m], make_float2(hr[kT * m], hi[kT * m]));
        s[m] = make_float2(s[m].x + x.x, s[m].y + x.y);
      }
    }
    OFDM_STAMP(3);
    if (ends) {
      // The gains of the symbol's store, read beside the partials.
      const float* const gain = p.gain + static_cast<long long>(r.item / p.S) * p.gain_stride + j;
      float g[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) g[m] = __ldg(gain + kT * m);
      bool mine = true;
      if (split) {
        const int b0 = block_of(p.rows, p.blocks, first_row);
        const int b1 = block_of(p.rows, p.blocks, first_row + p.A - 1);
        unsigned* const count = p.counters + r.item;
        if (j == 0) {  // had every other block of the symbol counted in?
          const bool all = seen == static_cast<unsigned>(b1 - b0);
          if (all) __threadfence();  // their partials after the count
          *flag = all;
        }
        team.sync();
        mine = *flag;
        if (!mine) {  // hand in the block's partial and count in
          float2* const part = partial(p, b, r.item) + j;
#pragma unroll
          for (int m = 0; m < kM; ++m) __stcg(part + kT * m, s[m]);
          team.sync();  // the partial is written
          if (j == 0) {
            __threadfence();  // the partial before the count
            const bool last = atomicAdd(count, 1u) == static_cast<unsigned>(b1 - b0);
            if (last) __threadfence();  // the others' partials after the count
            *flag = last;
          }
          team.sync();
          mine = *flag;
        }
        if (mine) {
          if (j == 0) *count = 0u;  // every block has counted: 0 for the next launch
          add_partials(p, r.item, b0, b1, b, s, j);
        }
      }
      if (mine) store(r.item, s, g, j);
      OFDM_STAMP(4);
    }
    team.sync();  // buffer i is free for row i + 2
  }
}

// Launch of kernel over the plan's blocks.
template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& p, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, kT, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace spread
}  // namespace ofdm
