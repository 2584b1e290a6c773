// K5: per-row 256-bin histogram of a (B, n) uint8 symbol stack, in one
// persistent launch.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/entropy/kernel.py::symbol_histogram_pallas
// (the symbolize step of the device entropy codec, core/entropy.py): the
// (B, 256) int32 counts are the only data that crosses to the host before
// the bit packing, which builds the code tables from them.
//
// The TPU kernel compared each chunk of symbols against a broadcast iota
// of the 256 bins and summed, because the TPU has no fast scatter-add.
// What bounds it on the H100: bytes.  It reads each symbol once (16-byte
// loads, neighbouring lanes on neighbouring addresses) and writes 1 KB
// per row.  The design keeps the per-symbol work and the fixed per-CTA
// cost below the time of those reads:
//
// * A grid sized to the card, not to the data.  One wave of at most two
//   resident CTAs an SM is split over the rows; each thread walks its row
//   in a grid-stride loop with kUnroll 16-byte loads in flight.  Zeroing
//   and folding the shared bins is paid once per CTA (on the card, three
//   CTAs an SM cost more in that fixed part than they gained).
// * Symbols counted four to a 32-bit word.  Residuals are small, so
//   almost every symbol of a real field is 0..4 (zigzag of -2..2; in a
//   vortex-street field at the default bound 99.9 % of them, 2.3 % are
//   4).  Three operations tell whether a word holds a symbol >= 5; the
//   lanes of symbols 1..4 are counted as byte-lane masks (one LOP3 or
//   shift-and each) added into four registers and summed with __dp4a
//   before a lane can carry: about 12 integer operations a word.  Only symbols >= 5 take a shared atomic,
//   into the warp's own 256-bin copy, so few warps diverge.  Symbol 0 is
//   never counted: bin 0 is n minus the other 255 bins.
// * Finished in the same launch.  Each CTA adds its non-zero bins 1..255
//   to a per-row accumulator with one global atomic each, and the last
//   CTA of a row (per-row ticket after a __threadfence) moves the row's
//   accumulator into hist, zeroing it, and writes bin 0.  The
//   accumulator and tickets are a workspace the wrapper keeps zeroed per
//   device and stream; the kernel leaves them zeroed, so no fill launch
//   precedes it.  Integer adds make the counts independent of CTA order.
// * Any n and row alignment: the row's unaligned head and tail (fewer
//   than 16 bytes each) are counted byte by byte by the row's first CTA.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kCtasPerSm = 2;            // grid: at most this many an SM
constexpr int kUnroll = 4;               // 16-byte loads in flight per thread
constexpr int kFoldEvery = 15;           // trips: 15 * 4 * 4 < 256 a lane
constexpr int kSmall = 5;                // symbols 0..4 counted in registers
constexpr unsigned kLanes = 0x01010101u;

struct Acc {
  unsigned a[kSmall - 1];                // byte-lane counts of symbols 1..4
  unsigned c[kSmall - 1];                // their folded totals
};

__device__ __forceinline__ void count_word(unsigned w, unsigned* wbins,
                                           Acc& c) {
  // a lane has one of bits 3..7 set iff it holds a symbol >= 5 (lane + 3 >= 8,
  // or its bit 7 is set; the add cannot carry into the next lane)
  const unsigned hi = (((w & 0x7F7F7F7Fu) + 0x03030303u) | w) & 0xF8F8F8F8u;
  if (hi) {
    // 0x80 in each such lane
    const unsigned big =
        (((hi & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | hi) & 0x80808080u;
    for (unsigned m = big; m; m &= m - 1u)
      atomicAdd(&wbins[(w >> ((__ffs(m) - 1) & ~7)) & 0xFFu], 1u);
    w &= ~((big >> 7) * 0xFFu);          // those lanes now read as symbol 0
  }
  // lanes hold 0..4: bits 0 and 1 tell 1, 2, 3 apart, bit 2 is 4
  const unsigned t = w >> 1;
  c.a[0] += w & ~t & kLanes;
  c.a[1] += ~w & t & kLanes;
  c.a[2] += w & t & kLanes;
  c.a[3] += (w >> 2) & kLanes;
}

__device__ __forceinline__ void fold(Acc& c) {
#pragma unroll
  for (int v = 0; v < kSmall - 1; ++v) {
    c.c[v] = __dp4a(c.a[v], kLanes, c.c[v]);
    c.a[v] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
symbol_histogram_kernel(const uint8_t* __restrict__ sym, int64_t n,
                        int* __restrict__ hist, unsigned* __restrict__ acc,
                        unsigned* __restrict__ ticket) {
  __shared__ unsigned bins[kWarps][kBins];
  __shared__ unsigned part[kWarps];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&bins[0][0])[i] = 0u;
  __syncthreads();

  const int row_id = blockIdx.y;
  unsigned* wbins = bins[threadIdx.x >> 5];
  const uint8_t* row = sym + (int64_t)row_id * n;
  // bytes before the first 16-byte boundary, the aligned middle in
  // 16-byte words, and the tail after it
  int64_t head = (int64_t)((16u - ((uintptr_t)row & 15u)) & 15u);
  head = head < n ? head : n;
  const int64_t nvec = (n - head) >> 4;
  const int64_t tail0 = head + (nvec << 4);
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  Acc c = {};
  int trips = 0;
  for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < nvec;
       v += kUnroll * stride) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t vu = v + u * stride;
      w[u] = vu < nvec ? __ldg(vec + vu) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count_word(w[u].x, wbins, c);
      count_word(w[u].y, wbins, c);
      count_word(w[u].z, wbins, c);
      count_word(w[u].w, wbins, c);
    }
    if (++trips == kFoldEvery) {
      fold(c);
      trips = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 16) {
    if (threadIdx.x < head) count_word(row[threadIdx.x], wbins, c);
    if (tail0 + threadIdx.x < n) count_word(row[tail0 + threadIdx.x], wbins, c);
  }
  fold(c);

  // bins 1..4 of each warp copy take the warp's register counts (no
  // atomic touches them); fold the copies; one global atomic per
  // non-zero bin 1..255
#pragma unroll
  for (int v = 0; v < kSmall - 1; ++v) {
    const unsigned sv = __reduce_add_sync(0xFFFFFFFFu, c.c[v]);
    if ((threadIdx.x & 31) == 0) wbins[v + 1] = sv;
  }
  __syncthreads();
  unsigned* racc = acc + (int64_t)row_id * kBins;
  const int b = threadIdx.x;
  if (b > 0 && b < kBins) {
    unsigned s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += bins[w][b];
    if (s) atomicAdd(racc + b, s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket + row_id, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the row's last CTA: accumulator -> hist (zeroing it), bin 0 = n - rest
  __threadfence();
  unsigned s = 0u;
  if (b > 0 && b < kBins) {
    s = atomicExch(racc + b, 0u);
    hist[(int64_t)row_id * kBins + b] = (int)s;
  }
  s = __reduce_add_sync(0xFFFFFFFFu, s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned rest = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) rest += part[w];
    hist[(int64_t)row_id * kBins] = (int)((uint64_t)n - rest);
    ticket[row_id] = 0u;
  }
}

}  // namespace

// sym: contiguous (B, n) uint8, 1 <= B <= 65535, 1 <= n < 2^31; hist:
// contiguous (B, 256) int32, written whole; work: B * 257 uint32 (the
// per-row accumulators, then the per-row tickets), zero on entry and on
// return.  Returns the launch's cudaError_t.
extern "C" int symbol_histogram(const uint8_t* sym, int B, int64_t n,
                                int* hist, unsigned* work, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, symbol_histogram_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // one wave over all rows, every SM busy, and no CTA without a load; at
  // most kCtasPerSm CTAs an SM (more add fixed cost, not bandwidth)
  per_sm = per_sm < kCtasPerSm ? per_sm : kCtasPerSm;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t per_row = (n / 16 + kThreads - 1) / kThreads;
  int64_t ctas = resident / B;
  ctas = ctas < per_row ? ctas : per_row;
  ctas = ctas < 1 ? 1 : ctas;
  const dim3 grid((unsigned)ctas, (unsigned)B);
  symbol_histogram_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sym, n, hist, work, work + (int64_t)B * kBins);
  return (int)cudaGetLastError();
}
