// K5: per-row 256-bin histogram of a (B, n) uint8 symbol stack.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/entropy/kernel.py::symbol_histogram_pallas
// (the symbolize step of the device entropy codec, core/entropy.py): the
// (B, 256) int32 counts are the only data that crosses to the host before
// the bit packing, which builds the code tables from them.
//
// The TPU kernel compared each chunk of symbols against a broadcast iota
// of the 256 bins and summed, because the TPU has no fast scatter-add; it
// needed the row padded to its chunk and bin 0 corrected afterwards.
// Here every CTA counts a strided share of one row into shared-memory
// bins and adds its totals to the row's global counts with one atomicAdd
// per non-zero bin.  Integer adds make the result exact and independent
// of the order of the CTAs.  Any n is taken: the row's unaligned head and
// tail (fewer than 16 bytes each) are counted byte by byte.
//
// Contention: residuals are small, so almost every symbol of a real field
// is 0, 1, 2 or 3 (zigzag of 0, -1, 1, -2).  One shared bin set per CTA
// would serialise eight warps on the same words, and even one set per
// warp would serialise the 32 lanes of a warp on bin 0.  So each warp has
// its own 256-bin copy (8 warps x 1 KB), the four most frequent symbols
// are counted in registers by compare-and-add (no atomics at all) and
// reduced over the warp once at the end, and only symbols >= 4 take a
// shared atomic into the warp's copy.
//
// What bounds it on the H100: bytes.  It reads each symbol once (16-byte
// loads, neighbouring lanes on neighbouring addresses) and writes 1 KB
// per row; the register path spends about 5 integer operations per byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // == kBins: one bin per thread in the fold
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kVecPerThread = 4;         // 16-byte loads per thread (grid sizing)

struct Small {
  unsigned c0, c1, c2, c3;
};

__device__ __forceinline__ void count(unsigned b, unsigned* wbins,
                                      Small& c) {
  c.c0 += (b == 0u);
  c.c1 += (b == 1u);
  c.c2 += (b == 2u);
  c.c3 += (b == 3u);
  if (b >= 4u) atomicAdd(&wbins[b], 1u);
}

__device__ __forceinline__ void count_word(unsigned w, unsigned* wbins,
                                           Small& c) {
#pragma unroll
  for (int k = 0; k < 4; ++k) count((w >> (8 * k)) & 0xFFu, wbins, c);
}

__global__ void symbol_histogram_kernel(const uint8_t* __restrict__ sym,
                                        int64_t n, int* __restrict__ hist) {
  __shared__ unsigned bins[kWarps][kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&bins[0][0])[i] = 0u;
  __syncthreads();

  unsigned* wbins = bins[threadIdx.x >> 5];
  const uint8_t* row = sym + (int64_t)blockIdx.y * n;
  // bytes before the first 16-byte boundary, the aligned middle in
  // 16-byte words, and the tail after it
  int64_t head = (int64_t)((16u - ((uintptr_t)row & 15u)) & 15u);
  head = head < n ? head : n;
  const int64_t nvec = (n - head) >> 4;
  const int64_t tail0 = head + (nvec << 4);
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);

  Small c = {0u, 0u, 0u, 0u};
  for (int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * kThreads) {
    const uint4 w = __ldg(vec + v);
    count_word(w.x, wbins, c);
    count_word(w.y, wbins, c);
    count_word(w.z, wbins, c);
    count_word(w.w, wbins, c);
  }
  if (blockIdx.x == 0 && threadIdx.x < 16) {
    if (threadIdx.x < head) count(row[threadIdx.x], wbins, c);
    if (tail0 + threadIdx.x < n) count(row[tail0 + threadIdx.x], wbins, c);
  }

  // the register counts of the warp go to its own copy of bins 0..3,
  // which no lane touches by atomics
  const unsigned s0 = __reduce_add_sync(0xFFFFFFFFu, c.c0);
  const unsigned s1 = __reduce_add_sync(0xFFFFFFFFu, c.c1);
  const unsigned s2 = __reduce_add_sync(0xFFFFFFFFu, c.c2);
  const unsigned s3 = __reduce_add_sync(0xFFFFFFFFu, c.c3);
  if ((threadIdx.x & 31) == 0) {
    wbins[0] = s0;
    wbins[1] = s1;
    wbins[2] = s2;
    wbins[3] = s3;
  }
  __syncthreads();

  // fold the warp copies; one global atomic per non-zero bin
  const int b = threadIdx.x;
  unsigned s = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += bins[w][b];
  if (s) atomicAdd(hist + (int64_t)blockIdx.y * kBins + b, (int)s);
}

}  // namespace

// sym: contiguous (B, n) uint8, 1 <= B <= 65535, 1 <= n < 2^31;
// hist: contiguous (B, 256) int32, zeroed by the caller.  Returns the
// launch's cudaError_t.
extern "C" int symbol_histogram(const uint8_t* sym, int B, int64_t n,
                                int* hist, void* stream) {
  const int64_t per_cta = (int64_t)kThreads * kVecPerThread;
  int64_t ctas = (n / 16 + per_cta - 1) / per_cta;
  ctas = ctas < 1 ? 1 : (ctas > 65535 ? 65535 : ctas);
  const dim3 grid((unsigned)ctas, (unsigned)B);
  symbol_histogram_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sym, n, hist);
  return (int)cudaGetLastError();
}
