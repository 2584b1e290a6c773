// K6: canonical Huffman decode of one symbol section of a CPTH1
// container (the device entropy codec, core/entropy.py), on the card.
//
// Replaces no TPU kernel: the JAX package decodes these sections on the
// host (repro/core/encode.py::huffman_decode), and so did the port.  It
// was added because that host decode took 79-81 % of a whole-field read
// of a 64x512x512 chunk (2 x 16.8 M symbols at 5.8-7.7 M symbols/s),
// with the card idle.  Its symbols equal the host decode's on every
// input, valid or not (core/entropy.py::decode_symbols holds the rules
// for a stream that ends early).
//
// What bounds it on the H100: not bytes.  A 16.8 M-symbol stream reads
// ~4 MB and writes 16.8 MB (~6 us at 3.35 TB/s), but each codeword's
// start depends on the previous codeword's length: a chain of dependent
// table lookups.  The format has no index of codeword starts, so the
// design makes the chain parallel (self-synchronisation, as in
// Weissenberger and Schmidt, "Massively Parallel Huffman Decoding on
// GPUs", ICPP 2018), with a bounded amount of work on any input:
//
// 1. Split.  The stream is cut into subsequences of kSubBits bits.  The
//    first codeword that starts in subsequence t starts within
//    kEntries = L_MAX bits of its start, so a subsequence has at most 16
//    possible entry offsets.
// 2. Speculative decode.  One thread a (subsequence, entry offset)
//    decodes from there to the first codeword start past the
//    subsequence's end: the subsequence's transfer map, entry offset ->
//    (exit offset into the next subsequence, symbols decoded), or
//    "stuck" where the chain meets a window no code maps (an incomplete
//    code, or damaged data: the host decode then stays at that position
//    and repeats symbol 0).  Sixteen chains of ~67 steps a subsequence
//    cost 16 x the serial decode's lookups, spread over ~4 M threads.
// 3. Resynchronisation.  The maps compose (apply one, then the next; a
//    stuck entry stays stuck), so the true entry of every subsequence is
//    an exclusive scan of the maps applied to entry 0.  A block of 1,024
//    threads scans 64 maps (Hillis-Steele over 16 lanes a map) in shared
//    memory, fused into the speculative pass; further passes scan the
//    block composites (3 levels for a 32 M-bit stream), and a down pass
//    gives every subsequence its entry offset and its first symbol's
//    index.  Whatever the code, the work is bounded: a fixed-length code
//    that never resynchronises costs what any other does.
// 4. Final pass.  One thread a subsequence decodes from its true entry,
//    writing its symbols into shared memory at its offset; the block then
//    stores its contiguous range with coalesced writes.  A last pass
//    fills the symbols past the chain's end (the host decode's zero
//    padding, or symbol 0 after a stuck window) and reports the chain's
//    end (symbols before it, exit offset or stuck) for the host's rules.
//
// Decode tables (built on the host once a section: core/entropy.py::
// decode_tables): a 2^11-entry first-level table (symbol | length << 8,
// or a flag that a longer code starts with these bits) in shared memory;
// codes longer than 11 bits take the canonical compare with the first
// code and count of each length (at most 5 compares, rare).  The
// bitstream is read as big-endian 32-bit words with a funnel shift; a
// thread keeps the two words under its window in registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSubBits = 128;            // bits a subsequence (a multiple of 32)
constexpr int kEntries = 16;             // entry offsets a subsequence (L_MAX)
constexpr int kStuck = kEntries;         // the state of a chain that is stuck
constexpr int kGroup = 64;               // maps a scan block
constexpr int kScanThreads = kGroup * kEntries;
constexpr int kEmitThreads = 256;        // subsequences a final-pass block
constexpr int kFillThreads = 256;
constexpr int kMaxLen = 16;
constexpr int kPeekBits = 11;
constexpr int kPeek = 1 << kPeekBits;
constexpr unsigned kLong = 1u << 13;     // a longer code starts with the prefix
// int32 table layout, as core/entropy.py::decode_tables writes it
constexpr int kFirst = kPeek;            // first canonical code of length l
constexpr int kCount = kFirst + kMaxLen + 1;   // codes of length l
constexpr int kBase = kCount + kMaxLen + 1;    // their first index in kSorted
constexpr int kSorted = kBase + kMaxLen + 1;   // symbols in canonical order

// A map entry: symbols << 8 | state (an exit offset 0..15, or kStuck).
// Composition adds the symbols and takes the second map's state.
__device__ __forceinline__ int64_t then(int64_t a, const int64_t* next) {
  const int st = (int)(a & 0xFF);
  return st == kStuck ? a : (a & ~(int64_t)0xFF) + next[st];
}

struct Tables {
  uint16_t peek[kPeek];
  int first[kMaxLen + 1];
  int count[kMaxLen + 1];
  int base[kMaxLen + 1];
  uint8_t sorted[256];
};

__device__ void load_tables(Tables& s, const int* __restrict__ tab) {
  for (int i = threadIdx.x; i < kPeek; i += blockDim.x)
    s.peek[i] = (uint16_t)tab[i];
  for (int i = threadIdx.x; i <= kMaxLen; i += blockDim.x) {
    s.first[i] = tab[kFirst + i];
    s.count[i] = tab[kCount + i];
    s.base[i] = tab[kBase + i];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s.sorted[i] = (uint8_t)tab[kSorted + i];
  __syncthreads();
}

// symbol | length << 8 of the codeword that starts a 16-bit window;
// length 0 where no code maps the window (the host's peek table holds
// symbol 0, length 0 there)
__device__ __forceinline__ unsigned codeword(const Tables& s, unsigned w16) {
  unsigned e = s.peek[w16 >> (16 - kPeekBits)];
  if (e & kLong) {
    e = 0u;
    for (int l = kPeekBits + 1; l <= kMaxLen; ++l) {
      const unsigned d = (w16 >> (16 - l)) - (unsigned)s.first[l];
      if (d < (unsigned)s.count[l]) {
        e = s.sorted[s.base[l] + d] | ((unsigned)l << 8);
        break;
      }
    }
  }
  return e & 0x1FFFu;
}

__device__ __forceinline__ unsigned be_word(const uint32_t* w, int i) {
  return __byte_perm(__ldg(w + i), 0u, 0x0123);
}

// Decodes from bit p (relative to the subsequence's first word, words)
// while p < end; p moves at most 16 bits a step, so the word under the
// window advances by at most one.  Returns the symbols decoded; p ends
// at the first codeword start >= end, or at the stuck window.
template <class Emit>
__device__ __forceinline__ int walk(const Tables& s,
                                    const uint32_t* __restrict__ words,
                                    int& p, int end, bool& stuck, Emit emit) {
  int wi = p >> 5;
  unsigned hi = be_word(words, wi), lo = be_word(words, wi + 1);
  int c = 0;
  while (p < end) {
    if ((p >> 5) != wi) {
      ++wi;
      hi = lo;
      lo = be_word(words, wi + 1);
    }
    const unsigned e = codeword(s, __funnelshift_l(lo, hi, (unsigned)p) >> 16);
    const int len = (int)(e >> 8);
    if (len == 0) {
      stuck = true;
      break;
    }
    emit(c, (uint8_t)e);
    ++c;
    p += len;
  }
  return c;
}

// Inclusive Hillis-Steele scan of a block's kGroup maps (thread = map j,
// entry o): returns map j composed after maps 0..j-1 of the block.
__device__ int64_t scan_maps(int64_t (*buf)[kScanThreads], int64_t m) {
  const int j = threadIdx.x / kEntries;
  int cur = 0;
  buf[0][threadIdx.x] = m;
  __syncthreads();
  for (int d = 1; d < kGroup; d <<= 1) {
    if (j >= d)
      m = then(buf[cur][threadIdx.x - d * kEntries],
               &buf[cur][j * kEntries]);
    buf[cur ^ 1][threadIdx.x] = m;
    cur ^= 1;
    __syncthreads();
  }
  return m;
}

// phases 2 and the first level of 3: every (subsequence, entry offset)
// chain, then the block's prefix maps (in maps) and its composite (up)
__global__ void __launch_bounds__(kScanThreads)
huffman_spec_kernel(const uint32_t* __restrict__ words,
                    const int* __restrict__ tab, int64_t nbits, int64_t T,
                    int64_t* __restrict__ maps, int64_t* __restrict__ up) {
  __shared__ Tables s;
  __shared__ int64_t buf[2][kScanThreads];
  load_tables(s, tab);
  const int o = threadIdx.x % kEntries;
  const int64_t t = (int64_t)blockIdx.x * kGroup + threadIdx.x / kEntries;
  int64_t m = o;                         // identity past the last one
  if (t < T) {
    const int64_t left = nbits - t * kSubBits;
    const int end = left < kSubBits ? (int)left : kSubBits;
    int p = o;
    bool stuck = false;
    const int64_t c = walk(s, words + t * (kSubBits / 32), p, end, stuck,
                           [](int, uint8_t) {});
    m = (c << 8) | (stuck ? kStuck : p - end);
  }
  m = scan_maps(buf, m);
  if (t < T) maps[t * kEntries + o] = m;
  if (threadIdx.x / kEntries == kGroup - 1)
    up[(int64_t)blockIdx.x * kEntries + o] = m;
}

// the next levels of 3: the same scan over n block composites
__global__ void __launch_bounds__(kScanThreads)
huffman_scan_kernel(int64_t* __restrict__ maps, int64_t n,
                    int64_t* __restrict__ up) {
  __shared__ int64_t buf[2][kScanThreads];
  const int o = threadIdx.x % kEntries;
  const int64_t t = (int64_t)blockIdx.x * kGroup + threadIdx.x / kEntries;
  int64_t m = t < n ? maps[t * kEntries + o] : o;
  m = scan_maps(buf, m);
  if (t < n) maps[t * kEntries + o] = m;
  if (threadIdx.x / kEntries == kGroup - 1)
    up[(int64_t)blockIdx.x * kEntries + o] = m;
}

// the down pass: each element's entry (first symbol << 8 | entry offset
// or kStuck) from its group's entry (entry 0 at the top) and the prefix
// map of the elements before it in the group
__global__ void huffman_entries_kernel(const int64_t* __restrict__ maps,
                                       int64_t n,
                                       const int64_t* __restrict__ up_entries,
                                       int64_t* __restrict__ entries) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int64_t g = up_entries ? up_entries[t / kGroup] : 0;
  entries[t] = t % kGroup ? then(g, maps + (t - 1) * kEntries) : g;
}

// phase 4: each subsequence from its true entry, staged per block
__global__ void __launch_bounds__(kEmitThreads)
huffman_emit_kernel(const uint32_t* __restrict__ words,
                    const int* __restrict__ tab, int64_t nbits, int64_t T,
                    const int64_t* __restrict__ entries,
                    const int64_t* __restrict__ top, int64_t n,
                    uint8_t* __restrict__ out) {
  __shared__ Tables s;
  __shared__ uint8_t stage[kEmitThreads * kSubBits];
  const int64_t t0 = (int64_t)blockIdx.x * kEmitThreads;
  const int64_t first = entries[t0] >> 8;
  if (first >= n) return;                // the whole block
  const int64_t last = (t0 + kEmitThreads < T ? entries[t0 + kEmitThreads]
                                              : top[0]) >> 8;
  load_tables(s, tab);
  const int64_t t = t0 + threadIdx.x;
  if (t < T) {
    const int64_t e = entries[t];
    if ((e & 0xFF) != kStuck) {
      const int64_t left = nbits - t * kSubBits;
      const int end = left < kSubBits ? (int)left : kSubBits;
      int p = (int)(e & 0xFF);
      bool stuck = false;
      uint8_t* at = stage + ((e >> 8) - first);
      walk(s, words + t * (kSubBits / 32), p, end, stuck,
           [at](int c, uint8_t sym) { at[c] = sym; });
    }
  }
  __syncthreads();
  const int64_t stop = last < n ? last : n;
  for (int64_t i = first + threadIdx.x; i < stop; i += kEmitThreads)
    out[i] = stage[i - first];
}

// the symbols past the chain's end, and the chain's end for the host
__global__ void __launch_bounds__(kFillThreads)
huffman_fill_kernel(const int64_t* __restrict__ top, int64_t n, int fill,
                    uint8_t* __restrict__ out, int64_t* __restrict__ status) {
  const int64_t total = top[0] >> 8;
  const int state = (int)(top[0] & 0xFF);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[0] = total;
    status[1] = state;
  }
  const uint8_t f = state == kStuck ? 0 : (uint8_t)fill;
  const int64_t step = (int64_t)gridDim.x * kFillThreads;
  for (int64_t i = total + (int64_t)blockIdx.x * kFillThreads + threadIdx.x;
       i < n; i += step)
    out[i] = f;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// element counts of the scan levels: T, then block composites down to 1
int levels(int64_t nbits, int64_t* sizes) {
  int k = 0;
  sizes[0] = cdiv(nbits, kSubBits);
  if (sizes[0] == 0) return 0;
  do {
    sizes[k + 1] = cdiv(sizes[k], kGroup);
    ++k;
  } while (sizes[k] > 1);
  return k;
}

}  // namespace

// int64 workspace words huffman_decode needs for a stream of nbits bits
extern "C" int64_t huffman_workspace(int64_t nbits) {
  int64_t sizes[64];
  const int K = levels(nbits, sizes);
  int64_t w = 1;                         // the top map when T == 0
  for (int k = 0; k <= K; ++k) w += sizes[k] * (kEntries + 1);
  return w;
}

// words: the section's bytes, zero-padded to a multiple of 4 bytes and at
// least 8 bytes past nbits / 8, 4-byte aligned; tab: the int32 decode
// tables (kSorted + 256 entries); out: n uint8 symbols; status: 2 int64,
// the symbols before the chain's end and its state (exit offset past
// nbits, or 16: stuck); work: huffman_workspace(nbits) int64 words.
// Launches every pass on `stream`; returns the first cudaError_t.
extern "C" int huffman_decode(const uint32_t* words, const int* tab,
                              int64_t nbits, int64_t n, int fill,
                              uint8_t* out, int64_t* status, int64_t* work,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int64_t sizes[64];
  const int K = levels(nbits, sizes);
  const int64_t T = sizes[0];
  int64_t* maps[64];
  int64_t* entries[64];
  int64_t* at = work + 1;
  for (int k = 0; k <= K; ++k) {
    maps[k] = at;
    at += sizes[k] * kEntries;
    entries[k] = at;
    at += sizes[k];
  }
  const int64_t* top = work;
  cudaError_t err = cudaSuccess;
  if (T == 0) {
    err = cudaMemsetAsync(work, 0, sizeof(int64_t), st);
  } else {
    huffman_spec_kernel<<<(unsigned)cdiv(T, kGroup), kScanThreads, 0, st>>>(
        words, tab, nbits, T, maps[0], maps[1]);
    err = cudaGetLastError();
    for (int k = 1; k < K && err == cudaSuccess; ++k) {
      huffman_scan_kernel<<<(unsigned)cdiv(sizes[k], kGroup), kScanThreads,
                            0, st>>>(maps[k], sizes[k], maps[k + 1]);
      err = cudaGetLastError();
    }
    for (int k = K - 1; k >= 0 && err == cudaSuccess; --k) {
      huffman_entries_kernel<<<(unsigned)cdiv(sizes[k], 256), 256, 0, st>>>(
          maps[k], sizes[k], k == K - 1 ? nullptr : entries[k + 1],
          entries[k]);
      err = cudaGetLastError();
    }
    top = maps[K];
    if (err == cudaSuccess && n > 0) {
      huffman_emit_kernel<<<(unsigned)cdiv(T, kEmitThreads), kEmitThreads, 0,
                            st>>>(words, tab, nbits, T, entries[0], top, n,
                                  out);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = cdiv(n, kFillThreads * 16);
  blocks = blocks < 1 ? 1 : blocks > 1024 ? 1024 : blocks;
  huffman_fill_kernel<<<(unsigned)blocks, kFillThreads, 0, st>>>(
      top, n, fill, out, status);
  return (int)cudaGetLastError();
}
