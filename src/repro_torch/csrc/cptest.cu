// K2: exact SoS face-crossing predicate, and the verify round built on it.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/cptest/kernel.py::face_crossed_pallas
// (wrapper ops.face_crossed_batch).  For face f with global vertex ids
// (a, b, c) the predicate says whether the origin lies in
// conv{w_a, w_b, w_c}, w = (u, v), under Simulation of Simplicity: the
// three pairwise determinant signs det(a,b), det(b,c), det(c,a), each
// resolved on a zero by the tie-break cascade of core/sos.py (+Bv, -Bu,
// -Av, +Au, -1 for index(A) < index(B), negated and swapped otherwise),
// must agree.
//
// Arithmetic bound: the values are refixed reconstructions,
// |v| <= 2^29 + tau <= 2^30 (fixedpoint.py keeps |value * scale| below
// 2^29 and the error bound tau is below that), so each product is below
// 2^60 and each determinant below 2^61 in magnitude: exact in int64.
// The TPU kernel needed 10-bit limbs because the TPU has no int64 unit;
// here one 64-bit multiply pair per determinant does it.
//
// Two entry points share the predicate:
//
// * face_crossed: the predicate of an explicit (N, 3) list of faces with
//   the vertex gather fused in -- what the Pallas kernel computes.  Off
//   the main path; the tests hold it against its plain version.
//
// * verify_faces: one verify round of the encoder's fixpoint
//   (core/pipeline.py::_verify_round), in one launch.  On the TPU this
//   was a sign-stability screen (or, after the first round, a touched-
//   face selection) in XLA ops, two host-side nonzero, a gather of the
//   selected faces' ids and original predicates, the Pallas predicate on
//   that subset, a compare and a scatter of the bad faces' vertices.
//   Here one launch selects, re-checks and forces every face of the
//   mesh, and no per-face temporary reaches device memory.
//
// What bounds verify_faces on the H100: bytes.  Compulsory are the four
// int64 vertex arrays (screen mode), the face list once, the original
// predicate of the selected faces and the forced mask.  Per face the
// screen needs one bit pattern of each of its three vertices, and every
// vertex is in about 20 faces spread over 14 segments of the tables, so
// a kernel that gathers the values per face moves each value through L1
// and L2 about 20 times and waits on those gathers.  The design:
//
// * A CTA owns a block of the plane, R rows by C columns, for a run of
//   kFrames frames.  It first reads the four values of every vertex of
//   the block (plus the row below it and the column right of it, where
//   its faces end) in the run's frames (plus the frame after it) with
//   coalesced loads, a warp a row, and keeps one byte a vertex in shared
//   memory: the screen's four sign bits (u > 0 in both fields, u < 0 in
//   both, the same for v), or in the incremental mode the delta byte.
// * It then walks the faces whose first vertex lies in its block: the
//   mesh lists every face once, sorted by the plane position of its
//   first vertex, as int32 (index, three local ids), with the first
//   record of each position (core/grid.py::face_walk), so a block's
//   faces are one contiguous range a row and every vertex of them is
//   staged.  A thread takes a face, reads its record once and tests it
//   in every frame of the run from three shared-memory bytes.  Only a
//   selected face (a thin band around the zero set) gathers its six
//   values from device memory, evaluates the SoS predicate and reads its
//   original predicate.
// * A face whose predicate flipped writes true into forced at its three
//   vertices (several writers of one byte all write true: no atomics)
//   and counts in a register; the counts meet in one warp reduction and
//   one atomic a CTA, and the last CTA (ticket after a fence) moves the
//   sum into the output and leaves the two-word workspace zeroed, so no
//   fill launch precedes the kernel.
// * R and C are picked on the host: C is the whole width up to kMaxCols
//   columns, else the width split evenly into blocks of at most that, so
//   any width fits the 48 KB of shared memory a CTA gets without
//   opting in; R is four, halved while the grid has fewer than four CTAs
//   an SM.  The row, column and frame a CTA stages beyond its own are
//   re-read by its neighbours, mostly from L2.
// * Unit axis (verify_faces_units, the tiled pipeline): B same-shape tile
//   extensions, each with its own fields, delta, original predicates and
//   forced mask, go through one launch.  The CTAs of unit b are the
//   whole-field grid of that unit, offset by b; every unit walks the same
//   face records (one table per extension shape), and the bad faces of
//   all units meet in one sum, which is all the encoder reads.  The
//   whole-field entry is the case B = 1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int sgn(int64_t x) { return (x > 0) - (x < 0); }

// SoS tie-break for det(A, B) == 0, index(A) < index(B)
__device__ __forceinline__ int tiebreak(int64_t au, int64_t av, int64_t bu,
                                        int64_t bv) {
  int s = sgn(bv);
  if (s) return s;
  s = -sgn(bu);
  if (s) return s;
  s = -sgn(av);
  if (s) return s;
  s = sgn(au);
  if (s) return s;
  return -1;
}

__device__ __forceinline__ int sign_det_sos(int64_t au, int64_t av, int64_t ma,
                                            int64_t bu, int64_t bv,
                                            int64_t mb) {
  const int s = sgn(au * bv - av * bu);
  if (s) return s;
  return ma < mb ? tiebreak(au, av, bu, bv) : -tiebreak(bu, bv, au, av);
}

__device__ __forceinline__ bool crossed(int64_t au, int64_t av, int64_t a,
                                        int64_t bu, int64_t bv, int64_t b,
                                        int64_t cu, int64_t cv, int64_t c) {
  const int s1 = sign_det_sos(au, av, a, bu, bv, b);
  const int s2 = sign_det_sos(bu, bv, b, cu, cv, c);
  const int s3 = sign_det_sos(cu, cv, c, au, av, a);
  return (s1 == s2) && (s2 == s3);
}

__global__ void face_crossed_kernel(const int64_t* __restrict__ u,
                                    const int64_t* __restrict__ v,
                                    const int64_t* __restrict__ verts,
                                    bool* __restrict__ out, int64_t n) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int64_t a = verts[3 * f];
  const int64_t b = verts[3 * f + 1];
  const int64_t c = verts[3 * f + 2];
  out[f] = crossed(u[a], v[a], a, u[b], v[b], b, u[c], v[c], c);
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 8;               // frames a CTA's run covers
constexpr int kMaxRows = 4;              // rows a CTA's block covers, at most
constexpr int kMaxCols = 1024;           // columns a CTA's block covers, at most
constexpr int kCtasPerSm = 4;            // R shrinks until the grid has these
static_assert((kFrames + 1) * (kMaxRows + 1) * (kMaxCols + 1) +
                      4 * (kWarps + 2 * kMaxRows + 1) <= 48 * 1024,
              "the staged block must fit without the shared-memory opt-in");

// bit 0: strictly positive in both fields, bit 1: strictly negative in both
__device__ __forceinline__ unsigned keeps_sign(int64_t o, int64_t r) {
  return (unsigned)((o > 0) & (r > 0)) | ((unsigned)((o < 0) & (r < 0)) << 1);
}

// Byte of local id y (plane * hw + position) in the run's first staged
// frame, for a face whose first vertex lies in plane row `row` (staged row
// r, position `row` * W the row's first); the face's vertices lie in that
// row or the next and in the first vertex's column or the next.
__device__ __forceinline__ int staged_at(int y, int hw, int row0, int W,
                                         int j0, int r, int pitch,
                                         int plane) {
  const int up = y >= hw;
  const int pos = y - up * hw;
  const int down = pos >= row0 + W;
  return up * plane + (r + down) * pitch + pos - row0 - down * W - j0;
}

#define K2_PARAMS                                                         \
  const int64_t *__restrict__ ur, const int64_t *__restrict__ vr,         \
      const int64_t *__restrict__ uo, const int64_t *__restrict__ vo,     \
      const bool *__restrict__ delta, const int4 *__restrict__ faces,     \
      const int *__restrict__ face_start, int fs, int fb,                 \
      const bool *__restrict__ slice0, const bool *__restrict__ slab0,    \
      int T, int H, int W, int rows, int cols, int n_bands, int n_blocks, \
      int per_unit, bool *__restrict__ forced,                            \
      unsigned long long *__restrict__ work, int64_t *__restrict__ out
#define K2_ARGS                                                          \
  ur, vr, uo, vo, delta, faces, face_start, fs, fb, slice0, slab0, T, H, \
      W, rows, cols, n_bands, n_blocks, per_unit, forced, work, out

__device__ __forceinline__ void verify_faces_body(K2_PARAMS) {
  extern __shared__ unsigned char staged[];  // [kFrames+1][rows+1][cols+1]
  __shared__ unsigned part[kWarps];
  __shared__ int seg_first[kMaxRows], seg_end[kMaxRows + 1];
  const int unit = blockIdx.x / per_unit;
  const int cta = blockIdx.x % per_unit;
  const int blk = cta % n_blocks;
  const int band = cta / n_blocks % n_bands;
  const int t0 = cta / n_blocks / n_bands * kFrames;
  const int i0 = band * rows, j0 = blk * cols;
  const int hw = H * W;                    // 2 H W < 2^31 (host check)
  {  // unit `unit`'s fields, masks and predicates
    const int64_t f0 = (int64_t)unit * T * hw;
    ur += f0;
    vr += f0;
    if (uo != nullptr) uo += f0;
    if (vo != nullptr) vo += f0;
    if (delta != nullptr) delta += f0;
    forced += f0;
    slice0 += (int64_t)unit * T * fs;
    slab0 += (int64_t)unit * (T - 1) * fb;
  }
  const int pitch = cols + 1;
  const int plane = (rows + 1) * pitch;    // staged bytes a frame
  const int st_rows = min(rows + 1, H - i0);
  const int st_cols = min(cols + 1, W - j0);
  const int n_planes = min(kFrames + 1, T - t0);
  const int n_rows = min(rows, H - i0);    // rows whose faces are walked
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int q = warp; q < n_planes * st_rows; q += kWarps) {
    const int p = q / st_rows, r = q - p * st_rows;
    const int64_t base = (int64_t)(t0 + p) * hw + (i0 + r) * W + j0;
    unsigned char* dst = staged + p * plane + r * pitch;
    if (delta != nullptr) {
      for (int c = lane; c < st_cols; c += 32)
        dst[c] = (unsigned char)delta[base + c];
    } else {
      for (int c = lane; c < st_cols; c += 32)
        dst[c] = (unsigned char)(keeps_sign(uo[base + c], ur[base + c]) |
                                 keeps_sign(vo[base + c], vr[base + c]) << 2);
    }
  }
  // the block's faces: row r's records are face_start[row + j0] up to
  // face_start[row + j1]; seg_end[r] counts the records of rows before r
  if (threadIdx.x == 0) {
    const int j1 = min(j0 + cols, W);
    int n = 0;
    seg_end[0] = 0;
    for (int r = 0; r < n_rows; ++r) {
      const int row0 = (i0 + r) * W;
      seg_first[r] = face_start[row0 + j0];
      n += face_start[row0 + j1] - seg_first[r];
      seg_end[r + 1] = n;
    }
  }
  __syncthreads();

  const int n_faces_here = seg_end[n_rows];
  int r = 0;
  unsigned bad = 0u;
  for (int k = threadIdx.x; k < n_faces_here; k += kThreads) {
    while (k >= seg_end[r + 1]) ++r;
    const int4 face = faces[seg_first[r] + k - seg_end[r]];
    const int row0 = (i0 + r) * W;
    const bool slab = face.x >= fs;
    const int64_t n_faces = slab ? fb : fs;
    const bool* orig = slab ? slab0 + (face.x - fs) : slice0 + face.x;
    const int sa = staged_at(face.y, hw, row0, W, j0, r, pitch, plane);
    const int sb = staged_at(face.z, hw, row0, W, j0, r, pitch, plane);
    const int sc = staged_at(face.w, hw, row0, W, j0, r, pitch, plane);
    const int t_end = min(t0 + kFrames, slab ? T - 1 : T);
    for (int t = t0; t < t_end; ++t) {
      const unsigned char* s = staged + (t - t0) * plane;
      const unsigned ma = s[sa], mb = s[sb], mc = s[sc];
      if (delta != nullptr ? !(ma | mb | mc) : (ma & mb & mc)) continue;
      const int64_t a = face.y + (int64_t)t * hw, b = face.z + (int64_t)t * hw,
                    c = face.w + (int64_t)t * hw;
      if (crossed(ur[a], vr[a], a, ur[b], vr[b], b, ur[c], vr[c], c) !=
          orig[t * n_faces]) {
        forced[a] = true;
        forced[b] = true;
        forced[c] = true;
        ++bad;
      }
    }
  }

  bad = __reduce_add_sync(0xFFFFFFFFu, bad);
  if (lane == 0) part[warp] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sum = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w];
    if (sum) atomicAdd(work, (unsigned long long)sum);
    __threadfence();
    if (atomicAdd(work + 1, 1ull) == gridDim.x - 1) {
      __threadfence();
      *out = (int64_t)atomicExch(work, 0ull);
      work[1] = 0ull;
    }
  }
}

// the whole-field kernel and the unit-batched one (their own names in a
// profile)
__global__ void __launch_bounds__(kThreads)
verify_faces_kernel(K2_PARAMS) { verify_faces_body(K2_ARGS); }

__global__ void __launch_bounds__(kThreads)
verify_faces_units_kernel(K2_PARAMS) { verify_faces_body(K2_ARGS); }

int launch_verify(const int64_t* ur, const int64_t* vr, const int64_t* uo,
                  const int64_t* vo, const bool* delta, const int4* faces,
                  const int* face_start, int fs, int fb, const bool* slice0,
                  const bool* slab0, bool units, int B, int T, int H, int W,
                  bool* forced, unsigned long long* work, int64_t* out,
                  void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t runs = (T + kFrames - 1) / kFrames;
  const int n_blocks = (W + kMaxCols - 1) / kMaxCols;
  const int cols = (W + n_blocks - 1) / n_blocks;
  int rows = kMaxRows < H ? kMaxRows : H;
  while (rows > 1 && B * runs * ((H + rows - 1) / rows) * n_blocks <
                         (int64_t)kCtasPerSm * sms)
    rows /= 2;
  const int n_bands = (H + rows - 1) / rows;
  const int64_t per_unit = runs * n_bands * n_blocks;
  const int64_t ctas = B * per_unit;
  if (ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kFrames + 1) * (rows + 1) * (cols + 1);
  const auto kernel = units ? verify_faces_units_kernel : verify_faces_kernel;
  kernel<<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(
      ur, vr, uo, vo, delta, faces, face_start, fs, fb, slice0, slab0, T, H,
      W, rows, cols, n_bands, n_blocks, (int)per_unit, forced, work, out);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v: flat int64 vertex values; verts: (n, 3) int64 global vertex ids,
// every id < len(u); out: (n,) bool.  Returns the launch's cudaError_t.
extern "C" int face_crossed(const int64_t* u, const int64_t* v,
                            const int64_t* verts, bool* out, int64_t n,
                            void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  face_crossed_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      u, v, verts, out, n);
  return (int)cudaGetLastError();
}

// ur, vr (and uo, vo unless delta is given): contiguous (T, H, W) int64
// with T >= 1 and 2 H W < 2^31; delta: (T, H, W) bool or null (null: the
// screen); faces: fs + fb int32 records (index, three local ids) of every
// slice face (index < fs, ids in [0, H W)) and slab face (index - fs its
// slab table row, ids in [0, 2 H W)), sorted by the plane position of
// their first vertex, each face's vertices in that vertex's row or the
// next and in its column or the next; face_start: H W + 1 int32, the
// first record of each plane position; slice0 (T, fs) bool, slab0
// (T - 1, fb) bool; forced (T, H, W) bool, updated in place; work: two
// uint64, zero on entry and on return; out: one int64, written whole.
// Always launches, also with no face (out is then 0).  Returns the
// launch's cudaError_t.
extern "C" int verify_faces(const int64_t* ur, const int64_t* vr,
                            const int64_t* uo, const int64_t* vo,
                            const bool* delta, const int4* faces,
                            const int* face_start, int fs, int fb,
                            const bool* slice0, const bool* slab0, int T,
                            int H, int W, bool* forced,
                            unsigned long long* work, int64_t* out,
                            void* stream) {
  return launch_verify(ur, vr, uo, vo, delta, faces, face_start, fs, fb,
                       slice0, slab0, false, 1, T, H, W, forced, work, out,
                       stream);
}

// verify_faces over B units in one launch: ur, vr (uo, vo), delta and
// forced contiguous (B, T, H, W), slice0 (B, T, fs), slab0 (B, T - 1, fb);
// out gets the bad faces of all units.
extern "C" int verify_faces_units(const int64_t* ur, const int64_t* vr,
                                  const int64_t* uo, const int64_t* vo,
                                  const bool* delta, const int4* faces,
                                  const int* face_start, int fs, int fb,
                                  const bool* slice0, const bool* slab0,
                                  int B, int T, int H, int W, bool* forced,
                                  unsigned long long* work, int64_t* out,
                                  void* stream) {
  return launch_verify(ur, vr, uo, vo, delta, faces, face_start, fs, fb,
                       slice0, slab0, true, B, T, H, W, forced, work, out,
                       stream);
}
