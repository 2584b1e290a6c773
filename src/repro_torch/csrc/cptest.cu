// K2: exact SoS face-crossing predicate with the vertex gather fused in.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/cptest/kernel.py::face_crossed_pallas
// (wrapper ops.face_crossed_batch) together with the gather
// ur_flat[verts] / vr_flat[verts] that fed it in the verify rounds
// (pipeline.UnitFns._face_subset).  For face f with global vertex ids
// (a, b, c) it returns whether the origin lies in conv{w_a, w_b, w_c},
// w = (u, v), under Simulation of Simplicity: the three pairwise
// determinant signs det(a,b), det(b,c), det(c,a), each resolved on a
// zero by the tie-break cascade of core/sos.py (+Bv, -Bu, -Av, +Au, -1
// for index(A) < index(B), negated and swapped otherwise), must agree.
//
// Arithmetic bound: the values are refixed reconstructions,
// |v| <= 2^29 + tau <= 2^30 (fixedpoint.py keeps |value * scale| below
// 2^29 and the error bound tau is below that), so each product is below
// 2^60 and each determinant below 2^61 in magnitude: exact in int64.
// The TPU kernel needed 10-bit limbs because the TPU has no int64 unit;
// here one 64-bit multiply pair per determinant does it.
//
// What bounds it on the H100: bytes and gather latency.  Per face it
// reads three int64 ids (24 B) and gathers six int64 values at scattered
// addresses (48 B, mostly L2 hits: the faces of one verify round touch a
// band around the zero set), and writes one byte.  One thread per face,
// no shared memory; the const __restrict__ gathers go through the
// read-only cache.
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

__global__ void face_crossed_kernel(const int64_t* __restrict__ u,
                                    const int64_t* __restrict__ v,
                                    const int64_t* __restrict__ verts,
                                    bool* __restrict__ out, int64_t n) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int64_t a = verts[3 * f];
  const int64_t b = verts[3 * f + 1];
  const int64_t c = verts[3 * f + 2];
  const int64_t au = u[a], av = v[a];
  const int64_t bu = u[b], bv = v[b];
  const int64_t cu = u[c], cv = v[c];
  const int s1 = sign_det_sos(au, av, a, bu, bv, b);
  const int s2 = sign_det_sos(bu, bv, b, cu, cv, c);
  const int s3 = sign_det_sos(cu, cv, c, au, av, a);
  out[f] = (s1 == s2) && (s2 == s3);
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
