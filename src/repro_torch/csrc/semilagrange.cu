// K3 and K4: the semi-Lagrangian stepper, in the three variants of the
// JAX package.  Build with -fmad=false.
//
// K3 (sl_decode) replaces the Pallas TPU kernel
//   src/repro/kernels/semilagrange/kernel.py::sl_predict_pallas
// as the JAX decoder calls it in its frame loop
// (src/repro/core/pipeline.py::_decode_fields_parallel): one persistent
// launch decodes every frame of a field, for the verify simulation and
// for decompress.  K4 (sl_step_batched) replaces
//   src/repro/kernels/semilagrange/kernel.py::sl_predict_batched_pallas
// (the same stepper over a (B, H, W) stack of independent frames): the
// encoder predicts frames 1..T-1 from frames 0..T-2 in one launch.
// sl_step, the stepper over one frame, is kept as a per-frame launch that
// the tests hold K4 against; it is not on the main path.  All three run
// the one __device__ function sl_pixel on the one sampling function
// bilinear2 under the same flags, so their integers are equal bit for bit
// by construction.
//
// The stepper maps frame t-1's base-grid integers (xu, xv) to frame t's
// integer predictions (pu, pv):
//   u = (R)xu * g2, v = (R)xv * g2
//   d_inf = max(|u| cx, |v| cy)
//   d_inf <= d_max: RK2 midpoint backtrace
//   otherwise:      n_sub = clip(ceil(d_inf / d_max), 1, n_max) clamped
//                   Euler substeps
//   p = rint(bilinear(u at the departure point) / g2)
//
// A container's header names the stepper that made its predictions
// (sl_backend), and each is instantiated here (the template argument S):
//   Numpy   f64, every operation rounded once, in the op order of the JAX
//           package's numpy stepper (backend._sl_predict_frame_np):
//           (0.5*v)*cy, (vs*cy)/n_sub, the bilinear sum left to right,
//           rint half to even.  The port writes it by default.
//   Xla     f64 in the same order, with the multiply-adds XLA:CPU
//           contracts: the RK2 points ii - v (0.5 cy) and ii - v_h cy one
//           fused multiply-add each, the bilinear sum
//           fma(w11, f11, fma(w10, f10, fma(w00, f00, w01 f01))), and
//           d_inf / d_max as d_inf * (1 / d_max).  The JAX package writes
//           it off the TPU.
//   Pallas  f32 with the same contractions: the Pallas kernel's body as
//           XLA:CPU compiles it in interpret mode (what the JAX package's
//           "pallas" stepper runs off the TPU; on a TPU its compiled
//           arithmetic, which no other machine reproduces).
// __fmaf_rn / __fma_rn stand at those sites and nowhere else; every other
// operation is rounded once (-fmad=false, IEEE division), so each variant
// equals its plain PyTorch version (core/predictors.py) bit for bit.  Each
// thread loops to its OWN n_sub: in the reference, iterations past a
// pixel's own count are masked identities, so no field-wide maximum is
// needed.
//
// What bounds it on the H100: not bytes.  A pixel reads 8 (RK2) or
// 8 * n_sub + 8 (substeps) scattered values of the previous frame, each
// sample dependent on the last, and spends most of its instructions on
// the real type (two correctly rounded divisions a substep, conversions,
// floors); a warp runs to its lanes' largest n_sub.  Both kernels stage
// the tile of the previous frame they step, plus a halo, in shared memory
// as the values x * g2 (the product the stepper samples, rounded once, so
// a staged sample equals a global one bit for bit).  A bilinear footprint
// inside the staged region reads shared memory; any other (a substep
// pixel, a departure point beyond the halo) reads global memory in the
// same kernel.
//
// The decoder's recurrence is sequential in time: frame t's SL blocks
// sample frame t-1 anywhere.  One cooperative launch walks all T frames;
// a pixel outside an SL block needs only its own value of frame t-1,
// which its thread keeps in registers, so only frames that hold an SL
// block cost a grid-wide barrier.
//
// sl_decode_units decodes B same-shape tile units in one cooperative
// launch (the tiled pipeline's verify simulation): the decode units of
// all B fields share the grid, each field has its own per-frame SL
// flags, and the grid meets before frame t when any field steps SL
// blocks in it (a field whose frame t is Lorenzo-only still adds its
// c2 there).  The whole-field entry is the case B = 1, compiled apart
// (kUnits false) so that it carries no field index arithmetic.
//
// Each extern "C" entry of K3 and K4 takes the variant (0 Numpy, 1 Xla,
// 2 Pallas: the order of core/predictors.SL_VARIANTS) and picks its kernel
// from a table in that order; each variant of a kernel has a __global__
// function of its own name (sl_decode_kernel, sl_decode_xla_kernel,
// sl_decode_pallas_kernel, ...).  The per-frame sl_step, which no path
// launches, runs the Numpy stepper only.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// The three steppers (file comment): the real type and whether the
// reference's multiply-adds are contracted.
template <class R, bool kFma>
struct Stepper {
  using real = R;
  static constexpr bool fma = kFma;
};
using Numpy = Stepper<double, false>;
using Xla = Stepper<double, true>;
using Pallas = Stepper<float, true>;

// table[variant] for an extern "C" entry's variant code (file comment),
// nullptr for any other code
template <class K, int N>
K pick(K const (&table)[N], int variant) {
  return variant >= 0 && variant < N ? table[variant] : nullptr;
}

// K4's staged halo: 4 cells on each side of a tile hold every sample of
// an RK2 pixel at d_max = 2 whose neighbours are RK2 pixels too: the
// midpoint lies within d_max / 2 = 1 cell, the departure point within
// d_max = 2 cells (a bilinear mean of displacements <= d_max), floor() of
// either, after a rounding below an integer, one more, and the +1
// footprint one more again: 2 + 1 + 1 = 4.  sl_decode stages 8 cells,
// which also holds the first two or three substeps of a substep pixel
// (each moves at most about d_max): its global reads go through L2,
// about ten times the latency of a shared-memory read.
constexpr int K4_HALO = 4;
constexpr int DEC_HALO = 8;

// numpy clip: minimum(maximum(x, lo), hi)
template <class R>
__device__ __forceinline__ R clip(R x, R lo, R hi) {
  x = x > lo ? x : lo;
  return x < hi ? x : hi;
}

// the math functions of each real type, rounded as the reference rounds
__device__ __forceinline__ float r_floor(float x) { return floorf(x); }
__device__ __forceinline__ double r_floor(double x) { return floor(x); }
__device__ __forceinline__ float r_ceil(float x) { return ceilf(x); }
__device__ __forceinline__ double r_ceil(double x) { return ceil(x); }
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }
__device__ __forceinline__ float r_rint(float x) { return rintf(x); }
__device__ __forceinline__ double r_rint(double x) { return rint(x); }
__device__ __forceinline__ float r_fma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double r_fma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
// int64 -> the real type, rounded to nearest even (cvt.rn)
template <class R>
__device__ __forceinline__ R r_of(int64_t x) {
  return (R)x;
}

// The two ways a kernel reads the previous frame from global memory.
// K4 and sl_step read an input that no thread writes: the read-only path
// through L1.  sl_decode reads frames that other SMs wrote in the same
// launch: ld.global.cg through L2, never L1 (not coherent across SMs) or
// the non-coherent path; volatile with a memory clobber, so the compiler
// keeps it after the grid barrier that orders it (the header's __ldcg
// promises neither).
struct LoadReadOnly {
  __device__ __forceinline__ static int64_t ld(const int64_t* p) {
    return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
  }
};

struct LoadL2 {
  __device__ __forceinline__ static int64_t ld(const int64_t* p) {
    long long r;
    asm volatile("ld.global.cg.s64 %0, [%1];" : "=l"(r) : "l"(p) : "memory");
    return (int64_t)r;
  }
};

// (R)f[k] * g2, the value the stepper samples
template <class L, class R>
__device__ __forceinline__ R load_g2(const int64_t* f, int64_t k, R g2) {
  return r_of<R>(L::ld(f + k)) * g2;
}

// Frame t-1 as the values x * g2 over the rows [i0, i0 + h) and columns
// [j0, j0 + w) of the plane, row stride w, in shared memory.  h = 0
// stages nothing.
template <class R>
struct Stage {
  const R* u;
  const R* v;
  int i0, j0, h, w;
};

// Stage the rows [i0, i1) x columns [j0, j1) of the (H, W) planes xu, xv,
// clipped to the plane, into su, sv.  Every thread of the CTA calls it;
// the caller synchronizes before the reads.  Each thread issues up to
// STAGE_BATCH loads a plane before it converts any, so a tile costs one
// memory latency, not one a value: both kernels stage at most
// 4 x 256 values a plane.
constexpr int STAGE_BATCH = 4;

template <class L, class R>
__device__ Stage<R> stage(const int64_t* xu, const int64_t* xv, int H, int W,
                          R g2, int i0, int i1, int j0, int j1, R* su,
                          R* sv) {
  i0 = max(i0, 0);
  j0 = max(j0, 0);
  const Stage<R> s{su, sv, i0, j0, min(i1, H) - i0, min(j1, W) - j0};
  const int n = s.h * s.w;
  for (int k0 = threadIdx.x; k0 < n; k0 += STAGE_BATCH * blockDim.x) {
    int64_t a[STAGE_BATCH], b[STAGE_BATCH];
#pragma unroll
    for (int m = 0; m < STAGE_BATCH; ++m) {
      const int k = k0 + m * blockDim.x;
      if (k < n) {
        const int64_t g = (int64_t)(i0 + k / s.w) * W + (j0 + k % s.w);
        a[m] = L::ld(xu + g);
        b[m] = L::ld(xv + g);
      }
    }
#pragma unroll
    for (int m = 0; m < STAGE_BATCH; ++m) {
      const int k = k0 + m * blockDim.x;
      if (k < n) {
        su[k] = r_of<R>(a[m]) * g2;
        sv[k] = r_of<R>(b[m]) * g2;
      }
    }
  }
  return s;
}

template <class R>
struct UV {
  R u, v;
};

// the bilinear sum of one plane: left to right, each product and sum
// rounded once (Numpy), or contracted as XLA:CPU contracts it
template <class S>
__device__ __forceinline__ typename S::real bilinear_sum(
    typename S::real w00, typename S::real w01, typename S::real w10,
    typename S::real w11, typename S::real f00, typename S::real f01,
    typename S::real f10, typename S::real f11) {
  if constexpr (S::fma) {
    typename S::real acc = r_fma(w00, f00, w01 * f01);
    acc = r_fma(w10, f10, acc);
    return r_fma(w11, f11, acc);
  } else {
    typename S::real acc = w00 * f00;
    acc = acc + w01 * f01;
    acc = acc + w10 * f10;
    return acc + w11 * f11;
  }
}

// Bilinear sample of both planes at (fi, fj):
// (1-a)(1-b) f00 + (1-a) b f01 + a (1-b) f10 + a b f11.
template <class L, class S>
__device__ UV<typename S::real> bilinear2(const int64_t* xu,
                                          const int64_t* xv,
                                          const Stage<typename S::real>& s,
                                          typename S::real g2,
                                          typename S::real fi,
                                          typename S::real fj, int H,
                                          int W) {
  using R = typename S::real;
  const R i0 = clip(r_floor(fi), R(0), R(H - 1));
  const R j0 = clip(r_floor(fj), R(0), R(W - 1));
  const R a = fi - i0;
  const R b = fj - j0;
  const int ii0 = (int)i0;
  const int jj0 = (int)j0;
  const int ii1 = min(ii0 + 1, H - 1);
  const int jj1 = min(jj0 + 1, W - 1);
  R u00, u01, u10, u11, v00, v01, v10, v11;
  if (ii0 >= s.i0 && ii1 < s.i0 + s.h && jj0 >= s.j0 && jj1 < s.j0 + s.w) {
    const int r0 = (ii0 - s.i0) * s.w, r1 = (ii1 - s.i0) * s.w;
    const int c0 = jj0 - s.j0, c1 = jj1 - s.j0;
    u00 = s.u[r0 + c0];
    u01 = s.u[r0 + c1];
    u10 = s.u[r1 + c0];
    u11 = s.u[r1 + c1];
    v00 = s.v[r0 + c0];
    v01 = s.v[r0 + c1];
    v10 = s.v[r1 + c0];
    v11 = s.v[r1 + c1];
  } else {
    const int64_t r0 = (int64_t)ii0 * W, r1 = (int64_t)ii1 * W;
    u00 = load_g2<L>(xu, r0 + jj0, g2);
    u01 = load_g2<L>(xu, r0 + jj1, g2);
    u10 = load_g2<L>(xu, r1 + jj0, g2);
    u11 = load_g2<L>(xu, r1 + jj1, g2);
    v00 = load_g2<L>(xv, r0 + jj0, g2);
    v01 = load_g2<L>(xv, r0 + jj1, g2);
    v10 = load_g2<L>(xv, r1 + jj0, g2);
    v11 = load_g2<L>(xv, r1 + jj1, g2);
  }
  const R w00 = (R(1) - a) * (R(1) - b);
  const R w01 = (R(1) - a) * b;
  const R w10 = a * (R(1) - b);
  const R w11 = a * b;
  UV<R> r;
  r.u = bilinear_sum<S>(w00, w01, w10, w11, u00, u01, u10, u11);
  r.v = bilinear_sum<S>(w00, w01, w10, w11, v00, v01, v10, v11);
  return r;
}

// The stepper's scalars in its real type, each rounded once from the
// caller's double: g2, the CFL numbers, d_max and the reciprocal that the
// contracting variants multiply by
template <class R>
struct Params {
  R g2, cx, cy, d_max, inv_d_max;
  int n_max;
};

template <class R>
__device__ __forceinline__ Params<R> params(double g2, double cx, double cy,
                                            double d_max, int n_max) {
  Params<R> p;
  p.g2 = (R)g2;
  p.cx = (R)cx;
  p.cy = (R)cy;
  p.d_max = (R)d_max;
  p.inv_d_max = R(1) / p.d_max;
  p.n_max = n_max;
  return p;
}

// Pixel (i, j) of the (H, W) planes xu, xv of frame t-1, whose own
// values are u0 = xu[i, j] * g2 and v0 = xv[i, j] * g2 -> its
// predictions (pu, pv) for frame t.
template <class L, class S>
__device__ void sl_pixel(const int64_t* xu, const int64_t* xv,
                         const Stage<typename S::real>& s, int i, int j,
                         typename S::real u0, typename S::real v0, int H,
                         int W, const Params<typename S::real>& p,
                         int64_t& pu, int64_t& pv) {
  using R = typename S::real;
  const R ii = (R)i;
  const R jj = (R)j;
  const R hi_i = R(H - 1), hi_j = R(W - 1);
  const R du = r_abs(u0) * p.cx;
  const R dv = r_abs(v0) * p.cy;
  const R d_inf = du > dv ? du : dv;

  R i_s, j_s;
  if (d_inf <= p.d_max) {
    R i_h, j_h;
    if constexpr (S::fma) {
      i_h = r_fma(-v0, R(0.5) * p.cy, ii);
      j_h = r_fma(-u0, R(0.5) * p.cx, jj);
    } else {
      i_h = ii - R(0.5) * v0 * p.cy;
      j_h = jj - R(0.5) * u0 * p.cx;
    }
    i_h = clip(i_h, R(0), hi_i);
    j_h = clip(j_h, R(0), hi_j);
    const UV<R> h = bilinear2<L, S>(xu, xv, s, p.g2, i_h, j_h, H, W);
    if constexpr (S::fma) {
      i_s = r_fma(-h.v, p.cy, ii);
      j_s = r_fma(-h.u, p.cx, jj);
    } else {
      i_s = ii - h.v * p.cy;
      j_s = jj - h.u * p.cx;
    }
  } else {
    const R steps = S::fma ? d_inf * p.inv_d_max : d_inf / p.d_max;
    const R n_sub = clip(r_ceil(steps), R(1), (R)p.n_max);
    R pi = ii, pj = jj;
    for (int k = 0; k < n_sub; ++k) {
      const UV<R> q = bilinear2<L, S>(xu, xv, s, p.g2, pi, pj, H, W);
      pi = clip(pi - q.v * p.cy / n_sub, R(0), hi_i);
      pj = clip(pj - q.u * p.cx / n_sub, R(0), hi_j);
    }
    i_s = pi;
    j_s = pj;
  }
  i_s = clip(i_s, R(0), hi_i);
  j_s = clip(j_s, R(0), hi_j);
  const UV<R> f = bilinear2<L, S>(xu, xv, s, p.g2, i_s, j_s, H, W);
  pu = (int64_t)r_rint(f.u / p.g2);
  pv = (int64_t)r_rint(f.v / p.g2);
}

#define SL_SCALARS double g2, double cx, double cy, double d_max, int n_max

// ---------------------------------------------------------------------
// sl_step: one frame, one thread per pixel, nothing staged
// ---------------------------------------------------------------------

template <class S>
__global__ void sl_step_kernel(const int64_t* xu, const int64_t* xv,
                               int64_t* pu, int64_t* pv, int H, int W,
                               SL_SCALARS) {
  using R = typename S::real;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)H * W) return;
  const Params<R> p = params<R>(g2, cx, cy, d_max, n_max);
  const Stage<R> none{nullptr, nullptr, 0, 0, 0, 0};
  sl_pixel<LoadReadOnly, S>(xu, xv, none, (int)(idx / W), (int)(idx % W),
                            load_g2<LoadReadOnly>(xu, idx, p.g2),
                            load_g2<LoadReadOnly>(xv, idx, p.g2), H, W, p,
                            pu[idx], pv[idx]);
}

// ---------------------------------------------------------------------
// K4 sl_step_batched: one CTA per (frame, 32x16 tile), tile + halo staged
// ---------------------------------------------------------------------
//
// 32 rows x 16 columns, two pixels a thread, 40 x 24 staged values a
// plane: 15 KB of shared memory a CTA in f64, half that in f32.
// tools/sl_tile_sweep.py times the other tile shapes and halos (their
// times are in PERF.md).

constexpr int K4_TH = 32;
constexpr int K4_TW = 16;
constexpr int K4_THREADS = 256;
constexpr int K4_SPAN = (K4_TH + 2 * K4_HALO) * (K4_TW + 2 * K4_HALO);

#define K4_PARAMS                                                        \
  const int64_t *xu, const int64_t *xv, int64_t *pu, int64_t *pv, int H, \
      int W, int tiles_j, int n_tiles, SL_SCALARS
#define K4_ARGS \
  xu, xv, pu, pv, H, W, tiles_j, n_tiles, g2, cx, cy, d_max, n_max

template <class S>
__device__ __forceinline__ void sl_step_batched_body(K4_PARAMS) {
  using R = typename S::real;
  __shared__ R su[K4_SPAN];
  __shared__ R sv[K4_SPAN];
  const Params<R> p = params<R>(g2, cx, cy, d_max, n_max);
  const int b = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int ti0 = (tile / tiles_j) * K4_TH;
  const int tj0 = (tile % tiles_j) * K4_TW;
  const int64_t off = (int64_t)b * H * W;
  xu += off;
  xv += off;
  const Stage<R> s =
      stage<LoadReadOnly>(xu, xv, H, W, p.g2, ti0 - K4_HALO,
                          ti0 + K4_TH + K4_HALO, tj0 - K4_HALO,
                          tj0 + K4_TW + K4_HALO, su, sv);
  __syncthreads();
  for (int q = threadIdx.x; q < K4_TH * K4_TW; q += K4_THREADS) {
    const int i = ti0 + q / K4_TW;
    const int j = tj0 + q % K4_TW;
    if (i >= H || j >= W) continue;
    const int k = (i - s.i0) * s.w + (j - s.j0);
    const int64_t g = off + (int64_t)i * W + j;
    sl_pixel<LoadReadOnly, S>(xu, xv, s, i, j, s.u[k], s.v[k], H, W, p,
                              pu[g], pv[g]);
  }
}

// one __global__ name a variant (their own rows in a profile)
__global__ void __launch_bounds__(K4_THREADS)
    sl_step_batched_kernel(K4_PARAMS) { sl_step_batched_body<Numpy>(K4_ARGS); }
__global__ void __launch_bounds__(K4_THREADS)
    sl_step_batched_xla_kernel(K4_PARAMS) {
  sl_step_batched_body<Xla>(K4_ARGS);
}
__global__ void __launch_bounds__(K4_THREADS)
    sl_step_batched_pallas_kernel(K4_PARAMS) {
  sl_step_batched_body<Pallas>(K4_ARGS);
}

using StepBatchedKernel = void (*)(K4_PARAMS);
// [variant]
const StepBatchedKernel kStepBatchedKernels[3] = {
    sl_step_batched_kernel, sl_step_batched_xla_kernel,
    sl_step_batched_pallas_kernel};

// ---------------------------------------------------------------------
// K3 sl_decode: one cooperative launch decodes all T frames
// ---------------------------------------------------------------------
//
// The plane is cut into units: the MoP blocks (block x block pixels, the
// border ones partial), each cut further into at most 16x16 pieces when
// block > 16.  A unit has at most 256 pixels, one a thread.  CTA c owns
// the units c, c + grid, c + 2 grid, ... for all frames, so a pixel
// always belongs to the same thread, which keeps its x of the last frame
// in registers (for its first DEC_REG_UNITS units; later ones re-read
// their own store of frame t-1) and loads its residual or c2 of frame t
// before the frame's barrier.
//
// Frame 0: x_0 = c2[0].  Frame t >= 1, pixel in an SL block of frame t
// (flags[t] && blockmap[t, bi, bj]): x_t = res[t] + SL(x_{t-1}); any
// other pixel: x_t = x_{t-1} + c2[t].  Before a frame whose flag is set
// every CTA meets at grid.sync(): SL samples frame t-1 anywhere.  Every
// CTA reads the same flags, so the barriers are uniform; no thread
// leaves the frame loop early.

constexpr int DEC_UNIT = 16;
// 32: 2 x 32^2 x 8 B = 16 KB of shared memory a CTA in f64
constexpr int DEC_SPAN = DEC_UNIT + 2 * DEC_HALO;
constexpr int DEC_THREADS = DEC_UNIT * DEC_UNIT;
constexpr int DEC_REG_UNITS = 4;

__device__ __forceinline__ int64_t reg_get(const int64_t (&r)[DEC_REG_UNITS],
                                           int k) {
  int64_t x = r[0];
#pragma unroll
  for (int m = 1; m < DEC_REG_UNITS; ++m) x = m == k ? r[m] : x;
  return x;
}

__device__ __forceinline__ void reg_put(int64_t (&r)[DEC_REG_UNITS], int k,
                                        int64_t x) {
#pragma unroll
  for (int m = 0; m < DEC_REG_UNITS; ++m) r[m] = m == k ? x : r[m];
}

// Decode unit q (of all B fields) in frame t and this thread's pixel in
// it; all but i, j, active and g are CTA-uniform
struct UnitPixel {
  int r0, r1, c0, c1;  // the unit's rows [r0, r1), columns [c0, c1)
  int i, j;            // the thread's pixel
  bool some;           // the unit lies (partly) inside the plane
  bool active;         // the thread has a pixel in it
  bool sl;             // the unit is in an SL block of a flagged frame
  int64_t g;           // the pixel's offset in (B, T, H, W)
  int field;           // the field (tile unit) the unit belongs to
};

// sl_frame: some field steps SL blocks in frame t (the field's own
// flag is read only then, and only with kUnits)
template <bool kUnits>
__device__ __forceinline__ UnitPixel unit_pixel(int q, int t, int T,
                                                bool sl_frame,
                                                const uint8_t* flags,
                                                const uint8_t* bm, int H,
                                                int W, int block, int nbi,
                                                int nbj, int sub,
                                                int n_units) {
  UnitPixel u;
  const int f = kUnits ? q / n_units : 0;  // the field (tile unit) of q
  const int fq = kUnits ? q % n_units : q;
  const int bq = fq / (sub * sub);
  const int uq = fq % (sub * sub);
  const int bi = bq / nbj, bj = bq % nbj;
  const int64_t ft = (int64_t)f * T + t;  // frame t of field f
  u.r0 = bi * block + (uq / sub) * DEC_UNIT;
  u.c0 = bj * block + (uq % sub) * DEC_UNIT;
  u.r1 = min(min(u.r0 + DEC_UNIT, (bi + 1) * block), H);
  u.c1 = min(min(u.c0 + DEC_UNIT, (bj + 1) * block), W);
  u.some = u.r0 < u.r1 && u.c0 < u.c1;
  const int uw = max(u.c1 - u.c0, 1);
  u.active = u.some && (int)threadIdx.x < (u.r1 - u.r0) * uw;
  u.i = u.r0 + (int)threadIdx.x / uw;
  u.j = u.c0 + (int)threadIdx.x % uw;
  u.g = (ft * H + u.i) * W + u.j;
  u.sl = sl_frame && (!kUnits || flags[ft] != 0) &&
         bm[(ft * nbi + bi) * nbj + bj] != 0;
  u.field = f;
  return u;
}

#define K3_PARAMS                                                      \
  const int64_t *c2u, const int64_t *c2v, const int64_t *ru,           \
      const int64_t *rv, const uint8_t *bm, const uint8_t *flags,      \
      const uint8_t *sync, int64_t *xu, int64_t *xv, int B, int T,     \
      int H, int W, int block, SL_SCALARS
#define K3_ARGS                                                           \
  c2u, c2v, ru, rv, bm, flags, sync, xu, xv, B, T, H, W, block, g2, cx, cy, \
      d_max, n_max

template <bool kUnits, class S>
__device__ __forceinline__ void sl_decode_body(K3_PARAMS) {
  using R = typename S::real;
  __shared__ R su[DEC_SPAN * DEC_SPAN];
  __shared__ R sv[DEC_SPAN * DEC_SPAN];
  const Params<R> p = params<R>(g2, cx, cy, d_max, n_max);
  cg::grid_group grid = cg::this_grid();
  const int nbi = (H + block - 1) / block;
  const int nbj = (W + block - 1) / block;
  const int sub = (block + DEC_UNIT - 1) / DEC_UNIT;  // unit rows a block
  const int n_units = nbi * nbj * sub * sub;          // a field
  const int n_all = kUnits ? B * n_units : n_units;
  const int64_t HW = (int64_t)H * W;
  int64_t reg_u[DEC_REG_UNITS] = {0}, reg_v[DEC_REG_UNITS] = {0};
  int64_t pre_u[DEC_REG_UNITS] = {0}, pre_v[DEC_REG_UNITS] = {0};

  for (int t = 0; t < T; ++t) {
    const bool sl_frame = t > 0 && sync[t] != 0;
    // this frame's residual (SL pixel) or c2 (any other) of the units in
    // registers, loaded before the barrier so that it waits with it
#pragma unroll
    for (int k = 0; k < DEC_REG_UNITS; ++k) {
      const int q = blockIdx.x + k * gridDim.x;
      if (q >= n_all) break;
      const UnitPixel u = unit_pixel<kUnits>(q, t, T, sl_frame, flags, bm,
                                             H, W, block, nbi, nbj, sub,
                                             n_units);
      if (u.active) {
        pre_u[k] = u.sl ? ru[u.g] : c2u[u.g];
        pre_v[k] = u.sl ? rv[u.g] : c2v[u.g];
      }
    }
    if (sl_frame) grid.sync();
    int k = 0;
    for (int q = blockIdx.x; q < n_all; q += gridDim.x, ++k) {
      const UnitPixel u = unit_pixel<kUnits>(q, t, T, sl_frame, flags, bm,
                                             H, W, block, nbi, nbj, sub,
                                             n_units);
      if (!u.some) continue;  // past the plane's edge, CTA-uniform
      const bool in_regs = k < DEC_REG_UNITS;
      int64_t x_u = 0, x_v = 0;
      if (u.active) {
        x_u = in_regs ? reg_get(pre_u, k) : u.sl ? ru[u.g] : c2u[u.g];
        x_v = in_regs ? reg_get(pre_v, k) : u.sl ? rv[u.g] : c2v[u.g];
      }
      if (u.sl) {
        // frame t-1 of this unit's field
        const int64_t prev = ((int64_t)u.field * T + t - 1) * HW;
        const int64_t* pu_prev = xu + prev;
        const int64_t* pv_prev = xv + prev;
        __syncthreads();  // the last unit's staged tile is read
        const Stage<R> s =
            stage<LoadL2>(pu_prev, pv_prev, H, W, p.g2, u.r0 - DEC_HALO,
                          u.r1 + DEC_HALO, u.c0 - DEC_HALO, u.c1 + DEC_HALO,
                          su, sv);
        __syncthreads();
        if (u.active) {
          const int ks = (u.i - s.i0) * s.w + (u.j - s.j0);
          int64_t pu, pv;
          sl_pixel<LoadL2, S>(pu_prev, pv_prev, s, u.i, u.j, s.u[ks],
                              s.v[ks], H, W, p, pu, pv);
          x_u += pu;
          x_v += pv;
        }
      } else if (u.active && t > 0) {
        if (in_regs) {
          x_u += reg_get(reg_u, k);
          x_v += reg_get(reg_v, k);
        } else {  // this thread's own store of frame t-1
          x_u += LoadL2::ld(xu + u.g - HW);
          x_v += LoadL2::ld(xv + u.g - HW);
        }
      }
      if (u.active) {
        xu[u.g] = x_u;
        xv[u.g] = x_v;
        if (in_regs) {
          reg_put(reg_u, k, x_u);
          reg_put(reg_v, k, x_v);
        }
      }
    }
  }
}

// the whole-field kernel and the unit-batched one, one __global__ name a
// variant (their own rows in a profile)
#define K3_KERNEL(NAME, UNITS, S)                   \
  __global__ void __launch_bounds__(DEC_THREADS)    \
      NAME(K3_PARAMS) {                             \
    sl_decode_body<UNITS, S>(K3_ARGS);              \
  }
K3_KERNEL(sl_decode_kernel, false, Numpy)
K3_KERNEL(sl_decode_xla_kernel, false, Xla)
K3_KERNEL(sl_decode_pallas_kernel, false, Pallas)
K3_KERNEL(sl_decode_units_kernel, true, Numpy)
K3_KERNEL(sl_decode_units_xla_kernel, true, Xla)
K3_KERNEL(sl_decode_units_pallas_kernel, true, Pallas)

using DecodeKernel = void (*)(K3_PARAMS);
// [kUnits][variant]
const DecodeKernel kDecodeKernels[2][3] = {
    {sl_decode_kernel, sl_decode_xla_kernel, sl_decode_pallas_kernel},
    {sl_decode_units_kernel, sl_decode_units_xla_kernel,
     sl_decode_units_pallas_kernel}};

template <bool kUnits>
int launch_decode(const int64_t* c2u, const int64_t* c2v, const int64_t* ru,
                  const int64_t* rv, const uint8_t* bm, const uint8_t* flags,
                  const uint8_t* sync, int64_t* xu, int64_t* xv, int B, int T,
                  int H, int W, int block, double g2, double cfl_x,
                  double cfl_y, double d_max, int n_max, int variant,
                  int* grid_out, void* stream) {
  const DecodeKernel kernel = pick(kDecodeKernels[kUnits], variant);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, DEC_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int sub = (block + DEC_UNIT - 1) / DEC_UNIT;
  const int64_t n_units = (int64_t)B * ((H + block - 1) / block) *
                          ((W + block - 1) / block) * sub * sub;
  if (n_units > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int64_t fit = (int64_t)per_sm * sms;
  const int64_t grid = fit < n_units ? fit : n_units;
  *grid_out = (int)grid;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&c2u, &c2v,   &ru, &rv,    &bm,     &flags, &sync,
                  &xu,  &xv,    &B,  &T,     &H,      &W,     &block,
                  &g2,  &cfl_x, &cfl_y, &d_max, &n_max};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)kernel, dim3((unsigned)grid), dim3(DEC_THREADS),
      args, 0, (cudaStream_t)stream);
}

}  // namespace

// xu, xv, pu, pv: contiguous (H, W) int64; the Numpy stepper.  Returns
// the launch's cudaError_t.
extern "C" int sl_step(const int64_t* xu, const int64_t* xv, int64_t* pu,
                       int64_t* pv, int H, int W, double g2, double cfl_x,
                       double cfl_y, double d_max, int n_max, void* stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const int64_t blocks = (n + threads - 1) / threads;
  sl_step_kernel<Numpy><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      xu, xv, pu, pv, H, W, g2, cfl_x, cfl_y, d_max, n_max);
  return (int)cudaGetLastError();
}

// xu, xv, pu, pv: contiguous (B, H, W) int64, frames independent.
// Returns the launch's cudaError_t.
extern "C" int sl_step_batched(const int64_t* xu, const int64_t* xv,
                               int64_t* pu, int64_t* pv, int B, int H, int W,
                               double g2, double cfl_x, double cfl_y,
                               double d_max, int n_max, int variant,
                               void* stream) {
  const int tiles_j = (W + K4_TW - 1) / K4_TW;
  const int n_tiles = ((H + K4_TH - 1) / K4_TH) * tiles_j;
  const int64_t blocks = (int64_t)B * n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const StepBatchedKernel kernel = pick(kStepBatchedKernels, variant);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, K4_THREADS, 0, (cudaStream_t)stream>>>(
      xu, xv, pu, pv, H, W, tiles_j, n_tiles, g2, cfl_x, cfl_y, d_max, n_max);
  return (int)cudaGetLastError();
}

// c2u, c2v, ru, rv, xu, xv: contiguous (T, H, W) int64; bm: contiguous
// (T, ceil(H / block), ceil(W / block)) uint8; flags: (T,) uint8.  One
// cooperative launch of as many CTAs as fit on the card at once, at most
// one a unit; *grid_out gets that count.  Returns the launch's
// cudaError_t (a launch the card refuses is not retried).
extern "C" int sl_decode(const int64_t* c2u, const int64_t* c2v,
                         const int64_t* ru, const int64_t* rv,
                         const uint8_t* bm, const uint8_t* flags, int64_t* xu,
                         int64_t* xv, int T, int H, int W, int block,
                         double g2, double cfl_x, double cfl_y, double d_max,
                         int n_max, int variant, int* grid_out,
                         void* stream) {
  return launch_decode<false>(c2u, c2v, ru, rv, bm, flags, flags, xu, xv, 1,
                              T, H, W, block, g2, cfl_x, cfl_y, d_max, n_max,
                              variant, grid_out, stream);
}

// sl_decode of B fields in one cooperative launch: c2u, c2v, ru, rv, xu,
// xv contiguous (B, T, H, W) int64, bm (B, T, ceil(H / block),
// ceil(W / block)) uint8, flags (B, T) uint8 (field b steps its SL blocks
// in frame t), sync (T,) uint8 (some field does).
extern "C" int sl_decode_units(const int64_t* c2u, const int64_t* c2v,
                               const int64_t* ru, const int64_t* rv,
                               const uint8_t* bm, const uint8_t* flags,
                               const uint8_t* sync, int64_t* xu, int64_t* xv,
                               int B, int T, int H, int W, int block,
                               double g2, double cfl_x, double cfl_y,
                               double d_max, int n_max, int variant,
                               int* grid_out, void* stream) {
  return launch_decode<true>(c2u, c2v, ru, rv, bm, flags, sync, xu, xv, B, T,
                             H, W, block, g2, cfl_x, cfl_y, d_max, n_max,
                             variant, grid_out, stream);
}
