// K3 and K4: semi-Lagrangian stepper, float64.  Build with -fmad=false.
//
// K3 (sl_step) replaces the Pallas TPU kernel
//   src/repro/kernels/semilagrange/kernel.py::sl_predict_pallas
// (the per-frame SL stepper of the verify simulation and decode, which
// must step frames in sequence).  K4 (sl_step_batched) replaces
//   src/repro/kernels/semilagrange/kernel.py::sl_predict_batched_pallas
// (the same stepper over a (B, H, W) stack of independent frames): the
// encoder predicts frames 1..T-1 from frames 0..T-2 in one launch.  Both
// kernels run the one __device__ function sl_pixel under the same flags,
// so K4's integers equal B launches of K3 bit for bit by construction.
//
// The stepper maps frame t-1's base-grid integers (xu, xv) to frame t's
// integer predictions (pu, pv):
//   u = (double)xu * g2, v = (double)xv * g2
//   d_inf = max(|u| cx, |v| cy)
//   d_inf <= d_max: RK2 midpoint backtrace
//   otherwise:      n_sub = clip(ceil(d_inf / d_max), 1, n_max) clamped
//                   Euler substeps
//   p = rint(bilinear(u at the departure point) / g2)
//
// The TPU kernel computed this in f32.  This one computes it in f64, in
// the op order of the JAX package's numpy stepper
// (backend._sl_predict_frame_np) -- (0.5*v)*cy, (vs*cy)/n_sub, the
// bilinear sum left to right, rint half to even -- with every operation
// rounded once (-fmad=false), so its integers equal that stepper's bit
// for bit.  That is what lets the containers it writes (header
// sl_backend "numpy") decode in the JAX package, and the JAX package's
// f64 containers decode here.
//
// Each thread loops to its OWN n_sub: in the reference, iterations past
// a pixel's own count are masked identities, so no field-wide maximum is
// needed and the result is the same.  A pixel that takes the RK2 branch
// skips the substep loop (its result is discarded in the reference).
//
// What bounds it on the H100: latency of dependent f64 gathers.  A pixel
// reads its own two values and 8 (RK2) or 8 * n_sub + 8 (substeps)
// scattered int64 values of the two planes, through L1/L2 (a plane of
// the main path is well under 1 MB); each substep depends on the last.
// Compulsory traffic is 16 B in and 16 B out per pixel.  One thread per
// output pixel, no shared memory.  K3 launches one 100x225 frame at a
// time, too few threads to fill the card; K4 gives it all B frames of
// the encoder at once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// numpy clip: minimum(maximum(x, lo), hi)
__device__ __forceinline__ double clip(double x, double lo, double hi) {
  x = x > lo ? x : lo;
  return x < hi ? x : hi;
}

__device__ __forceinline__ double sample(const int64_t* __restrict__ f,
                                         int i, int j, int W, double g2) {
  return (double)f[(int64_t)i * W + j] * g2;
}

__device__ double bilinear(const int64_t* __restrict__ f, double g2,
                           double fi, double fj, int H, int W) {
  const double i0 = clip(floor(fi), 0.0, H - 1.0);
  const double j0 = clip(floor(fj), 0.0, W - 1.0);
  const double a = fi - i0;
  const double b = fj - j0;
  const int ii0 = (int)i0;
  const int jj0 = (int)j0;
  const int ii1 = min(ii0 + 1, H - 1);
  const int jj1 = min(jj0 + 1, W - 1);
  const double f00 = sample(f, ii0, jj0, W, g2);
  const double f01 = sample(f, ii0, jj1, W, g2);
  const double f10 = sample(f, ii1, jj0, W, g2);
  const double f11 = sample(f, ii1, jj1, W, g2);
  double r = (1.0 - a) * (1.0 - b) * f00;
  r = r + (1.0 - a) * b * f01;
  r = r + a * (1.0 - b) * f10;
  r = r + a * b * f11;
  return r;
}

// pixel idx of the (H, W) planes xu, xv -> its predictions pu[idx], pv[idx]
__device__ __forceinline__ void sl_pixel(const int64_t* __restrict__ xu,
                                         const int64_t* __restrict__ xv,
                                         int64_t* __restrict__ pu,
                                         int64_t* __restrict__ pv,
                                         int64_t idx, int H, int W, double g2,
                                         double cx, double cy, double d_max,
                                         int n_max) {
  const double ii = (double)(idx / W);
  const double jj = (double)(idx % W);
  const double u0 = (double)xu[idx] * g2;
  const double v0 = (double)xv[idx] * g2;
  const double du = fabs(u0) * cx;
  const double dv = fabs(v0) * cy;
  const double d_inf = du > dv ? du : dv;

  double i_s, j_s;
  if (d_inf <= d_max) {
    const double i_h = clip(ii - 0.5 * v0 * cy, 0.0, H - 1.0);
    const double j_h = clip(jj - 0.5 * u0 * cx, 0.0, W - 1.0);
    const double u_h = bilinear(xu, g2, i_h, j_h, H, W);
    const double v_h = bilinear(xv, g2, i_h, j_h, H, W);
    i_s = ii - v_h * cy;
    j_s = jj - u_h * cx;
  } else {
    const double n_sub = clip(ceil(d_inf / d_max), 1.0, (double)n_max);
    double pi = ii, pj = jj;
    for (int s = 0; s < n_sub; ++s) {
      const double us = bilinear(xu, g2, pi, pj, H, W);
      const double vs = bilinear(xv, g2, pi, pj, H, W);
      pi = clip(pi - vs * cy / n_sub, 0.0, H - 1.0);
      pj = clip(pj - us * cx / n_sub, 0.0, W - 1.0);
    }
    i_s = pi;
    j_s = pj;
  }
  i_s = clip(i_s, 0.0, H - 1.0);
  j_s = clip(j_s, 0.0, W - 1.0);
  pu[idx] = (int64_t)rint(bilinear(xu, g2, i_s, j_s, H, W) / g2);
  pv[idx] = (int64_t)rint(bilinear(xv, g2, i_s, j_s, H, W) / g2);
}

__global__ void sl_step_kernel(const int64_t* __restrict__ xu,
                               const int64_t* __restrict__ xv,
                               int64_t* __restrict__ pu,
                               int64_t* __restrict__ pv, int H, int W,
                               double g2, double cx, double cy, double d_max,
                               int n_max) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)H * W) return;
  sl_pixel(xu, xv, pu, pv, idx, H, W, g2, cx, cy, d_max, n_max);
}

__global__ void sl_step_batched_kernel(const int64_t* __restrict__ xu,
                                       const int64_t* __restrict__ xv,
                                       int64_t* __restrict__ pu,
                                       int64_t* __restrict__ pv, int B, int H,
                                       int W, double g2, double cx, double cy,
                                       double d_max, int n_max) {
  const int64_t hw = (int64_t)H * W;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * hw) return;
  const int64_t off = (idx / hw) * hw;
  sl_pixel(xu + off, xv + off, pu + off, pv + off, idx - off, H, W, g2, cx,
           cy, d_max, n_max);
}

}  // namespace

// xu, xv, pu, pv: contiguous (H, W) int64.  Returns the launch's
// cudaError_t.
extern "C" int sl_step(const int64_t* xu, const int64_t* xv, int64_t* pu,
                       int64_t* pv, int H, int W, double g2, double cfl_x,
                       double cfl_y, double d_max, int n_max, void* stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const int64_t blocks = (n + threads - 1) / threads;
  sl_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      xu, xv, pu, pv, H, W, g2, cfl_x, cfl_y, d_max, n_max);
  return (int)cudaGetLastError();
}

// xu, xv, pu, pv: contiguous (B, H, W) int64, frames independent.
// Returns the launch's cudaError_t.
extern "C" int sl_step_batched(const int64_t* xu, const int64_t* xv,
                               int64_t* pu, int64_t* pv, int B, int H, int W,
                               double g2, double cfl_x, double cfl_y,
                               double d_max, int n_max, void* stream) {
  const int threads = 256;
  const int64_t n = (int64_t)B * H * W;
  const int64_t blocks = (n + threads - 1) / threads;
  sl_step_batched_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      xu, xv, pu, pv, B, H, W, g2, cfl_x, cfl_y, d_max, n_max);
  return (int)cudaGetLastError();
}
