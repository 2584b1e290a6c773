// K1: fused dual-quantization + block-local 3D Lorenzo residual (int64)
// of both velocity components in one streaming launch.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lorenzo/kernel.py::dualquant_lorenzo_residual_pallas
// and computes, bit for bit and per component, quantize.dual_quantize
// followed by predictors.lorenzo_encode (the JAX package's
// backend._lorenzo_residual_np):
//   x      = sign(d) * (((|d| + q/2) >> kk) / g) << kk,   q = g << kk,
//            g = 2 xi_unit, kk = 0 where the vertex is lossless, else
//            max(k, 0)   (== ((|d| + q/2) / q) << kk: nested floors)
//   d2(x)  = x - x[i-1] - x[j-1] + x[i-1, j-1]    (block-local context)
//   res_t  = d2(x_t) - d2(x_{t-1}),   res_0 = d2(x_0)
// and, when asked, writes x of both components beside the residuals (the
// MoP path feeds it to the SL predictions instead of quantizing again).
//
// What bounds it on the H100: bytes.  Per element it reads ufp, vfp
// (16 B), k (4 B) and the lossless flag (1 B) and writes two residuals
// (16 B) and, with x, two more int64 (16 B).
//
// Design:
// * Stream over time.  One CTA owns a 16 x 64 spatial tile over a run of
//   consecutive frames.  It quantizes each frame of its tile once into
//   shared memory (double-buffered, so one barrier a frame), and each
//   thread keeps d2 of its four elements of frame t-1 in registers.  Only
//   the first frame of a run is quantized a second time, by the CTA of
//   the next run (1/run of the reads).  The wrapper picks the run so the
//   grid still fills the card.
// * Any block.  The tile is not tied to the Lorenzo block: where a tile's
//   top row or left column is not a block edge, the CTA also quantizes
//   the row above / the column left of its tile (a one-element halo).  At
//   block 16 every tile edge is a block edge and no halo is loaded.
// * Divide by a launch constant.  The only division is by g, constant
//   over the launch: a 32-bit dividend (every real field: |dfp| < 2^29)
//   takes the Granlund-Montgomery multiply-high with parameters the host
//   computes once (kernels/lorenzo/kernel.py::divisor_params), any other
//   takes an exact 64-bit floor division, element by element.  The
//   arithmetic wraps as the plain version's int64 torch ops do, so the
//   result equals it for every int64 dfp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTH = 16;                 // tile rows
constexpr int kTW = 64;                 // tile columns
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTW;  // rows one pass of the CTA covers
constexpr int kEPT = kTH / kRowStep;      // elements per thread per frame
constexpr int kSW = kTW + 1;              // shared row stride (col 0: halo)
constexpr int kPlane = (kTH + 1) * kSW;   // row 0: halo
constexpr int kHalo = kTW + 1 + kTH;      // halo elements (corner, top, left)

struct Divisor {
  int64_t g;      // 2 * xi_unit
  int64_t xi;     // xi_unit (q >> 1 == xi << kk)
  uint32_t m;     // multiply-high constant of g (fast != 0)
  int sh1, sh2;   // its shifts
  int fast;       // g < 2^32: the 32-bit path exists
};

__device__ __forceinline__ int64_t floor_div(int64_t n, int64_t g) {
  int64_t q = n / g;
  if (n < 0 && q * g != n) --q;
  return q;
}

__device__ __forceinline__ int64_t dual_quant(int64_t d, int32_t k, uint8_t ll,
                                              const Divisor& dv) {
  const int kk = ll ? 0 : (k > 0 ? k : 0);
  // |d| + q/2 with the int64 wrap of the plain version (|INT64_MIN| wraps)
  const uint64_t a = d < 0 ? 0ull - (uint64_t)d : (uint64_t)d;
  const uint64_t n = a + ((uint64_t)dv.xi << kk);
  const uint64_t nk = n >> kk;
  uint64_t mag;
  if (dv.fast && (int64_t)n >= 0 && (nk >> 32) == 0) {
    const uint32_t n32 = (uint32_t)nk;
    const uint32_t t1 = __umulhi(dv.m, n32);
    mag = (t1 + ((n32 - t1) >> dv.sh1)) >> dv.sh2;
  } else {
    // floor((n >> kk) / g) == floor(n / q), n as the plain version's int64
    mag = (uint64_t)floor_div((int64_t)n >> kk, dv.g);
  }
  const uint64_t x = mag << kk;
  return d > 0 ? (int64_t)x : (d < 0 ? (int64_t)(0ull - x) : 0);
}

__device__ __forceinline__ int64_t d2_at(const int64_t* s, int li, int lj,
                                         unsigned msk) {
  // s: one component's staged tile, element (li, lj) at (li+1, lj+1)
  const int c = (li + 1) * kSW + lj + 1;
  int64_t v = s[c];
  if (msk & 1u) v -= s[c - kSW];
  if (msk & 2u) v -= s[c - 1];
  if (msk == 3u) v += s[c - kSW - 1];
  return v;
}

// The extension of unit b is (Te, He, We) at ufp + b Te He We (and k,
// ll, xu, xv alike); its owned box is (To, Ho, Wo) at offset (ot, oi, oj),
// with residuals at ru + b To Ho Wo.
struct Box {
  int Te, He, We;        // extension
  int To, Ho, Wo;        // owned box
  int ot, oi, oj;        // its offset in the extension
};

#define K1_PARAMS                                                        \
  const int64_t *__restrict__ ufp, const int64_t *__restrict__ vfp,      \
      const int32_t *__restrict__ k, const uint8_t *__restrict__ ll,     \
      int64_t *__restrict__ ru, int64_t *__restrict__ rv,                \
      int64_t *__restrict__ xu, int64_t *__restrict__ xv, Box bx,        \
      int block, int run, int ntj, int ntiles, int nruns, Divisor dv
#define K1_ARGS \
  ufp, vfp, k, ll, ru, rv, xu, xv, bx, block, run, ntj, ntiles, nruns, dv

template <bool kUnits>
__device__ __forceinline__ void lorenzo_residual_body(K1_PARAMS) {
  __shared__ int64_t sx[2][2][kPlane];  // [frame parity][component][tile]

  const int b = kUnits ? blockIdx.x / (ntiles * nruns) : 0;
  const int rest = kUnits ? blockIdx.x % (ntiles * nruns) : blockIdx.x;
  const int tile = rest % ntiles;
  const int t0 = (rest / ntiles) * run;
  const int t1 = min(bx.Te, t0 + run);
  const int i0 = (tile / ntj) * kTH;
  const int j0 = (tile % ntj) * kTW;
  const int H = bx.He, W = bx.We;
  const int64_t HW = (int64_t)H * W;
  // the owned box: offset (ot, oi0, oj0), planes Ho x Wo, To frames
  const int ot = kUnits ? bx.ot : 0;
  const int oi0 = kUnits ? bx.oi : 0;
  const int oj0 = kUnits ? bx.oj : 0;
  const int To = kUnits ? bx.To : bx.Te;
  const int Wo = kUnits ? bx.Wo : W;
  const int64_t ext0 = (int64_t)b * bx.Te * HW;   // unit b's extension
  const int64_t oHW = kUnits ? (int64_t)bx.Ho * Wo : HW;
  const int64_t own0 = (int64_t)b * To * oHW;

  // the thread's elements: column lj, rows r0, r0 + 4, ...
  const int lj = threadIdx.x % kTW;
  const int r0 = threadIdx.x / kTW;
  const int j = j0 + lj;
  const int oj = j - oj0;                   // owned column
  int64_t off[kEPT];
  int64_t roff[kEPT];          // its residual offset in the owned plane
  unsigned msk[kEPT];          // bit 0: up neighbour, 1: left, 2: in the
                               // extension, 3: in the owned plane
#pragma unroll
  for (int e = 0; e < kEPT; ++e) {
    const int i = i0 + r0 + e * kRowStep;
    const int oi = i - oi0;
    const bool in = i < H && j < W;
    const bool own = kUnits ? oi >= 0 && oi < bx.Ho && oj >= 0 && oj < Wo
                            : in;
    off[e] = (int64_t)i * W + j;
    if (kUnits) {
      roff[e] = own ? (int64_t)oi * Wo + oj : 0;
      msk[e] = (own && (oi % block) != 0 ? 1u : 0u) |
               (own && (oj % block) != 0 ? 2u : 0u) | (in ? 4u : 0u) |
               (own ? 8u : 0u);
    } else {  // the owned box is the field: bit 3 is bit 2
      msk[e] = ((i % block) != 0 ? 1u : 0u) |
               ((j % block) != 0 ? 2u : 0u) | (in ? 12u : 0u);
    }
  }
  // the halo element of this thread, if the tile needs it: the row above
  // / the column left of the tile where that edge is inside the owned
  // plane but not on one of its block edges
  const bool top = kUnits ? i0 > oi0 && ((i0 - oi0) % block) != 0
                          : (i0 % block) != 0;
  const bool left = kUnits ? j0 > oj0 && ((j0 - oj0) % block) != 0
                           : (j0 % block) != 0;
  int64_t hoff = -1;
  int hs = 0;                  // its place in the staged tile
  {
    const int h = threadIdx.x;
    if (h == 0) {
      if (top && left) { hoff = (int64_t)(i0 - 1) * W + j0 - 1; hs = 0; }
    } else if (h <= kTW) {
      if (top && j0 - 1 + h < W) {
        hoff = (int64_t)(i0 - 1) * W + j0 - 1 + h;
        hs = h;
      }
    } else if (h < kHalo) {
      const int li = h - kTW - 1;
      if (left && i0 + li < H) {
        hoff = (int64_t)(i0 + li) * W + j0 - 1;
        hs = (li + 1) * kSW;
      }
    }
  }

  int64_t pu[kEPT], pv[kEPT];  // d2 of frame t-1
#pragma unroll
  for (int e = 0; e < kEPT; ++e) pu[e] = pv[e] = 0;

  for (int t = t0 > 0 ? t0 - 1 : 0; t < t1; ++t) {
    const bool out = t >= t0;  // frame t0-1 only primes pu / pv
    const int tt = t - ot;     // owned frame
    const bool res = kUnits ? out && tt >= 0 && tt < To : out;
    if (kUnits && tt == 0) {   // the temporal predictor restarts here
#pragma unroll
      for (int e = 0; e < kEPT; ++e) pu[e] = pv[e] = 0;
    }
    const int64_t base = ext0 + (int64_t)t * HW;
    const int64_t rbase = own0 + (int64_t)tt * oHW;
    int64_t* su = sx[t & 1][0];
    int64_t* sv = sx[t & 1][1];
    int64_t du[kEPT], dw[kEPT];
    int32_t kv[kEPT];
    uint8_t lv[kEPT];
#pragma unroll
    for (int e = 0; e < kEPT; ++e) {
      if (msk[e] & 4u) {
        const int64_t c = base + off[e];
        du[e] = __ldg(ufp + c);
        dw[e] = __ldg(vfp + c);
        kv[e] = __ldg(k + c);
        lv[e] = __ldg(ll + c);
      }
    }
    if (hoff >= 0) {
      const int64_t c = base + hoff;
      const int32_t kh = __ldg(k + c);
      const uint8_t lh = __ldg(ll + c);
      su[hs] = dual_quant(__ldg(ufp + c), kh, lh, dv);
      sv[hs] = dual_quant(__ldg(vfp + c), kh, lh, dv);
    }
#pragma unroll
    for (int e = 0; e < kEPT; ++e) {
      if (msk[e] & 4u) {
        const int s = (r0 + e * kRowStep + 1) * kSW + lj + 1;
        const int64_t x_u = dual_quant(du[e], kv[e], lv[e], dv);
        const int64_t x_v = dual_quant(dw[e], kv[e], lv[e], dv);
        su[s] = x_u;
        sv[s] = x_v;
        if (xu != nullptr && out) {
          xu[base + off[e]] = x_u;
          xv[base + off[e]] = x_v;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kEPT; ++e) {
      if (msk[e] & 8u) {
        const int li = r0 + e * kRowStep;
        const unsigned m = msk[e] & 3u;
        const int64_t d_u = d2_at(su, li, lj, m);
        const int64_t d_v = d2_at(sv, li, lj, m);
        if (res) {
          const int64_t r = kUnits ? rbase + roff[e] : base + off[e];
          ru[r] = d_u - pu[e];
          rv[r] = d_v - pv[e];
        }
        pu[e] = d_u;
        pv[e] = d_v;
      }
    }
    // no second barrier: frame t+1 stages into the other buffer, and
    // frame t+2 (this buffer again) stages only after frame t+1's barrier
  }
}

// the whole-field kernel and the unit-batched one (their own names in a
// profile)
__global__ void __launch_bounds__(kThreads)
lorenzo_residual_kernel(K1_PARAMS) { lorenzo_residual_body<false>(K1_ARGS); }

__global__ void __launch_bounds__(kThreads)
lorenzo_residual_units_kernel(K1_PARAMS) {
  lorenzo_residual_body<true>(K1_ARGS);
}

template <bool kUnits>
int launch(const int64_t* ufp, const int64_t* vfp, const int32_t* k,
           const uint8_t* ll, int64_t* ru, int64_t* rv, int64_t* xu,
           int64_t* xv, int B, const Box& bx, int block, int run,
           int64_t xi_unit, uint32_t m, int sh1, int sh2, int fast,
           void* stream) {
  const int nti = (bx.He + kTH - 1) / kTH;
  const int ntj = (bx.We + kTW - 1) / kTW;
  const int ntiles = nti * ntj;
  const int nruns = (bx.Te + run - 1) / run;
  const int64_t ctas = (int64_t)B * ntiles * nruns;
  if (ctas > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  const Divisor dv = {2 * xi_unit, xi_unit, m, sh1, sh2, fast};
  const auto kernel =
      kUnits ? lorenzo_residual_units_kernel : lorenzo_residual_kernel;
  kernel<<<(unsigned)ctas, kThreads, 0, (cudaStream_t)stream>>>(
      ufp, vfp, k, ll, ru, rv, xu, xv, bx, block, run, ntj, ntiles, nruns,
      dv);
  return (int)cudaGetLastError();
}

}  // namespace

// ufp, vfp, res_u, res_v (and xu, xv unless null): contiguous (T, H, W)
// int64; k int32, ll uint8 of the same shape.  One CTA per (run of `run`
// frames, 16 x 64 tile): ceil(T / run) * tiles < 2^31.  (m, sh1, sh2,
// fast) divide by g = 2 xi_unit (kernels/lorenzo/kernel.py::
// divisor_params).  Returns the launch's cudaError_t (0 on success).
extern "C" int lorenzo_residual_pair(
    const int64_t* ufp, const int64_t* vfp, const int32_t* k,
    const uint8_t* ll, int64_t* ru, int64_t* rv, int64_t* xu, int64_t* xv,
    int T, int H, int W, int block, int run, int64_t xi_unit, uint32_t m,
    int sh1, int sh2, int fast, void* stream) {
  const Box bx = {T, H, W, T, H, W, 0, 0, 0};
  return launch<false>(ufp, vfp, k, ll, ru, rv, xu, xv, 1, bx, block, run,
                       xi_unit, m, sh1, sh2, fast, stream);
}

// B units: ufp, vfp, xu, xv contiguous (B, Te, He, We) int64, k int32 and
// ll uint8 of that shape; ru, rv contiguous (B, To, Ho, Wo) int64, the
// owned box at offset (ot, oi, oj) inside the extension.  Writes X of
// every extension element and the residuals of the owned box.  Returns
// the launch's cudaError_t.
extern "C" int lorenzo_residual_units(
    const int64_t* ufp, const int64_t* vfp, const int32_t* k,
    const uint8_t* ll, int64_t* ru, int64_t* rv, int64_t* xu, int64_t* xv,
    int B, int Te, int He, int We, int To, int Ho, int Wo, int ot, int oi,
    int oj, int block, int run, int64_t xi_unit, uint32_t m, int sh1,
    int sh2, int fast, void* stream) {
  const Box bx = {Te, He, We, To, Ho, Wo, ot, oi, oj};
  return launch<true>(ufp, vfp, k, ll, ru, rv, xu, xv, B, bx, block, run,
                      xi_unit, m, sh1, sh2, fast, stream);
}
