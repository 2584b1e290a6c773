// K1: fused dual-quantization + block-local 3D Lorenzo residual (int64).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lorenzo/kernel.py::dualquant_lorenzo_residual_pallas
// and computes, bit for bit, backend._lorenzo_residual_np of the JAX
// package:
//   x      = sign(d) * ((|d| + q/2) / q) << k,   q = g << k,  g = 2 xi_unit
//   x      = k = 0 rounding where the vertex is lossless
//   d2(x)  = x - x[i-1] - x[j-1] + x[i-1, j-1]    (block-local context)
//   res_t  = d2(x_t) - d2(x_{t-1}),   res_0 = d2(x_0)
//
// What bounds it on the H100: bytes.  Per element it reads dfp (8 B),
// k (4 B) and the lossless flag (1 B) and writes one int64 (8 B); the
// integer work is a few dozen operations.  The TPU kernel was int32 and
// had to be demoted to XLA at xi_unit < 4; here everything is int64, so
// no demotion exists.
//
// Design: one CTA per (Lorenzo tile, frame t).  The Lorenzo context is
// block-local, so a CTA needs no halo: it quantizes its tile of frames t
// and t-1 into shared memory (2 * block^2 int64), synchronizes, and
// writes d2(t) - d2(t-1) once per element.  Frame t-1's tile is
// re-quantized by the CTA of frame t (twice the loads of one pass, all
// coalesced rows of the tile), which keeps CTAs independent.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int64_t sgn(int64_t x) { return (x > 0) - (x < 0); }

__device__ __forceinline__ int64_t dual_quant(int64_t d, int32_t k, uint8_t ll,
                                              int64_t g) {
  const int kk = ll ? 0 : (k > 0 ? k : 0);
  const int64_t q = g << kk;
  const int64_t a = d < 0 ? -d : d;
  const int64_t mag = (a + (q >> 1)) / q;
  return sgn(d) * (mag << kk);
}

__device__ __forceinline__ int64_t d2_at(const int64_t* x, int li, int lj,
                                         int block) {
  int64_t v = x[li * block + lj];
  if (li > 0) v -= x[(li - 1) * block + lj];
  if (lj > 0) v -= x[li * block + lj - 1];
  if (li > 0 && lj > 0) v += x[(li - 1) * block + lj - 1];
  return v;
}

__global__ void lorenzo_residual_kernel(const int64_t* __restrict__ dfp,
                                        const int32_t* __restrict__ k,
                                        const uint8_t* __restrict__ ll,
                                        int64_t* __restrict__ out, int H,
                                        int W, int64_t g, int block) {
  extern __shared__ int64_t smem[];
  int64_t* cur = smem;
  int64_t* prv = smem + block * block;
  const int nbi = (H + block - 1) / block;
  const int nbj = (W + block - 1) / block;
  const int t = blockIdx.x / (nbi * nbj);
  const int tile = blockIdx.x % (nbi * nbj);
  const int bi = tile / nbj;
  const int bj = tile % nbj;
  const int i0 = bi * block;
  const int j0 = bj * block;
  const int bh = min(block, H - i0);
  const int bw = min(block, W - j0);
  const int64_t HW = (int64_t)H * W;

  for (int li = threadIdx.y; li < bh; li += blockDim.y) {
    for (int lj = threadIdx.x; lj < bw; lj += blockDim.x) {
      const int64_t c = t * HW + (int64_t)(i0 + li) * W + (j0 + lj);
      cur[li * block + lj] = dual_quant(dfp[c], k[c], ll[c], g);
      if (t > 0) {
        const int64_t p = c - HW;
        prv[li * block + lj] = dual_quant(dfp[p], k[p], ll[p], g);
      }
    }
  }
  __syncthreads();
  for (int li = threadIdx.y; li < bh; li += blockDim.y) {
    for (int lj = threadIdx.x; lj < bw; lj += blockDim.x) {
      const int64_t c = t * HW + (int64_t)(i0 + li) * W + (j0 + lj);
      int64_t r = d2_at(cur, li, lj, block);
      if (t > 0) r -= d2_at(prv, li, lj, block);
      out[c] = r;
    }
  }
}

}  // namespace

// dfp, k, ll, out: contiguous (T, H, W); returns the cudaError_t of the
// launch (0 on success).  One CTA per (frame, tile): T * tiles < 2^31.
extern "C" int lorenzo_residual(const int64_t* dfp, const int32_t* k,
                                const uint8_t* ll, int64_t* out, int T, int H,
                                int W, int64_t xi_unit, int block,
                                void* stream) {
  const int nbi = (H + block - 1) / block;
  const int nbj = (W + block - 1) / block;
  const size_t smem = 2 * (size_t)block * block * sizeof(int64_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lorenzo_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((int64_t)nbi * nbj * T));
  dim3 threads(16, 16);
  lorenzo_residual_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      dfp, k, ll, out, H, W, 2 * xi_unit, block);
  return (int)cudaGetLastError();
}
