// Fused spectral diagonal scaling on the full c2c spectrum, for Hopper (sm_90a).
//
//   biharmonic_scale_f32   replaces src/repro/kernels/spectral_diag.py _kernel
//                          (entry biharmonic_scale_pallas).
//                          out_c = beta_c * |k|^4 * spec   for c < n_betas,
//                          the spectrum held as two real planes (re, im).
//
// What it computes is kernels/spectral_diag.py biharmonic_scale_ref: the
// integer wavenumbers of a point are rebuilt from its index in the fftfreq
// convention (k < (n + 1) / 2 ? k : k - n), so no k-grid streams from
// memory, and the symbol is (beta * |k|^2) * |k|^2 in f32, the order of the
// TPU kernel.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): bytes.  Each point reads
// 8 bytes (re, im) and writes 8 * n_betas bytes, against ~9 + 4 n_betas
// flops.  Design: one thread per (k1, k2, k3), the betas passed by value
// (at most kMaxBetas), one read of the spectrum and n_betas coalesced
// writes of each plane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBetas = 8;

struct Betas {
  float b[kMaxBetas];
};

__device__ __forceinline__ float freq(int i, int n) {
  return (float)(i < (n + 1) / 2 ? i : i - n);
}

__global__ void __launch_bounds__(kThreads)
biharmonic_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  float* __restrict__ out_re, float* __restrict__ out_im, Betas betas,
                  int n_betas, int n1, int n2, int n3) {
  const int64_t npts = (int64_t)n1 * n2 * n3;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const float k3 = freq((int)(p % n3), n3);
  const float k2 = freq((int)((p / n3) % n2), n2);
  const float k1 = freq((int)(p / ((int64_t)n2 * n3)), n1);
  const float ksq = k1 * k1 + k2 * k2 + k3 * k3;  // exact: integers below 2^24
  const float r = __ldg(re + p), m = __ldg(im + p);
  for (int c = 0; c < n_betas; ++c) {
    const float sym = (betas.b[c] * ksq) * ksq;
    out_re[c * npts + p] = r * sym;
    out_im[c * npts + p] = m * sym;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  ``betas`` is a host array of
// ``n_betas`` floats, 1 <= n_betas <= 8 (else returns cudaErrorInvalidValue);
// the launch goes on ``stream``, does not synchronise, and the function
// returns cudaGetLastError().
extern "C" int biharmonic_scale_f32(const void* re, const void* im, void* out_re,
                                    void* out_im, const float* betas, int n_betas, int n1,
                                    int n2, int n3, void* stream) {
  if (n_betas < 1 || n_betas > kMaxBetas) return (int)cudaErrorInvalidValue;
  Betas b = {};
  for (int c = 0; c < n_betas; ++c) b.b[c] = betas[c];
  const int64_t npts = (int64_t)n1 * n2 * n3;
  const unsigned int blocks = (unsigned int)((npts + kThreads - 1) / kThreads);
  biharmonic_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)re, (const float*)im, (float*)out_re, (float*)out_im, b, n_betas, n1,
      n2, n3);
  return (int)cudaGetLastError();
}
