// Tricubic Lagrange interpolation on a periodic grid, for Hopper (sm_90a):
// the two kernels of the registration solve's main path, and the
// single-field displace that resamples an image through a deformation.
//
//   tricubic_apply_f32          replaces src/repro/kernels/tricubic.py
//                               _kernel_planned (entry tricubic_apply_pallas).
//                               out[c,x] = sum_{a,b,d in -1..2} w1[a] w2[b] w3[d]
//                                          * f[c, x + ib + (a,b,d)]
//                               with a precomputed InterpPlan (ib, w).
//   tricubic_displace_many_f32  replaces src/repro/kernels/tricubic.py
//                               _kernel_many (entry tricubic_displace_pallas_many).
//                               The same sum, with ib = floor(disp) and the
//                               Lagrange weights built per point from one disp
//                               shared by the C channels.
//   tricubic_displace_f32       replaces src/repro/kernels/tricubic.py
//                               _kernel (entry tricubic_displace_pallas).
//                               One field at x + disp: the query point
//                               q = x + disp is formed first and split into
//                               floor(q) and q - floor(q), as the plain
//                               version (ref.tricubic_displace) does.
//
// What they compute is kernels/ref.py (interp_apply, tricubic_displace_many,
// tricubic_displace):
// periodic wrap by index arithmetic, so any displacement, any N1, N2, N3 and
// any C.  The TPU kernels staged a tile plus a halo of 4 voxels and contracted
// one-hot matrices on the MXU, which bounds |disp| by the halo and needs
// tile-divisible shapes; at 256^3 a transport step moves ~10 voxels, so that
// contract does not hold here, and the card has a hardware gather instead.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): both kernels are bound by
// bytes.  The planned apply reads C fields, 3 int32 bases and 12 f32 weights
// per point and writes C outputs: (2C + 15) * 4 bytes per point against
// 168 C flops.  The displace reads C fields and 3 displacements and writes C
// outputs: (2C + 3) * 4 bytes per point against ~168 C + 60 flops.  The
// single-field displace is the latter at C = 1: 20 bytes against ~234 flops.
//
// Design (the simple first one): one thread per output point.  It reads its
// plan entries (or its displacement) once, wraps its 4 stencil indices per
// axis once, and then for each channel does the 64 gathers through the
// read-only cache, contracting in the plain version's order (axis 1, then 2,
// then 3, each sum left to right) in f32, under the
// rounding contract below.  Neighbouring threads are neighbouring x3 points whose departure
// points are close, so most gathers hit L1/L2; the plan and displacement
// reads and the output writes are coalesced.  Channel offsets are 64-bit.
// Shared-memory staging and several points per thread are later work.
//
// Rounding contract.  Kernel and plain version (kernels/ref.py) do the same
// IEEE f32 operations in the same order, so they agree bit for bit:
//   1. no product is fused into an add: build.py compiles with -fmad=false;
//   2. every 4-term stencil sum is ((p0 + p1) + p2) + p3, over axis 1, then
//      2, then 3: contract() here, ref._dot4 and ref._gather_contract there;
//   3. the Lagrange weights are the expressions of lagrange() here and of
//      ref.lagrange_weights there, term for term, with /6 as a product with
//      the f32 reciprocal kSixth;
//   4. the single-field displace forms q = x + disp before floor(q), as
//      ref.tricubic_displace does; the batched displace splits disp itself.
// Why: a solve whose PCG is preconditioned by the V-cycle (a few fixed inner
// CG iterations, not a fixed linear operator) turns 1e-7 of roundoff into
// other PCG counts, so the kernel path and the plain path take the same
// iterations only when they round alike (ROADMAP Queue C 5).  A change to
// either side changes both.  tests/test_torch_kernels.py checks the plain
// side against a step-by-step f32 evaluation in this order and the build
// flag; on the card chip_smoke.py's kernel_parity reports the kernels'
// error against the plain versions (0 under the contract) and
// ml_solve_parity fails when the counts part.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

constexpr float kSixth = 1.0f / 6.0f;

__device__ __forceinline__ void lagrange(float t, float w[4]) {
  // same expressions, in the same order, as ref.lagrange_weights
  w[0] = -t * (t - 1.0f) * (t - 2.0f) * kSixth;
  w[1] = (t + 1.0f) * (t - 1.0f) * (t - 2.0f) * 0.5f;
  w[2] = -(t + 1.0f) * t * (t - 2.0f) * 0.5f;
  w[3] = (t + 1.0f) * t * (t - 1.0f) * kSixth;
}

// Contract the 4x4x4 stencil of one channel: rows r1[a] + r2[b] + r3[d].
// Each sum is ((p0 + p1) + p2) + p3, the order of ref._dot4.
__device__ __forceinline__ float contract(const float* __restrict__ f,
                                          const int64_t r1[4], const int64_t r2[4],
                                          const int64_t r3[4], const float w1[4],
                                          const float w2[4], const float w3[4]) {
  float s2[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float s = __ldg(f + r1[0] + r2[b] + r3[d]) * w1[0];
#pragma unroll
      for (int a = 1; a < 4; ++a) s += __ldg(f + r1[a] + r2[b] + r3[d]) * w1[a];
      s2[b][d] = s;
    }
  }
  float s3[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    float s = s2[0][d] * w2[0];
#pragma unroll
    for (int b = 1; b < 4; ++b) s += s2[b][d] * w2[b];
    s3[d] = s;
  }
  float out = s3[0] * w3[0];
#pragma unroll
  for (int d = 1; d < 4; ++d) out += s3[d] * w3[d];
  return out;
}

// Stencil row offsets of the point (x1, x2, x3) with base offsets (i1, i2, i3).
__device__ __forceinline__ void rows(int x1, int x2, int x3, int i1, int i2, int i3,
                                     int n1, int n2, int n3, int64_t r1[4],
                                     int64_t r2[4], int64_t r3[4]) {
  const int64_t s1 = (int64_t)n2 * n3;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    r1[a] = (int64_t)wrap(x1 + i1 + a - 1, n1) * s1;
    r2[a] = (int64_t)wrap(x2 + i2 + a - 1, n2) * n3;
    r3[a] = (int64_t)wrap(x3 + i3 + a - 1, n3);
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ fields, const int32_t* __restrict__ ib,
             const float* __restrict__ w, float* __restrict__ out, int channels,
             int n1, int n2, int n3) {
  const int64_t npts = (int64_t)n1 * n2 * n3;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const int x3 = (int)(p % n3);
  const int x2 = (int)((p / n3) % n2);
  const int x1 = (int)(p / ((int64_t)n2 * n3));

  int64_t r1[4], r2[4], r3[4];
  rows(x1, x2, x3, __ldg(ib + p), __ldg(ib + npts + p), __ldg(ib + 2 * npts + p),
       n1, n2, n3, r1, r2, r3);
  // w is (3, 4, N): plane (axis, k) starts at (4 * axis + k) * N
  float w1[4], w2[4], w3[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w1[k] = __ldg(w + (0 + k) * npts + p);
    w2[k] = __ldg(w + (4 + k) * npts + p);
    w3[k] = __ldg(w + (8 + k) * npts + p);
  }
  for (int c = 0; c < channels; ++c) {
    out[c * npts + p] = contract(fields + c * npts, r1, r2, r3, w1, w2, w3);
  }
}

__global__ void __launch_bounds__(kThreads)
displace_kernel(const float* __restrict__ fields, const float* __restrict__ disp,
                float* __restrict__ out, int channels, int n1, int n2, int n3) {
  const int64_t npts = (int64_t)n1 * n2 * n3;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const int x3 = (int)(p % n3);
  const int x2 = (int)((p / n3) % n2);
  const int x1 = (int)(p / ((int64_t)n2 * n3));

  const float d1 = __ldg(disp + p), d2 = __ldg(disp + npts + p),
              d3 = __ldg(disp + 2 * npts + p);
  const float f1 = floorf(d1), f2 = floorf(d2), f3 = floorf(d3);
  float w1[4], w2[4], w3[4];
  lagrange(d1 - f1, w1);
  lagrange(d2 - f2, w2);
  lagrange(d3 - f3, w3);
  int64_t r1[4], r2[4], r3[4];
  rows(x1, x2, x3, (int)f1, (int)f2, (int)f3, n1, n2, n3, r1, r2, r3);
  for (int c = 0; c < channels; ++c) {
    out[c * npts + p] = contract(fields + c * npts, r1, r2, r3, w1, w2, w3);
  }
}

// A kernel of its own rather than C = 1 of displace_kernel: its own register
// count, its own row in a profile and its own launch counter.
__global__ void __launch_bounds__(kThreads)
field_warp_kernel(const float* __restrict__ field, const float* __restrict__ disp,
                  float* __restrict__ out, int n1, int n2, int n3) {
  const int64_t npts = (int64_t)n1 * n2 * n3;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const int x3 = (int)(p % n3);
  const int x2 = (int)((p / n3) % n2);
  const int x1 = (int)(p / ((int64_t)n2 * n3));

  // the query point in grid units, as ref.tricubic_displace forms it
  const float q1 = (float)x1 + __ldg(disp + p);
  const float q2 = (float)x2 + __ldg(disp + npts + p);
  const float q3 = (float)x3 + __ldg(disp + 2 * npts + p);
  const float f1 = floorf(q1), f2 = floorf(q2), f3 = floorf(q3);
  float w1[4], w2[4], w3[4];
  lagrange(q1 - f1, w1);
  lagrange(q2 - f2, w2);
  lagrange(q3 - f3, w3);
  int64_t r1[4], r2[4], r3[4];
  rows(0, 0, 0, (int)f1, (int)f2, (int)f3, n1, n2, n3, r1, r2, r3);
  out[p] = contract(field, r1, r2, r3, w1, w2, w3);
}

unsigned int blocks_for(int n1, int n2, int n3) {
  const int64_t npts = (int64_t)n1 * n2 * n3;
  return (unsigned int)((npts + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
extern "C" int tricubic_apply_f32(const void* fields, const void* ib, const void* w,
                                  void* out, int channels, int n1, int n2, int n3,
                                  void* stream) {
  apply_kernel<<<blocks_for(n1, n2, n3), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int32_t*)ib, (const float*)w, (float*)out, channels,
      n1, n2, n3);
  return (int)cudaGetLastError();
}

extern "C" int tricubic_displace_many_f32(const void* fields, const void* disp, void* out,
                                          int channels, int n1, int n2, int n3,
                                          void* stream) {
  displace_kernel<<<blocks_for(n1, n2, n3), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const float*)disp, (float*)out, channels, n1, n2, n3);
  return (int)cudaGetLastError();
}

extern "C" int tricubic_displace_f32(const void* field, const void* disp, void* out, int n1,
                                     int n2, int n3, void* stream) {
  field_warp_kernel<<<blocks_for(n1, n2, n3), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)field, (const float*)disp, (float*)out, n1, n2, n3);
  return (int)cudaGetLastError();
}
