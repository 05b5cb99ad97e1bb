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
// Design of the planned apply and the batched displace (apply_kernel,
// displace_kernel; one template, tile_interp).  A block of 256 threads owns
// an output tile of 4 x 8 x 32 points (x1 x2 x3): lane = x3, warp = x2, and
// each thread computes the tile's 4 points along x1.  The grid is the list
// of tiles, so no index is split by a division per point; offsets within a
// channel are 32-bit (the wrappers refuse grids of 2^31 points), only the
// channel and plane bases are 64-bit.  The block reads its points' stencil
// bases (ib, or floor(disp)) and takes the box of source voxels their
// stencils reach, [min(x + ib) - 1, max(x + ib) + 2] per axis.
//   * Staged branch, when the box spans at most kBoxWidth voxels along x3
//     and kBoxRows (x1, x2) rows: the block copies each channel's box from
//     global memory into shared memory with cp.async, wrapping every
//     coordinate periodically, into one of two buffers, so that channel
//     c + 1 arrives while channel c is contracted.  The 64 stencil reads
//     per point are then shared-memory loads at a per-point base plus
//     immediate offsets; neighbouring lanes read neighbouring words.
//   * Otherwise (a rough displacement), the same block gathers from global
//     memory through the read-only cache: one periodic wrap per axis of
//     x + ib - 1, the other three stencil indices by increment and
//     compare-subtract.
// Both branches contract with contract_run(): running sums with three
// partial sums live instead of 16, each output point seeing the same
// operations in the same order (the rounding contract below), and the loop
// over the last stencil axis kept rolled, so that the compiler hoists at
// most 16 loads per point (unrolled, it hoisted all 64 and spilled at every
// register cap tried, even at 255).  The staged branch keeps each point's
// box offset and 12 weights in registers across the channel loop; the
// displace re-reads its displacement for the weights instead of keeping it
// across the block's reduction.  __launch_bounds__(256, 3) caps the
// kernels at 80 registers with no spill, so 3 blocks (24 warps, 141 KB of
// shared memory) share an SM.  The budget, 2 buffers of kBoxRows x
// kBoxWidth floats (46 KB), holds the box of every tile of the 256^3
// solve's departure fields (at most 108 rows and 36 voxels; PERF.md).
// The tile gives 256 blocks at 64^3, so the ladder's coarsest level still
// fills the 132 SMs.  The shared memory is reserved whichever branch a
// block takes, which leaves the unstaged branch's gathers less L1 than the
// first design had.  kernels/tricubic.py states the tile and box rule in
// Python (staged_tiles), and each entry point takes an optional counter of
// the tiles that took the staged branch.
// The single-field displace (field_warp_kernel) keeps the first design: one
// thread per output point, 64-bit offsets, the stencil sums of contract().
//
// Rounding contract.  Kernel and plain version (kernels/ref.py) do the same
// IEEE f32 operations in the same order, so they agree bit for bit:
//   1. no product is fused into an add: build.py compiles with -fmad=false;
//   2. every 4-term stencil sum is ((p0 + p1) + p2) + p3, over axis 1, then
//      2, then 3: contract_run() and contract() here, ref._dot4 and
//      ref._gather_contract there;
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
#include <climits>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // field_warp_kernel: threads per block

// The output tile of apply_kernel and displace_kernel, and the largest box
// they stage.  kernels/tricubic.py (TILE, BOX_WIDTH, BOX_ROWS) mirrors these.
constexpr int kTile1 = 4;       // points along x1, all of one thread
constexpr int kTile2 = 8;       // points along x2, one warp each
constexpr int kTile3 = 32;      // points along x3, one lane each
constexpr int kBoxWidth = 40;   // voxels along x3 a staged box may span
constexpr int kBoxRows = 144;   // (x1, x2) rows a staged box may hold
constexpr int kMinBlocks = 3;   // blocks per SM asked of the register allocator
constexpr int kTileThreads = kTile2 * kTile3;

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

// The same contraction as contract(), written as running sums: at(a, b, d)
// is the value at stencil offset (a - 1, b - 1, d - 1).  plane() folds the
// axis-1 sums s_b of one d into acc_d = ((s_0 w2[0] + s_1 w2[1]) + ...), and
// contract_run() folds acc_d into out = ((acc_0 w3[0] + acc_1 w3[1]) + ...),
// so three sums are live.  The loop over d stays rolled (see the design
// note above).
template <class At>
__device__ __forceinline__ float plane(At at, int d, const float* w1, const float* w2) {
  float acc = 0.0f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float s = at(0, b, d) * w1[0];
#pragma unroll
    for (int a = 1; a < 4; ++a) s = s + at(a, b, d) * w1[a];
    acc = b == 0 ? s * w2[0] : acc + s * w2[b];
  }
  return acc;
}

template <class At>
__device__ __forceinline__ float contract_run(At at, const float* w1, const float* w2,
                                              const float* w3) {
  float out = plane(at, 0, w1, w2) * w3[0];
#pragma unroll 1
  for (int d = 1; d < 4; ++d) {
    const float w = d == 1 ? w3[1] : d == 2 ? w3[2] : w3[3];
    out = out + plane(at, d, w1, w2) * w;
  }
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

// Offsets of the stencil indices g, g+1, g+2, g+3 along an axis of length n
// with the given stride: one periodic wrap, then increment and
// compare-subtract.
__device__ __forceinline__ void stencil_offsets(int g, int n, int stride, int r[4]) {
  int i = wrap(g, n);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[k] = i * stride;
    i = i + 1 == n ? 0 : i + 1;
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying one channel's box into dst: box element (j1, j2, j3) sits at
// (j1 * e2 + j2) * kBoxWidth + j3 and comes from the periodically wrapped
// voxel row_off[j1 * e2 + j2] + col_off[j3] of src.
__device__ __forceinline__ void stage_box(float* dst, const float* __restrict__ src,
                                          const int* row_off, const int* col_off, int rows,
                                          int e3) {
  for (int e = threadIdx.x; e < rows * kBoxWidth; e += kTileThreads) {
    const int r = e / kBoxWidth, j3 = e - r * kBoxWidth;
    if (j3 < e3) cp_async4(dst + e, src + (row_off[r] + col_off[j3]));
  }
  cp_async_commit();
}

// The 12 weights of the point at flat index q, axis-major (w1[0..3],
// w2[0..3], w3[0..3]): read from the plan, or built from the displacement.
template <bool kPlanned>
__device__ __forceinline__ void point_weights(const float* __restrict__ w,
                                              const float* __restrict__ disp, int npts, int q,
                                              float wt[12]) {
  if constexpr (kPlanned) {
    // w is (3, 4, N): plane (axis, k) starts at (4 * axis + k) * N
#pragma unroll
    for (int k = 0; k < 12; ++k) wt[k] = __ldg(w + (size_t)k * npts + q);
  } else {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float d = __ldg(disp + (size_t)ax * npts + q);
      lagrange(d - floorf(d), &wt[4 * ax]);
    }
  }
}

// One output tile of the planned apply (kPlanned: ib and w from the plan)
// or of the batched displace (disp; ib = floor(disp), weights by lagrange()).
template <bool kPlanned>
__device__ __forceinline__ void tile_interp(const float* __restrict__ fields,
                                            const int32_t* __restrict__ ib,
                                            const float* __restrict__ w,
                                            const float* __restrict__ disp,
                                            float* __restrict__ out, int channels, int n1,
                                            int n2, int n3, int* __restrict__ staged_tiles) {
  __shared__ float box[2][kBoxRows * kBoxWidth];
  __shared__ int row_off[kBoxRows];
  __shared__ int col_off[kBoxWidth];
  __shared__ int red[6][kTile2];

  const int n23 = n2 * n3, npts = n1 * n23;
  const int tid = threadIdx.x, lane = tid % kTile3, warp = tid / kTile3;
  const int tiles3 = (n3 + kTile3 - 1) / kTile3, tiles2 = (n2 + kTile2 - 1) / kTile2;
  const int t12 = blockIdx.x / tiles3;
  const int x3 = (blockIdx.x - t12 * tiles3) * kTile3 + lane;
  const int x2 = (t12 % tiles2) * kTile2 + warp;
  const int x1_0 = (t12 / tiles2) * kTile1;
  const bool in_row = x2 < n2 && x3 < n3;
  // flat index of the thread's first point; point p is p * n23 further on
  const int q0 = in_row ? (x1_0 * n2 + x2) * n3 + x3 : 0;

  // 1. each point's stencil origin g = x + ib - 1 (not wrapped), and the box
  int g[kTile1][3];
  int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
  for (int p = 0; p < kTile1; ++p) {
    if (!in_row || x1_0 + p >= n1) continue;
    const int q = q0 + p * n23;
    const int x[3] = {x1_0 + p, x2, x3};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      // the displacement is read again for the weights, not kept
      const int base = kPlanned ? __ldg(ib + (size_t)ax * npts + q)
                                : (int)floorf(__ldg(disp + (size_t)ax * npts + q));
      g[p][ax] = x[ax] + base - 1;
      lo[ax] = min(lo[ax], g[p][ax]);
      hi[ax] = max(hi[ax], g[p][ax]);
    }
  }
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    lo[ax] = __reduce_min_sync(0xffffffffu, lo[ax]);
    hi[ax] = __reduce_max_sync(0xffffffffu, hi[ax]);
    if (lane == 0) {
      red[ax][warp] = lo[ax];
      red[3 + ax][warp] = hi[ax];
    }
  }
  __syncthreads();
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int k = 0; k < kTile2; ++k) {
      lo[ax] = min(lo[ax], red[ax][k]);
      hi[ax] = max(hi[ax], red[3 + ax][k]);
    }
  }
  // the box spans hi - lo + 4 voxels per axis (the difference is exact in
  // unsigned arithmetic, since hi >= lo)
  const unsigned s1 = (unsigned)hi[0] - (unsigned)lo[0];
  const unsigned s2 = (unsigned)hi[1] - (unsigned)lo[1];
  const unsigned s3 = (unsigned)hi[2] - (unsigned)lo[2];
  const bool staged = s3 <= (unsigned)(kBoxWidth - 4) && s1 < (unsigned)kBoxRows &&
                      s2 < (unsigned)kBoxRows && (s1 + 4) * (s2 + 4) <= (unsigned)kBoxRows;

  if (staged) {
    // 2. staged: the wrapped source offsets of the box's rows and columns,
    // then channel 0's box in flight while the weights are read
    if (staged_tiles != nullptr && tid == 0) atomicAdd(staged_tiles, 1);
    const int e2 = (int)s2 + 4, e3 = (int)s3 + 4, rows = ((int)s1 + 4) * e2;
    if (tid < rows) {
      const int j1 = tid / e2;
      row_off[tid] = wrap(lo[0] + j1, n1) * n23 + wrap(lo[1] + tid - j1 * e2, n2) * n3;
    }
    if (tid < e3) col_off[tid] = wrap(lo[2] + tid, n3);
    __syncthreads();
    stage_box(box[0], fields, row_off, col_off, rows, e3);

    int o[kTile1];          // box offset of each point's stencil origin
    float wt[kTile1][12];   // its weights
#pragma unroll
    for (int p = 0; p < kTile1; ++p) {
      if (!in_row || x1_0 + p >= n1) continue;
      o[p] = ((g[p][0] - lo[0]) * e2 + (g[p][1] - lo[1])) * kBoxWidth + (g[p][2] - lo[2]);
      point_weights<kPlanned>(w, disp, npts, q0 + p * n23, wt[p]);
    }
    const int step1 = e2 * kBoxWidth;
    for (int c = 0; c < channels; ++c) {
      if (c + 1 < channels) {
        stage_box(box[(c + 1) & 1], fields + (size_t)(c + 1) * npts, row_off, col_off, rows,
                  e3);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* bx = box[c & 1];
      float* oc = out + (size_t)c * npts;
#pragma unroll
      for (int p = 0; p < kTile1; ++p) {
        if (!in_row || x1_0 + p >= n1) continue;
        const float* sb = bx + o[p];
        oc[q0 + p * n23] = contract_run(
            [&](int a, int b, int d) { return sb[a * step1 + b * kBoxWidth + d]; },
            &wt[p][0], &wt[p][4], &wt[p][8]);
      }
      __syncthreads();
    }
  } else {
    // 2. unstaged: each point gathers its stencils from global memory
#pragma unroll
    for (int p = 0; p < kTile1; ++p) {
      if (!in_row || x1_0 + p >= n1) continue;
      const int q = q0 + p * n23;
      float wp[12];
      point_weights<kPlanned>(w, disp, npts, q, wp);
      int r1[4], r2[4], r3[4];
      stencil_offsets(g[p][0], n1, n23, r1);
      stencil_offsets(g[p][1], n2, n3, r2);
      stencil_offsets(g[p][2], n3, 1, r3);
      for (int c = 0; c < channels; ++c) {
        const float* fc = fields + (size_t)c * npts;
        out[(size_t)c * npts + q] = contract_run(
            [&](int a, int b, int d) {
              const int r3d = d == 0 ? r3[0] : d == 1 ? r3[1] : d == 2 ? r3[2] : r3[3];
              return __ldg(fc + (r1[a] + r2[b] + r3d));
            },
            &wp[0], &wp[4], &wp[8]);
      }
    }
  }
}

__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
apply_kernel(const float* __restrict__ fields, const int32_t* __restrict__ ib,
             const float* __restrict__ w, float* __restrict__ out, int channels, int n1,
             int n2, int n3, int* __restrict__ staged_tiles) {
  tile_interp<true>(fields, ib, w, nullptr, out, channels, n1, n2, n3, staged_tiles);
}

__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
displace_kernel(const float* __restrict__ fields, const float* __restrict__ disp,
                float* __restrict__ out, int channels, int n1, int n2, int n3,
                int* __restrict__ staged_tiles) {
  tile_interp<false>(fields, nullptr, nullptr, disp, out, channels, n1, n2, n3, staged_tiles);
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

unsigned int tiles_for(int n1, int n2, int n3) {
  return (unsigned int)((n1 + kTile1 - 1) / kTile1) * ((n2 + kTile2 - 1) / kTile2) *
         ((n3 + kTile3 - 1) / kTile3);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
// staged_tiles, where not null, is a device int to which the planned apply
// and the batched displace add the number of tiles that took the staged
// branch.
extern "C" int tricubic_apply_f32(const void* fields, const void* ib, const void* w,
                                  void* out, int channels, int n1, int n2, int n3,
                                  void* staged_tiles, void* stream) {
  apply_kernel<<<tiles_for(n1, n2, n3), kTileThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int32_t*)ib, (const float*)w, (float*)out, channels,
      n1, n2, n3, (int*)staged_tiles);
  return (int)cudaGetLastError();
}

extern "C" int tricubic_displace_many_f32(const void* fields, const void* disp, void* out,
                                          int channels, int n1, int n2, int n3,
                                          void* staged_tiles, void* stream) {
  displace_kernel<<<tiles_for(n1, n2, n3), kTileThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const float*)disp, (float*)out, channels, n1, n2, n3,
      (int*)staged_tiles);
  return (int)cudaGetLastError();
}

extern "C" int tricubic_displace_f32(const void* field, const void* disp, void* out, int n1,
                                     int n2, int n3, void* stream) {
  field_warp_kernel<<<blocks_for(n1, n2, n3), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)field, (const float*)disp, (float*)out, n1, n2, n3);
  return (int)cudaGetLastError();
}
