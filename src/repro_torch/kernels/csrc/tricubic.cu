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
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 counting an FMA as two): all
// three are bound by bytes.  The planned apply reads C fields, 3 int32
// bases and 12 f32 weights per point and writes C outputs: (2C + 15) * 4
// bytes per point against 147 C operations (contract_run: 16 rows of 4
// products and 3 sums, then 4 x 7, then 7).  The displace reads C fields
// and 3 displacements and writes C outputs: (2C + 3) * 4 bytes per point
// against 147 C + 51 operations (per axis floor, subtract, and lagrange's
// 3 sums and 12 products).  The single-field displace forms q = x + disp
// first: 20 bytes against 201 operations at C = 1.  Built without FMA (the
// rounding contract), the card does 33.5e12 of these operations a second,
// and the batched and the single-field displace are bound by operations
// instead.  A staged launch also makes 64 four-byte shared-memory loads per
// point and channel, at 128 bytes per clock per SM.
//
// Design (apply_kernel, displace_kernel, field_warp_kernel; one template,
// tile_interp, with three point policies).  A block of 256 threads owns
// an output tile of 4 x 8 x 32 points (x1 x2 x3): lane = x3, warp = x2, and
// each thread computes the tile's 4 points along x1.  The grid is the list
// of tiles, so no index is split by a division per point; offsets within a
// channel are 32-bit (the wrappers refuse grids of 2^31 points), only the
// channel and plane bases are 64-bit.  The block forms each point's stencil
// origin g (the first of the 4 source voxels per axis, not wrapped) and
// takes the box of source voxels its stencils reach, [min g, max g + 3] per
// axis.  The policy says how g and the weights come about:
//   planned (K1)      g = x + ib - 1, the 12 weights read from the plan;
//   displace (K2)     g = x + floor(disp) - 1, weights lagrange(disp - floor);
//   warp (K3)         q = (float)x + disp first, g = floor(q) - 1 (absolute:
//                     not x + floor(disp) - 1, which differs where x + disp
//                     rounds up to an integer in f32), weights lagrange(q -
//                     floor(q)).
//   * Staged branch, when the box spans at most kBoxWidth voxels along x3
//     and the kernel's box rows (x1, x2): the block copies each channel's
//     box from global memory into shared memory with cp.async, wrapping
//     every coordinate periodically.  The 64 stencil reads per point are
//     then shared-memory loads at a per-point base plus immediate offsets;
//     neighbouring lanes read neighbouring words.
//   * Otherwise (a rough displacement), the same block gathers from global
//     memory through the read-only cache: one periodic wrap per axis of g,
//     the other three stencil indices by increment and compare-subtract.
// Both branches contract with contract_run(): running sums with three
// partial sums live instead of 16, each output point seeing the same
// operations in the same order (the rounding contract below), and the loop
// over the last stencil axis kept rolled, so that the compiler hoists at
// most 16 loads per point (unrolled, it hoisted all 64 and spilled at every
// register cap tried, even at 255).
//   K1 and K2 run C = 2 or 3 channels: two buffers of kBoxRows x kBoxWidth
// floats (46 KB), so that channel c + 1 arrives while channel c is
// contracted, and each point's box offset and 12 weights stay in registers
// across the channel loop (K2 re-reads its displacement for the weights
// instead of keeping it across the block's reduction).  The box holds
// every tile of the 256^3 solve's departure fields (at most 108 rows and
// 36 voxels; PERF.md).  __launch_bounds__(256, 3) caps them at 80
// registers with no spill, so 3 blocks (24 warps, 141 KB of shared memory)
// share an SM.
//   K3 resamples one image (C = 1; more channels run one after another),
// so a second buffer would have nothing to overlap with: it has one buffer
// of kWarpBoxRows rows, twice K1/K2's, since a warp through a whole
// deformation strains its tiles more than one time step does.  Its weights
// are formed as K2's are (the displacement read again after the reduction,
// kept in registers while channel 0's box is in flight), and the overlap
// of one block's copy with another's contraction comes from co-resident
// blocks: 3 per SM at 80 registers with no spill.  Box height and blocks
// per SM were chosen by a same-call A/B (bench_torch/tricubic_ab.py, with
// these two constants edited): 144 rows tie on smooth fields and stage
// fewer strained tiles; 4 blocks per SM (64 registers) spill (PERF.md).
// The tile gives 256 blocks at 64^3, so the ladder's coarsest level still
// fills the 132 SMs.  The shared memory is reserved whichever branch a
// block takes, which leaves the unstaged branch's gathers less L1.
// kernels/tricubic.py states the tile and box rule in Python
// (staged_tiles; warp_base for K3's g), and each entry point takes an
// optional counter of the tiles that took the staged branch.
//   Subject axis (K1, K2).  A cohort of S registrations launches once, on a
// grid of (tiles, S) blocks: blockIdx.y is the subject s.  The cohort layout
// puts the subjects under the channels, fields (C, S, N..) against ib
// (S, 3, N..), w (S, 3, 4, N..) or disp (S, 3, N..), so a block first moves
// its plan or displacement on by s * 3 * N (ib, disp) or s * 12 * N (w), and
// channel c of subject s starts at (c * S + s) * N: the channel stride is
// S * N, with S = gridDim.y.  Each subject's tile stages, and contracts, as
// the same tile of a single-subject launch on that subject's slab would,
// so a launch over S subjects equals S single-subject launches bit for bit.
// The axis is a template flag of tile_interp: a launch of S > 1 subjects
// runs apply_cohort_kernel or displace_cohort_kernel, one of S = 1 (every
// single registration) apply_kernel or displace_kernel, whose code is that
// of before the axis, so the axis costs a single registration nothing.  K3
// has no subject axis.
//
// Rounding contract.  Kernel and plain version (kernels/ref.py) do the same
// IEEE f32 operations in the same order, so they agree bit for bit:
//   1. no product is fused into an add: build.py compiles with -fmad=false;
//   2. every 4-term stencil sum is ((p0 + p1) + p2) + p3, over axis 1, then
//      2, then 3: contract_run() here, ref._dot4 and ref._gather_contract
//      there;
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

// The output tile of the three kernels, and the largest box apply_kernel
// and displace_kernel stage.  kernels/tricubic.py (TILE, BOX_WIDTH,
// BOX_ROWS, WARP_BOX_ROWS) mirrors these and field_warp_kernel's box rows.
constexpr int kTile1 = 4;       // points along x1, all of one thread
constexpr int kTile2 = 8;       // points along x2, one warp each
constexpr int kTile3 = 32;      // points along x3, one lane each
constexpr int kBoxWidth = 40;   // voxels along x3 a staged box may span
constexpr int kBoxRows = 144;   // (x1, x2) rows a staged box may hold
constexpr int kMinBlocks = 3;   // blocks per SM asked of the register allocator
constexpr int kTileThreads = kTile2 * kTile3;
constexpr int kWarpBoxRows = 288;  // field_warp_kernel's box rows, one buffer
constexpr int kWarpMinBlocks = 3;  // and its blocks per SM

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

constexpr float kSixth = 1.0f / 6.0f;

__device__ __forceinline__ void lagrange(float t, float w[4]) {
  // same expressions, in the same order, as ref.lagrange_weights
  w[0] = -t * (t - 1.0f) * (t - 2.0f) * kSixth;
  w[1] = (t + 1.0f) * (t - 1.0f) * (t - 2.0f) * 0.5f;
  w[2] = -(t + 1.0f) * t * (t - 2.0f) * 0.5f;
  w[3] = (t + 1.0f) * t * (t - 1.0f) * kSixth;
}

// The contraction of the 4x4x4 stencil of one channel, as running sums:
// at(a, b, d) is the value at stencil offset (a - 1, b - 1, d - 1), each
// sum ((p0 + p1) + p2) + p3 in the order of ref._dot4.  plane() folds the
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

// How a kernel forms its points' stencil origins and weights (design note).
enum class Policy { kPlanned, kDisplace, kWarp };

// The 12 weights of the point x at flat index q, axis-major (w1[0..3],
// w2[0..3], w3[0..3]): read from the plan (K1), or built from the
// displacement d, as lagrange(d - floor(d)) (K2) or from the query point
// x + d, as lagrange(q - floor(q)) (K3).
template <Policy P>
__device__ __forceinline__ void point_weights(const float* __restrict__ w,
                                              const float* __restrict__ disp, int npts, int q,
                                              const int x[3], float wt[12]) {
  if constexpr (P == Policy::kPlanned) {
    // w is (3, 4, N): plane (axis, k) starts at (4 * axis + k) * N
#pragma unroll
    for (int k = 0; k < 12; ++k) wt[k] = __ldg(w + (size_t)k * npts + q);
  } else {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      float d = __ldg(disp + (size_t)ax * npts + q);
      if constexpr (P == Policy::kWarp) d = (float)x[ax] + d;
      lagrange(d - floorf(d), &wt[4 * ax]);
    }
  }
}

// One output tile of C channels under policy P, staging boxes of at most
// kRows (x1, x2) rows in kBuffers buffers; with kSubjects, of the cohort's
// subject blockIdx.y (the subject axis, design note).
template <Policy P, int kBuffers, int kRows, bool kSubjects>
__device__ __forceinline__ void tile_interp(const float* __restrict__ fields,
                                            const int32_t* __restrict__ ib,
                                            const float* __restrict__ w,
                                            const float* __restrict__ disp,
                                            float* __restrict__ out, int channels, int n1,
                                            int n2, int n3, int* __restrict__ staged_tiles) {
  static_assert(kBuffers == 1 || kBuffers == 2, "one or two box buffers");
  __shared__ float box[kBuffers][kRows * kBoxWidth];
  __shared__ int row_off[kRows];
  __shared__ int col_off[kBoxWidth];
  __shared__ int red[6][kTile2];

  const int n23 = n2 * n3, npts = n1 * n23;
  // the subject axis (design note): this block's subject's fields, output,
  // and plan or displacement.  Channel c of the subject is then c * S * npts
  // further on, S = gridDim.y, read where it is used so that no register
  // holds the stride.  Without kSubjects the code is that of the kernels
  // before the axis, character for character where it matters: forms that
  // differed from it only in how they spell c * npts spilled K3 at 80
  // registers and slowed K2 by 5% (PERF.md).
  if constexpr (kSubjects) {
    const size_t subject = blockIdx.y;
    fields += subject * npts;
    out += subject * npts;
    if constexpr (P == Policy::kPlanned) {
      ib += subject * 3 * npts;
      w += subject * 12 * npts;
    } else {
      disp += subject * 3 * npts;
    }
  }
  const int tid = threadIdx.x, lane = tid % kTile3, warp = tid / kTile3;
  const int tiles3 = (n3 + kTile3 - 1) / kTile3, tiles2 = (n2 + kTile2 - 1) / kTile2;
  const int t12 = blockIdx.x / tiles3;
  const int x3 = (blockIdx.x - t12 * tiles3) * kTile3 + lane;
  const int x2 = (t12 % tiles2) * kTile2 + warp;
  const int x1_0 = (t12 / tiles2) * kTile1;
  const bool in_row = x2 < n2 && x3 < n3;
  // flat index of the thread's first point; point p is p * n23 further on
  const int q0 = in_row ? (x1_0 * n2 + x2) * n3 + x3 : 0;

  // 1. each point's stencil origin g (not wrapped), and the box; K2 and K3
  // read their displacement again for the weights instead of keeping it
  int g[kTile1][3];
  int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
  for (int p = 0; p < kTile1; ++p) {
    if (!in_row || x1_0 + p >= n1) continue;
    const int q = q0 + p * n23;
    const int x[3] = {x1_0 + p, x2, x3};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      if constexpr (P == Policy::kWarp) {
        // the query point first, as ref.tricubic_displace forms it
        g[p][ax] = (int)floorf((float)x[ax] + __ldg(disp + (size_t)ax * npts + q)) - 1;
      } else {
        const int base = P == Policy::kPlanned
                             ? __ldg(ib + (size_t)ax * npts + q)
                             : (int)floorf(__ldg(disp + (size_t)ax * npts + q));
        g[p][ax] = x[ax] + base - 1;
      }
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
  const bool staged = s3 <= (unsigned)(kBoxWidth - 4) && s1 < (unsigned)kRows &&
                      s2 < (unsigned)kRows && (s1 + 4) * (s2 + 4) <= (unsigned)kRows;

  if (staged) {
    // 2. staged: the wrapped source offsets of the box's rows and columns,
    // then channel 0's box in flight while the weights are read
    if (staged_tiles != nullptr && tid == 0) atomicAdd(staged_tiles, 1);
    const int e2 = (int)s2 + 4, e3 = (int)s3 + 4, rows = ((int)s1 + 4) * e2;
    // one pass for K1/K2's 144 rows, two for K3's 288
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += kTileThreads) {
      const int r = r0 + tid;
      if (r < rows) {
        const int j1 = r / e2;
        row_off[r] = wrap(lo[0] + j1, n1) * n23 + wrap(lo[1] + r - j1 * e2, n2) * n3;
      }
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
      const int x[3] = {x1_0 + p, x2, x3};
      point_weights<P>(w, disp, npts, q0 + p * n23, x, wt[p]);
    }
    const int step1 = e2 * kBoxWidth;
    for (int c = 0; c < channels; ++c) {
      if constexpr (kBuffers == 2) {
        if (c + 1 < channels) {
          stage_box(box[(c + 1) & 1],
                    fields + (kSubjects ? (size_t)((c + 1) * gridDim.y) * npts
                                        : (size_t)(c + 1) * npts),
                    row_off, col_off, rows, e3);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {
        if (c > 0) {
          stage_box(box[0],
                    fields + (kSubjects ? (size_t)(c * gridDim.y) * npts : (size_t)c * npts),
                    row_off, col_off, rows, e3);
        }
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* bx = box[c % kBuffers];
      float* oc = out + (kSubjects ? (size_t)(c * gridDim.y) * npts : (size_t)c * npts);
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
      const int x[3] = {x1_0 + p, x2, x3};
      float wp[12];
      point_weights<P>(w, disp, npts, q, x, wp);
      int r1[4], r2[4], r3[4];
      stencil_offsets(g[p][0], n1, n23, r1);
      stencil_offsets(g[p][1], n2, n3, r2);
      stencil_offsets(g[p][2], n3, 1, r3);
      for (int c = 0; c < channels; ++c) {
        const float* fc = fields + (kSubjects ? (size_t)(c * gridDim.y) * npts : (size_t)c * npts);
        out[(kSubjects ? (size_t)(c * gridDim.y) * npts : (size_t)c * npts) + q] =
            contract_run(
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
  tile_interp<Policy::kPlanned, 2, kBoxRows, false>(fields, ib, w, nullptr, out, channels, n1,
                                                    n2, n3, staged_tiles);
}

__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
displace_kernel(const float* __restrict__ fields, const float* __restrict__ disp,
                float* __restrict__ out, int channels, int n1, int n2, int n3,
                int* __restrict__ staged_tiles) {
  tile_interp<Policy::kDisplace, 2, kBoxRows, false>(fields, nullptr, nullptr, disp, out,
                                                     channels, n1, n2, n3, staged_tiles);
}

// apply_kernel and displace_kernel over a cohort of S = gridDim.y > 1
// subjects: the same template with the subject axis, a kernel of its own so
// that a single registration's launch keeps its code (design note).
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
apply_cohort_kernel(const float* __restrict__ fields, const int32_t* __restrict__ ib,
                    const float* __restrict__ w, float* __restrict__ out, int channels, int n1,
                    int n2, int n3, int* __restrict__ staged_tiles) {
  tile_interp<Policy::kPlanned, 2, kBoxRows, true>(fields, ib, w, nullptr, out, channels, n1,
                                                   n2, n3, staged_tiles);
}

__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
displace_cohort_kernel(const float* __restrict__ fields, const float* __restrict__ disp,
                       float* __restrict__ out, int channels, int n1, int n2, int n3,
                       int* __restrict__ staged_tiles) {
  tile_interp<Policy::kDisplace, 2, kBoxRows, true>(fields, nullptr, nullptr, disp, out,
                                                    channels, n1, n2, n3, staged_tiles);
}

// A kernel of its own rather than C = 1 of displace_kernel: its own rounding
// (q = x + disp first), box, register count, row in a profile and launch
// counter.
__global__ void __launch_bounds__(kTileThreads, kWarpMinBlocks)
field_warp_kernel(const float* __restrict__ fields, const float* __restrict__ disp,
                  float* __restrict__ out, int channels, int n1, int n2, int n3,
                  int* __restrict__ staged_tiles) {
  tile_interp<Policy::kWarp, 1, kWarpBoxRows, false>(fields, nullptr, nullptr, disp, out,
                                                     channels, n1, n2, n3, staged_tiles);
}

unsigned int tiles_for(int n1, int n2, int n3) {
  return (unsigned int)((n1 + kTile1 - 1) / kTile1) * ((n2 + kTile2 - 1) / kTile2) *
         ((n3 + kTile3 - 1) / kTile3);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().
// subjects (K1, K2) is the cohort's S, 1 for a single registration: fields
// and out (C, S, N..), ib (S, 3, N..), w (S, 3, 4, N..), disp (S, 3, N..).
// staged_tiles, where not null, is a device int to which the kernel adds
// the number of tiles that took the staged branch.
extern "C" int tricubic_apply_f32(const void* fields, const void* ib, const void* w,
                                  void* out, int channels, int subjects, int n1, int n2,
                                  int n3, void* staged_tiles, void* stream) {
  const dim3 grid(tiles_for(n1, n2, n3), subjects);
  auto kernel = subjects == 1 ? apply_kernel : apply_cohort_kernel;
  kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const int32_t*)ib, (const float*)w, (float*)out, channels,
      n1, n2, n3, (int*)staged_tiles);
  return (int)cudaGetLastError();
}

extern "C" int tricubic_displace_many_f32(const void* fields, const void* disp, void* out,
                                          int channels, int subjects, int n1, int n2, int n3,
                                          void* staged_tiles, void* stream) {
  const dim3 grid(tiles_for(n1, n2, n3), subjects);
  auto kernel = subjects == 1 ? displace_kernel : displace_cohort_kernel;
  kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const float*)disp, (float*)out, channels, n1, n2, n3,
      (int*)staged_tiles);
  return (int)cudaGetLastError();
}

extern "C" int tricubic_displace_f32(const void* fields, const void* disp, void* out,
                                     int channels, int n1, int n2, int n3, void* staged_tiles,
                                     void* stream) {
  field_warp_kernel<<<tiles_for(n1, n2, n3), kTileThreads, 0, (cudaStream_t)stream>>>(
      (const float*)fields, (const float*)disp, (float*)out, channels, n1, n2, n3,
      (int*)staged_tiles);
  return (int)cudaGetLastError();
}
