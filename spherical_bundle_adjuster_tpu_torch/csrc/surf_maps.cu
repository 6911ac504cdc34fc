// SURF dense maps on Hopper: the det-of-Hessian pyramid (K1) and the
// Haar / trace-sign maps (K2), plain C interface for ctypes.
//
// K1 sba_det_pyramid replaces det_octave_dense
// (spherical_bundle_adjuster_tpu/ops/pallas_surf.py:95, the Pallas TPU
// kernel behind ops/surf._det_maps_per_octave). K2 sba_haar_trace replaces
// haar_trace_maps (same file, :145, behind surf._haar_trace_maps_pallas).
//
// Both are box filters over an integral image: every value is a weighted
// sum of box sums, each box four corner reads. At the 2K slice's shapes
// (8 bands of 257 x 2049 floats, 16.9 MB) the least time on an H100 SXM
// (3.35 TB/s) is set by bytes: K1 reads the image once and writes 111.4
// MB (4 octaves x 5 layers, one launch), 0.038 ms; K2 writes 251.7 MB
// (hx, hy bf16 and the trace sign int8 at 12 scales), 0.080 ms.
//
// What held the first versions (one thread per value) back was not DRAM
// but the corner reads: 40 (K1) or 56 (K2) per value straight from L2,
// 11.3 GB per K2 call, and at octaves 1-3 the lanes of a warp read
// corners `step` floats apart, so one load touched up to 32 sectors.
//
// The corners lie on a lattice (ops/cuda_surf.py, "staging plan"): image
// row y * step + off[k] and column x * step + off[k'] for output (y, x),
// with 10 offsets for a K1 layer and 9 for a K2 scale. A tile of ty x tx
// outputs touches, per offset, a progression of stride `step`; offsets of
// one residue mod step that lie close together share one run. One block
// per tile stages exactly those rows and columns in shared memory (16-byte
// cp.async copies at step 1; at step 2-8 only the residues the offsets
// use, not the whole full-resolution row): ~0.95 GB of L2 reads per K2
// call instead of 11.3 GB. Each output then reads its 32 (K1) or 24 (K2)
// distinct corners from shared memory, lanes on consecutive outputs, so
// free of bank conflicts at every step. A K1 tile row whose filter does
// not fit the band (all of octave 3's layer 4 at 256 rows) is written
// -inf without reading anything. Each launch's part table (tilings and
// runs) travels in the kernel's parameter space, where a block's uniform
// reads are cheap.
//
// Arithmetic is the plain version's, bit for bit: each box is
// ((y1x1 - y0x1) - y1x0) + y0x0, each term w * s accumulated in list
// order, det = (dxx * dyy) - ((0.81f * dxy) * dxy), with the same float32
// weights and no FMA contraction (explicit _rn intrinsics).
//
// Measured at the 2K slice's shapes on an H100 80GB HBM3 at 700 W, in
// turns with the first versions in one call (kernel_times.py): K1 0.321
// ms for all 4 octaves (first version 0.602, 4 launches), K2 0.421 ms
// (0.942); 12% and 19% of the bounds above. Staging alone takes about
// half of K2's time and the shared-memory corner reads the other half;
// the two do not overlap (PERF.md section 6).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOffs = 10;  // lattice offsets of a part: K1 10, K2 9
constexpr int kMaxParts = 32;  // K1 layers or K2 scales a launch takes
constexpr int kSeg = 128;     // output columns a warp computes per task
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// One K1 layer of one octave or one K2 scale (ops/cuda_surf._part_row,
// same field order). Tiles [first, first + bands * nty * ntx) are its
// tiles, over an oh x ow output grid at stride 1 << shift; band b's
// output plane starts at out_off + b * band_stride. A run i of rows
// holds ty + re[i] slots from slot r0[i]: slot r0[i] + m is image row
// y0 * step + ro[i] + m * step for the tile's first output row y0; the
// column runs likewise, in every staged row of `pitch` floats. rb[k],
// cb[k]: the row and column slot of offset k for the tile's output 0.
struct Part {
  int first, ty, tx, nty, ntx, pitch, nr, nc;
  int shift, oh, ow, out_off, band_stride;
  int r0[kMaxOffs], ro[kMaxOffs], re[kMaxOffs];
  int c0[kMaxOffs], co[kMaxOffs], ce[kMaxOffs];
  int rb[kMaxOffs], cb[kMaxOffs];
  int size, half;        // K1: the filter size and its half
  float wt[kMaxOffs];    // K1: box weights, Dxx 3, Dyy 3, Dxy 4
};
static_assert(sizeof(Part) == 105 * 4, "a row of ops/cuda_surf's part table: PART_INTS");

// Every part of a launch, passed by value: the kernel reads it from the
// parameter (constant) bank, where a block's uniform reads are cheap.
struct Table {
  Part part[kMaxParts];
};

// A tile: its part, band, first output row and column, and extent.
struct Tile {
  int p, band, y0, x0, ny, nx;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Box sum from its corners, in the plain version's order.
__device__ __forceinline__ float box(float y1x1, float y0x1, float y1x0,
                                     float y0x0) {
  return __fadd_rn(__fsub_rn(__fsub_rn(y1x1, y0x1), y1x0), y0x0);
}

// acc + w * s without contraction.
__device__ __forceinline__ float madd(float acc, float w, float s) {
  return __fadd_rn(acc, __fmul_rn(w, s));
}

__device__ __forceinline__ void stage4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// 16 bytes, both addresses 16-byte aligned.
__device__ __forceinline__ void stage16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Wait for this thread's copies, then for the block's.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Tile t of the launch.
__device__ __forceinline__ Tile locate(const Table& T, int n_parts, int t) {
  int p = 0;
  while (p + 1 < n_parts && t >= T.part[p + 1].first) ++p;
  const Part& P = T.part[p];
  Tile at;
  int rem = t - P.first;
  const int per_band = P.nty * P.ntx;
  at.p = p;
  at.band = rem / per_band;
  rem -= at.band * per_band;
  at.y0 = (rem / P.ntx) * P.ty;
  at.x0 = (rem % P.ntx) * P.tx;
  at.ny = min(P.ty, P.oh - at.y0);
  at.nx = min(P.tx, P.ow - at.x0);
  return at;
}

// Issue the cp.async copies of the lattice under output rows [y0, y0 +
// ny) and columns [x0, x0 + nx) of band image `img` (row stride ld) into
// S. Image indices are clamped, which is the plain version's edge
// padding. Staged row s goes to warp s mod kWarps, its lanes on
// consecutive column slots; at step 1 each lane copies 16 bytes (column
// runs start 4-float aligned, and so do the image's rows).
__device__ __forceinline__ void stage_lattice(float* S, const float* img, int h, int w,
                                              int ld, int step, const Part& P, int y0,
                                              int ny, int x0, int nx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int s0 = 0;  // staged rows of the runs before run i
  for (int i = 0; i < P.nr; ++i) {
    const int rows = ny + P.re[i];
    for (int m = (warp - s0 % kWarps + kWarps) % kWarps; m < rows; m += kWarps) {
      const float* src = img + (size_t)clampi((y0 + m) * step + P.ro[i], 0, h) * ld;
      float* dst = S + (P.r0[i] + m) * P.pitch;
      for (int j = 0; j < P.nc; ++j) {
        const int c = x0 * step + P.co[j], n = nx + P.ce[j];
        float* d = dst + P.c0[j];
        if (step == 1) {
          for (int q = 4 * lane; q < n; q += 128) {
            if (c + q >= 0 && c + q + 3 <= w) {
              stage16(d + q, src + c + q);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) stage4(d + q + e, src + clampi(c + q + e, 0, w));
            }
          }
        } else {
          for (int mm = lane; mm < n; mm += 32) stage4(d + mm, src + clampi(c + mm * step, 0, w));
        }
      }
    }
    s0 += rows;
  }
}

// ---------------------------------------------------------------------------
// K1

struct DetArgs {
  const float* ii;
  float* out;
  int n_parts, n_tiles, h, w, ld;  // ld: the image's row stride
  Table T;
};

// The tile's output rows whose filter fits the band: [va, vb) of the tile.
__device__ __forceinline__ void det_valid_rows(const DetArgs& a, const Part& P,
                                               const Tile& at, int& va, int& vb) {
  const int ylo = (P.half + (1 << P.shift) - 1) >> P.shift;
  const int lim = a.h - (P.size - P.half);
  const int yhi = lim >= 0 ? lim >> P.shift : -1;
  va = max(ylo - at.y0, 0);
  vb = min(yhi - at.y0 + 1, at.ny);
}

struct DetOp {
  using Args = DetArgs;

  static __device__ __forceinline__ void stage(const DetArgs& a, const Part& P,
                                               const Tile& at, float* S) {
    int va, vb;
    det_valid_rows(a, P, at, va, vb);
    if (va < vb)
      stage_lattice(S, a.ii + (size_t)at.band * (a.h + 1) * a.ld, a.h, a.w, a.ld,
                    1 << P.shift, P, at.y0 + va, vb - va, at.x0, at.nx);
  }

  static __device__ __forceinline__ void compute(const DetArgs& a, const Part& P,
                                                 const Tile& at, const float* S) {
    const int step = 1 << P.shift, ow = P.ow;
    float* obase = a.out + P.out_off + (size_t)at.band * P.band_stride + at.y0 * ow + at.x0;
    int va, vb;
    det_valid_rows(a, P, at, va, vb);
    // rows of the tile outside [va, vb) are border: -inf
    for (int yl = 0; yl < at.ny; ++yl) {
      if (yl >= va && yl < vb) continue;
      for (int i = threadIdx.x; i < at.nx; i += kThreads) obase[yl * ow + i] = -INFINITY;
    }
    if (va >= vb) return;
    const int size = P.size, half = P.half, pitch = P.pitch;
    int rb[kMaxOffs], cb[kMaxOffs];
    float wt[kMaxOffs];
#pragma unroll
    for (int k = 0; k < kMaxOffs; ++k) {
      rb[k] = P.rb[k];
      cb[k] = P.cb[k];
      wt[k] = P.wt[k];
    }
    // Each warp takes kSeg-column segments of the valid rows; lane l
    // computes columns i0 + 32u, u < kSeg / 32: a warp's loads of one
    // corner hit 32 banks, and a lane's u-th load is its first plus an
    // immediate.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nseg = (at.nx + kSeg - 1) / kSeg;
    for (int task = warp; task < (vb - va) * nseg; task += kWarps) {
      const int ys = task / nseg;  // row of the staged strip
      const int i0 = (task - ys * nseg) * kSeg + lane;
      const float* rows[kMaxOffs];
#pragma unroll
      for (int k = 0; k < kMaxOffs; ++k) rows[k] = S + (rb[k] + ys) * pitch + i0;
      float* orow = obase + (va + ys) * ow + i0;
#pragma unroll
      for (int u = 0; u < kSeg / 32; ++u) {
        if (i0 + 32 * u >= at.nx) break;
        const int xd = (at.x0 + i0 + 32 * u) * step;
        float v = -INFINITY;
        if (xd >= half && xd <= a.w - (size - half)) {
          // the image at (y + off[r], x + off[k])
#define P_(r, k) rows[r][cb[k] + 32 * u]
          // Dxx: rows 2, 7; cols 0, 3, 6, 9
          float dxx = __fmul_rn(wt[0], box(P_(7, 3), P_(2, 3), P_(7, 0), P_(2, 0)));
          dxx = madd(dxx, wt[1], box(P_(7, 6), P_(2, 6), P_(7, 3), P_(2, 3)));
          dxx = madd(dxx, wt[2], box(P_(7, 9), P_(2, 9), P_(7, 6), P_(2, 6)));
          // Dyy: rows 0, 3, 6, 9; cols 2, 7
          float dyy = __fmul_rn(wt[3], box(P_(3, 7), P_(0, 7), P_(3, 2), P_(0, 2)));
          dyy = madd(dyy, wt[4], box(P_(6, 7), P_(3, 7), P_(6, 2), P_(3, 2)));
          dyy = madd(dyy, wt[5], box(P_(9, 7), P_(6, 7), P_(9, 2), P_(6, 2)));
          // Dxy: rows and cols 1, 4, 5, 8
          float dxy = __fmul_rn(wt[6], box(P_(4, 4), P_(1, 4), P_(4, 1), P_(1, 1)));
          dxy = madd(dxy, wt[7], box(P_(4, 8), P_(1, 8), P_(4, 5), P_(1, 5)));
          dxy = madd(dxy, wt[8], box(P_(8, 4), P_(5, 4), P_(8, 1), P_(5, 1)));
          dxy = madd(dxy, wt[9], box(P_(8, 8), P_(5, 8), P_(8, 5), P_(5, 5)));
#undef P_
          v = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(__fmul_rn(0.81f, dxy), dxy));
        }
        orow[32 * u] = v;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// K2

struct HaarArgs {
  const float* ii;
  __nv_bfloat16* hx;
  __nv_bfloat16* hy;
  int8_t* tr;
  int n_parts, n_tiles, h, w, ld;  // ld: the image's row stride
  Table T;
};

struct HaarOp {
  using Args = HaarArgs;

  static __device__ __forceinline__ void stage(const HaarArgs& a, const Part& P,
                                               const Tile& at, float* S) {
    stage_lattice(S, a.ii + (size_t)at.band * (a.h + 1) * a.ld, a.h, a.w, a.ld, 1, P,
                  at.y0, at.ny, at.x0, at.nx);
  }

  static __device__ __forceinline__ void compute(const HaarArgs& a, const Part& P,
                                                 const Tile& at, const float* S) {
    const int pitch = P.pitch;
    int rb[kMaxOffs], cb[kMaxOffs];
#pragma unroll
    for (int k = 0; k < kMaxOffs; ++k) {
      rb[k] = P.rb[k];
      cb[k] = P.cb[k];
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nseg = (at.nx + kSeg - 1) / kSeg;
    for (int task = warp; task < at.ny * nseg; task += kWarps) {
      const int yl = task / nseg;
      const int i0 = (task - yl * nseg) * kSeg + lane;
      const float* rows[kMaxOffs];  // staged row of offset k, at column i0
#pragma unroll
      for (int k = 0; k < kMaxOffs; ++k) rows[k] = S + (rb[k] + yl) * pitch + i0;
      const size_t o = P.out_off + (size_t)at.band * P.band_stride + (at.y0 + yl) * a.w +
                       at.x0 + i0;
#pragma unroll
      for (int u = 0; u < kSeg / 32; ++u) {
        if (i0 + 32 * u >= at.nx) break;
        // the image at (y + off[r], x + off[c])
#define P_(r, c) rows[r][cb[c] + 32 * u]
        // Haar, offsets 0: -r, 1: 0, 2: r
        const float hx = __fsub_rn(box(P_(2, 2), P_(0, 2), P_(2, 1), P_(0, 1)),
                                   box(P_(2, 1), P_(0, 1), P_(2, 0), P_(0, 0)));
        const float hy = __fsub_rn(box(P_(2, 2), P_(1, 2), P_(2, 0), P_(1, 0)),
                                   box(P_(1, 2), P_(0, 2), P_(1, 0), P_(0, 0)));
        // thirds trace, offsets 3..6: T0..T3, 7: B+b, 8: B+size-b; Dyy's
        // three row bands, then Dxx's three column bands, weights (1, -2, 1)
        float tr = box(P_(4, 8), P_(3, 8), P_(4, 7), P_(3, 7));
        tr = madd(tr, -2.f, box(P_(5, 8), P_(4, 8), P_(5, 7), P_(4, 7)));
        tr = __fadd_rn(tr, box(P_(6, 8), P_(5, 8), P_(6, 7), P_(5, 7)));
        tr = __fadd_rn(tr, box(P_(8, 4), P_(7, 4), P_(8, 3), P_(7, 3)));
        tr = madd(tr, -2.f, box(P_(8, 5), P_(7, 5), P_(8, 4), P_(7, 4)));
        tr = __fadd_rn(tr, box(P_(8, 6), P_(7, 6), P_(8, 5), P_(7, 5)));
#undef P_
        // a warp's store covers whole sectors: 64 B of hx, of hy, 32 B of signs
        a.hx[o + 32 * u] = __float2bfloat16_rn(hx);
        a.hy[o + 32 * u] = __float2bfloat16_rn(hy);
        a.tr[o + 32 * u] = (int8_t)((tr > 0.f) - (tr < 0.f));
      }
    }
  }
};

// ---------------------------------------------------------------------------
// One block per tile: stage its lattice, then compute its outputs. (Two
// ways of overlapping the two measured slower on an H100: a persistent
// double-buffered grid, and staging a tile in two halves; staging and
// compute added up in both.)

template <class Op>
__global__ void __launch_bounds__(kThreads) tile_kernel(const typename Op::Args a) {
  extern __shared__ __align__(16) float S[];
  const Tile at = locate(a.T, a.n_parts, blockIdx.x);
  // Measurement variants (kernel_times.py --ablate): without the copies,
  // the outputs come from whatever shared memory holds; without the
  // compute, nothing is written.
#ifndef SBA_NO_STAGE
  Op::stage(a, a.T.part[at.p], at, S);
#endif
  stage_wait();
#ifndef SBA_NO_COMPUTE
  Op::compute(a, a.T.part[at.p], at, S);
#endif
}

// smem: bytes of the staging buffer (dynamic shared memory above 48 KB
// needs the kernel's opt-in).
template <class Op>
cudaError_t launch_tiles(const typename Op::Args& a, int smem, int device,
                         cudaStream_t stream) {
  auto kernel = tile_kernel<Op>;
  if (smem > kMaxSmem || smem < 4 || a.n_tiles < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_tiles, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The table rows (host memory, int32) of n parts into T.
bool read_table(Table& T, const void* table, int n) {
  if (n < 1 || n > kMaxParts) return false;
  memcpy(T.part, table, n * sizeof(Part));
  return true;
}

}  // namespace

extern "C" {

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: each entry point selects the tensors' device before it
// launches.

// ii: (B, h+1, w+1) f32 with row stride ld (a multiple of 4 floats, bands
// (h+1) * ld apart, 16-byte aligned); out: every octave's (B, n_layers,
// oh, ow) f32 maps, one after the other. table: (n_parts, sizeof(Part) /
// 4) int32 in host memory, one struct Part per octave and layer
// (ops/cuda_surf._det_plan), with n_tiles tiles in all; smem: bytes of a
// block's staging buffer.
int sba_det_pyramid(const float* ii, float* out, const void* table, int n_parts,
                    int n_tiles, int h, int w, int ld, int smem, int device,
                    cudaStream_t stream) {
  DetArgs a{ii, out, n_parts, n_tiles, h, w, ld};
  if (!read_table(a.T, table, n_parts) || ld % 4 || ld <= w) return (int)cudaErrorInvalidValue;
  return (int)launch_tiles<DetOp>(a, smem, device, stream);
}

// ii: as for K1; hx, hy: (B, q, h, w) bf16; tr: (B, q, h, w) i8. table:
// (q, sizeof(Part) / 4) int32 in host memory, one struct Part per
// middle-layer scale, offsets [-r, 0, r, T0, T1, T2, T3, B+b, B+size-b]
// (Haar radius r; thirds geometry with B = -half), from
// ops/cuda_surf._haar_plan with n_tiles tiles in all; smem as for K1.
int sba_haar_trace(const float* ii, void* hx, void* hy, int8_t* tr, const void* table,
                   int q, int n_tiles, int h, int w, int ld, int smem, int device,
                   cudaStream_t stream) {
  HaarArgs a{ii, (__nv_bfloat16*)hx, (__nv_bfloat16*)hy, tr, q, n_tiles, h, w, ld};
  if (!read_table(a.T, table, q) || ld % 4 || ld <= w) return (int)cudaErrorInvalidValue;
  return (int)launch_tiles<HaarOp>(a, smem, device, stream);
}

}  // extern "C"
