// Exact brute-force 2-nearest-neighbour search (K3), plain C interface.
//
// Replaces top2_distances in spherical_bundle_adjuster_tpu/ops/
// pallas_match.py (the Pallas TPU kernel behind ops/match.match_descriptors).
//
// Computes, for each query q_i, the two smallest
//   d2(i, j) = max(|q_i|^2 + |t_j|^2 - 2 q_i . t_j, 0)
// over valid train rows j (invalid rows are +inf), with ties going to the
// lower index (lax.top_k's order), and returns sqrt distances and int32
// indices. The K1 x K2 distance matrix is never stored.
//
// What bounds it on this card: 2 * K1 * K2 * D flops (2048 x 2048 x 64 at
// the 2K slice: 0.54 GFLOP) against 1 MB of input, so it is compute-bound:
// 0.008 ms at the H100's 67 TFLOP/s of fp32 FMA. Before this design (one
// thread per query, 2-warp blocks, 16 train splits and a second merge
// kernel) it took 0.0690 ms at that shape on an H100 80GB HBM3 at 700 W,
// 11.6% of the bound; its plain version (cuBLAS product plus two argmins)
// takes 0.170 ms and torch.cdist + torch.topk 0.207 ms (PERF.md).
//
// Why CUDA cores and not tensor cores: the contract is identical indices
// to the plain version, and TF32 alone changes which neighbour wins on
// near-ties; at K = 64 the fp32 bound is already 0.008 ms. A 3xTF32 or
// split-bf16 screen with an exact fp32 re-check of the candidates is the
// design for 8K-scale banks (ROADMAP.md queue 2).
//
// Design, one launch (ops/cuda_match.top2_plan chooses the tiling):
//  * the grid is (splits, query tiles, pairs): each block takes a tile of
//    128 queries of one pair and a contiguous span of that pair's train
//    bank. At 2048 x 2048 that is 16 x 8 = 128 blocks of 256 threads a
//    pair, one wave on 132 SMs at one block per SM (168 registers a
//    thread). The pairs of a batch are independent problems with their
//    own banks, scratch rows and counters, and each block computes
//    exactly what it computes in a launch of its pair alone.
//  * register-tiled outer product: thread (a, b) of a 16 x 16 thread grid
//    owns queries a + 16 i and train rows b + 16 j of a 128 x 128 sub-tile
//    (i, j < 8), 64 accumulators. Each step of 4 along d reads its 8 query
//    and 8 train fragments from shared memory as 16-byte vectors: 16 loads
//    per 256 FMAs. Rows are padded to 68 floats (an odd number of 16-byte
//    units), so the 16 lanes that share a query read 16 different rows in
//    the two wavefronts 256 bytes need, and the query reads broadcast.
//  * the query tile and the train sub-tiles are copied with cp.async into
//    a ring of kStages buffers; sub-tile s + kStages - 1 is in flight while
//    sub-tile s is multiplied. |t|^2 of each staged row is computed once,
//    by one thread per row, while the other threads start on the product;
//    the validity flags are loaded a sub-tile ahead.
//  * each distance keeps the arithmetic of the first kernel: each
//    accumulator sums d = 0..63 in order with fmaf, |q|^2 and |t|^2 are
//    fmaf chains over d in order, and qq + tt - 2 cross is combined the
//    same way, so every float equals the first kernel's.
//  * merge inside the launch: each thread keeps the running top-2 of its 8
//    queries (its rows come in ascending index order, so a strict '<'
//    keeps the lower index). The 16 lanes of a query merge by warp
//    shuffles; each block writes its top-2 to a (splits, K1) scratch and
//    counts its arrival on its query tile's counter (after a
//    __threadfence); the block that arrives last folds the splits in order
//    and writes the rows, and resets the counter for the next launch. Every
//    merge orders candidates by (d2, index), so the result does not depend
//    on which thread or block saw a candidate: ties go to the lower index.
//  * why not a thread-block cluster with a merge through distributed shared
//    memory: on the H100 at most 15 clusters of 8 such blocks are resident
//    at once (cudaOccupancyMaxActiveClusters), so the 16 clusters of the 2K
//    banks ran in two waves and the kernel took twice as long (PERF.md).
//  * an all-invalid bank gives (inf, inf) with index 0; a query with fewer
//    than two valid rows keeps (inf, 0) in its second slot.
//
// Measurement variants (ops/kernels.build defines, kernel_times.py
// --ablate): SBA_NO_STAGE drops the train and query copies, SBA_NO_COMPUTE
// the product loop, SBA_NO_MERGE the merge of the blocks (block 0 writes
// its own top-2).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kDim = 64;        // SURF descriptor width
constexpr int kQTile = 128;     // queries per block
constexpr int kSub = 128;      // train rows per staged sub-tile
constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kGrid = 16;
constexpr int kPerQ = 8;        // queries per thread
constexpr int kPerT = kSub / kGrid;  // train rows per thread and sub-tile
constexpr int kPitch = kDim + 4;  // floats per staged row: 17 16-byte units
constexpr int kStages = 2;     // sub-tile buffers in the ring
constexpr int kMaxSplits = 64;  // blocks per query tile
constexpr int kChunks = kDim / 4;  // 16-byte copies per row

static_assert(kGrid * kPerQ == kQTile && kGrid * kPerT == kSub, "thread tile");
static_assert(kGrid * kGrid == kThreads, "thread grid");
static_assert(kSub + kQTile <= kThreads, "one thread per norm");

// A query's top-2, as the blocks exchange it.
struct __align__(16) Top2 {
  float d1, d2;
  int i1, i2;
};

constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)(kQTile + kStages * kSub) * kPitch  // rows
    + sizeof(float) * (kQTile + kSub)                            // norms
    + sizeof(int) * kSub                                         // valid
    + sizeof(Top2) * kQTile;                                     // merge

// 16 bytes from src, or zeros when `full` is false (src is then not read).
__device__ __forceinline__ void stage16(float* dst, const float* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [row0, row0 + n) of a (rows, 64) bank into a padded tile,
// zeros past `limit`.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n, int row0,
                                           int limit) {
#ifndef SBA_NO_STAGE
  for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool full = row0 + r < limit;
    const float* s = full ? src + (size_t)(row0 + r) * kDim + 4 * c : src;
    stage16(dst + r * kPitch + 4 * c, s, full);
  }
#endif
}

// |x|^2 as an fmaf chain over d = 0..63, in order.
__device__ __forceinline__ float sqnorm(const float* row) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kDim; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + d);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// Insert candidate (d2, j) into a top-2 whose members all have lower
// indices than j: a strict '<' keeps the lower index on ties.
__device__ __forceinline__ void insert(float d2, int j, float& b1, int& i1,
                                       float& b2, int& i2) {
  if (d2 < b1) {
    b2 = b1; i2 = i1;
    b1 = d2; i1 = j;
  } else if (d2 < b2) {
    b2 = d2; i2 = j;
  }
}

// (d, i) before (e, j) in (d2, index) order.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Fold the top-2 (e1, j1) <= (e2, j2) into (d1, i1) <= (d2, i2).
__device__ __forceinline__ void merge(float& d1, int& i1, float& d2, int& i2,
                                      float e1, int j1, float e2, int j2) {
  if (before(e1, j1, d1, i1)) {
    if (before(e2, j2, d1, i1)) {
      d2 = e2; i2 = j2;
    } else {
      d2 = d1; i2 = i1;
    }
    d1 = e1; i1 = j1;
  } else if (before(e1, j1, d2, i2)) {
    d2 = e1; i2 = j1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
top2_kernel(const float* __restrict__ q, const float* __restrict__ t,
            const uint8_t* __restrict__ valid, float* __restrict__ dist,
            int* __restrict__ idx, Top2* __restrict__ part,
            unsigned* __restrict__ count, int k1, int k2, int span) {
  // this block's pair: its banks, outputs, scratch rows and counters
  const size_t pair = blockIdx.z;
  q += pair * k1 * kDim;
  t += pair * k2 * kDim;
  valid += pair * k2;
  dist += pair * k1 * 2;
  idx += pair * k1 * 2;
  part += pair * gridDim.x * k1;
  count += pair * gridDim.y;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // kQTile x kPitch
  float* ts = qs + kQTile * kPitch;                  // kStages x kSub x kPitch
  float* qq = ts + kStages * kSub * kPitch;          // kQTile
  float* tt = qq + kQTile;                           // kSub
  int* tv = reinterpret_cast<int*>(tt + kSub);       // kSub
  Top2* mb = reinterpret_cast<Top2*>(tv + kSub);     // kQTile

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int a = (tid / 32) * 2 + lane / 16;  // queries a + 16 i
  const int b = lane % 16;                   // train rows b + 16 j
  const int q0 = blockIdx.y * kQTile;
  const int lo = blockIdx.x * span;
  const int hi = min(lo + span, k2);
  const int n_sub = hi > lo ? (hi - lo + kSub - 1) / kSub : 0;

  float b1[kPerQ], b2[kPerQ];
  int i1[kPerQ], i2[kPerQ];
#pragma unroll
  for (int i = 0; i < kPerQ; ++i) {
    b1[i] = b2[i] = INFINITY;
    i1[i] = i2[i] = 0;
  }

  // validity of this thread's row of the next sub-tile, loaded a sub-tile
  // ahead so that the load does not stall the norms
  int v_next = 0;
  if (n_sub > 0) {
    // prologue: the query tile with sub-tile 0, then sub-tiles up to
    // kStages - 2, one commit group each
    stage_rows(qs, q, kQTile, q0, k1);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_sub) stage_rows(ts + s * kSub * kPitch, t, kSub, lo + s * kSub, hi);
      stage_commit();
    }
    if (tid < kSub) v_next = lo + tid < hi && valid[lo + tid];
  }

  for (int s = 0; s < n_sub; ++s) {
    stage_wait<kStages - 2>();  // sub-tile s has landed
    __syncthreads();            // ... for every thread; buffer of s - 1 is free
    const int next = s + kStages - 1;
    if (next < n_sub)
      stage_rows(ts + (next % kStages) * kSub * kPitch, t, kSub, lo + next * kSub, hi);
    stage_commit();

    const float* T = ts + (s % kStages) * kSub * kPitch;
    const int row0 = lo + s * kSub;
    if (tid < kSub) {
      tv[tid] = v_next;
      const int r = row0 + kSub + tid;
      v_next = r < hi && valid[r];
      tt[tid] = sqnorm(T + tid * kPitch);
    } else if (s == 0 && tid < kSub + kQTile) {
      qq[tid - kSub] = sqnorm(qs + (tid - kSub) * kPitch);
    }

    float acc[kPerQ][kPerT];
#pragma unroll
    for (int i = 0; i < kPerQ; ++i)
#pragma unroll
      for (int j = 0; j < kPerT; ++j) acc[i][j] = 0.f;
#ifndef SBA_NO_COMPUTE
    const float* qa = qs + a * kPitch;
    const float* tb = T + b * kPitch;
#pragma unroll 1
    for (int d = 0; d < kDim; d += 4) {
      float4 qf[kPerQ], tf[kPerT];
#pragma unroll
      for (int i = 0; i < kPerQ; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qa + i * kGrid * kPitch + d);
#pragma unroll
      for (int j = 0; j < kPerT; ++j)
        tf[j] = *reinterpret_cast<const float4*>(tb + j * kGrid * kPitch + d);
#pragma unroll
      for (int i = 0; i < kPerQ; ++i)
#pragma unroll
        for (int j = 0; j < kPerT; ++j) {
          acc[i][j] = fmaf(qf[i].x, tf[j].x, acc[i][j]);
          acc[i][j] = fmaf(qf[i].y, tf[j].y, acc[i][j]);
          acc[i][j] = fmaf(qf[i].z, tf[j].z, acc[i][j]);
          acc[i][j] = fmaf(qf[i].w, tf[j].w, acc[i][j]);
        }
    }
#endif
    __syncthreads();  // the norms and flags of this sub-tile

    float qn[kPerQ];
#pragma unroll
    for (int i = 0; i < kPerQ; ++i) qn[i] = qq[a + kGrid * i];
#pragma unroll
    for (int j = 0; j < kPerT; ++j) {
      const int r = b + kGrid * j;
      const float tn = tt[r];
      const bool ok = tv[r];
#pragma unroll
      for (int i = 0; i < kPerQ; ++i) {
        float d2 = fmaxf(qn[i] + tn - 2.f * acc[i][j], 0.f);
        if (!ok) d2 = INFINITY;
        insert(d2, row0 + r, b1[i], i1[i], b2[i], i2[i]);
      }
    }
  }
  stage_wait<0>();  // nothing may be in flight when the block exits

  // the 16 lanes that share a query: butterfly merge, every lane ends
  // with the same top-2
#pragma unroll
  for (int i = 0; i < kPerQ; ++i) {
#pragma unroll
    for (int m = 1; m < kGrid; m *= 2) {
      const float e1 = __shfl_xor_sync(0xffffffffu, b1[i], m);
      const float e2 = __shfl_xor_sync(0xffffffffu, b2[i], m);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1[i], m);
      const int j2 = __shfl_xor_sync(0xffffffffu, i2[i], m);
      merge(b1[i], i1[i], b2[i], i2[i], e1, j1, e2, j2);
    }
    if (b == 0) mb[a + kGrid * i] = Top2{b1[i], b2[i], i1[i], i2[i]};
  }

  __syncthreads();
  const int qi = q0 + tid;
#if defined(SBA_NO_MERGE)
  // measurement variant: block 0 writes its own top-2
  if (blockIdx.x != 0) return;
  Top2 r = mb[min(tid, kQTile - 1)];
#else
  // every block's top-2 to device memory; the block of a query tile that
  // arrives last folds them in split order and writes the rows
  __shared__ bool last;
  if (tid < kQTile && qi < k1) part[(size_t)blockIdx.x * k1 + qi] = mb[tid];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  Top2 r = {INFINITY, INFINITY, 0, 0};
  if (tid < kQTile && qi < k1)
    for (unsigned k = 0; k < gridDim.x; ++k) {
      const float4 o = __ldcg(reinterpret_cast<const float4*>(part + (size_t)k * k1 + qi));
      merge(r.d1, r.i1, r.d2, r.i2, o.x, __float_as_int(o.z), o.y, __float_as_int(o.w));
    }
  if (tid == 0) count[blockIdx.y] = 0;  // ready for the next launch
#endif
  if (tid < kQTile && qi < k1) {
    reinterpret_cast<float2*>(dist)[qi] = make_float2(sqrtf(r.d1), sqrtf(r.d2));
    reinterpret_cast<int2*>(idx)[qi] = make_int2(r.i1, r.i2);
  }
}

}  // namespace

extern "C" {

// A batch of `pairs` independent problems, each pair's arrays one after
// the other: q: (pairs, k1, 64) f32; t: (pairs, k2, 64) f32, both 16-byte
// aligned; valid: (pairs, k2) u8 (torch.bool); dist: (pairs, k1, 2) f32;
// idx: (pairs, k1, 2) i32; part: (pairs, splits, k1) top-2 scratch, 16
// bytes each; count: one counter per (pair, query tile), zero before the
// launch and left zero after it, that no other launch uses while this one
// runs. The plan (ops/cuda_match.top2_plan): `q_tiles`
// tiles of `q_tile` queries (this kernel's kQTile), `splits` blocks per
// query tile, each taking `span` train rows (a multiple of kSub),
// splits * span >= k2. A plan this kernel does not run is refused.
int sba_top2(const float* q, const float* t, const uint8_t* valid, float* dist,
             int* idx, void* part, unsigned* count, int pairs, int k1, int k2,
             int dim, int q_tile, int q_tiles, int span, int splits, int device,
             cudaStream_t stream) {
  if (dim != kDim || pairs < 1 || pairs > 65535 || k1 < 1 || k2 < 1 || q_tile != kQTile ||
      q_tiles != (k1 + kQTile - 1) / kQTile || q_tiles > 65535 || span < kSub ||
      span % kSub != 0 || splits < 1 || splits > kMaxSplits ||
      (long long)splits * span < k2 ||
      ((uintptr_t)q | (uintptr_t)t | (uintptr_t)part) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // The library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' device before launching.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  top2_kernel<<<dim3(splits, q_tiles, pairs), kThreads, kSmemBytes, stream>>>(
      q, t, valid, dist, idx, static_cast<Top2*>(part), count, k1, k2, span);
  return (int)cudaGetLastError();
}

}  // extern "C"
