// One trip of the LM loop of the two-view BCD stages, plain C interface.
//
// Replaces no TPU kernel: the JAX package runs each stage of
// spherical_bundle_adjuster_tpu/solver/lm.py as one lax.while_loop that
// XLA compiles whole. The port's loop (solver/lm.lm_fixed) is driven from
// the host, one read of the active counts a trip; op by op, a trip is
// 130-400 small aten kernels (the damped solve, the trial point's
// residuals, Jacobians, sums and the accept / reject updates, each a
// launch of a few microseconds on 1 to 131072 problems). Here a trip is
// two or three launches of these kernels around the one to three aten
// calls that take its products and sums over more than one element, and
// the stage's initial system is the same launches in an evaluate-only
// mode (ops/cuda_lm.Trips).
//
// Bit for bit with the op-by-op trip. The aten calls are the op-by-op
// trip's own on the same shapes (the depth stage's bmm j_rep^T rep; the
// 3x3 solve's einsum and the rotation / translation stages' einsums of H
// and g and sum of the Huber cost over the matches), so they round alike.
// Every other op is elementwise or a 3-term sum and is written here as
// aten's kernels compute it on the card, one rounding an op (mul / add /
// sub: __fmul_rn and friends, which nvcc never contracts into an fma):
// torch.sum over a last axis of 3 adds (a + c) + b; torch.linalg.cross
// writes fma(a, b, -(c d)); a batched 3x3 matmul is one fma chain, an
// unbatched one fma(a1, b1, a0 b0) + a2 b2; a tensor divided by a Python
// number is a product with its float reciprocal (found on an H100 against
// aten, PERF.md). Bit for bit matters: in corrected mode a start's path
// through a flat valley moves with the last bit, and a start chosen by
// another rounding at a near tie may explain the matches far worse than
// the one the benchmark's reference chooses.
//
// What bounds it on this card: latency. A depth trip moves ~200 bytes a
// problem (the loop state read and written, the bearings, the pose, the
// constant Jacobian block and the residual passed to the bmm); a rotation
// or translation trip reads its banks once and passes 100 bytes a match
// (residual, Jacobian, weighted Jacobian, cost) to the einsums. At the
// benchmark cells' shapes that is well under 10 us of bytes at 3.35 TB/s,
// against ~5 us a launch (PERF.md).
//
// Design:
//  * depth stage: one thread a 2x2 problem. depth_point reads the state
//    in place, solves the damped system by Cramer's rule, clamps the trial
//    depths at the lower bound and writes them and their 3 reprojection
//    residuals; depth_settle adds the barrier rows to the bmm's j_rep^T
//    rep, forms H (the constant J^T J block plus the barrier's diagonal)
//    and the cost, accepts or rejects, and writes the state back. A
//    finished problem is left as it is.
//  * rotation and translation stages: solve_kernel, one thread a problem,
//    writes the damped 3x3 system's cofactors and determinant; after
//    their einsum with g, point_kernel, one block a problem, forms the
//    trial point and its rotation constants (R, the right Jacobian, the
//    Rodrigues terms) in shared memory, and its threads stride over the
//    matches writing each one's residual, Jacobian (rotation_jacobian, or
//    the caller's identity), Huber-weighted Jacobian and masked Huber
//    cost; after the einsums of H and g and the cost's sum, settle_kernel,
//    one thread a problem, accepts or rejects. The bearing banks may be
//    shared: problem n reads bank n / per_bank. The depths are the compat
//    pair that every match shares (stride 0) or one pair a match.
//  * the next trip's counts: each settle adds the problems still active
//    after it, and those of them the stage keeps, into a (2,) int buffer
//    the host reads once a trip, one atomic a warp.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // a problem a thread
constexpr int kPointThreads = 256;  // a rotation / translation problem a block

// The loop state of N problems of n parameters (solver/lm._loop's tuple),
// the counts buffer and the kept mask (null: every problem is kept), and
// the damping constants of BaConfig.
struct Loop {
  float* x;       // (N, n)
  float* H;       // (N, n, n)
  float* g;       // (N, n)
  float* cost;    // (N,) of the accepted point
  float* cost_s;  // (N,) least cost seen
  float* lam;     // (N,)
  int* it;        // (N,)
  uint8_t* done;  // (N,)
  int* counts;    // (2,) active, active and kept, added to
  const uint8_t* kept;
  float lower_bound, lam_init, lam_down, lam_up, ftol;
};

// One rounding an op, as each aten kernel of the op-by-op trip rounds.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.sum over a last axis of 3 on the card: ((a + c) + b)
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, c), b); }
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}
// A batched 3x3 matmul's inner sum on the card (cuBLAS): one fma chain
// from the first product; an unbatched one (mm) adds the third product.
__device__ __forceinline__ float chain3(float a0, float b0, float a1, float b1, float a2,
                                        float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}
__device__ __forceinline__ float mm3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return add(__fmaf_rn(a1, b1, mul(a0, b0)), mul(a2, b2));
}
// a b - c d as aten's cross kernel compiles it: nvcc contracts the first
// product into an fma with the second, rounded, subtracted.
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -mul(c, d));
}

__device__ __forceinline__ float nan_min(float a, float b) {  // torch.minimum
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float clamp_low(float v, float lo) {  // torch.clamp(min=)
  return isnan(v) ? v : fmaxf(v, lo);
}

// A tensor divided by a Python number on the card is a product with the
// number's float reciprocal (aten's div_true_kernel_cuda); a Python number
// divided by a tensor is the tensor's reciprocal times the number.
__device__ __forceinline__ float div_by(float a, float b) { return mul(a, 1.0f / b); }

// Rodrigues terms of angle-axis aa (core/rotation.rotate_angle_axis):
// rotate(v) = v cos_t + (w x v) s theta + w (w . v) c.
struct Rodrigues {
  float w[3], s, theta, c, cos_t;
};

__device__ Rodrigues rodrigues(const float* aa) {
  Rodrigues q;
  const float theta2 = dot3(aa, aa);
  q.theta = sqrtf(add(theta2, 1e-32f));
  const bool small = theta2 < 1e-12f;
  q.s = small ? sub(1.0f, div_by(theta2, 6.0f)) : sinf(q.theta) / q.theta;
  q.c = small ? div_by(theta2, 2.0f) : sub(1.0f, cosf(q.theta));
  for (int k = 0; k < 3; ++k) q.w[k] = aa[k] / q.theta;
  q.cos_t = sub(1.0f, q.c);
  return q;
}

__device__ __forceinline__ void rotate(const Rodrigues& q, const float* v, float* out) {
  const float* w = q.w;
  const float wxv[3] = {cross_term(w[1], v[2], w[2], v[1]), cross_term(w[2], v[0], w[0], v[2]),
                        cross_term(w[0], v[1], w[1], v[0])};
  const float wdv = dot3(w, v);
  for (int k = 0; k < 3; ++k)
    out[k] = add(add(mul(v[k], q.cos_t), mul(mul(wxv[k], q.s), q.theta)),
                 mul(mul(w[k], wdv), q.c));
}

// res = d2 b2 - (R(r) (d1 b1) - t) (lm.reprojection_residual); x1 = d1 b1.
__device__ __forceinline__ void residual(const Rodrigues& q, const float* b1, const float* b2,
                                         float d1, float d2, const float* t, float* x1,
                                         float* res) {
  float x1r[3];
  for (int k = 0; k < 3; ++k) x1[k] = mul(b1[k], d1);
  rotate(q, x1, x1r);
  for (int k = 0; k < 3; ++k) res[k] = sub(mul(b2[k], d2), sub(x1r[k], t[k]));
}

// Damped LM step of the state of problem i: x - (H + lam diag(H) +
// 1e-12 I)^-1 g, clamped at the lower bound (lm._trip; smallmat.solve2 /
// solve3).
__device__ void trial2(const Loop& L, int i, float* xn) {
  const float* H = L.H + 4 * i;
  const float* g = L.g + 2 * i;
  const float lam = L.lam[i];
  const float a00 = add(add(H[0], mul(lam, H[0])), 1e-12f), a01 = H[1];
  const float a10 = H[2], a11 = add(add(H[3], mul(lam, H[3])), 1e-12f);
  const float inv_det = 1.0f / sub(mul(a00, a11), mul(a01, a10));
  const float s0 = mul(sub(mul(g[0], a11), mul(g[1], a01)), inv_det);
  const float s1 = mul(sub(mul(a00, g[1]), mul(a10, g[0])), inv_det);
  xn[0] = clamp_low(add(L.x[2 * i], -s0), L.lower_bound);
  xn[1] = clamp_low(add(L.x[2 * i + 1], -s1), L.lower_bound);
}

// The damped 3x3 system of problem i's state, its cofactors (cof[j][k])
// and determinant (smallmat.solve3 before its einsum).
__device__ void damped_cofactors(const Loop& L, int i, float* cof, float* det) {
  const float* H = L.H + 9 * i;
  const float lam = L.lam[i];
  float a[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      a[r][c] = r == c ? add(add(H[3 * r + c], mul(lam, H[3 * r + c])), 1e-12f) : H[3 * r + c];
  // a[r][c] a[u][v] - a[r'][c'] a[u'][v'], each product rounded
  auto minor = [&](int r, int c, int u, int v, int r2, int c2, int u2, int v2) {
    return sub(mul(a[r][c], a[u][v]), mul(a[r2][c2], a[u2][v2]));
  };
  const float m[9] = {
      minor(1, 1, 2, 2, 1, 2, 2, 1), minor(1, 2, 2, 0, 1, 0, 2, 2), minor(1, 0, 2, 1, 1, 1, 2, 0),
      minor(0, 2, 2, 1, 0, 1, 2, 2), minor(0, 0, 2, 2, 0, 2, 2, 0), minor(0, 1, 2, 0, 0, 0, 2, 1),
      minor(0, 1, 1, 2, 0, 2, 1, 1), minor(0, 2, 1, 0, 0, 0, 1, 2), minor(0, 0, 1, 1, 0, 1, 1, 0)};
  for (int k = 0; k < 9; ++k) cof[k] = m[k];
  *det = add(sub(mul(a[0][0], minor(1, 1, 2, 2, 1, 2, 2, 1)),
                 mul(a[0][1], minor(1, 0, 2, 2, 1, 2, 2, 0))),
             mul(a[0][2], minor(1, 0, 2, 1, 1, 1, 2, 0)));
}

// The accept / reject updates of problem i from its trial point xn and
// that point's system (Hn, gn, cn), or, evaluating, the loop's initial
// state at x. Returns whether the problem is active after the trip.
template <int N>
__device__ bool settle(const Loop& L, int i, bool evaluate, const float* xn, const float* Hn,
                       const float* gn, float cn) {
  if (evaluate) {
    for (int k = 0; k < N * N; ++k) L.H[N * N * i + k] = Hn[k];
    for (int k = 0; k < N; ++k) L.g[N * i + k] = gn[k];
    L.cost[i] = cn;
    L.cost_s[i] = cn;
    L.lam[i] = L.lam_init;
    L.it[i] = 0;
    L.done[i] = 0;
    return true;
  }
  const float cost = L.cost[i], lam = L.lam[i];
  const bool accept = cn < cost;
  const float lam_new =
      fminf(fmaxf(accept ? div_by(lam, L.lam_down) : mul(lam, L.lam_up), 1e-12f), 1e10f);
  const bool converged = accept && sub(cost, cn) <= mul(L.ftol, fmaxf(cost, 1e-30f));
  const bool stuck = !accept && lam >= 1e6f;
  if (accept) {
    for (int k = 0; k < N; ++k) L.x[N * i + k] = xn[k];
    for (int k = 0; k < N * N; ++k) L.H[N * N * i + k] = Hn[k];
    for (int k = 0; k < N; ++k) L.g[N * i + k] = gn[k];
    L.cost[i] = cn;
  }
  L.cost_s[i] = nan_min(cn, cost);
  L.lam[i] = lam_new;
  L.it[i] += 1;
  const bool done = converged || stuck;
  L.done[i] = done;
  return !done;
}

// Adds this warp's (left, left and kept) counts with one atomic each.
__device__ __forceinline__ void count(const Loop& L, bool left, bool keep) {
  const unsigned n_left = __popc(__ballot_sync(0xffffffffu, left));
  const unsigned n_keep = __popc(__ballot_sync(0xffffffffu, keep));
  if ((threadIdx.x & 31) == 0 && n_left) {
    atomicAdd(L.counts, (int)n_left);
    if (n_keep) atomicAdd(L.counts + 1, (int)n_keep);
  }
}

// ---------------------------------------------------------------------------
// Depth stage: per problem b1, b2, r, t (N, 3), j_rep (N, 3, 2) = [-R b1,
// b2], h_rep (N, 2, 2) = j_rep^T j_rep (solve_depths builds them once).

struct Depth {
  const float *b1, *b2, *r, *t, *j_rep, *h_rep;
  float bar_lambda, bar_c;
};

// A depth trip is two launches around j_rep^T rep, which the caller takes
// with the same bmm as the op-by-op trip: depth_point writes each active
// problem's trial depths dn (N, 2) and residual rep (N, 3) there;
// depth_settle takes gr = j_rep^T rep (N, 2), adds the barrier rows and
// accepts or rejects.

struct DepthScratch {
  float *dn, *rep;
};

__global__ void __launch_bounds__(kThreads)
depth_point(Loop L, Depth P, DepthScratch W, int n, int evaluate) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || (!evaluate && L.done[i])) return;
  float d[2];
  if (evaluate) {
    d[0] = L.x[2 * i];
    d[1] = L.x[2 * i + 1];
  } else {
    trial2(L, i, d);
  }
  const Rodrigues q = rodrigues(P.r + 3 * i);
  float x1[3], rep[3];
  residual(q, P.b1 + 3 * i, P.b2 + 3 * i, d[0], d[1], P.t + 3 * i, x1, rep);
  for (int k = 0; k < 2; ++k) W.dn[2 * i + k] = d[k];
  for (int k = 0; k < 3; ++k) W.rep[3 * i + k] = rep[k];
}

__global__ void __launch_bounds__(kThreads)
depth_settle(Loop L, Depth P, DepthScratch W, const float* gr, int n, int evaluate) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool left = false, keep = false;
  if (i < n && (evaluate || !L.done[i])) {
    const float* d = W.dn + 2 * i;
    const float* rep = W.rep + 3 * i;
    const float* h = P.h_rep + 4 * i;
    float bar[2], jb[2], Hn[4], gn[2];
    for (int k = 0; k < 2; ++k) {
      bar[k] = mul(P.bar_lambda, expf(mul(-P.bar_c, d[k])));
      jb[k] = mul(-P.bar_c, bar[k]);
      gn[k] = add(gr[2 * i + k], mul(jb[k], bar[k]));
    }
    Hn[0] = add(h[0], mul(jb[0], jb[0]));
    Hn[1] = h[1];
    Hn[2] = h[2];
    Hn[3] = add(h[3], mul(jb[1], jb[1]));
    const float cn = mul(0.5f, add(dot3(rep, rep), add(mul(bar[0], bar[0]), mul(bar[1], bar[1]))));
    left = settle<2>(L, i, evaluate, d, Hn, gn, cn);
    keep = left && (L.kept == nullptr || L.kept[i]);
  }
  count(L, left, keep);
}

// ---------------------------------------------------------------------------
// Rotation / translation stages: banks b1, b2 (N / per_bank, M, 3), depths
// d (N, 2) shared by every match or (N, M, 2), mask valid (N, M), and the
// pose part the stage holds fixed (N, 3): t for the rotation stage, r for
// the translation stage. A trip is three launches around the einsums and
// the sum that the caller takes with the same aten calls as the op-by-op
// trip: solve_kernel writes each active problem's damped cofactors cof
// (N, 3, 3) and determinant det (N,), whose einsum with g is the step;
// point_kernel writes the trial point xn (N, 3) and each match's residual
// res (N, M, 3), Jacobian J (N, M, 3, 3; the rotation stage only),
// Huber-weighted Jacobian Jw and masked Huber cost rhov (N, M);
// settle_kernel takes H (N, 3, 3), g (N, 3) and cost (N,) of the trial
// points and accepts or rejects.

struct Global {
  const float *b1, *b2, *d;
  const uint8_t* valid;
  const float* fixed;
  int m, per_bank, per_match, rotation, unbatched;
  float delta, delta2;
};

struct Point {  // the trial point's constants, in shared memory
  float p[3];
  Rodrigues q;
  float R[3][3], Jr[3][3], t[3];
};

// a @ b for 3x3 matrices as cuBLAS multiplies them: batched (chain3) or
// not (mm3).
__device__ __forceinline__ void matmul3(const float a[3][3], const float b[3][3], float c[3][3],
                                        bool unbatched = false) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[i][j] = unbatched ? mm3(a[i][0], b[0][j], a[i][1], b[1][j], a[i][2], b[2][j])
                          : chain3(a[i][0], b[0][j], a[i][1], b[1][j], a[i][2], b[2][j]);
}

// angle_axis_to_matrix and right_jacobian of r (core/rotation.py); K @ K
// is one 3x3 product when r has no leading axes (unbatched).
__device__ void rotation_matrices(const float* r, const Rodrigues& q, bool unbatched,
                                  float R[3][3], float Jr[3][3]) {
  const float theta2 = dot3(r, r);
  const float K[3][3] = {{0.0f, -r[2], r[1]}, {r[2], 0.0f, -r[0]}, {-r[1], r[0], 0.0f}};
  float KK[3][3];
  matmul3(K, K, KK, unbatched);
  const float cR = theta2 < 1e-12f ? sub(0.5f, div_by(theta2, 24.0f))
                                   : sub(1.0f, cosf(q.theta)) / fmaxf(theta2, 1e-32f);
  const bool small = theta2 < 1e-2f;
  const float safe2 = small ? 1.0f : theta2;
  const float safe = sqrtf(safe2);
  const float th4 = mul(theta2, theta2);
  const float a = small ? add(sub(0.5f, div_by(theta2, 24.0f)), div_by(th4, 720.0f))
                        : sub(1.0f, cosf(safe)) / safe2;
  const float b = small ? add(sub((float)(1.0 / 6.0), div_by(theta2, 120.0f)), div_by(th4, 5040.0f))
                        : sub(safe, sinf(safe)) / mul(safe2, safe);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      R[i][j] = add(add(e, mul(q.s, K[i][j])), mul(cR, KK[i][j]));
      Jr[i][j] = add(sub(e, mul(a, K[i][j])), mul(b, KK[i][j]));
    }
}

struct Scratch {
  float *xn, *res, *J, *Jw, *rhov;
};

__global__ void __launch_bounds__(kThreads)
solve_kernel(Loop L, float* cof, float* det, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n && !L.done[i]) damped_cofactors(L, i, cof + 9 * i, det + i);
}

// step (N, 3) = einsum("...ji,...j->...i", cof, g), det (N,): the trial
// point x - step / det (evaluating: x itself).
__global__ void __launch_bounds__(kPointThreads)
point_kernel(Loop L, Global P, Scratch W, const float* step, const float* det, int evaluate) {
  __shared__ Point pt;
  __shared__ int frozen;
  const int n = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) {
    frozen = !evaluate && L.done[n];
    if (!frozen) {
      for (int k = 0; k < 3; ++k)
        pt.p[k] = evaluate ? L.x[3 * n + k]
                           : clamp_low(add(L.x[3 * n + k], -(step[3 * n + k] / det[n])),
                                       L.lower_bound);
      for (int k = 0; k < 3; ++k) W.xn[3 * n + k] = pt.p[k];
      const float* fixed = P.fixed + 3 * n;
      const float* r = P.rotation ? pt.p : fixed;
      pt.q = rodrigues(r);
      for (int k = 0; k < 3; ++k) pt.t[k] = P.rotation ? fixed[k] : pt.p[k];
      if (P.rotation) rotation_matrices(r, pt.q, P.unbatched, pt.R, pt.Jr);
    }
  }
  __syncthreads();
  if (frozen) return;

  const size_t bank = (size_t)(n / P.per_bank) * P.m * 3;
  for (int m = tid; m < P.m; m += kPointThreads) {
    const size_t nm = (size_t)n * P.m + m;
    const float* dd = P.d + (P.per_match ? nm * 2 : (size_t)n * 2);
    float x1[3], res[3];
    residual(pt.q, P.b1 + bank + 3 * m, P.b2 + bank + 3 * m, dd[0], dd[1], pt.t, x1, res);
    // d res / d p: (R [x1]x) J_r(r) (rotation_jacobian), or I.
    float J[3][3];
    if (P.rotation) {
      const float S[3][3] = {{0.0f, -x1[2], x1[1]}, {x1[2], 0.0f, -x1[0]}, {-x1[1], x1[0], 0.0f}};
      float RS[3][3];
      matmul3(pt.R, S, RS);
      matmul3(RS, pt.Jr, J);
      for (int k = 0; k < 9; ++k) W.J[nm * 9 + k] = J[k / 3][k % 3];
    } else {
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) J[i][j] = i == j ? 1.0f : 0.0f;
    }
    // Huber(delta) IRLS weight and cost (lm.huber_weight, lm.huber_cost)
    const float valid = P.valid[nm] ? 1.0f : 0.0f;
    const float s = dot3(res, res);
    const bool inner = s <= P.delta2;
    const float root = sqrtf(fmaxf(s, 1e-32f));
    const float w = mul(inner ? 1.0f : mul(1.0f / root, P.delta), valid);
    const float rho = inner ? s : sub(mul(2.0f * P.delta, root), P.delta2);
    for (int k = 0; k < 9; ++k) W.Jw[nm * 9 + k] = mul(J[k / 3][k % 3], w);
    for (int k = 0; k < 3; ++k) W.res[nm * 3 + k] = res[k];
    W.rhov[nm] = mul(rho, valid);
  }
}

// One thread a problem: H (N, 3, 3), g (N, 3), cost (N,) of W.xn.
__global__ void __launch_bounds__(kThreads)
settle_kernel(Loop L, const float* xn, const float* H, const float* g, const float* cost, int n,
              int evaluate) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool left = false, keep = false;
  if (i < n && (evaluate || !L.done[i])) {
    left = settle<3>(L, i, evaluate, xn + 3 * i, H + 9 * i, g + 3 * i, cost[i]);
    keep = left && (L.kept == nullptr || L.kept[i]);
  }
  count(L, left, keep);
}

}  // namespace

extern "C" {

// Common arguments: the loop state x (N, n), H (N, n, n), g (N, n), cost,
// cost_s, lam (N,) f32, it (N,) i32, done (N,) u8; counts (2,) i32, added
// to; kept (N,) u8 or null. evaluate = 1: the initial system at x (a
// settle sets H, g, cost and cost_s there, and lam, it and done to the
// loop's start); evaluate = 0: one trip of the problems not done. Only the
// settles write the state.

#define SBA_SET_DEVICE(n)                                \
  if ((n) < 0) return (int)cudaErrorInvalidValue;        \
  cudaError_t err = cudaSetDevice(device);               \
  if (err != cudaSuccess) return (int)err;               \
  if ((n) == 0) return (int)cudaSuccess;

static inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Depth stage, first launch: dn (N, 2), rep (N, 3) of the active problems.
int sba_lm_depth_point(float* x, float* H, float* g, float* cost, float* cost_s, float* lam,
                       int* it, uint8_t* done, const float* b1, const float* b2, const float* r,
                       const float* t, float* dn, float* rep, int n, int evaluate,
                       float lower_bound, int device, cudaStream_t stream) {
  SBA_SET_DEVICE(n)
  const Loop L = {x, H, g, cost, cost_s, lam, it, done, nullptr, nullptr,
                  lower_bound, 0.0f, 0.0f, 0.0f, 0.0f};
  const Depth P = {b1, b2, r, t, nullptr, nullptr, 0.0f, 0.0f};
  depth_point<<<blocks(n), kThreads, 0, stream>>>(L, P, DepthScratch{dn, rep}, n, evaluate);
  return (int)cudaGetLastError();
}

// Depth stage, second launch, after gr = (j_rep^T @ rep[..., None])[..., 0].
int sba_lm_depth_settle(float* x, float* H, float* g, float* cost, float* cost_s, float* lam,
                        int* it, uint8_t* done, int* counts, const uint8_t* kept,
                        const float* h_rep, const float* dn, const float* rep, const float* gr,
                        int n, int evaluate, float lam_init, float lam_down, float lam_up,
                        float ftol, float bar_lambda, float bar_c, int device,
                        cudaStream_t stream) {
  SBA_SET_DEVICE(n)
  const Loop L = {x, H, g, cost, cost_s, lam, it, done, counts, kept,
                  0.0f, lam_init, lam_down, lam_up, ftol};
  const Depth P = {nullptr, nullptr, nullptr, nullptr, nullptr, h_rep, bar_lambda, bar_c};
  depth_settle<<<blocks(n), kThreads, 0, stream>>>(
      L, P, DepthScratch{const_cast<float*>(dn), const_cast<float*>(rep)}, gr, n, evaluate);
  return (int)cudaGetLastError();
}

// Rotation / translation stage, first launch of a trip: cof (N, 3, 3) and
// det (N,) of the active problems' damped systems.
int sba_lm_global_solve(float* x, float* H, float* g, float* cost, float* cost_s, float* lam,
                        int* it, uint8_t* done, float* cof, float* det, int n, int device,
                        cudaStream_t stream) {
  SBA_SET_DEVICE(n)
  const Loop L = {x, H, g, cost, cost_s, lam, it, done, nullptr, nullptr,
                  0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  solve_kernel<<<blocks(n), kThreads, 0, stream>>>(L, cof, det, n);
  return (int)cudaGetLastError();
}

// Its next launch (the first when evaluating), after step = einsum(cof,
// g): the trial points into xn (N, 3) and each match's res (N, M, 3), J
// (N, M, 3, 3; rotation only, else unused), Jw (N, M, 3, 3) and rhov (N,
// M). unbatched: the stage's start has no leading axes.
int sba_lm_global_point(float* x, float* H, float* g, float* cost, float* cost_s, float* lam,
                        int* it, uint8_t* done, const float* b1, const float* b2, const float* d,
                        const uint8_t* valid, const float* fixed, const float* step,
                        const float* det, float* xn, float* res, float* J, float* Jw,
                        float* rhov, int n, int m, int per_bank, int per_match, int rotation,
                        int unbatched, int evaluate, float lower_bound, float delta,
                        float delta2, int device, cudaStream_t stream) {
  if (m < 0 || per_bank < 1 || n % per_bank != 0) return (int)cudaErrorInvalidValue;
  SBA_SET_DEVICE(n)
  const Loop L = {x, H, g, cost, cost_s, lam, it, done, nullptr, nullptr,
                  lower_bound, 0.0f, 0.0f, 0.0f, 0.0f};
  const Global P = {b1, b2, d, valid, fixed, m, per_bank, per_match, rotation, unbatched,
                    delta, delta2};
  const Scratch W = {xn, res, J, Jw, rhov};
  point_kernel<<<n, kPointThreads, 0, stream>>>(L, P, W, step, det, evaluate);
  return (int)cudaGetLastError();
}

// Its last launch: the accept / reject updates from the trial points xn
// (N, 3) and their H (N, 3, 3), g (N, 3) and cost (N,); adds the counts.
int sba_lm_global_settle(float* x, float* H, float* g, float* cost, float* cost_s, float* lam,
                         int* it, uint8_t* done, int* counts, const uint8_t* kept,
                         const float* xn, const float* Hn, const float* gn, const float* cn,
                         int n, int evaluate, float lam_init, float lam_down, float lam_up,
                         float ftol, int device, cudaStream_t stream) {
  SBA_SET_DEVICE(n)
  const Loop L = {x, H, g, cost, cost_s, lam, it, done, counts, kept,
                  0.0f, lam_init, lam_down, lam_up, ftol};
  settle_kernel<<<blocks(n), kThreads, 0, stream>>>(L, xn, Hn, gn, cn, n, evaluate);
  return (int)cudaGetLastError();
}

}  // extern "C"
