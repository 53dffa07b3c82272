// The soft (differentiable) raytracer for Hopper (sm_90a): K10a-K10d and
// K10g-K10j, unmasked and masked, and the two-launch backwards K10e, K10f,
// K10k and K10l.
//
// K10a, soft_rt_pri_fwd_kernel<false> with the merge of its runs, replaces
// raytpu/kernels/soft_raytrace_pallas.py::_pri_fwd_kernel and K10b,
// soft_rt_pri_fwd_kernel<true> with its plan and merge,
// ::_pri_fwd_kernel_masked (K10a and K10b redesigned for Hopper around the
// pairs whose weight is exactly 0 at the running max and the few tiles
// that hold the work, below); K10c,
// soft_rt_pri_bwd_kernel<false>, the merge of its runs and its fixed-order
// sums, replaces _pri_bwd_fused_kernel and K10d, soft_rt_pri_bwd_kernel<true>
// with its plan, merge and sums, _pri_bwd_fused_kernel_masked (K10c and K10d
// redesigned for Hopper around the pairs whose weight is exactly 0 and the
// few tiles that hold the work, below); K10g,
// soft_rt_shw_fwd_kernel<false>, replaces _shw_fwd_kernel and K10h, <true>,
// _shw_fwd_kernel_masked, each with the merge of its runs; K10i,
// soft_rt_shw_bwd_kernel<false>, the merge and the sums, replaces
// _shw_bwd_fused_kernel and K10j, <true>, _shw_bwd_fused_kernel_masked
// (K10g-K10j redesigned for Hopper around the triples that add exactly
// nothing and the few tiles that hold the work, below). K10e, soft_rt_pri_bwd_tables_kernel and the
// sums of its runs and of the camera, replaces _pri_bwd_tables_kernel; K10f,
// soft_rt_pri_bwd_dirs_kernel, _pri_bwd_dirs_kernel (both redesigned for
// Hopper around the pairs whose weight is exactly 0, below); K10k,
// soft_rt_shw_bwd_consts_kernel and the sums of its runs,
// _shw_bwd_consts_kernel; K10l, soft_rt_shw_bwd_rays_kernel and the
// sources' sum, _shw_bwd_rays_kernel (both redesigned around the triples
// whose sigmoid is exactly 0, below).
// The wrappers take them where JAX does, above its fused limit
// (kernels/soft_raytrace.py::pri_two_launch, shw_two_launch), without a
// mask, as JAX's two-launch route takes none.
//
// What they compute. Primary: for every ray r (direction d, from the
// camera position g) and every row of the (Tp, 32) float32 table of
// kernels/soft_raytrace.py::primary_tri_constants, _primary_terms'
// Moller-Trumbore t, u, v from the precomputed camera terms, the margin
// min(u, v, 1 - u - v), and the logit
//   zs / max(t |d|, dmin, 0.1) + log_sigmoid(es margin) + log(active + 1e-20)
// with behind-camera and near-parallel pairs gated to weight 0; the 9 values
// [albedo rgb, g + t d, normal xyz]. A background hypothesis (logit 0, zero
// values) joins the softmax. The forward keeps JAX's chunk-by-chunk online
// form (a chunk's max, one exp(m - m_new) rescale of the carry, the chunk's
// sums) and writes out (9, R) = acc / s, m (R,) and s (R,). Shadow: for every
// source s and point w (the aggregated hit position), the optical depth
//   od = sum over rows of sigmoid(es margin) active sigmoid(zs (0.99 r - t))
// along the ray from s to w (pairs whose hit is behind the source or
// near-parallel give 0), summed chunk by chunk, and trans = exp(-16 od).
// The backwards take the saved m (primary) or trans (shadow) and the
// cotangents formed outside (primary: [d s, d acc_0..8], _primary_cot;
// shadow: d trans) and give, per pair at the saved m,
//   w = exp(logit - m), dL/dlogit = w (ds + sum_j da_j val_j),
//   dL/dval_j = w da_j
// (shadow: d od = -16 trans d trans), taken back by hand through
// _primary_terms to the table's 18 used columns, the camera position and the
// ray direction, or through _shadow_od_terms to the table's 14 used
// columns, the source and the point. Ties pass half the gradient to each
// side, as jnp.minimum and jnp.maximum do; d log_sigmoid(x) / dx =
// sigmoid(-x), d sigmoid(x) / dx = sigmoid (1 - sigmoid). A pair whose
// weight is exactly 0 (gated, or underflowed) contributes exactly 0 and is
// skipped, as its terms are all products with that 0. The JAX kernels also
// take a globals row and the lights table; _primary_terms reads the
// globals' first three entries only (the camera position, passed alone
// here) and deletes the lights table, whose gradient is exactly zero.
//
// Layout and design. The TPU grid walked (1,024-ray tile, chunk) in order,
// carrying (m, s, acc) or od in VMEM scratch, and the backward kept the
// whole d-table resident across the grid. Here one thread takes a ray (or a
// (source, point) pair), 256 a block, the carry in registers, and a block
// stages one chunk of <= 32 rows in shared memory, read by warp-uniform
// broadcast, with per-row values derived once: |n| and log(active + 1e-20)
// (primary; the shadow's below). The backwards run the same thread-a-ray loop
// over every chunk in order, so the per-ray gradients (d dirs, d world)
// add up in registers chunk by chunk, with the per-ray chains (|d|;
// 1 / |w - s|) applied once a chunk to the chunk's sums, as JAX's VJP of a
// broadcast does. A row's gradient is a sum over rays: for each row a warp
// adds its 32 lanes by shuffles (skipped where no lane has a pair), the
// block adds its 8 warps in order into its own (Tp, used) partial in device
// memory, and a block walks ray blocks g, g + groups, ...; the sum kernel
// adds the groups' partials in a fixed order. The camera's and the
// sources' gradients take the same two steps. No floating-point atomics:
// two calls give the same bits. (The first design; K10a-K10d and K10g-K10j
// have been redesigned since, below.)
//
// The masked kernels (K10b, K10d; K10h and K10j below) take a keep-mask
// over the port's ray tiles (kernels/intersect.py::ray_tiles: th x 256 / th pixel
// blocks of the H x W image, 16 x 16 for a frame, row-major over the tiles)
// in place of runs of 256 consecutive rays: a block (or, backward, each turn
// of a block's loop) takes one tile, reads the tile's keep bit for each
// chunk, the same for every thread, and skips a dropped chunk before staging
// it, leaving the carry (m, s, acc), or od, as it was, and adding nothing to
// any gradient, as JAX's pl.when(keep) does. Slots of a tile past the
// image's edge hold no ray: they read nothing, write nothing and add nothing.
// The primary mask is (n_tiles, n_chunks), the shadow mask (n_tiles, S,
// n_chunks), int32. A masked kernel with every bit set computes what its
// unmasked twin does, in the same order, for each ray.
//
// Bound on the H100: ~50-70 float operations and 4-6 exp/log/sqrt/divides
// a (ray, row) pair forward, 3-4x that backward, against ~40 B a ray and
// the table: bound by operations (chip_smoke.py counts them on its inputs).
// The two-launch halves each recompute every pair, so together they do the
// fused backward's operations and about twice its recomputes; K10c-K10f
// stop a pair that pri_pair_dead proves of weight 0 at that test, K10k and
// K10l a triple that shw_triple_dead finds dead at that test.
//
// Rounding. Built with -fmad=false and IEEE division and sqrt; every
// expression in the JAX kernels' order (the shadow's rsqrt as 1 / sqrt, as
// the plain version pins it), so the forwards match the plain PyTorch
// versions (kernels/soft_raytrace.py) to the order of their sums.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "work_items.cuh"

namespace {

constexpr int kThreads = 256;             // rays (or points) a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 32;             // rows a chunk
constexpr int kPriCols = 32;              // columns of the primary table
constexpr int kPriUsed = 18;              // of them read
constexpr int kPriRow = kPriUsed + 2;     // + |n|, log(active + 1e-20)
constexpr int kShwCols = 16;              // columns of the shadow table
constexpr int kShwUsed = 14;              // of them read
constexpr int kShwRow = 21;               // derived per (row, source)
constexpr int kSumSlices = 32;            // sum kernel: slices of groups
constexpr float kTNear = 0.1f;            // raytpu/render/soft.py::_T_NEAR
constexpr float kBig = 3.4028235e38f;
constexpr float kOdScale = 16.0f;
constexpr unsigned kFull = 0xffffffffu;

// d min(a, b) / da: 1 where a is the smaller, half on a tie.
__device__ __forceinline__ float dmin_first(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// d max(a, b) / da: 1 where a is the larger, half on a tie.
__device__ __forceinline__ float dmax_first(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0), jnp.cross's order.
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The ray of this thread in tile `tile` and whether it is one: the tile's
// slots are rays tile * 256 + threadIdx.x of R (unmasked), or a th x
// (256 / th) block of the H x W grid, row-major over the blocks (masked).
struct TileRay {
  int r;
  bool live;
};

template <bool kMasked>
__device__ __forceinline__ TileRay tile_ray(int tile, int R, int H, int W,
                                            int th) {
  if (!kMasked) {
    const int r = tile * kThreads + threadIdx.x;
    return {r, r < R};
  }
  const int tw = kThreads / th;
  const int tiles_x = (W + tw - 1) / tw;
  const int y = (tile / tiles_x) * th + threadIdx.x / tw;
  const int x = (tile % tiles_x) * tw + threadIdx.x % tw;
  const bool live = y < H && x < W;
  return {live ? y * W + x : 0, live};
}

// The per-point terms of the shadow ray from sp to w: d = w - sp, r2s
// (|d|^2, 1 where 0), sq = sqrt(r2s), rrec = 1 / sq, rr = r2s rrec and
// dh = d rrec.
struct ShadowRay {
  float d[3], dh[3], r2s, sq, rrec, rr;
  bool lit;
};

__device__ __forceinline__ ShadowRay shadow_ray(const float* w,
                                                const float* sp) {
  ShadowRay a;
#pragma unroll
  for (int j = 0; j < 3; ++j) a.d[j] = w[j] - sp[j];
  const float r2 = (a.d[0] * a.d[0] + a.d[1] * a.d[1]) + a.d[2] * a.d[2];
  a.lit = r2 > 0.0f;
  a.r2s = a.lit ? r2 : 1.0f;
  a.sq = sqrtf(a.r2s);
  a.rrec = 1.0f / a.sq;
  a.rr = a.r2s * a.rrec;
#pragma unroll
  for (int j = 0; j < 3; ++j) a.dh[j] = a.d[j] * a.rrec;
  return a;
}

// Warp sum of g[0..N) into dst (lane 0 writes), or zeros where no lane of
// the warp has a pair.
template <int N>
__device__ __forceinline__ void warp_sum_store(const float* g, bool mine,
                                               float* dst) {
  const int lane = threadIdx.x & 31;
  if (__any_sync(kFull, mine)) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float v = g[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(kFull, v, off);
      }
      if (lane == 0) dst[k] = v;
    }
  } else if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = 0.0f;
  }
}

// The first half of a (ray, row) pair's backward, in pri_pair_bwd's order,
// from the ray d and the row's n (columns 0-2), k0 (9), c2b (3-5) and cb1
// (6-8): the denominator and its guard, 1 / denom, t, u and v with their
// numerators, the margin's two operands and xs = es margin. pri_pair_dead
// (K10c-K10f's test) and pri_pair_rest (the derivative) both go on from it,
// so a pair's test and its gradient see the same bits.
struct PriTest {
  float denom, rec, t, nu, nv, u, v, muv, omu, xs;
  bool big;
};

__device__ __forceinline__ PriTest pri_test(const float* d, float n0,
                                            float n1, float n2, float k0,
                                            float c3, float c4, float c5,
                                            float c6, float c7, float c8,
                                            float es) {
  PriTest x;
  x.denom = -((d[0] * n0 + d[1] * n1) + d[2] * n2);
  x.big = fabsf(x.denom) > 1e-12f;
  const float safe = x.big ? x.denom : 1e-12f;
  x.rec = 1.0f / safe;
  x.t = k0 * x.rec;
  x.nu = (d[0] * c3 + d[1] * c4) + d[2] * c5;
  x.nv = (d[0] * c6 + d[1] * c7) + d[2] * c8;
  x.u = x.nu * x.rec;
  x.v = x.nv * x.rec;
  x.muv = fminf(x.u, x.v);
  x.omu = (1.0f - x.u) - x.v;
  x.xs = es * fminf(x.muv, x.omu);
  return x;
}

// The rest of a pair's backward from its test x, the gate passed: the
// weight at the saved max mp and, where it is not 0, the derivative (as
// pri_pair_bwd below, whose second half it is).
__device__ __forceinline__ bool pri_pair_rest(const PriTest& x,
                                              const float* c, const float* d,
                                              float dn, const float* gp,
                                              float mp, float ds,
                                              const float* da, float es,
                                              float zs, float* g, float* gcam,
                                              float* ddc, float* ddn) {
  const bool big = x.big;
  const float rec = x.rec, t = x.t, nu = x.nu, nv = x.nv;
  const float muv = x.muv, omu = x.omu, xs = x.xs;
  const float u = x.u, v = x.v;
  const float dist = t * dn;
  const float a1 = fmaxf(dist, c[17]);
  const float a2 = fmaxf(a1, kTNear);
  const float zinv = 1.0f / a2;
  const float ex = expf(-fabsf(xs));
  const float logit = (zs * zinv + (fminf(xs, 0.0f) - log1pf(ex))) + c[19];
  const float w = expf(logit - mp);
  if (w == 0.0f) return false;
  const bool finite_t = t < kBig;
  const float tp = finite_t ? t : 0.0f;
  // dL/dlogit = w (ds + sum_j da_j val_j).
  float inner = ds;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    inner += (da[j] * c[13 + j] + da[3 + j] * (gp[j] + tp * d[j])) +
             da[6 + j] * c[10 + j];
  }
  const float G = w * inner;
  // The values: albedo, normal, pos = g + tp d.
  float dtp = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g[13 + j] += w * da[j];
    g[10 + j] += w * da[6 + j];
    const float P = w * da[3 + j];
    gcam[j] += P;
    dtp += P * d[j];
    ddc[j] += P * tp;
  }
  // log(active + 1e-20): 1e20 on a row of active 0.
  g[16] += G / (c[16] + 1e-20f);
  // log_sigmoid(xs): sigmoid(-xs) = e / (1 + e) for xs >= 0, else
  // 1 / (1 + e), with e = exp(-|xs|).
  const float sig = xs >= 0.0f ? ex / (1.0f + ex) : 1.0f / (1.0f + ex);
  const float dmargin = G * sig * es;
  // zinv = 1 / max(max(dist, dmin), t_near), dist = t |d|.
  const float da2 = -(G * zs) / (a2 * a2);
  const float da1 = da2 * dmax_first(a1, kTNear);
  const float ddist = da1 * dmax_first(dist, c[17]);
  g[17] += da1 * dmax_first(c[17], dist);
  *ddn += ddist * t;
  const float dt = ddist * dn + (finite_t ? dtp : 0.0f);
  // margin = min(min(u, v), (1 - u) - v).
  const float dmuv = dmargin * dmin_first(muv, omu);
  const float domu = dmargin * dmin_first(omu, muv);
  const float du = dmuv * dmin_first(u, v) - domu;
  const float dv = dmuv * dmin_first(v, u) - domu;
  // t = k0 rec, u = nu rec, v = nv rec, rec = 1 / safe.
  g[9] += dt * rec;
  const float drec = (dt * c[9] + du * nu) + dv * nv;
  const float dnu = du * rec, dnv = dv * rec;
  const float dden = big ? -drec * (rec * rec) : 0.0f;
  // denom = -(d . n), nu = d . c2b, nv = d . cb1.
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g[j] -= dden * d[j];
    g[3 + j] += dnu * d[j];
    g[6 + j] += dnv * d[j];
    ddc[j] += (dnu * c[3 + j] + dnv * c[6 + j]) - dden * c[j];
  }
  return true;
}

// Adds one (ray, row) pair's gradient to the row's g[18], the camera's
// gcam[3], the ray's chunk sums ddc[3] (direction) and ddn (|d|). d the
// direction, dn = |d|, gp the camera position, mp the ray's saved max, ds
// and da its cotangents. False (nothing added) for a pair of weight 0.
__device__ __forceinline__ bool pri_pair_bwd(const float* c, const float* d,
                                             float dn, const float* gp,
                                             float mp, float ds,
                                             const float* da, float es,
                                             float zs, float* g, float* gcam,
                                             float* ddc, float* ddn) {
  const PriTest x = pri_test(d, c[0], c[1], c[2], c[9], c[3], c[4], c[5],
                             c[6], c[7], c[8], es);
  if (!(x.t > 1e-6f && fabsf(x.denom) > (1e-3f * dn) * c[18])) return false;
  return pri_pair_rest(x, c, d, dn, gp, mp, ds, da, es, zs, g, gcam, ddc, ddn);
}

constexpr float kSigZero = -100.0f;  // sigmoid below this: exactly 0

// The test of a (source, point, row) triple: the gate, u, v, the margin,
// xs = es margin and y = zs (0.99 rr - t), by shw_pair_bwd's expressions
// in its order, from the row staged for the source (stage_shw_row: s0 =
// (n, k0), s1 = (c2b, |n|), s2 = (cb1, 1e-3 |n|)) and the point pt = (dh,
// 0.99 rr). Every term and gradient of the triple goes on from these
// floats.
struct ShwTest {
  float denom, rec, t, nu, nv, u, v, muv, omu, xs, y;
  bool big, ok;
};

__device__ __forceinline__ ShwTest shw_test(float4 s0, float4 s1, float4 s2,
                                            float4 pt, float es, float zs) {
  ShwTest x;
  x.denom = -((pt.x * s0.x + pt.y * s0.y) + pt.z * s0.z);
  x.big = fabsf(x.denom) > 1e-12f;
  const float safe = x.big ? x.denom : 1e-12f;
  x.rec = 1.0f / safe;
  x.t = s0.w * x.rec;
  x.ok = (x.t > 1e-6f) & (fabsf(x.denom) > s2.w);
  x.nu = (pt.x * s1.x + pt.y * s1.y) + pt.z * s1.z;
  x.nv = (pt.x * s2.x + pt.y * s2.y) + pt.z * s2.z;
  x.u = x.nu * x.rec;
  x.v = x.nv * x.rec;
  x.muv = fminf(x.u, x.v);
  x.omu = (1.0f - x.u) - x.v;
  x.xs = es * fminf(x.muv, x.omu);
  x.y = zs * (pt.w - x.t);
  return x;
}

// The backward's test: gated, or xs or y below kSigZero, where 1 / (1 +
// expf(-x)) is exactly 0, so shw_pair_grad would add nothing (see K10k and
// K10l's note below). Or-ed bitwise, with no return between them, so that
// the compiler schedules a run of triples as one block.
__device__ __forceinline__ bool shw_dead(const ShwTest& x) {
  return !x.ok | (x.xs < kSigZero) | (x.y < kSigZero);
}

// The forward's test (K10g, K10h): true where the term cov0 active occ of a
// triple is +-0, so that skipping it leaves the chunk's sum (from +0, never
// -0) bit for bit as it was: gated (the kernels add nothing), or xs or y
// below kSigZero, where that sigmoid is exactly 0 and the other lies in [0,
// 1]; and only where the active column is finite and none of 1 - u - v, xs
// and y is NaN, as 0 inf and 0 NaN are NaN. A NaN u or v makes 1 - u - v
// NaN too, so the plain version's margin (a NaN-keeping minimum) is the
// kernels' (fminf) wherever a triple is marked.
__device__ __forceinline__ bool shw_term_dead(const ShwTest& x, float act) {
  const bool sane = (fabsf(act) <= kBig) & (x.omu == x.omu) &
                    (x.xs == x.xs) & (x.y == x.y);
  return sane & shw_dead(x);
}

// Adds the gradient of a triple that passed its gate to the row's g[14],
// the source's dsrc[3] and the point's chunk sums ddh[3] (unit direction)
// and drr (length), going on from its test x: the two sigmoids and, where
// neither is 0, the derivative. q the row in load order (unstage_shw_row),
// dh the point's unit direction, dl = d od of the pair. False (nothing
// added) where a sigmoid is 0.
__device__ __forceinline__ bool shw_pair_grad(const ShwTest& x,
                                              const float* q, const float* dh,
                                              float dl, const float* sp,
                                              float es, float zs, float* g,
                                              float* ddh, float* drr,
                                              float* dsrc) {
  const float cov0 = sigmoid(x.xs);
  const float occ = sigmoid(x.y);
  if (cov0 == 0.0f || occ == 0.0f) return false;
  const float cov = cov0 * q[13];
  // od term = cov0 active occ.
  const float dcov = dl * occ, docc = dl * cov;
  g[13] += dcov * cov0;
  const float dmargin = ((dcov * q[13]) * (cov0 * (1.0f - cov0))) * es;
  const float dy = (docc * (occ * (1.0f - occ))) * zs;
  *drr += dy * 0.99f;
  const float dt = -dy;
  const float dmuv = dmargin * dmin_first(x.muv, x.omu);
  const float domu = dmargin * dmin_first(x.omu, x.muv);
  const float du = dmuv * dmin_first(x.u, x.v) - domu;
  const float dv = dmuv * dmin_first(x.v, x.u) - domu;
  // t = k0 rec, u = nu rec, v = nv rec, rec = 1 / safe.
  const float dk0 = dt * x.rec;
  const float drec = (dt * q[12] + du * x.nu) + dv * x.nv;
  const float dnu = du * x.rec, dnv = dv * x.rec;
  const float dden = x.big ? -drec * (x.rec * x.rec) : 0.0f;
  // denom = -(dh . n), nu = dh . c2b, nv = dh . cb1, k0 = sp . n - n . v0.
  float dn[3], dc2b[3], dcb1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ddh[j] += (dnu * q[14 + j] + dnv * q[17 + j]) - dden * q[9 + j];
    dn[j] = dk0 * sp[j] - dden * dh[j];
    dc2b[j] = dnu * dh[j];
    dcb1[j] = dnv * dh[j];
    dsrc[j] += dk0 * q[9 + j];
  }
  g[12] -= dk0;
  // c2b = cross(e2, b), cb1 = cross(b, e1), b = sp - v0.
  float de1[3], de2[3], db[3], db2[3];
  cross3(q, dc2b, de2);
  cross3(dc2b, q + 6, db);
  cross3(q + 3, dcb1, db2);
  cross3(dcb1, q, de1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dbj = db[j] + db2[j];
    g[j] -= dbj;
    dsrc[j] += dbj;
    g[3 + j] += de1[j];
    g[6 + j] += de2[j];
    g[9 + j] += dn[j];
  }
  return true;
}

// Adds one (source, point, row) triple's gradient as shw_pair_grad does,
// from its test on the row q in load order (b 0-2, e1 3-5, e2 6-8, n 9-11,
// k0 12, active 13, c2b 14-16, cb1 17-19, |n| 20) and the point's unit
// direction dh and length rr. False (nothing added) where its weight is 0.
__device__ __forceinline__ bool shw_pair_bwd(const float* q, const float* dh,
                                             float rr, float dl,
                                             const float* sp, float es,
                                             float zs, float* g, float* ddh,
                                             float* drr, float* dsrc) {
  const ShwTest x = shw_test(
      make_float4(q[9], q[10], q[11], q[12]),
      make_float4(q[14], q[15], q[16], q[20]),
      make_float4(q[17], q[18], q[19], 1e-3f * q[20]),
      make_float4(dh[0], dh[1], dh[2], 0.99f * rr), es, zs);
  if (!x.ok) return false;
  return shw_pair_grad(x, q, dh, dl, sp, es, zs, g, ddh, drr, dsrc);
}

// The two-launch backwards (K10e/K10f primary, K10k/K10l shadow), JAX's
// route above its fused limit, split as JAX splits them: a row-major pass
// owns the table's rows and sweeps the rays, a ray-major pass owns each
// ray and sweeps every chunk. Neither needs the fused kernels' per-block
// partials of the whole table, so a large table fills the card where their
// 256 MiB cap leaves fewer blocks than SMs. The pair derivatives are K10c's and K10i's
// (pri_pair_bwd, shw_pair_bwd); each half drops the other half's outputs.

// K10e and K10f, redesigned for Hopper around the dead pairs. On the main
// path (512^2 on the 66,560-triangle torus, sharpness 40 / 40) 85% of the
// (ray, row) pairs pass the gate and only about 1 in 640 of those has a
// weight exp(logit - m) that is not 0, yet pri_pair_bwd works out the whole
// logit (two IEEE reciprocals, expf, log1pf, expf) before it finds that 0.
// pri_pair_dead below proves most of them 0 from the gate's own terms, and
// both kernels run pri_pair_bwd, unchanged, on the rest only.
//
// The bound. For a pair that passes the gate,
//   logit = (zs zinv + (min(xs, 0) - log1p(exp(-|xs|)))) + la,
// xs = es margin, la = log(active + 1e-20), zinv = 1 / max(max(t |d|,
// dmin), 0.1). Its upper bound
//   B = (zb + cap) + la,  zb = zs zinv_max (0 for zs < 0),
//   zinv_max = 1 / max(dmin, 0.1),  cap = min(xs, 0),
// takes the same operations in the same order, each replaced by one that is
// no smaller: max(max(t |d|, dmin), 0.1) >= max(dmin, 0.1) (fmaxf drops a
// NaN operand, so this holds for a NaN t |d| or dmin too), and a correctly
// rounded 1 / x falls as x grows, so zinv <= zinv_max; for zs >= 0,
// zs zinv <= zs zinv_max, and for zs < 0, zs zinv <= 0 as zinv > 0;
// log1pf of exp(-|xs|) in [0, 1] is >= 0, so the log-sigmoid term is <=
// cap. Rounding to nearest is monotone in each operand of a product by a
// non-negative number, a sum and a difference, so the float32 B is >= the
// float32 logit exactly: the rounding of B uses none of the slack (in any
// other order it would cost a few ulps of |B|, a few 1e-5 at |B| ~ 100,
// against a slack of 6). Then logit - m <= B - m, and where B - m <
// kDeadBelow = -110, expf(logit - m) is exactly 0 on the card: float32
// expf underflows to 0 below about -103.97, and tests/test_torch_gpu.py
// enumerates every float32 from -110 down to -200 on the device through
// raytpu_soft_rt_expf (built with these flags) to hold it. Such a pair
// adds exactly nothing today, so skipping it changes no bit.
//
// NaN and inf. Every comparison with a NaN is false, so a NaN anywhere in B
// or m falls through to pri_pair_bwd, which does what it always did: cap is
// `xs > 0 ? 0 : xs`, not fminf, so a NaN xs stays in B; zb of a NaN zs is
// NaN. B = -inf (xs = -inf) is dead, and its logit is -inf too; B = +inf
// (zs = +inf) never is; m = +inf makes every finite B dead, and w =
// exp(logit - inf) is 0 there too.
//
// Staging. A row is six float4s (stage_pri_row): the dead test reads the
// first four (q0-q2 and zb), the live path all six. A ray is four float4s
// (pack_pri_rays_kernel): (d, 1e-3 |d|), (m, |d|, ds, da0), da1-4, da5-8;
// the dead test reads the first two. |n|, la, |d| and 1e-3 |d| are the
// same expressions as K10c's, so the gate and the live path see the same
// bits.
//
// K10f: a thread a ray, 256 a block; the rows
// stream through a ring of kStages stages of whole chunks in shared memory,
// copied with cp.async two stages ahead, one barrier a stage. For each
// chunk, a thread tests all its rows and keeps a bit mask of the pairs not
// proved dead, then runs pri_pair_bwd on those in row order, so each lane
// of a warp walks its own live rows at once; the |d| chain follows once a
// chunk into the sum of its run of `run` chunks, and the runs are added in
// order, as K10c folds its work items, so d dirs equals K10c's bit for bit.
//
// K10e: row-stationary. A thread owns a row of the table: its staged
// constants and its 18 + 3 gradient sums stay in registers. A block owns
// 256 rows (8 chunks) and one of `splits` contiguous runs of ray tiles;
// the packed rays stream through a ring of tiles of kRayTile in shared
// memory (cp.async, two tiles ahead), read by every warp as a broadcast.
// For each group of 32 rays a thread tests its row against each and keeps
// a mask of the pairs not proved dead, then runs pri_pair_bwd on those in
// ray order: no shuffle, shared-memory write or barrier a pair. Each
// block writes its (256, 18) partial of its run and its camera sum; the
// runs' partials add in run order (sum_groups_kernel), the camera sums in
// block order, so two calls give the same bits.

constexpr float kDeadBelow = -110.0f;  // B - m below this: weight exactly 0
constexpr int kRowQ = 6;               // float4s of a staged row
constexpr int kRayQ = 4;               // float4s of a packed ray
constexpr int kStages = 3;             // ring depth, two stages in flight
constexpr int kStageRows = 128;        // rows (whole chunks) a K10f stage
constexpr int kRayTile = 128;          // rays a K10e tile

// Copies n float4s from src to dst, the block's threads in turn.
__device__ __forceinline__ void copy_async(float4* dst, const float4* src,
                                           int n) {
  for (int k = threadIdx.x; k < n; k += kThreads) cp_async16(dst + k, src + k);
}

// The row src (the table's 18 used columns) staged as six float4s:
// q0 = (n, k0): columns 0-2, 9; q1 = (c2b, |n|): 3-5; q2 = (cb1, la): 6-8;
// q3 = (zb, normal): 10-12; q4 = (albedo, active): 13-16; q5 = (dmin, 0, 0,
// 0): 17. |n| = sqrt((n0 n0 + n1 n1) + n2 n2) and la = log(active +
// 1e-20), the first design's per-chunk expressions.
__device__ __forceinline__ void stage_pri_row(const float* src, float zs,
                                              float4* q) {
  float c[kPriUsed];
#pragma unroll
  for (int k = 0; k < kPriUsed; ++k) c[k] = src[k];
  const float nm = sqrtf((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]);
  const float la = logf(c[16] + 1e-20f);
  const float zb = zs < 0.0f ? 0.0f : zs * (1.0f / fmaxf(c[17], kTNear));
  q[0] = make_float4(c[0], c[1], c[2], c[9]);
  q[1] = make_float4(c[3], c[4], c[5], nm);
  q[2] = make_float4(c[6], c[7], c[8], la);
  q[3] = make_float4(zb, c[10], c[11], c[12]);
  q[4] = make_float4(c[13], c[14], c[15], c[16]);
  q[5] = make_float4(c[17], 0.0f, 0.0f, 0.0f);
}

// A staged row back in the table's layout (18 columns, |n|, la), as
// pri_pair_bwd reads it.
__device__ __forceinline__ void unstage_pri_row(const float4* q, float* c) {
  const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4];
  c[0] = q0.x; c[1] = q0.y; c[2] = q0.z; c[9] = q0.w;
  c[3] = q1.x; c[4] = q1.y; c[5] = q1.z; c[18] = q1.w;
  c[6] = q2.x; c[7] = q2.y; c[8] = q2.z; c[19] = q2.w;
  c[10] = q3.y; c[11] = q3.z; c[12] = q3.w;
  c[13] = q4.x; c[14] = q4.y; c[15] = q4.z; c[16] = q4.w;
  c[17] = q[5].x;
}

// True where the pair of a ray (r0 = (d, 1e-3 |d|), saved max mp) and a
// staged row (q0-q2, zb; |n| nm = q1.w, la = q2.w) with test x adds
// nothing: gated, by pri_pair_bwd's own test, or of weight exactly 0 by the
// bound B above. False sends it to pri_pair_bwd (K10c and K10d: on to
// pri_pair_rest from x). The gate's tests and the bound's are or-ed
// bitwise, with no return between them, so that the compiler schedules a
// run of pairs as one block (a gated pair's B is computed and ignored).
__device__ __forceinline__ bool pri_dead(const PriTest& x, float4 r0,
                                         float nm, float zb, float la,
                                         float mp) {
  const float cap = x.xs > 0.0f ? 0.0f : x.xs;
  return !(x.t > 1e-6f) | !(fabsf(x.denom) > r0.w * nm) |
         (((zb + cap) + la) - mp < kDeadBelow);
}

// The test of a ray against the row's first three staged float4s.
__device__ __forceinline__ PriTest pri_row_test(float4 r0, float4 q0,
                                                float4 q1, float4 q2,
                                                float es) {
  const float d[3] = {r0.x, r0.y, r0.z};
  return pri_test(d, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q2.x, q2.y,
                  q2.z, es);
}

__device__ __forceinline__ bool pri_pair_dead(float4 q0, float4 q1,
                                              float4 q2, float zb, float4 r0,
                                              float mp, float es) {
  return pri_dead(pri_row_test(r0, q0, q1, q2, es), r0, q1.w, zb, q2.w, mp);
}

// The ray's values pri_pair_bwd reads, from its four packed float4s.
struct PriRay {
  float4 r0;  // (d, 1e-3 |d|)
  float d[3], dn, mp, ds, da[9];
};

__device__ __forceinline__ PriRay unpack_pri_ray(const float4* p) {
  PriRay a;
  const float4 r1 = p[1], r2 = p[2], r3 = p[3];
  a.r0 = p[0];
  a.d[0] = a.r0.x; a.d[1] = a.r0.y; a.d[2] = a.r0.z;
  a.mp = r1.x; a.dn = r1.y; a.ds = r1.z;
  a.da[0] = r1.w; a.da[1] = r2.x; a.da[2] = r2.y; a.da[3] = r2.z;
  a.da[4] = r2.w; a.da[5] = r3.x; a.da[6] = r3.y; a.da[7] = r3.z;
  a.da[8] = r3.w;
  return a;
}

// The rays packed as kRayQ float4s each (PriRay's order), Rp >= R of
// them, zeros past R.
__global__ void __launch_bounds__(kThreads)
    pack_pri_rays_kernel(const float* __restrict__ dirs,
                         const float* __restrict__ m,
                         const float* __restrict__ cot, int R, int Rp,
                         float4* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= Rp) return;
  float4* o = out + static_cast<size_t>(r) * kRayQ;
  if (r >= R) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    o[0] = z; o[1] = z; o[2] = z; o[3] = z;
    return;
  }
  float d[3], c[10];
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = dirs[static_cast<size_t>(j) * R + r];
#pragma unroll
  for (int j = 0; j < 10; ++j) c[j] = cot[static_cast<size_t>(j) * R + r];
  const float dn = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  o[0] = make_float4(d[0], d[1], d[2], 1e-3f * dn);
  o[1] = make_float4(m[r], dn, c[0], c[1]);
  o[2] = make_float4(c[2], c[3], c[4], c[5]);
  o[3] = make_float4(c[6], c[7], c[8], c[9]);
}

// The table's Tp rows staged (stage_pri_row) for K10f.
__global__ void __launch_bounds__(kThreads)
    pack_pri_rows_kernel(const float* __restrict__ consts, int Tp, float zs,
                         float4* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row < Tp) {
    stage_pri_row(consts + static_cast<size_t>(row) * kPriCols, zs,
                  out + static_cast<size_t>(row) * kRowQ);
  }
}

// K10e, replaces _pri_bwd_tables_kernel (see above): rows blockIdx.x * 256
// + threadIdx.x, ray tiles [blockIdx.y tps, (blockIdx.y + 1) tps) of the
// packed rays; partials (splits, Tp, 18), cam_partials (splits * blocks of
// rows, 3). Four blocks an SM (64 registers a thread, a few spilled to
// local memory) run faster than the three that 80 registers allow.
__global__ void __launch_bounds__(kThreads, 4)
    soft_rt_pri_bwd_tables_kernel(const float* __restrict__ consts, int Tp,
                                  const float* __restrict__ cam,
                                  const float4* __restrict__ rays, int R,
                                  int tps, float es, float zs,
                                  float* __restrict__ partials,
                                  float* __restrict__ cam_partials) {
  __shared__ float4 s_rays[kStages * kRayTile * kRayQ];
  __shared__ float s_cam[kWarps][3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.x * kThreads + tid;
  const bool row_live = row < Tp;
  const float gp[3] = {cam[0], cam[1], cam[2]};
  float4 q[kRowQ];
  if (row_live) {
    stage_pri_row(consts + static_cast<size_t>(row) * kPriCols, zs, q);
  } else {
#pragma unroll
    for (int k = 0; k < kRowQ; ++k) q[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float c[kPriRow];
  unstage_pri_row(q, c);
  const float4 q0 = q[0], q1 = q[1], q2 = q[2];
  const float zb = q[3].x;
  float g[kPriUsed], gcam[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kPriUsed; ++k) g[k] = 0.0f;
  const int n_tiles = (R + kRayTile - 1) / kRayTile;
  const int t0 = blockIdx.y * tps;
  const int nt = max(0, min(n_tiles, t0 + tps) - t0);
  auto issue = [&](int s) {
    if (s < nt) {
      copy_async(s_rays + (s % kStages) * kRayTile * kRayQ,
                 rays + static_cast<size_t>(t0 + s) * kRayTile * kRayQ,
                 kRayTile * kRayQ);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  for (int s = 0; s < nt; ++s) {
    cp_async_wait_one();
    __syncthreads();  // tile s is in; every thread is done with tile s - 1
    issue(s + 2);     // into tile s - 1's buffer
    if (!row_live) continue;
    const float4* buf = s_rays + (s % kStages) * kRayTile * kRayQ;
    const int n_valid = min(kRayTile, R - (t0 + s) * kRayTile);
    for (int grp = 0; grp < n_valid; grp += 32) {
      const float4* p = buf + grp * kRayQ;
      const int nv = min(32, n_valid - grp);
      unsigned mask = 0u;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        if (j < nv && !pri_pair_dead(q0, q1, q2, zb, p[j * kRayQ],
                                     p[j * kRayQ + 1].x, es)) {
          mask |= 1u << j;
        }
      }
      while (mask != 0u) {  // this row's pairs not proved dead, in ray order
        const int j = __ffs(mask) - 1;
        mask &= mask - 1u;
        const PriRay a = unpack_pri_ray(p + j * kRayQ);
        float ddc[3] = {0.0f, 0.0f, 0.0f}, ddn = 0.0f;  // K10f's
        pri_pair_bwd(c, a.d, a.dn, gp, a.mp, a.ds, a.da, es, zs, g, gcam,
                     ddc, &ddn);
      }
    }
  }
  if (row_live) {
    float* dst = partials + (static_cast<size_t>(blockIdx.y) * Tp + row) *
                                kPriUsed;
#pragma unroll
    for (int k = 0; k < kPriUsed; ++k) dst[k] = g[k];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float v = gcam[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) s_cam[warp][j] = v;
  }
  __syncthreads();
  if (tid < 3) {
    float sum = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) sum += s_cam[wp][tid];
    cam_partials[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                     3 + tid] = sum;
  }
}

// K10f, replaces _pri_bwd_dirs_kernel (see above): ray blockIdx.x * 256 +
// threadIdx.x; rows the staged table.
__global__ void __launch_bounds__(kThreads)
    soft_rt_pri_bwd_dirs_kernel(const float4* __restrict__ rows, int Tp,
                                int chunk, const float* __restrict__ cam,
                                const float* __restrict__ dirs, int R,
                                float es, float zs, int run,
                                const float* __restrict__ m,
                                const float* __restrict__ cot,
                                float* __restrict__ dd_out) {
  __shared__ float4 s_rows[kStages * kStageRows * kRowQ];
  const int tid = threadIdx.x;
  const int r = blockIdx.x * kThreads + tid;
  const bool live = r < R;
  const float gp[3] = {cam[0], cam[1], cam[2]};
  PriRay a;
  float d[3] = {0.0f, 0.0f, 0.0f};
  a.mp = 0.0f;
  a.ds = 0.0f;
#pragma unroll
  for (int j = 0; j < 9; ++j) a.da[j] = 0.0f;
  if (live) {
#pragma unroll
    for (int j = 0; j < 3; ++j) d[j] = dirs[static_cast<size_t>(j) * R + r];
    a.mp = m[r];
    a.ds = cot[r];
#pragma unroll
    for (int j = 0; j < 9; ++j) a.da[j] = cot[static_cast<size_t>(1 + j) * R + r];
  }
  a.dn = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  a.r0 = make_float4(d[0], d[1], d[2], 1e-3f * a.dn);
  float dd[3], prun[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a.d[j] = d[j];
    dd[j] = 0.0f;
    prun[j] = 0.0f;
  }
  float g[kPriUsed], gcam[3] = {0.0f, 0.0f, 0.0f};  // K10e's
#pragma unroll
  for (int k = 0; k < kPriUsed; ++k) g[k] = 0.0f;
  const int stage_rows = (kStageRows / chunk) * chunk;
  const int n_stages = (Tp + stage_rows - 1) / stage_rows;
  int in_run = run;  // chunks left in the current run
  auto issue = [&](int s) {
    if (s < n_stages) {
      const int row0 = s * stage_rows;
      copy_async(s_rows + (s % kStages) * kStageRows * kRowQ,
                 rows + static_cast<size_t>(row0) * kRowQ,
                 min(stage_rows, Tp - row0) * kRowQ);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_one();
    __syncthreads();  // stage s is in; every thread is done with s - 1
    issue(s + 2);     // into stage s - 1's buffer
    if (!live) continue;
    const float4* buf = s_rows + (s % kStages) * kStageRows * kRowQ;
    const int n_ch = min(stage_rows, Tp - s * stage_rows) / chunk;
    for (int cc = 0; cc < n_ch; ++cc) {
      const float4* q = buf + cc * chunk * kRowQ;
      unsigned mask = 0u;
#pragma unroll 8
      for (int i = 0; i < chunk; ++i) {
        const float4* qi = q + i * kRowQ;
        if (!pri_pair_dead(qi[0], qi[1], qi[2], qi[3].x, a.r0, a.mp, es)) {
          mask |= 1u << i;
        }
      }
      float ddc[3] = {0.0f, 0.0f, 0.0f}, ddn = 0.0f;
      while (mask != 0u) {  // the ray's pairs not proved dead, in row order
        const int i = __ffs(mask) - 1;
        mask &= mask - 1u;
        float c[kPriRow];
        unstage_pri_row(q + i * kRowQ, c);
        pri_pair_bwd(c, a.d, a.dn, gp, a.mp, a.ds, a.da, es, zs, g, gcam, ddc,
                     &ddn);
      }
      // |d| = sqrt((dx dx + dy dy) + dz dz), once a chunk, into the run's
      // sum, and the runs of `run` chunks added in order, as K10c does.
      const float dq = ddn * (0.5f / a.dn);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        prun[j] += ddc[j] + (dq * a.d[j] + dq * a.d[j]);
      }
      if (--in_run == 0 || s * (stage_rows / chunk) + cc + 1 == Tp / chunk) {
        in_run = run;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          dd[j] += prun[j];
          prun[j] = 0.0f;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < 3; ++j) dd_out[static_cast<size_t>(j) * R + r] = dd[j];
  }
}

// out[i] = expf(x[i]), built with the kernels' flags: the tests' probe of
// the float32 underflow that pri_pair_dead relies on.
__global__ void __launch_bounds__(kThreads)
    expf_probe_kernel(const float* __restrict__ x, int n,
                      float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = expf(x[i]);
}

// out[i] = sigmoid(x[i]), built with the kernels' flags: the tests' probe
// of the exact zero that shw_triple_dead relies on.
__global__ void __launch_bounds__(kThreads)
    sigmoid_probe_kernel(const float* __restrict__ x, int n,
                         float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = sigmoid(x[i]);
}

// The point r's shadow ray from the source at sp and its d od = gcot
// (-16) trans (0 where it is no point).
struct ShwPoint {
  ShadowRay a;
  float dl;
  bool active;
};

__device__ __forceinline__ ShwPoint shw_point(const float* w, const float* sp,
                                              const float* trans,
                                              const float* gcot, int src,
                                              int r, int R, bool live) {
  ShwPoint p;
  p.a = shadow_ray(w, sp);
  p.dl = 0.0f;
  if (live) {
    const size_t k = static_cast<size_t>(src) * R + r;
    p.dl = gcot[k] * trans[k] * (-kOdScale);
  }
  p.active = live && p.dl != 0.0f;
  return p;
}

__device__ __forceinline__ void load_point(const float* world, int r, int R,
                                           bool live, float* w) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    w[j] = live ? world[static_cast<size_t>(j) * R + r] : 0.0f;
  }
}

// K10k and K10l, redesigned for Hopper around the dead triples. On the main
// path (512^2 on the 66,560-triangle torus, one light, sharpness 40 / 40)
// about 62% of the (source, point, row) triples pass the gate and more than
// 99% of those have sigmoid(es margin) exactly 0, yet shw_pair_bwd works out
// both sigmoids (an expf and an IEEE divide each) before it finds that 0.
// shw_triple_dead below finds nearly all of them, and both kernels run
// shw_pair_bwd on the rest only.
//
// Exactness. The test is shw_test, the gate, u, v, the margin, xs = es
// margin and y = zs (0.99 rr - t), which shw_pair_bwd runs first itself
// (the build contracts nothing into an FMA), so xs and y are the very
// floats its two sigmoids take. sigmoid(x) = 1 / (1 + expf(-x)): below x =
// kSigZero = -100, -x > 100 lies past float32 expf's overflow (about
// 88.72), so expf(-x) = +inf and 1 / (1 + inf) = 0 exactly. Then cov0 or
// occ is 0 and shw_pair_bwd returns before it adds anything: a triple the
// test calls dead adds exactly what it adds today, nothing, so no bit of
// any output moves. tests/test_torch_gpu.py enumerates every float32 from
// -100 down to -200 on the device through raytpu_soft_rt_sigmoid (built
// with these flags) to hold it.
//
// NaN and inf. Every comparison with a NaN is false, so a NaN xs or y is
// not dead and falls through to shw_pair_bwd, which does what it always
// did; fminf drops a NaN u or v here exactly as it does there, so the
// margin is the same float; xs = -inf or y = -inf is dead, and its sigmoid
// is 1 / (1 + inf) = 0 too. A point whose d od is 0 (or no point) adds
// nothing and is skipped whole, as before.
//
// Staging. A row is six float4s for a source (stage_shw_row, the first
// design's per-chunk expressions, so the same bits): the dead test reads the
// first three, (n, k0), (c2b, |n|), (cb1, 1e-3 |n|); the live path also
// (b, active), (e1, 0), (e2, 0). A point is (dh, 0.99 rr) for the test and,
// packed for K10k (pack_shw_points_kernel, through shw_point), (d od, rr,
// 0, 0) beside it. 1e-3 |n| and 0.99 rr are the products shw_pair_bwd
// forms, taken once a row and once a point.
//
// K10l: a thread a point, 256 a block; the source's staged rows
// (pack_shw_rows_kernel, once a launch) stream through a ring of kStages
// stages of whole chunks in shared memory, copied with cp.async two stages
// ahead, one barrier a stage, read by every thread as a broadcast. For
// each chunk a thread tests its point against every row and keeps a mask of
// the triples not dead, then runs shw_pair_bwd on those in row order; K10i's
// chain through dh, rr, rrec and r2s follows once a chunk, and the point
// sums over the sources, K10i's runs of chunks, the chunks and the rows in
// K10i's order, so d world equals K10i's bit for bit. A block whose points all have d od 0
// for a source skips it. The sources' gradients: a (blocks, S, 3) partial
// of warp sums, added in order.
//
// K10k: row-stationary. A thread owns a row of the table: its staged
// constants for the current source and its 14 gradient sums stay in
// registers. A block owns 256 rows and one of `splits` contiguous runs of
// point tiles; the packed points stream through a ring of tiles of
// kPtTile in shared memory (cp.async, two tiles ahead), read by every warp
// as a broadcast. For each group of 32 points, a ballot of d od != 0 skips
// the points that add nothing (uniform across the block); a thread tests
// its row against the rest and keeps a mask of the triples not dead, then
// runs shw_pair_bwd on those in point order and drops the point's and the
// source's outputs: no shuffle, shared-memory write or barrier a triple.
// Each block writes its (256, 14) partial of its run; the runs' partials
// add in run order (sum_groups_kernel), so two calls give the same bits.

constexpr int kShwQ = 6;             // float4s of a staged shadow row
constexpr int kPtQ = 2;              // float4s of a packed point
constexpr int kPtTile = 256;         // points a K10k tile

// Row q of the shadow table (14 used columns) staged for the source at sp
// as six float4s: s0 = (n, k0), s1 =
// (c2b, |n|), s2 = (cb1, 1e-3 |n|), s3 = (b, active), s4 = (e1, 0), s5 =
// (e2, 0).
__device__ __forceinline__ void stage_shw_row(const float* q, const float* sp,
                                              float4* s) {
  float b[3], e1[3], e2[3], c2b[3], cb1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    b[j] = sp[j] - q[j];
    e1[j] = q[3 + j];
    e2[j] = q[6 + j];
  }
  const float k0 = ((sp[0] * q[9] + sp[1] * q[10]) + sp[2] * q[11]) - q[12];
  cross3(e2, b, c2b);
  cross3(b, e1, cb1);
  const float nm = sqrtf((q[9] * q[9] + q[10] * q[10]) + q[11] * q[11]);
  s[0] = make_float4(q[9], q[10], q[11], k0);
  s[1] = make_float4(c2b[0], c2b[1], c2b[2], nm);
  s[2] = make_float4(cb1[0], cb1[1], cb1[2], 1e-3f * nm);
  s[3] = make_float4(b[0], b[1], b[2], q[13]);
  s[4] = make_float4(e1[0], e1[1], e1[2], 0.0f);
  s[5] = make_float4(e2[0], e2[1], e2[2], 0.0f);
}

// A staged row back in load order (21 floats), as shw_pair_bwd and
// shw_pair_grad read it.
__device__ __forceinline__ void unstage_shw_row(const float4* s, float* q) {
  const float4 s0 = s[0], s1 = s[1], s2 = s[2], s3 = s[3], s4 = s[4],
               s5 = s[5];
  q[0] = s3.x; q[1] = s3.y; q[2] = s3.z; q[13] = s3.w;
  q[3] = s4.x; q[4] = s4.y; q[5] = s4.z;
  q[6] = s5.x; q[7] = s5.y; q[8] = s5.z;
  q[9] = s0.x; q[10] = s0.y; q[11] = s0.z; q[12] = s0.w;
  q[14] = s1.x; q[15] = s1.y; q[16] = s1.z; q[20] = s1.w;
  q[17] = s2.x; q[18] = s2.y; q[19] = s2.z;
}

// True where the triple of a point (pt = (dh, 0.99 rr)) and a staged row
// (s0-s2) adds nothing: gated, by shw_pair_bwd's own test, or with xs or y
// below kSigZero, where its sigmoid is exactly 0 (see above). False sends
// it to shw_pair_bwd. The tests are or-ed bitwise, with no return between
// them, so that the compiler schedules a run of triples as one block (a
// gated triple's xs and y are computed and ignored).
__device__ __forceinline__ bool shw_triple_dead(float4 s0, float4 s1,
                                                float4 s2, float4 pt,
                                                float es, float zs) {
  return shw_dead(shw_test(s0, s1, s2, pt, es, zs));
}

// The table's Tp rows staged (stage_shw_row) for each source (blockIdx.y)
// for K10l: out (S, Tp, kShwQ float4s).
__global__ void __launch_bounds__(kThreads)
    pack_shw_rows_kernel(const float* __restrict__ consts, int Tp,
                         const float* __restrict__ srcs,
                         float4* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int src = blockIdx.y;
  if (row >= Tp) return;
  const float sp[3] = {srcs[3 * src], srcs[3 * src + 1], srcs[3 * src + 2]};
  float q[kShwUsed];
#pragma unroll
  for (int k = 0; k < kShwUsed; ++k) {
    q[k] = consts[static_cast<size_t>(row) * kShwCols + k];
  }
  float4 s[kShwQ];
  stage_shw_row(q, sp, s);
  float4* o = out + (static_cast<size_t>(src) * Tp + row) * kShwQ;
#pragma unroll
  for (int k = 0; k < kShwQ; ++k) o[k] = s[k];
}

// The points packed for each source (blockIdx.y) for K10k: out (S, Rp,
// kPtQ float4s), Rp >= R, (dh, 0.99 rr) and (d od, rr, 0, 0) from
// shw_point; d od 0 past R.
__global__ void __launch_bounds__(kThreads)
    pack_shw_points_kernel(const float* __restrict__ srcs,
                           const float* __restrict__ world, int R, int Rp,
                           const float* __restrict__ trans,
                           const float* __restrict__ gcot,
                           float4* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int src = blockIdx.y;
  if (r >= Rp) return;
  const float sp[3] = {srcs[3 * src], srcs[3 * src + 1], srcs[3 * src + 2]};
  const bool live = r < R;
  float w[3];
  load_point(world, r, R, live, w);
  const ShwPoint p = shw_point(w, sp, trans, gcot, src, r, R, live);
  float4* o = out + (static_cast<size_t>(src) * Rp + r) * kPtQ;
  o[0] = make_float4(p.a.dh[0], p.a.dh[1], p.a.dh[2], 0.99f * p.a.rr);
  o[1] = make_float4(p.dl, p.a.rr, 0.0f, 0.0f);
}

// K10k, replaces _shw_bwd_consts_kernel (see above): rows blockIdx.x * 256
// + threadIdx.x, point tiles [blockIdx.y tps, (blockIdx.y + 1) tps) of each
// source's packed points (Rp a whole number of tiles); partials (splits,
// Tp, 14). Four blocks an SM (64 registers a thread, a few bytes spilled)
// ran faster than the three or two that more registers allow, tiles of
// 256 points than of 128, and 64 runs (kernels/soft_raytrace.py
// SHW_SPLITS) than 32, 16 or 8 (chip_smoke.py's phase 32 times 64 beside
// 32). At Tp = 66,560 the 64 runs' partials take 239 MB.
__global__ void __launch_bounds__(kThreads, 4)
    soft_rt_shw_bwd_consts_kernel(const float* __restrict__ consts, int Tp,
                                  const float* __restrict__ srcs, int S,
                                  const float4* __restrict__ pts, int Rp,
                                  int tps, float es, float zs,
                                  float* __restrict__ partials) {
  __shared__ float4 s_pts[kStages * kPtTile * kPtQ];
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x * kThreads + tid;
  const bool row_live = row < Tp;
  float g[kShwUsed];
#pragma unroll
  for (int k = 0; k < kShwUsed; ++k) g[k] = 0.0f;
  const int n_tiles = Rp / kPtTile;
  const int t0 = blockIdx.y * tps;
  const int nt = max(0, min(n_tiles, t0 + tps) - t0);
  for (int src = 0; src < S; ++src) {
    const float sp[3] = {srcs[3 * src], srcs[3 * src + 1],
                         srcs[3 * src + 2]};
    float q[kShwUsed], qs[kShwRow];  // a row past Tp: zeros, always gated
#pragma unroll
    for (int k = 0; k < kShwUsed; ++k) {
      q[k] = row_live ? consts[static_cast<size_t>(row) * kShwCols + k]
                      : 0.0f;
    }
    float4 s[kShwQ];
    stage_shw_row(q, sp, s);
    unstage_shw_row(s, qs);
    const float4* run =
        pts + (static_cast<size_t>(src) * Rp +
               static_cast<size_t>(t0) * kPtTile) * kPtQ;
    auto issue = [&](int k) {
      if (k < nt) {
        copy_async(s_pts + (k % kStages) * kPtTile * kPtQ,
                   run + static_cast<size_t>(k) * kPtTile * kPtQ,
                   kPtTile * kPtQ);
      }
      cp_async_commit();
    };
    __syncthreads();  // every thread is done with the last source's tiles
    issue(0);
    issue(1);
    for (int k = 0; k < nt; ++k) {
      cp_async_wait_one();
      __syncthreads();  // tile k is in; every thread is done with k - 1
      issue(k + 2);     // into tile k - 1's buffer
      const float4* buf = s_pts + (k % kStages) * kPtTile * kPtQ;
      for (int grp = 0; grp < kPtTile; grp += 32) {
        const float4* p = buf + grp * kPtQ;
        // The points of d od not 0: the same bits in every warp.
        const unsigned act =
            __ballot_sync(kFull, p[lane * kPtQ + 1].x != 0.0f);
        unsigned mask = 0u;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          if (((act >> j) & 1u) &&
              !shw_triple_dead(s[0], s[1], s[2], p[j * kPtQ], es, zs)) {
            mask |= 1u << j;
          }
        }
        while (mask != 0u) {  // this row's triples not dead, in point order
          const int j = __ffs(mask) - 1;
          mask &= mask - 1u;
          const float4 pt = p[j * kPtQ], pl = p[j * kPtQ + 1];
          const float dh[3] = {pt.x, pt.y, pt.z};
          float ddh[3] = {0.0f, 0.0f, 0.0f}, drr = 0.0f;  // K10l's
          float dsrc[3] = {0.0f, 0.0f, 0.0f};
          shw_pair_bwd(qs, dh, pl.y, pl.x, sp, es, zs, g, ddh, &drr, dsrc);
        }
      }
    }
  }
  if (row_live) {
    float* dst =
        partials + (static_cast<size_t>(blockIdx.y) * Tp + row) * kShwUsed;
#pragma unroll
    for (int k = 0; k < kShwUsed; ++k) dst[k] = g[k];
  }
}

// K10l, replaces _shw_bwd_rays_kernel (see above): point blockIdx.x * 256
// + threadIdx.x; rows the table staged for each source (S, Tp, kShwQ).
__global__ void __launch_bounds__(kThreads)
    soft_rt_shw_bwd_rays_kernel(const float4* __restrict__ rows, int Tp,
                                int chunk, const float* __restrict__ srcs,
                                int S, const float* __restrict__ world,
                                int R, const float* __restrict__ trans,
                                const float* __restrict__ gcot, float es,
                                float zs, int run,
                                float* __restrict__ src_partials,
                                float* __restrict__ dw_out) {
  __shared__ float4 s_rows[kStages * kStageRows * kShwQ];
  __shared__ float s_src[kWarps][3];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r = blockIdx.x * kThreads + tid;
  const bool live = r < R;
  float w[3];
  load_point(world, r, R, live, w);
  float dw[3] = {0.0f, 0.0f, 0.0f};
  float g[kShwUsed];  // K10k's
#pragma unroll
  for (int k = 0; k < kShwUsed; ++k) g[k] = 0.0f;
  const int stage_rows = (kStageRows / chunk) * chunk;
  const int n_stages = (Tp + stage_rows - 1) / stage_rows;
  const int n_chunks = Tp / chunk;
  for (int src = 0; src < S; ++src) {
    const float sp[3] = {srcs[3 * src], srcs[3 * src + 1],
                         srcs[3 * src + 2]};
    const ShwPoint p = shw_point(w, sp, trans, gcot, src, r, R, live);
    const ShadowRay& a = p.a;
    const float4 pt = make_float4(a.dh[0], a.dh[1], a.dh[2], 0.99f * a.rr);
    const float4* src_rows = rows + static_cast<size_t>(src) * Tp * kShwQ;
    // K10i's fold: a run's chunks into prun from 0, the runs into dws.
    float dws[3] = {0.0f, 0.0f, 0.0f}, prun[3] = {0.0f, 0.0f, 0.0f};
    float dsrc[3] = {0.0f, 0.0f, 0.0f};
    auto issue = [&](int s) {
      if (s < n_stages) {
        const int row0 = s * stage_rows;
        copy_async(s_rows + (s % kStages) * kStageRows * kShwQ,
                   src_rows + static_cast<size_t>(row0) * kShwQ,
                   min(stage_rows, Tp - row0) * kShwQ);
      }
      cp_async_commit();
    };
    // Also the barrier after every thread's last use of the stages and of
    // s_src for the source before.
    if (__syncthreads_or(p.active)) {
      issue(0);
      issue(1);
      for (int s = 0; s < n_stages; ++s) {
        cp_async_wait_one();
        __syncthreads();  // stage s is in; every thread is done with s - 1
        issue(s + 2);     // into stage s - 1's buffer
        if (!p.active) continue;
        const float4* buf = s_rows + (s % kStages) * kStageRows * kShwQ;
        const int n_ch = min(stage_rows, Tp - s * stage_rows) / chunk;
        for (int cc = 0; cc < n_ch; ++cc) {
          const float4* q = buf + cc * chunk * kShwQ;
          unsigned mask = 0u;
#pragma unroll 8
          for (int i = 0; i < chunk; ++i) {
            const float4* qi = q + i * kShwQ;
            if (!shw_triple_dead(qi[0], qi[1], qi[2], pt, es, zs)) {
              mask |= 1u << i;
            }
          }
          float ddh[3] = {0.0f, 0.0f, 0.0f}, drr = 0.0f;
          while (mask != 0u) {  // the point's triples not dead, in row order
            const int i = __ffs(mask) - 1;
            mask &= mask - 1u;
            float qs[kShwRow];
            unstage_shw_row(q + i * kShwQ, qs);
            shw_pair_bwd(qs, a.dh, a.rr, p.dl, sp, es, zs, g, ddh, &drr,
                         dsrc);
          }
          // K10i's chain through dh, rr, rrec and r2s to d = w - sp.
          float drrec = drr * a.r2s;
          float dd[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            dd[j] = ddh[j] * a.rrec;
            drrec += ddh[j] * a.d[j];
          }
          const float dsq = -drrec / (a.sq * a.sq);
          const float dr2s = drr * a.rrec + dsq * (0.5f / a.sq);
          const float dr2 = a.lit ? dr2s : 0.0f;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            dd[j] += dr2 * a.d[j] + dr2 * a.d[j];
            prun[j] += dd[j];
            dsrc[j] -= dd[j];
          }
          const int c = s * (stage_rows / chunk) + cc + 1;  // chunks done
          if (c % run == 0 || c == n_chunks) {
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              dws[j] += prun[j];
              prun[j] = 0.0f;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) dw[j] += dws[j];
    warp_sum_store<3>(dsrc, p.active, s_src[warp]);
    __syncthreads();
    if (tid < 3) {
      float sum = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp) sum += s_src[wp][tid];
      src_partials[(static_cast<size_t>(blockIdx.x) * S + src) * 3 + tid] =
          sum;
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < 3; ++j) dw_out[static_cast<size_t>(j) * R + r] =
        dw[j];
  }
}

// K10g-K10j, redesigned for Hopper. On the culled steps and frames (512^2,
// the 9,216-, 36,000- and 66,560-triangle meshes) a third of the (tile,
// source, chunk) triples are kept, more than 95% of the kept triples that
// pass the gate have a sigmoid that is exactly 0, and a few tiles hold most
// of the kept chunks; the first design (a block a tile, every kept chunk
// derived by one warp between two barriers, every triple's sigmoids worked
// out in full) ran 11-28x its bound there. Three changes:
//
// - Exact early-outs. The backward (K10i, K10j) runs shw_dead, K10k's and
//   K10l's test, on every triple before the derivative: a dead triple adds
//   nothing today, so no bit moves. The forward (K10g, K10h) adds its term
//   cov0 active occ to od, so it skips a triple only where that term is
//   +-0 (shw_term_dead): a sum that starts at +0 never becomes -0, and
//   adding +-0 leaves it as it was, so od keeps its bits. Both go on from
//   the test's own floats (ShwTest) to the term or the derivative, as the
//   test is the first half of either: a triple that is not dead pays no
//   second reciprocal. A warp walks a chunk's rows in order; the rows no
//   lane keeps cost it the test alone.
// - Rows staged once a launch. The masked kernels read each source's rows
//   as pack_shw_rows_kernel staged them (stage_shw_row, six float4s a
//   row), a kept chunk at a time through a cp.async ring of kShwRing
//   stages, two ahead, one barrier a stage. The unmasked kernels, whose
//   callers run them on tables of a chunk or two (the Cornell box: 32
//   rows) 500 times a fit, stage the rows of their chunks in the same ring
//   with the same expressions (the same bits), and save the staging launch.
// - Work items of at most `run` kept chunks. A (tile, source)'s kept chunks
//   (every chunk, unmasked) are cut into runs of `run` in order, a work
//   item each, laid out in (tile, source, run) order; the masked kernels'
//   items come from the plan (shw_plan_kernel: each pair's kept chunks in
//   order; shw_items_kernel: the items' offsets), made on the card, with no
//   host sync. Block b takes items b, b + blocks, ... (a fixed rule, no
//   atomic counter), so the few tiles that hold most of the work spread
//   over the card, and every sum adds in a fixed order: two calls give the
//   same bits. An item sums od, or d world, over its run's chunks from 0;
//   a merge (shw_fwd_merge_kernel, shw_bwd_merge_kernel) folds the runs of
//   a (tile, source) in run order, and d world the sources in order, as
//   k7a_merge_kernel folds K7a's runs. With one run a pair (and, backward,
//   one source) an unmasked kernel writes trans, or d world, itself.
//   K10l folds d world's chunks in the same runs, so its d world stays
//   K10i's bit for bit. The backward's blocks each keep a (Tp, 14)
//   partial of the table's gradient: a chunk's rows where a lane of the
//   block has a live triple are added in warp order into it, the others
//   written 0 once (a bit a chunk in shared memory says which); the
//   partials add in block order (sum_groups_kernel). Their cap is the
//   shadow backward's own, sized for the card (SHW_PARTIAL_BYTES in
//   kernels/soft_raytrace.py), so at 36,000 rows the grid is no longer one
//   block an SM.
//
// Unchanged: an unmasked kernel with every bit set computes what its masked
// twin does, item by item, for each ray, so all-ones masks give the
// unmasked kernels' bits.

constexpr int kShwRing = 3;       // stages of a chunk's rows, two in flight

// Issues stage k of item x into ring[k % kShwRing] and commits a cp.async
// group: masked, a cp.async of the chunk's rows as staged for source src
// (rows (S, Tp, kShwQ)); unmasked, the chunk's rows staged here by the
// first `chunk` threads (stage_shw_row from the table, the same bits).
template <bool kMasked>
__device__ __forceinline__ void issue_shw_stage(
    const ShwItem& x, int k, float4 (*ring)[kMaxChunk * kShwQ],
    const float4* rows, const float* consts, int Tp, int chunk, int src,
    const float* sp) {
  if (k < x.n) {
    const size_t row0 = static_cast<size_t>(item_chunk<kMasked>(x, k)) * chunk;
    float4* dst = ring[k % kShwRing];
    if (kMasked) {
      copy_async(dst, rows + (static_cast<size_t>(src) * Tp + row0) * kShwQ,
                 chunk * kShwQ);
    } else if (threadIdx.x < chunk) {
      stage_shw_row(consts + (row0 + threadIdx.x) * kShwCols, sp,
                    dst + threadIdx.x * kShwQ);
    }
  }
  cp_async_commit();
}

// K10g (kMasked false) and K10h (true), replace _shw_fwd_kernel and
// _shw_fwd_kernel_masked (see above): block b takes items b, b + gridDim.x,
// ...; a thread a ray of the item's tile. od_part (items, 256) the runs'
// partial od, or null: trans written here.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    soft_rt_shw_fwd_kernel(const float* __restrict__ consts, int Tp,
                           int chunk, const float4* __restrict__ rows,
                           const float* __restrict__ srcs, int S,
                           const float* __restrict__ world, int R, int H,
                           int W, int th, float es, float zs, ShwPlan pl,
                           float* __restrict__ od_part,
                           float* __restrict__ trans) {
  __shared__ float4 s_ring[kShwRing][kMaxChunk * kShwQ];
  const int n_items = item_count<kMasked>(pl);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const ShwItem x = shw_item<kMasked>(pl, it);
    const int src = x.pair % S;
    const TileRay ray = tile_ray<kMasked>(x.pair / S, R, H, W, th);
    const float sp[3] = {srcs[3 * src], srcs[3 * src + 1],
                         srcs[3 * src + 2]};
    float w[3];
    load_point(world, ray.r, R, ray.live, w);
    const ShadowRay a = shadow_ray(w, sp);
    const float4 pt = make_float4(a.dh[0], a.dh[1], a.dh[2], 0.99f * a.rr);
    __syncthreads();  // every thread is done with the last item's stages
    issue_shw_stage<kMasked>(x, 0, s_ring, rows, consts, Tp, chunk, src, sp);
    issue_shw_stage<kMasked>(x, 1, s_ring, rows, consts, Tp, chunk, src, sp);
    float od = 0.0f;
    for (int k = 0; k < x.n; ++k) {
      cp_async_wait_one();
      __syncthreads();  // stage k is in; every thread is done with k - 1
      issue_shw_stage<kMasked>(x, k + 2, s_ring, rows, consts, Tp, chunk,
                               src, sp);  // into stage k - 1's buffer
      const float4* q = s_ring[k % kShwRing];
      float csum = 0.0f;
#pragma unroll 4
      for (int i = 0; i < chunk; ++i) {
        const float4* qi = q + i * kShwQ;
        const float act = qi[3].w;
        const ShwTest t = shw_test(qi[0], qi[1], qi[2], pt, es, zs);
        if (t.ok & !shw_term_dead(t, act)) {
          csum += (sigmoid(t.xs) * act) * sigmoid(t.y);
        }
      }
      od += csum;
    }
    if (od_part != nullptr) {
      od_part[static_cast<size_t>(it) * kThreads + threadIdx.x] = od;
    } else if (ray.live) {
      trans[static_cast<size_t>(src) * R + ray.r] = expf(-kOdScale * od);
    }
  }
}

// K10g's and K10h's merge, a block a (tile, source) pair: od is the pair's
// runs' partials added in run order from 0, trans = exp(-16 od).
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    shw_fwd_merge_kernel(ShwPlan pl, int S, int R, int H, int W, int th,
                         const float* __restrict__ od_part,
                         float* __restrict__ trans) {
  const int p = blockIdx.x;
  const TileRay ray = tile_ray<kMasked>(p / S, R, H, W, th);
  if (!ray.live) return;
  const int2 at = pair_items<kMasked>(pl, p);
  float od = 0.0f;
  for (int j = 0; j < at.y; ++j) {
    od += od_part[static_cast<size_t>(at.x + j) * kThreads + threadIdx.x];
  }
  trans[static_cast<size_t>(p % S) * R + ray.r] = expf(-kOdScale * od);
}

// K10i (kMasked false) and K10j (true), replace _shw_bwd_fused_kernel and
// _shw_bwd_fused_kernel_masked (see above): block b takes items b, b +
// gridDim.x, ...; a thread a ray of the item's tile. partials (blocks, Tp,
// 14) and src_partials (blocks, S, 3) the blocks' sums; dw_part (items, 3,
// 256) the runs' partial d world, or null: d world written here. Dynamic
// shared memory: shw_touched_bytes(n_chunks).
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    soft_rt_shw_bwd_kernel(const float* __restrict__ consts, int Tp,
                           int chunk, const float4* __restrict__ rows,
                           const float* __restrict__ srcs, int S,
                           const float* __restrict__ world, int R, int H,
                           int W, int th, const float* __restrict__ trans,
                           const float* __restrict__ gcot, float es, float zs,
                           ShwPlan pl, float* __restrict__ partials,
                           float* __restrict__ src_partials,
                           float* __restrict__ dw_part,
                           float* __restrict__ dw_out) {
  __shared__ float4 s_ring[kShwRing][kMaxChunk * kShwQ];
  __shared__ float s_red[kWarps][kMaxChunk][kShwUsed];
  __shared__ unsigned s_any[kWarps];
  __shared__ float s_src[kWarps][3];
  extern __shared__ unsigned s_touched[];  // chunks of the partial written
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = pl.n_chunks;
  float* part = partials + static_cast<size_t>(blockIdx.x) * Tp * kShwUsed;
  float* spart = src_partials + static_cast<size_t>(blockIdx.x) * S * 3;
  for (int o = tid; o < (n_chunks + 31) / 32; o += kThreads) {
    s_touched[o] = 0u;
  }
  for (int o = tid; o < S * 3; o += kThreads) spart[o] = 0.0f;
  const int n_items = item_count<kMasked>(pl);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const ShwItem x = shw_item<kMasked>(pl, it);
    const int src = x.pair % S;
    const TileRay ray = tile_ray<kMasked>(x.pair / S, R, H, W, th);
    const float sp[3] = {srcs[3 * src], srcs[3 * src + 1],
                         srcs[3 * src + 2]};
    float w[3];
    load_point(world, ray.r, R, ray.live, w);
    const ShwPoint p = shw_point(w, sp, trans, gcot, src, ray.r, R,
                                 ray.live);
    const ShadowRay& a = p.a;
    const float4 pt = make_float4(a.dh[0], a.dh[1], a.dh[2], 0.99f * a.rr);
    float prun[3] = {0.0f, 0.0f, 0.0f}, dsrc[3] = {0.0f, 0.0f, 0.0f};
    // Also the barrier after every thread's last use of the stages, s_red,
    // s_any and s_src for the item before. An item whose points all have
    // d od 0 adds nothing.
    if (__syncthreads_or(p.active)) {
      issue_shw_stage<kMasked>(x, 0, s_ring, rows, consts, Tp, chunk, src,
                               sp);
      issue_shw_stage<kMasked>(x, 1, s_ring, rows, consts, Tp, chunk, src,
                               sp);
      for (int k = 0; k < x.n; ++k) {
        cp_async_wait_one();
        __syncthreads();  // stage k is in; every thread is done with k - 1
        issue_shw_stage<kMasked>(x, k + 2, s_ring, rows, consts, Tp, chunk,
                                 src, sp);  // into stage k - 1's buffer
        const int c = item_chunk<kMasked>(x, k);
        // Read before the barrier below, after which thread 0 sets it.
        const bool first = ((s_touched[c >> 5] >> (c & 31)) & 1u) == 0u;
        const float4* q = s_ring[k % kShwRing];
        float ddh[3] = {0.0f, 0.0f, 0.0f}, drr = 0.0f;
        unsigned any = 0u;  // rows where a lane of the warp has a triple
        for (int i = 0; i < chunk; ++i) {
          const float4* qi = q + i * kShwQ;
          const ShwTest t = shw_test(qi[0], qi[1], qi[2], pt, es, zs);
          const bool mine = p.active && !shw_dead(t);
          if (__any_sync(kFull, mine)) {
            float g[kShwUsed];
#pragma unroll
            for (int col = 0; col < kShwUsed; ++col) g[col] = 0.0f;
            if (mine) {
              float qs[kShwRow];
              unstage_shw_row(qi, qs);
              shw_pair_grad(t, qs, a.dh, p.dl, sp, es, zs, g, ddh, &drr,
                            dsrc);
            }
            warp_sum_store<kShwUsed>(g, mine, s_red[warp][i]);
            any |= 1u << i;
          }
        }
        if (lane == 0) s_any[warp] = any;
        if (p.active) {
          // K10i's chain through dh, rr, rrec and r2s to d = w - sp, once a
          // chunk, into the run's sum.
          float drrec = drr * a.r2s;
          float dd[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            dd[j] = ddh[j] * a.rrec;
            drrec += ddh[j] * a.d[j];
          }
          const float dsq = -drrec / (a.sq * a.sq);
          const float dr2s = drr * a.rrec + dsq * (0.5f / a.sq);
          const float dr2 = a.lit ? dr2s : 0.0f;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            dd[j] += dr2 * a.d[j] + dr2 * a.d[j];
            prun[j] += dd[j];
            dsrc[j] -= dd[j];
          }
        }
        __syncthreads();  // the warps' row sums are in
        unsigned rows_any = 0u;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) rows_any |= s_any[wp];
        float* dst = part + static_cast<size_t>(c) * chunk * kShwUsed;
        for (int o = tid; o < chunk * kShwUsed; o += kThreads) {
          const int row = o / kShwUsed, col = o % kShwUsed;
          if ((rows_any >> row) & 1u) {
            float sum = 0.0f;
#pragma unroll
            for (int wp = 0; wp < kWarps; ++wp) {
              if ((s_any[wp] >> row) & 1u) sum += s_red[wp][row][col];
            }
            dst[o] = first ? sum : dst[o] + sum;
          } else if (first) {
            dst[o] = 0.0f;
          }
        }
        if (tid == 0) s_touched[c >> 5] |= 1u << (c & 31);
      }
    }
    if (dw_part != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        dw_part[(static_cast<size_t>(it) * 3 + j) * kThreads + tid] = prun[j];
      }
    } else if (ray.live) {
#pragma unroll
      for (int j = 0; j < 3; ++j) dw_out[static_cast<size_t>(j) * R + ray.r] =
          prun[j];
    }
    warp_sum_store<3>(dsrc, p.active, s_src[warp]);
    __syncthreads();
    if (tid < 3) {
      float sum = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp) sum += s_src[wp][tid];
      spart[3 * src + tid] += sum;
    }
  }
  __syncthreads();
  // The rows of chunks no item of this block wrote: 0, for the sums.
  for (int c = warp; c < n_chunks; c += kWarps) {
    if ((s_touched[c >> 5] >> (c & 31)) & 1u) continue;
    float* dst = part + static_cast<size_t>(c) * chunk * kShwUsed;
    for (int o = lane; o < chunk * kShwUsed; o += 32) dst[o] = 0.0f;
  }
}

// K10i's and K10j's merge, a block a tile: each point's d world is, source
// by source in order, the (tile, source)'s runs' partials added in run
// order from 0, added from 0.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    shw_bwd_merge_kernel(ShwPlan pl, int S, int R, int H, int W, int th,
                         const float* __restrict__ dw_part,
                         float* __restrict__ dw) {
  const TileRay ray = tile_ray<kMasked>(blockIdx.x, R, H, W, th);
  if (!ray.live) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int src = 0; src < S; ++src) {
    const int2 at = pair_items<kMasked>(pl, blockIdx.x * S + src);
    float dws[3] = {0.0f, 0.0f, 0.0f};
    for (int j = 0; j < at.y; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dws[c] += dw_part[(static_cast<size_t>(at.x + j) * 3 + c) * kThreads +
                          threadIdx.x];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += dws[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) dw[static_cast<size_t>(c) * R + ray.r] = acc[c];
}

// K10c and K10d, redesigned for Hopper. On the culled 9,216-triangle step
// (512^2, 1,024 tiles, 23.43% of the (tile, chunk) pairs kept) 88% of the
// kept (ray, row) pairs are proved of weight exactly 0 by pri_pair_dead and
// 6.6% are gated, a few tiles keep most of the chunks (111 of 288 at most),
// and the first design (a block a tile, pri_pair_bwd worked out in full on
// every pair, 18 x 5 shuffles and a barrier pair for every row of a chunk a
// lane of a warp had a pair in, a (groups, Tp, 18) partial of 268 MB
// written in full) ran 18.5x its bound there. Three changes:
//
// - An exact dead-pair skip. Every (ray, row) pair is screened with K10e's
//   and K10f's test (pri_pair_dead: pri_test, then pri_dead), and only the
//   pairs it does not prove dead go on to the derivative, pri_pair_bwd's
//   second half (pri_pair_rest) from the test's own floats, the same
//   expressions in the same order. A pair proved dead adds nothing today
//   (pri_pair_bwd returns before its first add), so no term and no order
//   of adding one moves.
// - Live rows only, cheaper sums. A warp walks a chunk's rows in order and
//   goes on past the test only where a lane has a live pair (a vote); a
//   (warp, row) with no live lane costs the test alone. A live one adds its
//   18 sums over the 32 lanes by a fixed-order reduce-scatter
//   (reduce_scatter18: five shuffle levels, 20 shuffles in all, column k's
//   total in lane scatter18_col's lane). The warps' sums
//   of a chunk are added in warp order by the warp that owns the row (rows
//   w, w + 8, ...) into the block's (Tp, 18) partial, one chunk behind the
//   warps (s_red is double-buffered), so a chunk costs one barrier. A
//   block's partial is written only where a lane of one of its items had a
//   live pair: a bit a (chunk, row) (`touched`, set by integer atomics)
//   says which rows hold a sum, nothing is zeroed, and sum_touched_kernel
//   adds in block order only the rows the bits mark. In a masked tile of
//   16 x 16 rays a warp takes a 4 x 8 block (bwd_slot): 8% fewer (warp,
//   row) units have a live lane than with 2 x 16 strips. Three blocks an SM
//   (80 registers, a few spilled) ran faster on the culled step than the
//   two that its 107-114 registers allow.
// - Work items of at most `run` kept chunks, as K10g-K10j's: a tile's kept
//   chunks (every chunk, unmasked) are cut in order into runs of `run`, a
//   work item each, from the plan that shw_plan_kernel and shw_items_kernel
//   make on the card (a tile is K10j's (tile, source) pair with one
//   source). Block b takes items b, b + blocks, ... (a fixed rule), so the
//   few tiles that hold most of the work spread over the card. The rows are
//   staged once a launch (pack_pri_rows_kernel, K10f's) and stream through
//   a cp.async ring of kShwRing chunks, two ahead. An item adds a ray's
//   d dirs over its chunks from 0, the |d| chain once a chunk as before;
//   a tile with one item writes them itself, pri_bwd_merge_kernel folds the
//   items of the others in run order. K10f folds its chunks in the same
//   runs, so its d dirs stay K10c's bit for bit. The camera's gradient is a
//   sum a block, added in block order.
//
// Every sum has a fixed order, so two calls give the same bits, and K10c is
// K10d with every tile kept: the same items, sums and grid (the fewer
// blocks an SM of the two instances), bit for bit.

// One level of reduce_scatter18: N values in g[0, N); lanes with bit `kHalf`
// clear keep g[0, C), the others g[C, N) moved to g[0, N - C), C = ceil(N /
// 2), each adding its partner's copy (a value past N counts 0).
template <int N, int kHalf>
__device__ __forceinline__ void scatter18_level(float* g, bool hi) {
  constexpr int C = (N + 1) / 2;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float up = C + i < N ? g[C + i] : 0.0f;
    const float send = hi ? g[i] : up;
    const float keep = hi ? up : g[i];
    g[i] = keep + __shfl_xor_sync(kFull, send, kHalf);
  }
}

// The warp's 18 sums g[0..17] added over its 32 lanes in a fixed order;
// returns this lane's total, that of column scatter18_col(lane).
__device__ __forceinline__ float reduce_scatter18(float* g) {
  const int lane = threadIdx.x & 31;
  scatter18_level<18, 16>(g, (lane & 16) != 0);
  scatter18_level<9, 8>(g, (lane & 8) != 0);
  scatter18_level<5, 4>(g, (lane & 4) != 0);
  scatter18_level<3, 2>(g, (lane & 2) != 0);
  scatter18_level<2, 1>(g, (lane & 1) != 0);
  return g[0];
}

// The column whose total reduce_scatter18 leaves in `lane`, or -1 (14
// lanes hold none): the levels' splits replayed on the real count.
__device__ __forceinline__ int scatter18_col(int lane) {
  int col = 0, real = kPriUsed, n = kPriUsed;
  for (int half = 16; half >= 1; half >>= 1) {
    const int c = (n + 1) / 2;
    if (lane & half) {
      col += c;
      real = real > c ? real - c : 0;
    } else {
      real = real < c ? real : c;
    }
    n = c;
  }
  return real == 1 ? col : -1;
}

// The slot of the tile this thread takes in the backward: in a masked tile
// of th x tw rays with th % 4 == 0 and tw % 8 == 0, warp w a 4 x 8 block
// (blocks row-major), lane l its pixel (l / 8, l % 8); else the thread's
// index (unmasked, runs of 256 consecutive rays).
template <bool kMasked>
__device__ __forceinline__ int bwd_slot(int th) {
  const int tw = kThreads / th;
  if (!kMasked || th % 4 != 0 || tw % 8 != 0) return threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int by = (warp / (tw / 8)) * 4 + lane / 8;
  const int bx = (warp % (tw / 8)) * 8 + lane % 8;
  return by * tw + bx;
}

// tile_ray for slot `slot` of the tile.
template <bool kMasked>
__device__ __forceinline__ TileRay slot_ray(int tile, int slot, int R, int H,
                                            int W, int th) {
  if (!kMasked) {
    const int r = tile * kThreads + slot;
    return {r, r < R};
  }
  const int tw = kThreads / th;
  const int tiles_x = (W + tw - 1) / tw;
  const int y = (tile / tiles_x) * th + slot / tw;
  const int x = (tile % tiles_x) * tw + slot % tw;
  const bool live = y < H && x < W;
  return {live ? y * W + x : 0, live};
}

// Issues stage k of item x into ring[k % kShwRing] and commits a cp.async
// group: a cp.async of the chunk's rows as pack_pri_rows_kernel staged
// them, or, where rows is null (K10a on a table of one chunk), the chunk's
// rows staged here by the first `chunk` threads from consts (stage_pri_row,
// the same bits).
template <bool kMasked>
__device__ __forceinline__ void issue_pri_stage(
    const ShwItem& x, int k, float4 (*ring)[kMaxChunk * kRowQ],
    const float4* rows, int chunk, const float* consts = nullptr,
    float zs = 0.0f) {
  if (k < x.n) {
    const size_t row0 = static_cast<size_t>(item_chunk<kMasked>(x, k)) * chunk;
    float4* dst = ring[k % kShwRing];
    if (rows != nullptr) {
      copy_async(dst, rows + row0 * kRowQ, chunk * kRowQ);
    } else if (threadIdx.x < chunk) {
      stage_pri_row(consts + (row0 + threadIdx.x) * kPriCols, zs,
                    dst + threadIdx.x * kRowQ);
    }
  }
  cp_async_commit();
}

// Adds the warps' sums of chunk c (buffer b) into the block's partial part:
// warp w the rows w, w + 8, ... that a lane of the block had a live pair
// in, its lanes the columns, the warps' sums in warp order; the row's first
// sum is written, later ones added (tmask, the block's bits of chunk c).
__device__ __forceinline__ void pri_block_sum(int c, int chunk,
                                              float (*red)[kMaxChunk][kPriUsed],
                                              const unsigned* any, float* part,
                                              unsigned* tmask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned all = 0u;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) all |= any[wp];
  unsigned rows = all & (0x01010101u << warp);
  if (rows == 0u) return;  // the same for the warp
  unsigned before = 0u;
  if (lane == 0) before = atomicOr(tmask + c, rows);
  before = __shfl_sync(kFull, before, 0);
  while (rows != 0u) {
    const int row = __ffs(rows) - 1;
    rows &= rows - 1u;
    if (lane < kPriUsed) {
      float sum = 0.0f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) {
        if ((any[wp] >> row) & 1u) sum += red[wp][row][lane];
      }
      float* dst = part + (static_cast<size_t>(c) * chunk + row) * kPriUsed +
                   lane;
      *dst = ((before >> row) & 1u) ? *dst + sum : sum;
    }
  }
}

// K10c (kMasked false) and K10d (true), replace _pri_bwd_fused_kernel and
// _pri_bwd_fused_kernel_masked (see above): block b takes items b, b +
// gridDim.x, ...; a thread a ray of the item's tile (bwd_slot). rows the
// staged table (pack_pri_rows_kernel); partials (blocks, Tp, 18) and
// touched (blocks, n_chunks) the blocks' sums and their bits; cam_partials
// (blocks, 3); dd_part (items, 3, 256) the runs' partial d dirs of tiles
// with more than one item, or null where every tile has one (`direct`:
// unmasked with one run a tile); dd_out (3, R).
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 3)
    soft_rt_pri_bwd_kernel(const float4* __restrict__ rows, int Tp,
                           int chunk, const float* __restrict__ cam,
                           const float* __restrict__ dirs, int R, int H,
                           int W, int th, float es, float zs,
                           const float* __restrict__ m,
                           const float* __restrict__ cot, ShwPlan pl,
                           float* __restrict__ partials,
                           unsigned* __restrict__ touched,
                           float* __restrict__ cam_partials,
                           float* __restrict__ dd_part,
                           float* __restrict__ dd_out) {
  __shared__ float4 s_ring[kShwRing][kMaxChunk * kRowQ];
  __shared__ float s_red[2][kWarps][kMaxChunk][kPriUsed];
  __shared__ unsigned s_any[2][kWarps];
  __shared__ float s_cam[kWarps][3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = scatter18_col(lane);
  const int slot = bwd_slot<kMasked>(th);
  const int n_chunks = pl.n_chunks;
  float* part = partials + static_cast<size_t>(blockIdx.x) * Tp * kPriUsed;
  unsigned* tmask = touched + static_cast<size_t>(blockIdx.x) * n_chunks;
  for (int o = tid; o < n_chunks; o += kThreads) tmask[o] = 0u;
  const float gp[3] = {cam[0], cam[1], cam[2]};
  float gcam[3] = {0.0f, 0.0f, 0.0f};
  const int n_items = item_count<kMasked>(pl);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const ShwItem x = shw_item<kMasked>(pl, it);
    const TileRay ray = slot_ray<kMasked>(x.pair, slot, R, H, W, th);
    float d[3] = {0.0f, 0.0f, 0.0f}, da[9];
    float mp = 0.0f, ds = 0.0f;
#pragma unroll
    for (int j = 0; j < 9; ++j) da[j] = 0.0f;
    if (ray.live) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        d[j] = dirs[static_cast<size_t>(j) * R + ray.r];
      }
      mp = m[ray.r];
      ds = cot[ray.r];
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        da[j] = cot[static_cast<size_t>(1 + j) * R + ray.r];
      }
    }
    const float dn = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
    const float4 r0 = make_float4(d[0], d[1], d[2], 1e-3f * dn);
    float prun[3] = {0.0f, 0.0f, 0.0f};
    // The previous item's last sums were added before its closing barrier,
    // and every thread is done with its stages: the ring is free.
    issue_pri_stage<kMasked>(x, 0, s_ring, rows, chunk);
    issue_pri_stage<kMasked>(x, 1, s_ring, rows, chunk);
    for (int k = 0; k < x.n; ++k) {
      cp_async_wait_one();
      // Stage k is in; every thread is done with stage k - 1 and the warps'
      // sums of chunk k - 1 are in s_red[(k - 1) & 1].
      __syncthreads();
      issue_pri_stage<kMasked>(x, k + 2, s_ring, rows, chunk);
      if (k > 0) {
        const int b = (k - 1) & 1;
        pri_block_sum(item_chunk<kMasked>(x, k - 1), chunk, s_red[b],
                      s_any[b], part, tmask);
      }
      const int b = k & 1;
      const float4* q = s_ring[k % kShwRing];
      unsigned any = 0u;  // the warp's rows with a live lane
      float ddc[3] = {0.0f, 0.0f, 0.0f}, ddn = 0.0f;
#pragma unroll 4
      for (int i = 0; i < chunk; ++i) {
        const float4* qi = q + i * kRowQ;
        const float4 q1 = qi[1], q2 = qi[2];
        const PriTest pt = pri_row_test(r0, qi[0], q1, q2, es);
        const bool live =
            ray.live & !pri_dead(pt, r0, q1.w, qi[3].x, q2.w, mp);
        if (__any_sync(kFull, live)) {
          any |= 1u << i;
          float g[kPriUsed];
#pragma unroll
          for (int k2 = 0; k2 < kPriUsed; ++k2) g[k2] = 0.0f;
          if (live) {
            float cr[kPriRow];
            unstage_pri_row(qi, cr);
            pri_pair_rest(pt, cr, d, dn, gp, mp, ds, da, es, zs, g, gcam, ddc,
                          &ddn);
          }
          const float total = reduce_scatter18(g);
          if (col >= 0) s_red[b][warp][i][col] = total;
        }
      }
      if (lane == 0) s_any[b][warp] = any;
      if (ray.live) {
        // |d| = sqrt((dx dx + dy dy) + dz dz), once a chunk.
        const float dq = ddn * (0.5f / dn);
#pragma unroll
        for (int j = 0; j < 3; ++j) prun[j] += ddc[j] + (dq * d[j] + dq * d[j]);
      }
    }
    __syncthreads();  // the warps' sums of the last chunk are in
    const int b = (x.n - 1) & 1;
    pri_block_sum(item_chunk<kMasked>(x, x.n - 1), chunk, s_red[b], s_any[b],
                  part, tmask);
    if (ray.live) {
      const bool one = dd_part == nullptr ||
                       (kMasked && pair_items<kMasked>(pl, x.pair).y == 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (one) {
          dd_out[static_cast<size_t>(j) * R + ray.r] = prun[j];
        } else {
          dd_part[(static_cast<size_t>(it) * 3 + j) * kThreads + tid] =
              prun[j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float v = gcam[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) s_cam[warp][j] = v;
  }
  __syncthreads();
  if (tid < 3) {
    float sum = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) sum += s_cam[wp][tid];
    cam_partials[static_cast<size_t>(blockIdx.x) * 3 + tid] = sum;
  }
}

// K10c's and K10d's merge of d dirs, a block a tile: a tile with one item
// was written by the kernel; the others' rays get their items' partials
// added in run order from 0 (0 where the tile keeps no chunk).
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    pri_bwd_merge_kernel(ShwPlan pl, int R, int H, int W, int th,
                         const float* __restrict__ dd_part,
                         float* __restrict__ dd) {
  const TileRay ray = slot_ray<kMasked>(blockIdx.x, bwd_slot<kMasked>(th), R,
                                        H, W, th);
  const int2 at = pair_items<kMasked>(pl, blockIdx.x);
  if (!ray.live || at.y == 1) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < at.y; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] += dd_part[(static_cast<size_t>(at.x + j) * 3 + c) * kThreads +
                        threadIdx.x];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) dd[static_cast<size_t>(c) * R + ray.r] = acc[c];
}

// K10a and K10b, redesigned for Hopper. On the brute 9,216-triangle frame
// (512^2) the first design, a block a 256-ray tile walking every chunk,
// restaging each chunk's rows between two barriers in every block and
// working out every pair's whole logit, ran 14.8x its bound, and on the
// culled frames (K10b) a few tiles keep most of the chunks while the other
// blocks finish at once: 13.5x on the culled step, 50x on the culled
// render --stl frame. Four changes:
//
// - An exact dead-pair skip against the running max. The forward does not
//   know the final max, but its carry m is enough: m starts at 0 (the
//   background, or an item's start) and only grows (m' = fmaxf(m, cmax)).
//   pri_dead's bound B is >= the pair's float32 logit (see K10e and K10f's
//   note), so where B - m < kDeadBelow, logit - m' <= B - m < -110 and
//   expf(logit - m') is exactly 0: the pair adds nothing to s or acc, and
//   as its logit lies below m, leaving it out of cmax leaves m' as it was.
//   A gated pair adds nothing either, and its -1e30 never passes m >= 0.
//   So the skip moves no bit. A NaN in B falls through, as there. A pair
//   that is not proved dead goes on from the test's own floats (pri_test:
//   the first design's expressions in the same order, the same safe, rec,
//   u, v and margin) to zinv, log1pf and its logit (fwd_logit): one
//   reciprocal for a dead pair, no second one for a live pair.
// - Live rows only. For each chunk a thread tests its rows and keeps a bit
//   mask of those not proved dead, their logits and t, then takes the
//   weight and the sums on those only, in row order; the loops are unrolled
//   and predicated on the bit. A row no lane of a warp keeps costs the warp
//   its test alone. The logits and t go to the thread's own column of
//   shared memory (kFwdKeepBytes, no bank conflict, no barrier), which
//   leaves 60 registers and three blocks an SM; kept in registers they took
//   117-120 registers, two blocks an SM, and ran slower on every main-path
//   frame (chip_smoke.py phases 22 and 28).
// - Rows staged once a launch. The rows are read as pack_pri_rows_kernel
//   stages them for K10c-K10f (six float4s a row; |n|, la and zb by the
//   first design's expressions, the same bits) through a cp.async ring of
//   kShwRing chunks, two ahead, one barrier a chunk; a table of one chunk
//   (the Cornell box, 500 launches a fit) is staged into the ring by the
//   kernel with the same expressions and saves the staging launch.
// - Work items across the card. Each tile's kept chunks (unmasked: every
//   chunk) are cut into runs of pri_fwd_run chunks, a work item each, from
//   K10j's plan (shw_plan_kernel, shw_items_kernel with one source a tile;
//   K10b's run is worked out before it by pri_fwd_run_kernel from the
//   mask's kept count, on the card, with no host sync). The run is the mean kept chunks a tile over a split
//   that gives about `items` items (kernels/soft_raytrace.py PRI_FWD_ITEMS),
//   so the tiles that keep more than the mean are cut and the few that hold
//   the work spread over the card; it depends on the shapes and the kept
//   count only, so an all-ones mask and no mask split alike. Block b takes
//   item b (grid: the most items; the blocks past the plan's count return),
//   so the hardware hands the next item to the first free slot. An item
//   keeps an online-softmax carry over its run from (m, s, acc) = (0, 0, 0)
//   and writes it as a partial of 11 floats a ray; m >= 0 still, so the
//   skip stays exact. A tile of one item starts from the background (0, 1,
//   0) and writes out, m and s itself: the first design's order, bit for
//   bit. pri_fwd_merge_kernel folds the other tiles' items in run order
//   into the background (and writes the background where a tile keeps
//   nothing): m, a max of the same logits and 0, keeps its bits; s and out
//   move by the rounding of the fold. The partials take at most n_tiles
//   (splits + 1) items, whatever the table's size.
//
// Two calls give the same bits (no atomics, every sum in a fixed order),
// and an all-ones mask gives K10a's: the same items on each ray, the same
// sums. The plain models are kernels/soft_raytrace.py::primary_fwd_walk
// (the test at the running carry) and primary_agg_items (the items and the
// merge).

constexpr int kFwdPart = 11;  // floats a ray of an item's partial: m, s, acc
// The forward's dynamic shared memory: a live row's t and logit in the
// thread's own column, (2, kMaxChunk, kThreads) floats.
constexpr int kFwdKeepBytes = 2 * kMaxChunk * kThreads * sizeof(float);

// The rest of a pair's logit from its test's t and xs, the gate passed,
// by the first design's expressions in its order: zinv = 1 / max(max(t
// |d|, dmin), 0.1), then zs zinv + log_sigmoid(xs) + la.
__device__ __forceinline__ float fwd_logit(float t, float xs, float dn,
                                           float dmin, float la, float zs) {
  const float zinv = 1.0f / fmaxf(fmaxf(t * dn, dmin), kTNear);
  return (zs * zinv + (fminf(xs, 0.0f) - log1pf(expf(-fabsf(xs))))) + la;
}

// K10a (kMasked false) and K10b (true), replace _pri_fwd_kernel and
// _pri_fwd_kernel_masked (see above): block b takes item b of the plan pl
// (masked: its run at run_dev); a thread a ray of the item's tile. rows the
// staged table, or null: staged here from consts. part (items, 11, 256)
// the items' (m, s, acc) of tiles of more than one item. Dynamic shared
// memory: kFwdKeepBytes.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 3)
    soft_rt_pri_fwd_kernel(const float* __restrict__ consts,
                           const float4* __restrict__ rows, int chunk,
                           const float* __restrict__ cam,
                           const float* __restrict__ dirs, int R, int H,
                           int W, int th, float es, float zs, ShwPlan pl,
                           const int* __restrict__ run_dev,
                           float* __restrict__ part,
                           float* __restrict__ out,
                           float* __restrict__ m_out,
                           float* __restrict__ s_out) {
  __shared__ float4 s_ring[kShwRing][kMaxChunk * kRowQ];
  extern __shared__ float s_keep[];  // kFwdKeepBytes: t, then logits
  float* tt = s_keep + threadIdx.x;  // row i at tt[i * kThreads]
  float* lg = s_keep + kMaxChunk * kThreads + threadIdx.x;
  const int it = blockIdx.x;
  if (it >= item_count<kMasked>(pl)) return;  // the same for the block
  if (kMasked) pl.run = *run_dev;
  const ShwItem x = shw_item<kMasked>(pl, it);
  const TileRay ray = tile_ray<kMasked>(x.pair, R, H, W, th);
  const bool one = pair_items<kMasked>(pl, x.pair).y == 1;
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (ray.live) {
#pragma unroll
    for (int j = 0; j < 3; ++j) d[j] = dirs[static_cast<size_t>(j) * R + ray.r];
  }
  const float gp[3] = {cam[0], cam[1], cam[2]};
  const float dn = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  const float4 r0 = make_float4(d[0], d[1], d[2], 1e-3f * dn);
  // The background hypothesis (logit 0, zero values) where the tile has
  // one item; else the item's own carry, folded into it by the merge.
  float m = 0.0f, s = one ? 1.0f : 0.0f;
  float acc[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) acc[j] = 0.0f;
  issue_pri_stage<kMasked>(x, 0, s_ring, rows, chunk, consts, zs);
  issue_pri_stage<kMasked>(x, 1, s_ring, rows, chunk, consts, zs);
  for (int k = 0; k < x.n; ++k) {
    cp_async_wait_one();
    __syncthreads();  // stage k is in; every thread is done with k - 1
    issue_pri_stage<kMasked>(x, k + 2, s_ring, rows, chunk, consts, zs);
    const float4* q = s_ring[k % kShwRing];
    unsigned bits = 0u;  // the rows not proved dead
    float cmax = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
      if (i < chunk) {
        const float4* qi = q + i * kRowQ;
        const float4 q1 = qi[1], q2 = qi[2];
        const PriTest pt = pri_row_test(r0, qi[0], q1, q2, es);
        if (ray.live & !pri_dead(pt, r0, q1.w, qi[3].x, q2.w, m)) {
          const float l = fwd_logit(pt.t, pt.xs, dn, qi[5].x, q2.w, zs);
          tt[i * kThreads] = pt.t;
          lg[i * kThreads] = l;
          cmax = fmaxf(cmax, l);
          bits |= 1u << i;
        }
      }
    }
    const float m_new = fmaxf(m, cmax);
    const float scale = expf(m - m_new);
    float wsum = 0.0f;
    float vsum[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) vsum[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
      if ((bits >> i) & 1u) {
        const float w = expf(lg[i * kThreads] - m_new);
        if (w != 0.0f) {  // a zero weight adds exactly nothing
          const float4 q3 = q[i * kRowQ + 3], q4 = q[i * kRowQ + 4];
          const float alb[3] = {q4.x, q4.y, q4.z};
          const float nrm[3] = {q3.y, q3.z, q3.w};
          const float t = tt[i * kThreads];
          const float tp = t < kBig ? t : 0.0f;
          wsum += w;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            vsum[j] += w * alb[j];
            vsum[3 + j] += w * (gp[j] + tp * d[j]);
            vsum[6 + j] += w * nrm[j];
          }
        }
      }
    }
    m = m_new;
    s = s * scale + wsum;
#pragma unroll
    for (int j = 0; j < 9; ++j) acc[j] = acc[j] * scale + vsum[j];
  }
  if (!ray.live) return;
  if (one) {
    const float rec = 1.0f / s;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      out[static_cast<size_t>(j) * R + ray.r] = acc[j] * rec;
    }
    m_out[ray.r] = m;
    s_out[ray.r] = s;
    return;
  }
  float* p = part + static_cast<size_t>(it) * kFwdPart * kThreads +
             threadIdx.x;
  p[0] = m;
  p[kThreads] = s;
#pragma unroll
  for (int j = 0; j < 9; ++j) p[(2 + j) * kThreads] = acc[j];
}

// K10a's and K10b's merge, a block a tile: a tile of one item was written
// by the kernel; the others' rays fold their items' (m, s, acc) in run
// order into the background (0, 1, 0): m' = max(m, m_j), s = s e^(m - m')
// + s_j e^(m_j - m'), acc likewise; out = acc / s. A tile that keeps no
// chunk gets the background.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    pri_fwd_merge_kernel(ShwPlan pl, int R, int H, int W, int th,
                         const float* __restrict__ part,
                         float* __restrict__ out, float* __restrict__ m_out,
                         float* __restrict__ s_out) {
  const TileRay ray = tile_ray<kMasked>(blockIdx.x, R, H, W, th);
  const int2 at = pair_items<kMasked>(pl, blockIdx.x);
  if (!ray.live || at.y == 1) return;
  float m, s, acc[9];
  fold_items<9>(part + static_cast<size_t>(at.x) * kFwdPart * kThreads +
                    threadIdx.x,
                at.y, static_cast<size_t>(kFwdPart) * kThreads, kThreads, &m,
                &s, acc);
  const float rec = 1.0f / s;
#pragma unroll
  for (int j = 0; j < 9; ++j) out[static_cast<size_t>(j) * R + ray.r] =
      acc[j] * rec;
  m_out[ray.r] = m;
  s_out[ray.r] = s;
}

// dc (Tp, 32): entry (row, k < 18) the sum over blocks b, in order, of
// partials[b, row, k] where b's bit of (row's chunk, row) is set (+0 where
// none is), k >= 18 zero. Thread (x, y) adds blocks y, y + kSumSlices, ...
// of one entry; thread (x, 0) then adds the kSumSlices sums in order.
__global__ void __launch_bounds__(32 * kSumSlices)
    sum_touched_kernel(const float* __restrict__ partials,
                       const unsigned* __restrict__ touched, int blocks,
                       int Tp, int chunk, float* __restrict__ dc) {
  __shared__ float s_sum[kSumSlices][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  const int n = Tp * kPriCols;
  const int row = o / kPriCols, k = o % kPriCols;
  const int n_chunks = Tp / chunk, c = row / chunk, bit = row % chunk;
  float acc = 0.0f;
  if (o < n && k < kPriUsed) {
    for (int b = threadIdx.y; b < blocks; b += kSumSlices) {
      if ((touched[static_cast<size_t>(b) * n_chunks + c] >> bit) & 1u) {
        acc += partials[(static_cast<size_t>(b) * Tp + row) * kPriUsed + k];
      }
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || o >= n) return;
  float total = 0.0f;
  for (int sl = 0; sl < kSumSlices; ++sl) total += s_sum[sl][threadIdx.x];
  dc[o] = total;
}

// out[row, k] = sum over groups g, in order, of partials[g, row, k] for
// k < in_cols, and 0 for in_cols <= k < out_cols. Thread (x, y) adds
// groups y, y + kSumSlices, ... of one output entry; thread (x, 0) then
// adds the kSumSlices sums in order.
__global__ void __launch_bounds__(32 * kSumSlices)
    sum_groups_kernel(const float* __restrict__ partials, int groups,
                      int rows, int in_cols, int out_cols,
                      float* __restrict__ out) {
  __shared__ float s_sum[kSumSlices][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  const int n = rows * out_cols;
  const int row = o / out_cols, k = o % out_cols;
  const size_t stride = static_cast<size_t>(rows) * in_cols;
  float acc = 0.0f;
  if (o < n && k < in_cols) {
    const float* p = partials + static_cast<size_t>(row) * in_cols + k;
    for (int g = threadIdx.y; g < groups; g += kSumSlices) {
      acc += p[g * stride];
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || o >= n) return;
  float total = 0.0f;
  for (int sl = 0; sl < kSumSlices; ++sl) total += s_sum[sl][threadIdx.x];
  out[o] = total;
}

cudaError_t sum_groups(const float* partials, int groups, int rows,
                       int in_cols, int out_cols, float* out,
                       cudaStream_t st) {
  const int n = rows * out_cols;
  sum_groups_kernel<<<(n + 31) / 32, dim3(32, kSumSlices), 0, st>>>(
      partials, groups, rows, in_cols, out_cols, out);
  return cudaGetLastError();
}

bool bad_shape(int Tp, int chunk, int R) {
  return chunk < 1 || chunk > kMaxChunk || Tp < chunk || Tp % chunk != 0 ||
         R < 1;
}

// The blocks of 256 rays: tiles of the H x W grid where there is a mask
// (0 for a grid that is not R rays or a th that does not divide 256), runs
// of 256 consecutive rays where there is none.
int ray_blocks(bool masked, int R, int H, int W, int th) {
  if (!masked) return (R + kThreads - 1) / kThreads;
  if (H < 1 || W < 1 || static_cast<long long>(H) * W != R || th < 1 ||
      th > kThreads || kThreads % th != 0) {
    return 0;
  }
  const int tw = kThreads / th;
  return ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

// A K10g-K10j call: its shapes (the first eleven fields, from the caller),
// what follows from them (shw_shapes) and where its scratch lies
// (shw_layout), carved from one buffer in this order, each part aligned to
// 16 bytes: masked, the plan's kept lists (n_pairs n_chunks), nk
// (n_pairs), off (n_pairs + 1) and items (max_items), int32, and the rows
// staged for each source (S Tp kShwQ float4s); the runs' partial od
// (forward: max_items 256 floats) or d world (backward: max_items 3 256),
// unless the kernel writes its output itself (direct: unmasked, one run a
// pair and, backward, one source); backward, the blocks' table partials
// (blocks, Tp, 14) and source partials (blocks, S, 3).
struct ShwCall {
  int Tp, chunk, S, R, H, W, th, run, blocks;
  bool masked, backward;
  bool direct;
  int n_tiles, n_chunks, n_pairs, runs;
  long long max_items;  // the most work items: n_pairs runs
  int* kept;
  int* nk;
  int* off;
  int* items;
  float4* rows;
  float* run_part;
  float* partials;
  float* src_partials;
  size_t bytes;
};

// The most chunks the backward's block keeps a bit for (its dynamic shared
// memory, s_touched).
constexpr int kMaxTouchedChunks = 1 << 17;

size_t shw_touched_bytes(int n_chunks) {
  return static_cast<size_t>((n_chunks + 31) / 32) * sizeof(unsigned);
}

bool shw_shapes(ShwCall& sc) {
  if (bad_shape(sc.Tp, sc.chunk, sc.R) || sc.S < 1 || sc.run < 1) {
    return false;
  }
  sc.n_tiles = ray_blocks(sc.masked, sc.R, sc.H, sc.W, sc.th);
  sc.n_chunks = sc.Tp / sc.chunk;
  sc.runs = (sc.n_chunks + sc.run - 1) / sc.run;
  const long long pairs = static_cast<long long>(sc.n_tiles) * sc.S;
  sc.max_items = pairs * sc.runs;
  if (sc.n_tiles < 1 || sc.max_items > 0x7fffffffLL ||
      (sc.masked && sc.S > 65535)) {
    return false;
  }
  sc.n_pairs = static_cast<int>(pairs);
  sc.direct = !sc.masked && sc.runs == 1 && (!sc.backward || sc.S == 1);
  if (sc.backward && (sc.blocks < 1 || sc.blocks > sc.max_items ||
                      sc.n_chunks > kMaxTouchedChunks)) {
    return false;
  }
  return true;
}

static size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Carves the scratch at base (null: sizes it only); false where base
// holds fewer than the bytes the call needs.
bool shw_layout(ShwCall& sc, void* base, long long avail) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t at = 0;
  auto take = [&](size_t n) {
    const uintptr_t q = n == 0 ? 0 : p + at;
    at += align16(n);
    return q;
  };
  const size_t items = static_cast<size_t>(sc.max_items);
  const size_t m = sc.masked ? 1 : 0, b = sc.backward ? 1 : 0;
  sc.kept = reinterpret_cast<int*>(
      take(m * sc.n_pairs * static_cast<size_t>(sc.n_chunks) * sizeof(int)));
  sc.nk = reinterpret_cast<int*>(take(m * sc.n_pairs * sizeof(int)));
  sc.off = reinterpret_cast<int*>(take(m * (sc.n_pairs + 1) * sizeof(int)));
  sc.items = reinterpret_cast<int*>(take(m * items * sizeof(int)));
  sc.rows = reinterpret_cast<float4*>(
      take(m * sc.S * static_cast<size_t>(sc.Tp) * kShwQ * sizeof(float4)));
  sc.run_part = reinterpret_cast<float*>(take(
      (sc.direct ? 0 : 1) * items * (sc.backward ? 3 : 1) * kThreads *
      sizeof(float)));
  sc.partials = reinterpret_cast<float*>(take(
      b * sc.blocks * static_cast<size_t>(sc.Tp) * kShwUsed * sizeof(float)));
  sc.src_partials = reinterpret_cast<float*>(
      take(b * sc.blocks * static_cast<size_t>(sc.S) * 3 * sizeof(float)));
  sc.bytes = at;
  return at == 0 || (base != nullptr && avail >= static_cast<long long>(at));
}

// Where the kernels find their items (ShwPlan) for a laid-out call.
ShwPlan shw_plan(const ShwCall& sc) {
  return ShwPlan{sc.kept, sc.nk, sc.off, sc.items, sc.n_pairs, sc.n_chunks,
                 sc.run, sc.runs, static_cast<int>(sc.max_items)};
}

// Masked, the plan (the kept lists, the items) and each source's rows
// staged once (pack_shw_rows_kernel); unmasked, nothing.
cudaError_t shw_prepare(const ShwCall& sc, const float* consts,
                        const float* srcs, const int* mask, cudaStream_t st) {
  if (!sc.masked) return cudaSuccess;
  const long long warps = static_cast<long long>(sc.n_pairs);
  shw_plan_kernel<<<static_cast<int>((warps + kWarps - 1) / kWarps), kThreads,
                    0, st>>>(mask, sc.n_pairs, sc.n_chunks, sc.kept, sc.nk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  shw_items_kernel<<<1, kScanThreads, 0, st>>>(sc.nk, sc.n_pairs, sc.run,
                                               nullptr, sc.off, sc.items);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pack_shw_rows_kernel<<<dim3((sc.Tp + kThreads - 1) / kThreads, sc.S),
                         kThreads, 0, st>>>(consts, sc.Tp, srcs, sc.rows);
  return cudaGetLastError();
}

// A K10c/K10d call: its shapes (the first nine fields, from the caller),
// what follows from them (pri_shapes) and where its scratch lies
// (pri_layout), carved from one buffer in this order, each part aligned to
// 16 bytes: masked, the plan (shw_plan's: kept lists n_tiles n_chunks, nk
// n_tiles, off n_tiles + 1 and items max_items, int32); the staged rows
// (Tp kRowQ float4s); the runs' partial d dirs (max_items 3 256 floats)
// unless every tile has one item (direct: unmasked, one run a tile); the
// blocks' table partials (blocks, Tp, 18), their bits (blocks, n_chunks)
// and camera sums (blocks, 3).
struct PriCall {
  int Tp, chunk, R, H, W, th, run, blocks;
  bool masked;
  bool direct;
  int n_tiles, n_chunks, runs;
  long long max_items;  // the most work items: n_tiles runs
  int* kept;
  int* nk;
  int* off;
  int* items;
  float4* rows;
  float* dd_part;
  float* partials;
  unsigned* touched;
  float* cam_partials;
  size_t bytes;
};

bool pri_shapes(PriCall& pc) {
  if (bad_shape(pc.Tp, pc.chunk, pc.R) || pc.run < 1) return false;
  pc.n_tiles = ray_blocks(pc.masked, pc.R, pc.H, pc.W, pc.th);
  pc.n_chunks = pc.Tp / pc.chunk;
  pc.runs = (pc.n_chunks + pc.run - 1) / pc.run;
  pc.max_items = static_cast<long long>(pc.n_tiles) * pc.runs;
  pc.direct = !pc.masked && pc.runs == 1;
  return pc.n_tiles >= 1 && pc.max_items <= 0x7fffffffLL &&
         pc.blocks >= 1 && pc.blocks <= pc.max_items;
}

// Carves the scratch at base (null: sizes it only); false where base
// holds fewer than the bytes the call needs.
bool pri_layout(PriCall& pc, void* base, long long avail) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t at = 0;
  auto take = [&](size_t n) {
    const uintptr_t q = n == 0 ? 0 : p + at;
    at += align16(n);
    return q;
  };
  const size_t items = static_cast<size_t>(pc.max_items);
  const size_t m = pc.masked ? 1 : 0, blocks = pc.blocks;
  pc.kept = reinterpret_cast<int*>(
      take(m * pc.n_tiles * static_cast<size_t>(pc.n_chunks) * sizeof(int)));
  pc.nk = reinterpret_cast<int*>(take(m * pc.n_tiles * sizeof(int)));
  pc.off = reinterpret_cast<int*>(take(m * (pc.n_tiles + 1) * sizeof(int)));
  pc.items = reinterpret_cast<int*>(take(m * items * sizeof(int)));
  pc.rows = reinterpret_cast<float4*>(
      take(static_cast<size_t>(pc.Tp) * kRowQ * sizeof(float4)));
  pc.dd_part = reinterpret_cast<float*>(
      take((pc.direct ? 0 : 1) * items * 3 * kThreads * sizeof(float)));
  pc.partials = reinterpret_cast<float*>(
      take(blocks * static_cast<size_t>(pc.Tp) * kPriUsed * sizeof(float)));
  pc.touched = reinterpret_cast<unsigned*>(
      take(blocks * static_cast<size_t>(pc.n_chunks) * sizeof(unsigned)));
  pc.cam_partials =
      reinterpret_cast<float*>(take(blocks * 3 * sizeof(float)));
  pc.bytes = at;
  return base != nullptr && avail >= static_cast<long long>(at);
}

// A K10a/K10b call: its shapes (the first eight fields, from the caller),
// its plan (work_items.cuh::FwdPlan) over the tiles of 256 rays (the
// split over the tiles of all R rays, so a mask and none split alike; the
// items' partials kFwdPart floats a ray), and the staged rows (Tp kRowQ
// float4s) unless the kernel stages them (packed: masked, or more than one
// chunk), carved from the scratch at base (0: sized only), and the bytes
// the scratch needs. False where the kernels refuse the shapes.
struct PriFwdCall {
  int Tp, chunk, R, H, W, th, run_min, items;
  FwdPlan plan;
  bool packed;
  float4* rows;
  size_t bytes;
};

bool pri_fwd_plan(PriFwdCall& fc, bool masked, void* base) {
  if (bad_shape(fc.Tp, fc.chunk, fc.R)) return false;
  if (!fwd_plan_shapes(fc.plan, masked,
                       ray_blocks(masked, fc.R, fc.H, fc.W, fc.th),
                       (fc.R + kThreads - 1) / kThreads, fc.Tp / fc.chunk,
                       fc.run_min, fc.items))
    return false;
  fc.packed = masked || fc.plan.n_chunks > 1;
  Carve c{reinterpret_cast<uintptr_t>(base), 0};
  carve_fwd_plan(fc.plan, c, static_cast<size_t>(kFwdPart) * kThreads);
  fc.rows = c.take<float4>((fc.packed ? 1 : 0) * static_cast<size_t>(fc.Tp) *
                           kRowQ);
  fc.bytes = c.at;
  return true;
}

}  // namespace

// consts (Tp, 32) float32 device pointer in chunks of `chunk` <= 32 rows;
// cam (3,), dirs (3, R) float32; mask null (K10a) or the (n_tiles,
// n_chunks) int32 keep-mask over the tiles of th x (256 / th) rays of the
// H x W grid of the R rays (K10b); run_min and items the run rule's
// (pri_fwd_run); scratch (at least what raytpu_soft_rt_pri_fwd_scratch
// gives for these shapes); out (9, R), m and s (R,) float32 outputs.
// Launches the plan (masked), the rows' staging (unless the table is one
// unmasked chunk), the kernel and the merge (masked, or more than one run
// a tile) on `stream`; returns the first cudaError_t.
extern "C" int raytpu_soft_rt_pri_fwd(const void* consts, int Tp, int chunk,
                                      const void* cam, const void* dirs,
                                      int R, const void* mask, int H, int W,
                                      int th, float es, float zs,
                                      int run_min, int items, void* scratch,
                                      long long scratch_bytes, void* out,
                                      void* m, void* s, void* stream) {
  PriFwdCall fc{Tp, chunk, R, H, W, th, run_min, items};
  if (!pri_fwd_plan(fc, mask != nullptr, scratch) ||
      !scratch_fits(fc.bytes, scratch, scratch_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdPlan& fp = fc.plan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(consts);
  cudaError_t err = launch_fwd_plan(fp, static_cast<const int*>(mask), st);
  if (err != cudaSuccess) return (int)err;
  if (fc.packed) {
    pack_pri_rows_kernel<<<(Tp + kThreads - 1) / kThreads, kThreads, 0,
                           st>>>(tab, Tp, zs, fc.rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const ShwPlan pl = fp.view();
  auto kernel = fp.masked ? soft_rt_pri_fwd_kernel<true>
                          : soft_rt_pri_fwd_kernel<false>;
  float* o = static_cast<float*>(out);
  float* mo = static_cast<float*>(m);
  float* so = static_cast<float*>(s);
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           kFwdKeepBytes)) != cudaSuccess) {
    return (int)err;
  }
  kernel<<<static_cast<int>(fp.max_items), kThreads, kFwdKeepBytes, st>>>(
      tab, fc.rows, chunk, static_cast<const float*>(cam),
      static_cast<const float*>(dirs), R, H, W, th, es, zs, pl, fp.run_dev,
      fp.part, o, mo, so);
  if ((err = cudaGetLastError()) != cudaSuccess || fp.direct) return (int)err;
  auto merge = fp.masked ? pri_fwd_merge_kernel<true>
                         : pri_fwd_merge_kernel<false>;
  merge<<<fp.n_tiles, kThreads, 0, st>>>(pl, R, H, W, th, fp.part, o, mo,
                                         so);
  return (int)cudaGetLastError();
}

// The bytes of the scratch of a K10a/K10b call with these shapes (masked:
// 1 with a mask) and run rule, or -1 where the kernels refuse them.
extern "C" long long raytpu_soft_rt_pri_fwd_scratch(int Tp, int chunk, int R,
                                                    int masked, int H, int W,
                                                    int th, int run_min,
                                                    int items) {
  PriFwdCall fc{Tp, chunk, R, H, W, th, run_min, items};
  if (!pri_fwd_plan(fc, masked != 0, nullptr)) return -1;
  return static_cast<long long>(fc.bytes);
}

// consts, cam, dirs and mask (K10c without, K10d with) as for
// raytpu_soft_rt_pri_fwd; m (R,) and cot (10, R) float32; run the most
// chunks a work item takes; blocks the kernel's blocks (1 <= blocks <= the
// most work items), each with its own table partial; scratch (at least what
// raytpu_soft_rt_pri_scratch gives for these shapes and blocks); dc (Tp,
// 32), dcam (3,) and dd (3, R) float32 outputs, every entry written.
// Launches the plan (masked), the rows' staging, the kernel, the merge of
// the runs' d dirs (unless direct) and the sums over blocks on `stream`;
// returns the first cudaError_t.
extern "C" int raytpu_soft_rt_pri_bwd(const void* consts, int Tp, int chunk,
                                      const void* cam, const void* dirs,
                                      int R, const void* mask, int H, int W,
                                      int th, float es, float zs,
                                      const void* m, const void* cot,
                                      int run, int blocks, void* scratch,
                                      long long scratch_bytes, void* dc,
                                      void* dcam, void* dd, void* stream) {
  PriCall pc{Tp, chunk, R, H, W, th, run, blocks, mask != nullptr};
  if (!pri_shapes(pc) || !pri_layout(pc, scratch, scratch_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pc.masked) {
    shw_plan_kernel<<<(pc.n_tiles + kWarps - 1) / kWarps, kThreads, 0, st>>>(
        static_cast<const int*>(mask), pc.n_tiles, pc.n_chunks, pc.kept,
        pc.nk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    shw_items_kernel<<<1, kScanThreads, 0, st>>>(pc.nk, pc.n_tiles, run,
                                                 nullptr, pc.off, pc.items);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  pack_pri_rows_kernel<<<(Tp + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(consts), Tp, zs, pc.rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const ShwPlan pl{pc.kept, pc.nk, pc.off, pc.items, pc.n_tiles, pc.n_chunks,
                   run, pc.runs, static_cast<int>(pc.max_items)};
  auto kernel = pc.masked ? soft_rt_pri_bwd_kernel<true>
                          : soft_rt_pri_bwd_kernel<false>;
  float* ddo = static_cast<float*>(dd);
  kernel<<<blocks, kThreads, 0, st>>>(
      pc.rows, Tp, chunk, static_cast<const float*>(cam),
      static_cast<const float*>(dirs), R, H, W, th, es, zs,
      static_cast<const float*>(m), static_cast<const float*>(cot), pl,
      pc.partials, pc.touched, pc.cam_partials, pc.dd_part, ddo);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (!pc.direct) {
    auto merge = pc.masked ? pri_bwd_merge_kernel<true>
                           : pri_bwd_merge_kernel<false>;
    merge<<<pc.n_tiles, kThreads, 0, st>>>(pl, R, H, W, th, pc.dd_part, ddo);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int n = Tp * kPriCols;
  sum_touched_kernel<<<(n + 31) / 32, dim3(32, kSumSlices), 0, st>>>(
      pc.partials, pc.touched, blocks, Tp, chunk, static_cast<float*>(dc));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_groups(pc.cam_partials, blocks, 1, 3, 3,
                         static_cast<float*>(dcam), st);
}

// The blocks of K10c and K10d the card holds at once: the SMs times the
// fewer blocks an SM of the two instances, so that an all-ones mask and no
// mask take the same grid; -1 where the device cannot be read.
extern "C" int raytpu_soft_rt_pri_bwd_fit() {
  int dev = 0, sms = 0, masked = 0, unmasked = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &masked, soft_rt_pri_bwd_kernel<true>, kThreads, 0) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &unmasked, soft_rt_pri_bwd_kernel<false>, kThreads, 0) !=
          cudaSuccess) {
    return -1;
  }
  return sms * (masked < unmasked ? masked : unmasked);
}

// The bytes of the scratch of a K10c/K10d call with these shapes (masked:
// 1 with a mask) and blocks, or -1 where the kernels refuse them.
extern "C" long long raytpu_soft_rt_pri_scratch(int Tp, int chunk, int R,
                                                int masked, int H, int W,
                                                int th, int run, int blocks) {
  PriCall pc{Tp, chunk, R, H, W, th, run, blocks, masked != 0};
  if (!pri_shapes(pc)) return -1;
  pri_layout(pc, nullptr, 0);
  return static_cast<long long>(pc.bytes);
}

// consts (Tp, 16) float32 in chunks of `chunk` <= 32 rows; srcs (S, 3),
// world (3, R) float32; mask null (K10g) or the (n_tiles, S, n_chunks)
// int32 keep-mask over the tiles of the H x W grid (K10h); run the most
// chunks a work item takes; scratch (scratch_bytes, at least what
// raytpu_soft_rt_shw_scratch gives for backward 0); trans (S, R) float32
// output. Launches the plan, the rows' staging, the kernel and the merge of
// the runs (shw_call) on `stream`; returns the first cudaError_t.
extern "C" int raytpu_soft_rt_shw_fwd(const void* consts, int Tp, int chunk,
                                      const void* srcs, int S,
                                      const void* world, int R,
                                      const void* mask, int H, int W, int th,
                                      float es, float zs, int run,
                                      void* scratch, long long scratch_bytes,
                                      void* trans, void* stream) {
  ShwCall sc{Tp, chunk, S, R, H, W, th, run, 0, mask != nullptr, false};
  if (!shw_shapes(sc) || !shw_layout(sc, scratch, scratch_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(consts);
  const float* sp = static_cast<const float*>(srcs);
  cudaError_t err = shw_prepare(sc, tab, sp, static_cast<const int*>(mask), st);
  if (err != cudaSuccess) return (int)err;
  const ShwPlan pl = shw_plan(sc);
  float* out = static_cast<float*>(trans);
  const float* wp = static_cast<const float*>(world);
  if (sc.masked) {
    // Persistent blocks, as many as fit on the card at once, over the items.
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, soft_rt_shw_fwd_kernel<true>, kThreads, 0)) !=
            cudaSuccess) {
      return (int)err;
    }
    const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    soft_rt_shw_fwd_kernel<true>
        <<<static_cast<int>(fit < sc.max_items ? fit : sc.max_items), kThreads,
           0, st>>>(
            tab, Tp, chunk, sc.rows, sp, S, wp, R, H, W, th, es, zs, pl,
            sc.run_part, out);
  } else {
    soft_rt_shw_fwd_kernel<false>
        <<<static_cast<int>(sc.max_items), kThreads, 0, st>>>(
            tab, Tp, chunk, sc.rows, sp, S, wp, R, H, W, th, es, zs, pl,
            sc.run_part, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || sc.direct) return (int)err;
  auto merge = sc.masked ? shw_fwd_merge_kernel<true>
                         : shw_fwd_merge_kernel<false>;
  merge<<<sc.n_pairs, kThreads, 0, st>>>(pl, S, R, H, W, th, sc.run_part,
                                         out);
  return (int)cudaGetLastError();
}

// consts, srcs, world, mask and run as for raytpu_soft_rt_shw_fwd; trans
// and gcot (S, R) float32; blocks the kernel's blocks (1 <= blocks <= the
// most work items), each with its own table partial; scratch (at least
// what raytpu_soft_rt_shw_scratch gives for backward 1 and these blocks);
// dc (Tp, 16), dsrc (S, 3) and dw (3, R) float32 outputs, every entry
// written. Launches the plan, the rows' staging, the kernel, the merge of
// the runs' d world and the sums over blocks on `stream`; returns the first
// cudaError_t.
extern "C" int raytpu_soft_rt_shw_bwd(const void* consts, int Tp, int chunk,
                                      const void* srcs, int S,
                                      const void* world, int R,
                                      const void* mask, int H, int W, int th,
                                      const void* trans, const void* gcot,
                                      float es, float zs, int run, int blocks,
                                      void* scratch, long long scratch_bytes,
                                      void* dc, void* dsrc, void* dw,
                                      void* stream) {
  ShwCall sc{Tp, chunk, S, R, H, W, th, run, blocks, mask != nullptr, true};
  if (!shw_shapes(sc) || !shw_layout(sc, scratch, scratch_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(consts);
  const float* sp = static_cast<const float*>(srcs);
  cudaError_t err = shw_prepare(sc, tab, sp, static_cast<const int*>(mask), st);
  if (err != cudaSuccess) return (int)err;
  const ShwPlan pl = shw_plan(sc);
  auto kernel = sc.masked ? soft_rt_shw_bwd_kernel<true>
                          : soft_rt_shw_bwd_kernel<false>;
  kernel<<<blocks, kThreads, shw_touched_bytes(sc.n_chunks), st>>>(
      tab, Tp, chunk, sc.rows, sp, S, static_cast<const float*>(world), R, H,
      W, th, static_cast<const float*>(trans),
      static_cast<const float*>(gcot), es, zs, pl, sc.partials,
      sc.src_partials, sc.run_part, static_cast<float*>(dw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!sc.direct) {
    auto merge = sc.masked ? shw_bwd_merge_kernel<true>
                           : shw_bwd_merge_kernel<false>;
    merge<<<sc.n_tiles, kThreads, 0, st>>>(pl, S, R, H, W, th, sc.run_part,
                                           static_cast<float*>(dw));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = sum_groups(sc.partials, blocks, Tp, kShwUsed, kShwCols,
                   static_cast<float*>(dc), st);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_groups(sc.src_partials, blocks, S, 3, 3,
                         static_cast<float*>(dsrc), st);
}

// The blocks of K10i and K10j the card holds at once for a table of
// n_chunks chunks (their dynamic shared memory): the SMs times the fewer
// blocks an SM of the two instances, so that an all-ones mask and no mask
// take the same grid; -1 where the device cannot be read.
extern "C" int raytpu_soft_rt_shw_bwd_fit(int n_chunks) {
  int dev = 0, sms = 0, masked = 0, unmasked = 0;
  const size_t smem = shw_touched_bytes(n_chunks);
  if (n_chunks < 1 || n_chunks > kMaxTouchedChunks ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &masked, soft_rt_shw_bwd_kernel<true>, kThreads, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &unmasked, soft_rt_shw_bwd_kernel<false>, kThreads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return sms * (masked < unmasked ? masked : unmasked);
}

// The bytes of the scratch of a K10g-K10j call with these shapes (masked:
// 1 with a mask; backward: 1 for K10i / K10j with `blocks` blocks, 0 for
// K10g / K10h), or -1 where the kernels refuse them.
extern "C" long long raytpu_soft_rt_shw_scratch(int Tp, int chunk, int S,
                                                int R, int masked, int H,
                                                int W, int th, int run,
                                                int backward, int blocks) {
  ShwCall sc{Tp, chunk, S, R, H, W, th, run, blocks, masked != 0,
             backward != 0};
  if (!shw_shapes(sc)) return -1;
  shw_layout(sc, nullptr, 0);
  return static_cast<long long>(sc.bytes);
}

// K10e: consts (Tp, 32) float32 in chunks of `chunk` <= 32 rows; cam (3,),
// dirs (3, R), m (R,) and cot (10, R) float32; scratch: rays
// (ceil(R / 128) 128, 16), partials (splits, Tp, 18) and cam_partials
// (splits ceil(Tp / 256), 3) float32, 1 <= splits <= ceil(R / 128); dc
// (Tp, 32) and dcam (3,) float32 outputs, every entry written. Launches the
// rays' packing, the kernel and the sums over the runs and blocks on
// `stream`; returns the first cudaError_t.
extern "C" int raytpu_soft_rt_pri_bwd_tables(const void* consts, int Tp,
                                             int chunk, const void* cam,
                                             const void* dirs, int R,
                                             float es, float zs,
                                             const void* m, const void* cot,
                                             void* rays, int splits,
                                             void* partials,
                                             void* cam_partials, void* dc,
                                             void* dcam, void* stream) {
  const int n_tiles = (R + kRayTile - 1) / kRayTile;
  if (bad_shape(Tp, chunk, R) || splits < 1 || splits > n_tiles ||
      splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Rp = n_tiles * kRayTile;
  float4* packed = static_cast<float4*>(rays);
  pack_pri_rays_kernel<<<(Rp + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(m),
      static_cast<const float*>(cot), R, Rp, packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (Tp + kThreads - 1) / kThreads;
  float* part = static_cast<float*>(partials);
  float* cpart = static_cast<float*>(cam_partials);
  soft_rt_pri_bwd_tables_kernel<<<dim3(row_blocks, splits), kThreads, 0,
                                  st>>>(
      static_cast<const float*>(consts), Tp, static_cast<const float*>(cam),
      packed, R, (n_tiles + splits - 1) / splits, es, zs, part, cpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_groups(part, splits, Tp, kPriUsed, kPriCols,
                   static_cast<float*>(dc), st);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_groups(cpart, splits * row_blocks, 1, 3, 3,
                         static_cast<float*>(dcam), st);
}

// K10f: consts, cam, dirs, m and cot as for raytpu_soft_rt_pri_bwd_tables;
// run the chunks of K10c's runs, whose sums d dirs folds as K10c does;
// scratch: rows (Tp, 24) float32, the staged table; dd (3, R) float32
// output. Launches the table's staging and the kernel on `stream`; returns
// the first cudaError_t.
extern "C" int raytpu_soft_rt_pri_bwd_dirs(const void* consts, int Tp,
                                           int chunk, const void* cam,
                                           const void* dirs, int R, float es,
                                           float zs, int run, const void* m,
                                           const void* cot, void* rows,
                                           void* dd, void* stream) {
  if (bad_shape(Tp, chunk, R) || run < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* staged = static_cast<float4*>(rows);
  pack_pri_rows_kernel<<<(Tp + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(consts), Tp, zs, staged);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  soft_rt_pri_bwd_dirs_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                                st>>>(
      staged, Tp, chunk, static_cast<const float*>(cam),
      static_cast<const float*>(dirs), R, es, zs, run,
      static_cast<const float*>(m), static_cast<const float*>(cot),
      static_cast<float*>(dd));
  return (int)cudaGetLastError();
}

// out (n,) = expf(x (n,)), float32 device pointers, as the kernels above
// compute it (the tests' probe of pri_pair_dead's underflow). Launches on
// `stream`; returns the launch's cudaError_t.
extern "C" int raytpu_soft_rt_expf(const void* x, int n, void* out,
                                   void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  expf_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// out (n,) = sigmoid(x (n,)), float32 device pointers, as the kernels
// above compute it (the tests' probe of shw_triple_dead's exact zero).
// Launches on `stream`; returns the launch's cudaError_t.
extern "C" int raytpu_soft_rt_sigmoid(const void* x, int n, void* out,
                                      void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  sigmoid_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// K10k: consts (Tp, 16) float32 in chunks of `chunk` <= 32 rows; srcs
// (S, 3), world (3, R), trans and gcot (S, R) float32; scratch: pts (S,
// ceil(R / 256) 256, 8) and partials (splits, Tp, 14) float32, 1 <= splits
// <= ceil(R / 256); dc (Tp, 16) float32 output, every entry written.
// Launches the points' packing, the kernel and the sum over the runs on
// `stream`; returns the first cudaError_t.
extern "C" int raytpu_soft_rt_shw_bwd_consts(const void* consts, int Tp,
                                             int chunk, const void* srcs,
                                             int S, const void* world, int R,
                                             const void* trans,
                                             const void* gcot, float es,
                                             float zs, void* pts, int splits,
                                             void* partials, void* dc,
                                             void* stream) {
  const int n_tiles = (R + kPtTile - 1) / kPtTile;
  if (bad_shape(Tp, chunk, R) || S < 1 || S > 65535 || splits < 1 ||
      splits > n_tiles || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Rp = n_tiles * kPtTile;
  float4* packed = static_cast<float4*>(pts);
  pack_shw_points_kernel<<<dim3(Rp / kThreads, S), kThreads, 0, st>>>(
      static_cast<const float*>(srcs), static_cast<const float*>(world), R,
      Rp, static_cast<const float*>(trans), static_cast<const float*>(gcot),
      packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* part = static_cast<float*>(partials);
  soft_rt_shw_bwd_consts_kernel<<<dim3((Tp + kThreads - 1) / kThreads,
                                       splits),
                                  kThreads, 0, st>>>(
      static_cast<const float*>(consts), Tp, static_cast<const float*>(srcs),
      S, packed, Rp, (n_tiles + splits - 1) / splits, es, zs, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_groups(part, splits, Tp, kShwUsed, kShwCols,
                         static_cast<float*>(dc), st);
}

// K10l: consts, srcs, world, trans and gcot as for
// raytpu_soft_rt_shw_bwd_consts; run the chunks of K10i's runs, whose sums
// d world folds as K10i does; scratch: rows (S, Tp, 24) float32, the
// table staged for each source, and src_partials (ceil(R / 256), S, 3)
// float32; dsrc (S, 3) and dw (3, R) float32 outputs. Launches the
// table's staging, the kernel and the sources' sum on `stream`; returns
// the first cudaError_t.
extern "C" int raytpu_soft_rt_shw_bwd_rays(const void* consts, int Tp,
                                           int chunk, const void* srcs, int S,
                                           const void* world, int R,
                                           const void* trans,
                                           const void* gcot, float es,
                                           float zs, int run, void* rows,
                                           void* src_partials, void* dsrc,
                                           void* dw, void* stream) {
  if (bad_shape(Tp, chunk, R) || S < 1 || S > 65535 || run < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* staged = static_cast<float4*>(rows);
  pack_shw_rows_kernel<<<dim3((Tp + kThreads - 1) / kThreads, S), kThreads,
                         0, st>>>(static_cast<const float*>(consts), Tp,
                                  static_cast<const float*>(srcs), staged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kThreads - 1) / kThreads;
  float* spart = static_cast<float*>(src_partials);
  soft_rt_shw_bwd_rays_kernel<<<blocks, kThreads, 0, st>>>(
      staged, Tp, chunk, static_cast<const float*>(srcs), S,
      static_cast<const float*>(world), R, static_cast<const float*>(trans),
      static_cast<const float*>(gcot), es, zs, run, spart,
      static_cast<float*>(dw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_groups(spart, blocks, S, 3, 3, static_cast<float*>(dsrc),
                         st);
}
