// The soft (differentiable) rasterizer's aggregation for Hopper (sm_90a):
// K9a-K9d.
//
// K9a, soft_raster_fwd_kernel<false>, replaces
// raytpu/kernels/soft_raster_pallas.py::_fwd_kernel; K9b,
// soft_raster_fwd_kernel<true>, replaces _fwd_kernel_masked; K9c replaces
// _bwd_kernel and K9d _bwd_kernel_masked: both are soft_bwd_list_kernel,
// soft_bwd_items_kernel, soft_raster_bwd_kernel and the fixed-order sum
// soft_raster_bwd_sum_kernel, K9c with every tile kept.
//
// What they compute. For every pixel (x, y) of an H x W image (integer
// coordinates, row-major r = y W + x; the image is rows [y0, y0 + H) of the
// frame, as the sharded soft rasterizer's row blocks are, so a pixel's y
// coordinate is float(y0 + y), exact below 2^24) and every row of the
// (Tp, 32) float32 triangle table of kernels/soft_raster.py::
// soft_tri_constants, the logit
//   zs zpx + log_sigmoid(es sdist) + log(valid + 1e-20)
// and the 10 attribute values [albedo rgb, pos3d numerator xyz, zpx,
// normal xyz] of _chunk_terms (soft_raster_pallas.py:146-242), with the
// background hypothesis (logit 0, zero attributes) in the softmax. The
// forward keeps JAX's chunk-by-chunk online softmax: a chunk's max, one
// exp(m - m_new) rescale of the carry, then the chunk's sums; it writes
// agg (10, R) = acc / s and the residuals m (R,) and s (R,). The masked
// forward skips the (16 x 16 pixel tile, chunk) pairs whose keep-mask bit is
// 0, leaving that tile's carry as it was. The backward takes m and the 11
// cotangent rows cot = [d s, d acc_0..9] (formed outside, as _soft_agg_bwd
// does) and gives d consts (Tp, 32): per (pixel, row), at the saved m (a
// constant: the image is invariant to it),
//   w = exp(logit - m),  dL/dlogit = w (ds + sum_j da_j val_j),
//   dL/dval_j = w da_j,
// taken back by hand through _chunk_terms to the 29 used columns. Ties pass
// half the gradient to each side, as jnp.minimum and jnp.clip do (and
// torch.minimum, which the plain version uses); d log_sigmoid(x) / dx =
// sigmoid(-x). The camera-globals and lights tables of the TPU kernels are
// never read by _chunk_terms (ROADMAP fault F3), so these kernels take
// neither and give no gradient for them (JAX's is exactly zero).
//
// Layout and design. The TPU grid walked (1,024-pixel swizzled tile, chunk)
// in order and carried (m, s, acc) in VMEM scratch. Here the forward (below,
// "K9a and K9b, redesigned") runs one thread a pixel of a 16 x 16 tile
// (ragged edges computed and not stored) with the carry in registers, skips
// the rows it proves of weight exactly 0 at every pixel of the tile, and
// cuts each tile's kept chunks into work items across the card.
// The backward (below, "K9c and K9d, redesigned") works in items of a
// chunk and a run of its kept tiles, a pixel a lane, and skips the pairs
// whose weight it proves exactly 0; every sum has a fixed order, so two
// calls give the same bits.
//
// Bound on the H100: ~200 float operations a live (pixel, row) pair
// forward, plus ~150 for the dead test of each (tile, row) pair it walks; a
// backward pair pays its dead test (soft_dist, B, the comparison) and, if
// live, ~290 more (pair_bwd past soft_dist); against 48 B a pixel of output
// (forward) or input (backward) and the table: bound by operations
// (chip_smoke.py counts them on its inputs: FLOPS_SOFT_*).
//
// Rounding. Built with -fmad=false and IEEE division and sqrt; every
// expression in the JAX kernel's order, so the forward matches the plain
// PyTorch version (kernels/soft_raster.py::soft_agg_reference) to the
// order of its sums.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "work_items.cuh"

namespace {

constexpr int kTile = 16;                  // forward block: a 16 x 16 tile
constexpr int kThreads = kTile * kTile;
constexpr int kMaxChunk = 32;              // rows a chunk
constexpr int kCols = 32;                  // columns of the table
constexpr int kUsed = 29;                  // columns _chunk_terms reads
constexpr int kCh = 10;                    // aggregated channels
constexpr int kDerived = 4;                // per-row values derived once
constexpr int kSumSlices = 32;             // sum kernel: slices of groups

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// d clip01(x) / dx with jnp.clip's (and torch.maximum/minimum's) half
// gradient at a tie with either bound.
__device__ __forceinline__ float dclip01(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

// d min(a, b) / da: 1 where a is the smaller, half on a tie.
__device__ __forceinline__ float dmin_first(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// Differences first, products after (soft_tri_constants' layout note).
__device__ __forceinline__ float edge_raw(float x0, float y0, float x1,
                                          float y1, float px, float py) {
  return (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
}

// 1 / (|edge|^2 + 1e-12): depends on the row only.
__device__ __forceinline__ float seg_rec(float x0, float y0, float x1,
                                         float y1) {
  const float ex = x1 - x0, ey = y1 - y0;
  return 1.0f / ((ex * ex + ey * ey) + 1e-12f);
}

// Squared distance to the edge SEGMENT plus 1e-20 (_chunk_terms' seg2).
__device__ __forceinline__ float seg2(float x0, float y0, float x1, float y1,
                                      float rec, float px, float py) {
  const float ex = x1 - x0, ey = y1 - y0;
  const float t = clip01(((px - x0) * ex + (py - y0) * ey) * rec);
  const float dx = px - (x0 + t * ex);
  const float dy = py - (y0 + t * ey);
  return (dx * dx + dy * dy) + 1e-20f;
}

// The four per-row values: log(valid + 1e-20) and the reciprocals of the
// edges (a, b), (b, c), (c, a).
__device__ __forceinline__ void derive(const float* c, float* d) {
  d[0] = logf(c[28] + 1e-20f);
  d[1] = seg_rec(c[0], c[1], c[2], c[3]);
  d[2] = seg_rec(c[2], c[3], c[4], c[5]);
  d[3] = seg_rec(c[4], c[5], c[0], c[1]);
}

// The clamped, normalised barycentrics L of a pixel with raw edge values
// r1, r2, and its interpolated zinv (zpx).
__device__ __forceinline__ float bary(const float* c, float r1, float r2,
                                      float* L) {
  const float l0 = r1 * c[9];
  const float l1 = r2 * c[9];
  const float l2 = (1.0f - l0) - l1;
  const float l0c = clip01(l0), l1c = clip01(l1), l2c = clip01(l2);
  const float lrec = 1.0f / (((l0c + l1c) + l2c) + 1e-12f);
  L[0] = l0c * lrec;
  L[1] = l1c * lrec;
  L[2] = l2c * lrec;
  return (L[0] * c[10] + L[1] * c[11]) + L[2] * c[12];
}

// jax.nn.log_sigmoid op by op: min(x, 0) - log1p(exp(-|x|)).
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// The logit of pixel (px, py) against row c.
__device__ __forceinline__ float fwd_logit(const float* c, const float* d,
                                           float px, float py, float es,
                                           float zs) {
  const float ax = c[0], ay = c[1], bx = c[2], by = c[3], cx = c[4],
              cy = c[5];
  const float r0 = edge_raw(ax, ay, bx, by, px, py);
  const float r1 = edge_raw(bx, by, cx, cy, px, py);
  const float r2 = edge_raw(cx, cy, ax, ay, px, py);
  const float hp = fminf(fminf(r0 * c[6], r1 * c[7]), r2 * c[8]);
  float sd = hp;
  if (!(hp >= 0.0f)) {  // outside: minus the distance to the nearest edge
    const float q0 = seg2(ax, ay, bx, by, d[1], px, py);
    const float q1 = seg2(bx, by, cx, cy, d[2], px, py);
    const float q2 = seg2(cx, cy, ax, ay, d[3], px, py);
    sd = -sqrtf(fminf(fminf(q0, q1), q2));
  }
  float L[3];
  const float zpx = bary(c, r1, r2, L);
  return (zs * zpx + log_sigmoid(es * sd)) + d[0];
}

// Backward of edge_raw(x0, y0, x1, y1) with cotangent dr into the vertex
// gradients (gx0, gy0), (gx1, gy1).
__device__ __forceinline__ void edge_raw_bwd(float x0, float y0, float x1,
                                             float y1, float px, float py,
                                             float dr, float* gx0, float* gy0,
                                             float* gx1, float* gy1) {
  const float dA = dr * (py - y0);   // A = x1 - x0
  const float dB = dr * (x1 - x0);   // B = py - y0
  const float dC = -dr * (px - x0);  // C = y1 - y0
  const float dD = -dr * (y1 - y0);  // D = px - x0
  *gx1 += dA;
  *gx0 -= dA + dD;
  *gy1 += dC;
  *gy0 -= dB + dC;
}

// Backward of seg2(x0, y0, x1, y1) with cotangent dq.
__device__ __forceinline__ void seg2_bwd(float x0, float y0, float x1,
                                         float y1, float rec, float px,
                                         float py, float dq, float* gx0,
                                         float* gy0, float* gx1, float* gy1) {
  const float ex = x1 - x0, ey = y1 - y0;
  const float n = (px - x0) * ex + (py - y0) * ey;
  const float u = n * rec;
  const float t = clip01(u);
  const float dx = px - (x0 + t * ex);
  const float dy = py - (y0 + t * ey);
  const float ddx = 2.0f * dx * dq, ddy = 2.0f * dy * dq;
  // dx = px - (x0 + t ex), dy = py - (y0 + t ey)
  float gx0_ = -ddx, gy0_ = -ddy;
  float dex = -ddx * t, dey = -ddy * t;
  const float du = (-ddx * ex - ddy * ey) * dclip01(u);
  // u = n rec, n = (px - x0) ex + (py - y0) ey, rec = 1 / (ex^2 + ey^2 + eps)
  const float dn = du * rec;
  const float dden = -(du * n) * rec * rec;
  gx0_ -= dn * ex;
  gy0_ -= dn * ey;
  dex += dn * (px - x0) + 2.0f * ex * dden;
  dey += dn * (py - y0) + 2.0f * ey * dden;
  *gx0 += gx0_ - dex;
  *gy0 += gy0_ - dey;
  *gx1 += dex;
  *gy1 += dey;
}

// The forward half of pair_bwd that its dead test shares: the raw edge
// values, the half-plane values, the segment distances (outside only) and
// the signed distance sd, each in fwd_logit's expressions.
struct SoftDist {
  float r0, r1, r2, e0, e1, e2, e01, q0, q1, q2, q01, smin, sd;
  bool inside;
};

__device__ __forceinline__ SoftDist soft_dist(const float* c, const float* d,
                                              float px, float py) {
  SoftDist s;
  const float ax = c[0], ay = c[1], bx = c[2], by = c[3], cx = c[4],
              cy = c[5];
  s.r0 = edge_raw(ax, ay, bx, by, px, py);
  s.r1 = edge_raw(bx, by, cx, cy, px, py);
  s.r2 = edge_raw(cx, cy, ax, ay, px, py);
  s.e0 = s.r0 * c[6];
  s.e1 = s.r1 * c[7];
  s.e2 = s.r2 * c[8];
  s.e01 = fminf(s.e0, s.e1);
  const float hp = fminf(s.e01, s.e2);
  s.inside = hp >= 0.0f;
  s.q0 = s.q1 = s.q2 = s.q01 = s.smin = 0.0f;
  s.sd = hp;
  if (!s.inside) {
    s.q0 = seg2(ax, ay, bx, by, d[1], px, py);
    s.q1 = seg2(bx, by, cx, cy, d[2], px, py);
    s.q2 = seg2(cx, cy, ax, ay, d[3], px, py);
    s.q01 = fminf(s.q0, s.q1);
    s.smin = sqrtf(fminf(s.q01, s.q2));
    s.sd = -s.smin;
  }
  return s;
}

// Adds the gradient of one (pixel, row) pair to g[29], going on from the
// pair's soft_dist and xs = es sd: c the row's constants, d its derived
// values, mp the pixel's saved max, ds and da its cotangents.
__device__ __forceinline__ void pair_bwd(const float* c, const float* d,
                                         const SoftDist& s, float xs,
                                         float px, float py, float mp,
                                         float ds, const float* da, float es,
                                         float zs, float* g) {
  const float ax = c[0], ay = c[1], bx = c[2], by = c[3], cx = c[4],
              cy = c[5];
  const float r0 = s.r0, r1 = s.r1, r2 = s.r2;
  // Barycentrics, kept unrolled for the backward.
  const float l0 = r1 * c[9];
  const float l1 = r2 * c[9];
  const float l2 = (1.0f - l0) - l1;
  const float l0c = clip01(l0), l1c = clip01(l1), l2c = clip01(l2);
  const float lrec = 1.0f / (((l0c + l1c) + l2c) + 1e-12f);
  const float L0 = l0c * lrec, L1 = l1c * lrec, L2 = l2c * lrec;
  const float zpx = (L0 * c[10] + L1 * c[11]) + L2 * c[12];
  const float ex = expf(-fabsf(xs));
  const float logit =
      (zs * zpx + (fminf(xs, 0.0f) - log1pf(ex))) + d[0];
  const float w = expf(logit - mp);
  float p[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = (L0 * c[13 + j] + L1 * c[16 + j]) + L2 * c[19 + j];
  }
  // dL/dlogit = w (ds + sum_j da_j val_j).
  float inner = ds;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    inner += da[j] * c[22 + j] + da[3 + j] * p[j] + da[7 + j] * c[25 + j];
  }
  inner += da[6] * zpx;
  const float G = w * inner;

  // The attribute values.
  float dL0 = 0.0f, dL1 = 0.0f, dL2 = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g[22 + j] += w * da[j];
    g[25 + j] += w * da[7 + j];
    const float V = w * da[3 + j];
    dL0 += V * c[13 + j];
    dL1 += V * c[16 + j];
    dL2 += V * c[19 + j];
    g[13 + j] += V * L0;
    g[16 + j] += V * L1;
    g[19 + j] += V * L2;
  }
  // zpx: in the logit (zs zpx) and as value 6.
  const float Z = w * da[6] + G * zs;
  dL0 += Z * c[10];
  dL1 += Z * c[11];
  dL2 += Z * c[12];
  g[10] += Z * L0;
  g[11] += Z * L1;
  g[12] += Z * L2;
  // log(valid + 1e-20): 1 / (valid + 1e-20), 1e20 on padding rows.
  g[28] += G / (c[28] + 1e-20f);
  // log_sigmoid(es sd): sigmoid(-x) = e / (1 + e) for x >= 0, else
  // 1 / (1 + e), with e = exp(-|x|).
  const float sig = xs >= 0.0f ? ex / (1.0f + ex) : 1.0f / (1.0f + ex);
  const float dsd = G * sig * es;

  // L_k = lkc lrec, lrec = 1 / (l0c + l1c + l2c + 1e-12), lkc = clip(lk).
  const float dlrec = (dL0 * l0c + dL1 * l1c) + dL2 * l2c;
  const float dS = -dlrec * lrec * lrec;
  const float dl0 = (dL0 * lrec + dS) * dclip01(l0);
  const float dl1 = (dL1 * lrec + dS) * dclip01(l1);
  const float dl2 = (dL2 * lrec + dS) * dclip01(l2);
  // l2 = (1 - l0) - l1; l0 = r1 ia, l1 = r2 ia.
  const float dl0t = dl0 - dl2, dl1t = dl1 - dl2;
  float dr0 = 0.0f;
  float dr1 = dl0t * c[9];
  float dr2 = dl1t * c[9];
  g[9] += dl0t * r1 + dl1t * r2;

  float gax = 0.0f, gay = 0.0f, gbx = 0.0f, gby = 0.0f, gcx = 0.0f,
        gcy = 0.0f;
  if (s.inside) {
    // sd = hp = min(min(e0, e1), e2), e_k = r_k s_k.
    const float d01 = dsd * dmin_first(s.e01, s.e2);
    const float de2 = dsd * dmin_first(s.e2, s.e01);
    const float de0 = d01 * dmin_first(s.e0, s.e1);
    const float de1 = d01 * dmin_first(s.e1, s.e0);
    dr0 += de0 * c[6];
    dr1 += de1 * c[7];
    dr2 += de2 * c[8];
    g[6] += de0 * r0;
    g[7] += de1 * r1;
    g[8] += de2 * r2;
  } else {
    // sd = -sqrt(min(min(q0, q1), q2)).
    const float dQ = -dsd / (2.0f * s.smin);
    const float d01 = dQ * dmin_first(s.q01, s.q2);
    const float dq2 = dQ * dmin_first(s.q2, s.q01);
    const float dq0 = d01 * dmin_first(s.q0, s.q1);
    const float dq1 = d01 * dmin_first(s.q1, s.q0);
    if (dq0 != 0.0f)
      seg2_bwd(ax, ay, bx, by, d[1], px, py, dq0, &gax, &gay, &gbx, &gby);
    if (dq1 != 0.0f)
      seg2_bwd(bx, by, cx, cy, d[2], px, py, dq1, &gbx, &gby, &gcx, &gcy);
    if (dq2 != 0.0f)
      seg2_bwd(cx, cy, ax, ay, d[3], px, py, dq2, &gcx, &gcy, &gax, &gay);
  }
  edge_raw_bwd(ax, ay, bx, by, px, py, dr0, &gax, &gay, &gbx, &gby);
  edge_raw_bwd(bx, by, cx, cy, px, py, dr1, &gbx, &gby, &gcx, &gcy);
  edge_raw_bwd(cx, cy, ax, ay, px, py, dr2, &gcx, &gcy, &gax, &gay);
  g[0] += gax;
  g[1] += gay;
  g[2] += gbx;
  g[3] += gby;
  g[4] += gcx;
  g[5] += gcy;
}

// ---------------------------------------------------------------------------
// K9c and K9d, redesigned for Hopper around the dead pairs.
//
// On the culled soft STL step (512^2, the 9,028-triangle mesh padded to
// 9,216, es = zs = 40) 93% of the kept (pixel, row) pairs have a weight
// exp(logit - m) of exactly 0 (96.9% of the (tile, chunk) pairs are culled
// first), and at the bench's Cornell step 89% of all pairs. Running
// pair_bwd's ~380 operations (a sqrt, expf, log1pf, IEEE divides) on every
// one, in a grid of (chunk, tile group) blocks that walks every tile's
// mask bit and lasts as long as its busiest chunk, took 17.5x the bound.
// So the kernels test each pair first and spread the kept pairs in items.
//
// The dead test (soft_pair_dead). The logit is
//   (zs zpx + (min(xs, 0) - log1p(exp(-|xs|)))) + d0,
// xs = es sd, d0 = log(valid + 1e-20). Its bound
//   B = (zb + cap) + d0,  cap = xs > 0 ? 0 : xs,
// takes sd and xs from soft_dist, the same floats pair_bwd goes on from
// (so the live path pays no second distance), and zb >= fl(zs zpx) for any
// barycentrics: L_k in [0, 1 + 5e] with sum <= 1 + 4e (e = 2^-24; clip01
// drops a NaN, so each L_k is finite), so |fl(zs zpx)| <= |zs| max|zinv_k|
// (1 + 8.2e), and zb = max(fl(fl(|zs| max|zinv_k|) (1 + 2^-16)), 2^-99)
// exceeds it. log1pf of exp(-|xs|) in [0, 1] is >= 0, and rounding to
// nearest is monotone in each operand of a sum or difference, so the
// float32 B is >= the float32 logit exactly. Then fl(logit - m) <=
// fl(B - m), and where B - m < kDeadBelow = -110, w = expf(logit - m) is
// exactly 0 on the card (float32 expf underflows below about -103.97;
// tests/test_torch_gpu.py enumerates -110 to -200 through
// raytpu_soft_rt_expf, built with these flags).
//
// No 0 * inf. The test marks a pair dead only where every factor that
// meets w is finite, so that every term pair_bwd would add is +-0: the
// row's 29 used columns and the pixel's 11 cotangents lie within
// kTame = 2^40 in magnitude (every product and sum of pair_bwd then stays
// below 2^125), es and zs too, and valid + 1e-20 is not 0 (G / 0). A row
// that fails carries zb = NaN, a pixel that fails m = NaN in the test, so
// B - m is NaN and the comparison false; a NaN in B or m falls through the
// same way (cap keeps a NaN xs, where fminf would drop it). A sum that
// starts at +0 never becomes -0, and adding +-0 to it changes no bit, so a
// skipped pair leaves every sum as it was.
//
// Work items (no host sync, no atomic work counter). soft_bwd_list_kernel
// lists each chunk's kept tiles in tile order (every tile for K9c);
// soft_bwd_items_kernel cuts each list into runs of `run` tiles, run =
// max(1, ceil(kept pairs / kMaxItems)) (one tile a run on the Cornell
// step's 1,024 tiles, a few on the culled mesh), and numbers the runs
// chunk by chunk: at most kMaxItems + n_chunks items. soft_raster_bwd_kernel
// runs as many blocks as the card holds at once; block b takes items b,
// b + blocks, ... Each item: the chunk's rows staged in shared memory
// (stage_bwd_row: 29 columns, the four derived values, zb), then for each
// tile of the run, warp w takes the 4 x 8 pixel block w of the 16 x 16
// tile, a pixel a lane, and walks the chunk's rows: every lane runs the
// dead test, and a row with a live lane (a ballot) runs pair_bwd on its
// live lanes; the warp's 29 sums are added across lanes by a reduce-scatter
// (5 shuffle levels, fixed order) that leaves column k's total in lane k,
// which adds it to the warp's (row, column) sum in shared memory. A warp
// on a compact pixel block keeps its lanes busy: on the mesh step 8.7% of
// (warp, row) units have a live lane and 79% of their lanes are live
// (with a row a lane and the pixels in turn, ~25%). The block
// adds its 8 warps in order into the item's (chunk, 32) partial, and
// soft_raster_bwd_sum_kernel adds each chunk's items in run order. Every
// sum has a fixed order, so two calls give the same bits, and K9c is K9d
// with every tile kept: the same items and sums, bit for bit.
//
// Scratch (raytpu_soft_raster_bwd_scratch): the lists (n_chunks n_tiles
// ints), the kept counts, item offsets and item chunks, and the partials,
// (kMaxItems + n_chunks) x chunk x 32 floats: 9.6 MB at 288 chunks of 32,
// 8.4 MB for one chunk; the lists 1.2 MB at 288 chunks and 1,024 tiles.

constexpr int kBwdWarps = kThreads / 32;    // warps a block: 8
constexpr int kBlockRowsPx = 4;             // a warp's pixel block: 4 x 8
constexpr int kBlockColsPx = 8;
constexpr int kRowStride = 40;              // floats a staged row
constexpr int kMaxItems = 2048;             // runs of kept tiles, about
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kDeadBelow = -110.0f;       // B - m below this: w = 0
constexpr float kTame = 0x1p40f;            // inputs a dead pair may have
constexpr float kZSlack = 0x1.0001p0f;      // 1 + 2^-16
constexpr float kZFloor = 0x1p-99f;

// A row staged for the backward: q[0..28] its used columns, q[32..35] the
// four derived values (derive), q[36] zb (NaN where the row may not be
// found dead).
__device__ __forceinline__ void stage_bwd_row(const float* src, float es,
                                              float zs, float* q) {
  bool tame = fabsf(es) <= kTame && fabsf(zs) <= kTame;
#pragma unroll
  for (int k = 0; k < kUsed; ++k) {
    q[k] = src[k];
    tame &= fabsf(q[k]) <= kTame;
  }
  derive(q, q + 32);
  tame &= (q[28] + 1e-20f) != 0.0f;
  const float zabs = fmaxf(fmaxf(fabsf(q[10]), fabsf(q[11])), fabsf(q[12]));
  const float zb = fmaxf((fabsf(zs) * zabs) * kZSlack, kZFloor);
  q[36] = tame ? zb : CUDART_NAN_F;
}

// True where pair_bwd of a pair would add only +-0 (above): q the staged
// row, xs = es sd from the pair's soft_dist (which pair_bwd goes on from),
// mt the pixel's saved max, or NaN for a pixel whose cotangents may not be
// skipped.
__device__ __forceinline__ bool soft_pair_dead(const float* q, float xs,
                                               float mt) {
  const float cap = xs > 0.0f ? 0.0f : xs;
  return ((q[36] + cap) + q[32]) - mt < kDeadBelow;
}

// One level of reduce_scatter: a lane keeps the half of g[0, 2 half) its
// bit `half` selects and adds its partner's copy of that half.
template <int kHalf>
__device__ __forceinline__ void scatter_level(float* g, int lane) {
  const bool hi = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = hi ? g[i] : g[i + kHalf];
    const float keep = hi ? g[i + kHalf] : g[i];
    g[i] = keep + __shfl_xor_sync(kFullMask, send, kHalf);
  }
}

// Column k of the warp's 32 sums g[0..31] added over its lanes, returned in
// lane k: five levels, each lane keeping half of what it holds and adding
// its partner's other half, in a fixed order.
__device__ __forceinline__ float reduce_scatter(float* g) {
  const int lane = threadIdx.x & 31;
  scatter_level<16>(g, lane);
  scatter_level<8>(g, lane);
  scatter_level<4>(g, lane);
  scatter_level<2>(g, lane);
  scatter_level<1>(g, lane);
  return g[0];
}

// Each chunk's kept tiles in tile order (mask null: every tile), a block a
// chunk: list[ch n_tiles + i] for i < kept[ch].
__global__ void __launch_bounds__(kThreads)
    soft_bwd_list_kernel(const int* __restrict__ mask, int n_tiles,
                         int n_chunks, int* __restrict__ list,
                         int* __restrict__ kept) {
  __shared__ int s_warp[kBwdWarps];
  const int ch = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const bool keep =
        t < n_tiles &&
        (mask == nullptr || mask[static_cast<size_t>(t) * n_chunks + ch] != 0);
    const unsigned ballot = __ballot_sync(kFullMask, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kBwdWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (keep)
      list[static_cast<size_t>(ch) * n_tiles + base + before +
           __popc(ballot & ((1u << lane) - 1u))] = t;
    base += total;
    __syncthreads();  // s_warp is read
  }
  if (threadIdx.x == 0) kept[ch] = base;
}

// One block: the run length (counts[1]) from the kept pairs, each chunk's
// first item (off, n_chunks + 1 entries), each item's chunk (item_ch) and
// the item count (counts[0]). Thread i takes chunks [i span, (i + 1) span).
__global__ void __launch_bounds__(1024)
    soft_bwd_items_kernel(const int* __restrict__ kept, int n_chunks,
                          int* __restrict__ off, int* __restrict__ item_ch,
                          int* __restrict__ counts) {
  __shared__ long long s_sum[1024];
  __shared__ int s_run;
  const int tid = threadIdx.x;
  const int span = (n_chunks + 1023) / 1024;
  const int lo = tid * span < n_chunks ? tid * span : n_chunks;
  const int hi = lo + span < n_chunks ? lo + span : n_chunks;
  long long pairs = 0;
  for (int ch = lo; ch < hi; ++ch) pairs += kept[ch];
  s_sum[tid] = pairs;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int i = 0; i < 1024; ++i) total += s_sum[i];
    const long long run = (total + kMaxItems - 1) / kMaxItems;
    s_run = run > 1 ? static_cast<int>(run) : 1;
  }
  __syncthreads();
  const int run = s_run;
  int items = 0;
  for (int ch = lo; ch < hi; ++ch) items += (kept[ch] + run - 1) / run;
  __syncthreads();  // s_sum is read
  s_sum[tid] = items;
  __syncthreads();
  if (tid == 0) {  // exclusive prefix over the threads, in order
    long long acc = 0;
    for (int i = 0; i < 1024; ++i) {
      const long long v = s_sum[i];
      s_sum[i] = acc;
      acc += v;
    }
    counts[0] = static_cast<int>(acc);
    counts[1] = run;
    off[n_chunks] = static_cast<int>(acc);
  }
  __syncthreads();
  int at = static_cast<int>(s_sum[tid]);
  for (int ch = lo; ch < hi; ++ch) {
    off[ch] = at;
    const int n = (kept[ch] + run - 1) / run;
    for (int j = 0; j < n; ++j) item_ch[at + j] = ch;
    at += n;
  }
}

__global__ void __launch_bounds__(kThreads)
    soft_raster_bwd_kernel(const float* __restrict__ consts, int chunk,
                           int H, int W, int y0, float es, float zs,
                           const float* __restrict__ m,
                           const float* __restrict__ cot, int n_tiles,
                           const int* __restrict__ list,
                           const int* __restrict__ kept,
                           const int* __restrict__ off,
                           const int* __restrict__ item_ch,
                           const int* __restrict__ counts,
                           float* __restrict__ partials) {
  __shared__ float s_row[kMaxChunk][kRowStride];
  __shared__ float s_acc[kBwdWarps][kMaxChunk][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_items = counts[0], run = counts[1];
  const int tiles_x = (W + kTile - 1) / kTile;
  const size_t R = static_cast<size_t>(H) * W;
  const int bx = (warp % (kTile / kBlockColsPx)) * kBlockColsPx +
                 lane % kBlockColsPx;
  const int by = (warp / (kTile / kBlockColsPx)) * kBlockRowsPx +
                 lane / kBlockColsPx;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int ch = item_ch[it];
    const int q0 = (it - off[ch]) * run;
    const int q1 = q0 + run < kept[ch] ? q0 + run : kept[ch];
    __syncthreads();  // the previous item's rows and sums are read
    if (threadIdx.x < chunk)
      stage_bwd_row(consts + (static_cast<size_t>(ch) * chunk + threadIdx.x) *
                                 kCols,
                    es, zs, s_row[threadIdx.x]);
    for (int o = threadIdx.x; o < kBwdWarps * kMaxChunk * kCols;
         o += kThreads)
      (&s_acc[0][0][0])[o] = 0.0f;
    __syncthreads();
    for (int q = q0; q < q1; ++q) {
      const int t = list[static_cast<size_t>(ch) * n_tiles + q];
      const int x = (t % tiles_x) * kTile + bx;
      const int y = (t / tiles_x) * kTile + by;
      const bool valid = x < W && y < H;
      const size_t r = valid ? static_cast<size_t>(y) * W + x : 0;
      float mp = 0.0f, ds = 0.0f, da[kCh];
      bool tame = valid;
#pragma unroll
      for (int j = 0; j < kCh; ++j) da[j] = 0.0f;
      if (valid) {
        mp = m[r];
        ds = cot[r];
        tame &= fabsf(ds) <= kTame;
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          da[j] = cot[(1 + j) * R + r];
          tame &= fabsf(da[j]) <= kTame;
        }
      }
      const float mt = tame ? mp : CUDART_NAN_F;
      const float px = static_cast<float>(x),
                  py = static_cast<float>(y0 + y);
      for (int i = 0; i < chunk; ++i) {
        const float* qr = s_row[i];
        const SoftDist sdist = soft_dist(qr, qr + 32, px, py);
        const float xs = es * sdist.sd;
        const bool live = valid && !soft_pair_dead(qr, xs, mt);
        if (__ballot_sync(kFullMask, live) == 0u) continue;
        float g[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) g[k] = 0.0f;
        if (live)
          pair_bwd(qr, qr + 32, sdist, xs, px, py, mp, ds, da, es, zs, g);
        const float total = reduce_scatter(g);
        if (lane < kUsed) s_acc[warp][i][lane] += total;
      }
    }
    __syncthreads();
    // The item's partial: the block's warps added in order.
    float* out = partials + static_cast<size_t>(it) * chunk * kCols;
    for (int o = threadIdx.x; o < chunk * kCols; o += kThreads) {
      const int row = o / kCols, k = o % kCols;
      float sum = 0.0f;
      for (int w = 0; w < kBwdWarps; ++w) sum += s_acc[w][row][k];
      out[o] = sum;
    }
  }
}

// dc[o] (o < Tp 32, row o / 32 of chunk ch): the sum over ch's items, in
// run order, of their partials' entry. Thread (x, y) adds items y,
// y + kSumSlices, ... of entry x; thread (x, 0) then adds the kSumSlices
// sums in order. A chunk with no item gets +0.
__global__ void __launch_bounds__(32 * kSumSlices)
    soft_raster_bwd_sum_kernel(const float* __restrict__ partials,
                               const int* __restrict__ off, int chunk,
                               int n, float* __restrict__ dc) {
  __shared__ float s_sum[kSumSlices][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (o < n) {
    const int ch = o / (chunk * kCols), e = o % (chunk * kCols);
    for (int j = off[ch] + threadIdx.y; j < off[ch + 1]; j += kSumSlices)
      acc += partials[static_cast<size_t>(j) * chunk * kCols + e];
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || o >= n) return;
  float total = 0.0f;
  for (int sl = 0; sl < kSumSlices; ++sl) total += s_sum[sl][threadIdx.x];
  dc[o] = total;
}

// The backward's scratch, carved from one buffer in this order, each part
// aligned to 16 bytes.
struct BwdScratch {
  int* list;
  int* kept;
  int* off;
  int* item_ch;
  int* counts;
  float* partials;
  size_t bytes;
};

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

BwdScratch bwd_scratch(void* base, int n_chunks, int n_tiles, int chunk) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t at = 0;
  auto take = [&](size_t n) {
    const uintptr_t q = p + at;
    at += align16(n);
    return q;
  };
  const size_t items = static_cast<size_t>(kMaxItems) + n_chunks;
  BwdScratch sc;
  sc.list = reinterpret_cast<int*>(
      take(static_cast<size_t>(n_chunks) * n_tiles * sizeof(int)));
  sc.kept = reinterpret_cast<int*>(take(n_chunks * sizeof(int)));
  sc.off = reinterpret_cast<int*>(take((n_chunks + 1) * sizeof(int)));
  sc.item_ch = reinterpret_cast<int*>(take(items * sizeof(int)));
  sc.counts = reinterpret_cast<int*>(take(4 * sizeof(int)));
  sc.partials = reinterpret_cast<float*>(
      take(items * chunk * kCols * sizeof(float)));
  sc.bytes = at;
  return sc;
}

bool bad_shape(int Tp, int chunk, int H, int W) {
  return chunk < 1 || chunk > kMaxChunk || Tp < chunk || Tp % chunk != 0 ||
         H < 1 || W < 1;
}

// ---------------------------------------------------------------------------
// K9a and K9b, redesigned for Hopper (one template,
// soft_raster_fwd_kernel<kMasked>; K9a is every chunk kept).
//
// On the culled soft STL step (512^2, the 9,028-triangle mesh padded to
// 9,216, es = zs = 40) a tile keeps a few chunks on average and the tiles
// on the mesh dozens, and within a kept chunk most rows lie farther from
// the tile than a logit bound 110 below the running max allows: their
// weight exp(logit - m_new) is exactly 0 at every pixel of the tile.
//
// The dead-row test (soft_row_bound; kernels/soft_raster.py::soft_row_dead
// is its plain form, op by op). A warp takes an 8 x 4 block of the 16 x 16
// tile, a pixel a lane. When a chunk is staged, lane i of every warp forms
// a bound B of row i's logit over every pixel of the warp's block (its
// pixel corners clipped to the image):
//   B = (zb + cap) + log(valid + 1e-20),
// zb as soft_pair_dead's (>= fl(zs zpx) for any barycentrics of the row;
// NaN where a used column, es or zs lies beyond kTame or valid + 1e-20 is 0:
// such a row is never dead). cap is 0, or, where es > 0 and one edge k is
// computed below 0 at every pixel of the block, fl(es (-d_lb)) with d_lb a
// lower bound of the distance fwd_logit computes at any pixel:
// - One edge below 0 everywhere. e_k = fl(fl(fl(ex fl(py - y0)) - fl(ey
//   fl(px - x0))) s_k) is, operation by operation, monotone in px and in py
//   (rounding to nearest is monotone in each operand; the direction is the
//   signs of ey, ex and s_k), so its largest value over the block is its
//   value at one corner, computed by the same expression (edge_max). Below
//   0 there, every pixel's hp <= e_k < 0 takes the outside branch: sd =
//   -sqrt(min q).
// - d_lb. seg2's nearest point x0 + t ex, t in [0, 1] after clip01, lies
//   within 8 K u (u = 2^-24, K the largest |vertex coordinate|, pixel
//   coordinate or 1) of a point of the segment, hence of the triangle's
//   bounding box; dx = fl(px - qx) then has |dx| >= (gap_x - 8 K u)(1 - u),
//   gap_x the exact distance from the block's x range to the box's, and the
//   sums, squares and square root lose at most 3u more relatively. The
//   kernel's gap is rounded up by at most 2 K u and shortened by E = K 2^-19
//   (32 K u), and the distance it forms is scaled by 1 - 2^-18 (64 u), which
//   covers its own roundings: d_lb <= every pixel's computed sqrt(min q).
//   With es > 0, fl(es (-d_lb)) >= fl(es sd) = xs at every pixel, so cap >=
//   cap(xs) of soft_pair_dead's proof, and B >= the computed logit there
//   (rounding is monotone in each operand of the two sums).
// A row is dead for the warp where fl(B - floor) < kDeadBelow, floor the
// smallest running max m of the block's pixels inside the image (a min over
// the warp's lanes, 0 before an item's first chunk: m starts at 0, the
// background's logit, and never falls). Every such pixel's m_new >= floor, so fl(logit - m_new) <=
// fl(B - floor) < -110 and expf gives exactly +0; the logit lies below m, so
// the row is not the chunk's max either. Skipping it leaves the max, the
// rescale and every sum (w val adds +-0) as they were, bit for bit.
// kTame keeps the products finite, so no logit of a tame row is NaN.
//
// The kernel. Each chunk's rows are staged with cp.async (one float4 a
// thread, a chunk ahead, two buffers, nine float4s a row so that lane i
// reading row i meets no bank conflict; one barrier a chunk). Every warp
// tests the chunk's rows for its own block, a row a lane (live_rows: a
// ballot gives the warp's live rows, whose four derived values the lanes
// write to the warp's own shared memory), and runs the two passes (the
// chunk's max, then the sums) over its live rows only, in triangle order,
// each live logit kept in shared memory in the lane's own column. A block
// of 8 x 4 pixels keeps ~2.8x fewer rows live than the whole tile (the
// CPU's 64^2 torus), and no warp waits on another's test. The card's probe
// (raytpu_soft_row_dead_probe) recomputes every pixel's logit for every
// row the device test calls dead at a block's floor and counts those with
// expf(logit - floor) != 0 or a logit not below it: 0.
//
// Work items (work_items.cuh, K10b's plan). Each tile's kept chunks (K9a:
// every chunk) are cut into runs of pri_fwd_run chunks (the mean kept
// chunks a tile over ceil(kSoftFwdItems / tiles), at least
// kSoftFwdRunMin), a work item
// each; with a mask the run is worked out on the card (shw_plan_kernel,
// pri_fwd_run_kernel, shw_items_kernel), with no host sync. The run
// depends on the shapes and the kept count only, so an all-ones mask and
// no mask split alike: K9b with every bit set gives K9a's bits. Block b
// takes item b. A tile of one item starts from the background (0, 1, 0)
// and writes agg, m and s itself, in the chunk-by-chunk order of the plain
// version; an item of a tile of several carries (m, s, acc) from (0, 0, 0)
// (m >= 0 still, so the skip stays exact) and writes 12 floats a pixel,
// which soft_fwd_merge_kernel folds in run order into the background. Two
// calls give the same bits (no atomics, fixed orders). At 512^2 and above
// K9a has one item a tile (one run of every chunk): no merge.

// Waits until no committed cp.async group is in flight.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

constexpr int kFwdPart = 2 + kCh;  // floats a pixel of an item's partial
// The run rule of K9a's and K9b's items (pri_fwd_run): K10a's and K10b's
// (kernels/soft_raytrace.py PRI_FWD_ITEMS, PRI_FWD_RUN_MIN), measured on
// K10b's step and taken over as they are; kernels/soft_raster.py
// SOFT_FWD_ITEMS, SOFT_FWD_RUN_MIN mirror them.
constexpr int kSoftFwdItems = 1024;
constexpr int kSoftFwdRunMin = 8;
constexpr int kFwdRowQ = 9;  // float4s a staged row: 8 and one of padding
constexpr int kBlocksPerTile = kThreads / 32;  // a warp's 8 x 4 block each

// The pixel corners of a warp's 8 x 4 block clipped to the image, in frame
// coordinates; none (x0 > x1 or y0 > y1) where the block lies past the
// image's edge.
struct SoftRect {
  float x0, x1, y0, y1;
  bool any;
};

// Thread tid's pixel in its 16 x 16 tile: warp w takes the 8 x 4 block w
// (two across, four down), a pixel a lane, row-major in the block.
__device__ __forceinline__ int2 fwd_pixel(int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  return make_int2((warp % (kTile / kBlockColsPx)) * kBlockColsPx +
                       lane % kBlockColsPx,
                   (warp / (kTile / kBlockColsPx)) * kBlockRowsPx +
                       lane / kBlockColsPx);
}

// Warp w's block of tile t of an H x W image at frame row y0.
__device__ __forceinline__ SoftRect soft_rect(int t, int w, int H, int W,
                                              int y0) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int x = (t % tiles_x) * kTile + (w % (kTile / kBlockColsPx)) *
                                            kBlockColsPx;
  const int y = (t / tiles_x) * kTile + (w / (kTile / kBlockColsPx)) *
                                            kBlockRowsPx;
  return {static_cast<float>(x),
          static_cast<float>(min(x + kBlockColsPx - 1, W - 1)),
          static_cast<float>(y0 + y),
          static_cast<float>(y0 + min(y + kBlockRowsPx - 1, H - 1)),
          x < W && y < H};
}

// The largest half-plane value fl(edge_raw(x0, y0, x1, y1, px, py) s) over
// the block: at the corner where each monotone step is largest (see above).
__device__ __forceinline__ float edge_max(float x0, float y0, float x1,
                                          float y1, float s,
                                          const SoftRect& r) {
  const float ex = x1 - x0, ey = y1 - y0;
  const bool up = s >= 0.0f;
  const float py = (ex >= 0.0f) == up ? r.y1 : r.y0;
  const float px = (ey <= 0.0f) == up ? r.x1 : r.x0;
  return edge_raw(x0, y0, x1, y1, px, py) * s;
}

// B >= every logit fwd_logit computes for row c at the pixels of r, ld =
// log(valid + 1e-20) its first derived value; NaN where the row may not be
// found dead (see above).
__device__ __forceinline__ float soft_row_bound(const float* c, float ld,
                                                float es, float zs,
                                                const SoftRect& r) {
  bool tame = fabsf(es) <= kTame && fabsf(zs) <= kTame;
#pragma unroll
  for (int k = 0; k < kUsed; ++k) tame &= fabsf(c[k]) <= kTame;
  tame &= (c[28] + 1e-20f) != 0.0f;
  const float zabs = fmaxf(fmaxf(fabsf(c[10]), fabsf(c[11])), fabsf(c[12]));
  const float zb = fmaxf((fabsf(zs) * zabs) * kZSlack, kZFloor);
  float cap = 0.0f;
  const bool outside = edge_max(c[0], c[1], c[2], c[3], c[6], r) < 0.0f ||
                       edge_max(c[2], c[3], c[4], c[5], c[7], r) < 0.0f ||
                       edge_max(c[4], c[5], c[0], c[1], c[8], r) < 0.0f;
  if (tame && es > 0.0f && outside) {
    float k = fmaxf(fmaxf(r.x1, r.y1), 1.0f);
#pragma unroll
    for (int j = 0; j < 6; ++j) k = fmaxf(k, fabsf(c[j]));
    const float e = k * 0x1p-19f;
    const float bx0 = fminf(fminf(c[0], c[2]), c[4]);
    const float bx1 = fmaxf(fmaxf(c[0], c[2]), c[4]);
    const float by0 = fminf(fminf(c[1], c[3]), c[5]);
    const float by1 = fmaxf(fmaxf(c[1], c[3]), c[5]);
    float gx = fmaxf(fmaxf(bx0 - r.x1, r.x0 - bx1), 0.0f);
    float gy = fmaxf(fmaxf(by0 - r.y1, r.y0 - by1), 0.0f);
    gx = fmaxf(gx - e, 0.0f);
    gy = fmaxf(gy - e, 0.0f);
    const float dlb = sqrtf(gx * gx + gy * gy) * (1.0f - 0x1p-18f);
    cap = es * -dlb;
  }
  return tame ? (zb + cap) + ld : CUDART_NAN_F;
}

// The smallest m over the warp's lanes whose pixel lies in the image.
__device__ __forceinline__ float warp_floor(float m, bool in) {
  float v = in ? m : CUDART_INF_F;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Lane i < chunk tests row i of a staged chunk q (kFwdRowQ float4s a row)
// for the warp's block r at its floor; where live it writes the row's four
// derived values to d[i]. Returns the warp's live rows, bit i for row i.
__device__ __forceinline__ unsigned live_rows(const float4* q, int chunk,
                                              const SoftRect& r,
                                              float m_floor, float es,
                                              float zs, float (*d)[kDerived]) {
  const int lane = threadIdx.x & 31;
  bool live = false;
  if (r.any && lane < chunk) {
    float row[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = q[lane * kFwdRowQ + j];
      row[4 * j] = v.x;
      row[4 * j + 1] = v.y;
      row[4 * j + 2] = v.z;
      row[4 * j + 3] = v.w;
    }
    const float ld = logf(row[28] + 1e-20f);
    live = !(soft_row_bound(row, ld, es, zs, r) - m_floor < kDeadBelow);
    if (live) {
      d[lane][0] = ld;
      d[lane][1] = seg_rec(row[0], row[1], row[2], row[3]);
      d[lane][2] = seg_rec(row[2], row[3], row[4], row[5]);
      d[lane][3] = seg_rec(row[4], row[5], row[0], row[1]);
    }
  }
  const unsigned bits = __ballot_sync(kFullMask, live);
  __syncwarp();  // d is written
  return bits;
}

// K9a (kMasked false) and K9b (true), replace _fwd_kernel and
// _fwd_kernel_masked (see above): block b takes item b of the plan pl
// (masked: its run at run_dev); a thread a pixel of the item's tile, warp w
// its 8 x 4 block w. part (items, 12, 256) the items' (m, s, acc) of tiles
// of more than one item.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 3)
    soft_raster_fwd_kernel(const float* __restrict__ consts, int chunk,
                           ShwPlan pl, const int* __restrict__ run_dev,
                           int H, int W, int y0, float es, float zs,
                           float* __restrict__ part, float* __restrict__ agg,
                           float* __restrict__ m_out,
                           float* __restrict__ s_out) {
  __shared__ float4 s_rows[2][kMaxChunk * kFwdRowQ];
  __shared__ float s_d[kBlocksPerTile][kMaxChunk][kDerived];
  // A live row's logit in its lane's own column: (warp, row, lane).
  __shared__ float s_lg[kBlocksPerTile][kMaxChunk][32];
  const int it = blockIdx.x;
  if (it >= item_count<kMasked>(pl)) return;  // the same for the block
  if (kMasked) pl.run = *run_dev;
  const ShwItem xi = shw_item<kMasked>(pl, it);
  const bool one = pair_items<kMasked>(pl, xi.pair).y == 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int2 at = fwd_pixel(tid);
  const int x = (xi.pair % tiles_x) * kTile + at.x;
  const int y = (xi.pair / tiles_x) * kTile + at.y;
  const bool in = x < W && y < H;
  const SoftRect rect = soft_rect(xi.pair, warp, H, W, y0);
  const float px = static_cast<float>(x), py = static_cast<float>(y0 + y);
  float* lg = &s_lg[warp][0][lane];
  // The background hypothesis (logit 0, zero attributes) where the tile has
  // one item; else the item's own carry, folded into it by the merge.
  float m = 0.0f, s = one ? 1.0f : 0.0f;
  float acc[kCh];
#pragma unroll
  for (int j = 0; j < kCh; ++j) acc[j] = 0.0f;
  // Stage k of the item: its chunk's rows, a float4 a thread.
  auto prefetch_chunk = [&](int k) {
    if (k < xi.n && tid < chunk * 8) {
      const float4* src = reinterpret_cast<const float4*>(
          consts + static_cast<size_t>(item_chunk<kMasked>(xi, k)) * chunk *
                       kCols);
      cp_async16(&s_rows[k & 1][(tid >> 3) * kFwdRowQ + (tid & 7)],
                 src + tid);
    }
    cp_async_commit();
  };
  prefetch_chunk(0);
  for (int k = 0; k < xi.n; ++k) {
    cp_async_wait_all();
    __syncthreads();  // chunk k is in; every warp is done with chunk k - 1
    prefetch_chunk(k + 1);  // into chunk k - 1's buffer
    const float4* q = s_rows[k & 1];
    const unsigned bits = live_rows(q, chunk, rect, warp_floor(m, in), es,
                                    zs, s_d[warp]);
    float cmax = -CUDART_INF_F;
    for (unsigned b = bits; b != 0u; b &= b - 1u) {
      const int i = __ffs(b) - 1;
      const float l =
          fwd_logit(reinterpret_cast<const float*>(q + i * kFwdRowQ),
                    s_d[warp][i], px, py, es, zs);
      lg[i * 32] = l;
      cmax = fmaxf(cmax, l);
    }
    const float m_new = fmaxf(m, cmax);
    const float scale = expf(m - m_new);
    float wsum = 0.0f;
    float vsum[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) vsum[j] = 0.0f;
    for (unsigned b = bits; b != 0u; b &= b - 1u) {
      const int i = __ffs(b) - 1;
      const float* c = reinterpret_cast<const float*>(q + i * kFwdRowQ);
      const float r1 = edge_raw(c[2], c[3], c[4], c[5], px, py);
      const float r2 = edge_raw(c[4], c[5], c[0], c[1], px, py);
      float L[3];
      const float zpx = bary(c, r1, r2, L);
      const float w = expf(lg[i * 32] - m_new);
      wsum += w;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        vsum[j] += w * c[22 + j];
        vsum[3 + j] +=
            w * ((L[0] * c[13 + j] + L[1] * c[16 + j]) + L[2] * c[19 + j]);
        vsum[7 + j] += w * c[25 + j];
      }
      vsum[6] += w * zpx;
    }
    m = m_new;
    s = s * scale + wsum;
#pragma unroll
    for (int j = 0; j < kCh; ++j) acc[j] = acc[j] * scale + vsum[j];
  }
  if (!in) return;
  if (one) {
    const size_t R = static_cast<size_t>(H) * W;
    const size_t r = static_cast<size_t>(y) * W + x;
    const float rec = 1.0f / s;
#pragma unroll
    for (int j = 0; j < kCh; ++j) agg[j * R + r] = acc[j] * rec;
    m_out[r] = m;
    s_out[r] = s;
    return;
  }
  float* p = part + static_cast<size_t>(it) * kFwdPart * kThreads + tid;
  p[0] = m;
  p[kThreads] = s;
#pragma unroll
  for (int j = 0; j < kCh; ++j) p[(2 + j) * kThreads] = acc[j];
}

// K9a's and K9b's merge, a block a tile (the kernel's pixels): a tile of
// one item was written by the kernel; the others' pixels fold their items
// in run order into the background (fold_items); agg = acc / s. A tile that
// keeps no chunk gets the background.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    soft_fwd_merge_kernel(ShwPlan pl, int H, int W,
                          const float* __restrict__ part,
                          float* __restrict__ agg, float* __restrict__ m_out,
                          float* __restrict__ s_out) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int2 px = fwd_pixel(tid);
  const int x = (blockIdx.x % tiles_x) * kTile + px.x;
  const int y = (blockIdx.x / tiles_x) * kTile + px.y;
  const int2 at = pair_items<kMasked>(pl, blockIdx.x);
  if (x >= W || y >= H || at.y == 1) return;
  float m, s, acc[kCh];
  fold_items<kCh>(part + static_cast<size_t>(at.x) * kFwdPart * kThreads +
                      tid,
                  at.y, static_cast<size_t>(kFwdPart) * kThreads, kThreads,
                  &m, &s, acc);
  const size_t R = static_cast<size_t>(H) * W;
  const size_t r = static_cast<size_t>(y) * W + x;
  const float rec = 1.0f / s;
#pragma unroll
  for (int j = 0; j < kCh; ++j) agg[j * R + r] = acc[j] * rec;
  m_out[r] = m;
  s_out[r] = s;
}

// The card's check of the dead-row test, a block a tile as the kernel
// runs it: each warp tests every row of the table for its 8 x 4 block at
// that block's floor (floors[8 t + w]) with live_rows, and evaluates every
// row it calls dead by fwd_logit at each of its pixels inside the image.
// counts[0] += the dead (block, row) pairs of blocks inside the image,
// counts[1] += the (pixel, row) pairs among them with expf(logit - floor)
// != 0 or a logit not below the floor (0 where the test is exact),
// counts[2] += every (block, row) pair of blocks inside the image.
__global__ void __launch_bounds__(kThreads)
    soft_row_dead_probe_kernel(const float* __restrict__ consts, int Tp,
                               int H, int W, int y0, float es, float zs,
                               const float* __restrict__ floors,
                               unsigned long long* __restrict__ counts) {
  __shared__ float4 s_rows[kMaxChunk * kFwdRowQ];
  __shared__ float s_d[kBlocksPerTile][kMaxChunk][kDerived];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int2 at = fwd_pixel(tid);
  const int x = (blockIdx.x % tiles_x) * kTile + at.x;
  const int y = (blockIdx.x / tiles_x) * kTile + at.y;
  const bool in = x < W && y < H;
  const SoftRect rect = soft_rect(blockIdx.x, warp, H, W, y0);
  const float px = static_cast<float>(x), py = static_cast<float>(y0 + y);
  const float f = floors[blockIdx.x * kBlocksPerTile + warp];
  unsigned long long dead = 0, bad = 0, pairs = 0;
  for (int lo = 0; lo < Tp; lo += kMaxChunk) {
    const int n = min(kMaxChunk, Tp - lo);
    __syncthreads();
    if (tid < n * 8)
      s_rows[(tid >> 3) * kFwdRowQ + (tid & 7)] = reinterpret_cast<
          const float4*>(consts + static_cast<size_t>(lo) * kCols)[tid];
    __syncthreads();
    // Every row's derived values, for the dead ones too.
    if (lane < n) {
      const float* c = reinterpret_cast<const float*>(s_rows +
                                                      lane * kFwdRowQ);
      derive(c, s_d[warp][lane]);
    }
    __syncwarp();
    const unsigned live = live_rows(s_rows, n, rect, f, es, zs, s_d[warp]);
    if (!rect.any) continue;
    const unsigned all = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    if (lane == 0) {
      dead += __popc(all & ~live);
      pairs += n;
    }
    for (unsigned b = all & ~live; b != 0u; b &= b - 1u) {
      const int i = __ffs(b) - 1;
      if (!in) continue;
      const float l =
          fwd_logit(reinterpret_cast<const float*>(s_rows + i * kFwdRowQ),
                    s_d[warp][i], px, py, es, zs);
      if (expf(l - f) != 0.0f || !(l < f)) ++bad;
    }
  }
  atomicAdd(counts, dead);
  atomicAdd(counts + 1, bad);
  atomicAdd(counts + 2, pairs);
}

int n_tiles_of(int H, int W) {
  return ((W + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
}

// A K9a/K9b call: its shapes (the first four fields, from the caller), its
// plan (work_items.cuh::FwdPlan) by the run rule kSoftFwdRunMin,
// kSoftFwdItems over its 16 x 16 tiles, carved from the scratch at base (0:
// sized only; the items' partials kFwdPart floats a pixel), and the bytes
// the scratch needs. False where the kernels refuse the shapes.
struct SoftFwdCall {
  int Tp, chunk, H, W;
  FwdPlan plan;
  size_t bytes;
};

bool soft_fwd_plan(SoftFwdCall& fc, bool masked, void* base) {
  if (bad_shape(fc.Tp, fc.chunk, fc.H, fc.W)) return false;
  const int n_tiles = n_tiles_of(fc.H, fc.W);
  if (!fwd_plan_shapes(fc.plan, masked, n_tiles, n_tiles, fc.Tp / fc.chunk,
                       kSoftFwdRunMin, kSoftFwdItems))
    return false;
  Carve c{reinterpret_cast<uintptr_t>(base), 0};
  carve_fwd_plan(fc.plan, c, static_cast<size_t>(kFwdPart) * kThreads);
  fc.bytes = c.at;
  return true;
}

}  // namespace

// consts (Tp, 32) float32 device pointer (16-byte aligned) in chunks of
// `chunk` <= 32 rows; mask (tiles_y * tiles_x, Tp / chunk) int32 over 16 x
// 16 tiles row-major, or null for K9a; the image rows [y0, y0 + H) of the
// frame; scratch (at least what raytpu_soft_raster_fwd_scratch gives for
// these shapes; may be null where that is 0); agg (10, H * W), m and s
// (H * W,) float32 outputs. Launches the plan (masked), K9a or K9b and the
// merge (masked, or more than one run a tile) on `stream`, never
// synchronises, and returns the first cudaError_t.
extern "C" int raytpu_soft_raster_fwd(const void* consts, int Tp, int chunk,
                                      const void* mask, int H, int W, int y0,
                                      float es, float zs, void* scratch,
                                      long long scratch_bytes, void* agg,
                                      void* m, void* s, void* stream) {
  SoftFwdCall fc{Tp, chunk, H, W};
  if (reinterpret_cast<uintptr_t>(consts) % 16 != 0 ||
      !soft_fwd_plan(fc, mask != nullptr, scratch) ||
      !scratch_fits(fc.bytes, scratch, scratch_bytes))
    return (int)cudaErrorInvalidValue;
  const FwdPlan& fp = fc.plan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_fwd_plan(fp, static_cast<const int*>(mask), st);
  if (err != cudaSuccess) return (int)err;
  const ShwPlan pl = fp.view();
  const float* c = static_cast<const float*>(consts);
  float *a = static_cast<float*>(agg), *mo = static_cast<float*>(m),
        *so = static_cast<float*>(s);
  const dim3 block(kThreads);
  auto kernel = fp.masked ? soft_raster_fwd_kernel<true>
                          : soft_raster_fwd_kernel<false>;
  kernel<<<static_cast<int>(fp.max_items), block, 0, st>>>(
      c, chunk, pl, fp.run_dev, H, W, y0, es, zs, fp.part, a, mo, so);
  if ((err = cudaGetLastError()) != cudaSuccess || fp.direct) return (int)err;
  auto merge = fp.masked ? soft_fwd_merge_kernel<true>
                         : soft_fwd_merge_kernel<false>;
  merge<<<fp.n_tiles, block, 0, st>>>(pl, H, W, fp.part, a, mo, so);
  return (int)cudaGetLastError();
}

// The bytes of the scratch of a K9a/K9b call with these shapes (masked: 1
// with a mask), or -1 where the kernels refuse them.
extern "C" long long raytpu_soft_raster_fwd_scratch(int Tp, int chunk, int H,
                                                    int W, int masked) {
  SoftFwdCall fc{Tp, chunk, H, W};
  if (!soft_fwd_plan(fc, masked != 0, nullptr)) return -1;
  return static_cast<long long>(fc.bytes);
}

// consts (Tp, 32) float32 device pointer (16-byte aligned); floors
// (n_tiles * 8,) float32, each 8 x 4 block's floor, tile by tile; counts
// (3,) uint64, zeroed by the caller, to which the probe adds the dead
// (block, row) pairs, the (pixel, row) pairs among them of weight not 0 at
// the floor, and every (block, row) pair of the H x W image at frame row
// y0. Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int raytpu_soft_row_dead_probe(const void* consts, int Tp, int H,
                                          int W, int y0, float es, float zs,
                                          const void* floors, void* counts,
                                          void* stream) {
  if (Tp < 1 || H < 1 || W < 1 ||
      reinterpret_cast<uintptr_t>(consts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  soft_row_dead_probe_kernel<<<n_tiles_of(H, W), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(consts), Tp, H, W, y0, es, zs,
      static_cast<const float*>(floors),
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// The bytes of the backward's scratch for these shapes, or -1 if the
// kernels refuse them.
extern "C" long long raytpu_soft_raster_bwd_scratch(int Tp, int chunk, int H,
                                                    int W) {
  if (bad_shape(Tp, chunk, H, W)) return -1;
  return static_cast<long long>(
      bwd_scratch(nullptr, Tp / chunk, n_tiles_of(H, W), chunk).bytes);
}

// consts and mask as for raytpu_soft_raster_fwd (mask null for K9c); m (H *
// W,) and cot (11, H * W) float32; scratch (scratch_bytes, at least what
// raytpu_soft_raster_bwd_scratch gives); dc (Tp, 32) float32 output, every
// entry written. Launches the lists, the items, K9c or K9d and the sum over
// items on `stream`, never synchronises, and returns the first cudaError_t.
extern "C" int raytpu_soft_raster_bwd(const void* consts, int Tp, int chunk,
                                      const void* mask, int H, int W, int y0,
                                      float es, float zs, const void* m,
                                      const void* cot, void* scratch,
                                      long long scratch_bytes, void* dc,
                                      void* stream) {
  if (bad_shape(Tp, chunk, H, W)) return (int)cudaErrorInvalidValue;
  const int n_chunks = Tp / chunk, n_tiles = n_tiles_of(H, W);
  const BwdScratch sc = bwd_scratch(scratch, n_chunks, n_tiles, chunk);
  if (scratch == nullptr || scratch_bytes < (long long)sc.bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  soft_bwd_list_kernel<<<n_chunks, kThreads, 0, st>>>(
      static_cast<const int*>(mask), n_tiles, n_chunks, sc.list, sc.kept);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  soft_bwd_items_kernel<<<1, 1024, 0, st>>>(sc.kept, n_chunks, sc.off,
                                            sc.item_ch, sc.counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // Persistent blocks: as many as fit on the card at once.
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, soft_raster_bwd_kernel, kThreads, 0)) != cudaSuccess)
    return (int)err;
  soft_raster_bwd_kernel<<<sms * (per_sm > 0 ? per_sm : 1), kThreads, 0,
                           st>>>(
      static_cast<const float*>(consts), chunk, H, W, y0, es, zs,
      static_cast<const float*>(m), static_cast<const float*>(cot), n_tiles,
      sc.list, sc.kept, sc.off, sc.item_ch, sc.counts, sc.partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = Tp * kCols;
  soft_raster_bwd_sum_kernel<<<(n + 31) / 32, dim3(32, kSumSlices), 0, st>>>(
      sc.partials, sc.off, chunk, n, static_cast<float*>(dc));
  return (int)cudaGetLastError();
}
