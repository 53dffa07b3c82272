// The soft (differentiable) rasterizer's aggregation for Hopper (sm_90a):
// K9a-K9d.
//
// K9a, soft_raster_fwd_kernel<false>, replaces
// raytpu/kernels/soft_raster_pallas.py::_fwd_kernel; K9b,
// soft_raster_fwd_kernel<true>, replaces _fwd_kernel_masked; K9c,
// soft_raster_bwd_kernel<false> and the fixed-order sum
// soft_raster_bwd_sum_kernel, replace _bwd_kernel; K9d,
// soft_raster_bwd_kernel<true> and the same sum, replace _bwd_kernel_masked.
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
// in order and carried (m, s, acc) in VMEM scratch. Here the forward runs one
// thread a pixel, a block a 16 x 16 tile (ragged edges computed and not
// stored), with the carry in registers. A block stages one chunk of <= 32
// rows in shared memory (4 KB, read by warp-uniform broadcast) with four
// per-row values derived once (log(valid + 1e-20) and the three segment
// reciprocals), keeps the chunk's 32 logits in registers from the first pass
// (the max), and in the second recomputes only the barycentrics for the
// sums. The masked forward skips a chunk block-uniformly.
// The backward turns the pairing around: a block is 32 rows (one chunk, a
// warp) by 8 pixel slices. Each thread holds its row's 29 constants and 29
// gradient sums in registers and walks the pixels of its slice; a warp reads
// one pixel's m and cotangents at a time, a broadcast. Grid (chunk, group):
// a group takes tiles g, g + groups, ... (the masked backward skips a tile
// whose bit is 0), so one chunk (Cornell) spreads over up to ~1,000 groups
// and 288 chunks (the STL mesh) over a few each. A block adds its 8 slices
// in order and writes one (Tp, 32) partial; the sum kernel adds the groups
// in a fixed order. No floating-point atomics: two calls give the same bits.
//
// Bound on the H100: ~150 float operations and 5-6 exp/log/sqrt/divides a
// (pixel, row) pair forward, ~3x that backward, against 48 B a pixel of
// output (forward) or input (backward) and the table: bound by operations
// (chip_smoke.py counts them on its inputs).
//
// Rounding. Built with -fmad=false and IEEE division and sqrt; every
// expression in the JAX kernel's order, so the forward matches the plain
// PyTorch version (kernels/soft_raster.py::soft_agg_reference) to the
// order of its sums.

#include <cstddef>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 16;                  // forward block: a 16 x 16 tile
constexpr int kThreads = kTile * kTile;
constexpr int kMaxChunk = 32;              // rows a chunk
constexpr int kCols = 32;                  // columns of the table
constexpr int kUsed = 29;                  // columns _chunk_terms reads
constexpr int kCh = 10;                    // aggregated channels
constexpr int kDerived = 4;                // per-row values derived once
constexpr int kSlices = 8;                 // backward: pixel slices a block
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

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    soft_raster_fwd_kernel(const float* __restrict__ consts, int n_chunks,
                           int chunk, const int* __restrict__ mask, int H,
                           int W, int y0, float es, float zs,
                           float* __restrict__ agg,
                           float* __restrict__ m_out,
                           float* __restrict__ s_out) {
  __shared__ float s_c[kMaxChunk * kCols];
  __shared__ float s_d[kMaxChunk * kDerived];
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const float px = static_cast<float>(x), py = static_cast<float>(y0 + y);
  const int* keep =
      kMasked ? mask + static_cast<size_t>(blockIdx.y * gridDim.x +
                                           blockIdx.x) * n_chunks
              : nullptr;
  // The background hypothesis: logit 0, zero attributes (`:254-261`).
  float m = 0.0f, s = 1.0f;
  float acc[kCh];
#pragma unroll
  for (int j = 0; j < kCh; ++j) acc[j] = 0.0f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    if (kMasked && keep[ch] == 0) continue;  // the same bit for the block
    __syncthreads();  // every thread is done with the previous chunk
    const float* src = consts + static_cast<size_t>(ch) * chunk * kCols;
    for (int k = tid; k < chunk * kCols; k += kThreads) s_c[k] = src[k];
    __syncthreads();
    if (tid < chunk) derive(s_c + tid * kCols, s_d + tid * kDerived);
    __syncthreads();

    float logit[kMaxChunk];
    float cmax = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
      if (i < chunk) {
        logit[i] = fwd_logit(s_c + i * kCols, s_d + i * kDerived, px, py, es,
                             zs);
        cmax = fmaxf(cmax, logit[i]);
      }
    }
    const float m_new = fmaxf(m, cmax);
    const float scale = expf(m - m_new);
    float wsum = 0.0f;
    float vsum[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) vsum[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxChunk; ++i) {
      if (i < chunk) {
        const float* c = s_c + i * kCols;
        const float r1 = edge_raw(c[2], c[3], c[4], c[5], px, py);
        const float r2 = edge_raw(c[4], c[5], c[0], c[1], px, py);
        float L[3];
        const float zpx = bary(c, r1, r2, L);
        const float w = expf(logit[i] - m_new);
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
    }
    m = m_new;
    s = s * scale + wsum;
#pragma unroll
    for (int j = 0; j < kCh; ++j) acc[j] = acc[j] * scale + vsum[j];
  }
  if (x < W && y < H) {
    const size_t R = static_cast<size_t>(H) * W;
    const size_t r = static_cast<size_t>(y) * W + x;
    const float rec = 1.0f / s;
#pragma unroll
    for (int j = 0; j < kCh; ++j) agg[j * R + r] = acc[j] * rec;
    m_out[r] = m;
    s_out[r] = s;
  }
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

// Adds the gradient of one (pixel, row) pair to g[29]: c the row's
// constants, d its derived values, mp the pixel's saved max, ds and da its
// cotangents.
__device__ __forceinline__ void pair_bwd(const float* c, const float* d,
                                         float px, float py, float mp,
                                         float ds, const float* da, float es,
                                         float zs, float* g) {
  const float ax = c[0], ay = c[1], bx = c[2], by = c[3], cx = c[4],
              cy = c[5];
  const float r0 = edge_raw(ax, ay, bx, by, px, py);
  const float r1 = edge_raw(bx, by, cx, cy, px, py);
  const float r2 = edge_raw(cx, cy, ax, ay, px, py);
  const float e0 = r0 * c[6], e1 = r1 * c[7], e2 = r2 * c[8];
  const float e01 = fminf(e0, e1);
  const float hp = fminf(e01, e2);
  const bool inside = hp >= 0.0f;
  float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, q01 = 0.0f, smin = 0.0f;
  float sd = hp;
  if (!inside) {
    q0 = seg2(ax, ay, bx, by, d[1], px, py);
    q1 = seg2(bx, by, cx, cy, d[2], px, py);
    q2 = seg2(cx, cy, ax, ay, d[3], px, py);
    q01 = fminf(q0, q1);
    smin = sqrtf(fminf(q01, q2));
    sd = -smin;
  }
  // Barycentrics, kept unrolled for the backward.
  const float l0 = r1 * c[9];
  const float l1 = r2 * c[9];
  const float l2 = (1.0f - l0) - l1;
  const float l0c = clip01(l0), l1c = clip01(l1), l2c = clip01(l2);
  const float lrec = 1.0f / (((l0c + l1c) + l2c) + 1e-12f);
  const float L0 = l0c * lrec, L1 = l1c * lrec, L2 = l2c * lrec;
  const float zpx = (L0 * c[10] + L1 * c[11]) + L2 * c[12];
  const float xs = es * sd;
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
  if (inside) {
    // sd = hp = min(min(e0, e1), e2), e_k = r_k s_k.
    const float d01 = dsd * dmin_first(e01, e2);
    const float de2 = dsd * dmin_first(e2, e01);
    const float de0 = d01 * dmin_first(e0, e1);
    const float de1 = d01 * dmin_first(e1, e0);
    dr0 += de0 * c[6];
    dr1 += de1 * c[7];
    dr2 += de2 * c[8];
    g[6] += de0 * r0;
    g[7] += de1 * r1;
    g[8] += de2 * r2;
  } else {
    // sd = -sqrt(min(min(q0, q1), q2)).
    const float dQ = -dsd / (2.0f * smin);
    const float d01 = dQ * dmin_first(q01, q2);
    const float dq2 = dQ * dmin_first(q2, q01);
    const float dq0 = d01 * dmin_first(q0, q1);
    const float dq1 = d01 * dmin_first(q1, q0);
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

template <bool kMasked>
__global__ void __launch_bounds__(kMaxChunk* kSlices)
    soft_raster_bwd_kernel(const float* __restrict__ consts, int Tp,
                           int chunk, const int* __restrict__ mask, int H,
                           int W, int y0, float es, float zs,
                           const float* __restrict__ m,
                           const float* __restrict__ cot, int groups,
                           float* __restrict__ partials) {
  __shared__ float s_red[kSlices][kMaxChunk][kUsed];
  const int i = threadIdx.x, slice = threadIdx.y;
  const int ch = blockIdx.x, group = blockIdx.y;
  const int n_chunks = Tp / chunk;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((H + kTile - 1) / kTile);
  const size_t R = static_cast<size_t>(H) * W;
  float acc[kUsed];
#pragma unroll
  for (int k = 0; k < kUsed; ++k) acc[k] = 0.0f;
  if (i < chunk) {
    float c[kUsed], d[kDerived];
    const float* row = consts + (static_cast<size_t>(ch) * chunk + i) * kCols;
#pragma unroll
    for (int k = 0; k < kUsed; ++k) c[k] = row[k];
    derive(c, d);
    for (int t = group; t < n_tiles; t += groups) {
      if (kMasked && mask[static_cast<size_t>(t) * n_chunks + ch] == 0) {
        continue;
      }
      const int tx = (t % tiles_x) * kTile, ty = (t / tiles_x) * kTile;
      for (int p = slice; p < kTile * kTile; p += kSlices) {
        const int x = tx + p % kTile, y = ty + p / kTile;
        if (x >= W || y >= H) continue;
        const size_t r = static_cast<size_t>(y) * W + x;
        float da[kCh];
#pragma unroll
        for (int j = 0; j < kCh; ++j) da[j] = cot[(1 + j) * R + r];
        pair_bwd(c, d, static_cast<float>(x), static_cast<float>(y0 + y),
                 m[r], cot[r], da, es, zs, acc);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kUsed; ++k) s_red[slice][i][k] = acc[k];
  __syncthreads();
  // The block's partial: its slices added in order; columns 29-31 are 0.
  float* out = partials + (static_cast<size_t>(group) * Tp +
                           static_cast<size_t>(ch) * chunk) * kCols;
  for (int o = slice * kMaxChunk + i; o < chunk * kCols;
       o += kMaxChunk * kSlices) {
    const int row = o / kCols, k = o % kCols;
    float sum = 0.0f;
    if (k < kUsed) {
      for (int sl = 0; sl < kSlices; ++sl) sum += s_red[sl][row][k];
    }
    out[o] = sum;
  }
}

// dc[o] = sum over groups g, in order, of partials[g][o]; o < n = Tp * 32.
// Thread (x, y) adds groups y, y + kSumSlices, ... of column x; thread
// (x, 0) then adds the kSumSlices sums in order.
__global__ void __launch_bounds__(32 * kSumSlices)
    soft_raster_bwd_sum_kernel(const float* __restrict__ partials, int groups,
                               int n, float* __restrict__ dc) {
  __shared__ float s_sum[kSumSlices][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (o < n) {
    for (int g = threadIdx.y; g < groups; g += kSumSlices) {
      acc += partials[static_cast<size_t>(g) * n + o];
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || o >= n) return;
  float total = 0.0f;
  for (int sl = 0; sl < kSumSlices; ++sl) total += s_sum[sl][threadIdx.x];
  dc[o] = total;
}

bool bad_shape(int Tp, int chunk, int H, int W) {
  return chunk < 1 || chunk > kMaxChunk || Tp < chunk || Tp % chunk != 0 ||
         H < 1 || W < 1;
}

}  // namespace

// consts (Tp, 32) float32 device pointer in chunks of `chunk` <= 32 rows;
// mask (tiles_y * tiles_x, Tp / chunk) int32 over 16 x 16 tiles row-major,
// or null for K9a; the image rows [y0, y0 + H) of the frame; agg (10, H * W),
// m and s (H * W,) float32 outputs.
// Launches K9a or K9b on `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_soft_raster_fwd(const void* consts, int Tp, int chunk,
                                      const void* mask, int H, int W, int y0,
                                      float es, float zs, void* agg, void* m,
                                      void* s, void* stream) {
  if (bad_shape(Tp, chunk, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const dim3 block(kTile, kTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  const int* mk = static_cast<const int*>(mask);
  float *a = static_cast<float*>(agg), *mo = static_cast<float*>(m),
        *so = static_cast<float*>(s);
  if (mk == nullptr) {
    soft_raster_fwd_kernel<false><<<grid, block, 0, st>>>(
        c, Tp / chunk, chunk, mk, H, W, y0, es, zs, a, mo, so);
  } else {
    soft_raster_fwd_kernel<true><<<grid, block, 0, st>>>(
        c, Tp / chunk, chunk, mk, H, W, y0, es, zs, a, mo, so);
  }
  return (int)cudaGetLastError();
}

// consts and mask as for raytpu_soft_raster_fwd (mask null for K9c); m (H *
// W,) and cot (11, H * W) float32; partials (groups, Tp, 32) float32
// scratch; dc (Tp, 32) float32 output, every entry written. Launches K9c or
// K9d and the sum over groups on `stream`; returns the first cudaError_t.
extern "C" int raytpu_soft_raster_bwd(const void* consts, int Tp, int chunk,
                                      const void* mask, int H, int W, int y0,
                                      float es, float zs, const void* m,
                                      const void* cot, int groups,
                                      void* partials, void* dc,
                                      void* stream) {
  if (bad_shape(Tp, chunk, H, W) || groups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(Tp / chunk, groups);
  const dim3 block(kMaxChunk, kSlices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  const int* mk = static_cast<const int*>(mask);
  const float *mp = static_cast<const float*>(m),
              *cp = static_cast<const float*>(cot);
  float* part = static_cast<float*>(partials);
  if (mk == nullptr) {
    soft_raster_bwd_kernel<false><<<grid, block, 0, st>>>(
        c, Tp, chunk, mk, H, W, y0, es, zs, mp, cp, groups, part);
  } else {
    soft_raster_bwd_kernel<true><<<grid, block, 0, st>>>(
        c, Tp, chunk, mk, H, W, y0, es, zs, mp, cp, groups, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = Tp * kCols;
  soft_raster_bwd_sum_kernel<<<(n + 31) / 32, dim3(32, kSumSlices), 0, st>>>(
      part, groups, n, static_cast<float*>(dc));
  return (int)cudaGetLastError();
}
