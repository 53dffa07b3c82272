// Backward of the fused hard-visibility render for Hopper (sm_90a).
//
// Replaces the two TPU kernels of raytpu/kernels/render_fused.py that
// _rhf_bwd launches: _bwd_kernel_blk8 (the per-ray recompute and VJP) and
// _scatter_kernel (the per-triangle scatter by winner index).
//
// What they compute. The forward saved each ray's winner index and
// occlusion bit; both are piecewise constant, so the backward
// differentiates only what follows from the winner: t = k0_i / -(d . n_i),
// the hit position, the inverse-square Lambert term, the composite and the
// focal distance t |d| - dof. Per hit ray, render_fused_bwd_kernel gives
// the cotangents of the ray direction, of the 10 values gathered from the
// winner's table column (n xyz, k0, normal xyz, albedo xyz) and of the 10
// parameters (cam, light, p_eff, dof). render_fused_scatter_kernel sums
// the gathered values' cotangents per triangle and the parameters'
// cotangents over all rays.
//
// Design. The per-ray kernel runs one thread per ray, 256 a block, as the
// forward does, and writes the derivative out by hand, term by term
// backwards through the forward (render_fused.cu). Each thread leaves its
// 20 cotangents and its winner in shared memory. Then each thread of the
// block owns some of the block's 10 C + 10 sums and adds its column over
// the block's 256 rays in ray order (a triangle's column takes only the
// rays that triangle won). The block writes its sums as one row of a
// (blocks, 10 C + 10) array of partials, and the second kernel adds the
// rows over blocks, in a fixed order, into the (26, C) table gradient
// (zero outside the gathered rows) and the (10,) parameter gradient. The
// TPU kernels carried the sum from one grid step to the next in a VMEM
// block; blocks on Hopper run in parallel and in no order, hence the two
// passes. No floating-point atomics anywhere, so two calls on the same
// inputs give bit-identical gradients.
//
// Bound on the H100 at 512^2 (R = 262,144, C = 32): the per-ray kernel
// reads 36 B a ray (dirs, idx, occ, g_color, g_fd) and writes 12 B
// (g_dirs); the partials, 1,024 x 330 floats (1.35 MB), are written once
// and read once; about 15.3 MB in all, 4.6 us at 3.35 TB/s. The arithmetic
// is ~150 float operations a hit ray, under a microsecond at 67 TFLOP/s.
// The column sums cost (10 C + 10) x 256 shared-memory reads a block, more
// than the per-ray work at C = 32; a segmented warp reduction is later
// work.
//
// Rounding. Built with -fmad=false and IEEE division and sqrt, like the
// forward: the recomputed t equals the forward's winner t bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 128;
constexpr int kParams = 10;
constexpr int kGathered = 10;
constexpr int kCots = kGathered + kParams;
// Row stride of the per-ray cotangents in shared memory: one more than the
// block so that column i of rows k and k + 1 fall in different banks.
constexpr int kStride = kThreads + 1;
constexpr float kFourPi = 0x1.921fb6p+3f;  // float32(4 * pi)
// The scatter kernel's block: 32 columns by kSlices slices of the blocks.
constexpr int kSlices = 32;

// Table row of gathered value k: n xyz (0..2), k0 (9), normal xyz
// (20..22), albedo xyz (23..25); kernels/tables.py GATHERED.
__device__ __forceinline__ int gathered_row(int k) {
  return k < 3 ? k : (k == 3 ? 9 : k + 16);
}

// The inverse: which gathered value table row `row` holds, or -1.
__device__ __forceinline__ int gathered_of_row(int row) {
  if (row < 3) return row;
  if (row == 9) return 3;
  return row >= 20 ? row - 16 : -1;
}

__global__ void __launch_bounds__(kThreads)
    render_fused_bwd_kernel(const float* __restrict__ dirs,
                            const float* __restrict__ table,
                            const float* __restrict__ params,
                            const int* __restrict__ idx,
                            const int* __restrict__ occ,
                            const float* __restrict__ g_color,
                            const float* __restrict__ g_fd, int C, int R,
                            float ambient, int parity,
                            float* __restrict__ g_dirs,
                            float* __restrict__ partials) {
  __shared__ float s_tab[kGathered * kMaxTris];
  __shared__ float s_par[kParams];
  __shared__ float s_cot[kCots * kStride];
  __shared__ int s_win[kThreads];
  for (int k = threadIdx.x; k < kGathered * C; k += kThreads) {
    s_tab[k] = table[gathered_row(k / C) * C + k % C];
  }
  if (threadIdx.x < kParams) s_par[threadIdx.x] = params[threadIdx.x];
  __syncthreads();

  // cot: gathered values [n xyz, k0, normal xyz, albedo xyz], then the
  // parameters [cam xyz, light xyz, p_eff xyz, dof].
  float cot[kCots];
#pragma unroll
  for (int k = 0; k < kCots; ++k) cot[k] = 0.0f;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int win = r < R ? idx[r] : -1;
  if (r < R) {
    const float d[3] = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
    float gd[3] = {0.0f, 0.0f, 0.0f};
    if (win >= 0) {
      float n[3], nrm[3], alb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        n[j] = s_tab[j * C + win];
        nrm[j] = s_tab[(4 + j) * C + win];
        alb[j] = s_tab[(7 + j) * C + win];
      }
      const float k0 = s_tab[3 * C + win];

      // The forward again, in its operation order.
      const float denom = -((d[0] * n[0] + d[1] * n[1]) + d[2] * n[2]);
      const bool nonpar = denom != 0.0f;
      const float rec = 1.0f / (nonpar ? denom : 1.0f);
      const float t = k0 * rec;
      float delta[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        delta[j] = (s_par[j] + t * d[j]) - s_par[3 + j];
      }
      const float r2 =
          (delta[0] * delta[0] + delta[1] * delta[1]) + delta[2] * delta[2];
      const bool lit = r2 > 0.0f;
      const float rr = sqrtf(lit ? r2 : 1.0f);
      const float area = kFourPi * (rr * rr);
      float rdir[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) rdir[j] = -delta[j] / rr;
      const float lam_raw =
          (rdir[0] * nrm[0] + rdir[1] * nrm[1]) + rdir[2] * nrm[2];
      const float lam = fmaxf(lam_raw, 0.0f);
      const bool shaded = lit && occ[r] == 0;
      const float dn = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);

      // Composite: color_j = alb_j (D_j + amb), or alb_j (D_j alb_j + amb)
      // in parity. D_j = (p_j / area) lam where the point is shaded, else 0.
      float q[3], g_dd[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        q[j] = s_par[6 + j] / area;
        const float dj = shaded ? q[j] * lam : 0.0f;
        const float gc = g_color[3 * r + j];
        if (parity) {
          const float ga = gc * alb[j];
          cot[7 + j] = gc * (dj * alb[j] + ambient) + ga * dj;
          g_dd[j] = ga * alb[j];
        } else {
          cot[7 + j] = gc * (dj + ambient);
          g_dd[j] = gc * alb[j];
        }
      }

      float g_delta[3] = {0.0f, 0.0f, 0.0f};
      if (shaded) {
        float g_lam = 0.0f, g_area = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float g_q = g_dd[j] * lam;
          g_lam += g_dd[j] * q[j];
          cot[kGathered + 6 + j] = g_q / area;
          g_area -= g_q * s_par[6 + j] / (area * area);
        }
        // max(x, 0) passes half the gradient at x == 0, as jnp.maximum.
        const float g_raw = lam_raw > 0.0f    ? g_lam
                            : lam_raw == 0.0f ? 0.5f * g_lam
                                              : 0.0f;
        // lam_raw = rdir . nrm, rdir = -delta / rr, area = 4 pi rr^2,
        // rr = sqrt(r2), r2 = delta . delta.
        float g_rr = g_area * (kFourPi * (2.0f * rr));
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float g_rdir = g_raw * nrm[j];
          cot[4 + j] = g_raw * rdir[j];
          g_delta[j] = -g_rdir / rr;
          g_rr += g_rdir * delta[j] / (rr * rr);
        }
        if (lit) {
          const float g_r2 = g_rr / (2.0f * rr);
#pragma unroll
          for (int j = 0; j < 3; ++j) g_delta[j] += 2.0f * delta[j] * g_r2;
        }
      }

      // delta_j = (cam_j + t d_j) - light_j.
      float g_t = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cot[kGathered + j] = g_delta[j];
        cot[kGathered + 3 + j] = -g_delta[j];
        g_t += g_delta[j] * d[j];
        gd[j] = g_delta[j] * t;
      }
      // fd = t |d| - dof, |d| = sqrt(d . d).
      const float gf = g_fd[r];
      g_t += gf * dn;
      cot[kGathered + 9] = -gf;
      const float g_dn = gf * t;
#pragma unroll
      for (int j = 0; j < 3; ++j) gd[j] += g_dn * d[j] / dn;
      // t = k0 * (1 / safe), safe = denom where nonzero, denom = -(d . n).
      cot[3] = g_t * rec;
      const float g_denom = nonpar ? -(g_t * k0) * (rec * rec) : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gd[j] -= g_denom * n[j];
        cot[j] = -g_denom * d[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) g_dirs[3 * r + j] = gd[j];
  }
  s_win[threadIdx.x] = win;
#pragma unroll
  for (int k = 0; k < kCots; ++k) s_cot[k * kStride + threadIdx.x] = cot[k];
  __syncthreads();

  // The block's sums, each over its rays in ray order.
  const int cols = kGathered * C + kParams;
  float* row = partials + static_cast<size_t>(blockIdx.x) * cols;
  for (int col = threadIdx.x; col < cols; col += kThreads) {
    float acc = 0.0f;
    if (col < kGathered * C) {
      const int k = col / C, tri = col - k * C;
      const float* c = s_cot + k * kStride;
      for (int i = 0; i < kThreads; ++i) {
        if (s_win[i] == tri) acc += c[i];
      }
    } else {
      const float* c = s_cot + (kGathered + col - kGathered * C) * kStride;
      for (int i = 0; i < kThreads; ++i) acc += c[i];
    }
    row[col] = acc;
  }
}

// Output o < 26 C is table entry (o / C, o % C); o >= 26 C is parameter
// o - 26 C. Thread (x, y) of a block adds column x's partials of blocks
// y, y + kSlices, ...; thread (x, 0) then adds the kSlices sums in order.
__global__ void __launch_bounds__(32 * kSlices)
    render_fused_scatter_kernel(const float* __restrict__ partials,
                                int blocks, int C,
                                float* __restrict__ g_table,
                                float* __restrict__ g_params) {
  __shared__ float s_sum[kSlices][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  const int outputs = 26 * C + kParams;
  const int cols = kGathered * C + kParams;
  int col = -1;  // the partials' column that output o sums, if any
  if (o < 26 * C) {
    const int k = gathered_of_row(o / C);
    if (k >= 0) col = k * C + o % C;
  } else if (o < outputs) {
    col = kGathered * C + (o - 26 * C);
  }
  float acc = 0.0f;
  if (col >= 0) {
#pragma unroll 4
    for (int b = threadIdx.y; b < blocks; b += kSlices) {
      acc += partials[static_cast<size_t>(b) * cols + col];
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || o >= outputs) return;
  float total = 0.0f;
  for (int s = 0; s < kSlices; ++s) total += s_sum[s][threadIdx.x];
  if (o < 26 * C) {
    g_table[o] = total;
  } else {
    g_params[o - 26 * C] = total;
  }
}

}  // namespace

// The per-ray backward. dirs (R, 3), table (26, C), params (10,), g_color
// (R, 3), g_fd (R,) float32 and idx, occ (R,) int32 device pointers, as the
// forward gave them; g_dirs (R, 3) and partials (blocks, 10 C + 10) float32
// outputs, blocks = ceil(R / 256). Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int raytpu_render_fused_bwd(const void* dirs, const void* table,
                                       const void* params, const void* idx,
                                       const void* occ, const void* g_color,
                                       const void* g_fd, int C, int R,
                                       float ambient, int parity,
                                       void* g_dirs, void* partials,
                                       int blocks, void* stream) {
  if (C < 1 || C > kMaxTris || R < 0 ||
      blocks != (R + kThreads - 1) / kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  if (R == 0) return (int)cudaSuccess;
  render_fused_bwd_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table),
      static_cast<const float*>(params), static_cast<const int*>(idx),
      static_cast<const int*>(occ), static_cast<const float*>(g_color),
      static_cast<const float*>(g_fd), C, R, ambient, parity,
      static_cast<float*>(g_dirs), static_cast<float*>(partials));
  return (int)cudaGetLastError();
}

// The sums over blocks. partials (blocks, 10 C + 10) from
// raytpu_render_fused_bwd; g_table (26, C) and g_params (10,) float32
// outputs, every entry written. Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int raytpu_render_fused_scatter(const void* partials, int blocks,
                                           int C, void* g_table,
                                           void* g_params, void* stream) {
  if (C < 1 || C > kMaxTris || blocks < 0) return (int)cudaErrorInvalidValue;
  const int outputs = 26 * C + kParams;
  render_fused_scatter_kernel<<<(outputs + 31) / 32, dim3(32, kSlices), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), blocks, C,
      static_cast<float*>(g_table), static_cast<float*>(g_params));
  return (int)cudaGetLastError();
}
