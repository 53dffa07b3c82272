// Fused hard-visibility forward render for Hopper (sm_90a).
//
// Replaces raytpu/kernels/render_fused.py::_fwd_kernel_blk8, the TPU kernel
// that _fused_fwd_raw8 launches. Per ray, in one pass: the primary closest
// hit over C <= 128 triangles (the last index wins ties, `raytracer.cpp:243`),
// the hit position, the shadow any-hit from the light toward it (t < 0.99,
// `raytracer.cpp:310-315`), the winner's normal and albedo, inverse-square
// Lambert plus ambient (parity applies the albedo twice), the composite and
// the focal distance t * |d| - dof_focus.
//
// Design. One thread per ray, 256 threads a block, a grid of ceil(R / 256).
// Each block copies the (26, C) triangle table of kernels/tables.py (at most
// 13 KB) and the 10 parameters into shared memory. In both sweeps every
// thread reads the same table entry at the same time: a broadcast, with no
// bank conflict. The TPU kernel's (8, tile/8) re-blocking, its
// scalar-prefetch tables and its select-chain gather existed for the TPU's
// vector layout and are gone: the winner's normal and albedo are read by
// index, which gives the same value as the select chain (one row matches).
//
// Bound on the H100. Memory: 12 B in (dirs) and 24 B out (color, fd, idx,
// occ) a ray, 9.4 MB for a 512^2 frame, about 2.8 us at 3.35 TB/s.
// Arithmetic: 2C plane tests a ray, each an IEEE divide and ~20 float ops,
// about 0.7 GFLOP for 512^2 at C = 32, about 10 us at the 67 TFLOP/s float32
// peak. Either way a frame's kernel time is microseconds, so the launch and
// the torch ops around it, not the kernel, set the frame time at first.
//
// Rounding. Built with -fmad=false and IEEE division and sqrt, and each
// expression keeps the JAX kernel's operation order, so the outputs equal
// the plain PyTorch version (fused_fwd_reference) on the card bit for bit.

#include <cfloat>
#include <cuda_runtime.h>

#include "plane_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 128;
constexpr int kRows = 26;
constexpr int kPrimary = 0, kShadow = 10, kNormal = 20, kAlbedo = 23;
constexpr int kParams = 10;
constexpr float kFourPi = 0x1.921fb6p+3f;  // float32(4 * pi)
constexpr float kShadowT = 0x1.fae148p-1f;  // float32(0.99)

__global__ void __launch_bounds__(kThreads)
    render_fused_fwd_kernel(const float* __restrict__ dirs,
                            const float* __restrict__ table,
                            const float* __restrict__ params, int C, int R,
                            float ambient, int parity,
                            float* __restrict__ color, float* __restrict__ fd,
                            int* __restrict__ idx, int* __restrict__ occ) {
  __shared__ float s_tab[kRows * kMaxTris];
  __shared__ float s_par[kParams];
  for (int k = threadIdx.x; k < kRows * C; k += kThreads) s_tab[k] = table[k];
  if (threadIdx.x < kParams) s_par[threadIdx.x] = params[threadIdx.x];
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];

  // Primary closest hit; `<=` lets the last of equal t win.
  float best_t = FLT_MAX;
  int best_i = -1;
  for (int i = 0; i < C; ++i) {
    const PlaneHit p = plane_test(s_tab + kPrimary * C, C, i, dx, dy, dz);
    const float tm = p.ok ? p.t : FLT_MAX;
    if (tm <= best_t) {
      best_t = tm;
      best_i = i;
    }
  }
  const bool hit = best_t < FLT_MAX;
  const float tz = hit ? best_t : 0.0f;

  // Shadow ray from the light toward pos = cam + t * d, unnormalized: its
  // parameter is the fraction of the light distance. Misses trace from the
  // camera position, as the TPU kernel does.
  const float ex = (s_par[0] + tz * dx) - s_par[3];
  const float ey = (s_par[1] + tz * dy) - s_par[4];
  const float ez = (s_par[2] + tz * dz) - s_par[5];
  bool blocked = false;
  for (int i = 0; i < C && !blocked; ++i) {
    const PlaneHit p = plane_test(s_tab + kShadow * C, C, i, ex, ey, ez);
    blocked = p.ok && p.t < kShadowT;
  }
  idx[r] = hit ? best_i : -1;
  occ[r] = blocked ? 1 : 0;

  if (!hit) {
    color[3 * r] = 0.0f;
    color[3 * r + 1] = 0.0f;
    color[3 * r + 2] = 0.0f;
    fd[r] = 0.0f;
    return;
  }

  // _shade_rows of the JAX kernel, term for term.
  const float r2 = (ex * ex + ey * ey) + ez * ez;
  const bool lit = r2 > 0.0f;
  const float rr = sqrtf(lit ? r2 : 1.0f);
  const float area = kFourPi * (rr * rr);
  float lam = ((-ex / rr) * s_tab[(kNormal + 0) * C + best_i] +
               (-ey / rr) * s_tab[(kNormal + 1) * C + best_i]) +
              (-ez / rr) * s_tab[(kNormal + 2) * C + best_i];
  lam = lam != lam ? lam : fmaxf(lam, 0.0f);  // clamp_min keeps NaN
  for (int j = 0; j < 3; ++j) {
    const float alb = s_tab[(kAlbedo + j) * C + best_i];
    float d = lit ? (s_par[6 + j] / area) * lam : 0.0f;
    if (blocked) d = 0.0f;
    color[3 * r + j] = parity ? alb * (d * alb + ambient) : alb * (d + ambient);
  }
  const float dn = sqrtf((dx * dx + dy * dy) + dz * dz);
  fd[r] = tz * dn - s_par[9];
}

}  // namespace

// dirs (R, 3), table (26, C), params (10,) float32 device pointers; color
// (R, 3), fd (R,), idx (R,) int32, occ (R,) int32 outputs. Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_render_fused_fwd(const void* dirs, const void* table,
                                       const void* params, int C, int R,
                                       float ambient, int parity, void* color,
                                       void* fd, void* idx, void* occ,
                                       void* stream) {
  if (C < 1 || C > kMaxTris || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int blocks = (R + kThreads - 1) / kThreads;
  render_fused_fwd_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table),
      static_cast<const float*>(params), C, R, ambient, parity,
      static_cast<float*>(color), static_cast<float*>(fd),
      static_cast<int*>(idx), static_cast<int*>(occ));
  return (int)cudaGetLastError();
}
