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
// Design. One thread per ray, 256 threads a block, a warp a block of
// wh x (32 / wh) rays of the H x W image (sweep_cull.cuh::sweep_ray; H = 1,
// W = R, wh = 1: 32 consecutive rays). Each block stages the primary and
// shadow blocks of the (26, C) triangle table of kernels/tables.py
// triangle-major (40 bytes a triangle, 10 KB at C = 128), the normal and
// albedo rows as they are (for the winner's gather) and the 10 parameters
// in shared memory. The two sweeps are K4's (sweep_cull.cuh): a warp culls
// exactly the triangles no ray of its box of directions can hit, its lanes
// test the survivors in order with the division-free reject first and the
// IEEE reciprocal only where the reject leaves a test open; the shadow
// sweep does the same on the warp's shadow rays, stopping a lane at its
// first blocker and the warp once no lane sweeps. Culled and rejected tests
// are ones the brute sweep finds not ok (not blocking), so idx, occ and
// the shading are the brute sweep's bits. The TPU kernel's (8, tile/8)
// re-blocking, its scalar-prefetch tables and its select-chain gather
// existed for the TPU's vector layout and are gone: the winner's normal and
// albedo are read by index, which gives the same value as the select chain
// (one row matches).
//
// Bound on the H100. Memory: 12 B in (dirs) and 24 B out (color, fd, idx,
// occ) a ray, 9.4 MB for a 512^2 frame, about 2.8 us at 3.35 TB/s.
// Arithmetic (chip_smoke.py::sweep_cull_work): the cull's (warp, triangle)
// decisions, the reject on each ray's survivors, a plane test where it
// leaves one open, and ~50 operations of a hit ray's shading.
//
// Rounding. Built with -fmad=false and IEEE division and sqrt, and each
// expression keeps the JAX kernel's operation order, so the outputs equal
// the plain PyTorch version (fused_fwd_reference) on the card bit for bit.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

#include "plane_test.cuh"
#include "sweep_cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 128;
constexpr int kRows = 26;
constexpr int kPrimary = 0, kShadow = 10, kNormal = 20, kAlbedo = 23;
constexpr int kParams = 10;
constexpr float kFourPi = 0x1.921fb6p+3f;  // float32(4 * pi)

__global__ void __launch_bounds__(kThreads)
    render_fused_fwd_kernel(const float* __restrict__ dirs,
                            const float* __restrict__ table,
                            const float* __restrict__ params, int C, int H,
                            int W, int wh, float ambient, int parity,
                            float* __restrict__ color, float* __restrict__ fd,
                            int* __restrict__ idx, int* __restrict__ occ) {
  static_assert(kThreads >= 2 * kSweepMaxTris && kMaxTris == kSweepMaxTris,
                "a thread stages each triangle of both blocks");
  __shared__ TriBlock s_pri, s_shw;
  __shared__ float s_na[(kRows - kNormal) * kMaxTris];
  __shared__ float s_par[kParams];
  const int k = threadIdx.x;
  if (k < C) stage_tri(s_pri, table + kPrimary * C, C, k);
  if (k >= kMaxTris && k - kMaxTris < C)
    stage_tri(s_shw, table + kShadow * C, C, k - kMaxTris);
  for (int j = k; j < (kRows - kNormal) * C; j += kThreads)
    s_na[j] = table[kNormal * C + j];
  if (k < kParams) s_par[k] = params[k];
  __syncthreads();

  const SweepRay ray = sweep_ray(H, W, wh);
  const int r = ray.r;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray.valid) {
    dx = dirs[3 * r];
    dy = dirs[3 * r + 1];
    dz = dirs[3 * r + 2];
  }

  // Primary closest hit; `<=` lets the last of equal t win.
  int best_i;
  const float best_t = warp_closest(s_pri, C, ray.valid, dx, dy, dz, &best_i);
  const bool hit = best_t < FLT_MAX;
  const float tz = hit ? best_t : 0.0f;

  // Shadow ray from the light toward pos = cam + t * d, unnormalized: its
  // parameter is the fraction of the light distance. Misses trace from the
  // camera position, as the TPU kernel does.
  const float ex = (s_par[0] + tz * dx) - s_par[3];
  const float ey = (s_par[1] + tz * dy) - s_par[4];
  const float ez = (s_par[2] + tz * dz) - s_par[5];
  const bool blocked = warp_blocked(s_shw, C, ray.valid, ex, ey, ez);
  if (!ray.valid) return;
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
  float lam = ((-ex / rr) * s_na[0 * C + best_i] +
               (-ey / rr) * s_na[1 * C + best_i]) +
              (-ez / rr) * s_na[2 * C + best_i];
  lam = lam != lam ? lam : fmaxf(lam, 0.0f);  // clamp_min keeps NaN
  for (int j = 0; j < 3; ++j) {
    const float alb = s_na[(kAlbedo - kNormal + j) * C + best_i];
    float d = lit ? (s_par[6 + j] / area) * lam : 0.0f;
    if (blocked) d = 0.0f;
    color[3 * r + j] = parity ? alb * (d * alb + ambient) : alb * (d + ambient);
  }
  const float dn = sqrtf((dx * dx + dy * dy) + dz * dz);
  fd[r] = tz * dn - s_par[9];
}

}  // namespace

// dirs (R, 3), table (26, C), params (10,) float32 device pointers, the
// rays a row-major H x W grid (R = H W) swept in warps of wh x (32 / wh)
// rays (H = 1, W = R, wh = 1: 32 consecutive rays); color (R, 3), fd (R,),
// idx (R,) int32, occ (R,) int32 outputs. Launches on `stream` and returns
// the launch's cudaError_t.
extern "C" int raytpu_render_fused_fwd(const void* dirs, const void* table,
                                       const void* params, int C, int H,
                                       int W, int wh, float ambient,
                                       int parity, void* color, void* fd,
                                       void* idx, void* occ, void* stream) {
  const long long blocks = sweep_blocks(C, H, W, wh, kThreads);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  render_fused_fwd_kernel<<<static_cast<int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table),
      static_cast<const float*>(params), C, H, W, wh, ambient, parity,
      static_cast<float*>(color), static_cast<float*>(fd),
      static_cast<int*>(idx), static_cast<int*>(occ));
  return (int)cudaGetLastError();
}
