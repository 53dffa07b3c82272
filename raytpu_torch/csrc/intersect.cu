// Closest hit with shadow occlusion for Hopper (sm_90a): K4 and K6.
//
// K4, closest_hit_occluded_kernel, replaces
// raytpu/kernels/intersect_pallas.py::_fused_kernel (launched by
// _fused_raw through closest_hit_occluded): per ray, the primary closest hit
// over C <= 128 triangles (the last index wins ties, `raytracer.cpp:243`),
// then the any-hit shadow test from ONE light toward the hit position
// (t < 0.99, `raytracer.cpp:310-315`).
//
// K6, closest_hit_occluded_multi_kernel, replaces
// intersect_pallas.py::_fused_multi_kernel (launched by _fused_multi_raw
// through closest_hit_occluded_multi): the same primary sweep, then one
// any-hit sweep for each of S shadow sources (lights, or the jittered
// soft-shadow positions of each light, light-major and sample-minor).
//
// Outputs: t (F32MAX on a miss), idx (-1 on a miss) and occ, int32, 1 where
// the source is blocked. occ is 0 on a miss ray and its shadow sweeps are
// skipped: K6's JAX wrapper masks misses the same way
// (intersect_occluded_multi_pallas); K4's returns the raw bit, which no
// consumer reads (composite zeroes misses, the AA record takes hits only).
//
// Layout. The constants arrive as one float32 table of (1 + S) blocks of 10
// rows by C columns, row-major (kernels/tables.py::_constant_rows): block 0
// holds the camera-origin constants, block 1 + s those of source s. The TPU
// kernels' chunk-blocked (4C, 3) arrays, their phase grid and their VMEM
// scratch carried between grid steps are gone: one thread takes one ray
// through every phase in registers.
//
// Design. One thread per ray, 256 a block. K4 copies both blocks (at most
// 10 KB) into shared memory; every thread reads the same entry at the same
// time, a broadcast without bank conflicts. K6 copies the primary block
// into shared memory, but its source blocks (S x 10 x C floats: 42 KB at
// S = 32, C = 32, and 2.6 MB for a 32-slot bank with 16 samples at C = 128)
// do not fit. They are read from device memory through the read-only
// cache (the table pointer is const __restrict__), and all threads of a
// warp that still sweep read the same address, one transaction a load.
// Staging one source at a time in shared memory was the other choice; it
// needs two block-wide barriers a source, which make every warp wait for
// the block's slowest ray, while here a warp whose rays all missed or
// were blocked early moves on to the next source at once. One source's
// block is 1.3-5 KB and stays in L1 while the warps of an SM sweep it.
//
// Bound on the H100 (512^2 rays, C = 32). Memory: 12 B in and 8 + 4 S B
// out a ray. Arithmetic: C plane tests a ray in the primary sweep and up to
// S x C for the shadow sweeps of a hit ray, each an IEEE divide and ~20
// float operations. K6 at S = 32 does up to 5.5 GFLOP a launch, ~0.08 ms at
// the 67 TFLOP/s float32 peak against ~0.012 ms for its 39 MB: bound by
// operations.
//
// Rounding. Built with -fmad=false and IEEE division, each expression in
// the JAX kernel's order (the shadow direction is (cam + tz * d) - source),
// so t, idx and occ equal the plain PyTorch versions
// (kernels/intersect.py::closest_hit_occluded{,_multi}_reference) on the
// card bit for bit.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

#include "plane_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 128;
constexpr int kBlockRows = 10;  // n xyz | c2 xyz | c3 xyz | k0
constexpr float kShadowT = 0x1.fae148p-1f;  // float32(0.99)

// Primary closest hit over the block at `blk`; `<=` lets the last of equal
// t win. Returns the winner (-1 if none) and its t (FLT_MAX if none).
__device__ __forceinline__ int closest(const float* blk, int C, float dx,
                                       float dy, float dz, float* best_t) {
  float bt = FLT_MAX;
  int bi = -1;
  for (int i = 0; i < C; ++i) {
    const PlaneHit p = plane_test(blk, C, i, dx, dy, dz);
    const float tm = p.ok ? p.t : FLT_MAX;
    if (tm <= bt) {
      bt = tm;
      bi = i;
    }
  }
  *best_t = bt;
  return bi;
}

// Any hit at t < 0.99 against the block at `blk`, stopping at the first
// blocker.
__device__ __forceinline__ bool blocked(const float* blk, int C, float ex,
                                        float ey, float ez) {
  for (int i = 0; i < C; ++i) {
    const PlaneHit p = plane_test(blk, C, i, ex, ey, ez);
    if (p.ok && p.t < kShadowT) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
    closest_hit_occluded_kernel(const float* __restrict__ dirs,
                                const float* __restrict__ table,
                                const float* __restrict__ cam,
                                const float* __restrict__ light, int C, int R,
                                float* __restrict__ t_out,
                                int* __restrict__ idx_out,
                                int* __restrict__ occ_out) {
  __shared__ float s_tab[2 * kBlockRows * kMaxTris];
  __shared__ float s_org[6];
  for (int k = threadIdx.x; k < 2 * kBlockRows * C; k += kThreads)
    s_tab[k] = table[k];
  if (threadIdx.x < 3) s_org[threadIdx.x] = cam[threadIdx.x];
  else if (threadIdx.x < 6) s_org[threadIdx.x] = light[threadIdx.x - 3];
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  float best_t;
  const int best_i = closest(s_tab, C, dx, dy, dz, &best_t);
  const bool hit = best_t < FLT_MAX;
  bool occ = false;
  if (hit) {
    // Shadow ray from the light toward pos = cam + t * d, unnormalized:
    // its parameter is the fraction of the light distance.
    const float tz = best_t;
    occ = blocked(s_tab + kBlockRows * C, C, (s_org[0] + tz * dx) - s_org[3],
                  (s_org[1] + tz * dy) - s_org[4],
                  (s_org[2] + tz * dz) - s_org[5]);
  }
  t_out[r] = best_t;
  idx_out[r] = hit ? best_i : -1;
  occ_out[r] = occ ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    closest_hit_occluded_multi_kernel(const float* __restrict__ dirs,
                                      const float* __restrict__ table,
                                      const float* __restrict__ cam,
                                      const float* __restrict__ src, int C,
                                      int S, int R, float* __restrict__ t_out,
                                      int* __restrict__ idx_out,
                                      int* __restrict__ occ_out) {
  __shared__ float s_tab[kBlockRows * kMaxTris];
  __shared__ float s_cam[3];
  for (int k = threadIdx.x; k < kBlockRows * C; k += kThreads)
    s_tab[k] = table[k];
  if (threadIdx.x < 3) s_cam[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  float best_t;
  const int best_i = closest(s_tab, C, dx, dy, dz, &best_t);
  const bool hit = best_t < FLT_MAX;
  t_out[r] = best_t;
  idx_out[r] = hit ? best_i : -1;

  const float tz = hit ? best_t : 0.0f;
  const float px = s_cam[0] + tz * dx;
  const float py = s_cam[1] + tz * dy;
  const float pz = s_cam[2] + tz * dz;
  for (int s = 0; s < S; ++s) {
    bool occ = false;
    if (hit) {
      const float* blk =
          table + static_cast<size_t>(1 + s) * kBlockRows * C;
      occ = blocked(blk, C, px - src[3 * s], py - src[3 * s + 1],
                    pz - src[3 * s + 2]);
    }
    occ_out[static_cast<size_t>(s) * R + r] = occ ? 1 : 0;
  }
}

}  // namespace

// dirs (R, 3), table (20, C), cam (3,), light (3,) float32 device pointers;
// t (R,) float32, idx (R,) int32 and occ (R,) int32 outputs. Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_closest_hit_occluded(const void* dirs, const void* table,
                                           const void* cam, const void* light,
                                           int C, int R, void* t, void* idx,
                                           void* occ, void* stream) {
  if (C < 1 || C > kMaxTris || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int blocks = (R + kThreads - 1) / kThreads;
  closest_hit_occluded_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table),
      static_cast<const float*>(cam), static_cast<const float*>(light), C, R,
      static_cast<float*>(t), static_cast<int*>(idx), static_cast<int*>(occ));
  return (int)cudaGetLastError();
}

// dirs (R, 3), table ((1 + S) * 10, C), cam (3,), src (S, 3) float32 device
// pointers; t (R,) float32, idx (R,) int32 and occ (S, R) int32 outputs.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_closest_hit_occluded_multi(
    const void* dirs, const void* table, const void* cam, const void* src,
    int C, int S, int R, void* t, void* idx, void* occ, void* stream) {
  if (C < 1 || C > kMaxTris || S < 1 || R < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int blocks = (R + kThreads - 1) / kThreads;
  closest_hit_occluded_multi_kernel<<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table),
      static_cast<const float*>(cam), static_cast<const float*>(src), C, S, R,
      static_cast<float*>(t), static_cast<int*>(idx), static_cast<int*>(occ));
  return (int)cudaGetLastError();
}
