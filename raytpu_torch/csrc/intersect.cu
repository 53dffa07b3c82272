// Closest hit, with and without shadow occlusion, for Hopper (sm_90a): K4,
// K6, and over several chunks K5, K7d and K7a; and the occlusion of known
// points, K7b and K7c.
//
// K4, closest_hit_occluded_kernel<false>, replaces
// raytpu/kernels/intersect_pallas.py::_fused_kernel (launched by
// _fused_raw through closest_hit_occluded): per ray, the primary closest hit
// over C <= 128 triangles (the last index wins ties, `raytracer.cpp:243`),
// then the any-hit shadow test from ONE light toward the hit position
// (t < 0.99, `raytracer.cpp:310-315`). L2, closest_hit_occluded_kernel<true>,
// replaces bench/megakernel_lab2.py::onestep_kernel (launched at :88 by
// run_onestep), K4's function in one TPU grid step a ray tile: on Hopper K4
// already takes a ray through both phases in one thread, so L2 is K4 with
// the rays read planar (dirs_t (3, R)), and equals it on every ray.
//
// K6, closest_hit_occluded_multi_kernel, replaces
// intersect_pallas.py::_fused_multi_kernel (launched by _fused_multi_raw
// through closest_hit_occluded_multi): the same primary sweep, then one
// any-hit sweep for each of S shadow sources (lights, or the jittered
// soft-shadow positions of each light, light-major and sample-minor).
//
// Outputs: t (F32MAX on a miss), idx (-1 on a miss) and occ, int32, 1 where
// the source is blocked. K6 defines occ as 0 on a miss ray and skips its
// shadow sweeps, as its JAX wrapper masks misses
// (intersect_occluded_multi_pallas). K4 sweeps every ray, a miss with
// tz = 0, so a miss's shadow ray runs from the light to the camera and its
// bit is the raw one that JAX's _fused_kernel writes and
// intersect_occluded_pallas returns unmasked; no consumer reads it
// (composite zeroes misses, the AA record takes hits only).
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
// S x C for the shadow sweeps of a hit ray (K4: of every ray), each an IEEE
// divide and ~20
// float operations. K6 at S = 32 does up to 5.5 GFLOP a launch, ~0.08 ms at
// the 67 TFLOP/s float32 peak against ~0.012 ms for its 39 MB: bound by
// operations.
//
// K5 and K7d, closest_hit_kernel<false> and <true>, replace
// intersect_pallas.py::_kernel (launched by _closest_hit_raw through
// closest_hit, the brute sweep of intersect_pallas) and ::_kernel_masked
// (launched by _closest_hit_masked_raw through closest_hit_masked, the
// culled sweep of intersect_pallas_culled): the primary closest hit over
// any number of chunks of C <= 128 triangles, the masked instance skipping
// the chunks a (ray tile, chunk) keep-mask rules out. K7a,
// raytpu_closest_hit_occluded_masked, replaces ::_fused_multi_kernel_masked
// (launched by _fused_multi_masked_raw through the scene_geom branch of
// intersect_occluded_multi_pallas, which every sub-ray of raytrace_full
// takes on a scene of more than 128 triangles): the masked primary sweep
// (closest_hit_kernel<true> on the mask's primary columns), then for each
// of S sources the any-hit sweep over the chunks that source's mask
// columns keep (occlusion_masked_kernel), two kernels in one launch.
//
// Rounding. Built with -fmad=false and IEEE division, each expression in
// the JAX kernel's order (the shadow direction is (cam + tz * d) - source),
// so t, idx and occ equal the plain PyTorch versions
// (kernels/intersect.py::closest_hit_occluded{,_multi}_reference,
// closest_reference, closest_masked_reference, occluded_masked_reference)
// on the card bit for bit.
//
// Several chunks (K5, K7d, K7a). The TPU kernels' (ray tile, chunk) grid,
// whose VMEM scratch carries the running best from one grid step to the
// next, becomes a loop inside the block: one thread a ray, one block of 256
// rays a ray tile (16 x 16 pixels of an image, or 256 consecutive rays of a
// list: the port's tiles, kernels/intersect.py::ray_tiles), and for each
// chunk in order the block reads the tile's keep bit (block-uniform) and,
// for a kept chunk, stages the chunk's 10 x C constants (5 KB) in shared
// memory and runs the closest-hit update on them. The running best stays
// in registers; `<=` over the triangles in order makes the last index win
// ties, within a chunk and across chunks, as the JAX kernels' chunk min
// with `upd = chunk_min <= best_t` does. A culled chunk holds no hit for
// any ray of its tile (the mask is conservative), so t and idx equal the
// brute sweep's. K7a's shadow phase then runs one block for each (tile,
// source) pair: it forms pos = cam + tz * d from the primary kernel's t and
// sweeps the source's kept chunks, a ray stopping at its first blocker and
// the block leaving the remaining chunks once no ray of it still sweeps
// (__syncthreads_or). One block a tile for all S sources would leave the
// card nearly idle: on an STL frame only the few tiles that see the model
// have hits, and each would run S sweeps in turn. Threads of a tile past
// the image's edge take part in the staging and the barriers and write
// nothing.
//
// K7b and K7c, occlusion_points_kernel<false> and <true>, replace
// intersect_pallas.py::_occlusion_multi_kernel (launched at :1078 by
// occlusion_multi_pallas) and ::_occlusion_multi_kernel_masked (launched at
// :1063 for a block of several chunks given its vertices): the any-hit
// shadow test (t < 0.99) of S sources toward KNOWN points, with no primary
// phase. The sharded renderer merges the primary closest hit across the
// triangle shards before any shadow ray exists, so each shard runs these on
// the merged hit positions against its own triangle block
// (raytpu_torch/parallel/render.py::_merged_occlusion_rows). Block (tile,
// s), one thread a point: the ray is pos - src[s], swept over source s's
// chunks (K7c: the chunks its (tile, s) mask columns keep, skipped
// block-uniformly) as occlusion_masked_kernel sweeps, a point stopping at
// its first blocker and the block leaving once none of its points still
// sweeps. Unlike K7a every point is tested, a miss's camera-origin point
// included, as the JAX kernels test every point; the masks of
// kernels/cull.py::position_shadow_mask are conservative for every point,
// so K7c's bits equal K7b's. Bound: 20 float operations a plane test to the
// first blocker against 12 B in and 4 S B out a point: operations.
//
// Bound of K5 at 512^2 x 9,216 triangles: 2.42 G plane tests of ~20 float
// operations, 0.72 ms at 67 TFLOP/s against 12 + 8 B a ray and 0.37 MB of
// table: bound by operations. The culled kernels do the kept (tile, chunk)
// pairs' share of that. What the design does about it: the constants are
// read from shared memory as broadcasts, two barriers a kept chunk, no
// atomics, and a kept chunk costs one global read of 5 KB a block.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

#include "plane_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 128;
constexpr int kBlockRows = 10;  // n xyz | c2 xyz | c3 xyz | k0
constexpr float kShadowT = 0x1.fae148p-1f;  // float32(0.99)

// The ray of this thread in the masked kernels' tiles: block b is tile b,
// row-major over tiles of th x (256 / th) rays of an H x W grid.
struct TileRay {
  int r;
  bool valid;
};

__device__ __forceinline__ TileRay tile_ray(int H, int W, int th) {
  const int tw = kThreads / th;
  const int tiles_x = (W + tw - 1) / tw;
  const int y = (blockIdx.x / tiles_x) * th + threadIdx.x / tw;
  const int x = (blockIdx.x % tiles_x) * tw + threadIdx.x % tw;
  const bool valid = y < H && x < W;
  return {valid ? y * W + x : 0, valid};
}

// Copy chunk c of the 10-row constant block at `blk` (row stride Tp) into
// shared memory as a 10 x C block.
__device__ __forceinline__ void stage(float* s_blk,
                                      const float* __restrict__ blk, int Tp,
                                      int C, int c) {
  for (int k = threadIdx.x; k < kBlockRows * C; k += kThreads) {
    const int row = k / C;
    s_blk[k] = blk[static_cast<size_t>(row) * Tp +
                   static_cast<size_t>(c) * C + (k - row * C)];
  }
}

// The primary sweep over the chunks of the block at `table`: for each
// chunk the tile keeps (keep == nullptr: every chunk), the running
// closest hit with `<=`. Every thread of the block calls it (barriers).
__device__ __forceinline__ void sweep_chunks(const float* __restrict__ table,
                                             int Tp, int C,
                                             const int* __restrict__ keep,
                                             float* s_blk, bool valid,
                                             float dx, float dy, float dz,
                                             float* best_t, int* best_i) {
  float bt = FLT_MAX;
  int bi = -1;
  const int n_chunks = Tp / C;
  for (int c = 0; c < n_chunks; ++c) {
    if (keep != nullptr && keep[c] == 0) continue;  // block-uniform
    __syncthreads();  // the previous chunk is read
    stage(s_blk, table, Tp, C, c);
    __syncthreads();
    if (!valid) continue;
    for (int i = 0; i < C; ++i) {
      const PlaneHit p = plane_test(s_blk, C, i, dx, dy, dz);
      const float tm = p.ok ? p.t : FLT_MAX;
      if (tm <= bt) {
        bt = tm;
        bi = c * C + i;
      }
    }
  }
  *best_t = bt;
  *best_i = bi;
}

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

// K4 reads the rays as (R, 3) rows; L2 (Planar, lab 2's one-step kernel)
// as the (3, R) planes of bench/megakernel_lab2.py's dirs_t.
template <bool Planar>
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
  const float dx = Planar ? dirs[r] : dirs[3 * r];
  const float dy = Planar ? dirs[R + r] : dirs[3 * r + 1];
  const float dz = Planar ? dirs[2 * R + r] : dirs[3 * r + 2];
  float best_t;
  const int best_i = closest(s_tab, C, dx, dy, dz, &best_t);
  const bool hit = best_t < FLT_MAX;
  // Shadow ray from the light toward pos = cam + tz * d, unnormalized: its
  // parameter is the fraction of the light distance. A miss sweeps too,
  // with tz = 0 (the raw bit of JAX's K4).
  const float tz = hit ? best_t : 0.0f;
  const bool occ =
      blocked(s_tab + kBlockRows * C, C, (s_org[0] + tz * dx) - s_org[3],
              (s_org[1] + tz * dy) - s_org[4], (s_org[2] + tz * dz) - s_org[5]);
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

template <bool Masked>
__global__ void __launch_bounds__(kThreads)
    closest_hit_kernel(const float* __restrict__ dirs,
                       const float* __restrict__ table, int Tp, int C,
                       const int* __restrict__ mask, int mask_stride, int H,
                       int W, int th, float* __restrict__ t_out,
                       int* __restrict__ idx_out) {
  __shared__ float s_blk[kBlockRows * kMaxTris];
  const TileRay ray = tile_ray(H, W, th);
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray.valid) {
    dx = dirs[3 * ray.r];
    dy = dirs[3 * ray.r + 1];
    dz = dirs[3 * ray.r + 2];
  }
  const int* keep =
      Masked ? mask + static_cast<size_t>(blockIdx.x) * mask_stride : nullptr;
  float best_t;
  int best_i;
  sweep_chunks(table, Tp, C, keep, s_blk, ray.valid, dx, dy, dz, &best_t,
               &best_i);
  if (!ray.valid) return;
  t_out[ray.r] = best_t;
  idx_out[ray.r] = best_t < FLT_MAX ? best_i : -1;
}

// K7a's shadow phase: block (tile, s) sweeps source s's kept chunks for
// the tile's hit rays, from the primary hits t of the same launch.
__global__ void __launch_bounds__(kThreads)
    occlusion_masked_kernel(const float* __restrict__ dirs,
                            const float* __restrict__ table, int Tp, int C,
                            const float* __restrict__ cam,
                            const float* __restrict__ src, int S,
                            const int* __restrict__ mask, int H, int W,
                            int th, const float* __restrict__ t_in,
                            int* __restrict__ occ_out) {
  __shared__ float s_blk[kBlockRows * kMaxTris];
  const TileRay ray = tile_ray(H, W, th);
  const int s = blockIdx.y;
  const int n_chunks = Tp / C;
  const int* keep = mask +
                    static_cast<size_t>(blockIdx.x) * (1 + S) * n_chunks +
                    static_cast<size_t>(1 + s) * n_chunks;
  const float* blk = table + static_cast<size_t>(1 + s) * kBlockRows * Tp;
  float ex = 0.0f, ey = 0.0f, ez = 0.0f;
  bool hit = false;
  if (ray.valid) {
    const float best_t = t_in[ray.r];
    hit = best_t < FLT_MAX;
    // The hit position, cam + tz * d as the JAX kernel forms it.
    const float tz = hit ? best_t : 0.0f;
    ex = (cam[0] + tz * dirs[3 * ray.r]) - src[3 * s];
    ey = (cam[1] + tz * dirs[3 * ray.r + 1]) - src[3 * s + 1];
    ez = (cam[2] + tz * dirs[3 * ray.r + 2]) - src[3 * s + 2];
  }
  bool sweeping = hit;
  bool occ = false;
  for (int c = 0; c < n_chunks; ++c) {
    if (keep[c] == 0) continue;  // block-uniform
    // A barrier (the previous chunk is read) that also tells whether any
    // ray of the tile still sweeps this source.
    if (!__syncthreads_or(sweeping)) break;
    stage(s_blk, blk, Tp, C, c);
    __syncthreads();
    if (sweeping && blocked(s_blk, C, ex, ey, ez)) {
      occ = true;
      sweeping = false;
    }
  }
  if (ray.valid)
    occ_out[static_cast<size_t>(s) * H * W + ray.r] = occ ? 1 : 0;
}

// K7b (Masked false) and K7c: block (tile, s) tests the tile's points
// against source s's chunks (the kept ones, K7c), each point from the first
// chunk to its first blocker.
template <bool Masked>
__global__ void __launch_bounds__(kThreads)
    occlusion_points_kernel(const float* __restrict__ pos,
                            const float* __restrict__ table, int Tp, int C,
                            const float* __restrict__ src, int S,
                            const int* __restrict__ mask, int H, int W,
                            int th, int* __restrict__ occ_out) {
  __shared__ float s_blk[kBlockRows * kMaxTris];
  const TileRay ray = tile_ray(H, W, th);
  const int s = blockIdx.y;
  const int n_chunks = Tp / C;
  const int* keep =
      Masked ? mask + static_cast<size_t>(blockIdx.x) * S * n_chunks +
                   static_cast<size_t>(s) * n_chunks
             : nullptr;
  const float* blk = table + static_cast<size_t>(s) * kBlockRows * Tp;
  float ex = 0.0f, ey = 0.0f, ez = 0.0f;
  if (ray.valid) {
    ex = pos[3 * ray.r] - src[3 * s];
    ey = pos[3 * ray.r + 1] - src[3 * s + 1];
    ez = pos[3 * ray.r + 2] - src[3 * s + 2];
  }
  bool sweeping = ray.valid;
  bool occ = false;
  for (int c = 0; c < n_chunks; ++c) {
    if (Masked && keep[c] == 0) continue;  // block-uniform
    // A barrier (the previous chunk is read) that also tells whether any
    // point of the tile still sweeps.
    if (!__syncthreads_or(sweeping)) break;
    stage(s_blk, blk, Tp, C, c);
    __syncthreads();
    if (sweeping && blocked(s_blk, C, ex, ey, ez)) {
      occ = true;
      sweeping = false;
    }
  }
  if (ray.valid)
    occ_out[static_cast<size_t>(s) * H * W + ray.r] = occ ? 1 : 0;
}

}  // namespace

// dirs (R, 3) (planar 0: K4) or (3, R) (planar 1: L2), table (20, C),
// cam (3,), light (3,) float32 device pointers; t (R,) float32, idx (R,)
// int32 and occ (R,) int32 outputs. Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int raytpu_closest_hit_occluded(const void* dirs, const void* table,
                                           const void* cam, const void* light,
                                           int C, int R, int planar, void* t,
                                           void* idx, void* occ,
                                           void* stream) {
  if (C < 1 || C > kMaxTris || R < 0 || (planar != 0 && planar != 1))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int blocks = (R + kThreads - 1) / kThreads;
  auto kernel = planar ? closest_hit_occluded_kernel<true>
                       : closest_hit_occluded_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// dirs (R = H * W, 3) and table (10, Tp) float32 device pointers, Tp a
// multiple of the chunk C <= 128; mask null (K5: every chunk, tiles of 256
// consecutive rays, pass H = 1, W = R, th = 1) or the (n_tiles, Tp / C)
// int32 keep-mask over the tiles of th x (256 / th) rays of the H x W grid
// (K7d); t (R,) float32 and idx (R,) int32 outputs. Launches on `stream`
// and returns the launch's cudaError_t.
extern "C" int raytpu_closest_hit(const void* dirs, const void* table, int Tp,
                                  int C, const void* mask, int H, int W,
                                  int th, void* t, void* idx, void* stream) {
  if (C < 1 || C > kMaxTris || Tp < C || Tp % C != 0 || H < 0 || W < 0 ||
      th < 1 || kThreads % th != 0)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const int tw = kThreads / th;
  const int blocks = ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask == nullptr)
    closest_hit_kernel<false><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(dirs), static_cast<const float*>(table), Tp,
        C, nullptr, 0, H, W, th, static_cast<float*>(t),
        static_cast<int*>(idx));
  else
    closest_hit_kernel<true><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(dirs), static_cast<const float*>(table), Tp,
        C, static_cast<const int*>(mask), Tp / C, H, W, th,
        static_cast<float*>(t), static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

// dirs (R = H * W, 3), table ((1 + S) * 10, Tp), cam (3,), src (S, 3)
// float32 device pointers, Tp a multiple of the chunk C <= 128; mask the
// (n_tiles, (1 + S) * Tp / C) int32 keep-mask over the tiles of
// th x (256 / th) rays of the H x W grid; t (R,) float32, idx (R,) int32
// and occ (S, R) int32 outputs. Launches K7a's two kernels on `stream`,
// the primary sweep (a block a tile) and the shadow sweeps (a block a
// tile and source), and returns the launches' cudaError_t.
extern "C" int raytpu_closest_hit_occluded_masked(
    const void* dirs, const void* table, int Tp, int C, const void* cam,
    const void* src, int S, const void* mask, int H, int W, int th, void* t,
    void* idx, void* occ, void* stream) {
  if (C < 1 || C > kMaxTris || Tp < C || Tp % C != 0 || S < 1 ||
      S > 65535 || H < 0 || W < 0 || th < 1 || kThreads % th != 0 ||
      mask == nullptr)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const int tw = kThreads / th;
  const int blocks = ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  closest_hit_kernel<true><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table), Tp,
      C, static_cast<const int*>(mask), (1 + S) * (Tp / C), H, W, th,
      static_cast<float*>(t), static_cast<int*>(idx));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  occlusion_masked_kernel<<<dim3(blocks, S), kThreads, 0, s>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table), Tp,
      C, static_cast<const float*>(cam), static_cast<const float*>(src), S,
      static_cast<const int*>(mask), H, W, th, static_cast<const float*>(t),
      static_cast<int*>(occ));
  return (int)cudaGetLastError();
}

// pos (R = H * W, 3), table (S * 10, Tp), src (S, 3) float32 device
// pointers, Tp a multiple of the chunk C <= 128; mask null (K7b: tiles of
// 256 consecutive points, pass H = 1, W = R, th = 1) or the (n_tiles, S *
// Tp / C) int32 keep-mask over the tiles of th x (256 / th) points of the
// H x W grid (K7c); occ (S, R) int32 output. Launches a block a (tile,
// source) on `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_occlusion_points(const void* pos, const void* table,
                                       int Tp, int C, const void* src, int S,
                                       const void* mask, int H, int W, int th,
                                       void* occ, void* stream) {
  if (C < 1 || C > kMaxTris || Tp < C || Tp % C != 0 || S < 1 ||
      S > 65535 || H < 0 || W < 0 || th < 1 || kThreads % th != 0)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const int tw = kThreads / th;
  const dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* tab = static_cast<const float*>(table);
  const float* sp = static_cast<const float*>(src);
  int* o = static_cast<int*>(occ);
  if (mask == nullptr)
    occlusion_points_kernel<false><<<grid, kThreads, 0, st>>>(
        p, tab, Tp, C, sp, S, nullptr, H, W, th, o);
  else
    occlusion_points_kernel<true><<<grid, kThreads, 0, st>>>(
        p, tab, Tp, C, sp, S, static_cast<const int*>(mask), H, W, th, o);
  return (int)cudaGetLastError();
}
