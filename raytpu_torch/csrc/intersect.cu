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
// into shared memory and runs the same primary sweep (it needs t, so it
// keeps plane_test's reciprocal). Its shadow sweeps, ~250 M tests at 512^2
// and S = 32, nearly all misses, are where its time goes: a sweep that paid
// plane_test's IEEE reciprocal and ten loads at stride C on each test ran
// at 13x its bound. So K6 sweeps the sources as K7a does:
// k7a_pack_tris_kernel copies the S source blocks triangle-major (48 bytes
// a triangle, three loads a test), each test takes K7a's exact reject
// first (shadow_reject, no reciprocal) and plane_test decides only what the
// reject leaves open (shadow_group); a lane stops at its first blocker and
// the warp goes on to the next source once no lane sweeps (__any_sync).
// The copy is staged once a block in dynamic shared memory where S C 48
// bytes fit (49 KB at S = 32, C = 32), else read from device memory
// through the read-only cache (every lane of a warp reads the same
// triangle: one transaction), as for the viewer's largest banks (C = 128,
// hundreds of sources); kernels/intersect.py::k6_staged chooses. Staged
// was the faster on the H100 up to 96 KB, where two blocks share an SM,
// and the slower at 144 and 192 KB (PERF.md). 95% of the bench's rays
// hit, so the misses are not packed out of the warps.
//
// Bound on the H100 (512^2 rays, C = 32). Memory: 12 B in and 8 + 4 S B
// out a ray. Arithmetic: C plane tests a ray in the primary sweep (20
// float operations each) and the shadow tests of a hit ray to its first
// blocker (K4: of every ray); K6's cost FLOPS_REJECT each where the reject
// decides them, and a plane test's 20 more elsewhere
// (chip_smoke.py::sweep_bound). At S = 32: bound by operations.
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
// takes on a scene of more than 128 triangles): the masked primary sweep,
// then for each of S sources the any-hit sweep over the chunks that
// source's mask columns keep.
//
// Rounding. Built with -fmad=false and IEEE division, each expression in
// the JAX kernel's order (the shadow direction is (cam + tz * d) - source),
// so t, idx and occ equal the plain PyTorch versions
// (kernels/intersect.py::closest_hit_occluded{,_multi}_reference,
// closest_reference, closest_masked_reference, occluded_masked_reference)
// on the card bit for bit.
//
// Several chunks (K5, K7d). The TPU kernels' (ray tile, chunk) grid,
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
// brute sweep's.
//
// K7a on Hopper. On an STL frame only the few tiles that see the mesh
// hold work (on the 9,028-triangle mesh at 500^2, 7% of the rays hit), so
// a block a tile would leave most of the card idle. K7a therefore runs
// four kernels, one call:
// - k7a_primary_kernel, a block a (tile, run): the tile's kept primary
//   chunks are split into PRIMARY_RUNS runs by rank among the kept ones,
//   each swept as above into partial (t, idx);
// - k7a_merge_kernel, a block a tile: each ray folds its runs' partials in
//   run order with `<=`, which is the sweep's own fold (the minimum, and the
//   last index of it, since later runs hold later chunks); then the tile's
//   hit rays are packed into full warps in ray order (ballot and prefix
//   count) with their hit positions, and the tile's warps of hit rays are
//   listed;
// - k7a_pack_tris_kernel copies the S shadow blocks triangle-major, 48
//   bytes a triangle, so a test reads its constants in three loads (two of
//   16 bytes, one of 8), not ten;
// - k7a_shadow_kernel, persistent warps that take work items (a warp of a
//   tile's hit rays, a source, a run of that source's kept chunks) from an
//   atomic counter: no block-wide barrier, a lane stops at its first
//   blocker, the warp leaves once no lane sweeps, and a test first takes
//   the exact reject (shadow_reject), which decides nearly every test
//   without the IEEE reciprocal; plane_test decides the rest. With few
//   sources a (tile, source)'s kept chunks are split into SHADOW_RUNS / S
//   runs, so the few tiles spread over every SM; the runs' bits OR into the
//   zeroed occ (a store of 1), in any order.
// Misses keep occ 0. The work lists are built on the card: no host sync.
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
// block-uniformly), each chunk staged between two barriers, a point
// stopping at its first blocker and the block leaving once none of its points still
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
// atomics, and a kept chunk costs one global read of 5 KB a block. K7a's
// shadow tests that the reject decides cost its 18 operations (15 for the
// dot products, 3 products and sums; its comparisons count not at all),
// the others those and a plane test's 20: bound by operations
// (chip_smoke.py::stl_bound).

#include <cfloat>
#include <cstddef>
#include <cstdint>
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

// ---------------------------------------------------------------------------
// K7a: the primary sweep in runs of kept chunks, their ordered merge and the
// packing of each tile's hit rays, then the shadow sweeps a warp a work item.

constexpr int kTileWarps = kThreads / 32;  // warps of a 256-ray tile
constexpr unsigned kFullMask = 0xffffffffu;

// The reject's constants (kernels/intersect.py REJECT_*), float32 exactly.
constexpr float kRejectMinD = 0x1p-40f;
constexpr float kRejectMaxD = 0x1p40f;
constexpr float kRejectEps = 0x1p-80f;
constexpr float kRejectT = 0x1.fae168p-1f;  // kShadowT + 2^-20
constexpr float kRejectUV = 0x1.00001p0f;   // 1 + 2^-20

// The dot products of plane_test for the triangle-major constants
// a = (n, k0), b = (c2, c3.x), c = (c3.y, c3.z), in plane_test's order:
// Dn = -D (D is plane_test's denom, Dn the sum it negates), U (u's
// numerator) and V (v's).
__device__ __forceinline__ void shadow_dots(float4 a, float4 b, float2 c,
                                            float ex, float ey, float ez,
                                            float* Dn, float* U, float* V) {
  *Dn = (ex * a.x + ey * a.y) + ez * a.z;
  *U = (ex * b.x + ey * b.y) + ez * b.z;
  *V = (ex * b.w + ey * c.x) + ez * c.y;
}

// x with D's sign bit XOR-ed in, from Dn = -D, whose sign bit is D's
// complemented (one LOP3).
__device__ __forceinline__ float flip_by(float x, float Dn) {
  return __int_as_float(__float_as_int(x) ^
                        (~__float_as_int(Dn) & static_cast<int>(0x80000000u)));
}

// The exact any-hit reject: true only where plane_test's ok && t < 0.99 is
// surely false, decided from D, U, V and K (k0) without the reciprocal.
//
// plane_test forms r = fl(1 / D), u = fl(U r), v = fl(V r), t = fl(K r)
// and fl(u + v). Round to nearest is symmetric, so with Ds = |D| and Us,
// Vs, Ks the values with D's sign bit XOR-ed in (exact), u = fl(Us r'),
// v = fl(Vs r'), t = fl(Ks r') for r' = fl(1 / Ds). Let e = 2^-24, and
// take the guard 2^-40 <= Ds <= 2^40 (it fails for NaN, inf, 0 and every
// subnormal D): then r' lies in [2^-40, 2^40] and fl(Ds c) = Ds c (1 + d),
// |d| <= e, for c near 1. Each clause below implies the test fails:
// - D = 0: plane_test's nonpar is false.
// - Us < -2^-80: Us r' <= -2^-120, a normal number, so u < 0 (likewise
//   Vs and v, Ks and t). A tiny or zero Us is left alone: fl(Us r') may
//   round to -0, which passes u >= 0.
// - Ks >= fl(Ds kRejectT): Ks r' >= kRejectT (1 - e)^2 > kShadowT, since
//   kRejectT = kShadowT + 2^-20, so t = fl(Ks r') >= kShadowT (rounding is
//   monotone and kShadowT a float; an overflow gives +inf).
// - fl(Us + Vs) > fl(Ds kRejectUV), with Us, Vs >= -2^-80 (else a clause
//   above holds): W = Us + Vs > Ds kRejectUV (1 - 2e), so r' W >
//   kRejectUV (1 - e) (1 - 2e); |fl(x) - x| <= e |x| + 2^-150 gives
//   u + v >= r' W - e r' (|Us| + |Vs|) - 2^-149, and |Us| + |Vs| <= W +
//   4 2^-80, so u + v >= r' W (1 - e) - 2^-61 >= kRejectUV (1 - 4e) -
//   2^-61 >= 1 + 2^-21 and fl(u + v) > 1 (kRejectUV = 1 + 2^-20).
// A NaN makes every comparison that reads it false, so it never rejects.
// Everything else (a test that blocks, a margin case, a D outside the
// guard) falls through to plane_test. kernels/intersect.py::shadow_reject
// is the plain form; the card enumerates it against plane_test
// (raytpu_shadow_reject_probe). It takes Dn = -D (shadow_dots), so that D
// itself is never formed.
__device__ __forceinline__ bool shadow_reject(float Dn, float U, float V,
                                              float K) {
  const float Ds = fabsf(Dn);
  const float Us = flip_by(U, Dn), Vs = flip_by(V, Dn), Ks = flip_by(K, Dn);
  const bool guard = (Ds >= kRejectMinD) & (Ds <= kRejectMaxD);
  const bool miss = (Us < -kRejectEps) | (Vs < -kRejectEps) |
                    (Ks < -kRejectEps) | (Ks >= Ds * kRejectT) |
                    (Us + Vs > Ds * kRejectUV);
  return (Dn == 0.0f) | (guard & miss);
}

// The kept chunks of one keep-mask row (n columns) with rank in [lo, hi)
// among the kept ones, in order: fn(c) for each, until fn returns false
// (warp-uniformly). Every lane of the warp calls it and sees the same
// chunks.
template <typename Fn>
__device__ __forceinline__ void for_kept_run(const int* __restrict__ keep,
                                             int n, int lo, int hi, Fn fn) {
  const int lane = threadIdx.x & 31;
  int rank = 0;
  for (int base = 0; base < n && rank < hi; base += 32) {
    unsigned bits =
        __ballot_sync(kFullMask, base + lane < n && keep[base + lane] != 0);
    while (bits != 0u && rank < hi) {
      const int c = base + __ffs(bits) - 1;
      bits &= bits - 1u;
      if (rank++ >= lo && !fn(c)) return;
    }
  }
}

// Kept chunks of a keep-mask row, counted by a warp.
__device__ __forceinline__ int kept_count(const int* __restrict__ keep,
                                          int n) {
  const int lane = threadIdx.x & 31;
  int k = 0;
  for (int base = 0; base < n; base += 32)
    k += __popc(
        __ballot_sync(kFullMask, base + lane < n && keep[base + lane] != 0));
  return k;
}

// Run j of `runs` over k kept chunks: ranks [k j / runs, k (j + 1) / runs).
__device__ __forceinline__ int run_edge(int k, int j, int runs) {
  return static_cast<int>(static_cast<long long>(k) * j / runs);
}

// K7a's primary sweep: block (tile, j) sweeps run j of the tile's kept
// primary chunks (the mask's first n_chunks columns) as sweep_chunks does,
// and writes its (t, idx) to the partials of run j.
__global__ void __launch_bounds__(kThreads)
    k7a_primary_kernel(const float* __restrict__ dirs,
                       const float* __restrict__ table, int Tp, int C,
                       const int* __restrict__ mask, int mask_stride, int H,
                       int W, int th, float* __restrict__ t_part,
                       int* __restrict__ i_part) {
  __shared__ float s_blk[kBlockRows * kMaxTris];
  const TileRay ray = tile_ray(H, W, th);
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray.valid) {
    dx = dirs[3 * ray.r];
    dy = dirs[3 * ray.r + 1];
    dz = dirs[3 * ray.r + 2];
  }
  const int n_chunks = Tp / C;
  const int* keep = mask + static_cast<size_t>(blockIdx.x) * mask_stride;
  const int k = kept_count(keep, n_chunks);
  float bt = FLT_MAX;
  int bi = -1;
  // Every warp walks the same chunks, so the barriers are block-uniform.
  for_kept_run(keep, n_chunks, run_edge(k, blockIdx.y, gridDim.y),
               run_edge(k, blockIdx.y + 1, gridDim.y), [&](int c) {
                 __syncthreads();  // the previous chunk is read
                 stage(s_blk, table, Tp, C, c);
                 __syncthreads();
                 if (ray.valid) {
                   for (int i = 0; i < C; ++i) {
                     const PlaneHit p = plane_test(s_blk, C, i, dx, dy, dz);
                     const float tm = p.ok ? p.t : FLT_MAX;
                     if (tm <= bt) {
                       bt = tm;
                       bi = c * C + i;
                     }
                   }
                 }
                 return true;
               });
  if (!ray.valid) return;
  const size_t at = static_cast<size_t>(blockIdx.y) * H * W + ray.r;
  t_part[at] = bt;
  i_part[at] = bi;
}

// K7a's merge and packing, a block a tile: each ray folds its runs' (t,
// idx) in run order with `<=` (the last index keeps winning ties), writes
// t and idx, and the tile's hit rays are packed in ray order: hits[tile *
// 256 + k] = (cam + t d, ray) for the k-th hit ray, n_hit[tile] their
// count; the tile's warps of hit rays are appended to warp_list (tile * 8
// + w, counted in counts[0]).
__global__ void __launch_bounds__(kThreads)
    k7a_merge_kernel(const float* __restrict__ dirs,
                     const float* __restrict__ cam, int H, int W, int th,
                     int runs, const float* __restrict__ t_part,
                     const int* __restrict__ i_part,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     float4* __restrict__ hits, int* __restrict__ n_hit,
                     int* __restrict__ warp_list, int* __restrict__ counts) {
  __shared__ int s_warp[kTileWarps];
  const TileRay ray = tile_ray(H, W, th);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float bt = FLT_MAX;
  int bi = -1;
  if (ray.valid) {
    for (int j = 0; j < runs; ++j) {
      const size_t at = static_cast<size_t>(j) * H * W + ray.r;
      const float tj = t_part[at];
      if (tj <= bt) {
        bt = tj;
        bi = i_part[at];
      }
    }
    t_out[ray.r] = bt;
    idx_out[ray.r] = bt < FLT_MAX ? bi : -1;
  }
  const bool hit = ray.valid && bt < FLT_MAX;
  const unsigned ballot = __ballot_sync(kFullMask, hit);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kTileWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  if (hit) {
    const int k = before + __popc(ballot & ((1u << lane) - 1u));
    // The hit position as the JAX kernel forms it, cam + tz * d.
    hits[static_cast<size_t>(blockIdx.x) * kThreads + k] = make_float4(
        cam[0] + bt * dirs[3 * ray.r], cam[1] + bt * dirs[3 * ray.r + 1],
        cam[2] + bt * dirs[3 * ray.r + 2], __int_as_float(ray.r));
  }
  if (threadIdx.x == 0) {
    n_hit[blockIdx.x] = total;
    const int warps = (total + 31) / 32;
    if (warps > 0) {
      const int at = atomicAdd(&counts[0], warps);
      for (int w = 0; w < warps; ++w)
        warp_list[at + w] = blockIdx.x * kTileWarps + w;
    }
  }
}

// The shadow blocks of the table, triangle-major, 48 bytes a triangle:
// tris[(s * Tp + i) * 3 + {0, 1, 2}] = (n, k0), (c2, c3.x), (c3.y, c3.z, 0,
// 0) of triangle i for source s.
__global__ void k7a_pack_tris_kernel(const float* __restrict__ table, int Tp,
                                     int S, float4* __restrict__ tris) {
  const size_t n = static_cast<size_t>(S) * Tp;
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < n; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t s = k / Tp, i = k % Tp;
    const float* blk = table + (1 + s) * kBlockRows * Tp + i;
    tris[3 * k] = make_float4(blk[0], blk[Tp], blk[2 * Tp], blk[9 * Tp]);
    tris[3 * k + 1] = make_float4(blk[3 * Tp], blk[4 * Tp], blk[5 * Tp],
                                  blk[6 * Tp]);
    tris[3 * k + 2] = make_float4(blk[7 * Tp], blk[8 * Tp], 0.f, 0.f);
  }
}

// Tests a group of the shadow sweep (its loads in flight together), and
// the sweep's blocks an SM (128 registers a thread).
constexpr int kShadowGroup = 16;
constexpr int kShadowMinBlocks = 2;
// K6's largest staged triangle-major copy: a block's shared memory less its
// primary block and the slack the runtime keeps.
constexpr long long kMaxStagedBytes = 200 * 1024;

// The reject on the triangle whose triangle-major constants are at t, in
// device memory through the read-only cache or (kSmem) in shared memory.
template <bool kSmem = false>
__device__ __forceinline__ bool rejected(const float4* __restrict__ t,
                                         float ex, float ey, float ez) {
  const float4 a = kSmem ? t[0] : __ldg(t);
  const float4 b = kSmem ? t[1] : __ldg(t + 1);
  const float2 c = kSmem ? *reinterpret_cast<const float2*>(t + 2)
                         : __ldg(reinterpret_cast<const float2*>(t + 2));
  float Dn, U, V;
  shadow_dots(a, b, c, ex, ey, ez, &Dn, &U, &V);
  return shadow_reject(Dn, U, V, a.w);
}

// G tests of the shadow sweep from triangle g on (constants at tri + 3 g,
// so each load's offset is an immediate): the reject on each, and one
// branch, taken only where it leaves a test undecided, to plane_test on
// the table (row stride Tp). A blocker stops the lane and sets *occ.
template <int G, bool kSmem = false>
__device__ __forceinline__ void shadow_group(const float4* __restrict__ tri,
                                             const float* __restrict__ blk,
                                             int Tp, int g, float ex,
                                             float ey, float ez,
                                             bool& sweeping, int* occ) {
  const float4* t = tri + 3 * static_cast<size_t>(g);
  bool decided = true;
#pragma unroll
  for (int u = 0; u < G; ++u)
    decided &= rejected<kSmem>(t + 3 * u, ex, ey, ez);
  if (!sweeping || decided) return;
  for (int i = g; i < g + G; ++i) {
    if (rejected<kSmem>(t + 3 * (i - g), ex, ey, ez)) continue;
    const PlaneHit p = plane_test(blk, Tp, i, ex, ey, ez);
    if (p.ok && p.t < kShadowT) {
      sweeping = false;
      *occ = 1;
      return;
    }
  }
}

// K6, a thread a ray, 256 a block: the primary sweep on the primary block
// staged in shared memory (closest: plane_test, it needs t), then the S
// shadow sweeps of a hit ray, each test through the exact reject first and
// plane_test on the table (row stride C) only where the reject leaves it
// open (shadow_group, K7a's). The sources' constants are read
// triangle-major from k7a_pack_tris_kernel's copy of K6's table (Tp = C),
// in device memory through the read-only cache or (kStaged) staged once a
// block in dynamic shared memory (S C 48 bytes). A lane stops at its first
// blocker; the warp moves to the next source once no lane sweeps. Misses
// sweep nothing (occ 0). A lane past R takes part in the warp's votes only.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    closest_hit_occluded_multi_kernel(const float* __restrict__ dirs,
                                      const float* __restrict__ table,
                                      const float* __restrict__ cam,
                                      const float* __restrict__ src,
                                      const float4* __restrict__ tris, int C,
                                      int S, int R, float* __restrict__ t_out,
                                      int* __restrict__ idx_out,
                                      int* __restrict__ occ_out) {
  extern __shared__ float4 s_tris[];
  __shared__ float s_tab[kBlockRows * kMaxTris];
  __shared__ float s_cam[3];
  for (int k = threadIdx.x; k < kBlockRows * C; k += kThreads)
    s_tab[k] = table[k];
  if (kStaged) {
    for (int k = threadIdx.x; k < S * C * 3; k += kThreads)
      s_tris[k] = tris[k];
  }
  if (threadIdx.x < 3) s_cam[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = r < R;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (valid) {
    dx = dirs[3 * r];
    dy = dirs[3 * r + 1];
    dz = dirs[3 * r + 2];
  }
  float best_t;
  const int best_i = closest(s_tab, C, dx, dy, dz, &best_t);
  const bool hit = valid && best_t < FLT_MAX;
  if (valid) {
    t_out[r] = best_t;
    idx_out[r] = hit ? best_i : -1;
  }
  const float tz = hit ? best_t : 0.0f;
  const float px = s_cam[0] + tz * dx;
  const float py = s_cam[1] + tz * dy;
  const float pz = s_cam[2] + tz * dz;
  const float4* tri_all = kStaged ? s_tris : tris;
  for (int s = 0; s < S; ++s) {
    bool sweeping = hit;
    int occ = 0;
    if (__any_sync(kFullMask, sweeping)) {
      const float ex = px - src[3 * s], ey = py - src[3 * s + 1],
                  ez = pz - src[3 * s + 2];
      const float4* tri = tri_all + static_cast<size_t>(s) * C * 3;
      const float* blk = table + static_cast<size_t>(1 + s) * kBlockRows * C;
      for (int i0 = 0; i0 < C; i0 += 32) {
        const int i1 = i0 + 32 < C ? i0 + 32 : C;
        int g = i0;
        for (; g + kShadowGroup <= i1; g += kShadowGroup)
          shadow_group<kShadowGroup, kStaged>(tri, blk, C, g, ex, ey, ez,
                                              sweeping, &occ);
        for (; g + 8 <= i1; g += 8)
          shadow_group<8, kStaged>(tri, blk, C, g, ex, ey, ez, sweeping,
                                   &occ);
        for (; g < i1; ++g)
          shadow_group<1, kStaged>(tri, blk, C, g, ex, ey, ez, sweeping,
                                   &occ);
        if (!__any_sync(kFullMask, sweeping)) break;
      }
    }
    if (valid) occ_out[static_cast<size_t>(s) * R + r] = occ;
  }
}

// K7a's shadow sweeps, a warp a work item (warp of hit rays w of a tile,
// source s, run j of the source's kept chunks): items hw + n_hw (j + runs
// s), taken in turn from counts[1] by persistent warps. Each lane takes one
// packed hit ray, sweeps the run's chunks from the triangle-major copy
// (warp-uniform loads through the read-only cache) with the reject first
// and plane_test on the table where it does not decide, and stops at its
// first blocker; the warp leaves the item once no lane sweeps. A blocked
// ray writes occ = 1 over the zeroed output: the runs' bits OR in any
// order.
__global__ void __launch_bounds__(kThreads, kShadowMinBlocks)
    k7a_shadow_kernel(const float4* __restrict__ tris,
                      const float* __restrict__ table, int Tp, int C,
                      const float* __restrict__ src, int S, int runs,
                      const int* __restrict__ mask, int R,
                      const float4* __restrict__ hits,
                      const int* __restrict__ n_hit,
                      const int* __restrict__ warp_list,
                      int* __restrict__ counts, int* __restrict__ occ_out) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = Tp / C;
  const int n_hw = counts[0];
  const long long n_items = static_cast<long long>(n_hw) * S * runs;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(&counts[1], 1);
    item = __shfl_sync(kFullMask, item, 0);
    if (item >= n_items) return;
    const int hw = item % n_hw, q = item / n_hw;
    const int j = q % runs, s = q / runs;
    const int tile = warp_list[hw] / kTileWarps;
    const int slot = (warp_list[hw] % kTileWarps) * 32 + lane;
    bool sweeping = slot < n_hit[tile];
    float ex = 0.0f, ey = 0.0f, ez = 0.0f;
    int r = 0;
    if (sweeping) {
      const float4 h = hits[static_cast<size_t>(tile) * kThreads + slot];
      ex = h.x - src[3 * s];
      ey = h.y - src[3 * s + 1];
      ez = h.z - src[3 * s + 2];
      r = __float_as_int(h.w);
    }
    const int* keep = mask +
                      static_cast<size_t>(tile) * (1 + S) * n_chunks +
                      static_cast<size_t>(1 + s) * n_chunks;
    const float4* tri = tris + static_cast<size_t>(s) * Tp * 3;
    const float* blk = table + static_cast<size_t>(1 + s) * kBlockRows * Tp;
    const int k = kept_count(keep, n_chunks);
    int* occ = occ_out + static_cast<size_t>(s) * R + r;
    for_kept_run(keep, n_chunks, run_edge(k, j, runs),
                 run_edge(k, j + 1, runs), [&](int c) {
      const int end = (c + 1) * C;
      for (int i0 = c * C; i0 < end; i0 += 32) {
        const int i1 = i0 + 32 < end ? i0 + 32 : end;
        int g = i0;
        for (; g + kShadowGroup <= i1; g += kShadowGroup)
          shadow_group<kShadowGroup>(tri, blk, Tp, g, ex, ey, ez, sweeping,
                                     occ);
        for (; g < i1; g += 8)  // C is a multiple of 8
          shadow_group<8>(tri, blk, Tp, g, ex, ey, ez, sweeping, occ);
        if (!__any_sync(kFullMask, sweeping)) return false;
      }
      return true;
    });
  }
}

// The reject and plane_test's any-hit verdict on N (ray, triangle) pairs:
// e (N, 3) shadow rays, tri (N, 10) constants [n | c2 | c3 | k0].
__global__ void shadow_reject_probe_kernel(const float* __restrict__ e,
                                           const float* __restrict__ tri,
                                           int N, int* __restrict__ reject,
                                           int* __restrict__ blocked) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  const float* m = tri + 10 * static_cast<size_t>(k);
  const float ex = e[3 * k], ey = e[3 * k + 1], ez = e[3 * k + 2];
  float Dn, U, V;
  shadow_dots(make_float4(m[0], m[1], m[2], m[9]),
              make_float4(m[3], m[4], m[5], m[6]), make_float2(m[7], m[8]),
              ex, ey, ez, &Dn, &U, &V);
  reject[k] = shadow_reject(Dn, U, V, m[9]) ? 1 : 0;
  const PlaneHit p = plane_test(m, 1, 0, ex, ey, ez);
  blocked[k] = p.ok && p.t < kShadowT ? 1 : 0;
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
// pointers; t (R,) float32, idx (R,) int32 and occ (S, R) int32 outputs;
// tris scratch for the triangle-major copy (S C 48 bytes, scratch_bytes at
// least that, 16-byte aligned). staged 1 stages the copy in shared memory
// (S C 48 bytes a block, at most kMaxStagedBytes), 0 reads it from device
// memory. Launches the copy and K6 on `stream`, never synchronises, and
// returns the first launch error.
extern "C" int raytpu_closest_hit_occluded_multi(
    const void* dirs, const void* table, const void* cam, const void* src,
    int C, int S, int R, void* t, void* idx, void* occ, void* tris,
    long long scratch_bytes, int staged, void* stream) {
  const long long tri_bytes = 48LL * S * C;
  if (C < 1 || C > kMaxTris || S < 1 || R < 0 || tris == nullptr ||
      scratch_bytes < tri_bytes || (staged != 0 && staged != 1) ||
      (staged == 1 && tri_bytes > kMaxStagedBytes))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(table);
  float4* tr = static_cast<float4*>(tris);
  const int n_tris = S * C;
  k7a_pack_tris_kernel<<<(n_tris + kThreads - 1) / kThreads, kThreads, 0,
                         st>>>(tab, C, S, tr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kThreads - 1) / kThreads;
  const float* d = static_cast<const float*>(dirs);
  const float* cp = static_cast<const float*>(cam);
  const float* sp = static_cast<const float*>(src);
  if (staged == 1) {
    const int smem = static_cast<int>(tri_bytes);
    if ((err = cudaFuncSetAttribute(
             closest_hit_occluded_multi_kernel<true>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return (int)err;
    closest_hit_occluded_multi_kernel<true><<<blocks, kThreads, smem, st>>>(
        d, tab, cp, sp, tr, C, S, R, static_cast<float*>(t),
        static_cast<int*>(idx), static_cast<int*>(occ));
  } else {
    closest_hit_occluded_multi_kernel<false><<<blocks, kThreads, 0, st>>>(
        d, tab, cp, sp, tr, C, S, R, static_cast<float*>(t),
        static_cast<int*>(idx), static_cast<int*>(occ));
  }
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

// K7a's scratch, carved from one buffer in this order, each part aligned to
// 16 bytes: the triangle-major shadow constants (S Tp triangles of 48
// bytes), the runs' partial t and idx (runs R each), the packed hits
// (n_tiles 256 float4), n_hit (n_tiles), warp_list (n_tiles 8) and counts
// (4 ints: warps of hit rays, next work item). `bytes` is the total.
struct K7aScratch {
  float4* tris;
  float* t_part;
  int* i_part;
  float4* hits;
  int* n_hit;
  int* warp_list;
  int* counts;
  size_t bytes;
};

static size_t align16(size_t n) { return (n + 15) / 16 * 16; }

static K7aScratch k7a_scratch(void* base, int Tp, int S, int R, int n_tiles,
                              int runs) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t at = 0;
  auto take = [&](size_t n) {
    const uintptr_t q = p + at;
    at += align16(n);
    return q;
  };
  K7aScratch sc;
  sc.tris = reinterpret_cast<float4*>(
      take(static_cast<size_t>(S) * Tp * 3 * sizeof(float4)));
  sc.t_part = reinterpret_cast<float*>(
      take(static_cast<size_t>(runs) * R * sizeof(float)));
  sc.i_part = reinterpret_cast<int*>(
      take(static_cast<size_t>(runs) * R * sizeof(int)));
  sc.hits = reinterpret_cast<float4*>(
      take(static_cast<size_t>(n_tiles) * kThreads * sizeof(float4)));
  sc.n_hit = reinterpret_cast<int*>(take(n_tiles * sizeof(int)));
  sc.warp_list =
      reinterpret_cast<int*>(take(n_tiles * kTileWarps * sizeof(int)));
  sc.counts = reinterpret_cast<int*>(take(4 * sizeof(int)));
  sc.bytes = at;
  return sc;
}

static bool k7a_shapes_ok(int Tp, int C, int S, int H, int W, int th,
                          int pri_runs) {
  return C >= 1 && C <= kMaxTris && Tp >= C && Tp % C == 0 && S >= 1 &&
         H >= 0 && W >= 0 && th >= 1 && kThreads % th == 0 &&
         pri_runs >= 1 && pri_runs <= 65535;
}

static int k7a_tiles(int H, int W, int th) {
  const int tw = kThreads / th;
  return ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

// The bytes of K7a's scratch for these shapes, or -1 if K7a refuses them.
extern "C" long long raytpu_closest_hit_occluded_masked_scratch(
    int Tp, int C, int S, int H, int W, int th, int pri_runs) {
  if (!k7a_shapes_ok(Tp, C, S, H, W, th, pri_runs)) return -1;
  return static_cast<long long>(
      k7a_scratch(nullptr, Tp, S, H * W, k7a_tiles(H, W, th), pri_runs)
          .bytes);
}

// dirs (R = H * W, 3), table ((1 + S) * 10, Tp), cam (3,), src (S, 3)
// float32 device pointers, Tp a multiple of the chunk C <= 128; mask the
// (n_tiles, (1 + S) * Tp / C) int32 keep-mask over the tiles of
// th x (256 / th) rays of the H x W grid; t (R,) float32, idx (R,) int32
// and occ (S, R) int32 outputs; scratch (scratch_bytes, at least what
// raytpu_closest_hit_occluded_masked_scratch gives). pri_runs and shw_runs split
// each tile's kept primary chunks, and each (tile, source)'s kept shadow
// chunks, into that many runs. phases: 1 the primary sweep, merge and
// packing (t, idx and the scratch's hits); 2 the shadow sweeps (occ, from
// the hits a phase 1 left in the same scratch); 3 both, K7a. Launches on
// `stream`, never synchronises, and returns the first launch error.
extern "C" int raytpu_closest_hit_occluded_masked(
    const void* dirs, const void* table, int Tp, int C, const void* cam,
    const void* src, int S, const void* mask, int H, int W, int th, void* t,
    void* idx, void* occ, void* scratch, long long scratch_bytes,
    int pri_runs, int shw_runs, int phases, void* stream) {
  if (!k7a_shapes_ok(Tp, C, S, H, W, th, pri_runs) || mask == nullptr ||
      shw_runs < 1 || phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const int n_tiles = k7a_tiles(H, W, th);
  const int R = H * W;
  const K7aScratch sc = k7a_scratch(scratch, Tp, S, R, n_tiles, pri_runs);
  if (scratch == nullptr || scratch_bytes < (long long)sc.bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dirs);
  const float* tab = static_cast<const float*>(table);
  const int* msk = static_cast<const int*>(mask);
  cudaError_t err;
  if (phases & 1) {
    if ((err = cudaMemsetAsync(sc.counts, 0, sizeof(int), st)) != cudaSuccess)
      return (int)err;
    k7a_primary_kernel<<<dim3(n_tiles, pri_runs), kThreads, 0, st>>>(
        d, tab, Tp, C, msk, (1 + S) * (Tp / C), H, W, th, sc.t_part,
        sc.i_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k7a_merge_kernel<<<n_tiles, kThreads, 0, st>>>(
        d, static_cast<const float*>(cam), H, W, th, pri_runs, sc.t_part,
        sc.i_part, static_cast<float*>(t), static_cast<int*>(idx), sc.hits,
        sc.n_hit, sc.warp_list, sc.counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    if ((err = cudaMemsetAsync(occ, 0, static_cast<size_t>(S) * R * 4,
                               st)) != cudaSuccess ||
        (err = cudaMemsetAsync(sc.counts + 1, 0, sizeof(int), st)) !=
            cudaSuccess)
      return (int)err;
    const size_t n_tris = static_cast<size_t>(S) * Tp;
    k7a_pack_tris_kernel<<<static_cast<int>(
                               (n_tris + kThreads - 1) / kThreads < 65535
                                   ? (n_tris + kThreads - 1) / kThreads
                                   : 65535),
                           kThreads, 0, st>>>(tab, Tp, S, sc.tris);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    // Persistent warps: as many blocks as fit on the card at once.
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, k7a_shadow_kernel, kThreads, 0)) != cudaSuccess)
      return (int)err;
    k7a_shadow_kernel<<<sms * (per_sm > 0 ? per_sm : 1), kThreads, 0, st>>>(
        sc.tris, tab, Tp, C, static_cast<const float*>(src), S, shw_runs,
        msk, R, sc.hits, sc.n_hit, sc.warp_list, sc.counts,
        static_cast<int*>(occ));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// e (N, 3) and tri (N, 10) float32 device pointers; reject and blocked (N,)
// int32 outputs: the device reject and plane_test's verdict (t < 0.99) on
// each pair. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_shadow_reject_probe(const void* e, const void* tri,
                                          int N, void* reject, void* blocked,
                                          void* stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  shadow_reject_probe_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(tri), N,
      static_cast<int*>(reject), static_cast<int*>(blocked));
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
