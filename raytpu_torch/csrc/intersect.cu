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
// Design. One thread per ray, 256 a block. K4 (and L2) stages both blocks
// triangle-major in shared memory (40 bytes a triangle, 10 KB at C = 128),
// read by every lane of a warp at once, a broadcast without bank
// conflicts. Its sweeps are sweep_cull.cuh's: a warp bounds its rays'
// directions by a box and culls exactly the triangles no ray of it can hit
// (box_reject: lane i decides triangles i, i + 32, ..., a ballot for each
// 32), and its lanes test the survivors in order, primary_reject first and
// the IEEE reciprocal only where it leaves a test open; then the shadow
// sweep does the same on the warp's shadow rays (with the t >= 0.99 clause,
// which culls the surface the hit points lie on and what lies beyond), a
// lane stopping at its first blocker and the warp once no lane sweeps. Where
// the rays are an image (kernels/intersect.py::closest_hit_occluded's
// image_hw), a warp takes a block of SWEEP_WARP_ROWS x (32 /
// SWEEP_WARP_ROWS) pixels, whose box is smaller than a row's strip of 32;
// the outputs stay in ray order. K6 copies the primary block into shared
// memory and runs the brute primary sweep (it needs t, so it keeps
// plane_test's reciprocal). Its shadow sweeps, ~250 M tests at 512^2
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
// out a ray. Arithmetic (chip_smoke.py::sweep_bound): K6, C plane tests a
// ray in the primary sweep (20 float operations each) and the shadow tests
// of a hit ray to its first blocker, FLOPS_REJECT each where the reject
// decides them and a plane test's 20 more elsewhere; K4,
// FLOPS_PRIMARY_CULL a (warp, triangle) decision of either sweep (one more
// for the shadow sweep's t clause), FLOPS_PRIMARY_REJECT a ray's test of
// its warp's primary survivors, FLOPS_REJECT one of its shadow survivors to
// its first blocker, and a plane test's 20 more where the reject leaves a
// test open (chip_smoke.py::sweep_cull_work). Bound by operations.
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
// Several chunks (K5, K7d), redesigned for Hopper. The TPU kernels'
// (ray tile, chunk) grid, whose VMEM scratch carries the running best from
// one grid step to the next, becomes closest_cull_kernel: one thread a ray,
// a block of 256 rays for a ray tile (16 x 16 pixels of an image, or 256
// consecutive rays of a list: the port's tiles,
// kernels/intersect.py::ray_tiles) and a run of the chunks the tile keeps
// (K5 every chunk, one run). On a mesh nearly every (ray, triangle) test
// is a miss that no ray of a tile can pass, so the block first culls: it
// bounds its rays' directions by a box, and each thread decides one
// triangle of a pass of 256 against it exactly (box_reject: plane_test's
// own sums at the box's corners, rounding being monotone); the survivors
// are compacted in triangle order into shared memory, triangle-major (44
// bytes each), and each warp then decides them again against its own
// 32 rays' box and sweeps what stays, each test through the exact reject
// (primary_reject, K7a's shadow reject without its t < 0.99 clause) and
// plane_test's verdict from the same sums only where the reject leaves it
// open. A culled or rejected test is one whose ok is false, so `<=` over
// the survivors in order gives the brute sweep's t, and its idx wherever t
// is not F32MAX (the last index wins ties within a chunk and across
// chunks, as the JAX kernels' chunk min with `upd = chunk_min <= best_t`
// does). A chunk the mask leaves out holds no hit for any ray of its tile
// (the mask is conservative), so t and idx equal the brute sweep's. K7d's
// few tiles that see a mesh hold nearly all its work, so a tile's kept
// chunks are cut into runs of at most PRIMARY_RUN (kernels/intersect.py),
// a block each; the block that finishes a tile's last run folds each ray's
// runs in run order with `<=`, the sweep's own fold. A tile of few kept
// chunks is one run and writes its outputs at once: no partials, no
// second launch.
//
// K7a on Hopper. On an STL frame only the few tiles that see the mesh
// hold work (on the 9,028-triangle mesh at 500^2, 7% of the rays hit), so
// a block a tile would leave most of the card idle. K7a therefore runs
// four kernels, one call:
// - closest_cull_kernel<true>, a block a (tile, run): K7d's sweep of the
//   tile's kept primary chunks, and its fold, into t and idx;
// - k7a_pack_kernel, a block a tile: the tile's hit rays are packed into
//   full warps in ray order (ballot and prefix count) with their hit
//   positions, and the tile's warps of hit rays are listed;
// - k7a_pack_tris_kernel copies the S shadow blocks triangle-major, 48
//   bytes a triangle, so a test reads its constants in three loads (two of
//   16 bytes, one of 8), not ten;
// - shadow_items_kernel<false>, persistent warps that take work items (a
//   warp of a tile's hit rays, a source, a run of that source's kept
//   chunks) from an atomic counter: no block-wide barrier, a lane stops at
//   its first blocker, the warp leaves once no lane sweeps, and a test
//   first takes the exact reject (shadow_reject), which decides nearly
//   every test without the IEEE reciprocal; plane_test decides the rest.
//   With few sources a (tile, source)'s kept chunks are split into
//   SHADOW_RUNS / S runs, so the few tiles spread over every SM; the runs'
//   bits OR into the zeroed occ (a store of 1), in any order.
// Misses keep occ 0. The work lists are built on the card: no host sync.
//
// K7b and K7c replace intersect_pallas.py::_occlusion_multi_kernel
// (launched at :1078 by occlusion_multi_pallas) and
// ::_occlusion_multi_kernel_masked (launched at :1063 for a block of
// several chunks given its vertices): the any-hit shadow test (t < 0.99) of
// S sources toward KNOWN points, with no primary phase. The sharded
// renderer merges the primary closest hit across the triangle shards
// before any shadow ray exists, so each shard runs these on the merged hit
// positions against its own triangle block
// (raytpu_torch/parallel/render.py::_merged_occlusion_rows). The ray is
// pos - src[s]. Unlike K7a every point is tested, a miss's camera-origin
// point included, as the JAX kernels test every point; the masks of
// kernels/cull.py::position_shadow_mask are conservative for every point,
// so K7c's bits equal K7b's. Every test takes K7a's exact reject first
// from k7a_pack_tris_kernel's triangle-major copy of the S blocks (block
// offset 0), so the IEEE reciprocal is paid only where the reject leaves a
// test open, and no block-wide barrier holds a warp whose points are done:
// - K7b on one chunk (the sharded renderer's scenes, T <= 128) is K6's
//   shadow half, occlusion_points_kernel<kStaged>: a thread a point, read
//   once, swept toward the S sources in turn (shadow_sources, K6's own
//   loop), the copy staged once a block in shared memory where it takes at
//   most kOccStagedBytes (kernels/intersect.py::k6_staged's 96 KB) and
//   read through the cache above; a lane stops at its first blocker, the warp moves to the next
//   source once no lane sweeps, and occ (S, R) is written a row a source,
//   coalesced.
// - K7c, and K7b over several chunks, are K7a's shadow half on the tiles'
//   own points, shadow_items_kernel<true>: occlusion_plan_kernel counts
//   each (tile, source) pair's kept chunks (K7b keeps every chunk), a warp
//   a pair, on the card; persistent warps take items (a warp of the tile's
//   points, one run of `run` kept chunks of one pair, every pair's first
//   run first) from a counter, so the few tiles holding most of the work
//   spread over the card; a blocked point stores 1 over the zeroed occ, the
//   runs' bits OR in any order, and a lane whose bit another item has set
//   stops. A warp of points all equal, bit for bit, to an earlier warp's
//   of its tile (occlusion_leaders_kernel; the points of misses, the camera
//   position) sweeps nothing: the earlier warp's bit is its bit, written by
//   that warp's items. Within a tile the mask row is one, so this is exact
//   for any mask.
// Bound: FLOPS_REJECT a test to the first blocker of each tile's distinct
// points and a plane test's 20 more where the reject leaves it open,
// against 12 B in and 4 S B out a point: operations
// (chip_smoke.py::occlusion_bound).
//
// Bound of K5, K7d and K7a's primary sweep (chip_smoke.py::stl_bound):
// FLOPS_PRIMARY_CULL (32: the three sums at two corners, a sum and a
// product) a (tile, triangle) pair the tile decides and a (warp, triangle)
// pair of the tile's survivors the warp decides, FLOPS_PRIMARY_REJECT (17)
// a test of the warp's survivors by each of its valid rays, and a plane
// test's 20 more where the reject leaves the test open, against 12 + 8 B
// a ray and the table and mask read once. Before the cull K5 at 512^2 x
// 9,216 triangles did 2.42 G plane tests, 0.72 ms at 67 TFLOP/s. K7a's
// shadow tests that the reject decides cost its 18 operations (15 for the
// dot products, 3 products and sums; its comparisons count not at all),
// the others those and a plane test's 20: bound by operations.

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "plane_test.cuh"
#include "sweep_cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 128;
constexpr int kBlockRows = 10;  // n xyz | c2 xyz | c3 xyz | k0

// The ray of slot k (0..255) of tile `tile` in the masked kernels' tiles,
// row-major over tiles of th x (256 / th) rays of an H x W grid.
struct TileRay {
  int r;
  bool valid;
};

__device__ __forceinline__ TileRay tile_slot(int tile, int k, int H, int W,
                                             int th) {
  const int tw = kThreads / th;
  const int tiles_x = (W + tw - 1) / tw;
  const int y = (tile / tiles_x) * th + k / tw;
  const int x = (tile % tiles_x) * tw + k % tw;
  const bool valid = y < H && x < W;
  return {valid ? y * W + x : 0, valid};
}

// The ray of this thread: block b is tile b.
__device__ __forceinline__ TileRay tile_ray(int H, int W, int th) {
  return tile_slot(blockIdx.x, threadIdx.x, H, W, th);
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

// K4 reads the rays as (R, 3) rows; L2 (Planar, lab 2's one-step kernel)
// as the (3, R) planes of bench/megakernel_lab2.py's dirs_t. A warp takes
// sweep_ray's block of wh x (32 / wh) rays of the H x W grid (R = H W;
// H = 1, W = R, wh = 1: consecutive rays). Each block stages both blocks
// of the table triangle-major (thread k < C the camera's triangle k,
// thread 128 + k the light's), then each warp runs the culled primary
// sweep (warp_closest) and, from the hit position, the culled shadow sweep
// (warp_blocked). A lane past the grid takes part in the warp's votes
// only.
template <bool Planar>
__global__ void __launch_bounds__(kThreads)
    closest_hit_occluded_kernel(const float* __restrict__ dirs,
                                const float* __restrict__ table,
                                const float* __restrict__ cam,
                                const float* __restrict__ light, int C, int H,
                                int W, int wh, float* __restrict__ t_out,
                                int* __restrict__ idx_out,
                                int* __restrict__ occ_out) {
  static_assert(kThreads >= 2 * kSweepMaxTris && kMaxTris == kSweepMaxTris,
                "a thread stages each triangle of both blocks");
  __shared__ TriBlock s_pri, s_shw;
  __shared__ float s_org[6];
  const int k = threadIdx.x;
  if (k < C) stage_tri(s_pri, table, C, k);
  if (k >= kMaxTris && k - kMaxTris < C)
    stage_tri(s_shw, table + kBlockRows * C, C, k - kMaxTris);
  if (k < 3) s_org[k] = cam[k];
  else if (k < 6) s_org[k] = light[k - 3];
  __syncthreads();

  const size_t R = static_cast<size_t>(H) * W;
  const SweepRay ray = sweep_ray(H, W, wh);
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray.valid) {
    dx = Planar ? dirs[ray.r] : dirs[3 * ray.r];
    dy = Planar ? dirs[R + ray.r] : dirs[3 * ray.r + 1];
    dz = Planar ? dirs[2 * R + ray.r] : dirs[3 * ray.r + 2];
  }
  int best_i;
  const float best_t = warp_closest(s_pri, C, ray.valid, dx, dy, dz, &best_i);
  const bool hit = best_t < FLT_MAX;
  // Shadow ray from the light toward pos = cam + tz * d, unnormalized: its
  // parameter is the fraction of the light distance. A miss sweeps too,
  // with tz = 0 (the raw bit of JAX's K4).
  const float tz = hit ? best_t : 0.0f;
  const bool occ = warp_blocked(s_shw, C, ray.valid,
                                (s_org[0] + tz * dx) - s_org[3],
                                (s_org[1] + tz * dy) - s_org[4],
                                (s_org[2] + tz * dz) - s_org[5]);
  if (!ray.valid) return;
  t_out[ray.r] = best_t;
  idx_out[ray.r] = hit ? best_i : -1;
  occ_out[ray.r] = occ ? 1 : 0;
}

// The sweeps' cull probe (K4, L2 and K1), a warp a warp of sweep_ray's
// grid: for every triangle i < C of the table's two 10-row blocks (row
// stride C: the camera's, then the light's), the warp's primary decision
// (box_reject on its valid lanes' directions) and its shadow decision
// (box_reject<true> on their shadow rays, tz from the brute sweep,
// closest) to dec[(2 g + {0, 1}) C + i] for warp g, 1 where culled;
// counts[0] and [1] add the culled (warp, triangle) pairs of each sweep,
// counts[2] the valid lanes of primary-culled pairs whose plane_test is ok,
// counts[3] those of shadow-culled pairs whose test blocks (ok && t <
// 0.99): both 0.
__global__ void __launch_bounds__(kThreads)
    sweep_cull_probe_kernel(const float* __restrict__ dirs,
                            const float* __restrict__ table,
                            const float* __restrict__ cam,
                            const float* __restrict__ light, int C, int H,
                            int W, int wh, unsigned char* __restrict__ dec,
                            unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long s_n[4];
  if (threadIdx.x < 4) s_n[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const size_t g = static_cast<size_t>(blockIdx.x) * (kThreads / 32) +
                   (threadIdx.x >> 5);
  const SweepRay ray = sweep_ray(H, W, wh);
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray.valid) {
    dx = dirs[3 * ray.r];
    dy = dirs[3 * ray.r + 1];
    dz = dirs[3 * ray.r + 2];
  }
  float best_t;
  closest(table, C, dx, dy, dz, &best_t);
  const float tz = best_t < FLT_MAX ? best_t : 0.0f;
  const float ex = (cam[0] + tz * dx) - light[0];
  const float ey = (cam[1] + tz * dy) - light[1];
  const float ez = (cam[2] + tz * dz) - light[2];
  const DirBox pbox = warp_box(ray.valid, dx, dy, dz);
  const DirBox sbox = warp_box(ray.valid, ex, ey, ez);
  const float* shw = table + kBlockRows * C;
  unsigned char* out = dec + 2 * g * C;
  unsigned long long n[4] = {0, 0, 0, 0};
  for (int i = 0; i < C; ++i) {
    float4 a, b;
    float2 c;
    load_tri(table, C, i, &a, &b, &c);
    const bool p_rej = box_reject(pbox, a, b, c);
    load_tri(shw, C, i, &a, &b, &c);
    const bool s_rej = box_reject<true>(sbox, a, b, c);
    const PlaneHit pp = plane_test(table, C, i, dx, dy, dz);
    const PlaneHit ps = plane_test(shw, C, i, ex, ey, ez);
    if (lane == 0) {
      out[i] = p_rej;
      out[C + i] = s_rej;
      n[0] += p_rej;
      n[1] += s_rej;
    }
    n[2] += ray.valid && p_rej && pp.ok;
    n[3] += ray.valid && s_rej && ps.ok && ps.t < kShadowT;
  }
  for (int j = 0; j < 4; ++j)
    if (n[j] != 0) atomicAdd(&s_n[j], n[j]);
  __syncthreads();
  if (threadIdx.x < 4) atomicAdd(&counts[threadIdx.x], s_n[threadIdx.x]);
}

// ---------------------------------------------------------------------------
// K5, K7d and K7a: the culled primary sweep in runs of kept chunks folded
// in order (the exact reject and cull are sweep_cull.cuh's), K7a's packing
// of each tile's hit rays, then its shadow sweeps a warp a work item.

constexpr int kTileWarps = kThreads / 32;  // warps of a 256-ray tile

// The kept chunks of one keep-mask row (n columns; null: every chunk kept)
// with rank in [lo, hi) among the kept ones, in order: fn(c) for each,
// until fn returns false (warp-uniformly). Every lane of the warp calls it
// and sees the same chunks.
template <typename Fn>
__device__ __forceinline__ void for_kept_run(const int* __restrict__ keep,
                                             int n, int lo, int hi, Fn fn) {
  const int lane = threadIdx.x & 31;
  int rank = 0;
  for (int base = 0; base < n && rank < hi; base += 32) {
    unsigned bits = __ballot_sync(
        kFullMask,
        base + lane < n && (keep == nullptr || keep[base + lane] != 0));
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

// ---------------------------------------------------------------------------
// K5, K7d and K7a's primary half: the exact per-tile triangle cull
// (box_reject, sweep_cull.cuh).

// Survivors of a tile's cull a block stages at most, and kept chunks of a
// run it lists at once.
constexpr int kCullCap = 768;
constexpr int kListCap = 256;

// The warps' boxes of a tile: lo and hi, and any | finite << 1.
struct BoxSmem {
  float box[kTileWarps][6];
  int flags[kTileWarps];
};

struct CullSmem {
  float4 a[kCullCap];
  float4 b[kCullCap];
  float2 c[kCullCap];
  int tri[kCullCap];
  int list[kListCap];
  BoxSmem boxes;
  int warp_n[2][kTileWarps];
};

// Each warp's box to shared memory (lane 0), to be combined after a
// barrier by tile_box.
__device__ __forceinline__ void put_box(BoxSmem& sm, const DirBox& b) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sm.box[warp][k] = b.lo[k];
    sm.box[warp][3 + k] = b.hi[k];
  }
  sm.flags[warp] = (b.any ? 1 : 0) | (b.finite ? 2 : 0);
}

// The tile's box, the union of its warps' (put_box).
__device__ __forceinline__ DirBox tile_box(const BoxSmem& sm) {
  DirBox t;
  t.any = false;
  t.finite = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t.lo[k] = INFINITY;
    t.hi[k] = -INFINITY;
  }
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    t.any |= (sm.flags[w] & 1) != 0;
    t.finite &= (sm.flags[w] & 2) != 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t.lo[k] = fminf(t.lo[k], sm.box[w][k]);
      t.hi[k] = fmaxf(t.hi[k], sm.box[w][3 + k]);
    }
  }
  return t;
}

// One warp's sweep of the n survivors staged in sm, in triangle order: 32
// at a time, lane i decides survivor g + i against the warp's own box, and
// the warp then tests each that stays, every lane on its own ray (a
// broadcast read): the exact reject first, plane_test's verdict from the
// same sums where it leaves the test open, and `<=` (the last of equal t
// wins). A test culled or rejected is one whose ok is false: leaving it out
// moves idx only while t is still F32MAX, where idx ends as -1.
__device__ __forceinline__ void sweep_survivors(const CullSmem& sm, int n,
                                                const DirBox& wbox,
                                                bool valid, float dx,
                                                float dy, float dz,
                                                float* bt, int* bi) {
  if (!wbox.any) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < n; g += 32) {
    const int e = g + lane;
    const bool live = e < n && !box_reject(wbox, sm.a[e], sm.b[e], sm.c[e]);
    unsigned bits = __ballot_sync(kFullMask, live);
    while (bits != 0u) {
      const int j = g + __ffs(bits) - 1;
      bits &= bits - 1u;
      const float4 a = sm.a[j];
      float Dn, U, V;
      shadow_dots(a, sm.b[j], sm.c[j], dx, dy, dz, &Dn, &U, &V);
      if (valid && !primary_reject(Dn, U, V, a.w)) {
        const PlaneHit p = plane_from_dots(Dn, U, V, a.w);
        if (p.ok && p.t <= *bt) {
          *bt = p.t;
          *bi = sm.tri[j];
        }
      }
    }
  }
}

// Runs of a tile's k kept chunks with at most `run` chunks each: one where
// k <= run, else ceil(k / run); run j holds the chunks of rank [j run,
// j run + run).
__host__ __device__ __forceinline__ int tile_runs(int k, int run) {
  return k <= run ? 1 : (k + run - 1) / run;
}

// Where a tile of several runs leaves its runs' partial (t, idx), at
// [j R + r] for run j and ray r, and counts its finished runs (done[tile],
// zeroed before the launch).
struct RunFold {
  float* t_part;
  int* i_part;
  int* done;
};

// K5 (Masked false), K7d and K7a's primary sweep (true), a block a (tile,
// run j): the rays of tile blockIdx.x (tile_ray: th x (256 / th) rays of
// the H x W grid) against run j of the chunks the tile keeps (mask row
// blockIdx.x, stride mask_stride, its first Tp / C columns; K5 every chunk,
// one run): tile_runs' runs of at most `run` kept chunks, in order; a block
// past the tile's runs leaves at once. The block walks the run's triangles
// 256 a pass: each thread loads one (its 10 constants, coalesced) and
// decides it against the tile's box (box_reject); a ballot and a popc
// prefix over the warps append the survivors, in triangle order, to shared
// memory (triangle-major, 44 bytes each); once kCullCap - 256 or more are
// staged, and at the run's end, every warp sweeps them (sweep_survivors).
// One barrier a pass, two a sweep. A tile of one run writes each ray's
// best t and idx (-1 where t is F32MAX) to t_out, i_out. A tile of several
// leaves each run's in `fold` and counts it done; the block that finishes
// its tile's last run folds the runs of each ray in run order with `<=`
// (the sweep's own fold: the last index keeps winning ties, later runs
// holding later chunks) and writes t and idx: no second launch, and no
// partial for the tiles of one run.
template <bool Masked>
__global__ void __launch_bounds__(kThreads)
    closest_cull_kernel(const float* __restrict__ dirs,
                        const float* __restrict__ table, int Tp, int C,
                        const int* __restrict__ mask, int mask_stride, int H,
                        int W, int th, int run, RunFold fold,
                        float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ CullSmem sm;
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = Tp / C;
  const int* keep =
      Masked ? mask + static_cast<size_t>(blockIdx.x) * mask_stride : nullptr;
  const int k = Masked ? kept_count(keep, n_chunks) : n_chunks;
  const int runs = Masked ? tile_runs(k, run) : 1;
  if (static_cast<int>(blockIdx.y) >= runs) return;  // block-uniform
  const int lo = blockIdx.y * run;
  const int hi = runs == 1 ? k : min(k, lo + run);
  const TileRay ray = tile_ray(H, W, th);
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray.valid) {
    dx = dirs[3 * ray.r];
    dy = dirs[3 * ray.r + 1];
    dz = dirs[3 * ray.r + 2];
  }
  float bt = FLT_MAX;
  int bi = -1;
  const DirBox wbox = warp_box(ray.valid, dx, dy, dz);
  put_box(sm.boxes, wbox);
  __syncthreads();
  const DirBox tbox = tile_box(sm.boxes);
  int n = 0, par = 0;     // survivors staged; warp_n's half this pass
  int col = 0, rank = 0;  // Masked: the next mask column, kept chunks before
  // Block-uniform: a tile of no valid ray, or an empty run, sweeps nothing.
  for (bool more = tbox.any && lo < hi; more;) {
    // This window's triangles: Masked, the next kListCap - 31 or fewer of
    // the run's chunks, listed by every warp alike (warp 0 writes); else
    // the run's chunks [lo, hi) at once.
    int n_tri;
    if (Masked) {
      int n_list = 0;
      while (col < n_chunks && rank < hi && n_list + 32 <= kListCap) {
        const int cc = col + lane;
        const bool kept = cc < n_chunks && keep[cc] != 0;
        const unsigned bits = __ballot_sync(kFullMask, kept);
        const int r = rank + __popc(bits & ((1u << lane) - 1u));
        const int from = rank > lo ? rank : lo;
        if (warp == 0 && kept && r >= lo && r < hi)
          sm.list[n_list + r - from] = cc;
        const int to = rank + __popc(bits) < hi ? rank + __popc(bits) : hi;
        n_list += to > from ? to - from : 0;
        rank += __popc(bits);
        col += 32;
      }
      more = col < n_chunks && rank < hi;
      __syncthreads();  // the list is in
      n_tri = n_list * C;
    } else {
      more = false;
      n_tri = (hi - lo) * C;
    }
    for (int q0 = 0; q0 < n_tri; q0 += kThreads) {
      const int q = q0 + threadIdx.x;
      bool surv = false;
      float4 a, b;
      float2 c;
      int tri = 0;
      if (q < n_tri) {
        tri = Masked ? sm.list[q / C] * C + q % C : lo * C + q;
        load_tri(table, Tp, tri, &a, &b, &c);
        surv = !box_reject(tbox, a, b, c);
      }
      const unsigned bits = __ballot_sync(kFullMask, surv);
      if (lane == 0) sm.warp_n[par][warp] = __popc(bits);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kTileWarps; ++w) {
        const int m = sm.warp_n[par][w];
        before += w < warp ? m : 0;
        total += m;
      }
      if (surv) {
        const int at = n + before + __popc(bits & ((1u << lane) - 1u));
        sm.a[at] = a;
        sm.b[at] = b;
        sm.c[at] = c;
        sm.tri[at] = tri;
      }
      n += total;
      par ^= 1;
      if (n > kCullCap - kThreads || q0 + kThreads >= n_tri) {
        __syncthreads();  // the survivors are in
        sweep_survivors(sm, n, wbox, ray.valid, dx, dy, dz, &bt, &bi);
        __syncthreads();  // and read
        n = 0;
      }
    }
  }
  if (runs == 1) {
    if (ray.valid) {
      t_out[ray.r] = bt;
      i_out[ray.r] = bt < FLT_MAX ? bi : -1;
    }
    return;
  }
  const size_t R = static_cast<size_t>(H) * W;
  if (ray.valid) {
    fold.t_part[blockIdx.y * R + ray.r] = bt;
    fold.i_part[blockIdx.y * R + ray.r] = bi;
  }
  __threadfence();  // the partials are seen before the count
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&fold.done[blockIdx.x], 1) == runs - 1;
  __syncthreads();
  if (!s_last || !ray.valid) return;
  bt = FLT_MAX;
  bi = -1;
  for (int j = 0; j < runs; ++j) {
    const float tj = __ldcg(&fold.t_part[j * R + ray.r]);
    if (tj <= bt) {
      bt = tj;
      bi = __ldcg(&fold.i_part[j * R + ray.r]);
    }
  }
  t_out[ray.r] = bt;
  i_out[ray.r] = bt < FLT_MAX ? bi : -1;
}

// K7a's packing, a block a tile: the tile's hit rays (t < F32MAX) are
// packed in ray order: hits[tile * 256 + k] = (cam + t d, ray) for the
// k-th hit ray, n_hit[tile] their count, and the tile's warps of hit rays
// are appended to warp_list (tile * 8 + w, counted in counts[0]).
__global__ void __launch_bounds__(kThreads)
    k7a_pack_kernel(const float* __restrict__ dirs,
                    const float* __restrict__ cam, int H, int W, int th,
                    const float* __restrict__ t, float4* __restrict__ hits,
                    int* __restrict__ n_hit, int* __restrict__ warp_list,
                    int* __restrict__ counts) {
  __shared__ int s_warp[kTileWarps];
  const TileRay ray = tile_ray(H, W, th);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float bt = ray.valid ? t[ray.r] : FLT_MAX;
  const bool hit = bt < FLT_MAX;
  const unsigned ballot = __ballot_sync(kFullMask, hit);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kTileWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  if (hit) {
    const int at = before + __popc(ballot & ((1u << lane) - 1u));
    // The hit position as the JAX kernel forms it, cam + tz * d.
    hits[static_cast<size_t>(blockIdx.x) * kThreads + at] = make_float4(
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

// The cull's probe, a block a tile (tile_ray's tiles): for every triangle
// i of the block at `table` (10 rows, row stride Tp), the tile's and each
// warp's decision (box_reject) to dec[(tile 9 + g) Tp + i] (g 0: the
// tile, 1 + w: warp w), 1 where culled; counts[0] and [1] add the (tile,
// triangle) and (warp, triangle) pairs culled, counts[2] and [3] the valid
// lanes of those pairs whose plane_test on the table passes (ok): 0.
__global__ void __launch_bounds__(kThreads)
    primary_cull_probe_kernel(const float* __restrict__ dirs,
                              const float* __restrict__ table, int Tp, int H,
                              int W, int th, unsigned char* __restrict__ dec,
                              unsigned long long* __restrict__ counts) {
  __shared__ BoxSmem sm;
  __shared__ unsigned long long s_n[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TileRay ray = tile_ray(H, W, th);
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (ray.valid) {
    dx = dirs[3 * ray.r];
    dy = dirs[3 * ray.r + 1];
    dz = dirs[3 * ray.r + 2];
  }
  const DirBox wbox = warp_box(ray.valid, dx, dy, dz);
  put_box(sm, wbox);
  if (threadIdx.x < 4) s_n[threadIdx.x] = 0;
  __syncthreads();
  const DirBox tbox = tile_box(sm);
  unsigned long long n[4] = {0, 0, 0, 0};
  unsigned char* out = dec + static_cast<size_t>(blockIdx.x) * 9 * Tp;
  for (int i = 0; i < Tp; ++i) {
    float4 a, b;
    float2 c;
    load_tri(table, Tp, i, &a, &b, &c);
    const bool t_rej = box_reject(tbox, a, b, c);
    const bool w_rej = box_reject(wbox, a, b, c);
    const bool ok = ray.valid && plane_test(table, Tp, i, dx, dy, dz).ok;
    if (threadIdx.x == 0) {
      out[i] = t_rej;
      n[0] += t_rej;
    }
    if (lane == 0) {
      out[static_cast<size_t>(1 + warp) * Tp + i] = w_rej;
      n[1] += w_rej;
    }
    n[2] += t_rej && ok;
    n[3] += w_rej && ok;
  }
  for (int j = 0; j < 4; ++j)
    if (n[j] != 0) atomicAdd(&s_n[j], n[j]);
  __syncthreads();
  if (threadIdx.x < 4) atomicAdd(&counts[threadIdx.x], s_n[threadIdx.x]);
}

// The shadow blocks of the table, triangle-major, 48 bytes a triangle:
// tris[(s * Tp + i) * 3 + {0, 1, 2}] = (n, k0), (c2, c3.x), (c3.y, c3.z, 0,
// 0) of triangle i for source s, whose block is the table's block first + s
// (K6, K7a: 1, after the primary block; K7b, K7c: 0).
__global__ void k7a_pack_tris_kernel(const float* __restrict__ table, int Tp,
                                     int S, int first,
                                     float4* __restrict__ tris) {
  const size_t n = static_cast<size_t>(S) * Tp;
  for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       k < n; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t s = k / Tp, i = k % Tp;
    const float* blk = table + (first + s) * kBlockRows * Tp + i;
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
// K7b on one chunk stages its copy where it takes at most this many bytes,
// K6's rule (kernels/intersect.py::k6_staged: two blocks an SM).
constexpr long long kOccStagedBytes = 96 * 1024;

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

// The shadow sweeps of one thread's point (px, py, pz) toward each of the S
// sources in turn, over one chunk of C triangles (K6's and K7b's): source
// s's triangle-major constants at tri_all + 3 C s (in shared memory where
// kSmem), its table block at blocks + 10 C s. Each test takes the exact
// reject first and plane_test only where the reject leaves it open
// (shadow_group); a lane stops at its first blocker and the warp moves to
// the next source once no lane sweeps. A lane that is not `active` sweeps
// nothing (occ 0); a `valid` lane writes occ_out[s R + r] for each source.
// Every lane of the warp calls it (the warp's votes).
template <bool kSmem>
__device__ __forceinline__ void shadow_sources(
    const float4* __restrict__ tri_all, const float* __restrict__ blocks,
    int C, const float* __restrict__ src, int S, float px, float py,
    float pz, bool active, bool valid, int R, int r,
    int* __restrict__ occ_out) {
  for (int s = 0; s < S; ++s) {
    bool sweeping = active;
    int occ = 0;
    if (__any_sync(kFullMask, sweeping)) {
      const float ex = px - src[3 * s], ey = py - src[3 * s + 1],
                  ez = pz - src[3 * s + 2];
      const float4* tri = tri_all + static_cast<size_t>(s) * C * 3;
      const float* blk = blocks + static_cast<size_t>(s) * kBlockRows * C;
      for (int i0 = 0; i0 < C; i0 += 32) {
        const int i1 = i0 + 32 < C ? i0 + 32 : C;
        int g = i0;
        for (; g + kShadowGroup <= i1; g += kShadowGroup)
          shadow_group<kShadowGroup, kSmem>(tri, blk, C, g, ex, ey, ez,
                                            sweeping, &occ);
        for (; g + 8 <= i1; g += 8)
          shadow_group<8, kSmem>(tri, blk, C, g, ex, ey, ez, sweeping, &occ);
        for (; g < i1; ++g)
          shadow_group<1, kSmem>(tri, blk, C, g, ex, ey, ez, sweeping, &occ);
        if (!__any_sync(kFullMask, sweeping)) break;
      }
    }
    if (valid) occ_out[static_cast<size_t>(s) * R + r] = occ;
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
  shadow_sources<kStaged>(kStaged ? s_tris : tris, table + kBlockRows * C, C,
                          src, S, s_cam[0] + tz * dx, s_cam[1] + tz * dy,
                          s_cam[2] + tz * dz, hit, valid, R, r, occ_out);
}

// K7b on one chunk (the sharded renderer's scenes of at most 128
// triangles), K6's shadow half: a thread a point r < R, read once, swept
// toward the S sources in turn (shadow_sources) from k7a_pack_tris_kernel's
// copy of the table's S blocks, staged once a block in dynamic shared
// memory (kStaged) or read through the read-only cache. Every point sweeps,
// a miss's camera-origin point too, and writes its bit of each source's
// row of occ (S, R), coalesced.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    occlusion_points_kernel(const float* __restrict__ pos,
                            const float* __restrict__ table,
                            const float* __restrict__ src,
                            const float4* __restrict__ tris, int C, int S,
                            int R, int* __restrict__ occ_out) {
  extern __shared__ float4 s_tris[];
  if (kStaged) {
    for (int k = threadIdx.x; k < S * C * 3; k += kThreads)
      s_tris[k] = tris[k];
    __syncthreads();
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = r < R;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (valid) {
    px = pos[3 * r];
    py = pos[3 * r + 1];
    pz = pos[3 * r + 2];
  }
  shadow_sources<kStaged>(kStaged ? s_tris : tris, table, C, src, S, px, py,
                          pz, valid, valid, R, r, occ_out);
}

// One lane's shadow sweep over chunk c of a source (triangles [c C, c C + C)
// of its triangle-major copy `tri`, through the read-only cache, and of its
// table block `blk`, row stride Tp), 32 triangles at a time in groups of
// 16, 8 and 1, to its first blocker: false once no lane of the warp sweeps.
__device__ __forceinline__ bool shadow_chunk(const float4* __restrict__ tri,
                                             const float* __restrict__ blk,
                                             int Tp, int C, int c, float ex,
                                             float ey, float ez,
                                             bool& sweeping, int* occ) {
  const int end = (c + 1) * C;
  for (int i0 = c * C; i0 < end; i0 += 32) {
    const int i1 = i0 + 32 < end ? i0 + 32 : end;
    int g = i0;
    for (; g + kShadowGroup <= i1; g += kShadowGroup)
      shadow_group<kShadowGroup>(tri, blk, Tp, g, ex, ey, ez, sweeping, occ);
    for (; g + 8 <= i1; g += 8)
      shadow_group<8>(tri, blk, Tp, g, ex, ey, ez, sweeping, occ);
    for (; g < i1; ++g)
      shadow_group<1>(tri, blk, Tp, g, ex, ey, ez, sweeping, occ);
    if (!__any_sync(kFullMask, sweeping)) return false;
  }
  return true;
}

// Where the shadow work items find their points and chunks.
// K7a (kTilePoints false): the packed hit rays of each tile (hits, n_hit)
// and the list of the tiles' warps of them (warp_list, counted in
// counts[0]); item hw + n_hw (j + runs s) is warp hw's rays toward source
// s over run j of `runs` (run_edge) of the tile's kept chunks for s (mask
// row stride (1 + S) n_chunks, source s's columns from (1 + s) n_chunks).
// K7b and K7c (true): the points pos (R = H W, 3) on the tiles of th x
// (256 / th); (tile, source) pair p = tile S + s is the mask's row p of
// n_chunks columns (null: every chunk kept), nk[p] its kept chunks
// (occlusion_plan_kernel), and its runs of `run` kept chunks: run j is the
// chunks of rank [j run, j run + run). Item (j n_pairs + p) 8 + w is warp w
// of the tile's points on run j of pair p (run-major: every pair's first
// runs come first); an item past the pair's last run is empty. A lane
// whose bit another item has already set stops (exact: the bits OR). A
// warp whose points all equal an earlier warp's of the same tile, bit for
// bit (lead, occlusion_leaders_kernel: a miss's camera-origin point, most
// often), sweeps nothing: its leader writes its bits.
struct ShadowItems {
  const float4* hits;
  const int* n_hit;
  const int* warp_list;
  int runs;
  const float* pos;
  const int* nk;
  const int* lead;
  int n_pairs, max_runs;
  int H, W, th;
  int run;
};

// Shadow sweeps a warp a work item (ShadowItems), the items taken in turn
// from counts[1] by persistent warps (K7a's shadow half; K7b over several
// chunks; K7c). Each lane takes one point, sweeps the item's chunks from
// the triangle-major copy (warp-uniform loads through the read-only cache)
// with the reject first and plane_test on the table (source s's block is
// the table's first + s) where it does not decide, and stops at its first
// blocker; the warp leaves the item once no lane sweeps. A blocked point
// writes occ = 1 over the zeroed output: the runs' bits OR in any order.
template <bool kTilePoints>
__global__ void __launch_bounds__(kThreads, kShadowMinBlocks)
    shadow_items_kernel(const float4* __restrict__ tris,
                        const float* __restrict__ table, int Tp, int C,
                        int first, const float* __restrict__ src, int S,
                        const int* __restrict__ mask, int R, ShadowItems w,
                        int* __restrict__ counts, int* __restrict__ occ_out) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = Tp / C;
  const long long n_items =
      kTilePoints ? static_cast<long long>(w.max_runs) * w.n_pairs * kTileWarps
                  : static_cast<long long>(counts[0]) * S * w.runs;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(&counts[1], 1);
    item = __shfl_sync(kFullMask, item, 0);
    if (item >= n_items) return;
    int s, lo, hi, r = 0, tile = 0, cover = 0;
    const int* keep;
    bool sweeping;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (kTilePoints) {
      const int q = item / kTileWarps;
      const int p = q % w.n_pairs;
      lo = (q / w.n_pairs) * w.run;
      if (lo >= (mask == nullptr ? n_chunks : w.nk[p])) continue;  // empty
      tile = p / S;
      const int wi = item % kTileWarps;
      const int ld = w.lead[tile * kTileWarps + wi];
      if ((ld & 0xff) != wi) continue;  // a follower: its leader sweeps
      cover = (ld >> 8) & ~(1 << wi);
      hi = lo + w.run;
      s = p % S;
      keep = mask == nullptr ? nullptr
                             : mask + static_cast<size_t>(p) * n_chunks;
      const TileRay tr = tile_slot(tile, wi * 32 + lane, w.H, w.W, w.th);
      sweeping = tr.valid;
      if (sweeping) {
        r = tr.r;
        px = w.pos[3 * r];
        py = w.pos[3 * r + 1];
        pz = w.pos[3 * r + 2];
      }
    } else {
      const int n_hw = counts[0];
      const int hw = item % n_hw, q = item / n_hw;
      const int j = q % w.runs;
      s = q / w.runs;
      const int tile = w.warp_list[hw] / kTileWarps;
      const int slot = (w.warp_list[hw] % kTileWarps) * 32 + lane;
      sweeping = slot < w.n_hit[tile];
      if (sweeping) {
        const float4 h = w.hits[static_cast<size_t>(tile) * kThreads + slot];
        px = h.x;
        py = h.y;
        pz = h.z;
        r = __float_as_int(h.w);
      }
      keep = mask + static_cast<size_t>(tile) * (1 + S) * n_chunks +
             static_cast<size_t>(1 + s) * n_chunks;
      const int k = kept_count(keep, n_chunks);
      lo = run_edge(k, j, w.runs);
      hi = run_edge(k, j + 1, w.runs);
    }
    const float ex = px - src[3 * s], ey = py - src[3 * s + 1],
                ez = pz - src[3 * s + 2];
    const float4* tri = tris + static_cast<size_t>(s) * Tp * 3;
    const float* blk =
        table + static_cast<size_t>(first + s) * kBlockRows * Tp;
    int* occ = occ_out + static_cast<size_t>(s) * R + r;
    // K7b/K7c: the lane's bit as another item may have set it, read from
    // L2 a chunk ahead of its use.
    int seen = kTilePoints && sweeping ? __ldcg(occ) : 0;
    const bool swept = sweeping;
    bool by_seen = false;
    for_kept_run(keep, n_chunks, lo, hi, [&](int c) {
      if (kTilePoints) {
        if (seen != 0) {
          sweeping = false;
          by_seen = true;
        }
        seen = sweeping ? __ldcg(occ) : 0;
      }
      return shadow_chunk(tri, blk, Tp, C, c, ex, ey, ez, sweeping, occ);
    });
    // A leader's points are one point: lane 0's bit, if this item set it,
    // goes to its followers' points.
    if (kTilePoints && cover != 0 &&
        __shfl_sync(kFullMask, swept && !sweeping && !by_seen, 0)) {
      for (int f = 0; f < kTileWarps; ++f) {
        if ((cover >> f & 1) == 0) continue;
        const TileRay tf = tile_slot(tile, f * 32 + lane, w.H, w.W, w.th);
        if (tf.valid) occ_out[static_cast<size_t>(s) * R + tf.r] = 1;
      }
    }
  }
}

// K7b's (several chunks) and K7c's warps of equal points, block b tile b
// of the tiles of th x (256 / th) points pos (H W, 3): warp w is uniform
// where its lane 0's point is valid and every valid point of it equals
// that point bit for bit. A uniform warp's leader is the tile's first
// uniform warp with the same point, any other warp its own: lead[8 b + w]
// = its leader | (the warps it leads, itself included, as bits) << 8.
__global__ void __launch_bounds__(kThreads)
    occlusion_leaders_kernel(const float* __restrict__ pos, int H, int W,
                             int th, int* __restrict__ lead) {
  __shared__ int s_pt[kTileWarps][3];
  __shared__ int s_uni[kTileWarps];
  __shared__ int s_lead[kTileWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TileRay tr = tile_ray(H, W, th);
  int x = 0, y = 0, z = 0;
  if (tr.valid) {
    x = __float_as_int(pos[3 * tr.r]);
    y = __float_as_int(pos[3 * tr.r + 1]);
    z = __float_as_int(pos[3 * tr.r + 2]);
  }
  const int x0 = __shfl_sync(kFullMask, x, 0);
  const int y0 = __shfl_sync(kFullMask, y, 0);
  const int z0 = __shfl_sync(kFullMask, z, 0);
  const bool v0 = __shfl_sync(kFullMask, tr.valid, 0);
  const bool uni = __all_sync(
      kFullMask, !tr.valid || (x == x0 && y == y0 && z == z0));
  if (lane == 0) {
    s_uni[warp] = v0 && uni;
    s_pt[warp][0] = x0;
    s_pt[warp][1] = y0;
    s_pt[warp][2] = z0;
  }
  __syncthreads();
  if (threadIdx.x < kTileWarps) {
    const int wi = threadIdx.x;
    int leader = wi;
    for (int v = 0; v < wi && s_uni[wi]; ++v) {
      if (s_uni[v] && s_pt[v][0] == s_pt[wi][0] &&
          s_pt[v][1] == s_pt[wi][1] && s_pt[v][2] == s_pt[wi][2]) {
        leader = v;
        break;
      }
    }
    s_lead[wi] = leader;
  }
  __syncthreads();
  if (threadIdx.x < kTileWarps) {
    const int wi = threadIdx.x;
    int led = 0;
    for (int v = 0; v < kTileWarps; ++v) led |= (s_lead[v] == wi) << v;
    lead[blockIdx.x * kTileWarps + wi] = s_lead[wi] | (led << 8);
  }
}

// K7c's plan, a warp a (tile, source) pair p < n_pairs (the mask's row p
// of n_chunks columns): its kept chunks' count into nk[p].
__global__ void __launch_bounds__(kThreads)
    occlusion_plan_kernel(const int* __restrict__ mask, int n_pairs,
                          int n_chunks, int* __restrict__ nk) {
  const long long p =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (p >= n_pairs) return;  // the same for the warp
  const int k = kept_count(mask + p * n_chunks, n_chunks);
  if ((threadIdx.x & 31) == 0) nk[p] = k;
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

}  // namespace

// dirs (R, 3) (planar 0: K4) or (3, R) (planar 1: L2), table (20, C),
// cam (3,), light (3,) float32 device pointers, the rays a row-major H x W
// grid (R = H W) swept in warps of wh x (32 / wh) rays (H = 1, W = R,
// wh = 1: 32 consecutive rays); t (R,) float32, idx (R,) int32 and occ
// (R,) int32 outputs. Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int raytpu_closest_hit_occluded(const void* dirs, const void* table,
                                           const void* cam, const void* light,
                                           int C, int H, int W, int wh,
                                           int planar, void* t, void* idx,
                                           void* occ, void* stream) {
  const long long blocks = sweep_blocks(C, H, W, wh, kThreads);
  if (blocks < 0 || (planar != 0 && planar != 1))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  auto kernel = planar ? closest_hit_occluded_kernel<true>
                       : closest_hit_occluded_kernel<false>;
  kernel<<<static_cast<int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table),
      static_cast<const float*>(cam), static_cast<const float*>(light), C, H,
      W, wh, static_cast<float*>(t), static_cast<int*>(idx),
      static_cast<int*>(occ));
  return (int)cudaGetLastError();
}

// dirs (R = H W, 3), table (at least 20 rows, C columns: the camera's and
// the light's 10-row blocks), cam (3,), light (3,) float32 device
// pointers; dec (n_blocks 8, 2, C) uint8 and counts (4,) int64 outputs,
// counts zeroed by the caller: sweep_cull_probe_kernel on sweep_ray's
// warps. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_sweep_cull_probe(const void* dirs, const void* table,
                                       const void* cam, const void* light,
                                       int C, int H, int W, int wh,
                                       void* dec, void* counts,
                                       void* stream) {
  const long long blocks = sweep_blocks(C, H, W, wh, kThreads);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  sweep_cull_probe_kernel<<<static_cast<int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table),
      static_cast<const float*>(cam), static_cast<const float*>(light), C, H,
      W, wh, static_cast<unsigned char*>(dec),
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// Launches k7a_pack_tris_kernel on the S blocks of `table` from block
// `first` on, into tris (S Tp 48 bytes).
static cudaError_t pack_tris(const float* table, int Tp, int S, int first,
                             float4* tris, cudaStream_t st) {
  const size_t blocks = (static_cast<size_t>(S) * Tp + kThreads - 1) /
                        kThreads;
  k7a_pack_tris_kernel<<<static_cast<int>(blocks < 65535 ? blocks : 65535),
                         kThreads, 0, st>>>(table, Tp, S, first, tris);
  return cudaGetLastError();
}

// Devices whose per-device launch settings the entry points keep.
constexpr int kMaxDevices = 64;

// The persistent grid of shadow_items_kernel<kTilePoints>: as many blocks as
// fit on the card at once, worked out on a device's first call and kept.
template <bool kTilePoints>
static cudaError_t persistent_blocks(int* blocks) {
  static int kept[kMaxDevices];  // 0: not yet worked out
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < kMaxDevices && kept[dev] > 0) {
    *blocks = kept[dev];
    return cudaSuccess;
  }
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, shadow_items_kernel<kTilePoints>, kThreads, 0)) !=
          cudaSuccess)
    return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) kept[dev] = *blocks;
  return cudaSuccess;
}

// Lets occlusion_points_kernel<true> take kOccStagedBytes of dynamic shared
// memory, once a device.
static cudaError_t occ_staged_limit() {
  static bool set[kMaxDevices];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < kMaxDevices && set[dev]) return cudaSuccess;
  if ((err = cudaFuncSetAttribute(
           occlusion_points_kernel<true>,
           cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(kOccStagedBytes))) != cudaSuccess)
    return err;
  if (dev < kMaxDevices) set[dev] = true;
  return cudaSuccess;
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
  cudaError_t err = pack_tris(tab, C, S, 1, tr, st);
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

static size_t align16(size_t n) { return (n + 15) / 16 * 16; }

static int k7a_tiles(int H, int W, int th) {
  const int tw = kThreads / th;
  return ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

static bool closest_shapes_ok(int Tp, int C, int H, int W, int th,
                              int run) {
  return C >= 1 && C <= kMaxTris && Tp >= C && Tp % C == 0 && H >= 0 &&
         W >= 0 && th >= 1 && kThreads % th == 0 && run >= 1 &&
         tile_runs(Tp / C, run) <= 65535;
}

// The fold's part of a scratch from `base` on (16-byte aligned parts): the
// partials of a tile's runs (runs R each of t and of idx, runs the most a
// tile of Tp / C chunks takes) and the tiles' counts of finished runs;
// none where no tile takes two runs. Returns the bytes it takes.
static size_t run_fold(void* base, int Tp, int C, int R, int n_tiles,
                       int run, RunFold* fold) {
  const int runs = tile_runs(Tp / C, run);
  *fold = RunFold{nullptr, nullptr, nullptr};
  if (runs == 1) return 0;
  const size_t part = static_cast<size_t>(runs) * R;
  char* p = static_cast<char*>(base);
  const size_t t_bytes = align16(part * sizeof(float));
  const size_t i_bytes = align16(part * sizeof(int));
  if (p != nullptr) {
    fold->t_part = reinterpret_cast<float*>(p);
    fold->i_part = reinterpret_cast<int*>(p + t_bytes);
    fold->done = reinterpret_cast<int*>(p + t_bytes + i_bytes);
  }
  return t_bytes + i_bytes + align16(n_tiles * sizeof(int));
}

// The bytes of K5's or K7d's scratch (the fold's, K7d's tiles cut into runs
// of at most `run` kept chunks), -1 where refused.
extern "C" long long raytpu_closest_hit_scratch(int Tp, int C, int H, int W,
                                                int th, int masked,
                                                int run) {
  if (!closest_shapes_ok(Tp, C, H, W, th, run)) return -1;
  if (masked == 0) return 0;
  RunFold fold;
  return static_cast<long long>(
      run_fold(nullptr, Tp, C, H * W, k7a_tiles(H, W, th), run, &fold));
}

// dirs (R = H * W, 3) and table (10, Tp) float32 device pointers, Tp a
// multiple of the chunk C <= 128; mask null (K5: every chunk, tiles of 256
// consecutive rays, pass H = 1, W = R, th = 1) or the (n_tiles, Tp / C)
// int32 keep-mask over the tiles of th x (256 / th) rays of the H x W grid
// (K7d); t (R,) float32 and idx (R,) int32 outputs. K5 sweeps a tile in one
// block; K7d cuts each tile's kept chunks into runs of at most `run`
// (closest_cull_kernel), a block each, folded in the kernel with the
// scratch (scratch_bytes, at least what raytpu_closest_hit_scratch gives).
// Launches on `stream` and returns the first launch error.
extern "C" int raytpu_closest_hit(const void* dirs, const void* table, int Tp,
                                  int C, const void* mask, int H, int W,
                                  int th, int run, void* scratch,
                                  long long scratch_bytes, void* t, void* idx,
                                  void* stream) {
  const long long need = raytpu_closest_hit_scratch(Tp, C, H, W, th,
                                                    mask != nullptr, run);
  if (need < 0 || (need > 0 && (scratch == nullptr || scratch_bytes < need)))
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const int n_tiles = k7a_tiles(H, W, th);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dirs);
  const float* tab = static_cast<const float*>(table);
  float* to = static_cast<float*>(t);
  int* io = static_cast<int*>(idx);
  if (mask == nullptr) {
    closest_cull_kernel<false><<<n_tiles, kThreads, 0, s>>>(
        d, tab, Tp, C, nullptr, 0, H, W, th, Tp / C, RunFold{}, to, io);
    return (int)cudaGetLastError();
  }
  RunFold fold;
  run_fold(scratch, Tp, C, H * W, n_tiles, run, &fold);
  cudaError_t err;
  if (fold.done != nullptr &&
      (err = cudaMemsetAsync(fold.done, 0, n_tiles * sizeof(int), s)) !=
          cudaSuccess)
    return (int)err;
  closest_cull_kernel<true>
      <<<dim3(n_tiles, tile_runs(Tp / C, run)), kThreads, 0, s>>>(
          d, tab, Tp, C, static_cast<const int*>(mask), Tp / C, H, W, th,
          run, fold, to, io);
  return (int)cudaGetLastError();
}

// dirs (R = H * W, 3) and table (10, Tp) float32 device pointers; dec
// (n_tiles, 9, Tp) uint8 and counts (4,) int64 outputs, counts zeroed by
// the caller: primary_cull_probe_kernel on the tiles of th x (256 / th)
// rays of the H x W grid (H = 1, W = R, th = 1: K5's). Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_primary_cull_probe(const void* dirs, const void* table,
                                         int Tp, int H, int W, int th,
                                         void* dec, void* counts,
                                         void* stream) {
  if (!closest_shapes_ok(Tp, 1, H, W, th, 1))
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  primary_cull_probe_kernel<<<k7a_tiles(H, W, th), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirs), static_cast<const float*>(table), Tp,
      H, W, th, static_cast<unsigned char*>(dec),
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// K7a's scratch, carved from one buffer in this order, each part aligned to
// 16 bytes: the triangle-major shadow constants (S Tp triangles of 48
// bytes), the packed hits (n_tiles 256 float4), n_hit (n_tiles), warp_list
// (n_tiles 8), counts (4 ints: warps of hit rays, next work item), and
// the primary sweep's fold of its runs of at most pri_run kept chunks
// (run_fold). `bytes` is the total.
struct K7aScratch {
  float4* tris;
  float4* hits;
  int* n_hit;
  int* warp_list;
  int* counts;
  RunFold fold;
  size_t bytes;
};

static K7aScratch k7a_scratch(void* base, int Tp, int C, int S, int R,
                              int n_tiles, int pri_run) {
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
  sc.hits = reinterpret_cast<float4*>(
      take(static_cast<size_t>(n_tiles) * kThreads * sizeof(float4)));
  sc.n_hit = reinterpret_cast<int*>(take(n_tiles * sizeof(int)));
  sc.warp_list =
      reinterpret_cast<int*>(take(n_tiles * kTileWarps * sizeof(int)));
  sc.counts = reinterpret_cast<int*>(take(4 * sizeof(int)));
  at += run_fold(base == nullptr ? nullptr : reinterpret_cast<void*>(p + at),
                 Tp, C, R, n_tiles, pri_run, &sc.fold);
  sc.bytes = at;
  return sc;
}

static bool k7a_shapes_ok(int Tp, int C, int S, int H, int W, int th,
                          int pri_run) {
  return closest_shapes_ok(Tp, C, H, W, th, pri_run) && S >= 1;
}

// The bytes of K7a's scratch for these shapes, or -1 if K7a refuses them.
extern "C" long long raytpu_closest_hit_occluded_masked_scratch(
    int Tp, int C, int S, int H, int W, int th, int pri_run) {
  if (!k7a_shapes_ok(Tp, C, S, H, W, th, pri_run)) return -1;
  return static_cast<long long>(
      k7a_scratch(nullptr, Tp, C, S, H * W, k7a_tiles(H, W, th), pri_run)
          .bytes);
}

// dirs (R = H * W, 3), table ((1 + S) * 10, Tp), cam (3,), src (S, 3)
// float32 device pointers, Tp a multiple of the chunk C <= 128; mask the
// (n_tiles, (1 + S) * Tp / C) int32 keep-mask over the tiles of
// th x (256 / th) rays of the H x W grid; t (R,) float32, idx (R,) int32
// and occ (S, R) int32 outputs; scratch (scratch_bytes, at least what
// raytpu_closest_hit_occluded_masked_scratch gives). pri_run cuts each
// tile's kept primary chunks into runs of at most that many (K7d's), and
// shw_runs each (tile, source)'s kept shadow chunks into that many runs.
// phases: 1 the primary sweep and packing (t, idx and the scratch's hits);
// 2 the shadow sweeps (occ, from the hits a phase 1 left in the same
// scratch); 3 both, K7a. Launches on `stream`, never synchronises, and
// returns the first launch error.
extern "C" int raytpu_closest_hit_occluded_masked(
    const void* dirs, const void* table, int Tp, int C, const void* cam,
    const void* src, int S, const void* mask, int H, int W, int th, void* t,
    void* idx, void* occ, void* scratch, long long scratch_bytes,
    int pri_run, int shw_runs, int phases, void* stream) {
  if (!k7a_shapes_ok(Tp, C, S, H, W, th, pri_run) || mask == nullptr ||
      shw_runs < 1 || phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const int n_tiles = k7a_tiles(H, W, th);
  const int R = H * W;
  const K7aScratch sc =
      k7a_scratch(scratch, Tp, C, S, R, n_tiles, pri_run);
  if (scratch == nullptr || scratch_bytes < (long long)sc.bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dirs);
  const float* tab = static_cast<const float*>(table);
  const int* msk = static_cast<const int*>(mask);
  cudaError_t err;
  if (phases & 1) {
    if ((err = cudaMemsetAsync(sc.counts, 0, sizeof(int), st)) !=
            cudaSuccess ||
        (sc.fold.done != nullptr &&
         (err = cudaMemsetAsync(sc.fold.done, 0, n_tiles * sizeof(int),
                                st)) != cudaSuccess))
      return (int)err;
    closest_cull_kernel<true>
        <<<dim3(n_tiles, tile_runs(Tp / C, pri_run)), kThreads, 0, st>>>(
            d, tab, Tp, C, msk, (1 + S) * (Tp / C), H, W, th, pri_run,
            sc.fold, static_cast<float*>(t), static_cast<int*>(idx));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k7a_pack_kernel<<<n_tiles, kThreads, 0, st>>>(
        d, static_cast<const float*>(cam), H, W, th,
        static_cast<const float*>(t), sc.hits, sc.n_hit, sc.warp_list,
        sc.counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    if ((err = cudaMemsetAsync(occ, 0, static_cast<size_t>(S) * R * 4,
                               st)) != cudaSuccess ||
        (err = cudaMemsetAsync(sc.counts + 1, 0, sizeof(int), st)) !=
            cudaSuccess)
      return (int)err;
    int blocks = 0;
    if ((err = pack_tris(tab, Tp, S, 1, sc.tris, st)) != cudaSuccess ||
        (err = persistent_blocks<false>(&blocks)) != cudaSuccess)
      return (int)err;
    ShadowItems w{};
    w.hits = sc.hits;
    w.n_hit = sc.n_hit;
    w.warp_list = sc.warp_list;
    w.runs = shw_runs;
    shadow_items_kernel<false><<<blocks, kThreads, 0, st>>>(
        sc.tris, tab, Tp, C, 1, static_cast<const float*>(src), S, msk, R, w,
        sc.counts, static_cast<int*>(occ));
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

// K7b's and K7c's scratch, carved from one buffer in this order, each part
// aligned to 16 bytes: the triangle-major copy of the S sources' blocks (S
// Tp triangles of 48 bytes); on the items route the plan's kept counts
// (n_tiles S ints), the warps' leaders (n_tiles 8 ints) and counts (4
// ints; counts[1] the next work item). `bytes` is the total.
struct OccScratch {
  float4* tris;
  int* nk;
  int* lead;
  int* counts;
  size_t bytes;
};

static OccScratch occ_scratch(void* base, int Tp, int S, int n_tiles,
                              bool items) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  size_t at = 0;
  auto take = [&](size_t n) {
    const uintptr_t q = p + at;
    at += align16(n);
    return q;
  };
  OccScratch sc{};
  sc.tris = reinterpret_cast<float4*>(
      take(static_cast<size_t>(S) * Tp * 3 * sizeof(float4)));
  if (items) {
    sc.nk = reinterpret_cast<int*>(
        take(static_cast<size_t>(n_tiles) * S * sizeof(int)));
    sc.lead = reinterpret_cast<int*>(
        take(static_cast<size_t>(n_tiles) * kTileWarps * sizeof(int)));
    sc.counts = reinterpret_cast<int*>(take(4 * sizeof(int)));
  }
  sc.bytes = at;
  return sc;
}

// The runs of `run` chunks a (tile, source) pair has at most.
static int occ_max_runs(int Tp, int C, int run) {
  return (Tp / C + run - 1) / run;
}

// The work items (a warp of a tile, a run of a pair) fit the kernel's int
// counter.
static bool occ_shapes_ok(int Tp, int C, int S, int H, int W, int th,
                          int run) {
  return C >= 1 && C <= kMaxTris && Tp >= C && Tp % C == 0 && S >= 1 &&
         H >= 0 && W >= 0 && th >= 1 && kThreads % th == 0 && run >= 1 &&
         static_cast<long long>(k7a_tiles(H, W, th)) * S *
                 occ_max_runs(Tp, C, run) * kTileWarps <
             (1LL << 31);
}

// K7b takes one chunk of its own (the sharded renderer's scenes of at most
// 128 triangles), every other call the items route.
static bool occ_items_route(int Tp, int C, bool masked) {
  return masked || Tp > C;
}

// The bytes of K7b's (masked 0) or K7c's scratch for these shapes (the
// tiles as raytpu_occlusion_points takes them), or -1 if it refuses them.
extern "C" long long raytpu_occlusion_points_scratch(int Tp, int C, int S,
                                                     int H, int W, int th,
                                                     int masked, int run) {
  if (!occ_shapes_ok(Tp, C, S, H, W, th, run)) return -1;
  return static_cast<long long>(
      occ_scratch(nullptr, Tp, S, k7a_tiles(H, W, th),
                  occ_items_route(Tp, C, masked != 0))
          .bytes);
}

// pos (R = H * W, 3), table (S * 10, Tp), src (S, 3) float32 device
// pointers, Tp a multiple of the chunk C <= 128; mask null (K7b: tiles of
// 256 consecutive points, pass H = 1, W = R, th = 1) or the (n_tiles, S *
// Tp / C) int32 keep-mask over the tiles of th x (256 / th) points of the
// H x W grid (K7c); occ (S, R) int32 output; scratch (scratch_bytes, at
// least what raytpu_occlusion_points_scratch gives). K7b on one chunk
// (Tp = C) launches the copy of the sources' blocks and
// occlusion_points_kernel, the copy staged in shared memory where its S C
// 48 bytes are at most kOccStagedBytes, else read through the cache. Every
// other call zeroes occ, copies the blocks, counts each (tile, source)'s
// kept chunks (K7c: occlusion_plan_kernel; K7b: every chunk), finds the
// warps of equal points (occlusion_leaders_kernel) and sweeps the runs of
// `run` in work items (shadow_items_kernel<true>). Launches on
// `stream`, never synchronises, and returns the first launch error.
extern "C" int raytpu_occlusion_points(const void* pos, const void* table,
                                       int Tp, int C, const void* src, int S,
                                       const void* mask, int H, int W, int th,
                                       void* occ, void* scratch,
                                       long long scratch_bytes, int run,
                                       void* stream) {
  if (!occ_shapes_ok(Tp, C, S, H, W, th, run))
    return (int)cudaErrorInvalidValue;
  const bool items = occ_items_route(Tp, C, mask != nullptr);
  const int n_tiles = k7a_tiles(H, W, th);
  const OccScratch sc = occ_scratch(scratch, Tp, S, n_tiles, items);
  if (scratch == nullptr || scratch_bytes < (long long)sc.bytes)
    return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const int R = H * W;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* tab = static_cast<const float*>(table);
  const float* sp = static_cast<const float*>(src);
  const int* msk = static_cast<const int*>(mask);
  int* o = static_cast<int*>(occ);
  cudaError_t err;
  if (!items) {
    if ((err = pack_tris(tab, C, S, 0, sc.tris, st)) != cudaSuccess)
      return (int)err;
    const int blocks = (R + kThreads - 1) / kThreads;
    const long long tri_bytes = 48LL * S * C;
    if (tri_bytes <= kOccStagedBytes) {
      if ((err = occ_staged_limit()) != cudaSuccess) return (int)err;
      occlusion_points_kernel<true><<<blocks, kThreads,
                                      static_cast<int>(tri_bytes), st>>>(
          p, tab, sp, sc.tris, C, S, R, o);
    } else {
      occlusion_points_kernel<false><<<blocks, kThreads, 0, st>>>(
          p, tab, sp, sc.tris, C, S, R, o);
    }
    return (int)cudaGetLastError();
  }
  const int n_pairs = n_tiles * S;
  int blocks = 0;
  if ((err = cudaMemsetAsync(o, 0, static_cast<size_t>(S) * R * 4, st)) !=
          cudaSuccess ||
      (err = cudaMemsetAsync(sc.counts, 0, 4 * sizeof(int), st)) !=
          cudaSuccess ||
      (err = pack_tris(tab, Tp, S, 0, sc.tris, st)) != cudaSuccess ||
      (err = persistent_blocks<true>(&blocks)) != cudaSuccess)
    return (int)err;
  if (msk != nullptr) {
    occlusion_plan_kernel<<<(n_pairs + kTileWarps - 1) / kTileWarps,
                            kThreads, 0, st>>>(msk, n_pairs, Tp / C, sc.nk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  occlusion_leaders_kernel<<<n_tiles, kThreads, 0, st>>>(p, H, W, th,
                                                         sc.lead);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ShadowItems w{};
  w.pos = p;
  w.nk = sc.nk;
  w.lead = sc.lead;
  w.n_pairs = n_pairs;
  w.max_runs = occ_max_runs(Tp, C, run);
  w.H = H;
  w.W = W;
  w.th = th;
  w.run = run;
  shadow_items_kernel<true><<<blocks, kThreads, 0, st>>>(
      sc.tris, tab, Tp, C, 0, sp, S, msk, R, w, sc.counts, o);
  return (int)cudaGetLastError();
}
