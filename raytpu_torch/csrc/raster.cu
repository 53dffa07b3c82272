// The hard rasterizer's winner search for Hopper (sm_90a): K8b, K8c and
// K8a.
//
// K8b, raster_winner_kernel, replaces
// raytpu/kernels/raster_pallas.py::_kernel_blk8 (launched by
// resolve_winner_pallas for one triangle chunk, the Cornell box): per pixel,
// the first triangle with the largest covered zpx over T <= 128 triangles.
//
// K8c, raster_winner_chunked_kernel<true>, replaces
// raster_pallas.py::_kernel_masked (launched by resolve_winner_pallas for
// several chunks with screen_verts, STL scale): the same search over chunks
// of `chunk` <= 128 triangles, each chunk skipped where a (pixel tile,
// chunk) keep-mask bit is 0 (kernels/raster.py::chunk_screen_mask,
// conservative, so the winners are those of the unmasked search).
//
// K8a, raster_winner_chunked_kernel<false>, replaces raster_pallas.py::
// _kernel (launched at :397 by resolve_winner_pallas for several chunks
// without screen_verts: only the sharded rasterizer's triangle blocks,
// raytpu/parallel/render.py::raster_block): K8c without the mask, every
// chunk swept. K8c is the <true> instance of the same kernel.
//
// Every kernel takes the image's first row y0: an H x W image is rows
// [y0, y0 + H) of the frame, as the sharded rasterizer's row blocks are
// (pixel y = float(y0 + row), exact below 2^24), so y0 = 0 is the whole
// frame.
//
// Both read the (T, 16) float32 constants of raster_tri_constants, rows
// [A0 B0 C0 A1 B1 C1 A2 B2 C2 Za Zb Zc valid 0 0 0], and write one int32
// winner per pixel of the H x W image (-1 for background). The pixel is its
// integer corner (x, y); e_k = (A_k x + B_k y) + C_k, zpx = (Za x + Zb y) +
// Zc, covered where min(e0, e1, e2) >= 0, zpx > 0 and valid > 0. A triangle
// replaces the running winner only with a strictly larger zpx, so the first
// of equal maxima wins (the reference's strict z-test, rasteriser.cpp:606),
// as the TPU kernels' chunk argmax with a strict update across chunks does.
//
// Layout and design. The TPU kernels re-blocked pixels into (8, tile/8)
// vregs, prefetched the constants as SMEM scalars with invalid rows folded
// into C0 = -3e38, and carried (best_z, best_idx) in VMEM scratch across a
// sequential chunk grid. Here one thread takes one pixel and keeps
// (best_z, best_idx) in registers. K8b: 256 pixels a block in row-major
// order, the whole table (T <= 128 rows) staged once in shared memory and
// read by broadcast; the valid flag is tested instead of folded (the same
// winners).
//
// K8c and K8a, redesigned for Hopper (one template,
// raster_winner_chunked_kernel<Masked>). A block is a 16 x 16 pixel tile;
// it walks the table in passes: K8a every row, 256 rows a pass; K8c the
// rows of each chunk its mask keeps, a chunk a pass. In a pass each
// thread loads one row (four float4s) and decides whether that row can
// cover any pixel of the tile (tile_reject, below); a ballot and a popc
// prefix over the warps write the surviving rows, in triangle order, to
// shared memory (four float4s and the triangle's index each); the block
// then sweeps only those, every thread the same row at a time (four
// 128-bit broadcast reads a row), with the strict `>` in triangle order.
// Culling a row that covers no pixel of the tile leaves every pixel's
// sequence of covered rows, and so its winner, as it was: the first of
// equal maxima still wins. A thread loads its row of the next pass before
// the block sweeps this one; two barriers a pass. On the 9,028-row mesh at
// 512^2 a tile's pass keeps a few rows of 256.
//
// The cull is exact (tile_reject). The sweep evaluates an edge as
// fl(fl(fl(A x) + fl(B y)) + C) (-fmad=false) at the pixel corners x in
// [x0, x1], y in [y0, y1] of the tile clipped to the image. Rounding to
// nearest is monotone in each operand of a product and a sum: fl(A x) does
// not decrease in x where A >= 0 and does not increase where A < 0, and a
// sum of non-decreasing terms does not decrease. So, with A, B, C finite,
// the largest value the sweep computes for this edge over the tile is its
// value at the corner (A >= 0 ? x1 : x0, B >= 0 ? y1 : y0), computed by
// the same expression: the rounding margin is 0. Overflow does not break
// this: with A, B, C finite a pixel's value is NaN only where fl(A x) and
// fl(B y) are infinities of opposite signs, and the +inf one would be +inf
// at the corner too, where the value is then +inf or NaN, not below 0.
// Where the corner value is below 0, every pixel of the tile has that edge
// below 0 and is not covered. The same
// holds for zpx <= 0 at its largest corner, and a row whose valid is not
// > 0 (or NaN) covers nothing. A row with an inf or NaN coefficient in a
// plane is never rejected by that plane. kernels/raster.py::
// raster_tile_reject is the plain form, op by op; the card's probe
// (raytpu_raster_cull_probe) evaluates every rejected (tile, row) pair at
// every pixel with the sweep's own test and counts the covered pixels: 0.
//
// Bound on the H100: 16 float operations a pixel-triangle test (four planes
// of a multiply, a multiply and two adds), against 4 B of output a pixel.
// K8b at 512^2 and T = 32 makes 8.4 M tests, 0.13 GFLOP: 2.0 us at the
// 67 TFLOP/s float32 peak, above the 0.3 us to write 1 MB: bound by
// operations. K8c and K8a pay the cull, 16 operations a (tile, row) pair
// of the rows they walk (four planes at one corner), and the test for each
// in-image pixel against each surviving row (chip_smoke.py::winner_bound).
//
// Rounding. Built with -fmad=false, each expression in the JAX kernel's
// order, so the winners equal the plain PyTorch versions
// (kernels/raster.py::resolve_winner{,_masked,_chunked}_reference) on the
// card bit for bit. min(min(e0, e1), e2) >= 0 is tested as three
// comparisons: with a NaN the minimum is NaN and the test false, as each
// comparison is.

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // K8c, K8a: a kTile x kTile pixel tile a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTris = 128;
constexpr int kCols = 16;
constexpr float kNegInf = -FLT_MAX;  // _NEG_INF = -3.4028235e38

// Whether pixel (px, py) is covered by the row c (16 floats), and its zpx:
// the sweep's test.
__device__ __forceinline__ bool covers(const float* c, float px, float py,
                                       float* zpx) {
  const float e0 = (c[0] * px + c[1] * py) + c[2];
  const float e1 = (c[3] * px + c[4] * py) + c[5];
  const float e2 = (c[6] * px + c[7] * py) + c[8];
  *zpx = (c[9] * px + c[10] * py) + c[11];
  return e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && *zpx > 0.0f &&
         c[12] > 0.0f;
}

// Sweep n staged rows; row i is triangle base + i.
__device__ __forceinline__ void sweep(const float* s, int n, int base,
                                      float px, float py, float* best_z,
                                      int* best_i) {
  float bz = *best_z;
  int bi = *best_i;
  for (int i = 0; i < n; ++i) {
    float zpx;
    if (covers(s + kCols * i, px, py, &zpx) && zpx > bz) {
      bz = zpx;
      bi = base + i;
    }
  }
  *best_z = bz;
  *best_i = bi;
}

// The pixel corners of a tile: x in [x0, x1], y in [y0, y1].
struct TileRect {
  float x0, x1, y0, y1;
};

// Tile (tx, ty) of a W-wide image of H rows that start at frame row y0,
// clipped to the image.
__device__ __forceinline__ TileRect tile_rect(int tx, int ty, int H, int W,
                                              int y0) {
  const int x = tx * kTile, y = ty * kTile;
  return {static_cast<float>(x), static_cast<float>(min(x + kTile - 1, W - 1)),
          static_cast<float>(y0 + y),
          static_cast<float>(y0 + min(y + kTile - 1, H - 1))};
}

// True where the plane (a, b, c) is computed below 0 (below or at 0 where
// `at_zero`) at every pixel of the tile: its value at its largest corner,
// by the sweep's expression (see above). A non-finite coefficient never
// rejects.
__device__ __forceinline__ bool plane_below(float a, float b, float c,
                                            const TileRect& r, bool at_zero) {
  if (!(isfinite(a) && isfinite(b) && isfinite(c))) return false;
  const float x = a >= 0.0f ? r.x1 : r.x0;
  const float y = b >= 0.0f ? r.y1 : r.y0;
  const float v = (a * x + b * y) + c;
  return at_zero ? v <= 0.0f : v < 0.0f;
}

// True where row q (four float4s: A0 B0 C0 A1 | B1 C1 A2 B2 | C2 Za Zb Zc |
// valid 0 0 0) covers no pixel of the tile r (kernels/raster.py::
// raster_tile_reject).
__device__ __forceinline__ bool tile_reject(const float4* q,
                                            const TileRect& r) {
  return !(q[3].x > 0.0f) || plane_below(q[0].x, q[0].y, q[0].z, r, false) ||
         plane_below(q[0].w, q[1].x, q[1].y, r, false) ||
         plane_below(q[1].z, q[1].w, q[2].x, r, false) ||
         plane_below(q[2].y, q[2].z, q[2].w, r, true);
}

__global__ void __launch_bounds__(kThreads)
    raster_winner_kernel(const float* __restrict__ consts, int T, int H,
                         int W, int y0, int* __restrict__ idx) {
  __shared__ float s[kMaxTris * kCols];
  for (int k = threadIdx.x; k < T * kCols; k += kThreads) s[k] = consts[k];
  __syncthreads();
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= H * W) return;
  float best_z = kNegInf;
  int best_i = -1;
  sweep(s, T, 0, static_cast<float>(r % W), static_cast<float>(y0 + r / W),
        &best_z, &best_i);
  idx[r] = best_i;  // -1 where no triangle covers the pixel
}

// The pass after pass p (K8a: p + 1; K8c: the next chunk the tile keeps),
// n_pass where there is none. The same for every thread of the block.
template <bool Masked>
__device__ __forceinline__ int next_pass(int p, int n_pass, const int* keep) {
  ++p;
  if (Masked) {
    while (p < n_pass && keep[p] == 0) ++p;
  }
  return p;
}

// K8a (Masked false) and K8c (true), redesigned (see above): a block a
// 16 x 16 tile, a thread a pixel; pass p is rows [p step, p step + step) of
// the table (K8a step 256, K8c step chunk, the chunks the mask keeps).
template <bool Masked>
__global__ void __launch_bounds__(kThreads)
    raster_winner_chunked_kernel(const float4* __restrict__ consts, int T,
                                 int step, int n_pass,
                                 const int* __restrict__ mask, int H, int W,
                                 int y0, int* __restrict__ idx) {
  __shared__ float4 s_rows[kThreads * 4];
  __shared__ int s_tri[kThreads];
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const int* keep =
      Masked ? mask + static_cast<size_t>(blockIdx.y * gridDim.x +
                                          blockIdx.x) * n_pass
             : nullptr;
  const TileRect rect = tile_rect(blockIdx.x, blockIdx.y, H, W, y0);
  const float px = static_cast<float>(x), py = static_cast<float>(y0 + y);
  float best_z = kNegInf;
  int best_i = -1;
  // This thread's row of pass p: row p step + tid, where below T and step.
  auto load = [&](int p, float4* q) {
    const int row = p * step + tid;
    const bool in = p < n_pass && tid < step && row < T;
    if (in) {
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = consts[static_cast<size_t>(row) * 4 + j];
    }
    return in;
  };
  float4 q[4];
  int p = Masked ? next_pass<true>(-1, n_pass, keep) : 0;
  bool have = load(p, q);
  while (p < n_pass) {
    const bool keep_row = have && !tile_reject(q, rect);
    const unsigned bits = __ballot_sync(0xffffffffu, keep_row);
    if (lane == 0) s_warp[warp] = __popc(bits);
    __syncthreads();  // the last sweep is done with s_rows; s_warp is in
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_warp[w];
      before += w < warp ? n : 0;
      total += n;
    }
    if (keep_row) {
      const int at = before + __popc(bits & ((1u << lane) - 1u));
#pragma unroll
      for (int j = 0; j < 4; ++j) s_rows[at * 4 + j] = q[j];
      s_tri[at] = p * step + tid;
    }
    const int p_next = Masked ? next_pass<true>(p, n_pass, keep) : p + 1;
    have = load(p_next, q);  // in flight during the sweep
    __syncthreads();  // the surviving rows are in
    float bz = best_z;
    int bi = best_i;
    for (int i = 0; i < total; ++i) {
      float zpx;
      if (covers(reinterpret_cast<const float*>(s_rows + i * 4), px, py,
                 &zpx) &&
          zpx > bz) {
        bz = zpx;
        bi = s_tri[i];
      }
    }
    best_z = bz;
    best_i = bi;
    p = p_next;
  }
  if (x < W && y < H) idx[static_cast<size_t>(y) * W + x] = best_i;
}

// The card's check of tile_reject: a block a tile, every row of the table
// decided by tile_reject, and every rejected row tested at every pixel of
// the tile inside the image with the sweep's own test. counts[0] += the
// rejected (tile, row) pairs, counts[1] += the covered (pixel, row) pairs
// among them (0 where the cull is exact), counts[2] += every (tile, row)
// pair.
__global__ void __launch_bounds__(kThreads)
    raster_cull_probe_kernel(const float4* __restrict__ consts, int T, int H,
                             int W, int y0,
                             unsigned long long* __restrict__ counts) {
  __shared__ float4 s_rows[kThreads * 4];
  __shared__ int s_rej[kThreads];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const bool in = x < W && y < H;
  const TileRect rect = tile_rect(blockIdx.x, blockIdx.y, H, W, y0);
  const float px = static_cast<float>(x), py = static_cast<float>(y0 + y);
  unsigned long long rejected = 0, covered = 0;
  for (int lo = 0; lo < T; lo += kThreads) {
    const int n = min(kThreads, T - lo);
    __syncthreads();
    if (tid < n) {
      float4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = consts[static_cast<size_t>(lo + tid) * 4 + j];
        s_rows[tid * 4 + j] = q[j];
      }
      s_rej[tid] = tile_reject(q, rect) ? 1 : 0;
      rejected += s_rej[tid];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      float zpx;
      if (s_rej[i] && in &&
          covers(reinterpret_cast<const float*>(s_rows + i * 4), px, py,
                 &zpx)) {
        ++covered;
      }
    }
  }
  atomicAdd(counts, rejected);
  atomicAdd(counts + 1, covered);
  if (tid == 0) atomicAdd(counts + 2, static_cast<unsigned long long>(T));
}

}  // namespace

// consts (T, 16) float32 device pointer, T <= 128; idx (H * W,) int32
// output for rows [y0, y0 + H) of the frame. Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int raytpu_raster_winner(const void* consts, int T, int H, int W,
                                    int y0, void* idx, void* stream) {
  if (T < 1 || T > kMaxTris || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int R = H * W;
  raster_winner_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(consts), T, H, W, y0, static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

// consts (T, 16) float32 device pointer (16-byte aligned) in chunks of
// `chunk` <= 128 rows, n_chunks = ceil(T / chunk); mask null (K8a: every
// row, 256 a pass) or the (tiles_y * tiles_x, n_chunks) int32 keep-mask over
// the image's tiles of 16 x 16 pixels, row-major (K8c: a kept chunk a pass);
// idx (H * W,) int32 output for rows [y0, y0 + H) of the frame. Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int raytpu_raster_winner_chunked(const void* consts, int T,
                                            int chunk, const void* mask,
                                            int H, int W, int y0, void* idx,
                                            void* stream) {
  if (T < 1 || chunk < 1 || chunk > kMaxTris || H < 1 || W < 1 ||
      reinterpret_cast<uintptr_t>(consts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* c = static_cast<const float4*>(consts);
  if (mask == nullptr)
    raster_winner_chunked_kernel<false><<<grid, dim3(kTile, kTile), 0, st>>>(
        c, T, kThreads, (T + kThreads - 1) / kThreads, nullptr, H, W, y0,
        static_cast<int*>(idx));
  else
    raster_winner_chunked_kernel<true><<<grid, dim3(kTile, kTile), 0, st>>>(
        c, T, chunk, (T + chunk - 1) / chunk, static_cast<const int*>(mask),
        H, W, y0, static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

// consts as for raytpu_raster_winner_chunked; counts (3,) uint64 device
// pointer, zeroed by the caller, to which the probe adds the rejected
// (tile, row) pairs, the covered (pixel, row) pairs among them and every
// (tile, row) pair of the H x W image at frame row y0. Launches on `stream`
// and returns the launch's cudaError_t.
extern "C" int raytpu_raster_cull_probe(const void* consts, int T, int H,
                                        int W, int y0, void* counts,
                                        void* stream) {
  if (T < 1 || H < 1 || W < 1 ||
      reinterpret_cast<uintptr_t>(consts) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  raster_cull_probe_kernel<<<grid, dim3(kTile, kTile), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(consts), T, H, W, y0,
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}
