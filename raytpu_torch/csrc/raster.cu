// The hard rasterizer's winner search for Hopper (sm_90a): K8b, K8c and
// K8a.
//
// K8b, raster_winner_kernel, replaces
// raytpu/kernels/raster_pallas.py::_kernel_blk8 (launched by
// resolve_winner_pallas for one triangle chunk, the Cornell box): per pixel,
// the first triangle with the largest covered zpx over T <= 128 triangles.
//
// K8c, raster_winner_chunked_kernel<true>, replaces
// raster_pallas.py::_kernel_masked (launched by resolve_winner_pallas for several chunks with screen_verts,
// STL scale): the same search over chunks of `chunk` <= 128 triangles, each
// chunk skipped where a (pixel tile, chunk) keep-mask bit is 0
// (kernels/raster.py::chunk_screen_mask, conservative, so the winners are
// those of the unmasked search).
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
// (best_z, best_idx) in registers; a block stages a chunk's rows in shared
// memory (8 KB at 128 rows) and every thread reads the same row at the same
// time, a broadcast. The valid flag is tested instead of folded: the same
// winners. K8b: 256 pixels a block in row-major order, the whole table
// (T rows, no padding) staged once. K8c and K8a: a block is a 16 x 16 pixel
// tile, so the mask's rectangle is tight; it walks the chunks in order,
// skips a chunk whose mask bit is 0 (K8c) as a block-uniform branch, and
// otherwise stages the chunk between two barriers and sweeps it. A
// sequential strict `>` over the triangles in order keeps the first of equal
// maxima, within a chunk and across chunks: K8a's chunk argmax (the lowest
// index at the chunk's max) followed by a strict update across chunks picks
// the same triangle. Rows past T in the last chunk are not staged (the JAX
// wrapper pads them with zeros, valid 0: never covered).
//
// Bound on the H100: 16 float operations a pixel-triangle test (four planes
// of a multiply, a multiply and two adds), against 4 B of output a pixel.
// K8b at 512^2 and T = 32 makes 8.4 M tests, 0.13 GFLOP: 2.0 us at the
// 67 TFLOP/s float32 peak, above the 0.3 us to write 1 MB: bound by
// operations. K8c's tests are those of the kept (tile, chunk) pairs; K8a's
// every in-image pixel against every valid row.
//
// Rounding. Built with -fmad=false, each expression in the JAX kernel's
// order, so the winners equal the plain PyTorch versions
// (kernels/raster.py::resolve_winner{,_masked,_chunked}_reference) on the
// card bit for bit. min(min(e0, e1), e2) >= 0 is tested as three
// comparisons: with a NaN the minimum is NaN and the test false, as each
// comparison is.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // K8c: a kTile x kTile pixel tile a block
constexpr int kMaxTris = 128;
constexpr int kCols = 16;
constexpr float kNegInf = -FLT_MAX;  // _NEG_INF = -3.4028235e38

// Sweep n staged rows; row i is triangle base + i.
__device__ __forceinline__ void sweep(const float* s, int n, int base,
                                      float px, float py, float* best_z,
                                      int* best_i) {
  float bz = *best_z;
  int bi = *best_i;
  for (int i = 0; i < n; ++i) {
    const float* c = s + kCols * i;
    const float e0 = (c[0] * px + c[1] * py) + c[2];
    const float e1 = (c[3] * px + c[4] * py) + c[5];
    const float e2 = (c[6] * px + c[7] * py) + c[8];
    const float zpx = (c[9] * px + c[10] * py) + c[11];
    const bool covered = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                         zpx > 0.0f && c[12] > 0.0f;
    if (covered && zpx > bz) {
      bz = zpx;
      bi = base + i;
    }
  }
  *best_z = bz;
  *best_i = bi;
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

template <bool Masked>
__global__ void __launch_bounds__(kTile* kTile)
    raster_winner_chunked_kernel(const float* __restrict__ consts, int T,
                                 int chunk, int n_chunks,
                                 const int* __restrict__ mask, int H, int W,
                                 int y0, int* __restrict__ idx) {
  __shared__ float s[kMaxTris * kCols];
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y = blockIdx.y * kTile + threadIdx.y;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int* keep =
      Masked ? mask + static_cast<size_t>(blockIdx.y * gridDim.x +
                                          blockIdx.x) * n_chunks
             : nullptr;
  const float px = static_cast<float>(x), py = static_cast<float>(y0 + y);
  float best_z = kNegInf;
  int best_i = -1;
  for (int c = 0; c < n_chunks; ++c) {
    if (Masked && keep[c] == 0) continue;  // the same bit for the block
    const int lo = c * chunk;
    const int n = min(chunk, T - lo);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = tid; k < n * kCols; k += kTile * kTile)
      s[k] = consts[static_cast<size_t>(lo) * kCols + k];
    __syncthreads();
    sweep(s, n, lo, px, py, &best_z, &best_i);
  }
  if (x < W && y < H) idx[static_cast<size_t>(y) * W + x] = best_i;
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

// consts (T, 16) float32 device pointer in chunks of `chunk` <= 128 rows,
// n_chunks = ceil(T / chunk); mask null (K8a: every chunk) or the
// (tiles_y * tiles_x, n_chunks) int32 keep-mask over the image's tiles of
// 16 x 16 pixels, row-major (K8c); idx (H * W,) int32 output for rows
// [y0, y0 + H) of the frame. Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int raytpu_raster_winner_chunked(const void* consts, int T,
                                            int chunk, const void* mask,
                                            int H, int W, int y0, void* idx,
                                            void* stream) {
  if (T < 1 || chunk < 1 || chunk > kMaxTris || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(consts);
  const int n_chunks = (T + chunk - 1) / chunk;
  if (mask == nullptr)
    raster_winner_chunked_kernel<false><<<grid, dim3(kTile, kTile), 0, st>>>(
        c, T, chunk, n_chunks, nullptr, H, W, y0, static_cast<int*>(idx));
  else
    raster_winner_chunked_kernel<true><<<grid, dim3(kTile, kTile), 0, st>>>(
        c, T, chunk, n_chunks, static_cast<const int*>(mask), H, W, y0,
        static_cast<int*>(idx));
  return (int)cudaGetLastError();
}
