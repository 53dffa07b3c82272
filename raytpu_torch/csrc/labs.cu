// The megakernel labs' forward kernels for Hopper (sm_90a): K1r, L5, L6.
//
// Replaces three TPU kernels that compute one function, K1's whole hard
// forward in one launch (primary closest hit, shadow any-hit toward the
// single light, the winner's normal and albedo, inverse-square Lambert plus
// ambient, composite and focal distance), each in its own data layout:
//
//   K1r  raytpu/kernels/render_fused.py::_fwd_kernel (launched by
//        _fused_fwd_raw): the (1, tile) row layout. dirs (3, Rp) in;
//        color (3, Rp), fd, idx, occ (1, Rp) out.
//   L5   bench/megakernel_lab4.py::variant_kernel (launched by run_variant):
//        K1r with the gather and/or the shading switched off. Without the
//        gather the winner's normal and albedo are tz * (0.1, 0.2, 0.3) and
//        tz * (0.4, 0.5, 0.6); without the shading color = normal + albedo
//        and fd = tz. Its shading is clean with ambient 0.2.
//   L6   bench/megakernel_lab6.py::_fwd_kernel_blk8 (launched by
//        fused_fwd_blk8): the (8, tile/8) blocked layout. dirs (24, Rp/8)
//        in, rows [dx x8 | dy x8 | dz x8]; (32, Rp/8) out, rows
//        [c0 x8 | c1 x8 | c2 x8 | fd x8]; no idx or occ.
//
// Design. One template, mega_fwd_kernel<Layout, Gather, Shade>, designed as
// K1 is (render_fused.cu): one ray per thread, 256 threads a block, the
// (26, C) triangle table of kernels/tables.py and the 10 parameters copied
// into shared memory and read as warp-uniform broadcasts, the plane test of
// plane_test.cuh. The TPU's scalar-prefetch tables, its select-chain gather
// and its (8, tile/8) re-blocking were answers to the TPU's vector layout
// and are not carried over: here kBlk8 is only an index map on the global
// reads and writes (_blk8's, megakernel_lab6.py:126-143). Ray r of tile i
// = r / tile_r, at s = (r % tile_r) / (tile_r / 8), c = r % (tile_r / 8),
// lives at row 8 k + s, column i (tile_r / 8) + c of component k's rows, so
// neighbouring threads still touch neighbouring addresses. The winner's
// normal and albedo are read by index, which gives the TPU kernels' value
// (their gather selects one row; the JAX row kernel's sum of
// where(win, attr, 0) differs only in the sign of a zero).
//
// Bound on the H100 at 512^2, C = 32 (the labs' shapes). Memory: 12 B in
// and 24 B out a ray for the row layout (16 B out for kBlk8), 9.4 MB
// (7.3 MB), about 2.8 us (2.2 us) at 3.35 TB/s. Arithmetic: C plane tests
// a ray in the primary sweep, the shadow sweep's up to its first blocker,
// each an IEEE divide and ~20 float ops, and ~50 for a hit ray's shading:
// about 0.5 GFLOP, about 7 us at the 67 TFLOP/s float32 peak. The launch
// and the plane tests' divides, not the bytes, bound these kernels.
//
// Rounding. Built with -fmad=false and IEEE division and sqrt, and each
// expression keeps the JAX kernels' operation order, so the outputs equal
// the plain PyTorch versions (kernels/labs.py) on the card bit for bit, and
// K1r equals K1 (render_fused.cu) bit for bit.

#include <cfloat>
#include <cuda_runtime.h>

#include "plane_test.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 128;
constexpr int kRows = 26;
constexpr int kPrimary = 0, kShadow = 10, kNormal = 20, kAlbedo = 23;
constexpr int kParams = 10;
constexpr float kFourPi = 0x1.921fb6p+3f;   // float32(4 * pi)
constexpr float kShadowT = 0x1.fae148p-1f;  // float32(0.99)

enum Layout { kRow = 0, kBlk8 = 1 };

template <int L, bool Gather, bool Shade>
__global__ void __launch_bounds__(kThreads)
    mega_fwd_kernel(const float* __restrict__ dirs,
                    const float* __restrict__ table,
                    const float* __restrict__ params, int C, int Rp,
                    int tile_r, float ambient, int parity,
                    float* __restrict__ color, float* __restrict__ fd,
                    int* __restrict__ idx, int* __restrict__ occ) {
  __shared__ float s_tab[kRows * kMaxTris];
  __shared__ float s_par[kParams];
  for (int k = threadIdx.x; k < kRows * C; k += kThreads) s_tab[k] = table[k];
  if (threadIdx.x < kParams) s_par[threadIdx.x] = params[threadIdx.x];
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= Rp) return;
  // Component k of ray r lives at k * stride + at in either layout.
  int stride, at;
  if (L == kBlk8) {
    const int p8 = tile_r / 8, cols = Rp / 8;
    const int tile = r / tile_r, in_tile = r - tile * tile_r;
    const int s = in_tile / p8;
    stride = 8 * cols;
    at = s * cols + tile * p8 + (in_tile - s * p8);
  } else {
    stride = Rp;
    at = r;
  }
  const float dx = dirs[at], dy = dirs[stride + at], dz = dirs[2 * stride + at];

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

  // Shadow ray from the light toward pos = cam + t * d (misses trace from
  // the camera position, as the TPU kernels do).
  const float ex = (s_par[0] + tz * dx) - s_par[3];
  const float ey = (s_par[1] + tz * dy) - s_par[4];
  const float ez = (s_par[2] + tz * dz) - s_par[5];
  bool blocked = false;
  for (int i = 0; i < C && !blocked; ++i) {
    const PlaneHit p = plane_test(s_tab + kShadow * C, C, i, ex, ey, ez);
    blocked = p.ok && p.t < kShadowT;
  }
  if (L == kRow) {
    idx[at] = hit ? best_i : -1;
    occ[at] = blocked ? 1 : 0;
  }

  // The winner's normal and albedo (zero on a miss), or the lab's
  // constants.
  float n[3], alb[3];
  for (int j = 0; j < 3; ++j) {
    if (Gather) {
      n[j] = hit ? s_tab[(kNormal + j) * C + best_i] : 0.0f;
      alb[j] = hit ? s_tab[(kAlbedo + j) * C + best_i] : 0.0f;
    } else {
      n[j] = tz * (j == 0 ? 0.1f : j == 1 ? 0.2f : 0.3f);
      alb[j] = tz * (j == 0 ? 0.4f : j == 1 ? 0.5f : 0.6f);
    }
  }
  float out[4];
  if (!Shade) {
    for (int j = 0; j < 3; ++j) out[j] = n[j] + alb[j];
    out[3] = tz;
  } else if (!hit) {
    out[0] = out[1] = out[2] = out[3] = 0.0f;
  } else {
    // _shade_rows of the JAX kernels, term for term.
    const float r2 = (ex * ex + ey * ey) + ez * ez;
    const bool lit = r2 > 0.0f;
    const float rr = sqrtf(lit ? r2 : 1.0f);
    const float area = kFourPi * (rr * rr);
    float lam = ((-ex / rr) * n[0] + (-ey / rr) * n[1]) + (-ez / rr) * n[2];
    lam = lam != lam ? lam : fmaxf(lam, 0.0f);  // maximum keeps NaN
    for (int j = 0; j < 3; ++j) {
      float d = lit ? (s_par[6 + j] / area) * lam : 0.0f;
      if (blocked) d = 0.0f;
      out[j] = parity ? alb[j] * (d * alb[j] + ambient)
                      : alb[j] * (d + ambient);
    }
    const float dn = sqrtf((dx * dx + dy * dy) + dz * dz);
    out[3] = tz * dn - s_par[9];
  }
  if (L == kBlk8) {
    for (int k = 0; k < 4; ++k) color[k * stride + at] = out[k];
  } else {
    for (int j = 0; j < 3; ++j) color[j * stride + at] = out[j];
    fd[at] = out[3];
  }
}

template <int L, bool Gather, bool Shade>
void launch(const float* dirs, const float* table, const float* params, int C,
            int Rp, int tile_r, float ambient, int parity, float* color,
            float* fd, int* idx, int* occ, cudaStream_t stream) {
  const int blocks = (Rp + kThreads - 1) / kThreads;
  mega_fwd_kernel<L, Gather, Shade><<<blocks, kThreads, 0, stream>>>(
      dirs, table, params, C, Rp, tile_r, ambient, parity, color, fd, idx,
      occ);
}

}  // namespace

// dirs, table (26, C), params (10,) float32 device pointers. layout 0 (row):
// dirs (3, Rp); color (3, Rp), fd (Rp,), idx and occ (Rp,) int32 outputs.
// layout 1 (blk8): dirs (24, Rp / 8); color is the (32, Rp / 8) output and
// fd, idx, occ are unused (gather and shade must be 1). Rp must be a whole
// number of tiles of tile_r (a multiple of 8 for blk8). Launches on `stream`
// and returns the launch's cudaError_t.
extern "C" int raytpu_mega_fwd(const void* dirs, const void* table,
                               const void* params, int C, int Rp, int tile_r,
                               int layout, int gather, int shade,
                               float ambient, int parity, void* color,
                               void* fd, void* idx, void* occ, void* stream) {
  if (C < 1 || C > kMaxTris || Rp < 0 || tile_r < 1 || Rp % tile_r != 0)
    return (int)cudaErrorInvalidValue;
  if (layout == kBlk8 && (tile_r % 8 != 0 || !gather || !shade))
    return (int)cudaErrorInvalidValue;
  if (layout != kRow && layout != kBlk8) return (int)cudaErrorInvalidValue;
  if (Rp == 0) return (int)cudaSuccess;
  const auto* d = static_cast<const float*>(dirs);
  const auto* t = static_cast<const float*>(table);
  const auto* p = static_cast<const float*>(params);
  auto* c = static_cast<float*>(color);
  auto* f = static_cast<float*>(fd);
  auto* i = static_cast<int*>(idx);
  auto* o = static_cast<int*>(occ);
  auto s = static_cast<cudaStream_t>(stream);
  if (layout == kBlk8)
    launch<kBlk8, true, true>(d, t, p, C, Rp, tile_r, ambient, parity, c, f,
                              i, o, s);
  else if (gather && shade)
    launch<kRow, true, true>(d, t, p, C, Rp, tile_r, ambient, parity, c, f, i,
                             o, s);
  else if (gather)
    launch<kRow, true, false>(d, t, p, C, Rp, tile_r, ambient, parity, c, f,
                              i, o, s);
  else if (shade)
    launch<kRow, false, true>(d, t, p, C, Rp, tile_r, ambient, parity, c, f,
                              i, o, s);
  else
    launch<kRow, false, false>(d, t, p, C, Rp, tile_r, ambient, parity, c, f,
                               i, o, s);
  return (int)cudaGetLastError();
}
