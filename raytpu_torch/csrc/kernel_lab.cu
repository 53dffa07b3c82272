// The kernel lab's closest-hit variants for Hopper (sm_90a): L1.
//
// Replaces bench/kernel_lab.py::_kernel_v (launched at :138 by
// run_variant): K5's streaming closest hit (every ray against every chunk
// of C triangles in order, the last index winning ties within a chunk and,
// by `<=`, across chunks) in the lab's variants:
//
//   chunk  C = 128, the table padded to whole chunks of 128 (pad128), or C
//          = T rounded up to 8, at most 128 (tight); the wrapper packs the
//          table (kernels/labs.py), padded columns zero, so they never hit.
//   dot    vpu: the three dots n . d, c2 . d, c3 . d as (a dx + b dy) + c dz
//          on the CUDA cores, JAX's order; mxu: on the tensor cores, TF32
//          m16n16k8 through nvcuda::wmma in three passes (3xTF32: x = hi +
//          lo, each rounded to TF32 as cvt.rna.tf32.f32 rounds, to nearest
//          with ties away from zero; the products lo.hi, hi.lo, hi.hi
//          accumulated in float32 in that order, lo.lo dropped), the
//          counterpart of the MXU's multi-pass Precision.HIGHEST.
//   div    t, u, v by three IEEE divides (div) or one IEEE reciprocal and
//          three multiplies (recip, K5's form).
//   tile   tile_r rays share each staging of a chunk in shared memory, as
//          a TPU ray tile shares each chunk's DMA: one block of 256 threads
//          a tile, tile_r / 256 rays a thread (2048, 4096, 8192: 8, 16, 32).
//
// Design. A block stages chunk c's 10 x C constants in shared memory, then
// every ray of its tile takes its running best (t, index) in registers
// through the chunk; chunks in order, so the TPU grid's scratch carried
// across chunk steps becomes registers carried across a loop.
// vpu: a thread reads each triangle's 10 constants once (warp-uniform
// broadcasts) and tests its tile_r / 256 rays against them, so a larger
// tile amortises the reads over more rays and holds more state in
// registers. mxu: a warp takes 32 rays at a time as the B operand (8 x 32:
// dx, dy, dz and five zero rows, K = 3 padded to 8) and 16 triangles as A
// (16 x 8, col-major over the staged rows with stride ld = C rounded up to
// 16: the rows past a dot's three are the next dot's, times B's zero rows,
// and rows 10-13 and columns C..ld-1 are zero, so padded triangles have
// denominator 0 and never hit). The three accumulators of 16 triangles x
// 16 rays go to shared memory; each lane then tests 8 triangles (one row
// parity) of one ray column on the CUDA cores, the two parities merge by a
// shuffle (the later row wins a tie), and the ray's owner lane updates its
// running best. The tensor cores compute only the dots: the divides, the
// inside test and the minimum stay on the CUDA cores, 9 MMAs a 16 x 16
// block of pairs for 3 x 16 x 16 x 3 useful MACs.
//
// Bound on the H100, the lab's shapes (512^2 rays, Cornell 32 and 9,216
// triangles): 12 B in and 8 B out a ray plus the table, against C plane
// tests a ray a chunk of ~20 float operations (vpu: 9 products and 6 adds
// for the dots; mxu: those 15 on the tensor cores as 3 x 8 x 3 padded TF32
// MACs a pair at 495 TFLOP/s dense, the remainder on the CUDA cores at 67
// TFLOP/s): bound by operations, about 0.72 ms for 9,216 triangles.
//
// Rounding. Built with -fmad=false and IEEE division: vpu instances equal
// the plain PyTorch version (kernels/labs.py::kernel_lab_variant_reference)
// bit for bit, and (vpu, recip) equals K5 (intersect.cu) at either chunk.
// The tensor cores' float32 accumulation is not IEEE's sequence of roundings,
// so mxu instances equal the plain 3xTF32 version within its error bound
// (kernels/labs.py::mxu_rule), not bit for bit.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kRows = 10;        // n xyz | c2 xyz | c3 xyz | k0
constexpr int kStagedRows = 14;  // + 4 zero rows: each dot's A reads 8 rows

enum Dot { kVpu = 0, kMxu = 1 };
enum Div { kDivide = 0, kRecip = 1 };

// t of one (triangle, ray) pair from its three dots, FLT_MAX unless it
// hits (kernel_lab.py:78-91).
template <int D>
__device__ __forceinline__ float pair_t(float dn, float du, float dv,
                                        float k0) {
  const float denom = -dn;
  const bool nonpar = denom != 0.0f;
  const float safe = nonpar ? denom : 1.0f;
  float t, u, v;
  if (D == kDivide) {
    t = k0 / safe;
    u = du / safe;
    v = dv / safe;
  } else {
    const float r = 1.0f / safe;
    t = k0 * r;
    u = du * r;
    v = dv * r;
  }
  const bool ok =
      (u + v <= 1.0f) && (u >= 0.0f) && (v >= 0.0f) && (t >= 0.0f) && nonpar;
  return ok ? t : FLT_MAX;
}

template <int D, int RPT>
__global__ void __launch_bounds__(kThreads)
    lab_vpu_kernel(const float* __restrict__ dirs_t,
                   const float* __restrict__ table, int Tp, int C, int R,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float s_blk[kRows * kMaxChunk];
  const int base = blockIdx.x * (kThreads * RPT) + threadIdx.x;
  float dx[RPT], dy[RPT], dz[RPT], bt[RPT];
  int bi[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = base + j * kThreads;
    dx[j] = dirs_t[r];
    dy[j] = dirs_t[R + r];
    dz[j] = dirs_t[2 * R + r];
    bt[j] = FLT_MAX;
    bi[j] = -1;
  }
  const int n_chunks = Tp / C;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk is read
    for (int k = threadIdx.x; k < kRows * C; k += kThreads) {
      const int row = k / C;
      s_blk[k] = table[static_cast<size_t>(row) * Tp +
                       static_cast<size_t>(c) * C + (k - row * C)];
    }
    __syncthreads();
    for (int i = 0; i < C; ++i) {
      const float n0 = s_blk[i], n1 = s_blk[C + i], n2 = s_blk[2 * C + i];
      const float a0 = s_blk[3 * C + i], a1 = s_blk[4 * C + i],
                  a2 = s_blk[5 * C + i];
      const float b0 = s_blk[6 * C + i], b1 = s_blk[7 * C + i],
                  b2 = s_blk[8 * C + i];
      const float k0 = s_blk[9 * C + i];
      const int tri = c * C + i;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float dn = (n0 * dx[j] + n1 * dy[j]) + n2 * dz[j];
        const float du = (a0 * dx[j] + a1 * dy[j]) + a2 * dz[j];
        const float dv = (b0 * dx[j] + b1 * dy[j]) + b2 * dz[j];
        const float tm = pair_t<D>(dn, du, dv, k0);
        if (tm <= bt[j]) {
          bt[j] = tm;
          bi[j] = tri;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = base + j * kThreads;
    t_out[r] = bt[j];
    idx_out[r] = bt[j] < FLT_MAX ? bi[j] : -1;
  }
}

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds, with the 13 low bits zero.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                             wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

template <int D, int RPT>
__global__ void __launch_bounds__(kThreads)
    lab_mxu_kernel(const float* __restrict__ dirs_t,
                   const float* __restrict__ table, int Tp, int C, int R,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  // The chunk's rows split into hi + lo, row stride ld; k0 exact.
  __shared__ __align__(32) float s_hi[kStagedRows * kMaxChunk];
  __shared__ __align__(32) float s_lo[kStagedRows * kMaxChunk];
  __shared__ float s_k0[kMaxChunk];
  // Each warp's B (rows dx, dy, dz of its 32 rays, then five zero rows)
  // and its three accumulators of 16 triangles x 16 rays.
  __shared__ __align__(32) float s_b[kWarps][8 * 32];
  __shared__ __align__(32) float s_acc[kWarps][3][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = (C + 15) / 16 * 16;
  for (int k = threadIdx.x; k < (kStagedRows - kRows) * ld; k += kThreads) {
    s_hi[kRows * ld + k] = 0.0f;
    s_lo[kRows * ld + k] = 0.0f;
  }
  for (int k = lane; k < 5 * 32; k += 32) s_b[warp][3 * 32 + k] = 0.0f;

  // Ray of this lane in the warp's group q.
  const int base = blockIdx.x * (kThreads * RPT) + warp * 32 + lane;
  float bt[RPT];
  int bi[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    bt[q] = FLT_MAX;
    bi[q] = -1;
  }
  const int col = lane & 15, par = lane >> 4;
  const int n_chunks = Tp / C;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk is read
    for (int k = threadIdx.x; k < kRows * ld; k += kThreads) {
      const int row = k / ld, j = k - row * ld;
      const float x =
          j < C ? table[static_cast<size_t>(row) * Tp +
                        static_cast<size_t>(c) * C + j]
                : 0.0f;
      const float hi = tf32_rna(x);
      s_hi[k] = hi;
      s_lo[k] = tf32_rna(x - hi);
      if (row == 9) s_k0[j] = x;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = base + q * kThreads;
      s_b[warp][lane] = dirs_t[r];
      s_b[warp][32 + lane] = dirs_t[R + r];
      s_b[warp][64 + lane] = dirs_t[2 * R + r];
      __syncwarp();
      FragB b_hi[2], b_lo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::load_matrix_sync(b_hi[h], s_b[warp] + 16 * h, 32);
#pragma unroll
        for (int e = 0; e < b_hi[h].num_elements; ++e) {
          const float x = b_hi[h].x[e];
          b_hi[h].x[e] = tf32_rna(x);
          b_lo[h].x[e] = tf32_rna(x - b_hi[h].x[e]);
        }
      }
      for (int g = 0; g < ld / 16; ++g) {
        FragA a_hi[3], a_lo[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          wmma::load_matrix_sync(a_hi[m], s_hi + 3 * m * ld + 16 * g, ld);
          wmma::load_matrix_sync(a_lo[m], s_lo + 3 * m * ld + 16 * g, ld);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            FragC acc;
            wmma::fill_fragment(acc, 0.0f);
            wmma::mma_sync(acc, a_lo[m], b_hi[h], acc);
            wmma::mma_sync(acc, a_hi[m], b_lo[h], acc);
            wmma::mma_sync(acc, a_hi[m], b_hi[h], acc);
            wmma::store_matrix_sync(s_acc[warp][m], acc, 16,
                                    wmma::mem_row_major);
          }
          __syncwarp();
          // Rows of parity `par` of ray column `col`, in order.
          float lt = FLT_MAX;
          int li = -1;
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            const int row = 2 * p + par, at = row * 16 + col;
            const float tm =
                pair_t<D>(s_acc[warp][0][at], s_acc[warp][1][at],
                          s_acc[warp][2][at], s_k0[16 * g + row]);
            if (tm <= lt) {
              lt = tm;
              li = row;
            }
          }
          // Merge the two parities; the later row wins a tie.
          const float ot = __shfl_xor_sync(0xffffffffu, lt, 16);
          const int oi = __shfl_xor_sync(0xffffffffu, li, 16);
          if (ot < lt || (ot == lt && oi > li)) {
            lt = ot;
            li = oi;
          }
          // Lane 16 h + col owns ray column col of half h.
          if (par == h && lt <= bt[q]) {
            bt[q] = lt;
            bi[q] = c * C + 16 * g + li;
          }
          __syncwarp();  // the accumulators are read
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = base + q * kThreads;
    t_out[r] = bt[q];
    idx_out[r] = bt[q] < FLT_MAX ? bi[q] : -1;
  }
}

template <int RPT>
int launch(int dot, int div, const float* dirs_t, const float* table, int Tp,
           int C, int R, float* t, int* idx, cudaStream_t s) {
  const int blocks = R / (kThreads * RPT);
  if (dot == kVpu && div == kDivide)
    lab_vpu_kernel<kDivide, RPT><<<blocks, kThreads, 0, s>>>(
        dirs_t, table, Tp, C, R, t, idx);
  else if (dot == kVpu)
    lab_vpu_kernel<kRecip, RPT><<<blocks, kThreads, 0, s>>>(
        dirs_t, table, Tp, C, R, t, idx);
  else if (div == kDivide)
    lab_mxu_kernel<kDivide, RPT><<<blocks, kThreads, 0, s>>>(
        dirs_t, table, Tp, C, R, t, idx);
  else
    lab_mxu_kernel<kRecip, RPT><<<blocks, kThreads, 0, s>>>(
        dirs_t, table, Tp, C, R, t, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// dirs_t (3, R) and table (10, Tp) float32 device pointers, Tp a multiple
// of the chunk C <= 128 (kernels/tables.py::constant_table, one block);
// tile_r 2048, 4096 or 8192 rays a block, R a multiple of it; dot 0 (vpu)
// or 1 (mxu), div 0 (three divides) or 1 (a reciprocal); t (R,) float32
// and idx (R,) int32 outputs. Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int raytpu_kernel_lab(const void* dirs_t, const void* table,
                                 int Tp, int C, int R, int tile_r, int dot,
                                 int div, void* t, void* idx, void* stream) {
  if (C < 1 || C > kMaxChunk || Tp < C || Tp % C != 0 || R < 0 ||
      tile_r < kThreads || tile_r % kThreads != 0 || R % tile_r != 0 ||
      (dot != kVpu && dot != kMxu) ||
      (div != kDivide && div != kRecip))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const auto* d = static_cast<const float*>(dirs_t);
  const auto* tab = static_cast<const float*>(table);
  auto* to = static_cast<float*>(t);
  auto* io = static_cast<int*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile_r / kThreads) {
    case 8:
      return launch<8>(dot, div, d, tab, Tp, C, R, to, io, s);
    case 16:
      return launch<16>(dot, div, d, tab, Tp, C, R, to, io, s);
    case 32:
      return launch<32>(dot, div, d, tab, Tp, C, R, to, io, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
