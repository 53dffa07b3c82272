// Work items across the card, and cp.async staging, shared by the soft
// kernels (sm_90a): K10b-K10j's plans (soft_raytrace.cu) and K9a's and
// K9b's (soft_raster.cu).
//
// A plan cuts each pair's kept chunks (a pair: a pixel tile, or a tile and a
// light source; masked, the chunks its keep-mask row keeps, in order;
// unmasked, every chunk) into runs of `run` chunks, a work item each, laid
// out in (pair, run) order, all on the card with no host sync:
// shw_plan_kernel lists each pair's kept chunks, pri_fwd_run_kernel works
// out the run from their count where the caller asks the card to
// (pri_fwd_run: the mean kept chunks a pair over a split, at least a
// floor), and shw_items_kernel numbers the items. A kernel's block b takes
// item b (or b, b + blocks, ...), so the few tiles that hold most of the
// work spread over the card; the items' partials are then folded in run
// order (fold_items for the forwards' softmax carries), so every sum has a
// fixed order and two calls give the same bits. The forwards' plans (K10a's
// and K10b's, K9a's and K9b's) share their host side too: FwdPlan's shapes
// (fwd_plan_shapes), its scratch (carve_fwd_plan) and its launches
// (launch_fwd_plan).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

constexpr int kScanThreads = 1024;  // the run's and the items' block
constexpr int kPlanThreads = 256;   // shw_plan_kernel's block: a warp a pair

// Where the kernels find their work items: masked, the plan's lists;
// unmasked, `runs` runs of `run` chunks a (tile, source) pair, n_items in
// all.
struct ShwPlan {
  const int* kept;   // (n_pairs, n_chunks): each pair's kept chunks
  const int* nk;     // (n_pairs): their count
  const int* off;    // (n_pairs + 1): each pair's first item; the items
  const int* items;  // the pair of each item
  int n_pairs, n_chunks, run, runs, n_items;
};

// The masked kernels' plan, a warp a (tile, source) pair p (the mask's row
// p): the pair's kept chunks in order into kept[p n_chunks ...] and their
// count into nk[p].
__global__ void __launch_bounds__(kPlanThreads)
    shw_plan_kernel(const int* __restrict__ mask, int n_pairs, int n_chunks,
                    int* __restrict__ kept, int* __restrict__ nk) {
  const int lane = threadIdx.x & 31;
  const long long p =
      (static_cast<long long>(blockIdx.x) * kPlanThreads + threadIdx.x) >> 5;
  if (p >= n_pairs) return;  // the same for the warp
  const int* row = mask + p * n_chunks;
  int* out = kept + p * n_chunks;
  int k = 0;
  for (int base = 0; base < n_chunks; base += 32) {
    const int c = base + lane;
    const bool on = c < n_chunks && row[c] != 0;
    const unsigned bits = __ballot_sync(0xffffffffu, on);
    if (on) out[k + __popc(bits & ((1u << lane) - 1u))] = c;
    k += __popc(bits);
  }
  if (lane == 0) nk[p] = k;
}

// The run of K10a's and K10b's work items
// (kernels/soft_raytrace.py::primary_fwd_run): the mean of `kept` chunks
// over n_tiles tiles, rounded up, over `splits`, rounded up, at least
// run_min.
__host__ __device__ __forceinline__ int pri_fwd_run(long long kept,
                                                    int n_tiles, int splits,
                                                    int run_min) {
  const long long mean = (kept + n_tiles - 1) / n_tiles;
  const long long run = (mean + splits - 1) / splits;
  return static_cast<int>(run > run_min ? run : run_min);
}

// K10b's run, one block: pri_fwd_run of the tiles' kept chunks (nk, the
// sum in any order: integers), written to *run_out for shw_items_kernel and
// the kernels, on the card, with no host sync.
__global__ void __launch_bounds__(kScanThreads)
    pri_fwd_run_kernel(const int* __restrict__ nk, int n_tiles, int splits,
                       int run_min, int* __restrict__ run_out) {
  __shared__ int s_sum[kScanThreads];
  const int tid = threadIdx.x;
  int kept = 0;  // at most n_tiles n_chunks < 2^31 (fwd_plan_shapes)
  for (int p = tid; p < n_tiles; p += kScanThreads) kept += nk[p];
  s_sum[tid] = kept;
  __syncthreads();
  for (int d = kScanThreads / 2; d > 0; d >>= 1) {
    if (tid < d) s_sum[tid] += s_sum[tid + d];
    __syncthreads();
  }
  if (tid == 0) *run_out = pri_fwd_run(s_sum[0], n_tiles, splits, run_min);
}

// The masked kernels' items, one block: pair p's ceil(nk[p] / run) runs are
// items off[p] ... off[p + 1] - 1, in pair order; items[i] is the pair of
// item i and off[n_pairs] the number of items. run_dev, where not null
// (K10b), holds the run in place of `run`.
__global__ void __launch_bounds__(kScanThreads)
    shw_items_kernel(const int* __restrict__ nk, int n_pairs, int run,
                     const int* __restrict__ run_dev, int* __restrict__ off,
                     int* __restrict__ items) {
  __shared__ int s_sum[kScanThreads];
  if (run_dev != nullptr) run = *run_dev;
  const int tid = threadIdx.x;
  const int per = (n_pairs + kScanThreads - 1) / kScanThreads;
  const int lo = static_cast<int>(
      min(static_cast<long long>(n_pairs), static_cast<long long>(tid) * per));
  const int hi = min(n_pairs, lo + per);
  int sum = 0;
  for (int p = lo; p < hi; ++p) sum += (nk[p] + run - 1) / run;
  s_sum[tid] = sum;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {  // inclusive scan
    const int v = tid >= d ? s_sum[tid - d] : 0;
    __syncthreads();
    s_sum[tid] += v;
    __syncthreads();
  }
  int at = s_sum[tid] - sum;
  for (int p = lo; p < hi; ++p) {
    const int r = (nk[p] + run - 1) / run;
    off[p] = at;
    for (int j = 0; j < r; ++j) items[at + j] = p;
    at += r;
  }
  if (tid == kScanThreads - 1) off[n_pairs] = s_sum[tid];
}

// Work item `it`: its (tile, source) pair and its n chunks, the k-th at
// item_chunk(x, k).
struct ShwItem {
  int pair, n, c0;
  const int* list;
};

template <bool kMasked>
__device__ __forceinline__ ShwItem shw_item(const ShwPlan& pl, int it) {
  ShwItem x;
  if (kMasked) {
    x.pair = pl.items[it];
    const int k0 = (it - pl.off[x.pair]) * pl.run;
    x.n = min(pl.run, pl.nk[x.pair] - k0);
    x.list = pl.kept + static_cast<size_t>(x.pair) * pl.n_chunks + k0;
    x.c0 = 0;
  } else {
    x.pair = it / pl.runs;
    x.c0 = (it % pl.runs) * pl.run;
    x.n = min(pl.run, pl.n_chunks - x.c0);
    x.list = nullptr;
  }
  return x;
}

template <bool kMasked>
__device__ __forceinline__ int item_chunk(const ShwItem& x, int k) {
  return kMasked ? x.list[k] : x.c0 + k;
}

template <bool kMasked>
__device__ __forceinline__ int item_count(const ShwPlan& pl) {
  return kMasked ? pl.off[pl.n_pairs] : pl.n_items;
}

// Pair p's first item and its number of runs.
template <bool kMasked>
__device__ __forceinline__ int2 pair_items(const ShwPlan& pl, int p) {
  if (kMasked) return make_int2(pl.off[p], pl.off[p + 1] - pl.off[p]);
  return make_int2(p * pl.runs, pl.runs);
}

// The fold of a merge (K9a/K9b's and K10a/K10b's): the n items' partials at
// p, item k's at p + k item_stride, each its (m, s, acc[N]) in fields
// field_stride floats apart, folded in run order into the background (m,
// s, acc) = (0, 1, 0): m' = max(m, m_k), s = s e^(m - m') + s_k e^(m_k -
// m'), acc likewise.
template <int N>
__device__ __forceinline__ void fold_items(const float* p, int n,
                                           size_t item_stride,
                                           int field_stride, float* m,
                                           float* s, float* acc) {
  float mm = 0.0f, ss = 1.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float* q = p + static_cast<size_t>(k) * item_stride;
    const float mj = q[0];
    const float m_new = fmaxf(mm, mj);
    const float a = expf(mm - m_new), b = expf(mj - m_new);
    ss = ss * a + q[field_stride] * b;
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc[j] = acc[j] * a + q[(2 + j) * field_stride] * b;
    mm = m_new;
  }
  *m = mm;
  *s = ss;
}

// A call's scratch, carved from one buffer at base (0: sized only) in the
// order of the take calls, each part aligned to 16 bytes; at ends as the
// bytes the call needs.
struct Carve {
  uintptr_t base;
  size_t at;
  template <class T>
  T* take(size_t n) {
    const uintptr_t q = n == 0 ? 0 : base + at;
    at += (n * sizeof(T) + 15) / 16 * 16;
    return reinterpret_cast<T*>(q);
  }
};

// Whether a buffer at base of avail bytes holds the need bytes of a call.
inline bool scratch_fits(size_t need, const void* base, long long avail) {
  return need == 0 ||
         (base != nullptr && avail >= static_cast<long long>(need));
}

// A forward's work items (K10a/K10b's, K9a/K9b's): what follows from the
// call's shapes and run rule (fwd_plan_shapes) and where the plan and the
// items' partials lie in its scratch (carve_fwd_plan).
struct FwdPlan {
  bool masked, direct;
  int n_tiles, n_chunks, run_min, splits, run, runs;
  long long max_items;
  int* kept;
  int* nk;
  int* off;
  int* item_tiles;
  int* run_dev;
  float* part;

  ShwPlan view() const {
    return ShwPlan{kept,    nk,  off,  item_tiles, n_tiles,
                   n_chunks, run, runs, static_cast<int>(max_items)};
  }
};

// The split is ceil(items / tiles_ref), the same with a mask and without
// (tiles_ref: the tiles of the call's full grid); unmasked, every tile
// keeps every chunk (mean n_chunks) and has `runs` items (direct: one).
// Masked, the run is worked out on the card, at least run_min and the mean
// over the split, so a tile has at most ceil(n_chunks / run_min) items and
// all of them at most n_tiles (splits + 1). False where the kernels refuse
// the shapes.
inline bool fwd_plan_shapes(FwdPlan& fp, bool masked, int n_tiles,
                            int tiles_ref, int n_chunks, int run_min,
                            int items) {
  fp.masked = masked;
  fp.n_tiles = n_tiles;
  fp.n_chunks = n_chunks;
  fp.run_min = run_min;
  const long long kept = static_cast<long long>(n_tiles) * n_chunks;
  if (n_tiles < 1 || tiles_ref < 1 || run_min < 1 || items < 1 ||
      kept > 0x7fffffffLL)
    return false;
  fp.splits = (items + tiles_ref - 1) / tiles_ref;
  fp.run = pri_fwd_run(kept, n_tiles, fp.splits, run_min);
  fp.runs = (n_chunks + fp.run - 1) / fp.run;
  const long long most = (n_chunks + run_min - 1) / run_min;
  const long long per_tile =
      !masked ? fp.runs : (fp.splits + 1LL < most ? fp.splits + 1LL : most);
  fp.max_items = n_tiles * per_tile;
  fp.direct = !masked && fp.runs == 1;
  return fp.max_items <= 0x7fffffffLL;
}

// Carves the plan (masked: the kept lists n_tiles n_chunks, nk n_tiles,
// off n_tiles + 1, the items' tiles max_items and the run, int32) and the
// items' partials (part_floats an item, unless direct) from c.
inline void carve_fwd_plan(FwdPlan& fp, Carve& c, size_t part_floats) {
  const size_t items = static_cast<size_t>(fp.max_items);
  const size_t m = fp.masked ? 1 : 0;
  fp.kept = c.take<int>(m * fp.n_tiles * static_cast<size_t>(fp.n_chunks));
  fp.nk = c.take<int>(m * fp.n_tiles);
  fp.off = c.take<int>(m * (fp.n_tiles + 1));
  fp.item_tiles = c.take<int>(m * items);
  fp.run_dev = c.take<int>(m);
  fp.part = c.take<float>((fp.direct ? 0 : 1) * items * part_floats);
}

// The plan's launches on st (masked only): each tile's kept chunks from
// its mask row, the run, and the items. Returns the first cudaError_t.
inline cudaError_t launch_fwd_plan(const FwdPlan& fp, const int* mask,
                                   cudaStream_t st) {
  if (!fp.masked) return cudaSuccess;
  shw_plan_kernel<<<(fp.n_tiles + kPlanThreads / 32 - 1) / (kPlanThreads / 32),
                    kPlanThreads, 0, st>>>(mask, fp.n_tiles, fp.n_chunks,
                                           fp.kept, fp.nk);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pri_fwd_run_kernel<<<1, kScanThreads, 0, st>>>(fp.nk, fp.n_tiles,
                                                 fp.splits, fp.run_min,
                                                 fp.run_dev);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  shw_items_kernel<<<1, kScanThreads, 0, st>>>(fp.nk, fp.n_tiles, 0,
                                               fp.run_dev, fp.off,
                                               fp.item_tiles);
  return cudaGetLastError();
}

}  // namespace
