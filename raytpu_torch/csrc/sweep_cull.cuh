// The exact tests of the port's ray-triangle sweeps (sm_90a): the
// division-free reject of one test (shadow_reject, primary_reject), the
// per-box triangle cull (box_reject on a DirBox), the triangle-major load of
// a constant block, and the one-chunk sweeps of a warp over a staged block
// (warp_closest, warp_blocked).
//
// intersect.cu (K4 and L2, K5, K7d, K7a, K6, K7b, K7c) and render_fused.cu
// (K1) include it. Every test here decides only what plane_test
// (plane_test.cuh) would decide the same way from the same sums formed in
// the same order: a culled or rejected primary test is one whose ok is
// false, a culled or rejected shadow test one whose ok && t < 0.99 is, so a
// sweep that leaves them out gives the brute sweep's bits.
// kernels/intersect.py holds the plain forms (shadow_reject,
// primary_tile_reject, sweep_cull_decisions), and the card probes them
// (raytpu_shadow_reject_probe, raytpu_primary_cull_probe,
// raytpu_sweep_cull_probe).

#pragma once

#include <cfloat>
#include <cmath>
#include <cstddef>

#include "plane_test.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kShadowT = 0x1.fae148p-1f;  // float32(0.99)

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
// itself is never formed. kBelowT false drops the t >= 0.99 clause, which
// only a shadow test fails by: every other clause implies plane_test's ok
// is false, which is the primary sweep's reject (primary_reject).
template <bool kBelowT>
__device__ __forceinline__ bool reject_test(float Dn, float U, float V,
                                            float K) {
  const float Ds = fabsf(Dn);
  const float Us = flip_by(U, Dn), Vs = flip_by(V, Dn), Ks = flip_by(K, Dn);
  const bool guard = (Ds >= kRejectMinD) & (Ds <= kRejectMaxD);
  const bool miss = (Us < -kRejectEps) | (Vs < -kRejectEps) |
                    (Ks < -kRejectEps) | (kBelowT & (Ks >= Ds * kRejectT)) |
                    (Us + Vs > Ds * kRejectUV);
  return (Dn == 0.0f) | (guard & miss);
}

__device__ __forceinline__ bool shadow_reject(float Dn, float U, float V,
                                              float K) {
  return reject_test<true>(Dn, U, V, K);
}

__device__ __forceinline__ bool primary_reject(float Dn, float U, float V,
                                               float K) {
  return reject_test<false>(Dn, U, V, K);
}

// A box of ray directions: lo and hi of dx, dy and dz over the valid lanes
// of a group (a warp, or the 256 rays of a tile); `any` where the group
// holds a valid lane, `finite` where every valid lane's direction is.
struct DirBox {
  float lo[3], hi[3];
  bool any, finite;
};

// The box of this warp's valid lanes, known to every lane.
__device__ __forceinline__ DirBox warp_box(bool valid, float dx, float dy,
                                           float dz) {
  DirBox b;
  const float d[3] = {dx, dy, dz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float lo = valid ? d[k] : INFINITY, hi = valid ? d[k] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFullMask, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFullMask, hi, o));
    }
    b.lo[k] = lo;
    b.hi[k] = hi;
  }
  b.any = __any_sync(kFullMask, valid);
  b.finite = __all_sync(kFullMask, !valid || (isfinite(dx) && isfinite(dy) &&
                                              isfinite(dz)));
  return b;
}

// The sum plane_test forms for the coefficient row (p, q, r),
// fl(fl(fl(x p) + fl(y q)) + fl(z r)) in shadow_dots' order, at the corner
// of the box where each product is largest (top) or smallest.
__device__ __forceinline__ float corner_dot(const DirBox& b, float p, float q,
                                            float r, bool top) {
  const float x = (p >= 0.0f) == top ? b.hi[0] : b.lo[0];
  const float y = (q >= 0.0f) == top ? b.hi[1] : b.lo[1];
  const float z = (r >= 0.0f) == top ? b.hi[2] : b.lo[2];
  return (x * p + y * q) + z * r;
}

// True where no ray of the box can pass plane_test on the triangle with
// triangle-major constants a = (n, k0), b = (c2, c3.x), c = (c3.y, c3.z)
// (kernels/intersect.py::primary_tile_reject is the plain form, op by op);
// with kBelowT, where no ray of the box can pass a shadow test (ok && t <
// 0.99).
//
// Exact, with no margin. Rounding to nearest is monotone in each operand of
// a product and of a sum, so over the box every lane's Dn, U and V (the
// sums shadow_dots forms) lies between their values at the two corners
// corner_dot picks, computed by the same expression. Where Dn keeps one
// sign over the box and |Dn| lies in [2^-40, 2^40] at both ends, every
// lane is inside the guard of reject_test with the same sign flip, and one
// of its clauses holding at the bound holds at every lane: with Dn > 0
// (Us = -U, Vs = -V, Ks = -K) min U > 2^-80, min V > 2^-80, K > 2^-80, or
// fl(-max U - max V) > fl(max Dn kRejectUV), since each lane's fl(Us + Vs)
// is at least the first and its fl(Ds kRejectUV) at most the second; with
// Dn < 0 (Us = U) the mirror. Each of those clauses implies that
// plane_test's ok is false (reject_test's argument). kBelowT adds the
// t >= 0.99 clause, Ks >= fl(Ds kRejectT): with Dn > 0 every lane's Ds =
// Dn is at most max Dn and fl(Dn kRejectT) <= fl(max Dn kRejectT) by
// monotone rounding, so -K >= fl(max Dn kRejectT) gives the clause at every
// lane; with Dn < 0 (Ds = -Dn <= -min Dn, Ks = K) the mirror,
// K >= fl(-min Dn kRejectT). For a warp of shadow rays e = pos - light it
// culls the surface the points lie on and what lies beyond them. Where
// both bounds of Dn are 0, every lane's Dn is 0 and plane_test's nonpar
// false: a zero (padding or invalid) triangle, culled everywhere. A bound
// that overflows into an infinity of the wrong sign, or a NaN, makes its
// comparison false. A box with a non-finite component, or a non-finite
// coefficient, culls nothing; a box of no valid lane culls everything.
template <bool kBelowT = false>
__device__ __forceinline__ bool box_reject(const DirBox& bx, float4 a,
                                           float4 b, float2 c) {
  if (!bx.any) return true;
  if (!bx.finite ||
      !(isfinite(a.x) && isfinite(a.y) && isfinite(a.z) && isfinite(a.w) &&
        isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w) &&
        isfinite(c.x) && isfinite(c.y)))
    return false;
  const float d_hi = corner_dot(bx, a.x, a.y, a.z, true);
  const float d_lo = corner_dot(bx, a.x, a.y, a.z, false);
  if ((d_lo == 0.0f) & (d_hi == 0.0f)) return true;  // every Dn 0: nonpar
  const bool pos = (d_lo >= kRejectMinD) & (d_hi <= kRejectMaxD);
  const bool neg = (d_hi <= -kRejectMinD) & (d_lo >= -kRejectMaxD);
  if (!(pos | neg)) return false;
  const float u_hi = corner_dot(bx, b.x, b.y, b.z, true);
  const float u_lo = corner_dot(bx, b.x, b.y, b.z, false);
  const float v_hi = corner_dot(bx, b.w, c.x, c.y, true);
  const float v_lo = corner_dot(bx, b.w, c.x, c.y, false);
  if (pos)
    return (u_lo > kRejectEps) | (v_lo > kRejectEps) | (a.w > kRejectEps) |
           (-(u_hi + v_hi) > d_hi * kRejectUV) |
           (kBelowT & (-a.w >= d_hi * kRejectT));
  return (u_hi < -kRejectEps) | (v_hi < -kRejectEps) | (a.w < -kRejectEps) |
         (u_lo + v_lo > -d_lo * kRejectUV) |
         (kBelowT & (a.w >= -d_lo * kRejectT));
}

// The triangle-major constants of column i of a 10-row block at `blk` (row
// stride Tp): (n, k0), (c2, c3.x), (c3.y, c3.z).
__device__ __forceinline__ void load_tri(const float* __restrict__ blk,
                                         int Tp, int i, float4* a, float4* b,
                                         float2* c) {
  const size_t s = static_cast<size_t>(Tp);
  *a = make_float4(blk[i], blk[s + i], blk[2 * s + i], blk[9 * s + i]);
  *b = make_float4(blk[3 * s + i], blk[4 * s + i], blk[5 * s + i],
                   blk[6 * s + i]);
  *c = make_float2(blk[7 * s + i], blk[8 * s + i]);
}

// ---------------------------------------------------------------------------
// One chunk swept a warp at a time (K4, L2 and K1): a block of at most
// kSweepMaxTris triangles staged triangle-major in shared memory, the
// warps' rays, and the two sweeps.

constexpr int kSweepMaxTris = 128;

// A 10-row block triangle-major, 40 bytes a triangle.
struct TriBlock {
  float4 a[kSweepMaxTris];
  float4 b[kSweepMaxTris];
  float2 c[kSweepMaxTris];
};

// Triangle k < C of the 10-row block at blk (row stride C) into s; one
// thread a triangle, the caller syncs.
__device__ __forceinline__ void stage_tri(TriBlock& s,
                                          const float* __restrict__ blk,
                                          int C, int k) {
  float4 a, b;
  float2 c;
  load_tri(blk, C, k, &a, &b, &c);
  s.a[k] = a;
  s.b[k] = b;
  s.c[k] = c;
}

struct SweepRay {
  int r;
  bool valid;
};

// The blocks of `threads` lanes that sweep_ray's warps of wh x (32 / wh)
// rays of an H x W grid take, or -1 where the shapes are refused (C outside
// [1, kSweepMaxTris], wh not dividing 32, H W past an int).
inline long long sweep_blocks(int C, int H, int W, int wh, int threads) {
  if (C < 1 || C > kSweepMaxTris || H < 0 || W < 0 || wh < 1 ||
      32 % wh != 0 || static_cast<long long>(H) * W >= (1LL << 31))
    return -1;
  const long long ww = 32 / wh;
  const long long warps = ((H + wh - 1LL) / wh) * ((W + ww - 1) / ww);
  return (warps + threads / 32 - 1) / (threads / 32);
}

// This lane's ray. Warp g of the launch (warp w of block b is g = b
// blockDim.x / 32 + w) takes a block of wh x (32 / wh) rays of the H x W
// grid (ray y W + x), the warps row-major over the grid, and lane k its
// ray (k / (32 / wh), k % (32 / wh)); a lane past the grid's edge is not
// valid. H = 1, W = R, wh = 1: 32 consecutive rays a warp
// (kernels/intersect.py::sweep_warps is the plain form).
__device__ __forceinline__ SweepRay sweep_ray(int H, int W, int wh) {
  const int ww = 32 / wh, lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int warps_x = (W + ww - 1) / ww;
  const int y = (g / warps_x) * wh + lane / ww;
  const int x = (g % warps_x) * ww + lane % ww;
  const bool valid = y < H && x < W;
  return {valid ? y * W + x : 0, valid};
}

// The primary closest hit of this lane's ray d over the C triangles staged
// in s. The warp bounds its valid lanes' directions (warp_box); lane i
// decides triangles i, i + 32, ... against the box (box_reject), a ballot a
// group of 32, and every lane then tests the group's survivors in triangle
// order (a broadcast read): primary_reject first, plane_test's verdict from
// the same sums only where it leaves the test open, and `<=` (the last of
// equal t wins). A culled or rejected test is one whose ok is false:
// leaving it out moves idx only while t is still F32MAX, where the brute
// sweep's idx ends as -1, so t equals the brute sweep's, and idx wherever t
// is not F32MAX. Every lane of the warp calls it. Returns t (FLT_MAX on a
// miss) and sets *bi (-1 where no test passed).
__device__ __forceinline__ float warp_closest(const TriBlock& s, int C,
                                              bool valid, float dx, float dy,
                                              float dz, int* bi) {
  const int lane = threadIdx.x & 31;
  const DirBox box = warp_box(valid, dx, dy, dz);
  float bt = FLT_MAX;
  int best = -1;
  for (int g = 0; g < C && box.any; g += 32) {  // warp-uniform
    const int i = g + lane;
    const bool live = i < C && !box_reject(box, s.a[i], s.b[i], s.c[i]);
    unsigned bits = __ballot_sync(kFullMask, live);
    while (bits != 0u) {
      const int j = g + __ffs(bits) - 1;
      bits &= bits - 1u;
      const float4 a = s.a[j];
      float Dn, U, V;
      shadow_dots(a, s.b[j], s.c[j], dx, dy, dz, &Dn, &U, &V);
      if (valid && !primary_reject(Dn, U, V, a.w)) {
        const PlaneHit p = plane_from_dots(Dn, U, V, a.w);
        if (p.ok && p.t <= bt) {
          bt = p.t;
          best = j;
        }
      }
    }
  }
  *bi = best;
  return bt;
}

// Whether one of the C triangles staged in s blocks this lane's shadow ray
// e (ok && t < 0.99), swept in triangle order to the first blocker. The
// warp bounds its sweeping lanes' e (warp_box) and, while a lane sweeps,
// decides each group of 32 triangles against the box with the t >= 0.99
// clause too (box_reject<true>); each lane tests the group's survivors,
// shadow_reject first and plane_test's verdict from the same sums only
// where the reject leaves the test open, and stops at its first blocker;
// the warp leaves once no lane sweeps. A culled or rejected test does not
// block, so the bit is the brute sweep's. Every lane of the warp calls it;
// a lane that does not `sweep` returns false.
__device__ __forceinline__ bool warp_blocked(const TriBlock& s, int C,
                                             bool sweep, float ex, float ey,
                                             float ez) {
  const int lane = threadIdx.x & 31;
  const DirBox box = warp_box(sweep, ex, ey, ez);
  bool sweeping = sweep, blocked = false;
  for (int g = 0; g < C && __any_sync(kFullMask, sweeping); g += 32) {
    const int i = g + lane;
    const bool live =
        i < C && !box_reject<true>(box, s.a[i], s.b[i], s.c[i]);
    unsigned bits = __ballot_sync(kFullMask, live);
    while (bits != 0u) {
      const int j = g + __ffs(bits) - 1;
      bits &= bits - 1u;
      if (!sweeping) continue;
      const float4 a = s.a[j];
      float Dn, U, V;
      shadow_dots(a, s.b[j], s.c[j], ex, ey, ez, &Dn, &U, &V);
      if (shadow_reject(Dn, U, V, a.w)) continue;
      const PlaneHit p = plane_from_dots(Dn, U, V, a.w);
      if (p.ok && p.t < kShadowT) {
        blocked = true;
        sweeping = false;
      }
    }
  }
  return blocked;
}

}  // namespace
