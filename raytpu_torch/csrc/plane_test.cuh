// The ray-triangle plane test shared by the port's kernels (sm_90a).
//
// Counterpart of raytpu/kernels/intersect_pallas.py::_chunk_tuv. A constant
// block is 10 rows of C floats, row-major: [n xyz | c2 xyz | c3 xyz | k0]
// (kernels/tables.py::_constant_rows). Built with -fmad=false and IEEE
// division, each expression in the JAX kernel's operation order, so the
// result equals ops/intersect.py::plane_tests bit for bit on the card.

#pragma once

namespace {

struct PlaneHit {
  float t;
  bool ok;
};

// One ray against triangle i of a 10-row constant block [n | c2 | c3 | k0]
// (intersect_pallas.py::_chunk_tuv): one reciprocal, three multiplies,
// inclusive barycentric bounds, and no hit for a zero denominator.
__device__ __forceinline__ PlaneHit plane_test(const float* blk, int C, int i,
                                               float dx, float dy, float dz) {
  const float denom =
      -((dx * blk[0 * C + i] + dy * blk[1 * C + i]) + dz * blk[2 * C + i]);
  const bool nonpar = denom != 0.0f;
  const float rec = 1.0f / (nonpar ? denom : 1.0f);
  const float t = blk[9 * C + i] * rec;
  const float u =
      ((dx * blk[3 * C + i] + dy * blk[4 * C + i]) + dz * blk[5 * C + i]) *
      rec;
  const float v =
      ((dx * blk[6 * C + i] + dy * blk[7 * C + i]) + dz * blk[8 * C + i]) *
      rec;
  return {t, (u + v <= 1.0f) && (u >= 0.0f) && (v >= 0.0f) && (t >= 0.0f) &&
                 nonpar};
}

}  // namespace
