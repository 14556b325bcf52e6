// Möller-Trumbore ray/triangle test shared by the hit kernels: the epsilons and the order of every operation of the
// plain version, ops/intersect.py:mt_intersect. The library is built with
// --fmad=false, so no product is contracted into an FMA, and 1.0f / det is
// IEEE division: the test gives the plain version's float32 results bit for
// bit.

#pragma once

namespace nrd {

constexpr float kEps = 1e-7f;                       // intersect.EPS
constexpr float kBaryLo = (float)(-1e-6);           // u, v >= -1e-6
constexpr float kBaryHi = (float)(1.0 + 1e-6);      // u + v <= 1 + 1e-6
constexpr float kTMin = (float)(1e-5);              // t > 1e-5

// Ray (o, d) against the triangle p0, e1 = p1 - p0, e2 = p2 - p0. Writes t,
// u, v and returns whether the ray hits it; backfaces count (two-sided
// traversal).
__device__ __forceinline__ bool mt_hit_values(float ox, float oy, float oz, float dx, float dy,
                                              float dz, float p0x, float p0y, float p0z,
                                              float e1x, float e1y, float e1z, float e2x,
                                              float e2y, float e2z, float& t, float& u,
                                              float& v) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool small = fabsf(det) < kEps;
  const float inv_det = small ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return !small && u >= kBaryLo && v >= kBaryLo && u + v <= kBaryHi && t > kTMin;
}

// The test on the triangle [p0, e1, e2] whose 9 floats lie kStride apart (1:
// one triangle's floats contiguous; 128: the plane-major tile of a cluster,
// tri pointing at triangle k of plane 0).
template <int kStride>
__device__ __forceinline__ bool mt_hit_strided(float ox, float oy, float oz, float dx, float dy,
                                               float dz, const float* tri, float& t, float& u,
                                               float& v) {
  return mt_hit_values(ox, oy, oz, dx, dy, dz, tri[0], tri[kStride], tri[2 * kStride],
                       tri[3 * kStride], tri[4 * kStride], tri[5 * kStride], tri[6 * kStride],
                       tri[7 * kStride], tri[8 * kStride], t, u, v);
}

// The test on one triangle's 9 contiguous floats.
__device__ __forceinline__ bool mt_hit(float ox, float oy, float oz, float dx, float dy,
                                       float dz, const float* tri, float& t, float& u,
                                       float& v) {
  return mt_hit_strided<1>(ox, oy, oz, dx, dy, dz, tri, t, u, v);
}

}  // namespace nrd
