// The (ray, triangle row) test shared by the brute triangle kernel (K6,
// closest_tri.cu) and the grid-culled one (K7, closest_tri_culled.cu), so
// the two cannot drift apart: op for op the JAX kernels' per-chunk body
// (iq's triIntersect, scene.cpp:52-70). Built with --fmad=false, so each op
// rounds as there and as in the plain versions
// (ops/mesh_pallas.py::_tri_test).

#pragma once

#include "lane.cuh"

namespace smallpt {

// A table row [v0(3) e1(3) e2(3) n(3) valid id 0 0] read as four float4s:
//   a = v0x v0y v0z e1x;  b = e1y e1z e2x e2y;  c = e2z nx ny nz;
//   d = valid id(column 13, K7's tables) 0 0.
struct TriRow {
  float4 a, b, c, d;
};

__device__ __forceinline__ TriRow load_tri_row(const float4* rows, int k) {
  return TriRow{rows[4 * k], rows[4 * k + 1], rows[4 * k + 2],
                rows[4 * k + 3]};
}

// Whether the ray (o, d) is a candidate for the row (inside the barycentric
// bounds, dn != 0, t > eps; the caller skips rows with valid 0), and its
// (t, u, v):
//   rov0 = o - v0;  q = cross(rov0, d);  dn = dot(d, n)
//   inv = 1 / (dn == 0 ? 1 : dn)
//   u = -dot(q, e2) * inv;  v = dot(q, e1) * inv;  t = -dot(n, rov0) * inv
__device__ __forceinline__ bool tri_candidate(float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              const TriRow& r, float eps,
                                              float& t, float& u, float& v) {
  const float rx = ox - r.a.x;
  const float ry = oy - r.a.y;
  const float rz = oz - r.a.z;
  const float qx = ry * dz - rz * dy;
  const float qy = rz * dx - rx * dz;
  const float qz = rx * dy - ry * dx;
  const float dn = dx * r.c.y + dy * r.c.z + dz * r.c.w;
  const float inv = 1.0f / (dn == 0.0f ? 1.0f : dn);
  u = -(qx * r.b.z + qy * r.b.w + qz * r.c.x) * inv;
  v = (qx * r.a.w + qy * r.b.x + qz * r.b.y) * inv;
  t = -(r.c.y * rx + r.c.z * ry + r.c.w * rz) * inv;
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && (u + v) <= 1.0f &&
         dn != 0.0f && t > eps;
}

}  // namespace smallpt
