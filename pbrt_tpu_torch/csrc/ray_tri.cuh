// The ray-triangle test shared by the port's kernels (fused_path.cu,
// intersect.cu, bvh_traverse.cu): Moeller-Trumbore on a triangle stored as
// v0, e1 = v1 - v0, e2 = v2 - v0, both sides, 46 float operations.
//
// A hit needs |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t > 1e-4 and
// t < best_t (strict: the first triangle tested wins a tie). The operation
// order is that of the plain-torch twins (ops/intersect.py, ops/bvh.py); the
// kernels build with --fmad=false and without fast math, so no multiply-add
// is contracted and the division is the correctly rounded one.

#pragma once

__device__ __forceinline__ bool ray_tri_hit(
    float ox, float oy, float oz, float dx, float dy, float dz, float v0x,
    float v0y, float v0z, float e1x, float e1y, float e1z, float e2x,
    float e2y, float e2z, float best_t, float& t_hit) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool okd = fabsf(det) > 1e-12f;
  const float inv_det = okd ? 1.0f / det : 0.0f;
  const float rx = ox - v0x;
  const float ry = oy - v0y;
  const float rz = oz - v0z;
  const float u = (rx * px + ry * py + rz * pz) * inv_det;
  const float qx = ry * e1z - rz * e1y;
  const float qy = rz * e1x - rx * e1z;
  const float qz = rx * e1y - ry * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  t_hit = t;
  return okd && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t > 1e-4f) && (t < best_t);
}
