// kd-tree closest-hit walk for Hopper (sm_90a).
//
// Replaces no Pallas kernel: pbrt_tpu walks its kd-tree
// (pbrt_tpu/scene/kdtree.py::_traverse_one, a vmapped lax.while_loop) in
// plain JAX. This is the port's own kernel for the same walk, the near/far
// stack walk of pbrt's KdTreeAccel::Intersect (kdtreeaccel.cpp:350+), so
// that a scene with `Accelerator "kdtree"` traces its triangles on the card.
//
// One ray a thread. The ray is clipped to the tree's world box, then a
// (node, tmin, tmax) stack of STACK_DEPTH (64) entries, in local memory,
// walks the tree: a popped node whose tmin exceeds min(its tmax, best t) is
// skipped; a leaf tests its n_prims triangles (prim_ids order, strict
// t < best t, so a triangle met again in a later leaf keeps the first hit);
// an interior node pushes its far child, then its near child, or only the
// child the ray's [tmin, tmax] reaches, with pbrt's precedence: the plane
// beyond tmax or behind the origin (tPlane <= 0) sends the ray to the near
// child only, before tPlane < tmin sends it to the far one. A ray on the
// split plane goes below first when its direction along the axis is <= 0.
//
// Tables: nodes as 16-byte records (split position's bits, axis with 3 a
// leaf, above child or the leaf's offset into prim_ids, prim count),
// read through __ldg; prim_ids; triangles as 9 floats v0, e1, e2
// (ops/kdtree.py::pack_tris); the world box as 6 floats.
//
// What bounds it on this card: the triangle tests and node steps a ray
// needs (46 float operations a test, none a fused multiply-add, so at most
// half the float32 rate), and the dependent loads of the walk: each step
// reads one node record and each test one prim id and 36 bytes of
// triangle, all at addresses only the ray's own walk knows. The design is
// the simple one: no packets, no staging, no ray reordering.
//
// Numerics follow the plain-torch twin (ops/kdtree.py::traverse_reference)
// operation by operation: built with --fmad=false and without fast math, so
// no multiply-add is contracted and the division is the correctly rounded
// one; minima and maxima propagate NaN as torch.minimum / torch.maximum do.
// The kernel then equals the twin bit for bit. The triangle test is
// ray_tri.cuh, pbrt_tpu's intersect_triangle_paired in its own order.

#include <cuda_runtime.h>

#include "ray_tri.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 64;  // ops/kdtree.py STACK_DEPTH
constexpr int kLeaf = 3;

struct Args {
  const float *o, *d, *tmax;
  const int4* nodes;
  const int* prim_ids;
  const float* tris;
  const float* world;  // lo xyz, hi xyz
  float* t_out;
  int* prim_out;
  int R, n_prim_ids;
};

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float pick(int ax, float x, float y, float z) {
  return ax == 0 ? x : (ax == 1 ? y : z);
}

__global__ void __launch_bounds__(kBlock) kd_traverse_kernel(const Args a) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= a.R) return;
  const float ox = a.o[3 * r], oy = a.o[3 * r + 1], oz = a.o[3 * r + 2];
  const float dx = a.d[3 * r], dy = a.d[3 * r + 1], dz = a.d[3 * r + 2];
  const float ix = 1.0f / (fabsf(dx) > 1e-12f ? dx : 1e-12f);
  const float iy = 1.0f / (fabsf(dy) > 1e-12f ? dy : 1e-12f);
  const float iz = 1.0f / (fabsf(dz) > 1e-12f ? dz : 1e-12f);

  // clip to the world box
  const float t0x = (a.world[0] - ox) * ix, t1x = (a.world[3] - ox) * ix;
  const float t0y = (a.world[1] - oy) * iy, t1y = (a.world[4] - oy) * iy;
  const float t0z = (a.world[2] - oz) * iz, t1z = (a.world[5] - oz) * iz;
  const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                           nan_min(t0z, t1z));
  const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                           nan_max(t0z, t1z));
  float best_t = a.tmax[r];
  int best_i = -1;
  const float tmin0 = nan_max(tn, 0.0f);
  const float tmax0 = nan_min(tf, best_t);

  int sn[kStack];
  float s0[kStack], s1[kStack];
  sn[0] = 0;
  s0[0] = tmin0;
  s1[0] = tmax0;
  int sp = (tmin0 <= tmax0) ? 1 : 0;
  while (sp > 0) {
    --sp;
    const int node = sn[sp];
    const float tmin = s0[sp];
    const float tmaxn = nan_min(s1[sp], best_t);
    if (tmin > tmaxn) continue;
    const int4 nd = __ldg(a.nodes + node);
    if (nd.y == kLeaf) {
      for (int k = 0; k < nd.w; ++k) {
        const int pi = __ldg(a.prim_ids + min(max(nd.z + k, 0),
                                              a.n_prim_ids - 1));
        const float* row = a.tris + 9 * (long long)pi;
        float t;
        if (ray_tri_hit(ox, oy, oz, dx, dy, dz, __ldg(row), __ldg(row + 1),
                        __ldg(row + 2), __ldg(row + 3), __ldg(row + 4),
                        __ldg(row + 5), __ldg(row + 6), __ldg(row + 7),
                        __ldg(row + 8), best_t, t)) {
          best_t = t;
          best_i = pi;
        }
      }
      continue;
    }
    const int ax = nd.y;
    const float split = __int_as_float(nd.x);
    const float o_ax = pick(ax, ox, oy, oz);
    const float d_ax = pick(ax, dx, dy, dz);
    const float t_plane = (split - o_ax) * pick(ax, ix, iy, iz);
    const bool below_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
    const int first = below_first ? node + 1 : nd.z;
    const int second = below_first ? nd.z : node + 1;
    const bool near_only = (t_plane > tmaxn) || (t_plane <= 0.0f);
    const bool far_only = t_plane < tmin;
    if (!near_only && !far_only) {
      // far child under the near one
      sn[sp] = second;
      s0[sp] = t_plane;
      s1[sp] = tmaxn;
      ++sp;
      sn[sp] = first;
      s0[sp] = tmin;
      s1[sp] = t_plane;
    } else {
      sn[sp] = near_only ? first : second;
      s0[sp] = tmin;
      s1[sp] = tmaxn;
    }
    ++sp;
  }
  a.t_out[r] = best_t;
  a.prim_out[r] = best_i;
}

}  // namespace

// Launches the walk on `stream` for R rays; returns the CUDA error code of
// the launch (0 = success). Allocates nothing and does not synchronise.
extern "C" int kd_traverse_launch(const float* o, const float* d,
                                  const float* tmax, const void* nodes,
                                  const int* prim_ids, const float* tris,
                                  const float* world, float* t_out,
                                  int* prim_out, int R, int n_prim_ids,
                                  void* stream) {
  const Args a{o,     d,        tmax, static_cast<const int4*>(nodes),
               prim_ids, tris,  world, t_out, prim_out, R, n_prim_ids};
  const int blocks = (R + kBlock - 1) / kBlock;
  kd_traverse_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
