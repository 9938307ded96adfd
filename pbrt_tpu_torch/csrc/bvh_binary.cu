// Per-ray binary-BVH traversal kernel for Hopper (sm_90a): the render path's
// kernel until bvh_traverse.cu replaced it, kept as the harness's yardstick
// (ops/bvh_binary.py; tools/kexp_run.py `binary`). No render path calls it.
//
// Replaces the TPU kernel pbrt_tpu/ops/bvh_pallas.py::_traverse_kernel
// (Pallas). For each ray it finds the closest triangle hit below tmax in a
// binary BVH (closest-hit), or whether any triangle is hit (any-hit), and
// writes the hit distance t and the LEAF-ORDERED triangle index (-1 on a
// miss; the caller maps it through the tree's prim_order). In any-hit mode
// a ray stops at its first hit and only `index >= 0` is meaningful. In count
// mode the index output carries n_pop * 65536 + n_leaf instead: the nodes
// popped and the leaves tested on the ray's walk.
//
// It is not the TPU kernel carried over. That kernel walks packets of 2,048
// rays down a 4-wide tree with one shared stack, a majority vote for the
// child order and leaf triangles at static lanes, because the TPU has no
// gathers inside loops and no per-lane stacks. An SM has both, so this is
// the textbook walk (BVHAccel::Intersect, accelerators/bvh.cpp:299-365):
// one ray per thread, a stack of node indices per thread, the near child
// first by the sign of the ray's own direction on the node's split axis,
// over the BVH builder's binary tree with its leaves of at most 4 triangles.
//
// Layout (ops/bvh_binary.py::pack_bvh): a node is 32 bytes, two float4:
//   [lo.x lo.y lo.z hi.x] [hi.y hi.z right|offset count<<2|axis]
// (the last two are int bits; right = second child of an interior node, the
// first child is node + 1; offset = first triangle of a leaf). A triangle is
// 48 bytes, three float4: [v0.xyz e1.x] [e1.yz e2.xy] [e2.z pad pad pad],
// in leaf order, so a leaf's triangles are consecutive.
//
// What bounds it on this card: neither the bytes a launch must move (36 per
// ray plus the tree once) nor its arithmetic (23 float operations per slab
// test, 46 per triangle test), but the latency of dependent, divergent
// loads: every step of a ray's walk waits for the node it popped, and the
// rays of a warp walk different subtrees. The tree (a few MB at 130k
// triangles) stays in the 50 MB L2 and is read through the read-only path
// (__ldg); the stack lives in local memory, which L1 serves.
//
// Numerics follow the plain-torch twin (ops/bvh_binary.py::
// _traverse_reference) and the TPU kernel operation by operation: inv_d =
// 1 / (|d| > 1e-12 ? d : 1e-12), the slab test enters when tn <= tf*gscale && tf*gscale > 0 && tn <
// best_t, the triangle test is ray_tri.cuh. Built with --fmad=false and
// without fast math, the kernel equals the twin bit for bit, ties included
// (both visit the leaves in the same order).

#include <cuda_runtime.h>

#include "ray_tri.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 64;  // ops/bvh_binary.py::STACK; pack_bvh raises
                            // past it
constexpr float kBig = 1e30f;

template <bool ANY_HIT, bool COUNT>
__global__ void __launch_bounds__(kBlock)
    bvh_binary_kernel(const float4* __restrict__ nodes,
                      const float4* __restrict__ tris,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmax,
                      float* __restrict__ t_out, int* __restrict__ i_out,
                      int R, float gscale) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= R) return;
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  // a tiny negative component becomes +1e12, as in the TPU kernel
  const float ix = 1.0f / ((fabsf(dx) > 1e-12f) ? dx : 1e-12f);
  const float iy = 1.0f / ((fabsf(dy) > 1e-12f) ? dy : 1e-12f);
  const float iz = 1.0f / ((fabsf(dz) > 1e-12f) ? dz : 1e-12f);
  float best_t = fminf(tmax[r], kBig);
  int best_i = -1;
  int n_pop = 0, n_leaf = 0;

  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    if (COUNT) ++n_pop;
    const float4 a = __ldg(nodes + 2 * node);
    const float4 b = __ldg(nodes + 2 * node + 1);
    const float t0x = (a.x - ox) * ix, t1x = (a.w - ox) * ix;
    const float t0y = (a.y - oy) * iy, t1y = (b.x - oy) * iy;
    const float t0z = (a.z - oz) * iz, t1z = (b.y - oz) * iz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z)) * gscale;
    if (!((tn <= tf) && (tf > 0.0f) && (tn < best_t))) continue;
    const int right = __float_as_int(b.z);
    const int meta = __float_as_int(b.w);
    const int cnt = meta >> 2;
    if (cnt > 0) {
      if (COUNT) ++n_leaf;
      for (int k = 0; k < cnt; ++k) {
        const float4* row = tris + 3 * (right + k);
        const float4 p = __ldg(row), q = __ldg(row + 1), s = __ldg(row + 2);
        float t;
        if (ray_tri_hit(ox, oy, oz, dx, dy, dz, p.x, p.y, p.z, p.w, q.x, q.y,
                        q.z, q.w, s.x, best_t, t)) {
          best_t = t;
          best_i = right + k;
        }
      }
      if (ANY_HIT && best_i >= 0) break;
    } else {
      const int axis = meta & 3;
      const float d_ax = (axis == 0) ? dx : ((axis == 1) ? dy : dz);
      const bool near_second = d_ax < 0.0f;
      // the far child goes below the near child, which is popped next
      stack[sp++] = near_second ? node + 1 : right;
      stack[sp++] = near_second ? right : node + 1;
    }
  }
  t_out[r] = best_t;
  i_out[r] = COUNT ? n_pop * 65536 + n_leaf : best_i;
}

template <bool ANY_HIT, bool COUNT>
int launch(const float4* nodes, const float4* tris, const float* o,
           const float* d, const float* tmax, float* t_out, int* i_out, int R,
           float gscale, cudaStream_t stream) {
  const int blocks = (R + kBlock - 1) / kBlock;
  bvh_binary_kernel<ANY_HIT, COUNT><<<blocks, kBlock, 0, stream>>>(
      nodes, tris, o, d, tmax, t_out, i_out, R, gscale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` for R rays; returns the CUDA error code of
// the launch (0 = success). Allocates nothing and does not synchronise.
extern "C" int bvh_binary_launch(const float* nodes, const float* tris,
                                 const float* o, const float* d,
                                 const float* tmax, float* t_out, int* i_out,
                                 int R, float gscale, int any_hit,
                                 int count_mode, void* stream) {
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return count_mode
               ? launch<true, true>(n4, t4, o, d, tmax, t_out, i_out, R,
                                    gscale, s)
               : launch<true, false>(n4, t4, o, d, tmax, t_out, i_out, R,
                                     gscale, s);
  return count_mode ? launch<false, true>(n4, t4, o, d, tmax, t_out, i_out, R,
                                          gscale, s)
                    : launch<false, false>(n4, t4, o, d, tmax, t_out, i_out,
                                           R, gscale, s);
}
