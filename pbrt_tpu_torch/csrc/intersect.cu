// Brute-force closest-hit kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/ops/intersect_pallas.py::_intersect_kernel
// (Pallas). For each ray it tests every triangle (Moeller-Trumbore, both
// sides), every sphere (stable quadratic) and every axis-aligned rectangle
// of a small scene (no BVH, at most 4096 primitives), in that order, and
// writes the closest hit distance t and the global primitive index
// (triangles [0,T), spheres [T,T+S), aaplanes [T+S,T+S+P); -1 on a miss).
// A hit replaces the best one only when it is strictly nearer, so the first
// primitive in table order wins a tie. The any-hit (shadow) query of the
// integrators is `prim >= 0` of the same kernel.
//
// What bounds it on this card: arithmetic, once a scene has more than a
// handful of primitives. A ray brings 28 bytes in and takes 8 bytes out,
// and does about 45 float operations per triangle it tests, none of them a
// fused multiply-add (see below).
//
// Design: one ray per thread, its state (origin, direction, best t, best
// primitive) in registers for the whole sweep. The primitive table is
// staged through shared memory in tiles of 18 KB (512 triangle rows), one
// copy per block: at the gate's cap a triangle table is 147 KB, which would
// fit a Hopper block only with the opt-in above 48 KB and then leave one
// block per SM, while an 18 KB static tile keeps several blocks resident.
// Every thread of a warp reads the same shared-memory word at the same
// time, which is a broadcast. Threads past the last ray keep running (they
// take part in the tile loads and the barriers) and write nothing.
//
// Numerics follow the plain-torch twin (ops/intersect.py
// ::_intersect_reference) operation by operation: build with --fmad=false
// and without fast math, so no multiply-add is contracted and division and
// sqrtf are the correctly rounded ones. The kernel then equals the twin bit
// for bit.

#include <cuda_runtime.h>

#include "ray_tri.cuh"

namespace {

constexpr int kBlock = 256;
constexpr float kBig = 1e30f;
constexpr int kTileFloats = 4608;          // 18 KB
constexpr int kTriTile = kTileFloats / 9;  // 512 rows: v0 e1 e2
constexpr int kSphTile = kTileFloats / 4;  // 1152 rows: center radius
constexpr int kPlnTile = kTileFloats / 8;  // 576 rows: lo hi axis pad

// Cooperative copy of n floats into the block's tile. The barrier before
// the copy keeps a thread from overwriting rows another thread still reads.
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int n) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kBlock) tile[i] = src[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
    intersect_kernel(const float* __restrict__ tri,
                     const float* __restrict__ sph,
                     const float* __restrict__ pln,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmax,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     int R, int n_tri, int n_sph, int n_pln) {
  __shared__ float tile[kTileFloats];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool live = r < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float best_t = 0.f;  // a thread past R can never hit: t > 1e-4 && t < 0
  int best_p = -1;
  if (live) {
    ox = o[3 * r + 0];
    oy = o[3 * r + 1];
    oz = o[3 * r + 2];
    dx = d[3 * r + 0];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    best_t = fminf(tmax[r], kBig);
  }

  // ---- triangles: Moeller-Trumbore (ray_tri.cuh)
  for (int base = 0; base < n_tri; base += kTriTile) {
    const int n = min(kTriTile, n_tri - base);
    load_tile(tile, tri + 9 * base, 9 * n);
    for (int i = 0; i < n; ++i) {
      const float* row = tile + 9 * i;
      float t;
      const bool hit = ray_tri_hit(ox, oy, oz, dx, dy, dz, row[0], row[1],
                                   row[2], row[3], row[4], row[5], row[6],
                                   row[7], row[8], best_t, t);
      best_t = hit ? t : best_t;
      best_p = hit ? base + i : best_p;
    }
  }

  // ---- spheres: stable quadratic (sphere.cpp:141-150)
  const float a = dx * dx + dy * dy + dz * dz;
  for (int base = 0; base < n_sph; base += kSphTile) {
    const int n = min(kSphTile, n_sph - base);
    load_tile(tile, sph + 4 * base, 4 * n);
    for (int i = 0; i < n; ++i) {
      const float* row = tile + 4 * i;
      const float lx = ox - row[0];
      const float ly = oy - row[1];
      const float lz = oz - row[2];
      const float rad = row[3];
      const float b = 2.0f * (lx * dx + ly * dy + lz * dz);
      const float c = lx * lx + ly * ly + lz * lz - rad * rad;
      const float disc = b * b - 4.0f * a * c;
      const bool ok = disc >= 0.0f;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float q = (b >= 0.0f) ? -0.5f * (b + sq) : -0.5f * (b - sq);
      const float t0 = q / fmaxf(a, 1e-20f);
      const float t1 = c / ((fabsf(q) > 1e-20f) ? q : 1e-20f);
      const float tn = fminf(t0, t1);
      const float tf = fmaxf(t0, t1);
      const float t = (tn > 1e-4f) ? tn : tf;
      const bool hit = ok && (t > 1e-4f) && (t < best_t);
      best_t = hit ? t : best_t;
      best_p = hit ? n_tri + base + i : best_p;
    }
  }

  // ---- aaplanes (shapes/plane.cpp:15-55): open bounds on the rectangle
  for (int base = 0; base < n_pln; base += kPlnTile) {
    const int n = min(kPlnTile, n_pln - base);
    load_tile(tile, pln + 8 * base, 8 * n);
    for (int i = 0; i < n; ++i) {
      const float* row = tile + 8 * i;
      const float lox = row[0], loy = row[1], loz = row[2];
      const float hix = row[3], hiy = row[4], hiz = row[5];
      const float ax = row[6];
      const bool is_x = ax < 0.5f;
      const bool is_y = (ax >= 0.5f) && (ax < 1.5f);
      const bool is_xy = is_x || is_y;
      const float d_ax = is_x ? dx : (is_y ? dy : dz);
      const float o_ax = is_x ? ox : (is_y ? oy : oz);
      const float lo_ax = is_x ? lox : (is_y ? loy : loz);
      const bool okd = fabsf(d_ax) > 1e-12f;
      const float t = (lo_ax - o_ax) / (okd ? d_ax : 1e-12f);
      const float hx = ox + t * dx;
      const float hy = oy + t * dy;
      const float hz = oz + t * dz;
      const float p0 = is_x ? hy : hx;
      const float lo0 = is_x ? loy : lox;
      const float hi0 = is_x ? hiy : hix;
      const float p1 = is_xy ? hz : hy;
      const float lo1 = is_xy ? loz : loy;
      const float hi1 = is_xy ? hiz : hiy;
      const bool hit = okd && (t > 1e-4f) && (t < best_t) && (p0 > lo0) &&
                       (p0 < hi0) && (p1 > lo1) && (p1 < hi1);
      best_t = hit ? t : best_t;
      best_p = hit ? n_tri + n_sph + base + i : best_p;
    }
  }

  if (live) {
    t_out[r] = best_t;
    prim_out[r] = best_p;
  }
}

}  // namespace

// Launches the kernel on `stream` for R rays; returns the CUDA error code
// of the launch (0 = success). Allocates nothing and does not synchronise.
extern "C" int intersect_launch(const float* tri, const float* sph,
                                const float* pln, const float* o,
                                const float* d, const float* tmax,
                                float* t_out, int* prim_out, int R, int n_tri,
                                int n_sph, int n_pln, void* stream) {
  const int blocks = (R + kBlock - 1) / kBlock;
  intersect_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      tri, sph, pln, o, d, tmax, t_out, prim_out, R, n_tri, n_sph, n_pln);
  return (int)cudaGetLastError();
}
