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
// What bounds it on this card: the instructions issued per ray-primitive
// test. A ray brings 28 bytes in and takes 8 bytes out; a triangle test is
// 46 counted float operations, none of them a fused multiply-add (see
// below), so at most half the card's FMA-counted float32 rate, and besides
// them each test issues the row's loads, the correctly rounded division (a
// reciprocal, Newton steps and a slow-path check), compares and selects.
//
// Design: the table is staged through shared memory in 18 KB tiles, one
// copy per block, every thread of a warp reading the same word (a
// broadcast). Two steps on top of that are compile-time choices of one
// source, so that chip_smoke.py times them against each other
// (ops/intersect.py::_launch_design; the render path runs kRenderDesign,
// both):
//   - Two rays per thread (TWO): lane l of warp w takes rays 64w + l and
//     64w + 32 + l, so each store is one coalesced 128-byte line per ray
//     and a warp covers 64 neighbouring rays. Each staged row is read once
//     for both rays; triangle rows are padded to 12 floats in the tile so
//     that a row is two float4 loads and one float (the packed table stays
//     9 floats, ops/intersect.py::pack_scene).
//   - The warp-wide early reject (REJECT, tri_sweep.cuh): the numerators of
//     Moeller-Trumbore decide, without the division, that a ray certainly
//     misses; where that holds for ray k of all 32 lanes, the warp skips
//     ray k's division and exact comparisons. For spheres, the square root
//     and both divisions are skipped when no ray of the warp has
//     disc >= 0.
// Design 0 has neither. Inside the generic loop's passes the two together
// take 8% (portal) to 17% (BVH scene) less device time than design 0, and
// less than either alone but for _sphere_cornell, where two rays alone are
// 1% faster; on rays with random origins and directions (no coherence in a
// warp) the two together are up to 14% slower than design 0 (PERF.md §6). Tried and dropped: whole-table
// staging once per resident block (a persistent grid), 1-4% slower than
// the tiles with two rays per thread; one vote for both rays of a thread
// (one per ray skips more); a probe of each tile's first rows that kept the
// reject only where it paid, slower than the reject alone in every pass.
//
// Two-keyframe motion blur has its own kernel in this file,
// intersect_motion_kernel (below, with its own entry point): 18-float rows
// moved to each ray's shutter time, one ray a thread, no early reject. It
// leaves the designs above and tri_sweep.cuh untouched.
//
// Numerics follow the plain-torch twin (ops/intersect.py
// ::_intersect_reference) operation by operation: build with --fmad=false
// and without fast math, so no multiply-add is contracted and division and
// sqrtf are the correctly rounded ones. Every design then equals the twin
// bit for bit: the early reject only skips work whose result is "no hit".

#include <cuda_runtime.h>

#include "tri_sweep.cuh"

namespace {

using tri_sweep::Rays;
using tri_sweep::TriRow;

constexpr int kBlock = 256;
constexpr float kBig = 1e30f;
constexpr int kTileFloats = 4608;  // 18 KB tiles
constexpr int kTwo = 1, kReject = 2;  // design bits
constexpr int kRenderDesign = kTwo | kReject;

struct Args {
  const float *tri, *sph, *pln, *o, *d, *tmax;
  float* t_out;
  int* prim_out;
  int R, n_tri, n_sph, n_pln;
};

// Floats of a staged triangle row: nine, or twelve (three float4) when two
// rays share each row read.
template <int NP>
__host__ __device__ constexpr int tri_floats() {
  return NP == 2 ? 12 : 9;
}

// Cooperative copy of n rows (src_f floats each) into the block's tile at
// dst_f floats a row, padding zeroed. The barrier before the copy keeps a
// thread from overwriting rows another thread still reads.
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int n, int src_f, int dst_f) {
  __syncthreads();
  for (int j = threadIdx.x; j < n * dst_f; j += kBlock) {
    const int row = j / dst_f, col = j - row * dst_f;
    tile[j] = col < src_f ? src[row * src_f + col] : 0.0f;
  }
  __syncthreads();
}

template <int NP>
__device__ __forceinline__ TriRow tri_row(const float* s, int i) {
  if (NP == 2) {
    const float4* q = reinterpret_cast<const float4*>(s) + 3 * i;
    const float4 a = q[0], b = q[1];
    return TriRow{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, s[12 * i + 8]};
  }
  const float* r = s + 9 * i;
  return TriRow{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]};
}

template <int NP, bool REJECT>
__device__ __forceinline__ void sweep_sphs(const float* s, int n, int base,
                                           const Rays<NP>& ray,
                                           float (&best_t)[NP],
                                           int (&best_p)[NP]) {
  float a[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k)
    a[k] = ray.dx[k] * ray.dx[k] + ray.dy[k] * ray.dy[k] +
           ray.dz[k] * ray.dz[k];
  for (int i = 0; i < n; ++i) {
    const float cx = s[4 * i], cy = s[4 * i + 1], cz = s[4 * i + 2];
    const float rad = s[4 * i + 3];
    float b[NP], c[NP], disc[NP];
    bool keep = false;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float lx = ray.ox[k] - cx;
      const float ly = ray.oy[k] - cy;
      const float lz = ray.oz[k] - cz;
      b[k] = 2.0f * (lx * ray.dx[k] + ly * ray.dy[k] + lz * ray.dz[k]);
      c[k] = lx * lx + ly * ly + lz * lz - rad * rad;
      disc[k] = b[k] * b[k] - 4.0f * a[k] * c[k];
      keep = keep | ((best_t[k] > 1e-4f) & (disc[k] >= 0.0f));
    }
    // no ray of the warp that can still hit has disc >= 0
    if (REJECT && !__any_sync(tri_sweep::kFullMask, keep)) continue;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const bool ok = disc[k] >= 0.0f;
      const float sq = sqrtf(fmaxf(disc[k], 0.0f));
      const float q =
          (b[k] >= 0.0f) ? -0.5f * (b[k] + sq) : -0.5f * (b[k] - sq);
      const float t0 = q / fmaxf(a[k], 1e-20f);
      const float t1 = c[k] / ((fabsf(q) > 1e-20f) ? q : 1e-20f);
      const float tn = fminf(t0, t1);
      const float tf = fmaxf(t0, t1);
      const float t = (tn > 1e-4f) ? tn : tf;
      const bool hit = ok && (t > 1e-4f) && (t < best_t[k]);
      best_t[k] = hit ? t : best_t[k];
      best_p[k] = hit ? base + i : best_p[k];
    }
  }
}

template <int NP>
__device__ __forceinline__ void sweep_plns(const float* s, int n, int base,
                                           const Rays<NP>& ray,
                                           float (&best_t)[NP],
                                           int (&best_p)[NP]) {
  for (int i = 0; i < n; ++i) {
    const float* row = s + 8 * i;
    const float lox = row[0], loy = row[1], loz = row[2];
    const float hix = row[3], hiy = row[4], hiz = row[5];
    const float ax = row[6];
    const bool is_x = ax < 0.5f;
    const bool is_y = (ax >= 0.5f) && (ax < 1.5f);
    const bool is_xy = is_x || is_y;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float ox = ray.ox[k], oy = ray.oy[k], oz = ray.oz[k];
      const float dx = ray.dx[k], dy = ray.dy[k], dz = ray.dz[k];
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
      const bool hit = okd && (t > 1e-4f) && (t < best_t[k]) && (p0 > lo0) &&
                       (p0 < hi0) && (p1 > lo1) && (p1 < hi1);
      best_t[k] = hit ? t : best_t[k];
      best_p[k] = hit ? base + i : best_p[k];
    }
  }
}

// One block per kBlock * NP rays; lane l of warp w takes rays
// 32·NP·w + 32·k + l (ops/intersect.py::lane_rays). The table is staged
// tile by tile. Threads past the last ray keep running (they take part in
// the tile loads and the barriers, and enter with best t 0, so they hit
// nothing and do not vote) and write nothing.
template <int NP, bool REJECT>
__global__ void __launch_bounds__(kBlock) intersect_kernel(const Args a) {
  __shared__ float4 tile4[kTileFloats / 4];
  float* tile = reinterpret_cast<float*>(tile4);
  constexpr int kTri = kTileFloats / tri_floats<NP>();
  constexpr int kSph = kTileFloats / 4;
  constexpr int kPln = kTileFloats / 8;
  const int g = blockIdx.x * kBlock + threadIdx.x;
  const int first = (g / 32) * 32 * NP + (g & 31);
  Rays<NP> ray;
  float best_t[NP];
  int best_p[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int r = first + 32 * k;
    best_p[k] = -1;
    ray.ox[k] = ray.oy[k] = ray.oz[k] = 0.0f;
    ray.dx[k] = ray.dy[k] = ray.dz[k] = 1.0f;
    best_t[k] = 0.0f;  // past R: can never hit (t > 1e-4 && t < 0)
    if (r < a.R) {
      ray.ox[k] = a.o[3 * r + 0];
      ray.oy[k] = a.o[3 * r + 1];
      ray.oz[k] = a.o[3 * r + 2];
      ray.dx[k] = a.d[3 * r + 0];
      ray.dy[k] = a.d[3 * r + 1];
      ray.dz[k] = a.d[3 * r + 2];
      best_t[k] = fminf(a.tmax[r], kBig);
    }
  }

  // ---- triangles: Moeller-Trumbore (tri_sweep.cuh)
  for (int base = 0; base < a.n_tri; base += kTri) {
    const int n = min(kTri, a.n_tri - base);
    load_tile(tile, a.tri + 9 * base, n, 9, tri_floats<NP>());
    for (int i = 0; i < n; ++i)
      tri_sweep::tri_step<NP, REJECT>(tri_row<NP>(tile, i), ray, base + i,
                                      best_t, best_p);
  }
  // ---- spheres: stable quadratic (sphere.cpp:141-150)
  for (int base = 0; base < a.n_sph; base += kSph) {
    const int n = min(kSph, a.n_sph - base);
    load_tile(tile, a.sph + 4 * base, n, 4, 4);
    sweep_sphs<NP, REJECT>(tile, n, a.n_tri + base, ray, best_t, best_p);
  }
  // ---- aaplanes (shapes/plane.cpp:15-55): open bounds on the rectangle
  for (int base = 0; base < a.n_pln; base += kPln) {
    const int n = min(kPln, a.n_pln - base);
    load_tile(tile, a.pln + 8 * base, n, 8, 8);
    sweep_plns<NP>(tile, n, a.n_tri + a.n_sph + base, ray, best_t, best_p);
  }

#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int r = first + 32 * k;
    if (r < a.R) {
      a.t_out[r] = best_t[k];
      a.prim_out[r] = best_p[k];
    }
  }
}

// ---- the motion variant (two-keyframe motion blur)
//
// A triangle row is 18 floats, v0 v1 v2 dv0 dv1 dv2 (ops/intersect.py
// ::pack_scene with motion), and each ray carries its shutter time. The
// triangle step first moves the row's vertices to the ray's time, v + time
// * dv (pbrt_tpu/scene/intersect.py::_tri_verts), then forms the edges
// e1 = v1 - v0, e2 = v2 - v0 from the moved vertices and runs tri_sweep.cuh's
// step on them, as pbrt_tpu's intersect_triangles does on its (R, T, 3)
// vertices. Each lane has its own row, so the warp-wide early reject, which
// votes on one row for 32 rays, has no place here: the variant is one ray a
// thread without the reject (tri_step<1, false>), and the sphere and aaplane
// sweeps are design 0's (spheres and aaplanes do not move). The static
// designs above are untouched. 18 floats a row in 18 KB tiles: 256 rows a
// tile.
constexpr int kMotionFloats = 18;

struct MotionArgs {
  const float *tri, *sph, *pln, *o, *d, *tmax, *time;
  float* t_out;
  int* prim_out;
  int R, n_tri, n_sph, n_pln;
};

__global__ void __launch_bounds__(kBlock)
    intersect_motion_kernel(const MotionArgs a) {
  __shared__ float4 tile4[kTileFloats / 4];
  float* tile = reinterpret_cast<float*>(tile4);
  constexpr int kTri = kTileFloats / kMotionFloats;
  constexpr int kSph = kTileFloats / 4;
  constexpr int kPln = kTileFloats / 8;
  const int r = blockIdx.x * kBlock + threadIdx.x;
  Rays<1> ray;
  float best_t[1] = {0.0f};  // past R: can never hit
  int best_p[1] = {-1};
  float tm = 0.0f;
  ray.ox[0] = ray.oy[0] = ray.oz[0] = 0.0f;
  ray.dx[0] = ray.dy[0] = ray.dz[0] = 1.0f;
  if (r < a.R) {
    ray.ox[0] = a.o[3 * r + 0];
    ray.oy[0] = a.o[3 * r + 1];
    ray.oz[0] = a.o[3 * r + 2];
    ray.dx[0] = a.d[3 * r + 0];
    ray.dy[0] = a.d[3 * r + 1];
    ray.dz[0] = a.d[3 * r + 2];
    best_t[0] = fminf(a.tmax[r], kBig);
    tm = a.time[r];
  }
  for (int base = 0; base < a.n_tri; base += kTri) {
    const int n = min(kTri, a.n_tri - base);
    load_tile(tile, a.tri + kMotionFloats * base, n, kMotionFloats,
              kMotionFloats);
    for (int i = 0; i < n; ++i) {
      const float* s = tile + kMotionFloats * i;
      const float w0x = s[0] + tm * s[9], w0y = s[1] + tm * s[10],
                  w0z = s[2] + tm * s[11];
      const float w1x = s[3] + tm * s[12], w1y = s[4] + tm * s[13],
                  w1z = s[5] + tm * s[14];
      const float w2x = s[6] + tm * s[15], w2y = s[7] + tm * s[16],
                  w2z = s[8] + tm * s[17];
      const TriRow w{w0x,       w0y,       w0z,       w1x - w0x, w1y - w0y,
                     w1z - w0z, w2x - w0x, w2y - w0y, w2z - w0z};
      tri_sweep::tri_step<1, false>(w, ray, base + i, best_t, best_p);
    }
  }
  for (int base = 0; base < a.n_sph; base += kSph) {
    const int n = min(kSph, a.n_sph - base);
    load_tile(tile, a.sph + 4 * base, n, 4, 4);
    sweep_sphs<1, false>(tile, n, a.n_tri + base, ray, best_t, best_p);
  }
  for (int base = 0; base < a.n_pln; base += kPln) {
    const int n = min(kPln, a.n_pln - base);
    load_tile(tile, a.pln + 8 * base, n, 8, 8);
    sweep_plns<1>(tile, n, a.n_tri + a.n_sph + base, ray, best_t, best_p);
  }
  if (r < a.R) {
    a.t_out[r] = best_t[0];
    a.prim_out[r] = best_p[0];
  }
}

template <int NP, bool REJECT>
int launch(const Args& a, cudaStream_t stream) {
  const int per_block = kBlock * NP;
  const int blocks = (a.R + per_block - 1) / per_block;
  intersect_kernel<NP, REJECT><<<blocks, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The design the render path runs (bits: 1 two rays per thread, 2 the
// early reject).
extern "C" int intersect_render_design() { return kRenderDesign; }

// Launches the kernel of `design` on `stream` for R rays; returns the CUDA
// error code of the launch (0 = success). Allocates nothing and does not
// synchronise.
extern "C" int intersect_launch(const float* tri, const float* sph,
                                const float* pln, const float* o,
                                const float* d, const float* tmax,
                                float* t_out, int* prim_out, int R, int n_tri,
                                int n_sph, int n_pln, int design,
                                void* stream) {
  const Args a{tri, sph, pln, o, d, tmax, t_out, prim_out,
               R, n_tri, n_sph, n_pln};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (design) {
    case 0: return launch<1, false>(a, st);
    case kTwo: return launch<2, false>(a, st);
    case kReject: return launch<1, true>(a, st);
    case kTwo | kReject: return launch<2, true>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the motion variant on `stream` for R rays of shutter times
// time[R] against 18-float triangle rows; returns the CUDA error code of
// the launch (0 = success). Allocates nothing and does not synchronise.
extern "C" int intersect_motion_launch(const float* tri, const float* sph,
                                       const float* pln, const float* o,
                                       const float* d, const float* tmax,
                                       const float* time, float* t_out,
                                       int* prim_out, int R, int n_tri,
                                       int n_sph, int n_pln, void* stream) {
  const MotionArgs a{tri, sph, pln, o, d, tmax, time, t_out, prim_out,
                     R, n_tri, n_sph, n_pln};
  const int blocks = (R + kBlock - 1) / kBlock;
  intersect_motion_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
