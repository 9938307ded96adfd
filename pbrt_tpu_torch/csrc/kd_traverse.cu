// kd-tree walk for Hopper (sm_90a): closest hit, or any hit for shadow rays.
//
// Replaces no Pallas kernel: pbrt_tpu walks its kd-tree
// (pbrt_tpu/scene/kdtree.py::_traverse_one, a vmapped lax.while_loop) in
// plain JAX. This is the port's own kernel for the same walk, the near/far
// walk of pbrt's KdTreeAccel::Intersect (kdtreeaccel.cpp:350+), so that a
// scene with `Accelerator "kdtree"` traces its triangles on the card.
//
// The walk. The ray is clipped to the tree's world box; the node being
// visited, with its [tmin, tmax], is kept in registers, and a stack holds
// only the far children still to visit. A visited node whose tmin exceeds
// min(its tmax, best t) is skipped; a leaf tests its triangles (strict
// t < best t, so a triangle met again in a later leaf keeps the first hit);
// an interior node descends into its near child and pushes its far one, or
// descends into the only child the ray's [tmin, tmax] reaches, with pbrt's
// precedence: the plane beyond tmax or behind the origin (tPlane <= 0)
// sends the ray to the near child only, before tPlane < tmin sends it to
// the far one. A ray on the split plane goes below first when its
// direction along the axis is <= 0. After a skipped node or a leaf the
// walk pops the stack. This is pbrt_tpu's stack walk with each push that
// is popped at once left out: the same nodes in the same order with the
// same floats, and a stack of at most `depth` entries (interior nodes on
// the longest root path) instead of depth + 1: 64 entries take any tree
// the wrapper passes (at most 64 levels deep).
//
// Any hit (ANY_HIT): the walk ends at its first accepted hit. Until then
// it visits what the closest-hit walk visits, with the same best t, so its
// `prim >= 0` is the closest-hit walk's, exactly; its t and prim are those
// of the first hit, not the closest.
//
// Tables (ops/kdtree.py::pack_nodes, pack_tris):
//   - nodes: 8 bytes, as pbrt's KdAccelNode. Interior: the split
//     position's float bits and axis | above_child << 2. Leaf: its first
//     triangle record and 3 | count << 2.
//   - triangle records in leaf order (prim_ids order), 48 bytes, three
//     float4: [v0.xyz e1.x] [e1.yz e2.xy] [e2.z idx pad pad], idx the
//     triangle's index in the scene as int bits. A triangle in several
//     leaves has a record in each; a test is three 16-byte loads with no
//     index step.
//   - the world box as 6 floats.
//
// What bounds it on this card: not the bytes (36 a ray, the tables once:
// ~0.025 ms for 2,097,152 camera rays), nor the float operations (3 a node
// step, 46 a triangle test, none a fused multiply-add), but the walk's
// dependent loads (each step waits for the node it visits, from L2: the
// heightfield's 1.0 MB of nodes and 7.3 MB of records sit in the 50 MB
// L2) and a warp whose rays are at different steps of their walks. Each
// step of the design below was timed in turns against the design without
// it (PERF.md §6 row 6; the steps that were dropped are in ROADMAP
// "Settled designs"):
//   - persistent warps, as bvh_traverse.cu: as many blocks as the card
//     holds at once, and lane 0 of each warp takes the next 32 rays with
//     one atomicAdd on a counter the wrapper zeroes on the launch's stream,
//     so a warp whose rays end early takes new ones;
//   - at least 12 blocks of 128 threads an SM (at most 40 registers: 48
//     warps in flight where the walk alone takes 56 and 36);
//   - one step a loop iteration, a node visit or one triangle test, so
//     that a lane in a large leaf (65 triangles on the heightfield) does
//     not hold up the lanes of its warp that walk nodes;
//   - tri_sweep.cuh's split triangle test, whose conservative reject skips
//     the division (the same hits and t bit for bit);
//   - the any-hit exit for shadow rays.
//
// Numerics follow the plain-torch twin (ops/kdtree.py::traverse_reference)
// operation by operation: built with --fmad=false and without fast math, so
// no multiply-add is contracted and the division is the correctly rounded
// one; minima and maxima propagate NaN as torch.minimum / torch.maximum do.
// The kernel then equals the twin bit for bit. The
// triangle test is tri_sweep.cuh's split form of ray_tri.cuh, pbrt_tpu's
// intersect_triangle_paired in its own order.

#include <cuda_runtime.h>

#include "tri_sweep.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kLeaf = 3;

constexpr int kMinBlocks = 12;  // blocks an SM, at least
constexpr int kStack = 64;      // ops/kdtree.py MAX_DEPTH

struct Args {
  const float *o, *d, *tmax;
  const int2* nodes;
  const float4* tris;
  const float* world;  // lo xyz, hi xyz
  float* t_out;
  int* prim_out;
  int R;
  int* next_ray;
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

// The far children still to visit: (node, tmin, tmax) entries in the
// thread's local memory.
struct FarStack {
  int n[kStack];
  float t0[kStack], t1[kStack];
  __device__ __forceinline__ void put(int i, int node, float a, float b) {
    n[i] = node;
    t0[i] = a;
    t1[i] = b;
  }
  __device__ __forceinline__ void get(int i, int& node, float& a,
                                      float& b) const {
    node = n[i];
    a = t0[i];
    b = t1[i];
  }
};

// One ray's walk: the ray, its best hit, the node it visits with its
// [tmin, tmax], the stack pointer and the leaf's records still to test
// [k, kend).
struct Walk {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  float best_t, tmin, tmax;
  int best_i, node, sp, k, kend;
};

// The ray r, clipped to the world box; returns whether it reaches it.
__device__ __forceinline__ bool start(const Args& a, int r, Walk& w) {
  w.ox = a.o[3 * r];
  w.oy = a.o[3 * r + 1];
  w.oz = a.o[3 * r + 2];
  w.dx = a.d[3 * r];
  w.dy = a.d[3 * r + 1];
  w.dz = a.d[3 * r + 2];
  w.ix = 1.0f / (fabsf(w.dx) > 1e-12f ? w.dx : 1e-12f);
  w.iy = 1.0f / (fabsf(w.dy) > 1e-12f ? w.dy : 1e-12f);
  w.iz = 1.0f / (fabsf(w.dz) > 1e-12f ? w.dz : 1e-12f);
  const float t0x = (__ldg(a.world + 0) - w.ox) * w.ix;
  const float t1x = (__ldg(a.world + 3) - w.ox) * w.ix;
  const float t0y = (__ldg(a.world + 1) - w.oy) * w.iy;
  const float t1y = (__ldg(a.world + 4) - w.oy) * w.iy;
  const float t0z = (__ldg(a.world + 2) - w.oz) * w.iz;
  const float t1z = (__ldg(a.world + 5) - w.oz) * w.iz;
  const float tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                           nan_min(t0z, t1z));
  const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                           nan_max(t0z, t1z));
  w.best_t = a.tmax[r];
  w.best_i = -1;
  w.tmin = nan_max(tn, 0.0f);
  w.tmax = nan_min(tf, w.best_t);
  w.node = w.sp = w.k = w.kend = 0;
  return w.tmin <= w.tmax;
}

// An interior node: descend into the near child and push the far one, or
// descend into the only child the ray's [tmin, tmaxn] reaches.
__device__ __forceinline__ void descend(Walk& w, int2 nd, float tmaxn,
                                        FarStack& stack) {
  const int ax = nd.y & 3, above = nd.y >> 2;
  const float split = __int_as_float(nd.x);
  const float o_ax = pick(ax, w.ox, w.oy, w.oz);
  const float d_ax = pick(ax, w.dx, w.dy, w.dz);
  const float t_plane = (split - o_ax) * pick(ax, w.ix, w.iy, w.iz);
  const bool below_first = (o_ax < split) || (o_ax == split && d_ax <= 0.0f);
  const int first = below_first ? w.node + 1 : above;
  const int second = below_first ? above : w.node + 1;
  const bool near_only = (t_plane > tmaxn) || (t_plane <= 0.0f);
  const bool far_only = t_plane < w.tmin;
  if (!near_only && !far_only) {
    stack.put(w.sp++, second, t_plane, tmaxn);
    w.node = first;
    w.tmax = t_plane;
  } else {
    w.node = near_only ? first : second;
    w.tmax = tmaxn;
  }
}

// Record k's test against the best hit so far: tri_sweep.cuh's split
// test, whose conservative reject skips the division.
__device__ __forceinline__ bool test(const Args& a, Walk& w, int k) {
  const float4* rec = a.tris + 3 * (size_t)k;
  const float4 p = __ldg(rec), q = __ldg(rec + 1), s = __ldg(rec + 2);
  float t;
  const tri_sweep::TriPre pre = tri_sweep::tri_pre(
      {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, s.x}, w.ox, w.oy, w.oz, w.dx,
      w.dy, w.dz);
  if (tri_sweep::tri_reject(pre) || !tri_sweep::tri_finish(pre, w.best_t, t))
    return false;
  w.best_t = t;
  w.best_i = __float_as_int(s.y);
  return true;
}

// One step of the walk: a node visit (and the pop after a skipped node or
// an empty leaf) or one triangle test (and the pop after a leaf's last);
// returns whether the walk goes on.
template <bool ANY_HIT>
__device__ __forceinline__ bool step(const Args& a, Walk& w,
                                     FarStack& stack) {
  bool pop;
  if (w.k < w.kend) {
    const bool hit = test(a, w, w.k++);
    if (ANY_HIT && hit) w.sp = 0;  // the walk ends at its first hit
    pop = (ANY_HIT && hit) || w.k == w.kend;
  } else {
    const float tmaxn = nan_min(w.tmax, w.best_t);
    pop = w.tmin > tmaxn;
    if (!pop) {
      const int2 nd = __ldg(a.nodes + w.node);
      if ((nd.y & 3) == kLeaf) {
        w.k = nd.x;
        w.kend = nd.x + (nd.y >> 2);
        pop = w.k == w.kend;
      } else {
        descend(w, nd, tmaxn, stack);
      }
    }
  }
  if (pop) {
    if (w.sp == 0) return false;
    stack.get(--w.sp, w.node, w.tmin, w.tmax);
  }
  return true;
}

__device__ __forceinline__ void finish(const Args& a, int r, const Walk& w) {
  a.t_out[r] = w.best_t;
  a.prim_out[r] = w.best_i;
}

// The walk of ray r, one step a loop iteration.
template <bool ANY_HIT>
__device__ __forceinline__ void walk(const Args& a, int r, FarStack& stack) {
  Walk w;
  bool live = start(a, r, w);
  while (live) live = step<ANY_HIT>(a, w, stack);
  finish(a, r, w);
}

// Persistent warps: lane 0 takes the next 32 rays for its warp.
template <bool ANY_HIT>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    kd_traverse_kernel(const Args a) {
  FarStack stack;
  const int lane = threadIdx.x & 31;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(a.next_ray, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= a.R) return;  // the same for every lane of the warp
    const int r = first + lane;
    if (r < a.R) walk<ANY_HIT>(a, r, stack);
  }
}

// As many blocks as the card holds at once; their warps fetch rays.
template <bool ANY_HIT>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = kd_traverse_kernel<ANY_HIT>;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kBlock, 0)) != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (per_sm < 1) per_sm = 1;
  int blocks = (a.R + kBlock - 1) / kBlock;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  kern<<<blocks, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the walk on `stream` for R rays (any_hit: the any-hit
// instantiation); returns the CUDA error code of the launch (0 = success),
// or cudaErrorInvalidValue for a size it does not take. The tree is at most
// kStack levels deep (the caller checks). next_ray: a zeroed int on the
// card. Allocates nothing and does not synchronise.
extern "C" int kd_traverse_launch(const float* o, const float* d,
                                  const float* tmax, const void* nodes,
                                  const void* tris, const float* world,
                                  float* t_out, int* prim_out, int R,
                                  int any_hit, int* next_ray, void* stream) {
  if (R <= 0 || next_ray == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{o,
               d,
               tmax,
               static_cast<const int2*>(nodes),
               static_cast<const float4*>(tris),
               world,
               t_out,
               prim_out,
               R,
               next_ray};
  const auto st = (cudaStream_t)stream;
  return any_hit ? launch<true>(a, st) : launch<false>(a, st);
}
