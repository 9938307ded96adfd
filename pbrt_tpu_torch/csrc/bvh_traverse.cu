// Per-ray traversal of a 4-wide BVH for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/ops/bvh_pallas.py::_traverse_kernel
// (Pallas). For each ray it finds the closest triangle hit below tmax
// (closest-hit), or whether any triangle is hit (any-hit: the ray stops at
// its first hit and only `index >= 0` is meaningful), and writes the hit
// distance t and the LEAF-ORDERED triangle index (-1 on a miss; the caller
// maps it through the tree's prim_order). In count mode the index output
// carries n_int * 65536 + n_leaf instead: the wide-node and leaf steps of
// the ray's walk.
//
// It is not the TPU kernel carried over. That kernel walks packets of 2,048
// rays down a 4-wide tree with one shared stack, a majority vote for the
// child order and leaves collapsed to 16 triangles at static lanes, because
// a vector unit needs that. Here one thread walks one ray with its own
// stack, and the tree is the BVH builder's binary tree with its leaves of at
// most 4 triangles, two binary levels merged into one 4-wide node.
//
// Layout (ops/bvh.py::pack_wide). A node is one 128-byte record, eight
// float4: words f*4 + k hold lo.x lo.y lo.z hi.x hi.y hi.z (f = 0..5) of
// child k, words 24 + k the slot encodings and word 28 the parent's split
// axis (int bits). A slot's encoding is first << cnt_bits | count for a leaf
// (its first triangle record and count), node << cnt_bits for a wide node,
// -1 for an empty slot; nodes are in breadth-first order, the root first. A
// triangle is a 48-byte record, three float4: [v0.xyz e1.x] [e1.yz e2.xy]
// [e2.z pad pad pad], in leaf order, so a record's index is the leaf-ordered
// index.
//
// What bounds it on this card: neither the bytes a launch must move (36 per
// ray plus the tree once, ~0.025 ms per 2,097,152 camera rays) nor its
// arithmetic (23 float operations per slab test, 46 per triangle test, on
// the fewer tests of the binary and the 4-wide walk: ~0.024 ms), but how
// often each SM can issue while the rays of a warp walk different subtrees
// (a warp runs until its longest walk ends: on the H100, 66% of a warp's
// issued steps are useful on camera rays, 34% on bounce rays) and each step
// waits for the record it popped (a dependent load from L2; 6.0 node and 1.9
// leaf steps per camera ray). The kernel reaches about 6% of the bound on
// camera rays (PERF.md §6). What the design does about it:
//   - 4-wide nodes: a third of the dependent steps of the binary walk
//     (bvh_binary.cu) per ray, each one record read as eight independent
//     16-byte __ldg loads whose latency overlaps, and four slab tests on
//     registers at compile-time indices (the bounds are transposed in the
//     record).
//   - Children are pushed so that the near half is popped first, by the
//     sign of the ray's own direction on the parent's split axis (the order
//     of kexp_traverse.cu's variant 2), so a ray meets its closest hit early
//     and culls more.
//   - The persistent grid, the render path's: as many blocks as the card
//     holds at once, and lane 0 of each warp takes the next 32 rays with one
//     atomicAdd on a counter the wrapper zeroes, so a warp whose rays end
//     early takes new rays instead of idling until its block retires. One
//     thread per ray (next_ray null) is the harness's other side of the
//     choice: on the heightfield tree 3-5% slower on camera rays, 0-1% on
//     bounce rays, 1-3% on shadow rays and 0.4-0.7% faster on its random
//     rays; on the 100,000-triangle soup 1-5% slower on every ray set
//     (PERF.md §5).
//   - An L2 access-policy window over the tree is only a harness experiment
//     (bvh_l2_window below): inside a render pass it moved this kernel's
//     time by under 1%, so the eager torch between two launches does not
//     evict the tree.
//
// Numerics follow the plain-torch twin (ops/bvh.py::_traverse_wide_reference)
// operation by operation: inv_d = 1 / (|d| > 1e-12 ? d : 1e-12), a child is
// entered when tn <= tf*gscale && tf*gscale > 0 && tn < best_t, the triangle
// test is ray_tri.cuh. Built with --fmad=false and without fast math, the
// kernel equals the twin bit for bit, ties included (both walk in the same
// order); t equals the binary kernel's bit for bit (the same triangles
// through the same formula), and the triangle too but for exact ties.

#include <cuda_runtime.h>

#include "ray_tri.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWide = 4;
constexpr int kNodeF4 = 8;   // float4 per node record
constexpr int kStack = 96;   // ops/bvh.py::STACK; pack_wide raises past it
constexpr float kBig = 1e30f;

__device__ __forceinline__ float word_of(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

template <bool ANY_HIT, bool COUNT>
__device__ __forceinline__ void trace(int r, const float4* __restrict__ nodes,
                                      const float4* __restrict__ tris,
                                      const float* __restrict__ o,
                                      const float* __restrict__ d,
                                      const float* __restrict__ tmax,
                                      float* __restrict__ t_out,
                                      int* __restrict__ i_out, int cnt_bits,
                                      float gscale) {
  const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
  // a tiny negative component becomes +1e12, as in the TPU kernel
  const float ix = 1.0f / ((fabsf(dx) > 1e-12f) ? dx : 1e-12f);
  const float iy = 1.0f / ((fabsf(dy) > 1e-12f) ? dy : 1e-12f);
  const float iz = 1.0f / ((fabsf(dz) > 1e-12f) ? dz : 1e-12f);
  float best_t = fminf(tmax[r], kBig);
  int best_i = -1;
  int n_int = 0, n_leaf = 0;
  const int cnt_mask = (1 << cnt_bits) - 1;

  int stack[kStack];
  int sp = 1;
  stack[0] = 0;  // wide node 0, the root
  while (sp > 0) {
    const int e = stack[--sp];
    const int cnt = e & cnt_mask;
    const int target = e >> cnt_bits;
    if (cnt > 0) {
      if (COUNT) ++n_leaf;
      const float4* rec = tris + 3 * (size_t)target;
      for (int k = 0; k < cnt; ++k) {
        const float4 p = __ldg(rec + 3 * k), q = __ldg(rec + 3 * k + 1),
                     s = __ldg(rec + 3 * k + 2);
        float t;
        if (ray_tri_hit(ox, oy, oz, dx, dy, dz, p.x, p.y, p.z, p.w, q.x, q.y,
                        q.z, q.w, s.x, best_t, t)) {
          best_t = t;
          best_i = target + k;
        }
      }
      if (ANY_HIT && best_i >= 0) break;
      continue;
    }

    if (COUNT) ++n_int;
    float4 rec[kNodeF4];
    const float4* src = nodes + (size_t)target * kNodeF4;
#pragma unroll
    for (int i = 0; i < kNodeF4; ++i) rec[i] = __ldg(src + i);
#define REC(i) word_of(rec[(i) >> 2], (i)&3)
    int enc[kWide];
    bool enter[kWide];
#pragma unroll
    for (int k = 0; k < kWide; ++k) {
      const float t0x = (REC(0 * kWide + k) - ox) * ix;
      const float t1x = (REC(3 * kWide + k) - ox) * ix;
      const float t0y = (REC(1 * kWide + k) - oy) * iy;
      const float t1y = (REC(4 * kWide + k) - oy) * iy;
      const float t0z = (REC(2 * kWide + k) - oz) * iz;
      const float t1z = (REC(5 * kWide + k) - oz) * iz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z)) * gscale;
      enc[k] = __float_as_int(REC(6 * kWide + k));
      enter[k] = (tn <= tf) && (tf > 0.0f) && (tn < best_t) && (enc[k] >= 0);
    }
    const int axis = __float_as_int(REC(7 * kWide));
#undef REC
    const float d_ax = (axis == 0) ? dx : ((axis == 1) ? dy : dz);
    const bool sneg = d_ax < 0.0f;
    // slots 0..3 when the ray runs down the axis, else the far half first;
    // the last pushed is the first popped
#pragma unroll
    for (int j = 0; j < kWide; ++j) {
      const int a = j, b = (j + kWide / 2) % kWide;
      if (sneg ? enter[a] : enter[b]) stack[sp++] = sneg ? enc[a] : enc[b];
    }
  }
  t_out[r] = best_t;
  i_out[r] = COUNT ? n_int * 65536 + n_leaf : best_i;
}

template <bool ANY_HIT, bool COUNT, bool PERSISTENT>
__global__ void __launch_bounds__(kBlock)
    bvh_traverse_kernel(const float4* __restrict__ nodes,
                        const float4* __restrict__ tris,
                        const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ tmax,
                        float* __restrict__ t_out, int* __restrict__ i_out,
                        int R, int cnt_bits, float gscale, int* next_ray) {
  if (!PERSISTENT) {
    const int r = blockIdx.x * kBlock + threadIdx.x;
    if (r < R)
      trace<ANY_HIT, COUNT>(r, nodes, tris, o, d, tmax, t_out, i_out,
                            cnt_bits, gscale);
    return;
  }
  const int lane = threadIdx.x & 31;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(next_ray, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= R) return;  // the same for every lane of the warp
    const int r = first + lane;
    if (r < R)
      trace<ANY_HIT, COUNT>(r, nodes, tris, o, d, tmax, t_out, i_out,
                            cnt_bits, gscale);
  }
}

struct Args {
  const float4 *nodes, *tris;
  const float *o, *d, *tmax;
  float* t_out;
  int* i_out;
  int R, cnt_bits;
  float gscale;
  int* next_ray;
  cudaStream_t stream;
};

template <bool ANY_HIT, bool COUNT, bool PERSISTENT>
int launch(const Args& a) {
  auto kern = bvh_traverse_kernel<ANY_HIT, COUNT, PERSISTENT>;
  int blocks = (a.R + kBlock - 1) / kBlock;
  if (PERSISTENT) {
    // as many blocks as the card holds at once; their warps fetch rays
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
    if (blocks > sms * per_sm) blocks = sms * per_sm;
  }
  kern<<<blocks, kBlock, 0, a.stream>>>(a.nodes, a.tris, a.o, a.d, a.tmax,
                                        a.t_out, a.i_out, a.R, a.cnt_bits,
                                        a.gscale, a.next_ray);
  return (int)cudaGetLastError();
}

template <bool ANY_HIT, bool COUNT>
int launch_grid(const Args& a) {
  return a.next_ray != nullptr ? launch<ANY_HIT, COUNT, true>(a)
                               : launch<ANY_HIT, COUNT, false>(a);
}

// The persisting L2 carve-out this process last reserved for a window (0:
// none). One device per process, as the port runs.
size_t g_carveout = 0;

}  // namespace

// Launches the kernel on `stream` for R rays; returns the CUDA error code of
// the launch (0 = success), or cudaErrorInvalidValue for sizes it does not
// take. next_ray: a zeroed int on the card for the persistent grid (the
// render path's), null for one thread per ray. Allocates nothing and does
// not synchronise.
extern "C" int bvh_traverse_launch(const float* nodes, const float* tris,
                                   const float* o, const float* d,
                                   const float* tmax, float* t_out,
                                   int* i_out, int R, int cnt_bits,
                                   float gscale, int any_hit, int count_mode,
                                   int* next_ray, void* stream) {
  if (R <= 0 || R >= (1 << 30) || cnt_bits < 1 || cnt_bits > 30)
    return (int)cudaErrorInvalidValue;
  const Args a{reinterpret_cast<const float4*>(nodes),
               reinterpret_cast<const float4*>(tris),
               o,
               d,
               tmax,
               t_out,
               i_out,
               R,
               cnt_bits,
               gscale,
               next_ray,
               (cudaStream_t)stream};
  if (any_hit)
    return count_mode ? launch_grid<true, true>(a)
                      : launch_grid<true, false>(a);
  return count_mode ? launch_grid<false, true>(a)
                    : launch_grid<false, false>(a);
}

// The kernel-experiment harness's L2 experiment
// (tools/kexp_kernels.py::l2_window); the render path never calls it. With
// bytes > 0: reserves a persisting L2 carve-out for [base, base + bytes) and
// puts an access-policy window over that range on `stream` (hit ratio up to
// 1, persisting; misses streaming), so every kernel launched there keeps the
// range in L2. With bytes == 0: clears the window on `stream`, resets the
// persisting lines and releases the carve-out. `stream` must not be the
// legacy default stream. Returns the CUDA error code (0 = success).
extern "C" int bvh_l2_window(const void* base, size_t bytes, void* stream) {
  const auto s = (cudaStream_t)stream;
  cudaStreamAttrValue v = {};
  cudaError_t err;
  if (bytes == 0) {
    v.accessPolicyWindow.num_bytes = 0;  // a window of 0 bytes: none
    if ((err = cudaStreamSetAttribute(
             s, cudaStreamAttributeAccessPolicyWindow, &v)) == cudaSuccess &&
        g_carveout != 0 &&
        (err = cudaCtxResetPersistingL2Cache()) == cudaSuccess &&
        (err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0)) ==
            cudaSuccess)
      g_carveout = 0;
    if (err != cudaSuccess) cudaGetLastError();
    return (int)err;
  }
  if (base == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, max_persist = 0, max_window = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev)) !=
          cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (max_persist <= 0 || max_window <= 0) return (int)cudaErrorNotSupported;
  const size_t carve = bytes < (size_t)max_persist ? bytes : max_persist;
  if ((err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, carve)) !=
      cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  g_carveout = carve;
  const size_t win = bytes < (size_t)max_window ? bytes : max_window;
  const float ratio = (float)carve / (float)win;
  v.accessPolicyWindow.base_ptr = const_cast<void*>(base);
  v.accessPolicyWindow.num_bytes = win;
  v.accessPolicyWindow.hitRatio = ratio < 1.0f ? ratio : 1.0f;
  v.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  v.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  if ((err = cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow,
                                    &v)) != cudaSuccess)
    cudaGetLastError();
  return (int)err;
}
