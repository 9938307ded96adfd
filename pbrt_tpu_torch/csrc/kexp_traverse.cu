// Wide-BVH traversal kernel for Hopper (sm_90a), in the variants of the
// kernel-experiment harness (tools/kexp_kernels.py, tools/kexp_run.py).
//
// Replaces the TPU kernel tools/kexp_kernels.py::_kernel (Pallas). For each
// ray it finds the closest triangle hit below tmax (closest-hit), or whether
// any triangle is hit (any-hit), in a 4- or 8-wide BVH whose leaves hold up
// to leaf_max triangles, and writes the hit distance t and the LEAF-ORDERED
// triangle index (-1 on a miss). In count mode the index output carries
// n_int * 65536 + n_leaf instead: the wide-node steps and the leaf steps of
// the ray's walk.
//
// It is not the TPU kernel carried over. That kernel walks 1,024 to 2,048
// rays as one packet with one shared stack, because a vector unit needs
// that; here a thread walks one ray with its own stack, as
// bvh_traverse.cu does. What each knob of the TPU kernel becomes:
//
//   wide, leaf_max   A wide node is one aligned record (tools/kexp_kernels.py
//                    ::make_layout): words f*W + k hold lo.x lo.y lo.z hi.x
//                    hi.y hi.z (f = 0..5) of child k, words 6W + k the slot
//                    encodings (target << cnt_bits | count, -1 = empty) and
//                    word 7W the parent's split axis: 29 words padded to 32
//                    for W = 4, 57 padded to 64 for W = 8, read as 16-byte
//                    loads. All W children are slab-tested per step; the
//                    entered ones are pushed so that the near half is popped
//                    first, by the sign of the ray's own direction on the
//                    axis (the TPU packet votes).
//   variant 1        The first smem_nodes records (breadth-first order: the
//                    top of the tree) are staged in dynamic shared memory
//                    once per block and read from there; the rest come
//                    through L2 with __ldg. With smem_nodes > 0 the grid is
//                    cut to the blocks the card holds at once and every block
//                    loops over chunks of rays, so a block stages the table
//                    once, not once per 64 to 256 rays. Leaf fields are read
//                    one float at a time from the TPU layout's 128-float
//                    leaf rows (LEAF = 0).
//   variant 2        Leaves as aligned 48-byte triangle records [v0.xyz e1.x]
//                    [e1.yz e2.xy] [e2.z index pad pad], three 16-byte loads
//                    (LEAF = 1).
//   variant 3        The stack holds (encoding, entry distance) pairs; a
//                    popped entry whose entry distance is not below best_t is
//                    skipped (PRUNE; never in any-hit mode). Per ray this
//                    needs no reduction over a packet.
//   variant 5        The dual-size leaf rows of pack_dual_leaf: the encoding
//                    addresses a row; up to 8 triangles sit in one row at
//                    10-float steps, more in two rows of 12 (LEAF = 2).
//   rows             The threads per block: 64, 128 or 256.
//
// What bounds it on this card: as bvh_traverse.cu, the latency of dependent,
// divergent loads, not the bytes a launch must move (36 per ray plus the
// tables once) nor its arithmetic (23 float operations per slab test, 46
// per triangle test). A wide node trades fewer dependent steps for more
// slab tests per step; shared memory trades L2 latency for bank conflicts
// when the threads of a warp read different records (each staged record is
// followed by 16 bytes of padding so that neighbouring records start on
// different banks).
//
// Numerics follow the plain-torch twin (tools/kexp_kernels.py::
// _traverse_wide_reference) operation by operation: inv_d = 1 / (|d| > 1e-12
// ? d : 1e-12), a child is entered when tn <= tf*gscale && tf*gscale > 0 &&
// tn < best_t, the triangle test is ray_tri.cuh. Built with --fmad=false
// and without fast math, the kernel equals the twin bit for bit, ties
// included (both walk in the same order).

#include <cuda_runtime.h>

#include "ray_tri.cuh"

namespace {

constexpr int kStack = 96;  // tools/kexp_kernels.py::STACK; make_layout raises
                            // past it
constexpr int kMaxBlock = 256;
constexpr float kBig = 1e30f;
constexpr int kLanes = 128;       // floats per leaf row
constexpr int kTriF = 10;         // floats per triangle in a leaf row
constexpr int kTrisPerRow = 12;

__device__ __forceinline__ float word_of(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One triangle given as 10 consecutive floats of a leaf row.
__device__ __forceinline__ void test_row_triangle(
    const float* __restrict__ p, float ox, float oy, float oz, float dx,
    float dy, float dz, float& best_t, int& best_i) {
  float t;
  if (ray_tri_hit(ox, oy, oz, dx, dy, dz, __ldg(p), __ldg(p + 1), __ldg(p + 2),
                  __ldg(p + 3), __ldg(p + 4), __ldg(p + 5), __ldg(p + 6),
                  __ldg(p + 7), __ldg(p + 8), best_t, t)) {
    best_t = t;
    best_i = (int)__ldg(p + 9);
  }
}

template <int WIDE, int LEAF, bool PRUNE, bool ANY_HIT, bool COUNT>
__global__ void __launch_bounds__(kMaxBlock)
    kexp_traverse_kernel(const float4* __restrict__ nodes,
                         const float* __restrict__ leaves,
                         const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ tmax,
                         float* __restrict__ t_out, int* __restrict__ i_out,
                         int R, int leaf_max, int block_rows, int cnt_bits,
                         float gscale, int smem_nodes) {
  constexpr int NW4 = WIDE * 2;    // float4 per record: 8 or 16
  constexpr int SW4 = NW4 + 1;     // float4 per staged record
  extern __shared__ float4 s_nodes[];
  for (int i = threadIdx.x; i < smem_nodes * NW4; i += blockDim.x)
    s_nodes[(i / NW4) * SW4 + (i % NW4)] = __ldg(nodes + i);
  __syncthreads();

  const int cnt_mask = (1 << cnt_bits) - 1;
  for (int first = blockIdx.x * blockDim.x; first < R;
       first += gridDim.x * blockDim.x) {
    const int r = first + threadIdx.x;
    if (r >= R) continue;
    const float ox = o[3 * r + 0], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r + 0], dy = d[3 * r + 1], dz = d[3 * r + 2];
    // a tiny negative component becomes +1e12, as in the TPU kernel
    const float ix = 1.0f / ((fabsf(dx) > 1e-12f) ? dx : 1e-12f);
    const float iy = 1.0f / ((fabsf(dy) > 1e-12f) ? dy : 1e-12f);
    const float iz = 1.0f / ((fabsf(dz) > 1e-12f) ? dz : 1e-12f);
    float best_t = fminf(tmax[r], kBig);
    int best_i = -1;
    int n_int = 0, n_leaf = 0;

    int stack[kStack];
    float tn_stack[PRUNE ? kStack : 1];
    int sp = 1;
    stack[0] = 0;                  // wide node 0, the root
    if (PRUNE) tn_stack[0] = 0.0f;
    while (sp > 0) {
      --sp;
      const int e = stack[sp];
      if (PRUNE && !(tn_stack[sp] < best_t)) continue;
      const int cnt = e & cnt_mask;
      const int target = e >> cnt_bits;
      if (cnt > 0) {
        if (COUNT) ++n_leaf;
        if (LEAF == 1) {
          const float4* rec = reinterpret_cast<const float4*>(leaves) +
                              3 * (size_t)(target * leaf_max);
          for (int k = 0; k < cnt; ++k) {
            const float4 p = __ldg(rec + 3 * k), q = __ldg(rec + 3 * k + 1),
                         s = __ldg(rec + 3 * k + 2);
            float t;
            if (ray_tri_hit(ox, oy, oz, dx, dy, dz, p.x, p.y, p.z, p.w, q.x,
                            q.y, q.z, q.w, s.x, best_t, t)) {
              best_t = t;
              best_i = __float_as_int(s.y);
            }
          }
        } else if (LEAF == 0) {
          const float* row0 = leaves + (size_t)target * block_rows * kLanes;
          for (int k = 0; k < cnt; ++k)
            test_row_triangle(row0 + (k / kTrisPerRow) * kLanes +
                                  (k % kTrisPerRow) * kTriF,
                              ox, oy, oz, dx, dy, dz, best_t, best_i);
        } else {
          const float* row0 = leaves + (size_t)target * kLanes;
          for (int k = 0; k < cnt; ++k)
            test_row_triangle(
                cnt <= 8 ? row0 + k * kTriF
                         : row0 + (k / kTrisPerRow) * kLanes +
                               (k % kTrisPerRow) * kTriF,
                ox, oy, oz, dx, dy, dz, best_t, best_i);
        }
        if (ANY_HIT && best_i >= 0) break;
        continue;
      }

      if (COUNT) ++n_int;
      float4 rec[NW4];
      if (target < smem_nodes) {
        const float4* src = s_nodes + target * SW4;
#pragma unroll
        for (int i = 0; i < NW4; ++i) rec[i] = src[i];
      } else {
        const float4* src = nodes + (size_t)target * NW4;
#pragma unroll
        for (int i = 0; i < NW4; ++i) rec[i] = __ldg(src + i);
      }
#define REC(i) word_of(rec[(i) >> 2], (i)&3)
      int enc[WIDE];
      float tn[WIDE];
      bool enter[WIDE];
#pragma unroll
      for (int k = 0; k < WIDE; ++k) {
        const float t0x = (REC(0 * WIDE + k) - ox) * ix;
        const float t1x = (REC(3 * WIDE + k) - ox) * ix;
        const float t0y = (REC(1 * WIDE + k) - oy) * iy;
        const float t1y = (REC(4 * WIDE + k) - oy) * iy;
        const float t0z = (REC(2 * WIDE + k) - oz) * iz;
        const float t1z = (REC(5 * WIDE + k) - oz) * iz;
        tn[k] = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                      fminf(t0z, t1z));
        const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z)) * gscale;
        enc[k] = __float_as_int(REC(6 * WIDE + k));
        enter[k] = (tn[k] <= tf) && (tf > 0.0f) && (tn[k] < best_t) &&
                   (enc[k] >= 0);
      }
      const int axis = __float_as_int(REC(7 * WIDE));
#undef REC
      const float d_ax = (axis == 0) ? dx : ((axis == 1) ? dy : dz);
      const bool sneg = d_ax < 0.0f;
      // slots 0..W-1 when the ray runs down the axis, else the far half
      // first; the last pushed is the first popped
#pragma unroll
      for (int j = 0; j < WIDE; ++j) {
        constexpr int kHalf = WIDE / 2;
        const int a = j, b = (j + kHalf) % WIDE;
        if (sneg ? enter[a] : enter[b]) {
          stack[sp] = sneg ? enc[a] : enc[b];
          if (PRUNE) tn_stack[sp] = sneg ? tn[a] : tn[b];
          ++sp;
        }
      }
    }
    t_out[r] = best_t;
    i_out[r] = COUNT ? n_int * 65536 + n_leaf : best_i;
  }
}

struct Args {
  const float4* nodes;
  const float* leaves;
  const float *o, *d, *tmax;
  float* t_out;
  int* i_out;
  int R, leaf_max, block_rows, cnt_bits;
  float gscale;
  int block, smem_nodes;
  cudaStream_t stream;
};

template <int WIDE, int LEAF, bool PRUNE, bool ANY_HIT, bool COUNT>
int launch(const Args& a) {
  auto kern = kexp_traverse_kernel<WIDE, LEAF, PRUNE, ANY_HIT, COUNT>;
  const size_t smem = (size_t)a.smem_nodes * (WIDE * 2 + 1) * sizeof(float4);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  int blocks = (a.R + a.block - 1) / a.block;
  if (a.smem_nodes > 0) {
    // as many blocks as the card holds at once; each loops over ray chunks
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, a.block, smem)) != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    if (per_sm < 1) per_sm = 1;
    if (blocks > sms * per_sm) blocks = sms * per_sm;
  }
  kern<<<blocks, a.block, smem, a.stream>>>(
      a.nodes, a.leaves, a.o, a.d, a.tmax, a.t_out, a.i_out, a.R, a.leaf_max,
      a.block_rows, a.cnt_bits, a.gscale, a.smem_nodes);
  return (int)cudaGetLastError();
}

template <int WIDE, int LEAF, bool PRUNE>
int launch_mode(const Args& a, bool any_hit, bool count) {
  if (any_hit)   // pruning never skips in any-hit mode: the unpruned walk
    return count ? launch<WIDE, LEAF, false, true, true>(a)
                 : launch<WIDE, LEAF, false, true, false>(a);
  return count ? launch<WIDE, LEAF, PRUNE, false, true>(a)
               : launch<WIDE, LEAF, PRUNE, false, false>(a);
}

template <int WIDE>
int launch_wide(const Args& a, int leaf_mode, bool prune, bool any_hit,
                bool count) {
  if (leaf_mode == 0 && !prune)
    return launch_mode<WIDE, 0, false>(a, any_hit, count);
  if (leaf_mode == 1 && !prune)
    return launch_mode<WIDE, 1, false>(a, any_hit, count);
  if (leaf_mode == 1 && prune)
    return launch_mode<WIDE, 1, true>(a, any_hit, count);
  return -1;
}

}  // namespace

// Launches the kernel on `stream` for R rays; returns the CUDA error code of
// the launch (0 = success), or -1 when no kernel is built for the asked
// combination. leaf_mode: 0 = leaf rows (variant 1), 1 = triangle records
// (variants 2, 3), 2 = dual-size leaf rows (variant 5, wide 4 only). Allocates
// nothing and does not synchronise.
extern "C" int kexp_traverse_launch(
    const float* nodes, const float* leaves, const float* o, const float* d,
    const float* tmax, float* t_out, int* i_out, int R, int n_nodes, int wide,
    int leaf_mode, int prune, int any_hit, int count_mode, int leaf_max,
    int block_rows, int cnt_bits, float gscale, int block, int smem_nodes,
    void* stream) {
  if (R <= 0 || smem_nodes < 0 || smem_nodes > n_nodes ||
      (block != 64 && block != 128 && block != 256))
    return -1;
  const Args a{reinterpret_cast<const float4*>(nodes), leaves, o, d, tmax,
               t_out, i_out, R, leaf_max, block_rows, cnt_bits, gscale, block,
               smem_nodes, (cudaStream_t)stream};
  const bool any = any_hit != 0, count = count_mode != 0;
  if (leaf_mode == 2)
    return (wide == 4 && !prune) ? launch_mode<4, 2, false>(a, any, count)
                                 : -1;
  if (wide == 4) return launch_wide<4>(a, leaf_mode, prune != 0, any, count);
  if (wide == 8) return launch_wide<8>(a, leaf_mode, prune != 0, any, count);
  return -1;
}
