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
//                    through L2 with __ldg. Leaf fields come from the TPU
//                    layout's 128-float leaf rows (LEAF = 0).
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
//   rows             The threads per block of an unstaged launch: 64, 128
//                    or 256.
//
// What bounds it on this card: as bvh_traverse.cu, the latency of dependent,
// divergent loads, not the bytes a launch must move (36 per ray plus the
// tables once) nor its arithmetic (23 float operations per slab test, 46
// per triangle test). A wide node trades fewer dependent steps for more
// slab tests per step. So the launch is built to keep many walks in flight:
//
//   warps        Every launch runs as many blocks as the card holds at once,
//                and lane 0 of each warp takes the next 32 consecutive rays
//                with one atomicAdd on a counter the wrapper zeroes on the
//                launch's stream (bvh_traverse.cu's scheme), so a warp whose
//                rays end early takes new ones instead of idling until its
//                block retires.
//   leaf rows    (formats 0 and 2) A triangle is read as five 8-byte loads:
//                a row starts on a 512-byte boundary and a triangle sits at
//                a 40-byte step. The loads of triangle k + 1 are not issued
//                while triangle k is tested: that pipeline was slower on
//                every ray set (PERF.md).
//   staging      A staged launch runs one block per SM, with as many threads
//                as the instantiation's registers allow (its own launch
//                bounds, staged_bound), sharing one staged copy: 24-32 warps
//                hide the L2 loads, not the 2-8 of a 64-256-thread block
//                that fills the SM's shared memory alone. Records are staged
//                unpadded, 16-byte chunk c of record r in slot c ^ (r & 7)
//                of its record, so the 8 threads of one LDS.128 phase that
//                read chunk c of 8 records whose indices differ mod 8 touch
//                8 different 16-byte bank groups (128 bytes a wide-4 record:
//                1,816 fit 227 KB; tools/kexp_kernels.py::staged_image).
//
// Numerics follow the plain-torch twin (tools/kexp_kernels.py::
// _traverse_wide_reference) operation by operation: inv_d = 1 / (|d| > 1e-12
// ? d : 1e-12), a child is entered when tn <= tf*gscale && tf*gscale > 0 &&
// tn < best_t, the triangle test is ray_tri.cuh. Built with --fmad=false
// and without fast math, the kernel equals the twin bit for bit, staged or
// not, ties included (both walk in the same order).

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
constexpr int kSwizzle = 7;       // staged chunk c of record r: slot c ^ (r & 7)

// The largest block of a staged launch, which bounds the registers of the
// staged instantiations (65,536 / threads).
template <int WIDE>
constexpr int staged_bound() {
  return WIDE == 4 ? 1024 : 640;
}

struct Params {
  const float4* nodes;
  const float* leaves;
  const float *o, *d, *tmax;
  float* t_out;
  int* i_out;
  int* next_ray;  // the next ray a warp takes, zeroed before the launch
  int R, leaf_max, block_rows, cnt_bits;
  float gscale;
  int smem_nodes;
};

__device__ __forceinline__ float word_of(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One triangle: v0, e1, e2 and its leaf-ordered index.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
  int idx;
};

// Float offset of triangle k of the leaf at `target` in the leaf rows
// (formats 0 and 2): a multiple of 2 (kexp_kernels.py::_row_addr).
template <int LEAF>
__device__ __forceinline__ size_t row_offset(int target, int k, int cnt,
                                             int block_rows) {
  const size_t row0 = (size_t)target * (LEAF == 0 ? block_rows : 1) * kLanes;
  return row0 + ((LEAF == 2 && cnt <= 8)
                     ? k * kTriF
                     : (k / kTrisPerRow) * kLanes + (k % kTrisPerRow) * kTriF);
}

// Triangle k of the leaf at `target` in the leaf rows, as five 8-byte loads.
template <int LEAF>
__device__ __forceinline__ Tri load_row_tri(const Params& p, int target, int k,
                                            int cnt) {
  const float2* q = reinterpret_cast<const float2*>(
      p.leaves + row_offset<LEAF>(target, k, cnt, p.block_rows));
  const float2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
               e = __ldg(q + 3), f = __ldg(q + 4);
  return {a.x, a.y, b.x, b.y, c.x, c.y, e.x, e.y, f.x, (int)f.y};
}

template <int WIDE, int LEAF, bool PRUNE, bool ANY_HIT, bool COUNT,
          bool STAGED>
__device__ __forceinline__ void trace(int r, const Params& p,
                                      const float4* s_nodes) {
  constexpr int NW4 = WIDE * 2;  // float4 per record: 8 or 16
  const int cnt_mask = (1 << p.cnt_bits) - 1;
  const float ox = p.o[3 * r + 0], oy = p.o[3 * r + 1], oz = p.o[3 * r + 2];
  const float dx = p.d[3 * r + 0], dy = p.d[3 * r + 1], dz = p.d[3 * r + 2];
  // a tiny negative component becomes +1e12, as in the TPU kernel
  const float ix = 1.0f / ((fabsf(dx) > 1e-12f) ? dx : 1e-12f);
  const float iy = 1.0f / ((fabsf(dy) > 1e-12f) ? dy : 1e-12f);
  const float iz = 1.0f / ((fabsf(dz) > 1e-12f) ? dz : 1e-12f);
  float best_t = fminf(p.tmax[r], kBig);
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
    const int target = e >> p.cnt_bits;
    if (cnt > 0) {
      if (COUNT) ++n_leaf;
      if constexpr (LEAF == 1) {
        // triangle records: three 16-byte loads and a test per triangle
        const float4* rec = reinterpret_cast<const float4*>(p.leaves) +
                            3 * (size_t)(target * p.leaf_max);
        for (int k = 0; k < cnt; ++k) {
          const float4 a = __ldg(rec + 3 * k), b = __ldg(rec + 3 * k + 1),
                       c = __ldg(rec + 3 * k + 2);
          float t;
          if (ray_tri_hit(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, a.w, b.x,
                          b.y, b.z, b.w, c.x, best_t, t)) {
            best_t = t;
            best_i = __float_as_int(c.y);
          }
        }
      } else {
        // leaf rows: five 8-byte loads and a test per triangle
        for (int k = 0; k < cnt; ++k) {
          const Tri c = load_row_tri<LEAF>(p, target, k, cnt);
          float t;
          if (ray_tri_hit(ox, oy, oz, dx, dy, dz, c.v0x, c.v0y, c.v0z, c.e1x,
                          c.e1y, c.e1z, c.e2x, c.e2y, c.e2z, best_t, t)) {
            best_t = t;
            best_i = c.idx;
          }
        }
      }
      if (ANY_HIT && best_i >= 0) break;
      continue;
    }

    if (COUNT) ++n_int;
    float4 rec[NW4];
    if (STAGED && target < p.smem_nodes) {
      const float4* src = s_nodes + target * NW4;
      const int sw = target & kSwizzle;
#pragma unroll
      for (int i = 0; i < NW4; ++i) rec[i] = src[i ^ sw];
    } else {
      const float4* src = p.nodes + (size_t)target * NW4;
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
                             fmaxf(t0z, t1z)) * p.gscale;
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
  p.t_out[r] = best_t;
  p.i_out[r] = COUNT ? n_int * 65536 + n_leaf : best_i;
}

// STAGED: the instantiation of staged launches, with its own launch bounds;
// the unstaged one has no shared-memory path.
template <int WIDE, int LEAF, bool PRUNE, bool ANY_HIT, bool COUNT,
          bool STAGED>
__global__ void __launch_bounds__(STAGED ? staged_bound<WIDE>() : kMaxBlock)
    kexp_traverse_kernel(const Params p) {
  constexpr int NW4 = WIDE * 2;
  extern __shared__ float4 s_nodes[];
  if (STAGED) {
    for (int i = threadIdx.x; i < p.smem_nodes * NW4; i += blockDim.x) {
      const int r = i / NW4, c = i % NW4;
      s_nodes[r * NW4 + (c ^ (r & kSwizzle))] = __ldg(p.nodes + i);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(p.next_ray, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= p.R) return;  // the same for every lane of the warp
    const int r = first + lane;
    if (r < p.R)
      trace<WIDE, LEAF, PRUNE, ANY_HIT, COUNT, STAGED>(r, p, s_nodes);
  }
}

template <int WIDE, int LEAF, bool PRUNE, bool ANY_HIT, bool COUNT>
int launch(const Params& p, int block, cudaStream_t stream, int* threads_out) {
  const bool staged = p.smem_nodes > 0;
  auto kern = staged ? kexp_traverse_kernel<WIDE, LEAF, PRUNE, ANY_HIT, COUNT,
                                          true>
                   : kexp_traverse_kernel<WIDE, LEAF, PRUNE, ANY_HIT, COUNT,
                                          false>;
  const size_t smem = (size_t)p.smem_nodes * WIDE * 2 * sizeof(float4);
  cudaError_t err;
  int dev = 0, sms = 0, threads = block, per_sm = 0;
  if ((smem > 48 * 1024 &&
       (err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
           cudaSuccess) ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (staged) {
    // one block per SM, as many threads as the registers allow
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    for (threads = attr.maxThreadsPerBlock / 32 * 32; threads >= block;
         threads -= 32) {
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kern, threads, smem)) != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
      }
      if (per_sm >= 1) break;
    }
    if (threads < block) return (int)cudaErrorInvalidConfiguration;
    per_sm = 1;
  } else {
    // as many blocks as the card holds at once
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, block, 0)) != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    if (per_sm < 1) per_sm = 1;
  }
  int blocks = (p.R + threads - 1) / threads;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  kern<<<blocks, threads, smem, stream>>>(p);
  if (threads_out != nullptr) *threads_out = threads;
  return (int)cudaGetLastError();
}

template <int WIDE, int LEAF, bool PRUNE>
int launch_mode(const Params& p, int block, cudaStream_t s, int* threads,
                bool any_hit, bool count) {
  if (any_hit)   // pruning never skips in any-hit mode: the unpruned walk
    return count ? launch<WIDE, LEAF, false, true, true>(p, block, s, threads)
                 : launch<WIDE, LEAF, false, true, false>(p, block, s,
                                                          threads);
  return count ? launch<WIDE, LEAF, PRUNE, false, true>(p, block, s, threads)
               : launch<WIDE, LEAF, PRUNE, false, false>(p, block, s, threads);
}

template <int WIDE>
int launch_wide(const Params& p, int block, cudaStream_t s, int* threads,
                int leaf_mode, bool prune, bool any_hit, bool count) {
  if (leaf_mode == 0 && !prune)
    return launch_mode<WIDE, 0, false>(p, block, s, threads, any_hit, count);
  if (leaf_mode == 1 && !prune)
    return launch_mode<WIDE, 1, false>(p, block, s, threads, any_hit, count);
  if (leaf_mode == 1 && prune)
    return launch_mode<WIDE, 1, true>(p, block, s, threads, any_hit, count);
  return -1;
}

}  // namespace

// Launches the kernel on `stream` for R rays; returns the CUDA error code of
// the launch (0 = success), or -1 when no kernel is built for the asked
// combination. leaf_mode: 0 = leaf rows (variant 1), 1 = triangle records
// (variants 2, 3), 2 = dual-size leaf rows (variant 5, wide 4 only).
// next_ray is an int on the card, zeroed on `stream` before the launch.
// *threads_out (if not null) receives the threads per block launched:
// `block`, or for a staged launch the most the registers allow. Allocates
// nothing and does not synchronise.
extern "C" int kexp_traverse_launch(
    const float* nodes, const float* leaves, const float* o, const float* d,
    const float* tmax, float* t_out, int* i_out, int R, int n_nodes, int wide,
    int leaf_mode, int prune, int any_hit, int count_mode, int leaf_max,
    int block_rows, int cnt_bits, float gscale, int block, int smem_nodes,
    int* next_ray, int* threads_out, void* stream) {
  if (R <= 0 || smem_nodes < 0 || smem_nodes > n_nodes ||
      (block != 64 && block != 128 && block != 256) || next_ray == nullptr)
    return -1;
  const Params p{reinterpret_cast<const float4*>(nodes),
                 leaves,
                 o,
                 d,
                 tmax,
                 t_out,
                 i_out,
                 next_ray,
                 R,
                 leaf_max,
                 block_rows,
                 cnt_bits,
                 gscale,
                 smem_nodes};
  const auto s = (cudaStream_t)stream;
  const bool any = any_hit != 0, count = count_mode != 0;
  if (leaf_mode == 2)
    return (wide == 4 && !prune)
               ? launch_mode<4, 2, false>(p, block, s, threads_out, any, count)
               : -1;
  if (wide == 4)
    return launch_wide<4>(p, block, s, threads_out, leaf_mode, prune != 0,
                          any, count);
  if (wide == 8)
    return launch_wide<8>(p, block, s, threads_out, leaf_mode, prune != 0,
                          any, count);
  return -1;
}
