// Fused path-bounce kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel pbrt_tpu/ops/fused_path.py::_kernel (Pallas).
// It runs the whole path-tracing bounce loop of one ray per thread:
// closest hit over <= 1024 triangles plus the light's aaplane, emission
// at bounce 0, next-event estimation (mode 1: portal projection, one
// shadow sweep; mode 0: two-sample MIS, two sweeps), cosine continuation
// and russian roulette after bounce 3. Per bounce it writes three
// parameter-free residuals (code int32, knee and kc float32) that
// pbrt_tpu_torch/ops/fused_path.py::replay turns into radiance.
//
// What bounds it on this card: the instructions issued per ray-triangle
// test. Each test is 46 counted float operations against 64 bytes of
// triangle that every thread of the block reads at the same time, and a
// path does (max_depth+1) + max_depth sweeps (mode 1) over all triangles,
// while it writes only 12 bytes of residuals per bounce. No multiply-add is
// contracted (see below), so the kernel can reach at most half of the
// FMA-counted float32 rate, and besides them each test issues the row's
// loads, the correctly rounded division, compares and selects.
//
// Design. The scene tables live in shared memory (one copy per block,
// broadcast reads), the path state in registers across all bounces (no
// device-memory traffic between bounces), the light-plane axis is a
// template parameter (so no runtime-indexed register array spills), and a
// 32-triangle cluster is skipped when no live path of the warp can reach
// its box (a warp vote, conservative, so hits equal the flat sweep's).
// Each triangle test is tri_sweep.cuh's step (the division unconditional,
// no select around it), and a sweep keeps only the hit's t and index and
// reads the normal and material once after it, not on every hit: 8-10%
// less time per launch than with ray_tri.cuh's test and the per-hit moves
// (PERF.md §6). Tried and dropped (PERF.md §6): the
// warp-wide early reject of tri_sweep.cuh in every sweep (2.3% slower: the
// main path's bounce rays spread too much for a warp to skip a division
// often enough) or only in bounce 0's sweeps (0.2%, within noise), and two
// paths per thread sharing each row read (slower still, at 126 registers
// against 73).
//
// Numerics follow the plain-torch twin (_kernel_reference) operation by
// operation: build with --fmad=false and without fast math, so no
// multiply-add is contracted and sqrtf / sinf / cosf / division are the
// full-precision versions. The uniform is pcg4d in uint32 exactly as
// pbrt_tpu/core/rng.py keys it.
//
// Control flow is warp-uniform: every lane of a warp runs the same
// sweeps (a lane whose path ended, or that lies past R, computes and
// discards), so the cluster vote can use the full mask. A warp stops as
// soon as none of its paths is alive. A lane whose path has ended writes
// code = knee = kc = 0 for its remaining bounces, which replay maps to the
// same radiance as the reference's residuals.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_sweep.cuh"

namespace {

using tri_sweep::Rays;
using tri_sweep::TriRow;

constexpr int kBlock = 256;
constexpr int kCluster = 32;
constexpr float kBig = 1e30f;
constexpr double kPi = 3.14159265358979323846;
constexpr float kInvPi = (float)(1.0 / kPi);
constexpr float kPi4 = (float)(kPi / 4.0);
constexpr float kPi2 = (float)(kPi / 2.0);
constexpr float kShadowEps = 1e-3f;
constexpr int kDimBase = 6;     // integrators/render.py _bounce_dims
constexpr int kDimStride = 10;
constexpr int kAlive = 8;       // residual code bits (fused_path.py)
constexpr int kRrDiv = 16;
constexpr int kEmit = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* tri;   // (n_rows,16): v0 e1 e2 n mat pad
  const float* msc;   // (1,16): plane lo hi mat, portal lo hi, pad
  const float* kd;    // (n_mat,3)
  const float* clu;   // (n_clu,8): lo hi pad
  const float* o;     // (R,3)
  const float* d;     // (R,3)
  const int* pid;     // (R,)
  const int* sidx;    // (R,)
  int* code;          // (n_b,R)
  float* knee;        // (n_b,R)
  float* kc;          // (n_b,R)
  int R, n_tri, n_rows, n_clu, n_b, n_mat;
  uint32_t seed;
  float rr_threshold;
  int pl_facing, portal_facing;
};

// jnp.maximum / jnp.minimum: NaN propagates from either side
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// jnp.sign: 0 at 0, NaN at NaN
__device__ __forceinline__ float jsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

template <int K>
__device__ __forceinline__ float comp(float x, float y, float z) {
  return K == 0 ? x : (K == 1 ? y : z);
}

// core/rng.py pcg4d → u32_to_uniform (first output only)
__device__ __forceinline__ float unif(uint32_t pid, uint32_t sid,
                                      uint32_t dim, uint32_t seed) {
  const uint32_t mul = 1664525u, inc = 1013904223u;
  uint32_t v0 = pid * mul + inc;
  uint32_t v1 = sid * mul + inc;
  uint32_t v2 = dim * mul + inc;
  uint32_t v3 = seed * mul + inc;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  v3 ^= v3 >> 16;
  v0 += v1 * v3;
  return (float)(v0 >> 8) * (1.0f / 16777216.0f);
}

struct Hit {
  float t;
  int p;
  float nx, ny, nz, m;
};

// Closest hit over the triangles + the single aaplane (same tests as
// pbrt_tpu/ops/fused_path.py sweep). Each triangle is tri_sweep.cuh's step
// on this thread's one ray; the hit primitive's normal and material are
// read once, after the sweep.
template <int AX, bool ATTRS>
__device__ __forceinline__ Hit sweep(const Params& p,
                                     const float* __restrict__ s_tri,
                                     const float* __restrict__ s_clu,
                                     const float* pl_lo, const float* pl_hi,
                                     float pl_mat, float sgn_pl, bool live,
                                     float rox, float roy, float roz,
                                     float rdx, float rdy, float rdz) {
  constexpr int AX0 = AX == 2 ? 0 : (AX == 0 ? 1 : 2);
  constexpr int AX1 = AX == 2 ? 1 : (AX == 0 ? 2 : 0);
  const Rays<1> ray{{rox}, {roy}, {roz}, {rdx}, {rdy}, {rdz}};
  float best_t[1] = {kBig};
  int best_i[1] = {-1};
  auto test = [&](int i) {
    const float* r = s_tri + 16 * i;
    tri_sweep::tri_step<1, false>(
        TriRow{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8]}, ray, i,
        best_t, best_i);
  };
  if (p.n_clu == 0) {
    for (int i = 0; i < p.n_tri; ++i) test(i);
  } else {
    const float ivx = (rdx >= 0.f ? 1.f : -1.f) / jmax(fabsf(rdx), 1e-30f);
    const float ivy = (rdy >= 0.f ? 1.f : -1.f) / jmax(fabsf(rdy), 1e-30f);
    const float ivz = (rdz >= 0.f ? 1.f : -1.f) / jmax(fabsf(rdz), 1e-30f);
    for (int ci = 0; ci < p.n_clu; ++ci) {
      const float* c = s_clu + 8 * ci;
      float tnear = -kBig, tfar = kBig;
      float t0 = (c[0] - rox) * ivx, t1 = (c[3] - rox) * ivx;
      tnear = jmax(tnear, jmin(t0, t1));
      tfar = jmin(tfar, jmax(t0, t1));
      t0 = (c[1] - roy) * ivy;
      t1 = (c[4] - roy) * ivy;
      tnear = jmax(tnear, jmin(t0, t1));
      tfar = jmin(tfar, jmax(t0, t1));
      t0 = (c[2] - roz) * ivz;
      t1 = (c[5] - roz) * ivz;
      tnear = jmax(tnear, jmin(t0, t1));
      tfar = jmin(tfar, jmax(t0, t1));
      const bool ov = (tfar >= jmax(tnear, 0.f)) && (tnear <= best_t[0]);
      // warp-uniform skip: sweep the leaf if any live lane overlaps it
      if (__any_sync(kFull, live && ov)) {
        for (int i = ci * kCluster; i < ci * kCluster + kCluster; ++i)
          test(i);
      }
    }
  }
  Hit h{best_t[0], best_i[0], 0.f, 0.f, 0.f, 0.f};
  // the aaplane (plane.cpp:15-55 slab test)
  const float o_ax = comp<AX>(rox, roy, roz);
  const float d_ax = comp<AX>(rdx, rdy, rdz);
  const bool okd = fabsf(d_ax) > 1e-12f;
  const float t = (pl_lo[AX] - o_ax) / (okd ? d_ax : 1e-12f);
  const float h0 = comp<AX0>(rox, roy, roz) + t * comp<AX0>(rdx, rdy, rdz);
  const float h1 = comp<AX1>(rox, roy, roz) + t * comp<AX1>(rdx, rdy, rdz);
  if (okd && t > 1e-4f && t < h.t && h0 > pl_lo[AX0] && h0 < pl_hi[AX0] &&
      h1 > pl_lo[AX1] && h1 < pl_hi[AX1]) {
    h.t = t;
    h.p = p.n_tri;
  }
  if (ATTRS) {
    if (h.p == p.n_tri) {
      h.nx = AX == 0 ? sgn_pl : 0.f;
      h.ny = AX == 1 ? sgn_pl : 0.f;
      h.nz = AX == 2 ? sgn_pl : 0.f;
      h.m = pl_mat;
    } else if (h.p >= 0) {
      const float* r = s_tri + 16 * h.p;
      h.nx = r[9];
      h.ny = r[10];
      h.nz = r[11];
      h.m = r[12];
    }
  }
  return h;
}

// concentric disk → cosine hemisphere (core/sampling.py:178-196)
__device__ __forceinline__ void cosine_dir(float u0, float u1, float& cx,
                                           float& cy, float& cz) {
  const float x = 2.f * u0 - 1.f;
  const float y = 2.f * u1 - 1.f;
  const bool zero = (x == 0.f) && (y == 0.f);
  const bool use_x = fabsf(x) > fabsf(y);
  float r = use_x ? x : y;
  float th = use_x ? kPi4 * (y / (x == 0.f ? 1.f : x))
                   : kPi2 - kPi4 * (x / (y == 0.f ? 1.f : y));
  if (zero) {
    r = 0.f;
    th = 0.f;
  }
  cx = r * cosf(th);
  cy = r * sinf(th);
  cz = sqrtf(jmax(0.f, 1.f - cx * cx - cy * cy));
}

template <int AX, int MODE>
__global__ void __launch_bounds__(kBlock)
    fused_path_kernel(const Params p) {
  constexpr int AX0 = AX == 2 ? 0 : (AX == 0 ? 1 : 2);
  constexpr int AX1 = AX == 2 ? 1 : (AX == 0 ? 2 : 0);
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_clu = s_tri + 16 * p.n_rows;
  float* s_msc = s_clu + 8 * p.n_clu;
  float* s_kd = s_msc + 16;
  for (int k = threadIdx.x; k < 16 * p.n_rows; k += blockDim.x)
    s_tri[k] = p.tri[k];
  for (int k = threadIdx.x; k < 8 * p.n_clu; k += blockDim.x)
    s_clu[k] = p.clu[k];
  for (int k = threadIdx.x; k < 16; k += blockDim.x) s_msc[k] = p.msc[k];
  for (int k = threadIdx.x; k < 3 * p.n_mat; k += blockDim.x)
    s_kd[k] = p.kd[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < p.R;
  float cox = 0.f, coy = 0.f, coz = 0.f, cdx = 0.f, cdy = 0.f, cdz = 1.f;
  uint32_t pid = 0u, sid = 0u;
  if (in_range) {
    cox = p.o[3 * i];
    coy = p.o[3 * i + 1];
    coz = p.o[3 * i + 2];
    cdx = p.d[3 * i];
    cdy = p.d[3 * i + 1];
    cdz = p.d[3 * i + 2];
    pid = (uint32_t)p.pid[i];
    sid = (uint32_t)p.sidx[i];
  }
  const float sgn_pl = p.pl_facing ? 1.f : -1.f;
  const float pl_lo[3] = {s_msc[0], s_msc[1], s_msc[2]};
  const float pl_hi[3] = {s_msc[3], s_msc[4], s_msc[5]};
  const float pl_mat = s_msc[6];
  const float po_lo[3] = {s_msc[7], s_msc[8], s_msc[9]};
  const float po_hi[3] = {s_msc[10], s_msc[11], s_msc[12]};
  const float area_l = (pl_hi[AX0] - pl_lo[AX0]) * (pl_hi[AX1] - pl_lo[AX1]);

  float beta0 = 1.f, beta1 = 1.f, beta2 = 1.f;
  bool active = in_range;
  bool spec = true;

  for (int b = 0; b < p.n_b; ++b) {
    const size_t out = (size_t)b * p.R + i;
    if (!__any_sync(kFull, active)) {
      // no path of this warp is alive: residuals of ended paths are 0
      if (in_range) {
        p.code[out] = 0;
        p.knee[out] = 0.f;
        p.kc[out] = 0.f;
      }
      continue;
    }
    const bool live = active;  // this lane's residuals are meaningful
    const uint32_t base = kDimBase + b * kDimStride;
    const Hit h = sweep<AX, true>(p, s_tri, s_clu, pl_lo, pl_hi, pl_mat,
                                  sgn_pl, live, cox, coy, coz, cdx, cdy,
                                  cdz);
    const float nx = h.nx, ny = h.ny, nz = h.nz;
    const bool hitv = h.p >= 0;
    const float tv = hitv ? h.t : 0.f;
    const float px = cox + tv * cdx;
    const float py = coy + tv * cdy;
    const float pz = coz + tv * cdz;
    // emission at the camera vertex: the one-sided light plane
    const bool kemit = active && spec && h.p == p.n_tri &&
                       (sgn_pl * -comp<AX>(cdx, cdy, cdz)) > 0.f;
    active = active && hitv;
    const int mi = (int)h.m;

    if (b == p.n_b - 1) {
      // the final iteration collects emission only
      if (in_range) {
        p.code[out] = live ? mi + (kemit ? kEmit : 0) : 0;
        p.knee[out] = 0.f;
        p.kc[out] = 0.f;
      }
      continue;
    }

    // shading frame (Duff; vecmath.coordinate_system)
    const float s = nz >= 0.f ? 1.f : -1.f;
    const float a = -1.0f / (s + nz);
    const float bb = nx * ny * a;
    const float t1x = 1.f + s * nx * nx * a, t1y = s * bb, t1z = -s * nx;
    const float t2x = bb, t2y = s + ny * ny * a, t2z = -ny;
    const float woz = -(cdx * nx + cdy * ny + cdz * nz);

    // ---- NEE: uniform point on the light rect (sample_aaplane)
    const float u_l0 = unif(pid, sid, base + 1, p.seed);
    const float u_l1 = unif(pid, sid, base + 2, p.seed);
    float lp[3];
    lp[AX] = pl_lo[AX];
    lp[AX0] = pl_lo[AX0] + (pl_hi[AX0] - pl_lo[AX0]) * u_l0;
    lp[AX1] = pl_lo[AX1] + (pl_hi[AX1] - pl_lo[AX1]) * u_l1;
    const float tox = lp[0] - px, toy = lp[1] - py, toz = lp[2] - pz;
    const float d2l = tox * tox + toy * toy + toz * toz;
    const float rl = rsqrtf(jmax(d2l, 1e-30f));
    const float wlx = tox * rl, wly = toy * rl, wlz = toz * rl;
    const float cos_l = fabsf(comp<AX>(wlx, wly, wlz));
    const float pdf_fb = d2l / (jmax(area_l, 1e-20f) * jmax(cos_l, 1e-9f));

    float wix = wlx, wiy = wly, wiz = wlz, pdf_nee = pdf_fb;
    if (MODE == 1) {
      // projection sampling (aaportal.cpp SampleProj): project the light
      // rect's corners through the portal plane, clip, sample
      const float p_ax = comp<AX>(px, py, pz);
      const bool in_front =
          p.portal_facing ? (p_ax > po_lo[AX]) : (p_ax < po_lo[AX]);
      const float po_c = po_lo[AX];
      float pr0[2], pr1[2];
      bool okc[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* lc = c == 0 ? pl_lo : pl_hi;
        const float dvx = px - lc[0], dvy = py - lc[1], dvz = pz - lc[2];
        const float d_axv = comp<AX>(dvx, dvy, dvz);
        okc[c] = fabsf(d_axv) > 1e-12f;
        const float tt = (po_c - lc[AX]) / (okc[c] ? d_axv : 1e-12f);
        pr0[c] = lc[AX0] + tt * comp<AX0>(dvx, dvy, dvz);
        pr1[c] = lc[AX1] + tt * comp<AX1>(dvx, dvy, dvz);
      }
      const float cmin0 = jmax(po_lo[AX0], jmin(pr0[0], pr0[1]));
      const float cmax0 = jmin(po_hi[AX0], jmax(pr0[0], pr0[1]));
      const float len0 = jmax(cmax0 - cmin0, 0.f);
      const float cmin1 = jmax(po_lo[AX1], jmin(pr1[0], pr1[1]));
      const float cmax1 = jmin(po_hi[AX1], jmax(pr1[0], pr1[1]));
      const float len1 = jmax(cmax1 - cmin1, 0.f);
      const float area_p = len0 * len1;
      const bool okp = okc[0] && okc[1] && area_p > 1e-12f;
      float sp[3];
      sp[AX] = po_c;
      sp[AX0] = cmin0 + u_l0 * len0;
      sp[AX1] = cmin1 + u_l1 * len1;
      const float tpx = sp[0] - px, tpy = sp[1] - py, tpz = sp[2] - pz;
      const float d2p = tpx * tpx + tpy * tpy + tpz * tpz;
      const float rp = rsqrtf(jmax(d2p, 1e-30f));
      const float wpx = tpx * rp, wpy = tpy * rp, wpz = tpz * rp;
      const float cos_p = fabsf(comp<AX>(wpx, wpy, wpz));
      const float pdf_pj = okp ? d2p / jmax(cos_p * area_p, 1e-9f) : 0.f;
      if (in_front) {
        wix = wpx;
        wiy = wpy;
        wiz = wpz;
        pdf_nee = pdf_pj;
      }
    }

    // shadow/emission sweep from the offset origin (offset_ray_origin)
    const float scale =
        kShadowEps * jmax(1.f, jmax(fabsf(px), jmax(fabsf(py), fabsf(pz))));
    const float ndw = nx * wix + ny * wiy + nz * wiz;
    const float nfs = ndw < 0.f ? -1.f : 1.f;
    const Hit h2 = sweep<AX, false>(
        p, s_tri, s_clu, pl_lo, pl_hi, pl_mat, sgn_pl, live,
        px + scale * nfs * nx, py + scale * nfs * ny, pz + scale * nfs * nz,
        wix, wiy, wiz);
    const bool le_hit =
        h2.p == p.n_tri && (sgn_pl * -comp<AX>(wix, wiy, wiz)) > 0.f;
    const bool refl = (woz * ndw) > 0.f;
    const bool ok_nee = active && pdf_nee > 0.f && refl && le_hit;
    float knee = ok_nee ? fabsf(ndw) / jmax(pdf_nee, 1e-20f) : 0.f;

    if (MODE == 0) {
      // two-sample MIS: light half (power heuristic) + BSDF half
      const float p_scat = refl ? fabsf(ndw) * kInvPi : 0.f;
      const float w_l = (pdf_nee * pdf_nee) /
                        jmax(pdf_nee * pdf_nee + p_scat * p_scat, 1e-20f);
      knee = knee * w_l;
      float bdx, bdy, bdz;
      cosine_dir(unif(pid, sid, base + 4, p.seed),
                 unif(pid, sid, base + 5, p.seed), bdx, bdy, bdz);
      const float sflip_b = jsign(woz + 1e-20f);
      const float wbx_l = bdx * sflip_b, wby_l = bdy * sflip_b,
                  wbz_l = bdz * sflip_b;
      const float wbx = wbx_l * t1x + wby_l * t2x + wbz_l * nx;
      const float wby = wbx_l * t1y + wby_l * t2y + wbz_l * ny;
      const float wbz = wbx_l * t1z + wby_l * t2z + wbz_l * nz;
      const float pdf_b = fabsf(wbz_l) * kInvPi;
      const float ndw_b = nx * wbx + ny * wby + nz * wbz;
      const float nfs_b = ndw_b < 0.f ? -1.f : 1.f;
      const Hit h3 = sweep<AX, false>(
          p, s_tri, s_clu, pl_lo, pl_hi, pl_mat, sgn_pl, live,
          px + scale * nfs_b * nx, py + scale * nfs_b * ny,
          pz + scale * nfs_b * nz, wbx, wby, wbz);
      const float wb_ax = comp<AX>(wbx, wby, wbz);
      const bool hit_l3 = h3.p == p.n_tri && (sgn_pl * -wb_ax) > 0.f;
      const float pdf_li_b =
          (h3.t * h3.t) / jmax(fabsf(wb_ax) * area_l, 1e-9f);
      const float w_b = (pdf_b * pdf_b) /
                        jmax(pdf_b * pdf_b + pdf_li_b * pdf_li_b, 1e-20f);
      const float knee_b = (active && hit_l3 && pdf_b > 0.f)
                               ? fabsf(ndw_b) * w_b / jmax(pdf_b, 1e-20f)
                               : 0.f;
      knee = knee + knee_b;
    }

    // ---- continuation (matte cosine lobe)
    float ddx, ddy, ddz;
    cosine_dir(unif(pid, sid, base + 7, p.seed),
               unif(pid, sid, base + 8, p.seed), ddx, ddy, ddz);
    const float sflip = jsign(woz + 1e-20f);
    const float wcx = ddx * sflip, wcy = ddy * sflip, wcz = ddz * sflip;
    const float wwx = wcx * t1x + wcy * t2x + wcz * nx;
    const float wwy = wcx * t1y + wcy * t2y + wcz * ny;
    const float wwz = wcx * t1z + wcy * t2z + wcz * nz;
    const float pdf_c = fabsf(wcz) * kInvPi;
    const float cos_c = fabsf(nx * wwx + ny * wwy + nz * wwz);
    const bool refl_c = (woz * wcz) > 0.f;
    const float kc = refl_c ? cos_c * kInvPi / jmax(pdf_c, 1e-20f) : 0.f;

    // beta tracking for RR and survival
    float kd0 = 0.f, kd1 = 0.f, kd2 = 0.f;
    if (mi >= 0 && mi < p.n_mat) {
      kd0 = s_kd[3 * mi];
      kd1 = s_kd[3 * mi + 1];
      kd2 = s_kd[3 * mi + 2];
    }
    float bn0 = beta0 * kd0 * kc, bn1 = beta1 * kd1 * kc,
          bn2 = beta2 * kd2 * kc;
    const float bmax = jmax(bn0, jmax(bn1, bn2));
    bool alive = active && pdf_c > 0.f && bmax > 0.f;
    bool rr_div = false;
    if (b > 3) {
      // russian roulette (path.cpp:362-370); eta_scale = 1 (matte)
      const bool do_rr = bmax < p.rr_threshold;
      const float q = jmax(0.05f, 1.f - bmax);
      const bool killed = do_rr && unif(pid, sid, base + 9, p.seed) < q;
      rr_div = do_rr && !killed;
      const float inv = 1.0f / jmax(1.f - q, 1e-6f);
      if (rr_div) {
        bn0 = bn0 * inv;
        bn1 = bn1 * inv;
        bn2 = bn2 * inv;
      }
      alive = alive && !killed;
    }

    if (in_range) {
      p.code[out] = live ? mi + (alive ? kAlive : 0) + (rr_div ? kRrDiv : 0) +
                               (kemit ? kEmit : 0)
                         : 0;
      p.knee[out] = live ? knee : 0.f;
      p.kc[out] = live ? kc : 0.f;
    }

    // state update (render.py _li_loop tail)
    if (alive) {
      beta0 = bn0;
      beta1 = bn1;
      beta2 = bn2;
      const float ndw2 = nx * wwx + ny * wwy + nz * wwz;
      const float nfs2 = ndw2 < 0.f ? -1.f : 1.f;
      cox = px + scale * nfs2 * nx;
      coy = py + scale * nfs2 * ny;
      coz = pz + scale * nfs2 * nz;
      cdx = wwx;
      cdy = wwy;
      cdz = wwz;
    }
    spec = spec && !alive;
    active = alive;
  }
}

template <int AX, int MODE>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a launch must opt in, or it is
  // refused without running
  cudaError_t err = cudaFuncSetAttribute(
      fused_path_kernel<AX, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.R + kBlock - 1) / kBlock;
  fused_path_kernel<AX, MODE><<<blocks, kBlock, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_path_launch(
    const float* tri, const float* msc, const float* kd, const float* clu,
    const float* o, const float* d, const int* pid, const int* sidx,
    int* code, float* knee, float* kc, int R, int n_tri, int n_rows,
    int n_clu, int n_b, int n_mat, uint32_t seed, float rr_threshold, int ax,
    int pl_facing, int portal_facing, int mode, void* stream) {
  const Params p{tri, msc, kd, clu, o, d, pid, sidx, code, knee, kc,
                 R, n_tri, n_rows, n_clu, n_b, n_mat, seed, rr_threshold,
                 pl_facing, portal_facing};
  const size_t smem =
      sizeof(float) * (16 * (size_t)n_rows + 8 * (size_t)n_clu + 16 +
                       3 * (size_t)n_mat);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (ax * 2 + (mode == 1 ? 1 : 0)) {
    case 0: return (int)launch<0, 0>(p, smem, st);
    case 1: return (int)launch<0, 1>(p, smem, st);
    case 2: return (int)launch<1, 0>(p, smem, st);
    case 3: return (int)launch<1, 1>(p, smem, st);
    case 4: return (int)launch<2, 0>(p, smem, st);
    case 5: return (int)launch<2, 1>(p, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
