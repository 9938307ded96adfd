// The triangle sweep step shared by the brute-force kernel (intersect.cu,
// two rays per thread) and the fused path-bounce kernel (fused_path.cu,
// one path per thread): NP rays against one triangle row, with an optional
// warp-wide early reject in front of the division.
//
// The test is ray_tri.cuh's Moeller-Trumbore, split at the division:
// tri_pre computes det = e1 . (d x e2) and the three numerators
// nu = (o - v0) . (d x e2), nv = d . q and nt = e2 . q, q = (o - v0) x e1,
// with ray_tri.cuh's operations in ray_tri.cuh's order; tri_finish divides
// (inv_det = 1 / det; u = nu * inv_det, v = nv * inv_det, t = nt * inv_det)
// and makes ray_tri.cuh's comparisons. Built with --fmad=false and without
// fast math, tri_finish(tri_pre(...)) hits where ray_tri_hit does, with
// the same t bit for bit.
//
// The early reject. tri_reject(a) looks at det, nu, nv and nt only (no
// division). It is conservative: when it holds, tri_finish(a, best_t, t) is
// false for every best_t. With ad = |det|, s = +1 if det > 0 else -1,
// su = s*nu, sv = s*nv, st = s*nt (negation is exact), it holds when one of
// five clauses does:
//   (1) !(ad > 1e-12f). This is !okd itself (NaN det included).
//   (2) st <= 0. If okd, inv_det = fl(1/det) has the sign of det and is not
//       0 (|1/det| >= 1/FLT_MAX, a subnormal, not 0, without flush to zero).
//       So t = fl(nt * inv_det) <= 0 (nt = +-0 gives t = +-0), and t > 1e-4
//       fails. A det of +-inf gives inv_det = +-0 and t = 0 or NaN: the
//       exact test fails whatever any clause says, as for every non-finite
//       det below.
//   (3) su <= -g, g = ad * 2^-64. For ad > 1e-12 the product is normal and
//       exact, g > 0, so su < 0 strictly and nu * inv_det < 0. Its size is
//       |nu| * |inv_det| >= ad * 2^-64 * (1/ad) * (1 - 2^-22) > 2^-65
//       (fl(1/det) is within 2^-22 relative even where it is subnormal), far
//       above 2^-150, below which a negative product would round to -0 and
//       pass u >= 0 (-0.0f >= 0.0f is true). So u < 0 and u >= 0 fails.
//       That guard is why the clause is not just su < 0.
//   (4) sv <= -g: as (3) for v.
//   (5) fl(su + sv) > fl(ad * (1 + 2^-20)). Take det > 0 (det < 0 is the
//       same with nu, nv, det negated, since rounding to nearest is
//       symmetric). Suppose u >= 0 and v >= 0 (else the test fails anyway).
//       Write i = fl(1/det) >= (1/det)(1 - 2^-22) and, for any product,
//       |fl(x) - x| <= 2^-24 |x| + 2^-150. u >= 0 means nu >= 0 or
//       |nu * i| <= 2^-150 (a negative product rounded to -0), so
//       |nu * i| <= nu * i + 2^-149, and the same for v. Then
//         u + v >= (nu + nv) i (1 - 2^-24) - 2^-147.
//       The clause gives nu + nv >= fl(su + sv)/(1 + 2^-24)
//         > det (1 + 2^-20)(1 - 2^-24)/(1 + 2^-24),
//       so (nu + nv) i > (1 + 2^-20)(1 - 2^-24)(1 - 2^-22)/(1 + 2^-24)
//       > 1 + 0.62 * 2^-20, and u + v > 1 + 0.55 * 2^-20 > 1 + 2^-21. As
//       1 + 2^-21 is a float and rounding is monotone, fl(u + v) >= 1 + 2^-21
//       > 1, and u + v <= 1 fails. (nu, nv or u, v infinite: u + v is +inf
//       or NaN, which fails too; ad * (1 + 2^-20) overflowing to inf makes
//       the clause false.)
// A NaN in su, sv or st makes its clause false, so such a lane is left to
// the exact test. ops/intersect.py::tri_reject_reference mirrors tri_pre
// and tri_reject operation for operation, and tests/test_torch_tri_sweep.py
// holds it to the exact test on random pairs and on each clause's edges.
//
// The step. tri_step runs tri_pre for each of the thread's NP rays; with
// REJECT, the warp then votes once for each of them (ray k of all 32
// lanes), and where no voting ray survives the reject the warp skips that
// ray's division (no voting ray would hit). Otherwise every lane finishes
// the ray exactly, so hits and their t equal ray_tri_hit's bit for bit. A
// ray votes while its best t exceeds 1e-4; one that does not can hit
// nothing (t > 1e-4 && t < best_t). One vote per ray measured faster than
// one vote for both rays of a thread (PERF.md §6): a warp's 32
// neighbouring rays skip together more often than its 64. Control flow
// must be warp-uniform where tri_step is called (the vote uses the full
// mask).

#pragma once

namespace tri_sweep {

constexpr unsigned kFullMask = 0xffffffffu;

struct TriRow {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

template <int NP>
struct Rays {
  float ox[NP], oy[NP], oz[NP], dx[NP], dy[NP], dz[NP];
};

struct TriPre {
  float det, nu, nv, nt;
};

__device__ __forceinline__ TriPre tri_pre(const TriRow& w, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
  const float px = dy * w.e2z - dz * w.e2y;
  const float py = dz * w.e2x - dx * w.e2z;
  const float pz = dx * w.e2y - dy * w.e2x;
  TriPre a;
  a.det = w.e1x * px + w.e1y * py + w.e1z * pz;
  const float rx = ox - w.v0x;
  const float ry = oy - w.v0y;
  const float rz = oz - w.v0z;
  a.nu = rx * px + ry * py + rz * pz;
  const float qx = ry * w.e1z - rz * w.e1y;
  const float qy = rz * w.e1x - rx * w.e1z;
  const float qz = rx * w.e1y - ry * w.e1x;
  a.nv = dx * qx + dy * qy + dz * qz;
  a.nt = w.e2x * qx + w.e2y * qy + w.e2z * qz;
  return a;
}

// ray_tri.cuh's division and comparisons. inv_det is 1 / det on every lane
// (ray_tri.cuh takes 0 where !okd): a lane with !okd misses either way, and
// its t is not used, so hits and their t are ray_tri_hit's; the select
// would only put a branch around the division.
__device__ __forceinline__ bool tri_finish(const TriPre& a, float best_t,
                                           float& t) {
  const bool okd = fabsf(a.det) > 1e-12f;
  const float inv_det = 1.0f / a.det;
  const float u = a.nu * inv_det;
  const float v = a.nv * inv_det;
  t = a.nt * inv_det;
  return okd & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 1e-4f) &
         (t < best_t);
}

__device__ __forceinline__ bool tri_reject(const TriPre& a) {
  const float ad = fabsf(a.det);
  const bool pos = a.det > 0.0f;
  const float su = pos ? a.nu : -a.nu;
  const float sv = pos ? a.nv : -a.nv;
  const float st = pos ? a.nt : -a.nt;
  const float g = ad * 0x1p-64f;
  return !(ad > 1e-12f) | (st <= 0.0f) | (su <= -g) | (sv <= -g) |
         (su + sv > ad * 0x1.00001p0f);  // 1 + 2^-20
}

// One triangle row (index idx) against the thread's NP rays: where ray k
// hits it nearer than best_t[k], best_t[k] and best_i[k] take the hit, as
// ray_tri_hit decides. With REJECT, ray k of every lane of the warp (32
// neighbouring rays) votes on its own, and the warp skips ray k's division
// when no voting ray can hit the row. A ray votes only while it can still
// hit something (best_t > 1e-4: a lane past the last ray or an ended path
// enters its sweep with best t 0).
template <int NP, bool REJECT>
__device__ __forceinline__ void tri_step(const TriRow& w, const Rays<NP>& r,
                                         int idx, float (&best_t)[NP],
                                         int (&best_i)[NP]) {
  TriPre a[NP];
  bool keep[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    a[k] = tri_pre(w, r.ox[k], r.oy[k], r.oz[k], r.dx[k], r.dy[k], r.dz[k]);
    keep[k] = (best_t[k] > 1e-4f) & !tri_reject(a[k]);
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (REJECT && !__any_sync(kFullMask, keep[k])) continue;
    float t;
    if (tri_finish(a[k], best_t[k], t)) {
      best_t[k] = t;
      best_i[k] = idx;
    }
  }
}

}  // namespace tri_sweep
