"""Object instancing: shared object-space geometry and per-instance
transforms (port of pbrt_tpu/scene/instances.py).

Counterpart of ``TransformedPrimitive`` (core/primitive.h:92-117) and the
ObjectBegin / ObjectInstance API (core/api.cpp). An instanced object's
triangles are stored once, in object space; each instance adds a 4×4
transform pair. Instanced hits get virtual primitive ids in
``[n_base_prims, n_base_prims + n_vprims)``; ``Scene.prim_mat`` and
``prim_light`` carry one entry per (instance, pool triangle), so every
material and light gather works unchanged. As in pbrt, an area light
inside an instanced object is not supported (the parser flattens such an
object instead).

The instance walk runs after the closest-hit kernel (or the BVH
traversal) in plain torch, as pbrt_tpu runs it in jnp outside any Pallas
kernel: a Python loop over objects and their instances in pbrt_tpu's
order, each a slab test against the object's box and an all-pairs
triangle test of the rays against the object's pool triangles, in object
space. The direction is left unnormalized, so object-space t is world t.
Products with the 3×3 transforms are written as elementwise sums, never
as a matmul (which may run in TF32 on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.scene import shapes


@dataclasses.dataclass
class InstanceTable:
    o2w: torch.Tensor         # (I,4,4) object → world
    w2o: torch.Tensor         # (I,4,4) world → object
    inst_ids: torch.Tensor    # (I,) int32, instance ids grouped by object
    vstart: torch.Tensor      # (I,) int32, first virtual prim per instance
    pool_v0: torch.Tensor     # (P,3) object-space shared triangles
    pool_v1: torch.Tensor
    pool_v2: torch.Tensor
    pool_uv0: torch.Tensor    # (P,2)
    pool_uv1: torch.Tensor
    pool_uv2: torch.Tensor
    pool_n0: torch.Tensor     # (P,3) object-space shading normals
    pool_n1: torch.Tensor     # (the face normal where the mesh has none)
    pool_n2: torch.Tensor
    vprim_inst: torch.Tensor  # (V,) int32 virtual prim → instance
    vprim_tri: torch.Tensor   # (V,) int32 virtual prim → pool triangle
    obj_lo: torch.Tensor      # (O,3) object-space box
    obj_hi: torch.Tensor      # (O,3)
    # per object: (tri_start, tri_count, inst_start, inst_count)
    obj_layout: tuple = ()
    # the host copy of inst_ids, for the walk's loop
    inst_order: tuple = ()

    @property
    def n_vprims(self) -> int:
        return self.vprim_inst.shape[0]


def _xform_p(m, p):
    """A (4,4) applied to points (R,3)."""
    return (p[:, None, :] * m[:3, :3]).sum(-1) + m[:3, 3]


def _xform_v(m, v):
    return (v[:, None, :] * m[:3, :3]).sum(-1)


def _xform_p_batched(m, p):
    """(R,4,4) applied to (R,3) points."""
    return (m[:, :3, :3] * p[:, None, :]).sum(-1) + m[:, :3, 3]


def _ray_box(o, inv_d, lo, hi, tmax):
    """Slab test against one box → hit mask (R,)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    return (tn <= tf) & (tf > 1e-5) & (tn < tmax)


def _local_ray(it, i, o, d):
    m = it.w2o[i]
    o_l = _xform_p(m, o)
    d_l = _xform_v(m, d)
    inv_d = 1.0 / torch.where(d_l.abs() > 1e-12, d_l,
                              torch.where(d_l >= 0, 1e-12, -1e-12))
    return o_l, d_l, inv_d


def _tri_hits(o_l, d_l, tmax, v0, v1, v2):
    """All-pairs ray × pool-triangle test → (t, hit), each (R, T)."""
    t, _, _, h = shapes.intersect_triangle_paired(
        o_l[:, None, :], d_l[:, None, :], tmax[:, None], v0[None], v1[None],
        v2[None])
    return t, h


def _objects(it):
    for obj_i, (ts, tc, is_, ic) in enumerate(it.obj_layout):
        yield (obj_i, it.pool_v0[ts:ts + tc], it.pool_v1[ts:ts + tc],
               it.pool_v2[ts:ts + tc], it.inst_order[is_:is_ + ic])


def update_closest(scene, o, d, best_t, prim_id):
    """Fold the instanced geometry into a closest hit (best_t, prim_id):
    pbrt_tpu's update ``any & (tb < best_t) & in_box`` with the first pool
    triangle of least t. Not differentiated, as the kernels' queries."""
    it = scene.inst
    if it is None or it.n_vprims == 0:
        return best_t, prim_id
    base_n = scene.n_base_prims
    with torch.no_grad():
        o, d = o.detach(), d.detach()
        for obj_i, v0, v1, v2, ids in _objects(it):
            lo, hi = it.obj_lo[obj_i], it.obj_hi[obj_i]
            for i in ids:
                o_l, d_l, inv_d = _local_ray(it, i, o, d)
                in_box = _ray_box(o_l, inv_d, lo, hi, best_t)
                t, h = _tri_hits(o_l, d_l,
                                 torch.where(in_box, best_t, -1.0),
                                 v0, v1, v2)
                tb, idx = torch.where(h, t, shapes.BIG).min(dim=-1)
                upd = (tb < shapes.BIG) & (tb < best_t) & in_box
                prim_id = torch.where(
                    upd, (base_n + it.vstart[i] + idx).to(prim_id.dtype),
                    prim_id)
                best_t = torch.where(upd, tb, best_t)
    return best_t, prim_id


def any_hit(scene, o, d, tmax):
    """Does any instanced triangle block the segment below tmax? (R,)."""
    it = scene.inst
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if it is None or it.n_vprims == 0:
        return occ
    with torch.no_grad():
        o, d, tmax = o.detach(), d.detach(), tmax.detach()
        for obj_i, v0, v1, v2, ids in _objects(it):
            lo, hi = it.obj_lo[obj_i], it.obj_hi[obj_i]
            for i in ids:
                o_l, d_l, inv_d = _local_ray(it, i, o, d)
                in_box = _ray_box(o_l, inv_d, lo, hi, tmax) & ~occ
                _, h = _tri_hits(o_l, d_l, torch.where(in_box, tmax, -1.0),
                                 v0, v1, v2)
                occ = occ | (h.any(-1) & in_box)
    return occ


def finalize_instance_hits(scene, t, prim_id, p, ng, ns, uv, dpdu, dpdv):
    """Hit attributes of the virtual (instanced) prims, as
    TransformedPrimitive::Intersect's SurfaceInteraction transform
    (core/primitive.cpp:90-100): the world-space triangle from the
    instance's o2w, the interpolated shading normal through the
    inverse-transpose (core/transform.cpp:358), and dpdu / dpdv from the
    uv parameterization (triangle.cpp:157-168)."""
    it = scene.inst
    base_n = scene.n_base_prims
    vi = (prim_id - base_n).clamp(0, it.n_vprims - 1)
    is_v = ((prim_id >= base_n) & (prim_id < base_n + it.n_vprims))[..., None]
    i = it.vprim_inst[vi].long()
    j = it.vprim_tri[vi].long()
    m = it.o2w[i]
    v0 = _xform_p_batched(m, it.pool_v0[j])
    v1 = _xform_p_batched(m, it.pool_v1[j])
    v2 = _xform_p_batched(m, it.pool_v2[j])
    ngv = shapes.triangle_normal(v0, v1, v2)
    e1 = v1 - v0
    e2 = v2 - v0
    rp = p - v0
    d00 = vecmath.dot(e1, e1)
    d01 = vecmath.dot(e1, e2)
    d11 = vecmath.dot(e2, e2)
    d20 = vecmath.dot(rp, e1)
    d21 = vecmath.dot(rp, e2)
    den = torch.clamp_min(d00 * d11 - d01 * d01, 1e-20)
    bu = torch.clamp((d11 * d20 - d01 * d21) / den, 0.0, 1.0)
    bv = torch.clamp((d00 * d21 - d01 * d20) / den, 0.0, 1.0)
    w = torch.clamp(1.0 - bu - bv, 0.0, 1.0)
    uv0, uv1, uv2 = it.pool_uv0[j], it.pool_uv1[j], it.pool_uv2[j]
    uvv = w[..., None] * uv0 + bu[..., None] * uv1 + bv[..., None] * uv2
    # the object-space shading normal to world by the inverse-transpose:
    # n_w[i] = Σ_j w2o[j, i] · n_o[j]
    n_obj = (w[..., None] * it.pool_n0[j] + bu[..., None] * it.pool_n1[j]
             + bv[..., None] * it.pool_n2[j])
    nsv = vecmath.normalize((it.w2o[i][:, :3, :3]
                             * n_obj[:, :, None]).sum(1))
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    ok_uv = det.abs() > 1e-12
    inv = torch.where(ok_uv, 1.0 / torch.where(ok_uv, det, 1.0), 0.0)
    dpdu_v = (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2) * inv[..., None]
    dpdv_v = (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2) * inv[..., None]
    t1_fb, t2_fb = vecmath.coordinate_system(ngv)
    dpdu_v = torch.where(ok_uv[..., None], dpdu_v, t1_fb)
    dpdv_v = torch.where(ok_uv[..., None], dpdv_v, t2_fb)
    return (torch.where(is_v, ngv, ng), torch.where(is_v, nsv, ns),
            torch.where(is_v, uvv, uv), torch.where(is_v, dpdu_v, dpdu),
            torch.where(is_v, dpdv_v, dpdv))


def build_instance_table(objects, instances, device="cpu"):
    """Host-side build. objects: dicts {"tris": [(v0, v1, v2, uvs or None,
    normals or None, mat)]}; instances: (obj_id, o2w 4×4) pairs. Returns
    (InstanceTable, vprim_mat (V,) np.int32)."""
    pool_v = [[], [], []]
    pool_uv = [[], [], []]
    pool_n = [[], [], []]
    pool_mat = []
    obj_tri_range = []
    obj_lo, obj_hi = [], []
    for ob in objects:
        s = len(pool_mat)
        for (v0, v1, v2, uvs, nrm, mat) in ob["tris"]:
            pool_v[0].append(v0)
            pool_v[1].append(v1)
            pool_v[2].append(v2)
            if uvs is None:
                uvs = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0))
            if nrm is None:
                fn = np.cross(np.asarray(v1, np.float64) - v0,
                              np.asarray(v2, np.float64) - v0)
                ln = np.linalg.norm(fn)
                fn = fn / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
                nrm = (fn, fn, fn)
            for k in range(3):
                pool_uv[k].append(uvs[k])
                pool_n[k].append(np.asarray(nrm[k], np.float32))
            pool_mat.append(mat)
        c = len(pool_mat) - s
        obj_tri_range.append((s, c))
        vs = np.asarray(pool_v[0][s:s + c] + pool_v[1][s:s + c]
                        + pool_v[2][s:s + c], np.float32).reshape(-1, 3)
        if len(vs):
            obj_lo.append(vs.min(0) - 1e-5)
            obj_hi.append(vs.max(0) + 1e-5)
        else:
            obj_lo.append(np.zeros(3, np.float32))
            obj_hi.append(np.zeros(3, np.float32))

    by_obj = [[] for _ in objects]
    o2w_list, w2o_list = [], []
    for idx, (obj_id, m) in enumerate(instances):
        by_obj[obj_id].append(idx)
        m = np.asarray(m, np.float32).reshape(4, 4)
        o2w_list.append(m)
        w2o_list.append(np.linalg.inv(m).astype(np.float32))

    inst_ids = []
    layout = []
    for ob in range(len(objects)):
        ts, tc = obj_tri_range[ob]
        layout.append((ts, tc, len(inst_ids), len(by_obj[ob])))
        inst_ids.extend(by_obj[ob])

    vstart = np.zeros(len(instances), np.int32)
    vprim_inst, vprim_tri, vprim_mat = [], [], []
    v = 0
    for i, (obj_id, _) in enumerate(instances):
        ts, tc = obj_tri_range[obj_id]
        vstart[i] = v
        vprim_inst.extend([i] * tc)
        vprim_tri.extend(range(ts, ts + tc))
        vprim_mat.extend(pool_mat[ts:ts + tc])
        v += tc

    def t(a, dtype=np.float32, width=None):
        a = np.asarray(a, dtype)
        return torch.as_tensor(a if width is None else a.reshape(-1, width),
                               device=device)

    table = InstanceTable(
        o2w=t(np.stack(o2w_list)), w2o=t(np.stack(w2o_list)),
        inst_ids=t(inst_ids, np.int32), vstart=t(vstart, np.int32),
        pool_v0=t(pool_v[0], width=3), pool_v1=t(pool_v[1], width=3),
        pool_v2=t(pool_v[2], width=3),
        pool_uv0=t(pool_uv[0], width=2), pool_uv1=t(pool_uv[1], width=2),
        pool_uv2=t(pool_uv[2], width=2),
        pool_n0=t(pool_n[0], width=3), pool_n1=t(pool_n[1], width=3),
        pool_n2=t(pool_n[2], width=3),
        vprim_inst=t(vprim_inst, np.int32), vprim_tri=t(vprim_tri, np.int32),
        obj_lo=t(np.stack(obj_lo)), obj_hi=t(np.stack(obj_hi)),
        obj_layout=tuple(layout), inst_order=tuple(inst_ids))
    return table, np.asarray(vprim_mat, np.int32)
