"""The modules of the generic loop, one by one, against pbrt_tpu:
``finalize_hit``, ``sample_li`` / ``pdf_li``, the three portal samplers,
the matte ``bsdf_f / bsdf_pdf / bsdf_sample`` (Lambert and Oren–Nayar),
light selection and ``estimate_direct``.

One scene holds every ported family: triangles with their own shading
normals and uvs, spheres, aaplanes; Lambert and Oren–Nayar rows; a point,
a spot and a distant light; area lights on a triangle, a sphere and three
aaplanes with portals, one per portal strategy. It is built by pbrt_tpu
and bridged, so both packages read the same tables. Shading points, sample
values and directions come from a numpy seed. pbrt_tpu's side runs as one
jitted function, so it is compiled once.

Tolerances: rtol 1e-5, atol 1e-6 (the same float32 formulas in another
library), except where a formula cancels and so magnifies a last-bit
difference (``LOOSER`` below names each such result and says why). Where
a result depends on a traced ray (``estimate_direct``), at most 6e-3 of
the lanes may fall outside: a float tie at a seam can send a shadow ray
to another primitive (tests/test_fused_path.py:258-261).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.integrators import common as jcommon
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene import lights as jlights
from pbrt_tpu.scene import materials as jmat
from pbrt_tpu.scene import portals as jportals
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import sampling as tsampling
from pbrt_tpu_torch.integrators import common as tcommon
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene import lights as tlights
from pbrt_tpu_torch.scene import materials as tmat
from pbrt_tpu_torch.scene import portals as tportals
from test_torch_intersect import box_rays, jax_scene

R = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
LOOSER = {
    # z = sqrt(1 − x² − y²) of the cosine lobe cancels at grazing angles
    "bsdf_sample.0": dict(rtol=1e-5, atol=5e-6),
    # normalize(p − center) on a sphere of radius 0.08 seen from ~0.5 away,
    # with p from the cone sampler, whose distance to the surface cancels
    # at the cone's rim
    "sample_li.n_light": dict(rtol=1e-5, atol=1e-4),
    # a pdf of a direction that is intersected again: t² / |cos|, and the
    # cosine cancels at grazing angles
    "pdf_li.sampled": dict(rtol=1e-4, atol=1e-6),
    "pdf_portal": dict(rtol=1e-4, atol=1e-6),
    "pdf_projection": dict(rtol=1e-4, atol=1e-6),
}
# A shading point ON a light's own plane (a hit of the emitter) projects
# that light degenerately: whether |p.y − 1.2| passes the 1e-12 guard
# depends on the last bit of p. A few such lanes may differ.
DEGENERATE = {"sample_projection.0": 1e-3, "sample_projection.1": 1e-3,
              "sample_projection.2": 1e-3, "pdf_projection": 1e-3}
_QUAD = [(0, 1, 2), (0, 2, 3)]


def _fill_zoo(b):
    grey = b.add_material(type=0, kd=0.7)
    rough = b.add_material(type=0, kd=(0.5, 0.4, 0.3), sigma=25.0)
    black = b.add_material(type=0, kd=0.0)
    b.add_mesh([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)], _QUAD, mat=grey)
    # back wall with its own (bent) shading normals and uvs
    b.add_mesh([(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], _QUAD,
               mat=rough,
               normals=[(-0.3, 0, -1), (0.3, 0, -1), (0.3, 0.2, -1),
                        (-0.3, 0.2, -1)],
               uvs=[(0, 0), (2, 0), (2, 3), (0, 3)])
    b.add_mesh([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)], _QUAD, mat=grey)
    b.add_sphere((0.35, 0.2, 0.55), 0.2, mat=rough)
    # area lights: a two-sided triangle, a sphere, three portal rects
    tri_l = b.add_light(type="area", L=(5.0, 5.0, 4.0), two_sided=True)
    tid = b.add_triangle((0.6, 0.9, 0.2), (0.9, 0.9, 0.2), (0.75, 0.9, 0.5),
                         mat=black, light=tri_l)
    b.light_rows[tri_l]["prim"] = ("tri", tid)
    sph_l = b.add_light(type="area", L=(8.0, 6.0, 4.0))
    sid = b.add_sphere((0.75, 0.55, 0.7), 0.08, mat=black, light=sph_l)
    b.light_rows[sph_l]["prim"] = ("sph", sid)
    for k, (strategy, x0) in enumerate([("portal", 0.05), ("projection", 0.4),
                                        ("light", 0.7)]):
        portals = [((x0, 1.0, 0.2), (x0 + 0.2, 1.0, 0.5), 1, False)]
        if k == 0:   # two portals on the first light
            portals.append(((x0, 1.0, 0.6), (x0 + 0.2, 1.0, 0.8), 1, False))
        li = b.add_light(type="area", L=(18.0, 15.0, 8.0), strategy=strategy,
                         portals=portals)
        pid = b.add_aaplane((x0 - 0.03, 1.2, 0.15), (x0 + 0.23, 1.2, 0.85),
                            axis=1, facing_fw=False, mat=black, light=li)
        b.light_rows[li]["prim"] = ("pln", pid)
    b.add_light(type="point", I=(0.6, 0.5, 0.4), pos=(0.8, 0.7, 0.3))
    b.add_light(type="spot", I=(2.0, 2.0, 2.5), pos=(0.2, 0.9, 0.2),
                dir=(0.3, -1.0, 0.4), cone_angle=40.0, cone_delta=12.0)
    b.add_light(type="distant", L=(0.8, 0.8, 0.7), dir=(0.2, -1.0, 0.3))


def _inputs():
    """Shading rays, sample values and directions (numpy, seed 5)."""
    o, d, tmax = box_rays(5, n=R)
    rng = np.random.default_rng(6)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)
                      ).astype(np.float32)
    return dict(
        o=o, d=d, tmax=tmax,
        u1=rng.random(R, dtype=np.float32),
        u2=rng.random((R, 2), dtype=np.float32),
        u3=rng.random((R, 2), dtype=np.float32),
        u4=rng.random(R, dtype=np.float32),
        light_idx=rng.integers(0, 8, R).astype(np.int32),
        portal_light=rng.integers(2, 5, R).astype(np.int32),
        w_a=unit(rng.normal(size=(R, 3))), w_b=unit(rng.normal(size=(R, 3))))


def _flat(prefix, obj):
    """Hit / dict / tuple → {name: array}."""
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    else:
        items = ((k, getattr(obj, k)) for k in
                 ("valid", "t", "p", "ng", "ns", "uv", "prim_id", "dpdu",
                  "dpdv"))
    return {f"{prefix}.{k}": v for k, v in items}


def _evaluate(scene, x, isect, lights, mat, portals, common):
    """The functions under test, written once for both packages."""
    out = {}
    # the reference's (t, prim), so both finalize the same hits
    hit = isect.finalize_hit(scene, x["o"], x["d"], x["t"], x["prim"])
    out.update(_flat("hit", hit))
    ls = lights.sample_li(scene, x["light_idx"], hit.p, x["u2"])
    out.update(_flat("sample_li", ls))
    out["pdf_li.sampled"] = lights.pdf_li(scene, x["light_idx"], hit.p,
                                          x["wi_li"])
    out["pdf_li.random"] = lights.pdf_li(scene, x["light_idx"], hit.p,
                                         x["w_a"])
    g = lights.gather_lights(scene.lights, x["portal_light"])
    in_front = portals.portals_in_front(hit.p, g)
    pidx, psel, behind = portals.select_visible_portal(in_front, x["u1"])
    out.update({"portal.in_front": in_front, "portal.idx": pidx,
                "portal.select_pdf": psel, "portal.behind_all": behind})
    ap = lights.gather_area_prim(scene, g.prim_id)
    out.update(_flat("sample_portal",
                     portals.sample_portal(g, pidx, hit.p, x["u2"])))
    out.update(_flat("sample_projection", portals.sample_projection(
        g, pidx, ap.lo, ap.hi, ap.ax, hit.p, x["u2"])))
    out["pdf_portal"] = portals.pdf_portal(g, pidx, hit.p, x["wi_portal"])
    out["pdf_projection"] = portals.pdf_projection(
        g, pidx, ap.lo, ap.hi, ap.ax, hit.p, x["wi_proj"])
    mp = mat.gather_materials(scene.materials, scene.mat_at(hit.prim_id))
    out["mat.sigma"] = mp.sigma
    out["bsdf_f"] = mat.bsdf_f(mp, x["w_a"], x["w_b"])
    out["bsdf_pdf"] = mat.bsdf_pdf(mp, x["w_a"], x["w_b"])
    out.update(_flat("bsdf_sample",
                     mat.bsdf_sample(mp, x["w_a"], x["u1"], x["u3"])))
    for half in (True, False):
        out[f"estimate_direct.half={half}"] = common.estimate_direct(
            scene, hit, mp, -x["d"], x["u1"], x["u2"], x["u3"], x["u4"],
            with_bsdf_half=half)
    return out


@pytest.fixture(scope="module")
def results():
    js = jax_scene(_fill_zoo)
    ts = bridge.scene_from_jax(js)
    assert (ts.n_tri, ts.n_sph, ts.n_pln, ts.lights.n) == (7, 2, 3, 8)
    assert ts.lights.present == (0, 1, 2, 3) and ts.lights.has_portals
    x = _inputs()
    jx = {k: jnp.asarray(v) for k, v in x.items()}

    @jax.jit
    def run_jax(scene, jx):
        h = jisect._intersect_brute(scene, jx["o"], jx["d"], jx["tmax"])
        jx = dict(jx, t=h.t, prim=h.prim_id)
        # directions whose pdf is asked for: the samplers' own outputs
        g = jlights.gather_lights(scene.lights, jx["portal_light"])
        ap = jlights.gather_area_prim(scene, g.prim_id)
        pidx = jportals.select_visible_portal(
            jportals.portals_in_front(h.p, g), jx["u1"])[0]
        jx["wi_li"] = jlights.sample_li(scene, jx["light_idx"], h.p,
                                        jx["u2"])["wi"]
        jx["wi_portal"] = jportals.sample_portal(g, pidx, h.p, jx["u2"])[0]
        jx["wi_proj"] = jportals.sample_projection(
            g, pidx, ap.lo, ap.hi, ap.ax, h.p, jx["u2"])[0]
        extra = {k: jx[k] for k in ("t", "prim", "wi_li", "wi_portal",
                                    "wi_proj")}
        return _evaluate(scene, jx, jisect, jlights, jmat, jportals,
                         jcommon), extra

    want, extra = run_jax(js, jx)
    want = {k: np.asarray(v) for k, v in want.items()}
    tx = {k: torch.as_tensor(np.array(v)) for k, v in
          {**x, **extra}.items()}
    got = _evaluate(ts, tx, tisect, tlights, tmat, tportals, tcommon)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    return got, want, js, ts


def _close(got, want, key, seam=0.0):
    g, w = got[key], want[key]
    assert g.shape == w.shape, key
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        bad = g != w
    else:
        assert np.isfinite(g).all(), key
        bad = ~np.isclose(g, w, **LOOSER.get(key, TOL))
    bad = bad.reshape(bad.shape[0], -1).any(-1)
    seam = max(seam, DEGENERATE.get(key, 0.0))
    assert bad.mean() <= seam, f"{key}: {bad.sum()} lanes differ"


GROUPS = {
    "finalize_hit": ["hit.valid", "hit.t", "hit.p", "hit.ng", "hit.ns",
                     "hit.uv", "hit.prim_id", "hit.dpdu", "hit.dpdv"],
    "sample_li": ["sample_li.wi", "sample_li.li", "sample_li.pdf",
                  "sample_li.p_light", "sample_li.n_light",
                  "sample_li.is_delta"],
    "pdf_li": ["pdf_li.sampled", "pdf_li.random"],
    "portal_selection": ["portal.in_front", "portal.idx",
                         "portal.select_pdf", "portal.behind_all"],
    "sample_portal": ["sample_portal.0", "sample_portal.1",
                      "sample_portal.2", "pdf_portal"],
    "sample_projection": ["sample_projection.0", "sample_projection.1",
                          "sample_projection.2", "pdf_projection"],
    "bsdf": ["mat.sigma", "bsdf_f", "bsdf_pdf", "bsdf_sample.0",
             "bsdf_sample.1", "bsdf_sample.2", "bsdf_sample.3"],
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_module_matches_jax(results, group):
    got, want, _, _ = results
    for key in GROUPS[group]:
        _close(got, want, key)


def test_inputs_reach_every_branch(results):
    """The comparison above means something only if the data goes through
    every family, light type, strategy and both matte models."""
    _, want, _, ts = results
    prim = want["hit.prim_id"]
    for lo, hi in ((0, 7), (7, 9), (9, 12)):        # tri, sph, pln
        assert ((prim >= lo) & (prim < hi)).sum() > 20
    assert (want["mat.sigma"] > 0).sum() > 100      # Oren–Nayar rows
    assert (want["mat.sigma"] == 0).sum() > 100     # Lambert rows
    assert 0.2 < want["sample_li.is_delta"].mean() < 0.6
    for key in ("pdf_li.sampled", "pdf_portal", "pdf_projection",
                "sample_projection.1", "bsdf_pdf"):
        assert (want[key] > 0).mean() > 0.1, key
    assert (want["pdf_li.random"] > 0).sum() > 10
    assert 0 < want["portal.behind_all"].mean() < 0.5 \
        and (want["portal.idx"] == 1).sum() > 100
    assert (want["bsdf_f"].sum(-1) > 0).mean() > 0.3


@pytest.mark.parametrize("half", [True, False], ids=["mis", "light_only"])
def test_estimate_direct_matches_jax(results, half):
    got, want, _, _ = results
    key = f"estimate_direct.half={half}"
    assert (want[key].sum(-1) > 0).mean() > 0.2
    _close(got, want, key, seam=6e-3)
    if half:
        other = want["estimate_direct.half=False"]
        assert not np.allclose(want[key], other)     # the BSDF half counts


def test_light_selection_matches_jax(results):
    """choose_light, uniform and by power (the power distribution's CDF
    over the eight lights)."""
    _, _, js, ts = results
    u = np.random.default_rng(8).random(R, dtype=np.float32)
    np.testing.assert_allclose(ts.lights.power.numpy(),
                               np.asarray(js.lights.power), rtol=1e-6)
    dj = jlights.power_distribution(js.lights)
    dt = tlights.power_distribution(ts.lights)
    np.testing.assert_allclose(dt.cdf.numpy(), np.asarray(dj.cdf), **TOL)
    for pj, pt in ((None, None), (dj, dt)):
        ij, pmf_j = jcommon.choose_light(js, jnp.asarray(u), pj)
        it, pmf_t = tcommon.choose_light(ts, torch.as_tensor(u), pt)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(pmf_t.numpy(), np.asarray(pmf_j), **TOL)
    assert len(np.unique(it.numpy())) >= 6
    assert isinstance(dt, tsampling.Distribution1D)


def test_unported_rows_raise():
    from pbrt_tpu_torch.scene.types import SceneBuilder
    b = SceneBuilder()
    b.add_material(type=0, kd=0.5)
    b.add_sphere((0, 0, 0), 1.0)
    b.add_light(type="infinite", L=1.0)
    assert b.build("cpu").lights.present == (tlights.INFINITE,)
    # hair rows build (item 8c); a textured sigma still raises
    assert SceneBuilder().add_material(type=12) == 0
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        SceneBuilder().add_material(type=0, sigma_tex=0)
    lit_disk = SceneBuilder()      # disks are ported; area lights on them
    lit_disk.add_disk((0, 0, 0), (0, 1, 0), 1.0,
                      light=lit_disk.add_light(type="area", L=1.0, prim=-1))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        lit_disk.build("cpu")
