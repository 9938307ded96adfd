"""The port's SceneBuilder against pbrt_tpu's, field by field.

Each scene is built twice from the same calls: once by pbrt_tpu (and
carried over with ``bridge.scene_from_jax``) and once by the port's own
builder, which needs no JAX. Geometry, material, light and bound tables,
the fused profile and the fused kernel's packed tables must agree.
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import test_fused_path as ref_scenes
from pbrt_tpu.ops import fused_path as jfp
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.ops import fused_path as tfp
from pbrt_tpu_torch.scene.types import SceneBuilder

SCENES = {
    "portal": (ge._portal_scene, lambda: entry._portal_scene("cpu")),
    "cornell_mode0": (ref_scenes._plain_cornell,
                      lambda: entry._plain_cornell("cpu")),
    "tessellated_portal": (lambda: ref_scenes._tessellated_portal(nseg=13),
                           lambda: entry._tessellated_portal(13, "cpu")),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_pair(request):
    jax_fn, port_fn = SCENES[request.param]
    js = jax_fn()
    return request.param, js, bridge.scene_from_jax(js), port_fn()


def _fields(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def test_scene_tables_equal_jax_build(scene_pair):
    name, _, bridged, built = scene_pair
    got = dict(_fields(built))
    for key, want in _fields(bridged):
        if key == "bvh.built_by":
            continue    # who built it
        have = got[key]
        if isinstance(want, torch.Tensor):
            assert have.dtype == want.dtype, key
            if have.dtype == torch.float32:
                # bit for bit: an empty slot of a 4-wide record holds −1,
                # whose bits are a NaN
                have, want = (x.contiguous().view(torch.int32)
                              for x in (have, want))
            assert torch.equal(have, want), key
        else:
            assert have == want, key
    # pbrt_tpu's rule: a BVH for more than 256 triangles, and then the
    # port's native build gives pbrt_tpu's tree (compared field by field
    # above, through the bridge)
    assert (built.bvh is not None) == (built.n_tri > 256) \
        == ("bvh.lo" in got)


def test_fused_profile_and_counts(scene_pair):
    name, js, _, built = scene_pair
    assert built.fused_profile == js.fused_profile is not None
    assert built.n_tri == js.n_tri
    if name == "portal":
        assert built.n_tri == 26 and built.fused_profile[4] == 1
    if name == "cornell_mode0":
        assert built.fused_profile[4] == 0
    if name == "tessellated_portal":
        assert built.n_tri > 255 and built.fused_profile[4] == 1


def test_pack_fused_tables_equal_jax(scene_pair):
    _, js, _, built = scene_pair
    mode = js.fused_profile[4]
    tri_j, msc_j, clu_j, nclu_j = jfp.pack_fused(js, mode)
    tri_t, msc_t, clu_t, nclu_t = tfp.pack_fused(built, mode)
    assert nclu_t == nclu_j
    assert nclu_t == (-(-js.n_tri // 32) if js.n_tri > 64 else 0)
    np.testing.assert_array_equal(msc_t.numpy(), np.asarray(msc_j))
    tri_j = np.asarray(tri_j)
    assert tri_t.shape == tri_j.shape
    # vertices, edges, material rows and pad rows are exact; the unit
    # normal goes through rsqrt (float32 rounding, 1e-7)
    cols = list(range(9)) + list(range(12, 16))
    np.testing.assert_array_equal(tri_t.numpy()[:, cols], tri_j[:, cols])
    np.testing.assert_allclose(tri_t.numpy()[:, 9:12], tri_j[:, 9:12],
                               atol=1e-7)
    np.testing.assert_allclose(clu_t.numpy(), np.asarray(clu_j), atol=1e-7,
                               rtol=0)


def test_cluster_boundary_keeps_jax_gate():
    """At or below 64 triangles the flat sweep runs (no cluster table);
    one more triangle switches to culling, as pbrt_tpu's ``nt > 64``."""
    for n_strips, want_clu in ((32, 0), (33, 3)):
        b = SceneBuilder()
        m = b.add_material(type=0, kd=0.5)
        for i in range(n_strips):
            x0, x1 = i / n_strips, (i + 1) / n_strips
            b.add_mesh([(x0, 0, 0), (x1, 0, 0), (x1, 0, 1), (x0, 0, 1)],
                       [(0, 1, 2), (0, 2, 3)], mat=m)
        li = b.add_light(type="area", L=5.0, prim=-1)
        p = b.add_aaplane((0.3, 1, 0.3), (0.7, 1, 0.7), axis=1,
                          facing_fw=False, mat=m, light=li)
        b.light_rows[li]["prim"] = b.prim_index("pln", p)
        scene = b.build("cpu")
        assert scene.fused_profile is not None
        tri_tab, _, clu, n_clu = tfp.pack_fused(scene, 0)
        assert n_clu == want_clu
        assert tri_tab.shape[0] == (n_clu * 32 if n_clu else 2 * n_strips)


def test_non_matte_scene_gets_no_profile_or_raises(monkeypatch):
    """pbrt_tpu's rejection case (tests/test_fused_path.py:108-125): an
    area light on a disk cannot be built; a plastic row, a sphere, a disk,
    or an Oren–Nayar (sigma > 0) matte row, builds but gets no fused
    profile, and `path` then renders it through the generic wavefront
    loop, never through the fused kernel."""
    b = SceneBuilder()
    m = b.add_material(type=0, kd=(0.5, 0.5, 0.5))
    portal = SceneBuilder()
    entry._fill_portal_scene(portal)
    assert portal.build("cpu").fused_profile is not None
    glossy = SceneBuilder()
    entry._fill_portal_scene(glossy)
    glossy.tris[0]["mat"] = glossy.add_material(type=3, kd=0.5, ks=0.2)
    assert glossy.build("cpu").fused_profile is None
    portal.add_disk((0.5, 0.5, 0.5), (0, 1, 0), 0.2, mat=0)
    with_disk = portal.build("cpu")
    assert with_disk.n_dsk == 1 and with_disk.fused_profile is None
    lit = portal.add_light(type="area", L=1.0, prim=-1)
    portal.add_disk((0.5, 0.5, 0.5), (0, -1, 0), 0.1, mat=0, light=lit)
    with pytest.raises(NotImplementedError, match="disks"):
        portal.build("cpu")
    rough = b.add_material(type=0, kd=0.5, sigma=20.0)
    b.add_mesh([(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
               [(0, 1, 2), (0, 2, 3)], mat=rough)
    li = b.add_light(type="area", L=(5.0, 5.0, 5.0), prim=-1,
                     strategy="projection", two_sided=False,
                     portals=[((0.3, 1.0, 0.3), (0.7, 1.0, 0.7), 1, False)])
    p = b.add_aaplane((0.3, 1.2, 0.3), (0.7, 1.2, 0.7), axis=1,
                      facing_fw=False, mat=m, light=li)
    b.light_rows[li]["prim"] = b.prim_index("pln", p)
    scene = b.build("cpu")
    assert scene.fused_profile is None
    b.add_sphere((0.5, 0.5, 0.5), 0.2, mat=m)
    with_sphere = b.build("cpu")
    assert with_sphere.n_sph == 1 and with_sphere.fused_profile is None
    from pbrt_tpu_torch.integrators.render import render
    from pbrt_tpu_torch.ops import intersect as ik
    calls = []
    monkeypatch.setattr(tfp, "fused_bounce",
                        lambda *a, **k: calls.append(1))
    img = render(with_sphere, entry._camera((4, 4), "cpu"), spp=1,
                 max_depth=2, device="cpu")
    assert not calls and ik.intersect_brute.launches == 0   # CPU: the twin
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())


def test_bridge_carries_curves_and_hair_rows():
    """Disks, curves (after the disks in the prim index space, no light
    rows, the bound padded by the widest width, crv_n None without a
    ribbon) and hair rows carry over, and equal the port's own build of
    the same rows."""
    from pbrt_tpu.core.spectrum import RGB
    from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
    cp = np.float32([[0, 0, 0], [0.2, 0.5, 0], [0.4, 0.6, 0.2],
                     [0.5, 1, 0.3]])
    builders = (JaxBuilder(RGB), SceneBuilder())
    for b in builders:
        m = b.add_material(type=0, kd=0.5)
        hair = b.add_material(type=12, sss_sigma_a=(0.5, 0.7, 1.4),
                              beta_m=0.2, eta=1.55)
        b.add_sphere((0.5, 0.5, 0.5), 0.2, mat=m)
        b.add_disk((0.5, 0.5, 0.5), (0, 1, 0), 0.2, mat=m)
        b.add_curve(cp, 0.05, 0.01, mat=hair)
        b.add_curve(cp + 1, 0.02, 0.02, mat=m)
    js = builders[0].build()
    ts = bridge.scene_from_jax(js)
    own = builders[1].build("cpu")
    assert (ts.n_dsk, ts.n_crv, ts.n_base_prims) == (1, 2, 4)
    assert ts.geom.crv_n is None and own.geom.crv_n is None
    for k in ("crv_cp", "crv_w"):
        assert torch.equal(getattr(ts.geom, k), getattr(own.geom, k)), k
    for k in ("prim_mat", "prim_light", "prim_med_in", "world_lo",
              "world_hi"):
        assert torch.equal(getattr(ts, k), getattr(own, k)), k
    assert ts.prim_light.tolist() == [-1, -1, -1, -1]
    assert ts.prim_mat.tolist() == [0, 0, 1, 0]
    for k in ("mtype", "sss_sigma_a", "beta_m", "beta_n", "hair_alpha",
              "eta", "fourier_id"):
        assert torch.equal(getattr(ts.materials, k),
                           getattr(own.materials, k)), k
    assert ts.materials.has_hair and own.materials.has_hair
    assert not ts.materials.has_fourier and ts.fourier == ()
    assert ts.fused_profile is None and own.fused_profile is None


def test_scene_to_device_keeps_values():
    from pbrt_tpu_torch.scene.types import to_device
    s = entry._portal_scene("cpu")
    moved = to_device(s, torch.device("cpu"))
    assert moved.fused_profile == s.fused_profile
    assert torch.equal(moved.geom.tri_v0, s.geom.tri_v0)
