"""The port's fused path (plain-torch twin of the CUDA kernel + replay)
against pbrt_tpu's Pallas kernel run in interpret mode on the CPU.

Both get the same rays and sample keys (made by pbrt_tpu, handed over as
numpy arrays). Residuals are compared on the lanes whose path is alive
at each bounce (the CUDA kernel writes zeros for ended paths, which
replay maps to the same radiance); radiance on all lanes.

Tolerances:
- portal scene (mode 1, flat sweep): codes identical; knee and kc at
  rtol 1e-5 / atol 1e-6 (float32 rounding of the same formulas in
  another library); L at atol 5e-6, the bound tests/test_fused_path.py
  holds pbrt_tpu's own kernel to;
- mode-0 and clustered scenes: the seam allowance of
  tests/test_fused_path.py:258-261 (fewer than 6e-3 of lanes over 1e-4,
  the rest at atol 1.1e-4, means within 1%), because the two libraries
  order float operations differently and can flip hit ties at
  tessellation seams.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import test_fused_path as ref
from pbrt_tpu.ops import fused_path as jfp
from pbrt_tpu_torch import entry
from pbrt_tpu_torch.integrators.render import RenderConfig, camera_rays
from pbrt_tpu_torch.ops import fused_path as tfp
from pbrt_tpu_torch.scene.film import make_filter

SCENES = {
    "portal": (ge._portal_scene, lambda: entry._portal_scene("cpu"), 16),
    "cornell_mode0": (ref._plain_cornell,
                      lambda: entry._plain_cornell("cpu"), 16),
    # nseg=7: 108 triangles, past the 64 of the cluster gate (4 clusters)
    "tessellated_portal": (lambda: ref._tessellated_portal(nseg=7),
                           lambda: entry._tessellated_portal(7, "cpu"), 16),
}
# pbrt_tpu's replay (what li_path_fused runs after its kernel), compiled
# once for all cases instead of op by op
_jax_replay = jax.jit(jfp.replay)


def _inputs(js, res, max_depth):
    rays, pid, sidx, _, jcfg = ref._rays(js, res=res, chunk=2,
                                         max_depth=max_depth)
    arrs = {k: np.array(v) for k, v in
            dict(o=rays.o, d=rays.d, pid=pid, sidx=sidx).items()}
    return rays, pid, sidx, jcfg, arrs


def _torch_rays(arrs):
    return (torch.as_tensor(arrs["o"]), torch.as_tensor(arrs["d"]),
            torch.as_tensor(arrs["pid"].astype(np.int64)),
            torch.as_tensor(arrs["sidx"].astype(np.int64)))


def _twin(ts, o, d, pid, sidx, max_depth, n_clu=None):
    ax, plf, pof, n_mat, mode = ts.fused_profile
    tri, msc, clu, nc = tfp.pack_fused(ts, mode)
    return tfp.fused_bounce(
        tri, msc, ts.materials.kd, clu, o, d, pid.to(torch.int32),
        sidx.to(torch.int32), n_tri=ts.n_tri, n_b=max_depth + 1, ax=ax,
        pl_facing=plf, portal_facing=pof, n_mat=n_mat, seed=0,
        rr_threshold=1.0, mode=mode, n_clu=nc if n_clu is None else n_clu)


@pytest.fixture(scope="module", params=[(s, md) for s in sorted(SCENES)
                                        for md in (4, 6)],
                ids=lambda p: f"{p[0]}-depth{p[1]}")
def case(request):
    name, max_depth = request.param
    jax_fn, port_fn, res = SCENES[name]
    js, ts = jax_fn(), port_fn()
    rays, pid, sidx, jcfg, arrs = _inputs(js, res, max_depth)
    ax, plf, pof, n_mat, mode = js.fused_profile
    tri, msc, clu, n_clu = jfp.pack_fused(js, mode)
    ref_res = jfp._impl(tri, msc, js.materials.kd, clu, rays.o, rays.d, pid,
                        sidx, n_tri=js.n_tri, n_b=max_depth + 1, ax=ax,
                        pl_facing=plf, portal_facing=pof, n_mat=n_mat,
                        seed=0, rr_threshold=1.0, mode=mode, n_clu=n_clu,
                        interpret=True)
    # li_path_fused is pack_fused + _impl + replay (fused_path.py:728-746):
    # replaying the residuals above gives its radiance without running
    # the interpreter a second time
    L_ref = _jax_replay(js.materials.kd, js.lights.emit[0], *ref_res)
    o, d, tpid, tsidx = _torch_rays(arrs)
    got = _twin(ts, o, d, tpid, tsidx, max_depth)
    L = tfp.li_path_fused(ts, o, d, tpid, tsidx,
                          RenderConfig(max_depth=max_depth))
    return dict(name=name, max_depth=max_depth,
                ref=[np.asarray(x) for x in ref_res],
                got=[x.numpy() for x in got], L_ref=np.asarray(L_ref),
                L=L.numpy(), ts=ts, torch_rays=(o, d, tpid, tsidx))


def _live(code):
    """Lanes whose path is alive entering each bounce."""
    live = np.ones_like(code, dtype=bool)
    live[1:] = (code[:-1] & 8) > 0
    return live


def _seam_allowance(L, L_ref):
    bad = np.abs(L - L_ref).max(-1) > 1e-4
    assert bad.mean() < 6e-3, f"{bad.sum()} mismatched lanes"
    np.testing.assert_allclose(L[~bad], L_ref[~bad], atol=1.1e-4)
    assert abs(L.mean() - L_ref.mean()) / L_ref.mean() < 0.01


def test_twin_residuals_match_pallas_kernel(case):
    (code_r, knee_r, kc_r), (code, knee, kc) = case["ref"], case["got"]
    assert code.shape == code_r.shape == (case["max_depth"] + 1,
                                          code.shape[1])
    assert code.dtype == np.int32 and knee.dtype == np.float32
    live = _live(code_r)
    if case["name"] == "portal":
        np.testing.assert_array_equal(code[live], code_r[live])
        np.testing.assert_allclose(knee[live], knee_r[live], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(kc[live], kc_r[live], rtol=1e-5,
                                   atol=1e-6)
    else:
        same = code[live] == code_r[live]
        assert same.mean() > 1 - 6e-3, f"{(~same).sum()} code mismatches"
    if case["max_depth"] == 6:
        # russian roulette ran (b = 4, 5) and killed or rescaled paths
        assert ((code_r[4:6] & 16) > 0).any()


def test_twin_radiance_matches_li_path_fused(case):
    L, L_ref = case["L"], case["L_ref"]
    assert L.shape == L_ref.shape and np.isfinite(L).all()
    assert L_ref.mean() > 0.01
    if case["name"] == "portal":
        np.testing.assert_allclose(L, L_ref, atol=5e-6)
    else:
        _seam_allowance(L, L_ref)


def test_replay_of_zeroed_dead_lanes_is_unchanged(case):
    """The CUDA kernel writes code = knee = kc = 0 once a lane's path has
    ended; replay must give the same L from those residuals."""
    code, knee, kc = (torch.as_tensor(x) for x in case["got"])
    live = torch.as_tensor(_live(case["got"][0]))
    zeroed = [torch.where(live, x, torch.zeros_like(x))
              for x in (code, knee, kc)]
    ts = case["ts"]
    args = (ts.materials.kd, ts.lights.emit[0])
    L_full = tfp.replay(*args, code, knee, kc)
    L_zero = tfp.replay(*args, *zeroed)
    assert torch.equal(L_full, L_zero)


def test_culled_sweep_equals_flat_sweep():
    """Cluster culling is conservative: with n_clu forced to 0 the flat
    sweep gives bit-identical residuals (diff == 0.0)."""
    ts = entry._tessellated_portal(7, "cpu")
    rays, pid, sidx, _ = camera_rays(
        entry._camera((16, 16), "cpu"), make_filter("box"),
        RenderConfig(max_depth=4), 16, 16, 2, 0, "cpu")
    o, d = rays.o, rays.d
    culled = _twin(ts, o, d, pid, sidx, 4)
    flat = _twin(ts, o, d, pid, sidx, 4, n_clu=0)
    assert tfp.pack_fused(ts, 1)[3] > 0
    for c, f in zip(culled, flat):
        assert torch.equal(c, f)


def test_replay_gradients_match_jax_grad():
    """∂mean(L)/∂(kd, emit) from torch autograd through replay equals
    jax.grad of pbrt_tpu's li_path_fused (interpret mode); tolerances of
    tests/test_fused_path.py:89-93."""
    js = ge._portal_scene()
    ts = entry._portal_scene("cpu")
    rays, pid, sidx, jcfg, arrs = _inputs(js, 16, 4)

    def loss_jax(kd, emit):
        s = dc.replace(js, materials=dc.replace(js.materials, kd=kd),
                       lights=dc.replace(js.lights, emit=emit))
        return jnp.mean(jfp.li_path_fused(s, rays.o, rays.d, pid, sidx,
                                          jcfg, interpret=True))

    v1, (g_kd, g_emit) = jax.value_and_grad(loss_jax, argnums=(0, 1))(
        js.materials.kd, js.lights.emit)

    kd = ts.materials.kd.clone().requires_grad_()
    emit = ts.lights.emit.clone().requires_grad_()
    s = dc.replace(ts, materials=dc.replace(ts.materials, kd=kd),
                   lights=dc.replace(ts.lights, emit=emit))
    loss = tfp.li_path_fused(s, *_torch_rays(arrs),
                             RenderConfig(max_depth=4)).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(v1),
                               rtol=1e-6)
    np.testing.assert_allclose(kd.grad.numpy(), np.asarray(g_kd), atol=1e-7)
    np.testing.assert_allclose(emit.grad.numpy(), np.asarray(g_emit),
                               atol=1e-8)
    assert np.abs(kd.grad.numpy()).max() > 1e-3


def test_fused_bounce_rejects_other_devices():
    ts = entry._portal_scene("cpu")
    o = torch.zeros(4, 3, device="meta")
    with pytest.raises(NotImplementedError):
        _twin(ts, o, o, torch.zeros(4, dtype=torch.int32, device="meta"),
              torch.zeros(4, dtype=torch.int32, device="meta"), 2)
