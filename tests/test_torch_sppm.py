"""Stochastic progressive photon mapping against pbrt_tpu: the camera
pass's visible points, the grid, the cell capacity, the photons' emission
for each light type and their walk, each (photon, entry) deposit, whole
photon passes and two iterations of ``render_sppm``; ``render``'s
parameters, the CLI, the queries of an iteration, and the caustic file
against the reference binary.

pbrt_tpu's ``render_sppm`` runs op by op (each jnp op on its own, as
pbrt_tpu's eager functions run; jitted, its photon pass would compile for
minutes and XLA would contract its multiply-adds) on
tests/test_torch_bdpt.py's ``area`` scene (a cornell box with a
triangle and a sphere light and a glass sphere, so specular chains lead
to 7% of the pixels' visible points, and escapes through the glass leave
7% without one) at a 32²
film, 1,024 photons an iteration and depth 3. Hooks read its state where
it is made: the visible points, capacity and output of each photon pass
(a wrapper of ``_photon_pass``), each photon bounce's rays, weights and
mask (the frame that calls ``intersect``), and each deposit's inputs and
grid (the frame that calls ``fori_loop``, which the hook runs as a Python
loop). The port runs on those inputs, so each stage is held on identical
inputs.

Tolerances. Integers, masks, the grid and the capacity exact; the visible
points and the photons' rays and weights rtol 2e-5 / atol 1e-6 on all but
at most 2% of the lanes (found: up to 8 of 1,024 visible points, sphere
hits whose point and normal XLA's contracted sphere test moves, ROADMAP
queue 3; 1 of 203 photon directions); each (photon, entry) deposit exact
(the same pairs, the same contributions bit for bit); M exact; phi rtol
1e-5 (the port sums the same contributions in another order; found:
1.8e-7 of the largest entry); the two-iteration image per pixel as the
visible points, with its mean within rel 1e-5 (found: 3 of 1,024 pixels
off, by up to 2.1e-4 relative, the mean equal).
"""

import contextlib
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.frontend import load_pbrt as jload_pbrt
from pbrt_tpu.frontend import parser as jparser
from pbrt_tpu.integrators import common as jcommon
from pbrt_tpu.integrators import sppm as jsppm
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene import materials as jmat
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.frontend import parser as tparser
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.integrators import sppm as tsppm
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene import lights as tlights
from pbrt_tpu_torch.utils import cli, imageio

from test_torch_bdpt import fill_area, fill_delta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "oracle")
CAUSTIC = os.path.join(ORACLE, "caustic_oracle.pbrt")
RES, PHOTONS, DEPTH, SEED, ITERS = 32, 1024, 3, 1, 2
LANES_OFF = 0.02
FIELDS = ("p", "ns", "wo", "beta", "L_direct")


def _caustic_text(res=RES):
    text = open(CAUSTIC).read()
    return text.replace('"integer xresolution" [96] "integer yresolution" '
                        '[96]', f'"integer xresolution" [{res}] '
                        f'"integer yresolution" [{res}]')


def _np(x):
    return np.array(np.asarray(x))


def _t(x):
    return torch.as_tensor(_np(x))


@contextlib.contextmanager
def _hooks(rec):
    """Record pbrt_tpu's photon passes, the state entering each camera and
    photon bounce, and each deposit's inputs, while it runs op by op."""
    inner_isect, inner_pp = jisect.intersect, jsppm._photon_pass

    def isect(*args, **kw):
        frame = sys._getframe(1)
        name = frame.f_code.co_name
        if name in ("_camera_pass", "_photon_pass"):
            loc = frame.f_locals
            rec[name].append({k: _np(loc[k]) if k != "b" else loc[k]
                              for k in ("b", "o_cur", "d_cur", "beta",
                                        "active")})
        return inner_isect(*args, **kw)

    def fori(lo, hi, body, init):
        frame = sys._getframe(1)
        if frame.f_code.co_name == "_photon_pass":
            loc = frame.f_locals
            rec["deposit"].append(dict(
                b=loc["b"], max_per_cell=hi, hit_p=_np(loc["hit"].p),
                **{k: _np(loc[k]) for k in (
                    "d_cur", "beta", "active", "pc", "start",
                    "entry_cell_s", "entry_vp_s", "cell", "res")}))
        for k in range(lo, hi):
            init = body(k, init)
        return init

    def no_jit(fn=None, **kw):
        return fn if fn is not None else (lambda f: f)

    def photon_pass(scene, vps, radius, n_photons, it, seed, max_depth,
                    grid_lo, grid_hi, max_per_cell):
        out = inner_pp(scene, vps, radius, n_photons, it, seed, max_depth,
                       grid_lo, grid_hi, max_per_cell=max_per_cell)
        rec["passes"].append(dict(
            vps={k: _np(v) for k, v in vps.items()}, radius=_np(radius),
            it=int(it), max_per_cell=max_per_cell,
            phi=_np(out[0]), M=_np(out[1]), ovf=float(out[2])))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jisect, "intersect", isect)
        mp.setattr(jax.lax, "fori_loop", fori)
        mp.setattr(jax, "jit", no_jit)
        mp.setattr(jsppm, "_photon_pass", photon_pass)
        yield


def _new_rec():
    return {"_camera_pass": [], "_photon_pass": [], "deposit": [],
            "passes": []}


@pytest.fixture(scope="module")
def ref():
    """pbrt_tpu's two-iteration render_sppm of the area scene, op by op,
    with its recorded state; the same scene and camera carried across."""
    b = JaxBuilder(RGB)
    fill_area(b)
    js = b.build()
    jc = jcam.make_perspective(
        jtransform.look_at((0.5, 0.5, -1.3), (0.5, 0.45, 0.5), (0, 1, 0)),
        40.0, (RES, RES))
    rec = _new_rec()
    with _hooks(rec):
        img = _np(jsppm.render_sppm(js, jc, n_iterations=ITERS,
                                    photons_per_iter=PHOTONS,
                                    max_depth=DEPTH, seed=SEED))
    return dict(rec=rec, img=img, js=js, ts=bridge.scene_from_jax(js),
                tc=bridge.camera_from_jax(jc))


def _vps(rec_pass):
    return {k: _t(v) for k, v in rec_pass["vps"].items()}


def _close_lanes(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    ok = np.isclose(got, want, rtol=2e-5, atol=1e-6)
    ok = ok.reshape(ok.shape[0], -1).all(-1)
    assert (~ok).sum() <= LANES_OFF * ok.size, \
        f"{what}: {(~ok).sum()} of {ok.size} lanes off"


@pytest.mark.parametrize("it", range(ITERS))
def test_camera_pass_visible_points(ref, it):
    """The port's camera pass of each iteration against the visible
    points pbrt_tpu's photon pass received: valid and mat exact, the
    points, normals, directions, weights and direct light lane for
    lane."""
    want = ref["rec"]["passes"][it]["vps"]
    got = tsppm.camera_pass(ref["ts"], ref["tc"], RES, RES, it, SEED, DEPTH,
                            "cpu")
    assert np.array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].mean() > 0.9
    assert np.array_equal(got["mat"].numpy(), want["mat"])
    for k in FIELDS:
        _close_lanes(got[k].numpy(), want[k], k)


def test_grid_and_capacity_exact(ref):
    """Each deposit's grid (cell size, cells an axis, the entries' sorted
    cells and their visible points) and each iteration's host capacity,
    from pbrt_tpu's visible points: exact."""
    rec = ref["rec"]
    ts = ref["ts"]
    assert len(rec["deposit"]) == ITERS * (DEPTH - 1)
    for it, p in enumerate(rec["passes"]):
        vps, radius = _vps(p), _t(p["radius"])
        assert tsppm.needed_capacity(vps, radius, ts.world_lo,
                                     ts.world_hi) == p["max_per_cell"]
        grid = tsppm.build_grid(vps, radius, ts.world_lo, ts.world_hi)
        for dep in rec["deposit"][it * (DEPTH - 1):(it + 1) * (DEPTH - 1)]:
            assert dep["max_per_cell"] == p["max_per_cell"]
            assert float(grid.cell) == float(dep["cell"])
            assert grid.res.tolist() == dep["res"].tolist()
            assert np.array_equal(grid.entry_cell.numpy(),
                                  dep["entry_cell_s"])
            assert np.array_equal(grid.entry_vp.numpy(), dep["entry_vp_s"])
            pc = tsppm.cell_id(_t(dep["hit_p"]), grid)
            assert np.array_equal(pc.numpy(), dep["pc"])


def _port_walk(scene, *args):
    """The port's photon_pass with the state entering each bounce
    recorded (the frame that calls intersect)."""
    walk = []
    inner = tisect.intersect

    def isect(*a, **kw):
        frame = sys._getframe(1)
        if frame.f_code.co_name == "photon_pass":
            loc = frame.f_locals
            walk.append({k: loc[k] if k == "b" else loc[k].numpy()
                         for k in ("b", "o_cur", "d_cur", "beta",
                                   "active")})
        return inner(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tisect, "intersect", isect)
        out = tsppm.photon_pass(scene, *args)
    return out, walk


def _hold_walk(walk, want_walk, what):
    assert [w["b"] for w in walk] == [w["b"] for w in want_walk]
    for got, want in zip(walk, want_walk):
        a, w = got["active"], want["active"]
        assert (a != w).sum() <= LANES_OFF * a.size, what
        both = a & w
        for k in ("o_cur", "d_cur", "beta"):
            _close_lanes(got[k][both], want[k][both],
                         f"{what} bounce {got['b']} {k}")


@pytest.mark.parametrize("it", range(ITERS))
def test_photon_pass(ref, it):
    """The port's photon pass on pbrt_tpu's visible points, radii and
    capacity: the photons' rays, weights and masks entering each bounce
    lane for lane, M exact, phi at rtol 1e-5, the overflow counter 0."""
    p = ref["rec"]["passes"][it]
    ts = ref["ts"]
    (phi, M, ovf), walk = _port_walk(
        ts, _vps(p), _t(p["radius"]), PHOTONS, it, SEED, DEPTH, ts.world_lo,
        ts.world_hi, p["max_per_cell"])
    per = DEPTH
    _hold_walk(walk, ref["rec"]["_photon_pass"][it * per:(it + 1) * per],
               f"iteration {it}")
    assert ovf == 0.0 and p["ovf"] == 0.0
    assert np.array_equal(M.numpy(), p["M"]) and p["M"].sum() > 200
    np.testing.assert_allclose(phi.numpy(), p["phi"], rtol=1e-5, atol=1e-9)


def _jax_pairs(dep, vps, radius, materials):
    """pbrt_tpu's dep_body, slot by slot, op by op over all photons (as it
    runs): {(photon, slot): (visible point, contribution)} of the pairs
    within the radius."""
    out = {}
    e_cell, e_vp = dep["entry_cell_s"], dep["entry_vp_s"]
    pc, start, active = dep["pc"], dep["start"], dep["active"]
    p_v, ns_v, wo_v = (jnp.asarray(vps[k]) for k in ("p", "ns", "wo"))
    hit_p, d_in = jnp.asarray(dep["hit_p"]), jnp.asarray(dep["d_cur"])
    beta, r = jnp.asarray(dep["beta"]), jnp.asarray(radius)
    for k in range(dep["max_per_cell"]):
        e = np.clip(start + k, 0, e_cell.shape[0] - 1)
        vp = e_vp[e]
        d2 = jnp.sum((p_v[vp] - hit_p) ** 2, -1)
        near = _np((e_cell[e] == pc) & active & vps["valid"][vp]
                   & (d2 <= r[vp] ** 2))
        if not near.any():
            continue
        mpv = jmat.gather_materials(materials, jnp.asarray(vps["mat"][vp]))
        t1, t2 = jcommon.make_frame(ns_v[vp])
        wo = jcommon.to_local(t1, t2, ns_v[vp], wo_v[vp])
        wi = jcommon.to_local(t1, t2, ns_v[vp], -d_in)
        contrib = _np(beta * jmat.bsdf_f(mpv, wo, wi))
        for i in np.nonzero(near)[0]:
            out[(int(i), k)] = (int(vp[i]), contrib[i])
    return out


def test_each_deposit_exact(ref):
    """Every (photon, scan slot) deposit of the first iteration's
    bounces: the port's pairs (``deposit_pairs`` on pbrt_tpu's photon
    hits, directions, weights and grid) are pbrt_tpu's, to the visible
    point, with the same contribution bit for bit."""
    rec = ref["rec"]
    p = rec["passes"][0]
    ts = ref["ts"]
    vps, radius = _vps(p), _t(p["radius"])
    grid = tsppm.build_grid(vps, radius, ts.world_lo, ts.world_hi)
    n_pairs = 0
    for dep in rec["deposit"][:DEPTH - 1]:
        want = _jax_pairs(dep, p["vps"], p["radius"], ref["js"].materials)
        start, slots, skipped = tsppm._scan_counts(
            grid, _t(dep["pc"]).long(), _t(dep["active"]),
            dep["max_per_cell"])
        assert int(skipped.sum()) == 0
        ph, k, vp, contrib = tsppm.deposit_pairs(
            ts, vps, radius, grid, _t(dep["hit_p"]), _t(dep["d_cur"]),
            _t(dep["beta"]), start, slots, 0, start.shape[0])
        got = {(int(a), int(b)): (int(v), c) for a, b, v, c in zip(
            ph.tolist(), k.tolist(), vp.tolist(), contrib.numpy())}
        assert got.keys() == want.keys()
        for key, (v, c) in want.items():
            assert got[key][0] == v and np.array_equal(got[key][1], c), key
        n_pairs += len(want)
    assert n_pairs > 100


def test_two_iterations_of_render_sppm(ref):
    """The port's render_sppm (two iterations; the update rule, the
    radius shrinking where photons landed) against pbrt_tpu's image."""
    img = tsppm.render_sppm(ref["ts"], ref["tc"], n_iterations=ITERS,
                            photons_per_iter=PHOTONS, max_depth=DEPTH,
                            seed=SEED, device="cpu").numpy()
    assert img.shape == (RES, RES, 3) and img.mean() > 0
    _close_lanes(img.reshape(-1, 3), ref["img"].reshape(-1, 3), "image")
    assert abs(img.mean() / ref["img"].mean() - 1.0) < 1e-5


def _emission_case(name):
    if name == "infinite":
        js, _, _ = jload_pbrt(os.path.join(ORACLE, "envcavity_oracle.pbrt"))
        return js
    if name == "area":
        js, _, _ = jparser.parse_pbrt_string(_caustic_text().replace(
            'Shape "sphere" "float radius" [0.25]',
            'Shape "sphere" "float radius" [0.25]\nAttributeEnd\n'
            'AttributeBegin\nAreaLightSource "area" "rgb L" [4 4 4]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2]\n'
            '  "point P" [-1 3 -1  1 3 -1  0 3 1]\nAttributeEnd\n'
            'AttributeBegin\nAreaLightSource "area" "rgb L" [2 2 2]\n'
            'Shape "aaplane" "point lo" [-1 5 -1] "point hi" [1 5 1]\n'
            '  "integer axis" [1] "bool facingFw" "false"'), ORACLE)
        return js
    b = JaxBuilder(RGB)
    fill_delta(b, name[-1])
    return b.build()


@pytest.mark.parametrize("name", ["area", "delta_a", "delta_b", "infinite"])
def test_photon_emission_each_light_type(name):
    """The photons as they leave the lights: area lights on a sphere, a
    triangle and an aaplane, point, spot, distant and goniometric lights (delta_a), a
    projection light (delta_b), an infinite light (envcavity): origins,
    directions and weights lane for lane, the mask exact, for each light
    type present."""
    js = _emission_case(name)
    ts = bridge.scene_from_jax(js)
    n = PHOTONS
    vps = {"p": jnp.zeros((1, 3)), "valid": jnp.zeros(1, bool),
           "ns": jnp.zeros((1, 3)), "wo": jnp.zeros((1, 3)),
           "mat": jnp.zeros(1, jnp.int32)}
    rec = _new_rec()
    with _hooks(rec):
        jsppm._photon_pass(js, vps, jnp.ones(1), n, 3, SEED, 1, js.world_lo,
                           js.world_hi, max_per_cell=8)
    want = rec["_photon_pass"][0]
    o, d, beta, active = tsppm.emit_photons(ts, n, 3, SEED, "cpu")
    assert np.array_equal(active.numpy(), want["active"])
    on = want["active"]
    for k, v in (("o_cur", o), ("d_cur", d), ("beta", beta)):
        _close_lanes(v.numpy()[on], want[k][on], f"{name} {k}")
    types = set(ts.lights.ltype.tolist())
    assert {"area": {tlights.AREA}, "delta_a": {
        tlights.POINT, tlights.SPOT, tlights.DISTANT, tlights.GONIO},
        "delta_b": {tlights.PROJECTION, tlights.POINT},
        "infinite": {tlights.INFINITE}}[name] <= types
    # (a spot or map light's photon may carry no weight along its ray)
    assert on.mean() > 0.9 and (beta.numpy()[on] > 0).any(-1).mean() > 0.3


def _capture_sppm_args(monkeypatch):
    got = {}

    def fake(scene, cam, **kw):
        got.update(kw)
        return torch.zeros(cam.resolution[1], cam.resolution[0], 3)
    monkeypatch.setattr(tsppm, "render_sppm", fake)
    return got


@pytest.mark.parametrize("params, want", [
    (None, dict(n_iterations=64, photons_per_iter=64, initial_radius=1.0)),
    (dict(iterations=3, photonsperiteration=100, radius=0.25),
     dict(n_iterations=3, photons_per_iter=100, initial_radius=0.25)),
    (dict(numiterations=5, photonsperiteration=-1),
     dict(n_iterations=5, photons_per_iter=64, initial_radius=1.0))])
def test_render_reads_the_sppm_parameters(monkeypatch, params, want):
    """``render(integrator="sppm")`` reads what pbrt_tpu's dispatch reads:
    iterations (or numiterations, default 64), photonsperiteration (−1,
    the default, means the film's pixel count) and radius (1.0); no
    integrator keyword is left unported."""
    assert trender._UNPORTED_INTEGRATORS == {}
    got = _capture_sppm_args(monkeypatch)
    scene, cam = entry._sphere_cornell("cpu"), entry._camera((8, 8), "cpu")
    trender.render(scene, cam, spp=4, integrator="sppm", max_depth=3,
                   seed=7, integrator_params=params, device="cpu")
    assert got == dict(want, max_depth=3, seed=7, device=torch.device("cpu"))


def test_cli_renders_sppm(tmp_path, capsys):
    """``python -m pbrt_tpu_torch.utils.cli … --integrator sppm`` on a file
    whose Integrator gives the SPPM parameters: the image render_sppm
    gives with them, written."""
    text = _caustic_text(16).replace(
        'Integrator "path" "integer maxdepth" 6',
        'Integrator "sppm" "integer maxdepth" 3 "integer iterations" [2] '
        '"integer photonsperiteration" [1024] "float radius" [0.3]')
    path = tmp_path / "c.pbrt"
    path.write_text(text)
    out = tmp_path / "c.pfm"
    assert cli.main([str(path), "--cpu", "--integrator", "sppm", "-o",
                     str(out)]) == 0
    scene, cam, _ = tparser.load_pbrt(str(path), device="cpu")
    want = tsppm.render_sppm(scene, cam, n_iterations=2,
                             photons_per_iter=1024, initial_radius=0.3,
                             max_depth=3, seed=0, device="cpu").numpy()
    img = imageio.read_pfm(str(out))
    assert np.array_equal(img, want) and img.mean() > 0
    assert '"integrator": "sppm"' in capsys.readouterr().err


@pytest.mark.parametrize("accel", ["brute", "bvh"])
def test_queries_per_iteration(accel):
    """``queries_per_iteration`` counts the closest-hit queries one
    iteration makes (counted here at scene/intersect.py's entry): on the
    sphere cornell (brute force; its area light takes the NEE's BSDF
    half) and on a heightfield with a BVH."""
    if accel == "brute":
        scene = entry._sphere_cornell("cpu")
    else:
        scene = entry._heightfield_cornell("cpu", 8)
        assert scene.bvh is not None
    cam = entry._camera((8, 8), "cpu")
    calls = []
    inner = tisect.intersect

    def count(*a, **kw):
        calls.append(a[1].shape[0])
        return inner(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tisect, "intersect", count)
        tsppm.render_sppm(scene, cam, n_iterations=1, photons_per_iter=256,
                          max_depth=3, device="cpu")
    assert len(calls) == tsppm.queries_per_iteration(3, scene.lights) == 12
    assert calls.count(256) == 3


def test_caustic_sppm_matches_reference_binary():
    """tests/test_oracle.py's call (12 iterations × 65,536 photons, seed 1,
    the file's max depth, pbrt_tpu's default radius) on the port's CPU
    twins, with its limit: md < 0.04 (pbrt_tpu: 0.023)."""
    ref = imageio.read_pfm(os.path.join(ORACLE, "caustic_ref.pfm"))
    scene, cam, opts = tparser.load_pbrt(CAUSTIC, device="cpu")
    img = tsppm.render_sppm(scene, cam, n_iterations=12,
                            photons_per_iter=1 << 16,
                            max_depth=opts["max_depth"], seed=1,
                            device="cpu").numpy()
    ma, mb = float(img.mean()), float(ref.mean())
    md = abs(ma - mb) / max(min(ma, mb), 1e-9)
    assert md < 0.04, f"sppm mean delta {md:.4f} vs reference binary"


def reference_cli_mean():
    """pbrt_tpu's image mean of caustic_oracle.pbrt rendered as the CLI's
    ``--integrator sppm`` renders it: pbrt's defaults (64 iterations of
    the pixel count of photons, radius 1.0), the file's max depth, seed 0,
    pbrt_tpu's jitted render_sppm (about 40 minutes on 8 CPU cores). The
    float64 mean of the float32 image: chip_smoke.py's REF_SPPM_CLI_MEAN."""
    render = importlib.import_module("pbrt_tpu.integrators.render").render
    scene, cam, opts = jload_pbrt(CAUSTIC)
    img = _np(render(scene, cam, spp=1, integrator="sppm",
                     max_depth=opts["max_depth"]))
    ref = imageio.read_pfm(os.path.join(ORACLE, "caustic_ref.pfm"))
    ma, mb = float(img.astype(np.float64).mean()), float(ref.mean())
    return ma, abs(ma - mb) / min(ma, mb)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print("pbrt_tpu's sppm mean at pbrt's defaults, md: %r, %r"
          % reference_cli_mean())
