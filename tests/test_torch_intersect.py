"""The brute-force intersection kernel's plain-torch twin against pbrt_tpu.

The same rays (numpy, seeded) and the same scene (one list of builder
calls, run on both packages' SceneBuilders) go through

- pbrt_tpu's Pallas kernel body ``_intersect_kernel``, wrapped here in
  ``pl.pallas_call(..., interpret=True)`` with the specs of
  ``intersect_pallas._impl``, so it runs on the CPU backend;
- pbrt_tpu's all-pairs ``scene/intersect.py::_intersect_brute``;
- the port's ``ops/intersect.py::intersect_brute`` (on CPU tensors: the
  twin ``_intersect_reference``).

Tolerances: ``prim`` equal on every ray. Against the kernel body, ``t``
is bit-equal on triangle and aaplane hits (the same float32 formulas in
the same order) and within rtol 2e-5 on sphere hits: the quadratic's
discriminant cancels, so a last-bit difference in one product (XLA may
contract a multiply-add on the CPU, torch does not) grows to 1e-5 on
grazing hits. Against the all-pairs brute force, which evaluates the
tests as (R, P) array expressions that XLA fuses its own way, ``t`` is
within rtol 2e-5 throughout.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.ops import intersect_pallas as ip
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene.types import SceneBuilder

R = 4096

# Under pytest-xdist every worker imports this module (the port's tests
# import its helpers), and each worker shares the machine's cores with the
# others: torch's default of one intra-op thread per core then
# oversubscribes them, and every parallel region of a large render waits
# for descheduled threads (a 20 s render was seen taking over 15 minutes).
# So each worker takes its share of the cores.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // _XDIST_WORKERS))


def jax_scene(fill, *args):
    """The scene of ``fill(builder, *args)`` built by pbrt_tpu."""
    b = JaxBuilder(RGB)
    fill(b, *args)
    return b.build()


def pallas_interpret(js, o, d, tmax):
    """pbrt_tpu's kernel body in interpret mode (intersect_pallas.py
    :185-221, with interpret=True)."""
    tri, sph, pln = ip.pack_scene(js)
    n = o.shape[0]
    block = ip.ROWS * ip.LANES
    assert n % block == 0
    comps = [o[:, k].reshape(-1, ip.LANES) for k in range(3)] \
        + [d[:, k].reshape(-1, ip.LANES) for k in range(3)]
    prim_spec = lambda shape: pl.BlockSpec(
        shape, lambda i: (0, 0), memory_space=pltpu.SMEM)
    ray_spec = pl.BlockSpec((ip.ROWS, ip.LANES), lambda i: (i, 0),
                            memory_space=pltpu.VMEM)
    t, prim = pl.pallas_call(
        functools.partial(ip._intersect_kernel, n_tri=js.n_tri,
                          n_sph=js.n_sph, n_pln=js.n_pln),
        grid=(n // block,),
        in_specs=[prim_spec(tri.shape), prim_spec(sph.shape),
                  prim_spec(pln.shape)] + [ray_spec] * 7,
        out_specs=[ray_spec, ray_spec],
        out_shape=[
            jax.ShapeDtypeStruct((n // ip.LANES, ip.LANES), jnp.float32),
            jax.ShapeDtypeStruct((n // ip.LANES, ip.LANES), jnp.int32)],
        interpret=True,
    )(tri, sph, pln, *comps, tmax.reshape(-1, ip.LANES))
    return np.asarray(t).reshape(-1), np.asarray(prim).reshape(-1)


_brute = jax.jit(jisect._intersect_brute)


def box_rays(seed, n=R, finite_tmax=False):
    """Rays from inside the unit box in random directions (numpy)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = (rng.uniform(0.1, 0.8, n).astype(np.float32) if finite_tmax
            else np.full(n, np.inf, np.float32))
    return o, d, tmax


def twin(ts, o, d, tmax):
    tri, sph, pln = ik.pack_scene(ts)
    t, prim = ik.intersect_brute(tri, sph, pln, torch.as_tensor(o),
                                 torch.as_tensor(d), torch.as_tensor(tmax),
                                 ts.n_tri, ts.n_sph, ts.n_pln)
    assert t.dtype == torch.float32 and prim.dtype == torch.int32
    return t.numpy(), prim.numpy()


@pytest.fixture(scope="module")
def scenes():
    js = jax_scene(entry._fill_sphere_cornell)
    ts = entry._sphere_cornell("cpu")
    assert (ts.n_tri, ts.n_sph, ts.n_pln) == (12, 2, 1) \
        == (js.n_tri, js.n_sph, js.n_pln)
    return js, ts


def test_pack_scene_equals_jax(scenes):
    js, ts = scenes
    for got, want in zip(ik.pack_scene(ts), ip.pack_scene(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(ik.pack_scene(bridge.scene_from_jax(js)),
                         ip.pack_scene(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("finite_tmax", [False, True],
                         ids=["tmax_inf", "tmax_finite"])
def test_twin_matches_pallas_kernel_and_brute(scenes, finite_tmax):
    """All three families, against both the interpret-mode kernel body
    and the all-pairs brute force (tolerances in the module docstring)."""
    js, ts = scenes
    o, d, tmax = box_rays(7 + finite_tmax, finite_tmax=finite_tmax)
    t, prim = twin(ts, o, d, tmax)
    t_k, prim_k = pallas_interpret(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax))
    hit_b = _brute(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    np.testing.assert_array_equal(prim, prim_k)
    on_sphere = (prim >= 12) & (prim < 14)
    np.testing.assert_array_equal(t[~on_sphere], t_k[~on_sphere])
    np.testing.assert_allclose(t[on_sphere], t_k[on_sphere], rtol=2e-5)
    np.testing.assert_array_equal(prim, np.asarray(hit_b.prim_id))
    np.testing.assert_allclose(t, np.asarray(hit_b.t), rtol=2e-5)
    # every family is hit, and a finite tmax turns hits into misses
    for lo, hi in ((0, 12), (12, 14), (14, 15)):
        assert ((prim >= lo) & (prim < hi)).any()
    if finite_tmax:
        miss = prim < 0
        assert 0.05 < miss.mean() < 0.95
        np.testing.assert_array_equal(t[miss], tmax[miss])
        assert (t[~miss] < tmax[~miss]).all()
    else:
        assert (prim >= 0).mean() > 0.7      # the box is open in front


def test_rays_that_miss(scenes):
    """Rays leaving from outside the box: prim −1 and t = min(tmax, 1e30),
    as the kernel's initial state."""
    js, ts = scenes
    o, d, tmax = box_rays(3, n=2048)
    o = o + np.float32(5.0) * np.sign(d)
    tmax[::2] = 2.5
    t, prim = twin(ts, o, d, tmax)
    t_k, prim_k = pallas_interpret(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax))
    assert (prim == -1).all() and (prim_k == -1).all()
    np.testing.assert_array_equal(t, np.minimum(tmax, np.float32(1e30)))
    np.testing.assert_array_equal(t, t_k)
    assert (tisect.intersect_p(ts, torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(tmax)) == False).all()  # noqa


def _fill_coplanar(b):
    m = b.add_material(type=0, kd=0.5)
    quad = [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
    b.add_mesh(quad, [(0, 1, 2)], mat=m)
    b.add_mesh(quad, [(0, 1, 2)], mat=m)      # the same triangle again
    b.add_aaplane((0, 0, 1), (1, 1, 1), axis=2, mat=m)   # and its plane


def test_tie_goes_to_the_first_primitive():
    """Two identical triangles and a coplanar aaplane: the strict
    ``t < best_t`` keeps the first in table order."""
    js = jax_scene(_fill_coplanar)
    b = SceneBuilder()
    _fill_coplanar(b)
    ts = b.build("cpu")
    rng = np.random.default_rng(11)
    n = 2048
    o = np.concatenate([rng.uniform(0.05, 0.95, (n, 2)),
                        np.zeros((n, 1))], -1).astype(np.float32)
    d = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    tmax = np.full(n, np.inf, np.float32)
    t, prim = twin(ts, o, d, tmax)
    t_k, prim_k = pallas_interpret(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmax))
    np.testing.assert_array_equal(prim, prim_k)
    np.testing.assert_array_equal(t, t_k)
    in_tri = o[:, 1] < o[:, 0]        # the triangle is the half x > y
    assert set(np.unique(prim)) == {0, 2}
    assert (prim[in_tri & (prim >= 0)] == 0).all()
    assert (prim[~in_tri] == 2).all()
    np.testing.assert_allclose(t, 1.0, rtol=1e-6)


def test_gate_and_devices():
    """The brute-force path has no gate: a scene of 4,097 spheres without
    a BVH (past pbrt_tpu's 4,096 of its Pallas path) is intersected, each
    ray hitting the sphere in front of it; a device that is neither the
    CPU nor a CUDA card raises; on the CPU no kernel is launched."""
    b = SceneBuilder()
    m = b.add_material(type=0, kd=0.5)
    for i in range(4097):
        b.add_sphere((i, 0, 0), 0.25, mat=m)
    big = b.build("cpu")
    assert big.bvh is None and big.n_prims == 4097
    ray = torch.zeros(4, 3)
    x = torch.tensor([0.0, 1.0, 2048.0, 4096.0])
    o = torch.stack([x, torch.zeros(4), torch.full((4,), -1.0)], -1)
    hit = tisect.intersect(big, o, torch.tensor([[0.0, 0.0, 1.0]] * 4),
                           torch.full((4,), np.inf))
    assert hit.prim_id.tolist() == [0, 1, 2048, 4096]
    np.testing.assert_allclose(hit.t.numpy(), 0.75, rtol=1e-6)
    ts = entry._portal_scene("cpu", strategy="portal")
    tabs = ik.pack_scene(ts)
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(NotImplementedError):
        ik.intersect_brute(*tabs, meta, meta, meta[:, 0], ts.n_tri, 0, 1)
    before = ik.intersect_brute.launches
    tisect.intersect(ts, ray + 0.5, ray + 1.0, torch.full((4,), np.inf))
    assert ik.intersect_brute.launches == before
