"""The sharded render and the training step over torch.distributed
against single-process renders and pbrt_tpu (tests/test_parallel.py's
cases).

Two gloo process groups run at once, one of 2 and one of 4 CPU
processes (tests/torch_parallel_worker.py, spawned as
tests/test_parallel.py spawns its workers), each rank writing what it
got; this file holds it against

- the port's single-process ``render`` at the same ``spp_eff`` (the same
  sample indices): the (2,1), (1,2), (2,2) and (4,1) meshes of the box
  scene, 5 spp over 19 rows on (2,2) (spp_eff 6, the rows padded to 20),
  with tests/test_parallel.py's rtol 2e-3 / atol 3e-4; `volpath` in a
  homogeneous and a grid medium, `hero_path_mis` in 60 bins and the
  spatial light strategy on (2,2) with its rtol 5e-3 / atol 5e-4 (the
  spatial image differs from the uniform one);
- pbrt_tpu's ``render_sharded`` of the box on its 8-device CPU mesh, the
  same tolerance;
- the step's gradients (8², 4 spp, depth 2, lr 0.5, target 0) against
  the port's single-process autograd and pbrt_tpu's
  ``inverse_render_step`` on its 8-device mesh: loss rtol 1e-4, gradients
  rtol 2e-3 / atol 1e-6 (tests/test_parallel.py's);
- the cached step (one object per mesh and config; the loss falls over
  two steps), every rank holding the same image and parameters, the
  idempotent ``initialize_multihost``, the meshes' shapes
  (``make_mesh``'s factorisation is pbrt_tpu's; the multi-host mesh is
  dp = the processes), ``process_local_rows`` and ``dryrun_multichip(2)``.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from pbrt_tpu.parallel import multihost as jmultihost
from pbrt_tpu.parallel import render as jprender
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.parallel import multihost, render as prender

import torch_parallel_worker as worker
from test_parallel import _cam as jcam
from test_parallel import _scene as jscene

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=2e-3, atol=3e-4)
TOL_MEDIA = dict(rtol=5e-3, atol=5e-4)
CASES = {name: (world, shape, kind, res, kw)
         for world, rows in worker.RENDERS.items()
         for name, shape, kind, res, kw in rows}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [each rank's npz]} from one group of 2 and one of 4
    processes, run at once."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    procs, dirs = [], {}
    for world in (2, 4):
        dirs[world] = tmp_path_factory.mktemp(f"world{world}")
        port = str(_free_port())
        procs += [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
             str(r), str(world), port, str(dirs[world])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    return {world: [dict(np.load(dirs[world] / f"rank{r}.npz"))
                    for r in range(world)] for world in (2, 4)}


def _single(name):
    """The port's single-process render of a case at its spp_eff."""
    _, shape, kind, res, kw = CASES[name]
    kw = dict(kw)
    spp = kw.pop("spp")
    dp = shape[0]
    return trender.render(worker.scene(kind), worker.cam(res),
                          spp=-(-spp // dp) * dp, device="cpu",
                          **kw).numpy()


@pytest.mark.parametrize("name", ["dp2", "sp2", "dp2sp2", "nondiv", "dp4"])
def test_sharded_equals_single_process(runs, name):
    world = CASES[name][0]
    img = runs[world][0][f"img_{name}"]
    ref = _single(name)
    assert img.shape == ref.shape and ref.mean() > 1e-3
    np.testing.assert_allclose(img, ref, err_msg=name, **TOL)
    for r in range(1, world):                    # every rank holds it
        np.testing.assert_array_equal(runs[world][r][f"img_{name}"], img)


@pytest.mark.parametrize("name", ["volpath", "hero", "grid", "spatial"])
def test_integrators_through_the_sharded_path(runs, name):
    img = runs[4][0][f"img_{name}"]
    ref = _single(name)
    assert img.shape == ref.shape and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, err_msg=name, **TOL_MEDIA)
    if name == "hero":
        assert img.shape[-1] == 60
    if name == "spatial":                        # the grid is live
        assert np.abs(runs[4][0]["img_uniform"] - img).max() > 1e-5


def _jax_mesh():
    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    return JaxMesh(devs, ("dp", "sp"))


def test_sharded_equals_pbrt_tpus(runs):
    want = np.asarray(jprender.render_sharded(
        jscene(), jcam(), _jax_mesh(), spp=8, integrator="path",
        max_depth=2))
    np.testing.assert_allclose(runs[4][0]["img_dp2sp2"], want, **TOL)
    np.testing.assert_allclose(runs[2][0]["img_sp2"], want, **TOL)


@pytest.fixture(scope="module")
def step_refs():
    """(loss, grads) of the port's single-process autograd and of
    pbrt_tpu's ``inverse_render_step`` on its 8-device mesh."""
    s, c = worker.scene(), worker.cam((8, 8))
    leaves = {"kd": s.materials.kd.clone().requires_grad_(),
              "emit": s.lights.emit.clone().requires_grad_()}
    img = trender.render(prender._set_params(s, leaves), c, spp=4,
                         max_depth=2, seed=0, device="cpu")
    loss = (img ** 2).mean()
    loss.backward()
    single = (float(loss.detach()),
              {k: v.grad.numpy() for k, v in leaves.items()})
    js, jc = jscene(), jcam((8, 8))
    params = {"kd": js.materials.kd, "emit": js.lights.emit}
    new, jloss = jprender.inverse_render_step(
        js, jc, _jax_mesh(), jnp.zeros((8, 8, 3)), params, lr=0.5, spp=4,
        max_depth=2, seed=0)
    theirs = (float(jloss), {k: (np.asarray(params[k])
                                 - np.asarray(new[k])) / 0.5
                             for k in params})
    return single, theirs


@pytest.mark.parametrize("ref", ["single_process", "pbrt_tpu"])
def test_step_gradients(runs, step_refs, ref):
    loss_ref, g_ref = step_refs[ref == "pbrt_tpu"]
    s = worker.scene()
    got = runs[4][0]
    np.testing.assert_allclose(got["step_loss"], loss_ref, rtol=1e-4)
    for k, p0 in (("kd", s.materials.kd), ("emit", s.lights.emit)):
        g = (p0.numpy() - got[f"step_{k}"]) / 0.5
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(g, g_ref[k], rtol=2e-3, atol=1e-6,
                                   err_msg=k)
        for r in range(1, 4):
            np.testing.assert_array_equal(runs[4][r][f"step_{k}"],
                                          got[f"step_{k}"])


def test_cached_step_descends(runs):
    for rank in runs[4]:
        assert bool(rank["cached"])
        l1, l2 = rank["cached_losses"]
        assert np.isfinite(l1) and np.isfinite(l2) and l2 < l1


def test_groups_meshes_and_dryrun(runs):
    """Each rank saw its world size (again on a second call); make_mesh's
    default shape is pbrt_tpu's factorisation, the multi-host mesh is
    dp = the processes; dryrun_multichip(2) finished with a finite loss
    and a moved kd."""
    for world, ranks in runs.items():
        for rank in ranks:
            assert int(rank["world"]) == int(rank["again"]) == world
            np.testing.assert_array_equal(
                rank["default_shape"],
                [prender.mesh_shape(world)["dp"],
                 prender.mesh_shape(world)["sp"]])
            np.testing.assert_array_equal(rank["multihost_shape"],
                                          [world, 1])
        loss, dkd, mean = ranks[0]["dryrun"] if world == 2 else (1, 1, 1)
        assert np.isfinite(loss) and dkd > 0 and mean > 0


def test_mesh_shapes_and_local_rows_match_pbrt_tpu():
    for n in (1, 2, 4, 6, 8):
        m = jprender.make_mesh(n)
        assert prender.mesh_shape(n) == {"dp": m.shape["dp"],
                                         "sp": m.shape["sp"]}
    assert prender.mesh_shape(4, axes=("dp",)) == {"dp": 4}
    for h, j, n in ((100, 0, 8), (100, 7, 8), (19, 1, 2), (16, 3, 4)):
        assert (multihost.process_local_rows(h, j, n)
                == jmultihost.process_local_rows(h, j, n))
