"""pbrt_tpu_torch/ops/fastgather.py against pbrt_tpu/ops/fastgather.py.

The same seeded numpy inputs go through both: every forward value must be
equal (each is ``table[clip(idx)]``), and every VJP (torch autograd
against ``jax.vjp``) within rtol 1e-5. pbrt_tpu runs eagerly, op by op:
no program is jitted. Cotangents are positive, so no row sum cancels and
rtol bounds the summation order's rounding alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.ops import fastgather as jfg
from pbrt_tpu_torch import entry
from pbrt_tpu_torch.integrators.render import RenderConfig, camera_rays
from pbrt_tpu_torch.ops import fastgather as tfg
from pbrt_tpu_torch.ops import fused_path as tfp
from pbrt_tpu_torch.scene import portals
from pbrt_tpu_torch.scene.film import make_filter

# the select chain (≤ 32), the one-hot product (≤ 512) and the plain take
NS = (5, 32, 33, 256, 513)
R = 257
RTOL = 1e-5
# torch's index backward (index_put_ with accumulate): on the card it folds
# every lane into a few rows serially
INDEX_BACKWARD = {"IndexBackward0", "IndexPutBackward0"}


def _tables(n, rng):
    return {
        "f32_1d": rng.rand(n).astype(np.float32),
        "f32_2d": rng.rand(n, 3).astype(np.float32),
        "f32_3d": rng.rand(n, 4, 3).astype(np.float32),
        "i32": rng.randint(-5, 1 << 20, (n, 2)).astype(np.int32),
        "bool": rng.rand(n, 3) > 0.5,
    }


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _vjp_pair(jfn, tfn, arrays, rng):
    """(jax cotangent results, torch gradients) of jfn / tfn at arrays
    for one seeded positive cotangent of the output."""
    out, pull = jax.vjp(jfn, *(jnp.asarray(a) for a in arrays))
    ct = (0.5 + rng.rand(*out.shape)).astype(np.float32)
    leaves = [_t(a, grad=True) for a in arrays]
    got = tfn(*leaves)
    np.testing.assert_array_equal(_np(got), np.asarray(out))
    got.backward(_t(ct))
    return [np.asarray(x) for x in pull(jnp.asarray(ct))], \
        [x.grad.numpy() for x in leaves]


def test_names_and_constants_match_pbrt_tpu():
    for name in ("gather_rows", "make_row_gather", "gather_tree",
                 "select_component", "select_row", "select_along_last"):
        assert callable(getattr(tfg, name)), name
    assert (tfg.MAX_ONEHOT, tfg.MAX_SELECT, tfg.ONEHOT_BUDGET_BYTES) == (
        jfg.MAX_ONEHOT, jfg.MAX_SELECT, jfg.ONEHOT_BUDGET_BYTES) == (
        512, 32, 128 << 20)


def test_gather_rows_matches_take_all_strategies():
    """tests/test_fastgather.py's first test on the port, also against
    pbrt_tpu's values."""
    rng = np.random.RandomState(0)
    for n in (1, 4, 31, 33, 300, 600):
        idx = rng.randint(-2, n + 2, R).astype(np.int32)
        clipped = np.clip(idx, 0, n - 1)
        for name, tab in _tables(n, rng).items():
            got = _np(tfg.gather_rows(_t(tab), _t(idx)))
            np.testing.assert_array_equal(got, tab[clipped],
                                          err_msg=f"{name} n={n}")
            np.testing.assert_array_equal(
                got, np.asarray(jfg.gather_rows(jnp.asarray(tab),
                                                jnp.asarray(idx))),
                err_msg=f"{name} n={n}")


def test_gather_tree_shares_strategy_and_skips_foreign_leaves():
    rng = np.random.RandomState(1)
    n = 7

    @dataclasses.dataclass
    class T:
        a: torch.Tensor
        b: torch.Tensor
        other: torch.Tensor   # leading dim != n → passes through
        rows: dict
        label: str = "x"

    a = rng.rand(n, 3).astype(np.float32)
    b = rng.randint(0, 9, n).astype(np.int32)
    c = rng.rand(n, 2).astype(np.float32)
    t = T(a=_t(a), b=_t(b), other=torch.arange(5, dtype=torch.float32),
          rows={"c": (_t(c), 3)})
    idx = rng.randint(0, n, 64).astype(np.int32)
    out = tfg.gather_tree(t, _t(idx), n)
    np.testing.assert_array_equal(_np(out.a), a[idx])
    np.testing.assert_array_equal(_np(out.b), b[idx])
    np.testing.assert_array_equal(_np(out.rows["c"][0]), c[idx])
    assert out.rows["c"][1] == 3 and out.label == "x"
    assert out.other is t.other


def test_select_component_and_row():
    """tests/test_fastgather.py's third test on the port, also against
    pbrt_tpu's values."""
    rng = np.random.RandomState(2)
    v = rng.rand(R, 3).astype(np.float32)
    ax = rng.randint(0, 3, R).astype(np.int32)
    want = np.take_along_axis(v, ax[:, None].astype(np.int64), -1)[:, 0]
    for fn in ("select_component", "select_along_last"):
        got = _np(getattr(tfg, fn)(_t(v), _t(ax)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(
            getattr(jfg, fn)(jnp.asarray(v), jnp.asarray(ax))))
    vi = rng.randint(0, 7, (R, 3)).astype(np.int32)
    got_i = tfg.select_component(_t(vi), _t(ax))
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got_i), np.take_along_axis(vi, ax[:, None].astype(np.int64),
                                       -1)[:, 0])
    m = 4
    w = rng.rand(R, m, 2).astype(np.float32)
    wi = rng.randint(0, 3, (R, m)).astype(np.int32)
    sl = rng.randint(0, m, R).astype(np.int32)
    for tab in (w, wi):
        got = _np(tfg.select_row(_t(tab), _t(sl)))
        np.testing.assert_array_equal(got, tab[np.arange(R), sl])
        np.testing.assert_array_equal(got, np.asarray(
            jfg.select_row(jnp.asarray(tab), jnp.asarray(sl))))


def test_make_row_gather_grad():
    """tests/test_fastgather.py's fourth test on the port: the gather is
    differentiable with respect to the table, and its gradient is
    pbrt_tpu's."""
    rng = np.random.RandomState(3)
    n = 4
    tab = rng.rand(n, 3).astype(np.float32)
    idx = rng.randint(0, n, 64).astype(np.int32)

    def f_jax(t):
        return jnp.sum(jfg.make_row_gather(n, jnp.asarray(idx))(t) ** 2)

    leaf = _t(tab, grad=True)
    loss = torch.sum(tfg.make_row_gather(n, _t(idx))(leaf) ** 2)
    assert abs(float(loss.detach()) - float(np.sum(tab[idx] ** 2))) < 1e-4
    loss.backward()
    counts = np.bincount(idx, minlength=n)[:, None]
    np.testing.assert_allclose(leaf.grad.numpy(), 2 * tab * counts,
                               rtol=1e-5)
    np.testing.assert_allclose(leaf.grad.numpy(),
                               np.asarray(jax.grad(f_jax)(jnp.asarray(tab))),
                               rtol=RTOL)


@pytest.mark.parametrize("n", NS)
def test_gather_rows_forward_and_vjp_match_pbrt_tpu(n):
    """Float, int and bool tables, indices out of range on both sides, a
    (R,) and a 2-D index: the forward equals pbrt_tpu's exactly, each
    dtype its own; the float tables' VJPs (gather_rows and
    make_row_gather) are jax.vjp's."""
    rng = np.random.RandomState(10 + n)
    idx = rng.randint(-3, n + 3, R).astype(np.int32)
    idx2 = rng.randint(-3, n + 3, (9, 5)).astype(np.int32)
    for name, tab in _tables(n, rng).items():
        for ix in (idx, idx2):
            got = tfg.gather_rows(_t(tab), _t(ix))
            want = np.asarray(jfg.gather_rows(jnp.asarray(tab),
                                              jnp.asarray(ix)))
            assert got.dtype == _t(tab).dtype, name
            np.testing.assert_array_equal(_np(got), want,
                                          err_msg=f"{name} {ix.shape}")
            np.testing.assert_array_equal(
                _np(tfg.make_row_gather(n, _t(ix))(_t(tab))), want)
        if name.startswith("f32"):
            for ix in (idx, idx2, idx.astype(np.int64)):
                for jfn, tfn in (
                        (lambda t: jfg.gather_rows(t, jnp.asarray(ix)),
                         lambda t: tfg.gather_rows(t, _t(ix))),
                        (lambda t: jfg.make_row_gather(
                            n, jnp.asarray(ix))(t),
                         lambda t: tfg.make_row_gather(n, _t(ix))(t))):
                    (gj,), (gt,) = _vjp_pair(jfn, tfn, [tab], rng)
                    np.testing.assert_allclose(gt, gj, rtol=RTOL,
                                               err_msg=name)


@pytest.mark.parametrize("n", (5, 32))
def test_select_vjp_with_every_lane_on_one_row(n):
    """The masked sums where every lane lands on one row (an in-range one
    and, clipped, one below and one above the table): pbrt_tpu's VJP, the
    other rows exactly zero."""
    rng = np.random.RandomState(7)
    tab = rng.rand(n, 3).astype(np.float32)
    for j in (n // 2, -4, n + 9):
        idx = np.full(R, j, np.int32)
        (gj,), (gt,) = _vjp_pair(
            lambda t: jfg.gather_rows(t, jnp.asarray(idx)),
            lambda t: tfg.gather_rows(t, _t(idx)), [tab], rng)
        np.testing.assert_allclose(gt, gj, rtol=RTOL)
        hit = min(max(j, 0), n - 1)
        assert not np.delete(gt, hit, axis=0).any()


def test_selects_and_tree_vjp_match_pbrt_tpu():
    """select_component, select_along_last, select_row and gather_tree:
    torch autograd against jax.vjp."""
    rng = np.random.RandomState(5)
    v = rng.rand(R, 3).astype(np.float32)
    ax = rng.randint(0, 3, R).astype(np.int32)
    for fn in ("select_component", "select_along_last"):
        (gj,), (gt,) = _vjp_pair(
            lambda x: getattr(jfg, fn)(x, jnp.asarray(ax)),
            lambda x: getattr(tfg, fn)(x, _t(ax)), [v], rng)
        np.testing.assert_allclose(gt, gj, rtol=RTOL, err_msg=fn)
    w = rng.rand(R, 4, 3).astype(np.float32)
    sl = rng.randint(0, 4, R).astype(np.int32)
    (gj,), (gt,) = _vjp_pair(lambda x: jfg.select_row(x, jnp.asarray(sl)),
                             lambda x: tfg.select_row(x, _t(sl)), [w], rng)
    np.testing.assert_allclose(gt, gj, rtol=RTOL)
    n = 40
    a = rng.rand(n, 3).astype(np.float32)
    b = rng.rand(n).astype(np.float32)
    idx = rng.randint(-1, n + 1, R).astype(np.int32)
    def prod(tree):
        return tree["a"] * tree["b"][0][:, None]

    (gja, gjb), (gta, gtb) = _vjp_pair(
        lambda x, y: prod(jfg.gather_tree({"a": x, "b": (y,)},
                                          jnp.asarray(idx), n)),
        lambda x, y: prod(tfg.gather_tree({"a": x, "b": (y,)}, _t(idx), n)),
        [a, b], rng)
    np.testing.assert_allclose(gta, gja, rtol=RTOL)
    np.testing.assert_allclose(gtb, gjb, rtol=RTOL)


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("n", NS)
def test_backward_is_a_reduction(n):
    """A float table of ≤ MAX_SELECT rows gets the module's backward, a
    larger one index_select's (index_add_); no gather leaves torch's
    index backward (index_put_ with accumulate) in the graph."""
    rng = np.random.RandomState(6)
    tab = _t(rng.rand(n, 3).astype(np.float32), grad=True)
    idx = _t(rng.randint(0, n, R).astype(np.int64))
    out = tfg.gather_rows(tab, idx)
    names = _graph_names(out)
    want = "_GatherRowsBackward" if n <= tfg.MAX_SELECT \
        else "IndexSelectBackward0"
    assert want in names, names
    assert not INDEX_BACKWARD & names, names
    with torch.no_grad():
        plain = tfg.gather_rows(tab, idx)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_replay_graph_has_no_index_backward():
    """The main path's replay (ops/fused_path.py) gathers kd[m] by
    fastgather.gather_rows: its graph holds the module's reduction
    backward and no index backward."""
    ts = entry._portal_scene("cpu")
    rays, pid, sidx, _ = camera_rays(
        entry._camera((16, 16), "cpu"), make_filter("box"),
        RenderConfig(max_depth=4), 16, 16, 2, 0, "cpu")
    ax, plf, pof, n_mat, mode = ts.fused_profile
    tri, msc, clu, n_clu = tfp.pack_fused(ts, mode)
    code, knee, kc = tfp.fused_bounce(
        tri, msc, ts.materials.kd, clu, rays.o, rays.d, pid.to(torch.int32),
        sidx.to(torch.int32), n_tri=ts.n_tri, n_b=5, ax=ax, pl_facing=plf,
        portal_facing=pof, n_mat=n_mat, seed=0, rr_threshold=1.0,
        mode=mode, n_clu=n_clu)
    kd = ts.materials.kd.clone().requires_grad_()
    emit = ts.lights.emit[0].clone().requires_grad_()
    names = _graph_names(tfp.replay(kd, emit, code, knee, kc))
    assert "_GatherRowsBackward" in names, names
    assert not INDEX_BACKWARD & names, names


def test_gather_portal_graph_has_no_index_backward():
    """_gather_portal reads each lane's portal slot by
    fastgather.select_row: the rows it returns equal plain indexing's, and
    the graph of portal_lo / portal_hi holds no index backward."""
    rng = np.random.RandomState(0)
    r, p = 64, 3
    rows_type = dataclasses.make_dataclass(
        "Rows", ["portal_lo", "portal_hi", "portal_ax", "portal_facing"])
    lights = rows_type(
        torch.tensor(rng.rand(r, p, 3), dtype=torch.float32,
                     requires_grad=True),
        torch.tensor(rng.rand(r, p, 3), dtype=torch.float32,
                     requires_grad=True),
        torch.tensor(rng.randint(0, 3, (r, p)), dtype=torch.int32),
        torch.tensor(rng.rand(r, p) > 0.5))
    pidx = torch.tensor(rng.randint(0, p, r))
    rows = portals._gather_portal(lights, pidx)
    ar = torch.arange(r)
    for got, table in zip(rows, (lights.portal_lo, lights.portal_hi,
                                 lights.portal_ax, lights.portal_facing)):
        assert torch.equal(got, table[ar, pidx])
    for got in rows[:2]:
        assert not INDEX_BACKWARD & _graph_names(got)
    (rows[0].sum() + 2.0 * rows[1].sum()).backward()
    want = torch.zeros(r, p)
    want[ar, pidx] = 1.0
    assert torch.equal(lights.portal_lo.grad, want[..., None].expand(r, p, 3))
    assert torch.equal(lights.portal_hi.grad, 2.0 * lights.portal_lo.grad)
