"""The port's kernel-experiment harness (pbrt_tpu_torch/tools/kexp_*)
against pbrt_tpu's (tools/kexp_*.py).

The same tree (a 500-triangle soup built by pbrt_tpu, carried across as
numpy arrays) and the same 1,024 seeded rays (one packet at ``rows=8``) go
through

- pbrt_tpu's packers ``tools.kexp_kernels.pack_params`` / ``pack_dual_leaf``
  and the port's: every returned array and the ``pp`` dict equal, exactly;
- pbrt_tpu's experimental Pallas kernel in interpret mode
  (``tools.kexp_kernels.traverse(..., interpret=True)``, the bounds table
  passed as the packer returns it) and the port's plain-torch twin
  ``_traverse_wide_reference``, for variants 1, 2, 3, the wide-8 packing,
  the dual-leaf variant 5, any-hit and count mode (seven Pallas programs);
- the port's binary traversal twin ``ops/bvh_binary.py::_traverse_reference``.

Tolerances. Against the Pallas kernel: hit masks equal, ``t`` of the hits
to rtol 1e-5 (XLA on the CPU contracts multiply-adds in the triangle test;
found 9.5e-7 absolute), the leaf-ordered index equal except where ``t``
ties (rtol 1e-5, atol 1e-6): the packet kernel orders a node's children by
the packet's majority direction, the twin by the ray's own. Against the
binary twin: ``t`` bit-equal on every ray (the same triangle through the
same formula), index equal except at exact ties. Count mode: a packet of
1,024 copies of one ray is a per-ray walk, so its step code equals the
twin's for that ray exactly. The CUDA kernels themselves run only on the
card, where chip_smoke.py holds them against these twins.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.kexp_kernels as jkk
from pbrt_tpu.ops import bvh_pallas as bp
from pbrt_tpu.scene import bvh as jbvh
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.ops import bvh as bvh_ops
from pbrt_tpu_torch.ops import bvh_binary
from pbrt_tpu_torch.tools import kexp_kernels as kk
from pbrt_tpu_torch.tools import kexp_prep, kexp_run
from test_torch_bvh import _assert_matches, _soup_rays
from tests.test_bvh_io import random_tri_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 1024
TREE = ("lo", "hi", "right", "count", "axis", "v0", "v1", "v2")
# name -> (wide, leaf_max, dual, variant, any_hit)
CONFIGS = {"v1": (4, 16, False, 1, False), "v2": (4, 16, False, 2, False),
           "v3": (4, 16, False, 3, False), "wide8": (8, 8, False, 2, False),
           "dual": (4, 16, True, 5, False), "v2_any": (4, 16, False, 2, True)}


@pytest.fixture(scope="module")
def soup():
    """pbrt_tpu's tree over a 500-triangle soup, its arrays as numpy, and
    the same tree as the port's FlatBVH."""
    jb = jbvh.build_bvh(None, random_tri_scene(500, seed=0))
    return jb, [np.asarray(getattr(jb, k)) for k in TREE], \
        bridge.bvh_from_jax(jb)


def _packed(tree, wide, leaf_max, dual, mod):
    """(meta, nbs, blocks, pp) of packer module ``mod``."""
    if dual:
        return (*mod.pack_dual_leaf(*tree, leaf_max=leaf_max),
                dict(jkk.DEFAULT_PP))
    return mod.pack_params(*tree, wide=wide, leaf_max=leaf_max)


def _layout(tree, wide, leaf_max, dual):
    *tabs, pp = _packed(tree, wide, leaf_max, dual, kk)
    return kk.make_layout(*tabs, pp, dual=dual)


def _twin(layout, o, d, tmax, any_hit, variant, stats=None):
    t, i = kk._traverse_wide_reference(
        layout, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax),
        any_hit=any_hit, variant=variant, stats=stats)
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    return t.numpy(), i.numpy()


def _pallas(tree, wide, leaf_max, dual, o, d, tmax, any_hit, variant):
    meta, nbs, blocks, pp = _packed(tree, wide, leaf_max, dual, jkk)
    t, i = jkk.traverse(meta, nbs, blocks, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(tmax), any_hit=any_hit, variant=variant,
                        interpret=True, rows=8, pp=tuple(sorted(pp.items())))
    return np.asarray(t), np.asarray(i)


# -- (a) the packers ---------------------------------------------------------

@pytest.mark.parametrize("max_leaf", [16, 8, 4])
def test_collapse_tree_equals_jax(soup, max_leaf):
    tree = soup[1]
    args = (tree[0], tree[1], tree[2].astype(np.int64),
            tree[3].astype(np.int64), tree[4].astype(np.int64))
    want = bp._collapse_tree(*args, max_leaf=max_leaf)
    got = bvh_ops._collapse_tree(*args, max_leaf=max_leaf)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3].max() <= max_leaf and got[3].sum() == tree[5].shape[0]
    if max_leaf > 4:       # the BVH build's own leaves hold up to 4
        assert (got[3] > 0).sum() < (tree[3] > 0).sum()


def _assert_same_tables(got, want):
    for g, w, name in zip(got[:3], want[:3], ("meta", "nbs", "blocks")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("wide,leaf_max", [(4, 16), (8, 8), (4, 8)])
def test_pack_params_equals_jax(soup, wide, leaf_max):
    jb, tree, _ = soup
    got = kk.pack_params(*tree, wide=wide, leaf_max=leaf_max)
    want = jkk.pack_params(*tree, wide=wide, leaf_max=leaf_max)
    _assert_same_tables(got, want)
    assert got[3] == want[3]
    assert got[0].shape[0] == wide + 1 and got[1].shape[0] == 6 * wide
    if (wide, leaf_max) == (4, 16):
        # the default packing is pbrt_tpu's production layout, as it is
        _assert_same_tables(got, (np.asarray(jb.pk_meta), np.asarray(jb.pk_nb),
                                  np.asarray(jb.pk_tri)))
        assert got[3] == jkk.DEFAULT_PP == kk.DUAL_PP


def test_pack_dual_leaf_equals_jax(soup):
    tree = soup[1]
    got = kk.pack_dual_leaf(*tree)
    _assert_same_tables(got, jkk.pack_dual_leaf(*tree))
    assert len(got) == 3 and got[2].shape[1] == 128
    # fewer rows than two per leaf: small leaves take one
    assert got[2].shape[0] < kk.pack_params(*tree)[2].shape[0]


def test_layout_holds_the_packers_numbers(soup):
    """Breadth-first records: child bounds, re-targeted encodings and the
    axis; the 48-byte triangle records repeat the leaf rows."""
    tree = soup[1]
    meta, nbs, blocks, pp = kk.pack_params(*tree, wide=8, leaf_max=8)
    lay = kk.make_layout(meta, nbs, blocks, pp)
    nw, W, cb = meta.shape[1], 8, pp["cnt_bits"]
    nodes = lay.nodes.numpy()
    assert nodes.shape == (nw, 64) and lay.recs.shape == (
        blocks.shape[0] // pp["block_rows"] * 8, 12)
    enc = nodes[:, 6 * W:7 * W].copy().view(np.int32)
    inner = (enc >= 0) & ((enc & ((1 << cb) - 1)) == 0)
    # breadth-first: a node's children sit after it, in increasing order
    kids = (enc >> cb)[inner]
    assert np.array_equal(kids, np.arange(1, nw))
    # walk both numberings from the root in step
    pairs, seen = [(0, 0)], 0
    while pairs:
        old, new = pairs.pop()
        seen += 1
        np.testing.assert_array_equal(
            nodes[new, :6 * W].reshape(6, W).T, nbs[:, old].reshape(W, 6))
        assert nodes[new, 7 * W:7 * W + 1].view(np.int32)[0] == meta[W, old]
        for k in range(W):
            e_old, e_new = int(meta[k, old]), int(enc[new, k])
            if e_old >= 0 and (e_old & ((1 << cb) - 1)) == 0:
                pairs.append((e_old >> cb, e_new >> cb))
            else:
                assert e_old == e_new
    assert seen == nw
    recs = lay.recs.numpy().reshape(-1, 8, 12)
    np.testing.assert_array_equal(recs[0, 0, :9], blocks[0, :9])
    assert recs[..., 9].copy().view(np.int32).max() == tree[5].shape[0] - 1
    assert lay.table_bytes(2) == 4 * (nodes.size + recs.size)
    assert lay.table_bytes(1) == 4 * (nodes.size + blocks.size)


# -- (b) the twin against the interpret-mode Pallas kernel -------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_twin_matches_pallas_kernel(soup, name):
    wide, leaf_max, dual, variant, any_hit = CONFIGS[name]
    tree = soup[1]
    o, d, tmax = _soup_rays(N_RAYS)
    if any_hit:
        tmax = _soup_rays(N_RAYS, tmax=(0.5, 6.0))[2]
    t, i = _twin(_layout(tree, wide, leaf_max, dual), o, d, tmax, any_hit,
                 variant)
    t_pk, i_pk = _pallas(tree, wide, leaf_max, dual, o, d, tmax, any_hit,
                         variant)
    if any_hit:
        np.testing.assert_array_equal(i >= 0, i_pk >= 0)
        assert 0 < (i >= 0).sum() < N_RAYS
        return
    hit = _assert_matches(t, i, t_pk, i_pk)
    assert 0.05 < hit.mean() < 0.95
    assert (i[hit] != i_pk[hit]).mean() < 1e-2           # ties only
    np.testing.assert_array_equal(t[~hit], np.float32(1e30))


# -- (c) the twin against the port's binary twin -----------------------------

@pytest.mark.parametrize("name", ["v1", "v2", "v3", "wide8", "dual"])
def test_twin_is_bit_equal_to_the_binary_twin(soup, name):
    wide, leaf_max, dual, variant, _ = CONFIGS[name]
    _, tree, tb = soup
    lay = _layout(tree, wide, leaf_max, dual)
    for tm in (None, (0.5, 6.0)):
        o, d, tmax = _soup_rays(1500, seed=5, tmax=tm)
        t_b, i_b = bvh_binary._traverse_reference(
            tb, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax),
            False)
        stats = {}
        t, i = _twin(lay, o, d, tmax, False, variant, stats)
        np.testing.assert_array_equal(t, t_b.numpy())      # bit for bit
        tied = i != i_b.numpy()
        assert tied.mean() < 1e-2 and ((i >= 0) == (i_b.numpy() >= 0)).all()
        _, i_any = _twin(lay, o, d, tmax, True, variant)
        np.testing.assert_array_equal(i_any >= 0, i >= 0)
        assert stats["slab_tests"] > stats["int_steps"] > 1500
        assert stats["tri_tests"] > stats["leaf_steps"] > 0
    assert (i >= 0).any() and (i < 0).any()


def test_pruning_skips_steps_and_changes_nothing(soup):
    """Variant 3 pops what variant 2 pops but skips entries that start at
    or beyond the closest hit: never more steps, the same hits."""
    lay = _layout(soup[1], 4, 16, False)
    o, d, tmax = _soup_rays(3000, seed=5)
    s2, s3 = {}, {}
    t2, i2 = _twin(lay, o, d, tmax, False, 2, s2)
    t3, i3 = _twin(lay, o, d, tmax, False, 3, s3)
    np.testing.assert_array_equal(t2, t3)
    np.testing.assert_array_equal(i2, i3)
    assert s3["int_steps"] + s3["leaf_steps"] < \
        s2["int_steps"] + s2["leaf_steps"]
    # count mode returns the steps per ray, and they add up to the stats
    _, code = _twin(lay, o, d, tmax, False, 13)
    assert (code >> 16).sum() == s3["int_steps"]
    assert (code & 0xFFFF).sum() == s3["leaf_steps"]


# -- (d) count mode ----------------------------------------------------------

def test_count_mode_matches_pallas_kernel(soup):
    """A packet of 1,024 copies of one ray walks as that ray alone does: the
    Pallas kernel's step code (variant 12) equals the twin's, for eight
    rays through one program."""
    tree = soup[1]
    lay = _layout(tree, 4, 16, False)
    o, d, tmax = _soup_rays(N_RAYS)
    t_all, i_all = _twin(lay, o, d, tmax, False, 2)
    hits = np.nonzero(i_all >= 0)[0][:6]
    picks = list(hits) + list(np.nonzero(i_all < 0)[0][:2])
    assert len(picks) == 8
    _, code = _twin(lay, o[picks], d[picks], tmax[picks], False, 12)
    assert (code >> 16).min() >= 1 and (code & 0xFFFF).max() >= 1
    for ray, want in zip(picks, code):
        rep = lambda x: np.repeat(x[ray:ray + 1], N_RAYS, axis=0)
        t_pk, c_pk = _pallas(tree, 4, 16, False, rep(o), rep(d), rep(tmax),
                             False, 12)
        assert (c_pk == c_pk[0]).all()
        assert int(c_pk[0]) == int(want), (ray, c_pk[0] >> 16,
                                           c_pk[0] & 0xFFFF, want)
        np.testing.assert_allclose(t_pk[0], t_all[ray], rtol=1e-5)


# -- (e) the probe and the wrappers ------------------------------------------

def test_smem_probe_plain_version_and_no_fallback(soup):
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(8, 128))
                        .astype(np.float32))
    want = x.numpy() + x.numpy()[0, 1]
    np.testing.assert_array_equal(kk._probe_reference(x).numpy(), want)
    # nothing is probed on the CPU, so nothing is reported as granted
    assert kk.smem_probe(48, "cpu", x) == {"kb": 48, "ok": None}
    assert kk.smem_probe(9999, "cpu") == {"kb": 9999, "ok": None}
    with pytest.raises(NotImplementedError):
        kexp_run._smem_nodes(None, "max", torch.device("cpu"))
    assert kexp_run._smem_nodes(None, "256", torch.device("cpu")) == 256
    with pytest.raises(ValueError):
        kk.smem_probe(0, "cpu")
    before = kk.smem_probe.launches, kk.traverse.launches
    if not torch.cuda.is_available():
        # asked for the card: no plain version in its place
        with pytest.raises(RuntimeError, match="CUDA"):
            kk.smem_probe(48)
        with pytest.raises(RuntimeError, match="CUDA"):
            kk.smem_limit_kb()
    lay = _layout(soup[1], 4, 16, False)
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(NotImplementedError):
        kk.traverse(lay, meta, meta, meta[:, 0], any_hit=False, variant=2)
    o, d, tmax = (torch.as_tensor(x) for x in _soup_rays(64))
    for bad in (4, 7, 15, 22):
        with pytest.raises(ValueError, match="variant"):
            kk.traverse(lay, o, d, tmax, any_hit=False, variant=bad)
    with pytest.raises(ValueError, match="dual"):
        kk.traverse(lay, o, d, tmax, any_hit=False, variant=5)
    t, i = kk.traverse(lay, o, d, tmax, any_hit=False, variant=3)
    assert t.shape == i.shape == (64,)
    assert before == (kk.smem_probe.launches, kk.traverse.launches)
    assert kk.node_smem_bytes(lay, 10) == 10 * 128
    assert kk.max_smem_nodes(lay, 227) == lay.n_nodes
    big = dataclasses.replace(lay, nodes=torch.zeros(5000, 32))
    assert kk.max_smem_nodes(big, 227) == 227 * 1024 // 128


def test_probe_sets_the_size_only_when_it_changes():
    """The probe's wrapper asks for the kernel's dynamic shared-memory size
    only when it differs from the last one granted on that device; a
    refused size leaves the granted one, and each device keeps its own."""
    calls = []

    def set_size(kb):
        calls.append(kb)
        return 0 if kb <= kk.SMEM_DOCUMENTED_KB else 1

    sizes = kk._ProbeSizes()
    for kb in (227, 227, 48, 48, 227):
        assert sizes.ensure(set_size, 0, kb) == 0
    assert calls == [227, 48, 227] and sizes.sets == 3
    assert sizes.ensure(set_size, 0, 228) == 1
    assert sizes.granted_kb == {0: 227} and calls[-1] == 228
    assert sizes.ensure(set_size, 0, 227) == 0 and len(calls) == 4
    assert sizes.ensure(set_size, 1, 227) == 0 and calls[-1] == 227
    assert sizes.granted_kb == {0: 227, 1: 227} and sizes.sets == 5
    assert isinstance(kk._probe_sizes, kk._ProbeSizes)


def test_warp_efficiency_of_step_codes():
    """Steps over 32 times the sum of each 32-ray group's longest walk."""
    even = torch.full((64,), 3 * 65536 + 2, dtype=torch.int32)
    assert kexp_run.warp_efficiency(even) == 1.0
    one_long = even.clone()
    one_long[5] = 9 * 65536 + 1                  # 10 steps, the others 5
    want = (63 * 5 + 10) / (32 * (10 + 5))
    assert kexp_run.warp_efficiency(one_long) == pytest.approx(want)
    # a ragged tail of fewer than 32 rays is left out
    assert kexp_run.warp_efficiency(torch.cat([even, one_long[:7]])) == 1.0


def test_deep_wide_tree_raises_at_layout_time():
    """A tree whose walk could need more stack than the kernel holds is
    refused when its layout is made."""
    levels = kk.STACK + 4
    # a chain of wide nodes: slot 0 a leaf, slot 1 the next wide node
    meta = np.full((5, levels), -1, np.int32)
    meta[4] = 0
    meta[0] = (np.arange(levels) << 5) | 1
    meta[1, :-1] = np.arange(1, levels) << 5
    assert kk.wide_stack_need(meta, 4, 5) == levels
    nbs = np.zeros((24, levels), np.float32)
    blocks = np.zeros((2 * levels, 128), np.float32)
    with pytest.raises(ValueError, match="STACK"):
        kk.make_layout(meta, nbs, blocks, kk.DUAL_PP)
    ok = kk.STACK
    meta_ok = meta[:, :ok].copy()
    meta_ok[1, ok - 1] = -1              # the chain ends here
    lay = kk.make_layout(meta_ok, nbs[:, :ok], blocks[:2 * ok], kk.DUAL_PP)
    assert lay.stack_need == kk.STACK and lay.n_nodes == ok


# -- (f) the harness end to end on the CPU -----------------------------------

@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kexp") / "soup.npz")
    kexp_prep.main(["--scene", "soup", "--size", "600", "--rays", "2048",
                    "--res", "32", "--out", path, "--device", "cpu"])
    return path


def test_prep_writes_the_harness_keys(npz):
    z = kexp_run.load(npz)
    want = ("lo hi right count axis v0 v1 v2 prim_order o_p d_p o_r d_r o_rs "
            "d_rs tmax "
            "o_mix d_mix t_x i_x o_b d_b d_sh tmax_sh").split()
    assert sorted(z) == sorted(want)
    assert not any(k.startswith("pk_") for k in z)
    for k in ("o_p", "d_p", "o_r", "d_r", "o_rs", "d_rs", "o_b", "d_b",
              "d_sh"):
        assert z[k].shape == (2048, 3) and z[k].dtype == np.float32, k
    assert z["tmax"].shape == z["tmax_sh"].shape == (2048,)
    assert z["t_x"].shape == z["i_x"].shape == (2048,)
    assert z["v0"].shape[0] >= 600 and (z["count"] <= 4).all()
    # the sorted set is the random set, by octant
    octant = ((z["d_rs"] < 0) * np.array([4, 2, 1])).sum(-1)
    assert (np.diff(octant) >= 0).all()
    assert np.array_equal(np.sort(z["o_r"], 0), np.sort(z["o_rs"], 0))
    for k in ("d_p", "d_b", "d_sh"):
        np.testing.assert_allclose(np.linalg.norm(z[k], axis=1), 1, atol=1e-5)
    assert np.isfinite(z["tmax_sh"]).all() and (z["i_x"] >= 0).mean() > 0.2


RATES = ["primary_mrays", "random_mrays", "sorted_mrays"]
AGREE = ["prim_agreement", "max_abs_dt"]
EXPERIMENTS = {
    "baseline": (["baseline"], ["wide_nodes", "stack_need"] + RATES[:2]
                 + AGREE),
    "binary": (["binary"], ["nodes"] + RATES[:2] + AGREE),
    "grid": (["grid", "persistent"], ["persistent"] + RATES + AGREE),
    "l2": (["l2", "on"], ["l2_window"] + RATES + AGREE),
    "variant3": (["variant", "3"], ["variant", "block"] + AGREE + RATES),
    "count2": (["count", "2"], ["variant", "primary", "random"]),
    "dual": (["dual"], ["exp_kind", "block", "tri_rows"] + AGREE + RATES),
    "pack88": (["pack", "8", "8"], ["wide", "leaf_max", "block", "nw",
                                    "n_leaf_blocks"] + AGREE + RATES),
}


@pytest.mark.parametrize("name", list(EXPERIMENTS))
def test_kexp_run_prints_the_harness_line(npz, capsys, name):
    argv, keys = EXPERIMENTS[name]
    kexp_run.main(argv + ["--npz", npz, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["exp"] == argv[0] and out["device"] == "cpu"
    assert set(keys + ["exp", "wall_s"]) <= set(out), set(keys) - set(out)
    if "prim_agreement" in out:
        assert out["prim_agreement"] >= 0.999          # 1.0 up to ties
        assert out["max_abs_dt"] < 1e-5
        # nothing is timed on the CPU: no rate under a device metric's name
        assert all(out[k] is None for k in out if k.endswith("_mrays"))
    else:
        for rset in ("primary", "random", "bounce", "shadow"):
            assert set(out[rset]) == {
                "packets", "int_steps_mean", "leaf_steps_mean",
                "int_steps_max", "leaf_steps_max"}
            assert out[rset]["packets"] == 2048
            assert out[rset]["int_steps_mean"] >= 1.0


def test_kexp_run_needs_the_card_by_default(npz):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for argv in (["baseline", "--npz", npz], ["smem_probe", "48"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            kexp_run.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        kexp_prep.main(["--scene", "soup", "--size", "300"])
    for argv in (["slope"], ["grid", "wide"], ["l2"]):
        with pytest.raises(SystemExit):
            kexp_run.main(argv + ["--npz", npz, "--device", "cpu"])


def test_triangle_soup_is_irregular():
    """The harness's second scene: edge lengths over two decades, one mesh,
    a BVH from the native build, the cornell light."""
    sc = entry._triangle_soup("cpu", n=2000)
    assert sc.n_tri == 2000 and sc.n_pln == 1 and sc.bvh is not None
    assert sc.bvh.built_by.startswith("native-")
    g = sc.geom
    edge = (g.tri_v1 - g.tri_v0).norm(dim=-1)
    short = 0.0005 * 50 ** 0.5           # the decades scale with 1/sqrt(n)
    assert 0.99 * short < float(edge.min()) < 2 * short
    assert 50 * short < float(edge.max()) <= 100.01 * short
    assert float(g.tri_v0.min()) >= 0.05 and float(g.tri_v0.max()) <= 0.95
    again = entry._triangle_soup("cpu", n=2000)
    assert torch.equal(again.geom.tri_v1, g.tri_v1)


# -- (g) no JAX at run time --------------------------------------------------

def test_harness_runs_without_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        before = set(sys.modules)
        sys.modules["jax"] = None
        import importlib, pkgutil
        import pbrt_tpu_torch.tools as tools
        for m in pkgutil.walk_packages(tools.__path__,
                                       "pbrt_tpu_torch.tools."):
            importlib.import_module(m.name)
        from pbrt_tpu_torch.tools import kexp_prep, kexp_run
        path = {str(tmp_path / "hf.npz")!r}
        kexp_prep.main(["--scene", "heightfield", "--size", "12", "--rays",
                        "512", "--res", "16", "--out", path, "--device",
                        "cpu"])
        for argv in (["variant", "1"], ["dual"], ["smem_probe", "100"]):
            kexp_run.main(argv + ["--npz", path, "--device", "cpu"])
        new = set(sys.modules) - before
        assert not any(m.startswith(("jax.", "jaxlib", "pbrt_tpu."))
                       or m == "tools" or m.startswith("tools.")
                       for m in new), sorted(new)
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert out.stdout.count('"prim_agreement": 1.0') == 2
