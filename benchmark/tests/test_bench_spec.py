"""BENCHMARK.json against the contract's limits, and every name found."""

import json
import shutil
import time

import pytest

from benchmark import drive, guard, run, spec
from benchmark.systems import Program


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _names(bench):
    yield from (c["name"] for c in bench["configs"])
    for w in bench["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in bench["end_to_end"] + bench["per_layer"])
    for c in bench["configs"]:
        yield from c["reduced"]


def test_names_and_units(bench):
    for n in _names(bench):
        assert spec.NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    lines = [w["why"] for w in bench["workloads"] + bench["configs"]]
    lines += [m["layer"] for m in bench["per_layer"]]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_exactly(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:3] == ["python3", "-m", "benchmark.run"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("kind", ["configs", "traffic", "kinds", "metrics",
                                  "cells"])
def test_every_file_found_by_name(bench, kind):
    if kind == "configs":
        for c in bench["configs"]:
            cfg = spec.load_json(spec.ROOT / c["file"])
            assert (spec.ROOT / cfg["scene"]).exists()
            assert spec.reference(cfg["reference"]).load
    elif kind == "traffic":
        for w in bench["workloads"]:
            assert spec.traffic_file(w["traffic"]).exists()
    elif kind == "kinds":
        for w in bench["workloads"]:
            traffic = spec.load_json(spec.traffic_file(w["traffic"]))
            assert callable(spec.kind(traffic["kind"]).run)
    elif kind == "metrics":
        for m in bench["end_to_end"] + bench["per_layer"]:
            assert callable(spec.reader(m["name"]))
    else:
        for w in bench["workloads"]:
            cell = spec.cell(bench, w["name"])
            names = {m["name"] for m in cell["end_to_end"]}
            assert "setup_s" in names and len(names) >= 2
            assert cell["per_layer"]
            assert all(m["moves"] in names for m in cell["per_layer"])


def _copy(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "benchmark"


def test_cell_added_by_files_alone(bench, tmp_path):
    """A new configuration, traffic mix and metric as new files, and new
    entries in BENCHMARK.json: the cell loads and runs with no code
    edited, and its configuration's max_depth reaches both the program
    and the reference."""
    here = _copy(tmp_path)
    new = json.loads(json.dumps(bench))
    cfg = json.loads((spec.HERE / "configs" / "cornell_portal.json")
                     .read_text())
    cfg["max_depth"] = 3
    (here / "configs/portal_d3.json").write_text(json.dumps(cfg))
    (here / "traffic/render_small.json").write_text(json.dumps(
        {"kind": "images", "width": 32, "height": 32, "spp": 4,
         "chunk_spp": 2}))
    (here / "metrics/images_done.py").write_text(
        "def read(rec):\n    return rec['items']\n")
    new["configs"].append({"name": "portal_d3", "source": "x",
                           "file": "benchmark/configs/portal_d3.json",
                           "reduced": ["max_depth"], "why": "x"})
    new["workloads"].append({"name": "d3.small", "config": "portal_d3",
                             "traffic": "render_small", "chips": 1,
                             "why": "x"})
    new["end_to_end"].append({"name": "images_done", "unit": "images",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["d3.small"]})
    cell = spec.cell(new, "d3.small", root=tmp_path)
    assert cell["config"]["max_depth"] == 3
    assert cell["traffic"]["width"] == 32
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s",
                                                       "images_done"]
    rec = drive.run(cell, 5, 0.5, False, Program, "cpu",
                    time.perf_counter())
    out = run.result(cell, rec, False, 1, "cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["images_done"]["value"] == rec["items"] >= 1


SINGLE = """
import time

from benchmark import compare, drive


def run(cell, seed, seconds, do_trace, system_cls, device, t_process,
        rank, world, port):
    tr, config = cell["traffic"], cell["config"]
    W, H, spp = tr["width"], tr["height"], tr["spp"]
    system = system_cls(config, device)
    t0 = time.perf_counter()
    img = system.render(W, H, spp, None, seed)
    t1 = time.perf_counter()
    ref, sc = drive.reference(cell, device)
    gap = compare.rel_l1(img, ref.render(sc, sc.kd, sc.emit, W, H, spp,
                                         seed))
    return {"kind": "single", "setup_s": t0 - t_process,
            "window_s": t1 - t0, "items": 1, "attempted": 1, "failed": 0,
            "memory_peak_bytes": 0,
            "checks": compare.checks({"image_rel_l1": gap},
                                     config["limits"])}
"""


def test_kind_added_by_files_alone(bench, tmp_path):
    """A new kind of traffic as a new driver file, a mix of that kind and
    a metric that reads its record: found by name and run with no code
    edited."""
    here = _copy(tmp_path)
    (here / "kinds/single.py").write_text(SINGLE)
    (here / "traffic/one_image.json").write_text(json.dumps(
        {"kind": "single", "width": 16, "height": 16, "spp": 2}))
    (here / "metrics/image_s.py").write_text(
        "def read(rec):\n    return rec['window_s']\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "portal.one", "config": "cornell_portal",
                             "traffic": "one_image", "chips": 1, "why": "x"})
    new["end_to_end"].append({"name": "image_s", "unit": "s",
                              "better": "lower", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["portal.one"]})
    cell = spec.cell(new, "portal.one", root=tmp_path)
    rec = drive.run(cell, 3, 0.5, False, Program, "cpu",
                    time.perf_counter())
    out = run.result(cell, rec, False, 1, "cpu")
    assert rec["kind"] == "single" and out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "image_s"}


@pytest.mark.parametrize("name,bad", [
    ("pbrt_tpu_torch", False), ("pbrt_tpu_torch.ops.fused_path", False),
    ("benchmark.run", False), ("pbrt_tpu", True), ("pbrt_tpu.ops", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("jaxtyping", False), ("pbrt_tpu_x", False)])
def test_import_guard_compares_top_level_names(name, bad):
    assert bool(guard.forbidden([name])) is bad


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        tops = {guard.top_level(m) for m in mods}
        assert not tops & (guard.FORBIDDEN | {"pbrt_tpu_torch"}), path
