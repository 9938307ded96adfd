"""BENCHMARK.json and the files it names, found by name.

- a configuration ``<config>``: the file its entry names
  (``benchmark/configs/<config>.json``), and its plain reference
  ``benchmark/reference/<reference>.py`` (the name in that file);
- a traffic mix ``<traffic>``: ``benchmark/traffic/<traffic>.json``, the
  parameters of the mix, among them its ``kind``;
- a traffic kind ``<kind>``: ``benchmark/kinds/<kind>.py``, the driver of
  every mix of that kind, with ``run(cell, seed, seconds, do_trace,
  system_cls, device, t_process, rank, world, port) -> record | None``;
- a metric ``<metric>``: ``benchmark/metrics/<metric>.py``, a reader with
  ``read(rec) -> float | None``.

So a cell, and a kind of traffic, is added by files and entries alone.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(path=None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def traffic_file(name: str, root: Path = ROOT) -> Path:
    return root / HERE.name / "traffic" / f"{check_name(name)}.json"


def metric_file(name: str, root: Path = ROOT) -> Path:
    return root / HERE.name / "metrics" / f"{check_name(name)}.py"


def kind_file(name: str, root: Path = ROOT) -> Path:
    return root / HERE.name / "kinds" / f"{check_name(name)}.py"


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


_LOADED: dict = {}


def _module(package: str, name: str, path: Path):
    """The module in the file ``path``, loaded once a process."""
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"benchmark.{package}." + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of metric ``name``."""
    return _module("metrics", name, metric_file(name, root)).read


def kind(name: str, root: Path = ROOT):
    """The driver module of traffic kind ``name``."""
    return _module("kinds", name, kind_file(name, root))


def reference(name: str):
    """The plain reference module of a configuration."""
    return importlib.import_module(f"benchmark.reference.{check_name(name)}")


def cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one run of ``workload`` needs: its entry, configuration,
    traffic mix and the end-to-end and per-layer metrics it reports."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(traffic_file(entry["traffic"], root))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in e2e_names]
    return {"name": workload, "entry": entry, "config_name": entry["config"],
            "config": config, "traffic": traffic, "chips": entry["chips"],
            "end_to_end": e2e, "per_layer": per_layer, "root": root}
