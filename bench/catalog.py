"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

A configuration is ``BENCHMARK.json``'s ``file``; a traffic mix is
``traffic/<name>.json``; a metric is ``metrics/<name>.py`` (its
``read(run)``); an operator generator ``operators/<name>.py`` and a
program form ``forms/<name>.py``, named by the configuration. Adding one
of them is a new file plus a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["HERE", "ROOT", "load_benchmark", "workload", "config", "traffic", "module",
           "metrics_for"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bm: dict, name: str) -> dict:
    return _named(bm["workloads"], name, "workload")


def config(bm: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bm["configs"], name, "config")
    with open(Path(root) / entry["file"]) as f:
        cfg = json.load(f)
    cfg.setdefault("name", name)
    return cfg


def traffic(name: str, base: Path = HERE) -> dict:
    with open(Path(base) / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    mix.setdefault("name", name)
    return mix


_MODULES: dict = {}


def module(kind: str, name: str, base: Path = HERE):
    """``<kind>/<name>.py`` loaded by its path (names may hold dots)."""
    path = Path(base) / kind / f"{name}.py"
    key = str(path)
    if key not in _MODULES:
        if not path.is_file():
            raise KeyError(f"no {kind} file {path}")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def metrics_for(bm: dict, workload_name: str, trace: bool) -> list:
    """The metric entries a run of this cell reports: the end-to-end ones
    with ``--trace 0``, the per-layer ones with ``--trace 1``. A metric
    without ``workloads`` is every cell's (per-layer: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bm["end_to_end"]
           if workload_name in m.get("workloads", [workload_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bm["per_layer"]
            if workload_name in m.get("workloads", [workload_name] if m["moves"] in moved else [])]
