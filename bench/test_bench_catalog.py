"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a traffic mix and a metric by file name alone: a new one
is a new file plus a new entry, with no edit to a file that is there."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from bench import catalog

ROOT = catalog.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _bm():
    return catalog.load_benchmark()


def test_benchmark_json_keeps_the_contract():
    bm = _bm()
    assert set(bm) == KEYS
    assert bm["paths"] == ["bench"] and 1 <= bm["run_seconds"] <= 51
    assert all("/" not in w or not w.startswith("/") for w in bm["command"])
    assert len(json.dumps(bm)) < 64 * 1024
    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
    names = {c["name"] for c in bm["configs"]}
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        catalog.traffic(w["traffic"])
    metrics = bm["end_to_end"] + bm["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(catalog.module("metrics", m["name"]).read)
    for m in bm["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bm["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in bm["workloads"]:
        e2e = {m["name"] for m in catalog.metrics_for(bm, w["name"], False)}
        layer = catalog.metrics_for(bm, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


def test_configurations_name_their_generator_form_and_limits():
    bm = _bm()
    for c in bm["configs"]:
        cfg = catalog.config(bm, c["name"])
        catalog.module("operators", cfg["operator"])
        catalog.module("forms", cfg["form"])
        assert cfg["limits"] and all(v > 0 for v in cfg["limits"].values())
        assert cfg["control"] and cfg["assumed"]


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix and a metric
    as new files and entries, and run the new cell on the CPU from the copy."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    bm = _bm()
    cfg = json.loads((ROOT / "bench/configs/poisson125_128.json").read_text())
    cfg.update(name="poisson125_8", grid=8)
    (tmp_path / "bench/configs/poisson125_8.json").write_text(json.dumps(cfg))
    (tmp_path / "bench/traffic/solve_twice.json").write_text(json.dumps(
        {"entry": "plan", "loop": "closed", "clients": 1,
         "rhs": {"scale_lo": 1.0, "scale_hi": 2.0}}))
    (tmp_path / "bench/metrics/iterations_mean.py").write_text(
        "def read(run):\n    its = [r.iterations for r in run.answered]\n"
        "    return sum(its) / len(its) if its else None\n")
    bm["configs"].append({"name": "poisson125_8", "source": "test", "why": "test",
                          "file": "bench/configs/poisson125_8.json", "reduced": ["grid"]})
    bm["workloads"].append({"name": "tiny.solve", "config": "poisson125_8",
                            "traffic": "solve_twice", "chips": 1, "why": "test"})
    bm["per_layer"].append({"name": "iterations_mean", "unit": "it", "better": "lower",
                            "source": "program_counter", "layer": "solver loop",
                            "moves": "solve_ms", "workloads": ["tiny.solve"]})
    bm["end_to_end"][1]["workloads"].append("tiny.solve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    code = (
        "import json, time, sys\n"
        "from bench import catalog, harness\n"
        "bm = catalog.load_benchmark(catalog.ROOT)\n"
        "w = catalog.workload(bm, 'tiny.solve')\n"
        "cfg = catalog.config(bm, w['config'])\n"
        "mix = catalog.traffic(w['traffic'])\n"
        "ms = catalog.metrics_for(bm, 'tiny.solve', False) + catalog.metrics_for(bm, 'tiny.solve', True)\n"
        "out = harness.run_cell(cfg, mix, ms, seed=3,\n"
        "    seconds=0.3, trace=False, t_start=time.monotonic(), device='cpu')\n"
        "print(json.dumps({'metrics': out['metrics'], 'correct': harness.correct(out['checks']),\n"
        "    'here': str(catalog.HERE)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert Path(out["here"]) == tmp_path / "bench"
    assert out["correct"] and out["metrics"]["iterations_mean"]["value"] > 0
    assert set(out["metrics"]) == {"setup_s", "solve_ms", "iterations_mean"}
    after = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())  # nothing that was there changed


def test_an_empty_trace_runs_the_window_again(monkeypatch):
    """A profiler session that did not record the traced part is not read:
    the window runs again under a fresh one, and every request of both is
    judged."""
    from bench import _tiny, harness
    from bench.trace import TraceSummary

    sessions = []

    class FakeTracer:
        def __init__(self, start_at, stop_at):
            self.start_at, self.stop_at = start_at, stop_at
            self.t_start = self.t_stop = None
            sessions.append(self)

        def begin(self):
            pass

        sound = harness.Tracer.sound

        def boundary(self, w0):
            now = harness.time.monotonic()
            if self.t_start is None and now - w0 >= self.start_at:
                self.t_start = now
            elif self.t_start is not None and self.t_stop is None and now - w0 >= self.stop_at:
                self.t_stop = now

        def traced(self, a, b):
            return self.t_stop is not None and a >= self.t_start and b <= self.t_stop

        def finish(self):
            if self.t_stop is None:
                self.t_stop = harness.time.monotonic()
            if len(sessions) == 1:
                return TraceSummary(window_s=0.0, busy_s=0.0)  # recorded nothing
            span = self.t_stop - self.t_start
            return TraceSummary(window_s=span, busy_s=0.5 * span, solver_kernel_s=0.4 * span,
                                solver_kernels=10, kernels=12, marked=2)

    monkeypatch.setattr(harness, "Tracer", FakeTracer)
    cfg, mix = _tiny.cell("poisson125.solve")
    out = harness.run_cell(cfg, mix, [{"name": "device_idle.solve", "unit": "%"}], seed=9,
                           seconds=0.3, trace=True, t_start=harness.time.monotonic(),
                           device="cpu")
    assert len(sessions) == 2 and len(out["extra"]["trace_attempts"]) == 2
    assert out["metrics"]["device_idle.solve"]["value"] == 50.0
    assert out["attempted"] > len(out["run"].requests) > 0
    assert harness.correct(out["checks"])
