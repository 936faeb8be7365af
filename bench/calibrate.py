"""Readings that set the benchmark's limits and its serving rate; run on
the chip by hand, never by the benchmark's own runs.

    python3 -m bench.calibrate readings --workload poisson125.solve --seeds 11,12,13 --seconds 3
    python3 -m bench.calibrate readings --workload poisson125.solve --seeds 11,12,13 --seconds 3 --control
    python3 -m bench.calibrate sweep --workload poisson125.serve --rates 150,200,250 --seconds 8 --seed 5

``readings`` runs the cell once per seed in one process (set-up is paid
per seed, the kernel library is loaded once) and prints, per seed, the
numbers compared with the reference and the iteration counts; with
``--control`` the configuration's control (a lower precision) takes the
program's place. ``sweep``
runs the open-loop cell at each rate and prints the latency quantiles,
the completed rate and how far the answers trailed the window's close.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from bench import catalog, harness
from bench.run import ROOT
from bench.stats import percentile


def _cell(name: str):
    bm = catalog.load_benchmark(ROOT)
    wl = catalog.workload(bm, name)
    return catalog.config(bm, wl["config"], ROOT), catalog.traffic(wl["traffic"])


def _run(cfg, mix, seed, seconds, control):
    import torch

    t = time.monotonic()
    out = harness.run_cell(cfg, mix, [], seed=seed, seconds=seconds, trace=False, t_start=t,
                           control=control)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def readings(args) -> None:
    cfg, mix = _cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = _run(cfg, mix, seed, args.seconds, args.control)
        run = out["run"]
        its = [r.iterations for r in run.answered]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": args.control,
            "checks": {k: c["value"] for k, c in out["checks"].items()},
            "answers": len(its), "iterations": [min(its, default=0), max(its, default=0)],
            "steps": sorted({r.steps for r in run.answered}), "setup_s": run.setup_s,
            "window_s": run.seconds, "correct": harness.correct(out["checks"])}), flush=True)


def sweep(args) -> None:
    cfg, mix = _cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        out = _run(cfg, dict(mix, rate_per_s=rate), args.seed, args.seconds, False)
        run = out["run"]
        lat = [r.done - r.due for r in run.answered]
        end = run.window_start + run.seconds
        print(json.dumps({
            "rate": rate, "due": len(run.requests), "answered": len(lat),
            "p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * percentile(lat, 95),
            "p99_ms": 1e3 * percentile(lat, 99), "max_ms": 1e3 * max(lat, default=0),
            "done_in_window_per_s": sum(r.done <= end for r in run.answered) / run.seconds,
            "last_answer_after_close_s": max((r.done for r in run.answered), default=end) - end,
            "mean_bucket": len(lat) / max(1, len({r.bucket for r in run.answered})),
            **out["extra"]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", required=True)
    r.add_argument("--seconds", type=float, default=3.0)
    r.add_argument("--control", action="store_true")
    s = sub.add_parser("sweep")
    s.add_argument("--workload", required=True)
    s.add_argument("--rates", required=True)
    s.add_argument("--seconds", type=float, default=8.0)
    s.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    (readings if args.cmd == "readings" else sweep)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
