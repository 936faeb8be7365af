"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which also close standard error. Exits with a
code other than 0, printing no result, where CUDA or the cell's chips are
missing, where the program is not in the checkout, or where JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T0 = time.monotonic()  # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _fail(msg: str, code: int) -> int:
    print(f"bench.run: {msg}", file=sys.stderr, flush=True)
    return code


def _finite(v):
    return v if isinstance(v, (int, bool)) or math.isfinite(v) else 1e300


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    from bench import catalog, harness, roofline

    try:
        bm = catalog.load_benchmark(ROOT)
        wl = catalog.workload(bm, args.workload)
        cfg = catalog.config(bm, wl["config"], ROOT)
        mix = catalog.traffic(wl["traffic"])
    except (OSError, KeyError, ValueError) as e:
        return _fail(f"cannot read the cell: {e}", 2)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        return _fail(f"needs {wl['chips']} CUDA device(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the program is not in this checkout ({e})", 4)

    out = harness.run_cell(cfg, mix, catalog.metrics_for(bm, args.workload, bool(args.trace)),
                           seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           t_start=T0, device="cuda")
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        return _fail(f"modules of JAX or the JAX package were loaded: {loaded}", 5)

    run, checks = out["run"], out["checks"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": wl["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"], "power": roofline.power_limit()}
    result = {"correct": harness.correct(checks), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if args.trace:
        tr = run.trace
        device.update(busy_s=tr.busy_s if tr else 0.0, window_s=tr.window_s if tr else 0.0)
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}

    info = {"workload": args.workload, "seed": args.seed, "window_s": run.seconds,
            "setup_s": run.setup_s, "answers": len(run.answered), **out["extra"]}
    if run.trace is not None:
        info.update(traced_units=sum(1 for r in run.answered if r.traced),
                    kernels=run.trace.kernels)
    print("info " + json.dumps(info), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
