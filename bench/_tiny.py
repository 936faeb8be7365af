"""The benchmark's cells cut to a size the CPU tests can hold."""
import time

from bench import catalog, harness

SIZES = {"poisson125_128": {"grid": 8}}


def cell(workload: str, rate_per_s: float = 20.0):
    bm = catalog.load_benchmark()
    w = catalog.workload(bm, workload)
    cfg = dict(catalog.config(bm, w["config"]), **SIZES[w["config"]])
    # a sound tiny solve takes tens of iterations: a faulty one stops sooner
    cfg["solver"] = dict(cfg["solver"], maxiter=120)
    mix = catalog.traffic(w["traffic"])
    if mix["loop"] == "open":
        mix = dict(mix, rate_per_s=rate_per_s)  # 20: below the plain CPU lanes' capacity
    return cfg, mix


def run(workload: str, seed: int = 2**31 + 77, control: bool = False, seconds: float = 0.4,
        rate_per_s: float = 20.0, device: str = "cpu"):
    cfg, mix = cell(workload, rate_per_s)
    out = harness.run_cell(cfg, mix, [], seed=seed, seconds=seconds, trace=False,
                           t_start=time.monotonic(), device=device, control=control)
    return harness.correct(out["checks"]), out
