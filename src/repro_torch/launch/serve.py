"""Serving launcher: ``python -m repro_torch.launch.serve --matrix poisson27:8``

Applies the allocator and CUDA environment from ``launch.env`` BEFORE the
first torch import, then stands up a :class:`repro_torch.serve.SolverServer`,
pushes a mixed-size workload through it, and reports queue, bucket and
runner telemetry. Runs on CUDA unless ``--device cpu`` is given.

    # cold start, mixed traffic, assert the two-runner steady state
    python -m repro_torch.launch.serve --matrix poisson27:8 --matrix poisson7:12 \\
        --requests 48 --max-batch 4 --expect-two-programs

    # save a warm-start manifest, then boot a hot replica from it
    python -m repro_torch.launch.serve --matrix poisson27:8 --save-manifest plans.json
    python -m repro_torch.launch.serve --manifest plans.json --requests 32
"""
from __future__ import annotations

import argparse
import sys

# the environment must precede any torch import: keep this module
# torch-free until main() has called apply_env()
from .env import apply_env, tcmalloc_note


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", action="append", default=None,
                    help="operator spec (repeatable for a multi-plan pool); "
                         "see launch/solve.py (default: poisson27:8)")
    ap.add_argument("--requests", type=int, default=32, help="requests pushed per operator")
    ap.add_argument("--method", default="pipecg")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=2000)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--max-depth", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--manifest", default=None,
                    help="warm start: rebuild every plan and its runners from this manifest")
    ap.add_argument("--save-manifest", default=None,
                    help="write the served plans' manifest here on exit")
    ap.add_argument("--expect-two-programs", action="store_true",
                    help="exit nonzero unless steady state built exactly two runners "
                         "(single + bucket) per plan")
    args = ap.parse_args(argv)

    # ---- environment BEFORE torch ----
    for k, v in apply_env().items():
        print(f"env: {k}={v}")
    note = tcmalloc_note()
    if note:
        print(f"env note: {note}")

    import torch

    import repro_torch.obs as obs
    from repro_torch.serve import SolverServer
    from repro_torch.sparse import spmv

    from .solve import build_matrix

    obs.enable()

    if args.manifest:
        server = SolverServer.from_manifest(args.manifest, device=args.device)
        # route traffic with each plan's own config — CLI solver defaults
        # must not shadow the manifest, or submits would miss the warm
        # pool and trigger fresh builds
        workload = [(p.A, p.config()) for p in server.plans()]
        warm_runners = {id(p): p.trace_count for p in server.plans()}
        print(f"warm-started {len(server.plans())} plan(s) from {args.manifest}")
    else:
        server = SolverServer(
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            max_depth=args.max_depth, method=args.method, engine=args.engine,
            atol=args.atol, maxiter=args.maxiter,
        )
        workload = [(build_matrix(s, device=args.device), {})
                    for s in (args.matrix or ["poisson27:8"])]
        warm_runners = None

    # ---- mixed-size workload: singles + partial + full buckets ----
    futures = []
    for A, overrides in workload:
        xstar = torch.ones(A.n, dtype=A.dtype, device=A.device) / A.n**0.5
        b = spmv(A, xstar)
        # prime: one lone request, waited on, so the single runner is built
        # deterministically (later singles may coalesce into buckets)
        futures.append(server.submit(A, b, **overrides))
        futures[-1].result(timeout=300.0)
        group, i = [], 1
        while i < args.requests:
            # cycle bucket sizes 1, cap, cap//2, 3 — singles exercise the
            # single runner, the rest coalesce into the bucket one
            for size in (1, args.max_batch, max(args.max_batch // 2, 1), 3):
                k = min(size, args.requests - i)
                if k <= 0:
                    break
                group += server.submit_many(
                    A, [(1.0 + 0.1 * (i + j)) * b for j in range(k)], **overrides)
                i += k
        futures += group
    results = [f.result(timeout=300.0) for f in futures]
    server.shutdown(drain=True)

    # ---- report ----
    waits = sorted(r.queue_wait_s for r in results)
    occ = [r.bucket_occupancy for r in results]
    iters = [r.iterations for r in results]

    def pct(xs, q):
        return xs[min(int(q * (len(xs) - 1)), len(xs) - 1)] if xs else 0.0

    print(f"served {len(results)} requests over {len(server.plans())} plan(s) "
          f"on {workload[0][0].device}")
    print(f"queue wait: p50={pct(waits, .5) * 1e3:.2f}ms p95={pct(waits, .95) * 1e3:.2f}ms")
    print(f"occupancy: mean={sum(occ) / max(len(occ), 1):.2f}  "
          f"iters: min={min(iters)} max={max(iters)}")
    for plan in server.plans():
        extra = ""
        if warm_runners is not None:
            boot = warm_runners.get(id(plan), 0)
            extra = f" (warm start: {boot} at boot, {plan.trace_count - boot} added serving)"
        print(f"plan n={plan.n}: runners (trace_count)={plan.trace_count}{extra}")
    rejects = {k: v["value"] for k, v in obs.snapshot().items()
               if k.startswith("serve.rejects.") and v["value"]}
    if rejects:
        print(f"rejections: {rejects}")

    if args.save_manifest:
        server.save_manifest(args.save_manifest)
        print(f"manifest saved: {args.save_manifest}")

    if args.expect_two_programs:
        bad = {p.n: p.trace_count for p in server.plans() if p.trace_count != 2}
        if bad:
            print(f"FAIL: expected exactly 2 runners per plan (single + bucket), got {bad}",
                  file=sys.stderr)
            return 1
        print("steady state OK: exactly 2 runners per plan")
    if warm_runners is not None:
        added = {p.n: p.trace_count - warm_runners.get(id(p), 0)
                 for p in server.plans() if p.trace_count != warm_runners.get(id(p), 0)}
        if added:
            print(f"FAIL: warm-started plans built runners while serving: {added}",
                  file=sys.stderr)
            return 1
        print("warm start OK: no new runner while serving")
    return 0


if __name__ == "__main__":
    sys.exit(main())
