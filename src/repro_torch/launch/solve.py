"""Solver launcher: ``python -m repro_torch.launch.solve --matrix poisson125:64``

Thin CLI over the plan/execute API: builds one ``repro_torch.plan``
(printed via ``plan.describe()``), then solves ``A x = A x*`` with
``x* = ones / sqrt(N)``. ``--method`` pcg, chronopoulos or pipecg on one
device, or a distributed method (h1, h2, h3, h4, pl2, pl3) over
``--shards`` devices: ``--devices`` lists them (default: the card for
shard 0 and the host's cores for the rest, the paper's CPU+GPU layout),
``--partition nnz`` with ``--weights`` gives the performance model's
split (relative speeds, e.g. from ``core.perfmodel.measure_spmv_time``),
``--sub`` the pods of h4. Matrices:
``poisson7/27/125:n``, ``synthetic:N,nnz_per_row`` and the Table-I names
(``Queen_4147:scale``), all in DIA form. Runs on CUDA unless ``--device
cpu`` is given. ``--rhs K`` serves K right-hand sides through the same
plan (``plan.solve_batched``) and prints the plan's runner count
(``traces=``; expect 2: the single solve and the K-batch).

    python -m repro_torch.launch.solve --matrix poisson27:12 --device cpu \
        --method h3 --shards 4 --devices cpu,cpu,cpu,cpu --partition nnz --weights 2,1,1,1
"""
from __future__ import annotations

import argparse
import sys

# the allocator and CUDA environment BEFORE the first torch import
# (``python -m repro_torch.launch.solve`` reaches this line torch-free); a
# no-op for every variable already set, and skipped when a running
# process imports this module for build_matrix()
if "torch" not in sys.modules:
    from .env import apply_env

    apply_env()

import torch  # noqa: E402

from ..core.distributed import method_names  # noqa: E402
from ..plan import plan, solver_names  # noqa: E402
from ..sparse import poisson7, poisson27, poisson125, spmv, synthetic_spd_dia, table1_matrix  # noqa: E402,E501

GENS = {"poisson7": poisson7, "poisson27": poisson27, "poisson125": poisson125}


def build_matrix(spec: str, device=None):
    name, _, arg = spec.partition(":")
    if name in GENS:
        return GENS[name](int(arg or 8), device=device)
    if name == "synthetic":
        n, _, nnz = (arg or "1000,9").partition(",")
        return synthetic_spd_dia(int(n), float(nnz or 9), device=device)
    return table1_matrix(name, scale=float(arg or 1.0), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="poisson27:12",
                    help="poisson7/27/125:N, synthetic:N,nnz_per_row or a Table-I name[:scale]")
    ap.add_argument("--method", default="pipecg", choices=solver_names(),
                    help="solver method (pcg/chronopoulos take engine auto/torch)")
    ap.add_argument("--engine", default="auto", choices=["auto", "torch", "cuda", "fused_iter"],
                    help="iteration core; fused_iter = whole-iteration kernel (pipecg, DIA)")
    ap.add_argument("--spmv-engine", default=None, choices=["auto", "torch", "cuda", "bf16"],
                    help="SPMV backend (pipecg); bf16 = half-traffic mixed precision")
    ap.add_argument("--replace-every", type=int, default=None,
                    help="residual-replacement period (pipecg; default: 0, or 50 under bf16)")
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--rtol", type=float, default=0.0)
    ap.add_argument("--maxiter", type=int, default=10000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rhs", type=int, default=1,
                    help="number of right-hand sides served through the one plan")
    ap.add_argument("--shards", type=int, default=1,
                    help="distributed methods: the number of shards")
    ap.add_argument("--devices", default=None,
                    help="distributed methods: comma-separated device per shard "
                         "(default: cuda for shard 0, cpu for the rest)")
    ap.add_argument("--partition", default="rows", choices=["rows", "nnz"],
                    help="distributed methods: equal rows, or nnz in proportion to --weights")
    ap.add_argument("--weights", default=None,
                    help="distributed methods: comma-separated relative speeds")
    ap.add_argument("--sub", type=int, default=None,
                    help="distributed methods: ranks per pod (h4 needs it)")
    args = ap.parse_args(argv)

    A = build_matrix(args.matrix, device=args.device)
    xstar = torch.ones(A.n, dtype=A.dtype, device=A.device) / A.n**0.5
    b = spmv(A, xstar)
    print(f"matrix {args.matrix}: N={A.n} nnz/N={A.nnz() / A.n:.1f} bw={A.bandwidth} "
          f"device={A.device}")

    kw = {}
    if args.method in method_names() or args.method == "pipecg_distributed":
        devices = (tuple(args.devices.split(",")) if args.devices
                   else ("cuda",) + ("cpu",) * (args.shards - 1))
        kw = {"shards": args.shards, "devices": devices, "partition": args.partition,
              "sub": args.sub, "replace_every": args.replace_every}
        if args.weights:
            kw["weights"] = [float(w) for w in args.weights.split(",")]
    elif args.shards > 1:
        ap.error(f"--method {args.method} is single-device; with --shards use one of "
                 f"{method_names()}")
    elif args.method == "pipecg":
        kw = {"replace_every": args.replace_every, "spmv_engine": args.spmv_engine}
    p = plan(A, method=args.method, engine=args.engine, M="jacobi", atol=args.atol,
             rtol=args.rtol, maxiter=args.maxiter, **kw)
    desc = p.describe()
    print("plan:", ", ".join(f"{k}={desc[k]}" for k in sorted(desc)))

    res = p.solve(b)
    if args.rhs > 1:
        B = torch.stack([(k + 1.0) * b for k in range(args.rhs)])
        batch = p.solve_batched(B)
        print(f"served {args.rhs} rhs through one plan: "
              f"iters={batch.iterations.tolist()} traces={p.trace_count}")
    err = float(torch.linalg.norm(res.x - xstar))
    true_res = float(torch.linalg.norm(b - spmv(A, res.x)))
    print(
        f"method={args.method} iters={int(res.iterations)} converged={bool(res.converged)} "
        f"|u|={float(res.residual_norm):.2e} |x-x*|={err:.2e} true_res={true_res:.2e}"
    )


if __name__ == "__main__":
    main()
