"""Solver launcher: ``python -m repro_torch.launch.solve --matrix poisson125:64``

Thin CLI over the plan/execute API: builds one ``repro_torch.plan``
(printed via ``plan.describe()``), then solves ``A x = A x*`` with
``x* = ones / sqrt(N)``. Single device, method pipecg. Runs on CUDA
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from ..plan import plan
from ..sparse import poisson7, poisson27, poisson125, spmv

GENS = {"poisson7": poisson7, "poisson27": poisson27, "poisson125": poisson125}


def build_matrix(spec: str, device=None):
    name, _, arg = spec.partition(":")
    if name not in GENS:
        raise ValueError(f"unknown matrix {name!r}; have {sorted(GENS)}")
    return GENS[name](int(arg or 8), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="poisson27:12", help="poisson7/27/125:N")
    ap.add_argument("--engine", default="auto", choices=["auto", "torch", "cuda", "fused_iter"],
                    help="iteration core; fused_iter = whole-iteration kernel")
    ap.add_argument("--spmv-engine", default=None, choices=["auto", "torch", "cuda", "bf16"],
                    help="SPMV backend; bf16 = half-traffic mixed precision")
    ap.add_argument("--replace-every", type=int, default=None,
                    help="residual-replacement period (default: 0, or 50 under bf16)")
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--rtol", type=float, default=0.0)
    ap.add_argument("--maxiter", type=int, default=10000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    A = build_matrix(args.matrix, device=args.device)
    xstar = torch.ones(A.n, dtype=A.dtype, device=A.device) / A.n**0.5
    b = spmv(A, xstar)
    print(f"matrix {args.matrix}: N={A.n} nnz/N={A.nnz() / A.n:.1f} bw={A.bandwidth} "
          f"device={A.device}")

    p = plan(A, method="pipecg", engine=args.engine, M="jacobi", atol=args.atol,
             rtol=args.rtol, maxiter=args.maxiter, replace_every=args.replace_every,
             spmv_engine=args.spmv_engine)
    desc = p.describe()
    print("plan:", ", ".join(f"{k}={desc[k]}" for k in sorted(desc)))

    res = p.solve(b)
    err = float(torch.linalg.norm(res.x - xstar))
    true_res = float(torch.linalg.norm(b - spmv(A, res.x)))
    print(
        f"method=pipecg iters={int(res.iterations)} converged={bool(res.converged)} "
        f"|u|={float(res.residual_norm):.2e} |x-x*|={err:.2e} true_res={true_res:.2e}"
    )


if __name__ == "__main__":
    main()
