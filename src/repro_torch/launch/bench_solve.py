"""Times single-rhs solves on the card: ``python -m repro_torch.launch.bench_solve``

The single-rhs rows of ``chip_smoke.py`` (phases 4 and 4b), alone and with
more repeats, so two trees can be compared on one card: copy this file to
the other tree's ``repro_torch/launch/`` and run it there too, alternating
the trees (it uses only ``repro_torch.plan``, the sparse generators and
three kernel wrappers, whose signatures both trees share).
Each row is the median, with the quartiles, of ``--repeats`` timings of one
``plan.solve(b)`` (CUDA events, as ``chip_smoke.py`` times it):

- ``poisson125(128)`` pipecg, ``auto`` (``fused_iter``) and ``cuda``, at a
  fixed 200 iterations: ms per iteration; and ``solve_batched`` of 8
  right-hand sides on the ``cuda`` core, in f32 and with
  ``spmv_engine="bf16"`` (one lane SPMV and one ``fused_vma`` lanes call a
  step): ms per batched iteration over a fifth of the repeats;
- Queen_4147 (``table1_matrix("Queen_4147")``, DIA and Bell forms), pipecg
  ``auto`` and pcg, to rtol 1e-3: ms per solve, set-up and the no-op steps
  up to the host's poll included, plus the host's wall-clock per solve;
- the same three paths at bcsstk15 (N = 3,948), where the card waits on
  the host at every step: µs per step of a fixed 64-step solve, the host's
  cost of one loop step;
- the single-rhs kernels those solves launch, through their wrappers, with
  the solve's flag on and off (``idle``: a converged solve's steps up to
  the poll): ``fused_iter`` at poisson125(128), ``spmv_bell`` and
  ``fused_vma`` at Queen_4147; ms per call over 20 calls.

Prints the card's name and power limit, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import torch

from ..kernels import fused_iter_step, fused_vma_dots, spmv_bell_cuda
from ..plan import plan
from ..sparse import bell_from_csr, csr_from_dia, poisson125, spmv, table1_matrix


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def _timed(fn, repeats: int):
    """CUDA-event ms and host wall ms of each of ``repeats`` calls."""
    fn()
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return dev_ms, wall_ms


def _per_call(fn, repeats: int, reps: int = 20):
    """Quartiles of the CUDA-event ms per call over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return _quartiles(out)


def _kernel_rows(rows, label, fn, repeats, dev):
    """``fn(active)`` timed with the flag on and off."""
    for name, flag in (("", True), (" idle", False)):
        active = torch.tensor(flag, device=dev)
        rows[f"{label}{name} ms/call"] = _per_call(lambda: fn(active), repeats)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=25)
    ap.add_argument("--label", default="", help="a name for this run in the JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_solve needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    dev = torch.device("cuda")
    rows = {}

    A = poisson125(128, device=dev)
    b = spmv(A, torch.full((A.n,), 1.0 / math.sqrt(A.n), device=dev))
    for engine in ("auto", "cuda"):
        p = plan(A, method="pipecg", engine=engine, M="jacobi", atol=0.0, rtol=0.0, maxiter=200)
        dev_ms, _ = _timed(lambda: p.solve(b), args.repeats)
        rows[f"poisson125 {engine} ms/iteration"] = _quartiles([t / 200 for t in dev_ms])
    B = torch.stack([(1.0 + 0.25 * lane) * b for lane in range(8)])
    for label, kw in (("cuda", {}), ("cuda+bf16", {"spmv_engine": "bf16"})):
        p = plan(A, method="pipecg", engine="cuda", M="jacobi", atol=0.0, rtol=0.0, maxiter=200,
                 **kw)
        dev_ms, _ = _timed(lambda: p.solve_batched(B), max(5, args.repeats // 5))
        rows[f"poisson125 k=8 {label} ms/batched iteration"] = _quartiles([t / 200 for t in dev_ms])
    del B
    # alpha = beta = 0 keeps the repeated updates bounded
    vecs = [torch.rand(A.n, device=dev) for _ in range(11)]
    zero = torch.zeros((), device=dev)
    _kernel_rows(rows, "poisson125 fused_iter", lambda act: fused_iter_step(
        A.data, A.offsets, *vecs, zero, zero, act), args.repeats, dev)
    del A, b, p, vecs
    torch.cuda.empty_cache()

    Q = table1_matrix("Queen_4147", device=dev)
    QB = bell_from_csr(csr_from_dia(Q), device=dev)
    qb = spmv(Q, torch.full((Q.n,), 1.0 / math.sqrt(Q.n), device=dev))
    for label, op, method in (("dia-auto", Q, "pipecg"), ("bell-auto", QB, "pipecg"),
                              ("pcg", QB, "pcg")):
        p = plan(op, method=method, engine="auto", M="jacobi", atol=0.0, rtol=1e-3, maxiter=2000)
        res = p.solve(qb)
        dev_ms, wall_ms = _timed(lambda: p.solve(qb), args.repeats)
        rows[f"Queen_4147 {label} ms/solve"] = dict(
            _quartiles(dev_ms), iterations=int(res.iterations), steps=int(res.steps),
            wall=_quartiles(wall_ms))
    S = table1_matrix("bcsstk15", device=dev)
    SB = bell_from_csr(csr_from_dia(S), device=dev)
    sb = spmv(S, torch.ones(S.n, device=dev))
    for label, op, method in (("dia-auto", S, "pipecg"), ("bell-auto", SB, "pipecg"),
                              ("pcg", SB, "pcg")):
        p = plan(op, method=method, engine="auto", M="jacobi", atol=0.0, rtol=0.0, maxiter=64)
        dev_ms, _ = _timed(lambda: p.solve(sb), args.repeats)
        rows[f"bcsstk15 {label} us/step"] = _quartiles([t / 64 * 1e3 for t in dev_ms])
    x = torch.rand(QB.n, device=dev)
    _kernel_rows(rows, "Queen_4147 spmv_bell", lambda act: spmv_bell_cuda(QB, x, act),
                 args.repeats, dev)
    vecs = [torch.rand(QB.n, device=dev) for _ in range(11)]
    _kernel_rows(rows, "Queen_4147 fused_vma", lambda act: fused_vma_dots(*vecs, zero, zero, act),
                 args.repeats, dev)
    print(json.dumps({"label": args.label, "card": card, "torch": torch.__version__,
                      "repeats": args.repeats, "rows": rows}))


if __name__ == "__main__":
    main()
