"""Iterations to a tolerance near f32's floor: other orders of summation
of the dots, another rounding of the SPMV, and the hybrid meshes.

    PYTHONPATH=src python -m repro_torch.launch.sum_order --device cpu

Solves poisson27(24) (b = A·1/√N, atol 0, Jacobi-PIPECG) at each
``--rtols`` value. In float32 on ``--device``:

* the plan's own solve (``repro_torch.plan``; engine ``cuda`` on the
  card, ``torch`` on the host);
* the plain loop (``run_pipecg`` with the plain core), its three dots
  summed as the core sums them, over B blocks added in block order (the
  partials of B equal shards, as a mesh reducer adds them), and over a
  seeded permutation of the rows; and once with each SPMV computed in
  float64 and rounded once to float32;
* ``h3`` on two shards, rows cut by nnz at weights 0.7 / 0.3 (shard 0 on
  ``--device``, shard 1 on the host), and on four equal shards.

Then in float64 on the host: the plan's solve and the same two ``h3``
meshes, all shards on the host (the card's kernels take float32 only).
Far above float64's floor, a mesh that splits the SPMV and the dots
right takes the single solve's iterations, and its x agrees to rounding.

Each line prints the iterations, whether the solve converged, and
max |x - x_plan|; the last line per tolerance and dtype gives the spread.
Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

import repro_torch
from ..core.iteration import dot_f32, run_pipecg, torch_core
from ..sparse import DIAMatrix, poisson27, spmv


def _blocked(blocks: int):
    def dot(a, b):
        total = None
        for a_, b_ in zip(a.chunk(blocks), b.chunk(blocks)):
            part = dot_f32(a_, b_)
            total = part if total is None else total + part
        return total
    return dot


def _permuted(n: int, seed: int, device):
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).to(device)
    return lambda a, b: dot_f32(a[perm], b[perm])


def _core_with(dot):
    """The plain core, its three dots summed by ``dot``."""
    def core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
        *vecs, _ = torch_core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active)
        r_, u_, w_ = vecs[5], vecs[6], vecs[7]
        return (*vecs, (dot(r_, u_), dot(w_, u_), dot(u_, u_)))
    return core


def _solves(A, b, rtol, engine, orders, meshes, spmv_once):
    """One tolerance's rows: the plan, the plain loop per order of the
    dots (and with the SPMV rounded once), and the h3 meshes."""
    dt = str(A.dtype).removeprefix("torch.")
    ref = repro_torch.plan(A, engine=engine, M="jacobi", atol=0.0, rtol=rtol).solve(b)
    counts = {}

    def line(label, iters, conv, x):
        counts[label] = int(iters)
        print(f"rtol={rtol:g} {dt} {label}: iterations={int(iters)} converged={bool(conv)} "
              f"max|x-x_plan|={float((x - ref.x).abs().max()):.3e}")

    line("plan", ref.iterations, ref.converged, ref.x)
    inv = 1.0 / A.diagonal()
    plain = lambda v, active=None: spmv(A, v, engine="torch")  # noqa: E731
    loops = [(f"plain loop, dots {k}", dot, plain) for k, dot in orders.items()]
    if spmv_once is not None:
        loops.append(("plain loop, SPMV in float64 rounded once", dot_f32, spmv_once))
    for label, dot, sp in loops:
        it, x, _, conv, _, _ = run_pipecg(
            b, torch.zeros_like(b), spmv_fn=sp, pc_fn=lambda r: inv * r, core=_core_with(dot),
            inv_diag=inv, atol=0.0, rtol=rtol, maxiter=2000)
        line(label, it, conv, x)
    for label, kw in meshes:
        res = repro_torch.plan(A, method="h3", M="jacobi", atol=0.0, rtol=rtol, **kw).solve(b)
        line(label, res.iterations, res.converged, res.x)
    dots = [v for k, v in counts.items() if k.startswith("plain loop, dots")]
    spread = f"the dots' orders {min(dots)}..{max(dots)}, " if dots else ""
    print(f"rtol={rtol:g} {dt} spread: {spread}all {min(counts.values())}..{max(counts.values())}")


def _meshes(dev):
    return (("h3 2 shards nnz 0.7/0.3", dict(shards=2, partition="nnz", weights=[0.7, 0.3],
                                             devices=(dev, "cpu"))),
            ("h3 4 equal shards", dict(shards=4, devices=(dev,) + ("cpu",) * 3)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--grid", type=int, default=24, help="poisson27 grid side")
    ap.add_argument("--rtols", default="1e-5,1e-4")
    args = ap.parse_args(argv)

    A = poisson27(args.grid, device=args.device)
    dev = A.device
    b = spmv(A, torch.ones(A.n, device=dev) / A.n**0.5)
    engine = "cuda" if dev.type == "cuda" else "torch"
    print(f"poisson27({args.grid}): N={A.n}, device {dev}, plan engine {engine}")
    orders = {"as the core sums": dot_f32}
    orders.update({f"{k} blocks": _blocked(k) for k in (2, 4, 8, 16)})
    orders.update({f"permutation {s}": _permuted(A.n, s, dev) for s in (0, 1, 2)})
    A64 = DIAMatrix(A.data.double(), A.offsets, A.n)
    once = lambda v, active=None: spmv(A64, v.double(), engine="torch").float()  # noqa: E731
    H64 = DIAMatrix(A.data.double().cpu(), A.offsets, A.n)
    b64 = spmv(H64, torch.ones(A.n, dtype=torch.float64) / A.n**0.5)
    for rtol in (float(v) for v in args.rtols.split(",")):
        _solves(A, b, rtol, engine, orders, _meshes(dev), once)
        _solves(H64, b64, rtol, "torch", {}, _meshes("cpu"), None)


if __name__ == "__main__":
    main()
