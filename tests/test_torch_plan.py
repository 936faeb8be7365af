"""The port's plan/solve surface on the CPU: the convergence poll, the
bf16 engine, fixed counts, warm starts, ``describe()``, the plan cache,
the no-fallback rule, the CLI and the package's isolation from JAX.

Solves are held against the JAX package as in ``test_torch_solve.py``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same_solve, operator, rhs

import repro
import repro_torch
from repro_torch.core import iteration
from repro_torch.launch import solve as cli
from repro_torch.sparse import poisson27, spmv_dia

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("engine", ["torch", "fused_iter"])
def test_steps_after_convergence_change_nothing(engine, monkeypatch):
    """The no-op steps between convergence and the poll leave x, the
    count, the history and the norm exactly as a loop that stops at once."""
    J, A = operator()
    b = torch.from_numpy(rhs(J, "smooth"))
    p = repro_torch.plan(A, engine=engine, M="jacobi", atol=1e-6, maxiter=60)
    late = p.solve(b)
    monkeypatch.setattr(iteration, "POLL_EVERY", 1)
    early = p.solve(b)
    it = int(early.iterations)
    assert early.steps == it and late.steps == -(-it // 16) * 16 > it
    assert int(late.iterations) == it
    assert torch.equal(late.x, early.x)
    assert torch.equal(late.residual_norm, early.residual_norm)
    assert np.array_equal(late.history.numpy(), early.history.numpy(), equal_nan=True)


def test_bf16_spmv_engine_matches_jax():
    J, A = operator()
    b = rhs(J, "smooth")
    # rtol above the bf16 plateau (~2e-2 here), where the two runs still agree
    kw = dict(M="jacobi", atol=0.0, rtol=5e-2, maxiter=60, spmv_engine="bf16")
    jres = repro.plan(J, engine="pallas", **kw).solve(jnp.asarray(b))
    p = repro_torch.plan(A, engine="cuda", **kw)
    assert p.describe()["replace_every"] == 50
    assert_same_solve(p.solve(torch.from_numpy(b)), jres)


def test_maxiter_bound_and_fixed_count():
    J, A = operator()
    b = torch.from_numpy(rhs(J, "random"))
    res = repro_torch.plan(A, engine="cuda", atol=0.0, rtol=0.0, maxiter=7).solve(b)
    assert int(res.iterations) == 7 and res.steps == 7 and not bool(res.converged)
    assert res.history.shape == (8,) and not res.history.isnan().any()


def test_x0_warm_start_is_not_mutated():
    J, A = operator()
    b = torch.from_numpy(rhs(J, "random"))
    x0 = torch.full((A.n,), 0.1)
    keep = x0.clone()
    res = repro_torch.plan(A, engine="fused_iter", atol=1e-6, maxiter=60).solve(b, x0=x0)
    assert torch.equal(x0, keep) and bool(res.converged)
    true_res = torch.linalg.norm(b - spmv_dia(A, res.x)) / torch.linalg.norm(b)
    assert float(true_res) < 1e-3


def test_describe_keeps_jax_keys_and_names_the_core():
    J, A = operator(5)
    keys = {"method", "engine", "n", "dtype", "operator", "preconditioner", "atol", "rtol",
            "maxiter", "distributed", "core", "spmv_engine", "replace_every"}
    d = repro_torch.plan(A).describe()
    assert keys <= set(d)
    assert d["core"] == "torch" and d["dtype"] == "float32" and d["device"] == "cpu"
    jd = repro.plan(J).describe()
    assert {k: d[k] for k in keys - {"core", "spmv_engine"}} == {
        k: jd[k] for k in keys - {"core", "spmv_engine"}}
    assert repro_torch.plan(A, engine="fused_iter").describe()["core"] == "fused_iter"
    assert repro_torch.plan(A, engine="cuda").describe()["spmv_engine"] == "auto"
    with pytest.raises(ValueError, match="not ported"):
        repro_torch.plan(A, method="pcg")
    with pytest.raises(TypeError, match="does not accept"):
        repro_torch.plan(A, tile=256)
    with pytest.raises(ValueError, match="unknown iteration engine"):
        repro_torch.plan(A, engine="pallas").solve(torch.ones(A.n))


def test_one_shot_solve_reuses_cached_plan():
    _, A = operator(5)
    b = torch.ones(A.n)
    repro_torch.clear_plan_cache()
    r1 = repro_torch.solve(A, b, engine="fused_iter", atol=1e-6)
    r2 = repro_torch.solve(A, b, engine="fused_iter", atol=1e-6)
    stats = repro_torch.plan_cache_stats()
    assert stats["hits"] == 1 and stats["misses"] == 1 and stats["size"] == 1
    assert torch.equal(r1.x, r2.x)


def test_no_fallback_to_cpu():
    A = poisson27(6, device="cpu")
    res = repro_torch.plan(A, atol=1e-6).solve(torch.ones(A.n))
    assert bool(res.converged) and res.x.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            poisson27(6)
    with pytest.raises(ValueError, match="b is on"):
        repro_torch.plan(A).solve(torch.ones(A.n, device="meta"))


def test_cli_on_cpu(capsys):
    cli.main(["--matrix", "poisson27:5", "--device", "cpu", "--engine", "fused_iter",
              "--atol", "1e-6"])
    out = capsys.readouterr().out
    assert "core=fused_iter" in out and "converged=True" in out


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.plan, repro_torch.api, repro_torch.convert\n"
        "import repro_torch.launch.solve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert callable(repro_torch.plan)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_have_no_jax_or_repro_import():
    offenders = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.name}: {name}")
    assert not offenders, offenders
