"""The port's baselines and general-format PIPECG against the JAX package,
on the CPU.

pcg and chronopoulos on the DIA, Bell and CSR forms of one operator;
pipecg on Bell and CSR through the torch and cuda cores (on the CPU the
cuda core's wrapper runs its plain version, against JAX's Pallas core in
interpret mode); block-Jacobi, its blocks and a solve on the cuda core.
Every solve is held to ``torch_parity.assert_same_solve``: equal
iterations and NaN tail, history rtol 1e-4 above 1e-6·||u0||, x rtol
1e-4 / atol 1e-5. Blocks: rtol 1e-5 (float32 LU in another library).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same_solve, operator, rhs

import repro
import repro.sparse as jsp
from repro.core.preconditioners import block_jacobi as jblock_jacobi
import repro_torch
from repro_torch import sparse as tsp
from repro_torch.core import block_jacobi
from repro_torch.plan import register_solver

KW = dict(M="jacobi", atol=1e-6, maxiter=60)
# JAX's built-in solver names, read when this file is imported. Pytest
# collects every test file (on each xdist worker too) before it runs any
# test, and no test file registers a solver at import, so the names that
# other files' tests register in JAX's process-global registry
# (tests/test_plan.py's "_plan_test_*", tests/test_unified_solver.py's
# "diag") are not among them, whichever file runs first.
JAX_BUILTIN_NAMES = repro.solver_names()


def _assert_port_has_jax_builtin_names():
    """The port's solver names are exactly JAX's built-in ones."""
    assert repro_torch.solver_names() == JAX_BUILTIN_NAMES


def _forms(fmt):
    """The JAX and port operators of poisson27(7) in DIA, Bell or CSR form."""
    J, A = operator()
    if fmt == "dia":
        return J, A
    jc, tc = jsp.csr_from_dia(J), tsp.csr_from_dia(A)
    if fmt == "bell":
        return jsp.bell_from_csr(jc), tsp.bell_from_csr(tc, device="cpu")
    return jsp.csr_device_from_host(jc), tsp.csr_device_from_host(tc, device="cpu")


@pytest.mark.parametrize("fmt", ["dia", "bell", "csr"])
@pytest.mark.parametrize("method", ["pcg", "chronopoulos"])
def test_baseline_matches_jax(method, fmt):
    JA, TA = _forms(fmt)
    b = rhs(operator()[0], "random")
    jres = repro.plan(JA, method=method, **KW).solve(jnp.asarray(b))
    p = repro_torch.plan(TA, method=method, **KW)
    res = p.solve(torch.from_numpy(b))
    assert bool(res.converged) and res.steps == -(-int(res.iterations) // 16) * 16
    assert_same_solve(res, jres)
    d = p.describe()
    assert d["operator"] == type(TA).__name__ and "core" not in d
    assert d["spmv"] == ("segsum" if fmt == "csr" else "torch")


@pytest.mark.parametrize("fmt,engine,jengine", [("bell", "torch", "jnp"), ("bell", "cuda", "pallas"),
                                                ("csr", "cuda", "pallas")])
def test_pipecg_general_format_matches_jax(fmt, engine, jengine):
    JA, TA = _forms(fmt)
    b = rhs(operator()[0], "smooth")
    jres = repro.plan(JA, engine=jengine, **KW).solve(jnp.asarray(b))
    p = repro_torch.plan(TA, engine=engine, **KW)
    assert p.describe()["core"] == engine
    assert p.describe()["spmv"] == ("segsum" if fmt == "csr" else "torch")
    assert_same_solve(p.solve(torch.from_numpy(b)), jres)


@pytest.mark.parametrize("fmt", ["dia", "bell"])
def test_block_jacobi_blocks_match_jax(fmt):
    JA, TA = _forms(fmt)
    jM, M = jblock_jacobi(JA, block=7), block_jacobi(TA, block=7)
    assert M.block == jM.block == 7 and M.inv_blocks.dtype == torch.float32
    np.testing.assert_allclose(M.inv_blocks.numpy(), np.asarray(jM.inv_blocks), rtol=1e-5,
                               atol=1e-7)
    r = np.random.default_rng(5).standard_normal(TA.n).astype(np.float32)
    from repro.core.preconditioners import apply_pc as japply
    from repro_torch.core import apply_pc

    np.testing.assert_allclose(apply_pc(M, torch.from_numpy(r)).numpy(),
                               np.asarray(japply(jM, jnp.asarray(r))), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        block_jacobi(TA, block=5)


@pytest.mark.parametrize("fmt", ["dia", "bell"])
def test_block_jacobi_on_the_cuda_core_matches_pallas(fmt):
    """The cuda core takes inv_diag=None (unit diagonal in the kernel, then
    m = M^-1 w in the loop), as the JAX Pallas core does."""
    JA, TA = _forms(fmt)
    b = rhs(operator()[0], "random")
    # f32 roundoff moves this history by up to 4e-3 relative near 1e-6 (in
    # JAX between its own engines too; float64 lies between): the limit
    # sits where no f32 run of either package crosses it marginally
    kw = dict(atol=2.5e-6, maxiter=60)
    jres = repro.plan(JA, engine="pallas", M=jblock_jacobi(JA, block=7), **kw).solve(
        jnp.asarray(b))
    p = repro_torch.plan(TA, engine="cuda", M=block_jacobi(TA, block=7), **kw)
    assert p.describe()["core"] == "cuda" and p.describe()["preconditioner"] == "BlockJacobiPC"
    res = p.solve(torch.from_numpy(b))
    assert bool(res.converged)
    assert_same_solve(res, jres)


def test_method_and_engine_rules_match_jax():
    JA, TA = _forms("bell")
    J, A = operator()
    b = rhs(J, "smooth")
    for jA, tA, meth, jeng, teng in ((JA, TA, "pcg", "pallas", "cuda"),
                                     (J, A, "chronopoulos", "fused_iter", "fused_iter")):
        with pytest.raises(ValueError, match=f"has no '{jeng}' backend"):
            repro.plan(jA, method=meth, engine=jeng).solve(jnp.asarray(b))
        with pytest.raises(ValueError, match=f"has no '{teng}' backend"):
            repro_torch.plan(tA, method=meth, engine=teng).solve(torch.from_numpy(b))
    for mod, ops in ((repro, (JA, J)), (repro_torch, (TA, A))):
        with pytest.raises(TypeError, match="needs a DIAMatrix"):
            mod.plan(ops[0], engine="fused_iter")
        M = (jblock_jacobi if mod is repro else block_jacobi)(ops[1], block=7)
        with pytest.raises(ValueError, match="elementwise preconditioner"):
            mod.plan(ops[1], engine="fused_iter", M=M)
    with pytest.raises(TypeError, match="does not accept"):
        repro_torch.plan(A, method="pcg", spmv_engine="cuda")
    _assert_port_has_jax_builtin_names()
    with pytest.raises(ValueError, match="already registered"):
        register_solver("pcg", lambda *a, **k: None)
    res = repro_torch.solve(TA, torch.from_numpy(b), method="chronopoulos", atol=1e-6)
    assert bool(res.converged)


def test_solver_names_hold_whatever_jax_registered_since():
    """A name registered in JAX's registry by another test, before or
    after this comparison, does not move it (a filter by name prefix
    failed on tests/test_unified_solver.py's "diag")."""
    from repro.plan import _SOLVERS as jax_registry

    name = "_names_probe"
    assert name not in JAX_BUILTIN_NAMES and "pcg" in JAX_BUILTIN_NAMES
    _assert_port_has_jax_builtin_names()
    repro.register_solver(name, lambda *a, **k: None)
    try:
        assert name in repro.solver_names()
        _assert_port_has_jax_builtin_names()
    finally:
        del jax_registry[name]
    assert name not in repro.solver_names()
    _assert_port_has_jax_builtin_names()
