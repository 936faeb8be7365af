"""The port's whole slice against the JAX package, on the CPU.

``repro_torch.plan(A_cpu, engine=e, M="jacobi")`` against
``repro.plan(A, engine=e_jax, M="jacobi")`` for the engine pairs
(torch, jnp), (cuda, pallas) and (fused_iter, fused_iter), on the same
operator (built by the JAX package and carried across) and rhs. Required:
equal iteration counts, the NaN tail at the same index, x to rtol 1e-4 /
atol 1e-5, and the history to rtol 1e-4 with atol 1e-6·||u0||: f32
roundoff in the recurrences is absolute, so entries far below the
starting norm differ by that much however the dots are ordered.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same_solve, operator, rhs

import repro
import repro_torch
from repro_torch import convert

PAIRS = [("torch", "jnp"), ("cuda", "pallas"), ("fused_iter", "fused_iter")]


@pytest.mark.parametrize("kind", ["smooth", "random"])
@pytest.mark.parametrize("engine,jengine", PAIRS)
def test_solve_matches_jax(engine, jengine, kind):
    J, A = operator()
    b = rhs(J, kind)
    jres = repro.plan(J, engine=jengine, M="jacobi", atol=1e-6, maxiter=60).solve(jnp.asarray(b))
    p = repro_torch.plan(A, engine=engine, M="jacobi", atol=1e-6, maxiter=60)
    assert p.describe()["core"] == engine
    res = p.solve(torch.from_numpy(b))
    assert bool(res.converged)
    assert_same_solve(res, jres)


@pytest.mark.parametrize("engine,jengine", [("torch", "jnp"), ("fused_iter", "fused_iter")])
def test_identity_pc_matches_jax(engine, jengine):
    J, A = operator()
    b = rhs(J, "smooth")
    jres = repro.plan(J, engine=jengine, M="identity", atol=1e-6, maxiter=60).solve(jnp.asarray(b))
    res = repro_torch.plan(A, engine=engine, M="identity", atol=1e-6, maxiter=60).solve(
        torch.from_numpy(b))
    assert_same_solve(res, jres)


@pytest.mark.parametrize("engine,jengine", PAIRS)
def test_residual_replacement_matches_jax(engine, jengine):
    J, A = operator()
    b = rhs(J, "random")
    jres = repro.plan(J, engine=jengine, M="jacobi", atol=1e-6, maxiter=60,
                      replace_every=5).solve(jnp.asarray(b))
    p = repro_torch.plan(A, engine=engine, M="jacobi", atol=1e-6, maxiter=60, replace_every=5)
    assert p.describe()["replace_every"] == 5
    assert_same_solve(p.solve(torch.from_numpy(b)), jres)


def test_jacobi_pc_object_from_jax():
    from repro.core.preconditioners import jacobi as jjacobi

    J, A = operator()
    b = rhs(J, "smooth")
    M = convert.jacobi_from_arrays(np.asarray(jjacobi(J).inv_diag), device="cpu")
    res = repro_torch.plan(A, engine="fused_iter", M=M, atol=1e-6, maxiter=60).solve(
        torch.from_numpy(b))
    jres = repro.plan(J, engine="fused_iter", M="jacobi", atol=1e-6, maxiter=60).solve(
        jnp.asarray(b))
    assert_same_solve(res, jres)
