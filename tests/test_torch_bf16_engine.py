"""The bf16 SPMV engine's stall on poisson125 (``spmv_engine="bf16"``), in
both packages on the CPU: the port's and the JAX package's Jacobi-PIPECG
at poisson125(16) (N = 4,096), b = A 1/sqrt(N), rtol 1e-2, replace_every
5, 10 and 50, 100 iterations at most.

Both packages converge at replace_every 5, in 11 iterations, and neither
does at 10 or 50: the residual the pipelined recurrences carry drifts
from b - A x under bf16 SPMV error until it grows (to 0.5-5x the initial
norm), and only a replacement every 5 steps holds it down. So the stall
is a fact of the bf16 engine, not of the port. Iteration counts and
convergence are pinned, equal in both packages; the final residual norms
agree within a factor of 3 (the f32 sums, in another order, move where a
diverging run ends).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.sparse as jsp
import repro_torch
from repro_torch import convert

N_GRID, RTOL, MAXITER = 16, 1e-2, 100
PINNED = {5: (11, True), 10: (MAXITER, False), 50: (MAXITER, False)}


@pytest.fixture(scope="module")
def system():
    J = jsp.poisson125(N_GRID)
    A = convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")
    b = np.asarray(jsp.spmv_dia(J, jnp.ones(J.n) / np.sqrt(J.n)), np.float32)
    return J, A, b


@pytest.mark.parametrize("replace_every", sorted(PINNED))
def test_bf16_engine_counts_equal_jax(system, replace_every):
    J, A, b = system
    kw = dict(method="pipecg", M="jacobi", atol=0.0, rtol=RTOL, maxiter=MAXITER,
              spmv_engine="bf16", replace_every=replace_every)
    jres = repro.plan(J, **kw).solve(jnp.asarray(b))
    res = repro_torch.plan(A, **kw).solve(torch.from_numpy(b))
    want = PINNED[replace_every]
    assert (int(jres.iterations), bool(jres.converged)) == want
    assert (int(res.iterations), bool(res.converged)) == want
    r, jr = float(res.residual_norm), float(jres.residual_norm)
    assert jr / 3 < r < 3 * jr
    if not want[1]:  # the stall: the residual ends above a tenth of its start
        assert r > 0.1 * float(res.history[0]) and jr > 0.1 * float(jres.history[0])
