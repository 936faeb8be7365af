"""Shared helpers of the port's solve tests: the operator and rhs, built
with the JAX package and carried across, and the parity assertion."""
import jax.numpy as jnp
import numpy as np
import torch

import repro.sparse as jsp
from repro_torch import convert


def operator(n=7):
    J = jsp.poisson27(n)
    return J, convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")


def rhs(J, kind):
    if kind == "smooth":
        b = np.asarray(jsp.spmv_dia(J, jnp.ones(J.n) / np.sqrt(J.n)))
    else:
        b = np.random.default_rng(0).standard_normal(J.n).astype(np.float32)
    return np.array(b, np.float32)


def assert_same_solve(res, jres):
    """Equal iterations and NaN tail; history rtol 1e-4 with atol
    1e-6·||u0||; x rtol 1e-4, atol 1e-5."""
    it = int(jres.iterations)
    assert int(res.iterations) == it
    assert res.iterations.dtype == torch.int32
    h, jh = res.history.numpy(), np.asarray(jres.history)
    assert h.dtype == np.float32 and h.shape == jh.shape
    assert np.isnan(h[it + 1:]).all() and np.isnan(jh[it + 1:]).all()
    assert not np.isnan(h[: it + 1]).any()
    np.testing.assert_allclose(h[: it + 1], jh[: it + 1], rtol=1e-4, atol=1e-6 * jh[0])
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-4, atol=1e-5)
    assert bool(res.converged) == bool(jres.converged)
    np.testing.assert_allclose(float(res.residual_norm), float(jres.residual_norm),
                               rtol=1e-4, atol=1e-6 * jh[0])
