"""The port's SPMV layer against the JAX package, on the CPU.

The plain DIA SPMV must be bitwise equal to ``repro.sparse.spmv.spmv_dia``
(the same f32 operations in the same order); the bf16 SPMV agrees to the
bf16 band (rtol 2e-2); the engine registry resolves and refuses names.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jsp
from repro_torch import convert
from repro_torch import sparse as tsp

GENS = [("poisson7", 6), ("poisson27", 6), ("poisson27", 7), ("poisson125", 8)]


def _pair(name, n):
    J = getattr(jsp, name)(n)
    return J, convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")


@pytest.mark.parametrize("name,n", GENS)
def test_plain_spmv_bitwise_equal_to_jax(name, n):
    J, A = _pair(name, n)
    x = np.random.default_rng(1).standard_normal(A.n).astype(np.float32)
    got = tsp.spmv_dia(A, torch.from_numpy(x)).numpy()
    # eager, op by op: under jit XLA may contract or reorder the sums
    want = np.asarray(jsp.spmv_dia(J, jnp.asarray(x)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,n", GENS)
def test_bf16_spmv_matches_jax(name, n):
    J, A = _pair(name, n)
    x = np.random.default_rng(2).standard_normal(A.n).astype(np.float32)
    got = tsp.spmv_dia_bf16(A, torch.from_numpy(x))
    want = np.asarray(jax.jit(jsp.spmv_dia_bf16)(J, jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-5)


def test_engines_on_cpu():
    A = tsp.poisson27(6, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(A.n).astype(np.float32))
    assert tsp.spmv_engines(A) == ("bf16", "cuda", "torch")
    assert tsp.resolve_engine(A, "auto") == "torch"  # the caller put A on the CPU
    assert tsp.resolve_engine(A, "cuda") == "cuda"
    with pytest.raises(ValueError, match="no SPMV engine"):
        tsp.resolve_engine(A, "pallas")
    # the kernel wrapper runs its plain version for CPU tensors
    assert torch.equal(tsp.spmv(A, x, engine="cuda"), tsp.spmv_dia(A, x))
    assert torch.equal(A.matvec(x), tsp.spmv_dia(A, x))
    with pytest.raises(ValueError, match="already registered"):
        tsp.register_spmv(tsp.DIAMatrix, "torch", tsp.spmv_dia)
    # a dense tensor takes the dense fallback; an object with no matvec raises
    assert torch.equal(tsp.spmv(2 * torch.eye(3), torch.ones(3)), torch.full((3,), 2.0))
    with pytest.raises(TypeError, match="unsupported matrix"):
        tsp.spmv(object(), torch.ones(3))
