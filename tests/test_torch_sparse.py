"""The port's sparse containers and generators against the JAX package,
on the CPU: the generators must give the JAX package's bits, and the
numpy carry-across (``repro_torch.convert``) must round-trip.
"""
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
def test_generators_match_jax_bits(name, n):
    A = getattr(tsp, name)(n, device="cpu")
    J = getattr(jsp, name)(n)
    assert A.offsets == J.offsets and A.n == J.n
    assert A.data.dtype == torch.float32
    assert np.array_equal(A.data.numpy(), np.asarray(J.data))
    assert A.bandwidth == J.bandwidth and A.nnz() == J.nnz()
    assert np.array_equal(A.diagonal().numpy(), np.asarray(J.diagonal()))


def test_stencil_offsets_match_jax():
    assert tsp.stencil_offsets(3, 5, 2) == jsp.stencil_offsets(3, 5, 2)


def test_float64_generator_matches_numpy_build():
    A = tsp.poisson27(5, device="cpu", dtype=torch.float64)
    J = jsp.poisson27(5, dtype=jnp.float32)
    np.testing.assert_array_equal(A.data.numpy().astype(np.float32), np.asarray(J.data))


def test_dia_from_arrays_round_trip():
    J, A = _pair("poisson27", 6)
    back = convert.dia_from_arrays(A.data.numpy(), A.offsets, A.n, device="cpu")
    assert back.offsets == J.offsets and back.n == J.n
    assert np.array_equal(back.data.numpy(), np.asarray(J.data))
    half = convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu",
                                   dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape"):
        convert.dia_from_arrays(np.asarray(J.data)[:, :-1], J.offsets, J.n, device="cpu")


def test_jacobi_from_arrays_round_trip():
    from repro.core.preconditioners import jacobi as jjacobi
    from repro_torch.core.preconditioners import jacobi

    J, A = _pair("poisson27", 6)
    inv = np.asarray(jjacobi(J).inv_diag)
    M = convert.jacobi_from_arrays(inv, device="cpu")
    assert np.array_equal(M.inv_diag.numpy(), inv)
    assert np.array_equal(jacobi(A).inv_diag.numpy(), inv)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsp.poisson27(6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.dia_from_arrays(np.zeros((1, 4), np.float32), (0,), 4, device=None)
