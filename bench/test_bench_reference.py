"""The float64 reference against dense NumPy, and the frozen operator
generator against the port's at tiny sizes."""
import numpy as np
import pytest
import torch

from bench import catalog
from bench.reference import ReferenceOperator, band_matvec

STENCIL = {"operator": "stencil", "dim": 3, "grid": 6, "radius": 2, "sigma": 1.0}


def _dense(offsets, data):
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[1]
    A = np.zeros((n, n))
    for j, o in enumerate(offsets):
        for i in range(max(0, -o), min(n, n - o)):
            A[i, i + o] = data[j, i]
    return A


def _band(cfg, seed=11, dtype=torch.float64):
    return catalog.module("operators", cfg["operator"]).band(cfg, seed, "cpu", dtype=dtype)


@pytest.mark.parametrize("grid,radius", [(6, 2), (5, 1), (7, 2)])
def test_band_matvec_against_dense(grid, radius):
    offs, data = _band(dict(STENCIL, grid=grid, radius=radius))
    x = torch.randn(data.shape[1], dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(band_matvec(offs, data, x).numpy(), _dense(offs, data) @ x.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_true_residual_and_gap_against_dense():
    offs, data = _band(STENCIL)
    A = _dense(offs, data)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.shape[0])
    x = np.linalg.solve(A, b) + 1e-3 * rng.standard_normal(A.shape[0])
    dinv = 1.0 / np.diag(A)
    want = np.linalg.norm(dinv * (b - A @ x)) / np.linalg.norm(dinv * b)
    ref = ReferenceOperator(offs, data.float())
    got = ref.judge(torch.from_numpy(b).float(), torch.from_numpy(x).float(),
                    reported_norm=0.5 * want * np.linalg.norm(dinv * b))
    assert got["true_resid"] == pytest.approx(want, rel=1e-4)
    assert got["resid_gap"] == pytest.approx(0.5 * want, rel=1e-3)


@pytest.mark.parametrize("grid", [4, 6, 7])
def test_stencil_copy_equals_the_ports_poisson125(grid):
    from repro_torch.sparse import poisson125

    want = poisson125(grid, device="cpu")
    offs, data = _band(dict(STENCIL, grid=grid), dtype=torch.float32)
    assert offs == tuple(want.offsets)
    assert torch.equal(data, want.data)

