"""The hybrid methods on the card and the host, and the launch census.

Every test here is marked ``cuda`` and skips where there is no GPU; on the
card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_dist.py``. The file imports neither JAX nor ``repro``.

* The launch census (``obs.plan_launches_per_iteration``): hand-written
  kernel launches per solver step, 1 for ``fused_iter``, 2 for the ``cuda``
  core with the CUDA SPMV, 0 for the plain path.
* ``h3`` on one card shard equals ``plan(A, engine="cuda").solve(b)``
  (same iterations, x within 1e-5); on the card plus the host (the default
  mesh) it converges within one iteration of it, with x within 1e-4, and
  launches ``spmv_dia`` and ``fused_vma`` on the card shard.
* ``solve_batched`` on the hybrid plan: each lane has its rhs's
  ``plan.solve`` iterations and x within 1e-6.
"""
import pytest
import torch

import repro_torch
from repro_torch.kernels import (
    fused_vma_dots,
    fused_vma_dots_batched,
    spmv_dia_batched,
    spmv_dia_cuda,
)
from repro_torch.obs import plan_launches_per_iteration
from repro_torch.sparse import poisson27, spmv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _system(device, n=24):
    A = poisson27(n, device=device)
    b = spmv(A, torch.ones(A.n, device=device) / A.n**0.5)
    return A, b


@pytest.mark.parametrize("engine,want", [("fused_iter", 1), ("cuda", 2), ("torch", 0)])
def test_launch_census(cuda, engine, want):
    A, b = _system(cuda)
    p = repro_torch.plan(A, method="pipecg", engine=engine, M="jacobi")
    assert plan_launches_per_iteration(p, b) == want


def test_h3_on_one_card_shard_equals_plan_solve(cuda):
    A, b = _system(cuda)
    ref = repro_torch.plan(A, engine="cuda", atol=0.0, rtol=1e-4).solve(b)
    p = repro_torch.plan(A, method="h3", shards=1, atol=0.0, rtol=1e-4)
    assert p.describe()["mesh_devices"] == ("cuda:0",)
    res = p.solve(b)
    assert int(res.iterations) == int(ref.iterations)
    assert res.x.device == A.device
    torch.testing.assert_close(res.x, ref.x, rtol=0, atol=1e-5)


def test_h3_on_card_and_host(cuda):
    A, b = _system(cuda)
    ref = repro_torch.plan(A, engine="cuda", atol=0.0, rtol=1e-4).solve(b)
    p = repro_torch.plan(A, method="h3", shards=2, partition="nnz", weights=[0.7, 0.3],
                         atol=0.0, rtol=1e-4)
    d = p.describe()
    assert d["mesh_devices"] == ("cuda:0", "cpu") and d["shard_cores"] == ("cuda", "torch")
    spmv_dia_cuda.launches = fused_vma_dots.launches = 0
    res = p.solve(b)
    assert spmv_dia_cuda.launches > 0 and fused_vma_dots.launches > 0
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 1
    torch.testing.assert_close(res.x, ref.x, rtol=0, atol=1e-4)
    st = p.last_stats
    assert st["counts"]["allreduce.loop"] == st["steps"]  # one packed reduction a step


def test_hybrid_solve_batched_lanes(cuda):
    A, b = _system(cuda, n=20)
    g = torch.Generator(device=cuda).manual_seed(0)
    B = torch.stack([b, 1e-3 * b, spmv(A, torch.randn(A.n, device=cuda, generator=g))])
    p = repro_torch.plan(A, method="h3", shards=2, partition="nnz", weights=[0.7, 0.3],
                         atol=0.0, rtol=1e-4)
    spmv_dia_batched.launches = fused_vma_dots_batched.launches = 0
    batch = p.solve_batched(B)
    assert spmv_dia_batched.launches > 0 and fused_vma_dots_batched.launches > 0
    for lane in range(3):
        one = p.solve(B[lane])
        assert int(batch.iterations[lane]) == int(one.iterations)
        torch.testing.assert_close(batch.x[lane], one.x, rtol=0, atol=1e-6)
