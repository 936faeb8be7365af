"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; on
the card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
The file imports neither JAX nor ``repro``: the card's machine has no JAX.
Tolerances: f32 vectors rtol/atol 1e-5; dots rtol 1e-4 with atol
1e-6·Σ|aᵢbᵢ| (f32 sums in another order); bf16 SPMV rtol 2e-2.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import (
    fused_iter_ref,
    fused_iter_step,
    fused_vma_dots,
    fused_vma_dots_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
)
from repro_torch.sparse import poisson27, poisson125

VEC = dict(rtol=1e-5, atol=1e-5)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _randn(n, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32)).to(device)


def _assert_dots(got, want, terms):
    scale = max(float(t.abs().sum()) for t in terms)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.parametrize("gen,n", [(poisson27, 37), (poisson125, 16)])
def test_spmv_matches_plain(cuda, gen, n):
    A = gen(n, device=cuda)
    x = _randn(A.n, 0, cuda)
    before = spmv_dia_cuda.launches
    torch.testing.assert_close(spmv_dia_cuda(A, x), spmv_dia_ref(A.data, A.offsets, x), **VEC)
    A16, x16 = A.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
    got = spmv_dia_cuda(A16, x16, out_dtype=torch.float32)
    torch.testing.assert_close(got, spmv_dia_ref(A16.data, A.offsets, x16, torch.float32),
                               rtol=2e-2, atol=1e-3)
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches == before + 2
    with pytest.raises(TypeError):
        spmv_dia_cuda(A.with_dtype(torch.float64), x.double())


def test_fused_vma_matches_plain_and_respects_active(cuda):
    n = 50_653  # not a multiple of the block
    vecs = [_randn(n, i, cuda) for i in range(10)]
    inv = vecs[9].abs() + 0.5
    want = fused_vma_dots_ref(*vecs, inv, 0.3, 0.6)
    work = [v.clone() for v in vecs]
    got = fused_vma_dots(*work, inv, 0.3, 0.6)
    for g, w in zip(got[:9], want[:9]):
        torch.testing.assert_close(g, w, **VEC)
    _assert_dots(got[9], want[9], (want[5] * want[6], want[7] * want[6], want[6] * want[6]))
    keep = [v.clone() for v in work]
    got = fused_vma_dots(*work, inv, 0.3, 0.6, torch.tensor(False, device=cuda))
    for v, k in zip(work, keep):
        assert torch.equal(v, k)
    assert torch.equal(got[9], torch.zeros(3, device=cuda))
    with pytest.raises(ValueError, match="share memory"):
        fused_vma_dots(*work[:8], work[0], work[9], inv, 0.3, 0.6)


def test_fused_iter_matches_plain_and_respects_active(cuda):
    A = poisson27(37, device=cuda)
    vecs = [_randn(A.n, 20 + i, cuda) for i in range(9)]
    inv = 1.0 / A.diagonal()
    want = fused_iter_ref(A.data, A.offsets, *vecs, inv, 0.3, 0.7)
    work = [v.clone() for v in vecs[:8]]
    m_out = torch.empty_like(vecs[8])
    got = fused_iter_step(A.data, A.offsets, *work, vecs[8], m_out, inv, 0.3, 0.7)
    for g, w in zip(got[:9], want[:9]):
        torch.testing.assert_close(g, w, **VEC)
    _assert_dots(got[9], torch.stack(list(want[9])),
                 (want[5] * want[6], want[7] * want[6], want[6] * want[6]))
    m_out2 = torch.empty_like(m_out)
    keep = [v.clone() for v in work]
    fused_iter_step(A.data, A.offsets, *work, m_out, m_out2, inv, 0.3, 0.7,
                    torch.tensor(False, device=cuda))
    assert torch.equal(m_out2, m_out)
    for v, k in zip(work, keep):
        assert torch.equal(v, k)


def test_solve_engines_agree_and_launch_their_kernels(cuda):
    A = poisson27(24, device=cuda)
    b = A.matvec(torch.full((A.n,), A.n ** -0.5, device=cuda))
    runs = {}
    for engine in ("auto", "cuda", "torch"):
        p = repro_torch.plan(A, engine=engine, atol=0.0, rtol=1e-3, maxiter=500)
        spmv_dia_cuda.launches = fused_vma_dots.launches = fused_iter_step.launches = 0
        res = p.solve(b)
        runs[engine] = (p.describe()["core"], int(res.iterations), res.steps,
                        spmv_dia_cuda.launches, fused_vma_dots.launches,
                        fused_iter_step.launches, bool(res.converged))
    it, steps = runs["torch"][1], runs["torch"][2]
    assert runs["auto"] == ("fused_iter", it, steps, 2, 0, steps, True)
    assert runs["cuda"] == ("cuda", it, steps, 3 + steps, steps, 0, True)
    assert runs["torch"] == ("torch", it, steps, 0, 0, 0, True)
