"""The serving tier's lane-batched CUDA kernels and ``solve_batched`` on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; on
the card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_serve.py``. The file imports neither JAX nor
``repro``. Each batched entry is held against its plain version and,
lane by lane, against the single-rhs kernel (f32 vectors rtol/atol 1e-5,
dots rtol 1e-4 with atol 1e-6·Σ|aᵢbᵢ|, tests/test_kernels.py's); a lane
whose flag is False must come back bit for bit untouched.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import (
    fused_iter_batched,
    fused_iter_batched_ref,
    fused_iter_step,
    fused_vma_dots,
    fused_vma_dots_batched,
    fused_vma_dots_batched_ref,
    spmv_bell_batched,
    spmv_bell_batched_ref,
    spmv_bell_cuda,
    spmv_dia_batched,
    spmv_dia_batched_bf16,
    spmv_dia_cuda,
)
from repro_torch.kernels.common import BLOCK, ceil_to
from repro_torch.serve import SolverServer
from repro_torch.sparse import (
    DIAMatrix,
    bell_from_csr,
    csr_device_from_host,
    csr_from_dia,
    poisson27,
    synthetic_spd_dia,
    table1_matrix,
)

VEC = dict(rtol=1e-5, atol=1e-5)
LANES = [1, 8, 11]  # 11: two launches (8 + 3); lane 1 of 8 and 11 inactive

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _lanes(k, n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)


def _flags(k, device):
    """Lane 1 (when there is one) inactive, the others active."""
    act = torch.ones(k, dtype=torch.bool, device=device)
    if k > 1:
        act[1] = False
    return act


def _assert_dots(got, want, terms):
    scale = max(float(t.abs().sum()) for t in terms)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)


def _padded(A):
    n_pad = ceil_to(A.n, BLOCK)
    return DIAMatrix(torch.nn.functional.pad(A.data, (0, n_pad - A.n)).contiguous(), A.offsets,
                     n_pad)


@pytest.mark.parametrize("k", LANES)
def test_spmv_bell_batched(cuda, k):
    """bcsstk15, and a band wider than the lane kernel's window (the slots
    outside it gathered from X, every lane the single kernel's bits)."""
    n = 40_000
    wide = bell_from_csr(csr_from_dia(synthetic_spd_dia(n, nnz_per_row=27, bandwidth=n // 4,
                                                        seed=3, device=cuda)), device=cuda)
    assert wide.column_span > 2_000  # far beyond the window's 256-column halves
    for A in (bell_from_csr(csr_from_dia(table1_matrix("bcsstk15", device=cuda)), device=cuda),
              wide):
        X = _lanes(k, A.n, 1, cuda)
        act = _flags(k, cuda)
        before = spmv_bell_batched.launches
        Y = spmv_bell_batched(A, X, act)
        torch.cuda.synchronize()
        assert spmv_bell_batched.launches == before + -(-k // 8)
        torch.testing.assert_close(Y, spmv_bell_batched_ref(A.cols, A.vals, X, act), **VEC)
        for lane in range(k):
            want = spmv_bell_cuda(A, X[lane]) if act[lane] else torch.zeros(A.n, device=cuda)
            torch.testing.assert_close(Y[lane], want, **VEC)
            if A is wide:
                assert torch.equal(Y[lane], want), lane


@pytest.mark.parametrize("k", LANES)
def test_fused_vma_batched(cuda, k):
    n = 50_653  # not a multiple of the block
    vecs = [_lanes(k, n, 10 + i, cuda) for i in range(10)]
    inv = _lanes(1, n, 30, cuda)[0].abs() + 0.5
    alpha = torch.linspace(0.2, 0.4, k, device=cuda)
    beta = torch.linspace(0.5, 0.7, k, device=cuda)
    act = _flags(k, cuda)
    want = fused_vma_dots_batched_ref(*vecs, inv, alpha, beta)
    work = [v.clone() for v in vecs]
    before = fused_vma_dots_batched.launches
    got = fused_vma_dots_batched(*work, inv, alpha, beta, act)
    torch.cuda.synchronize()
    assert fused_vma_dots_batched.launches == before + 1
    for lane in range(k):
        if not act[lane]:
            for v, v0 in zip(work, vecs):
                assert torch.equal(v[lane], v0[lane])
            assert torch.equal(got[9][lane], torch.zeros(3, device=cuda))
            continue
        single = fused_vma_dots(*[v[lane].clone() for v in vecs], inv, alpha[lane], beta[lane])
        for g, w, s in zip(got[:9], want[:9], single[:9]):
            torch.testing.assert_close(g[lane], w[lane], **VEC)
            torch.testing.assert_close(g[lane], s, **VEC)
        _assert_dots(got[9][lane], want[9][lane],
                     (want[5][lane] * want[6][lane], want[7][lane] * want[6][lane],
                      want[6][lane] * want[6][lane]))
        _assert_dots(got[9][lane], single[9], (single[5] * single[6],))


@pytest.mark.parametrize("k", LANES)
def test_fused_iter_batched(cuda, k):
    A = _padded(poisson27(37, device=cuda))
    vecs = [_lanes(k, A.n, 40 + i, cuda) for i in range(9)]
    for v in vecs:
        v[:, 50_653:] = 0  # the padded tail is zero, as the solver keeps it
    inv = torch.nn.functional.pad(1.0 / poisson27(37, device=cuda).diagonal(), (0, A.n - 50_653))
    alpha = torch.linspace(0.2, 0.4, k, device=cuda)
    beta = torch.linspace(0.5, 0.7, k, device=cuda)
    act = _flags(k, cuda)
    want = fused_iter_batched_ref(A.data, A.offsets, *vecs, inv, alpha, beta)
    work = [v.clone() for v in vecs[:8]]
    m_out = torch.empty_like(vecs[8])
    before = fused_iter_batched.launches
    got = fused_iter_batched(A.data, A.offsets, *work, vecs[8], m_out, inv, alpha, beta, act)
    torch.cuda.synchronize()
    assert fused_iter_batched.launches == before + -(-k // 8)
    for lane in range(k):
        if not act[lane]:
            for v, v0 in zip(work, vecs[:8]):
                assert torch.equal(v[lane], v0[lane])
            assert torch.equal(m_out[lane], vecs[8][lane])
            assert torch.equal(got[9][lane], torch.zeros(3, device=cuda))
            continue
        s_out = torch.empty(A.n, device=cuda)
        single = fused_iter_step(A.data, A.offsets, *[v[lane].clone() for v in vecs[:8]],
                                 vecs[8][lane], s_out, inv, alpha[lane], beta[lane])
        for g, w, s in zip(got[:9], want[:9], single[:9]):
            torch.testing.assert_close(g[lane], w[lane], **VEC)
            torch.testing.assert_close(g[lane], s, **VEC)
        _assert_dots(got[9][lane], want[9][lane],
                     (want[5][lane] * want[6][lane], want[7][lane] * want[6][lane],
                      want[6][lane] * want[6][lane]))


def _counters():
    return (spmv_dia_cuda, spmv_dia_batched, spmv_dia_batched_bf16, fused_iter_step,
            fused_iter_batched, fused_vma_dots, fused_vma_dots_batched, spmv_bell_cuda,
            spmv_bell_batched)


def _bucket_equals_solve(p, b, launched_want):
    """A bucket of [b, 2b, 0, -b, 0.5b] through ``p.solve_batched``: the
    batched kernels alone launch, and each lane has ``p.solve``'s
    iterations and x within 1e-5 (PERF.md's serving contract)."""
    B = torch.stack([b, 2 * b, torch.zeros_like(b), -b, 0.5 * b])
    singles = [p.solve(x) for x in B]
    for f in _counters():
        f.launches = 0
    res = p.solve_batched(B)
    torch.cuda.synchronize()
    launched = {f.__name__ for f in _counters() if f.launches}
    assert launched == launched_want, launched
    assert res.iterations.tolist() == [int(s.iterations) for s in singles]
    for lane, s in enumerate(singles):
        assert bool(res.converged[lane]) == bool(s.converged)
        torch.testing.assert_close(res.x[lane], s.x, rtol=1e-5,
                                   atol=1e-5 * float(s.x.abs().max()))
    return res, singles


def test_solve_batched_launches_the_batched_kernels(cuda):
    D = poisson27(24, device=cuda)
    Bl = bell_from_csr(csr_from_dia(D), device=cuda)
    for op, method, want_batched in ((D, "pipecg", {"spmv_dia_batched", "fused_iter_batched"}),
                                     (Bl, "pipecg", {"spmv_bell_batched",
                                                     "fused_vma_dots_batched"}),
                                     (Bl, "pcg", {"spmv_bell_batched"})):
        p = repro_torch.plan(op, method=method, atol=0.0, rtol=1e-3, maxiter=500)
        b = op.matvec(torch.full((op.n,), op.n ** -0.5, device=cuda))
        B = torch.stack([b, 2 * b, torch.zeros_like(b), -b])
        singles = [p.solve(x) for x in B]
        for f in _counters():
            f.launches = 0
        res = p.solve_batched(B)
        torch.cuda.synchronize()
        launched = {f.__name__ for f in _counters() if f.launches}
        assert launched == want_batched, (method, type(op).__name__, launched)
        assert res.iterations.tolist() == [int(s.iterations) for s in singles]
        assert res.iterations[2] == 0 and bool(res.converged[2]) and not res.x[2].any()
        for lane, s in enumerate(singles):
            torch.testing.assert_close(res.x[lane], s.x, rtol=1e-4, atol=1e-5)
        assert p.trace_count == 2
    # the "bf16" engine's bucket runs the bf16 lane SPMV (its init SPMV under
    # the fused_iter core; the f32 one replaces the residual every 3
    # iterations), each lane converged and plan.solve's bits
    b = D.matvec(torch.full((D.n,), D.n ** -0.5, device=cuda))
    p = repro_torch.plan(D, method="pipecg", spmv_engine="bf16", replace_every=3, atol=0.0,
                         rtol=1e-2, maxiter=500)
    res, singles = _bucket_equals_solve(p, b, {"spmv_dia_batched_bf16", "spmv_dia_batched",
                                               "fused_iter_batched"})
    for lane, s in enumerate(singles):
        assert bool(s.converged) and torch.equal(res.x[lane], s.x), lane
    # a CSR bucket (one segment sum over the (nnz, k) products) and a dense
    # one (x @ A.mT, a GEMM where the single solve runs a GEMV)
    D10 = poisson27(10, device=cuda)
    host = csr_from_dia(D10)
    b = D10.matvec(torch.full((D10.n,), D10.n ** -0.5, device=cuda))
    for A in (csr_device_from_host(host, device=cuda),
              torch.from_numpy(host.to_dense()).to(cuda)):
        p = repro_torch.plan(A, method="pipecg", atol=0.0, rtol=1e-3, maxiter=500)
        _, singles = _bucket_equals_solve(p, b, {"fused_vma_dots_batched"})
        assert all(bool(s.converged) for s in singles), type(A).__name__


def test_server_on_the_card(cuda):
    """Every served answer is ``plan.solve``'s: pipecg on DIA, and the
    baselines (lanes reduced one by one at every step) on Bell."""
    D = poisson27(16, device=cuda)
    Bl = bell_from_csr(csr_from_dia(D), device=cuda)
    b = D.matvec(torch.full((D.n,), D.n ** -0.5, device=cuda))
    scales = [1.0, 2.0, -0.5, 3.0, 10.0, 0.1, 5.0]
    for method, A in (("pipecg", D), ("pcg", Bl), ("chronopoulos", Bl)):
        with SolverServer(max_batch=4, max_wait_ms=5.0, method=method, atol=0.0, rtol=1e-3,
                          maxiter=500) as srv:
            srv.submit(A, b).result(timeout=120)
            results = [f.result(timeout=120) for f in srv.submit_many(A, [c * b for c in scales])]
            plans = srv.plans()
        assert len(plans) == 1 and plans[0].trace_count == 2, method
        direct = repro_torch.plan(A, method=method, atol=0.0, rtol=1e-3, maxiter=500)
        for c, r in zip(scales, results):
            ref = direct.solve(c * b)
            assert r.iterations == int(ref.iterations) and r.converged, (method, c)
            torch.testing.assert_close(r.x, ref.x, rtol=1e-5, atol=1e-6 * abs(c))
