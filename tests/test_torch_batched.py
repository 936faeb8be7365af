"""The port's lane-batched solves and kernels against the JAX package, on the CPU.

``SolverPlan.solve_batched`` runs k right-hand sides as one lane-batched
loop; the JAX package runs ``jax.vmap`` of its solve. Both see the same
numpy rhs ``[b, 2b, -b, 0, 1e-8 b]``: the zero lane (the server's
padding) and the tiny one start inactive. Per lane: equal iterations and
NaN tail, history rtol 1e-4 above 1e-6·||u0|| of that lane, x rtol 1e-4
/ atol 1e-5 (``torch_parity.assert_same_solve``, f32 sums in another
order). The batched plain kernel versions are held lane by lane against
the single-rhs plain versions (equal bits: the same operations) and
against the JAX package's interpret-mode Pallas kernels under
``jax.vmap`` (f32 vectors rtol/atol 1e-5, dots rtol 1e-4 / atol 1e-3, as
``tests/test_torch_kernels.py``). The CUDA entries are held against these
plain versions on the card in ``tests/test_torch_cuda_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same_solve, operator, rhs

import repro
import repro.kernels as jk
import repro.sparse as jsp
import repro_torch
from repro.kernels.common import ceil_to as jceil_to
from repro_torch import convert
from repro_torch import sparse as tsp
from repro_torch.kernels import (
    fused_iter_batched,
    fused_iter_batched_ref,
    fused_iter_ref,
    fused_vma_dots_batched,
    fused_vma_dots_batched_ref,
    fused_vma_dots_ref,
    spmv_bell_batched,
    spmv_bell_batched_ref,
    spmv_bell_ref,
    spmv_dia_batched,
    spmv_dia_batched_bf16,
    spmv_dia_batched_bf16_ref,
    spmv_dia_batched_ref,
    spmv_dia_ref,
)

KW = dict(M="jacobi", atol=1e-5, maxiter=100)
SCALES = (1.0, 2.0, -1.0, 0.0, 1e-8)
VEC = dict(rtol=1e-5, atol=1e-5)
DOTS = dict(rtol=1e-4, atol=1e-3)
TILE = 256  # small Pallas tile: several grid steps


def _lanes(result, k):
    """The k single-rhs SolveResults inside a batched one."""
    f = ("x", "iterations", "residual_norm", "converged", "history")
    return [dataclasses.replace(result, **{n: getattr(result, n)[i] for n in f})
            for i in range(k)]


def _jax_lanes(jres, k):
    return [type(jres)(**{n: getattr(jres, n)[i] for n in ("x", "iterations", "residual_norm",
                                                            "converged", "history")})
            for i in range(k)]


def _batch(J):
    b = rhs(J, "smooth")
    return np.stack([c * b for c in SCALES]).astype(np.float32)


def _assert_lanes_match(res, jres, B):
    k = B.shape[0]
    assert res.x.shape == B.shape and res.history.shape[0] == k
    assert res.iterations.tolist() == [int(i) for i in np.asarray(jres.iterations)]
    for lane, (r, j) in enumerate(zip(_lanes(res, k), _jax_lanes(jres, k))):
        if not B[lane].any():  # the zero lane: no iteration, x = 0, no NaN in it
            assert int(r.iterations) == 0 and bool(r.converged) and not r.x.any()
            assert np.isnan(r.history.numpy()[1:]).all() and float(r.history[0]) == 0.0
            continue
        assert_same_solve(r, j)


@pytest.mark.parametrize("engine", ["torch", "cuda", "fused_iter"])
def test_dia_solve_batched_matches_jax(engine):
    J, A = operator(6)
    B = _batch(J)
    jres = repro.plan(J, engine="jnp", **KW).solve_batched(jnp.asarray(B))
    p = repro_torch.plan(A, engine=engine, **KW)
    res = p.solve_batched(torch.from_numpy(B))
    _assert_lanes_match(res, jres, B)
    assert torch.isfinite(res.x).all() and torch.isfinite(res.residual_norm).all()
    # each lane is the single solve of that rhs, bit for bit (the same operations)
    for lane, single in enumerate(torch.from_numpy(B)):
        s = p.solve(single)
        assert int(s.iterations) == int(res.iterations[lane])
        assert torch.equal(s.x, res.x[lane])


def _bell_forms(scale=0.04):
    J = jsp.table1_matrix("bcsstk15", scale=scale)
    A = tsp.table1_matrix("bcsstk15", scale=scale, device="cpu")
    return (J, jsp.bell_from_csr(jsp.csr_from_dia(J)),
            tsp.bell_from_csr(tsp.csr_from_dia(A), device="cpu"))


@pytest.mark.parametrize("method,engine,jengine", [("pipecg", "cuda", "pallas"),
                                                   ("pcg", "auto", "auto"),
                                                   ("chronopoulos", "auto", "auto")])
def test_bell_solve_batched_matches_jax(method, engine, jengine):
    J, JB, TB = _bell_forms()
    B = _batch(J)
    kw = dict(KW, atol=1e-6)
    jres = repro.plan(JB, method=method, engine=jengine, **kw).solve_batched(jnp.asarray(B))
    res = repro_torch.plan(TB, method=method, engine=engine, **kw).solve_batched(
        torch.from_numpy(B))
    _assert_lanes_match(res, jres, B)


def test_warm_start_x0_matches_jax():
    J, A = operator(6)
    B = _batch(J)[:3]
    X0 = np.random.default_rng(3).standard_normal(B.shape).astype(np.float32) * 0.01
    jres = repro.plan(J, engine="jnp", **KW).solve_batched(jnp.asarray(B), jnp.asarray(X0))
    x0 = torch.from_numpy(X0.copy())
    res = repro_torch.plan(A, engine="fused_iter", **KW).solve_batched(torch.from_numpy(B), x0)
    assert torch.equal(x0, torch.from_numpy(X0))  # the caller's x0 is not written
    _assert_lanes_match(res, jres, B)


def test_trace_count_steady_like_jax():
    J, A = operator(5)
    B = _batch(J)[:3]
    jp = repro.plan(J, engine="jnp", **KW)
    p = repro_torch.plan(A, **KW)
    for _ in range(3):
        jp.solve(jnp.asarray(B[0]))
        jp.solve_batched(jnp.asarray(B))
        p.solve(torch.from_numpy(B[0]))
        p.solve_batched(torch.from_numpy(B), atol=1e-6)  # tolerances build nothing new
    assert p.trace_count == jp.trace_count == 2
    assert p.describe()["trace_count"] == 2
    p.solve_batched(torch.from_numpy(B[:2]))  # a second batch size: one more runner
    assert p.trace_count == 3


def test_solve_batched_checks_its_inputs():
    _, A = operator(5)
    p = repro_torch.plan(A, **KW)
    b = torch.ones(A.n)
    with pytest.raises(ValueError, match="solve_batched"):
        p.solve_batched(b)
    with pytest.raises(ValueError, match="rhs of shape"):
        p.solve_batched(torch.ones(2, A.n + 1))
    with pytest.raises(ValueError, match="x0 of shape"):
        p.solve_batched(torch.ones(2, A.n), torch.zeros(3, A.n))
    with pytest.raises(ValueError, match="solve_batched"):
        p.solve(torch.ones(2, A.n))


# ---------------------------------------------------------------------------
# the batched plain versions: lane by lane, and against vmapped Pallas
# ---------------------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


K = 3
ALPHA = np.array([0.3, 0.25, 0.37], np.float32)
BETA = np.array([0.6, 0.81, 0.5], np.float32)


def _check_dia():
    J = jsp.poisson27(7)
    A = convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")
    X = _rand((K, A.n), 1)
    got = spmv_dia_batched_ref(A.data, A.offsets, _t(X))
    for lane in range(K):
        assert torch.equal(got[lane], spmv_dia_ref(A.data, A.offsets, _t(X[lane])))
    want = jax.vmap(lambda x: jk.spmv_dia_pallas(J, x, tile=TILE))(jnp.asarray(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VEC)
    act = torch.tensor([True, False, True])
    masked = spmv_dia_batched(A, _t(X), act)  # the wrapper on the CPU: the plain version
    assert torch.equal(masked[0], got[0]) and not masked[1].any()


def _check_bell():
    _, JB, TB = _bell_forms()
    X = _rand((K, TB.n), 2)
    got = spmv_bell_batched_ref(TB.cols, TB.vals, _t(X))
    for lane in range(K):
        assert torch.equal(got[lane], spmv_bell_ref(TB.cols, TB.vals, _t(X[lane])))
    want = jax.vmap(lambda x: jk.spmv_bell_pallas(JB, x))(jnp.asarray(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VEC)
    act = torch.tensor([False, True, True])
    masked = spmv_bell_batched(TB, _t(X), act)
    assert not masked[0].any() and torch.equal(masked[2], got[2])


def _check_fused_vma():
    n = 1000
    vecs = [_rand((K, n), 10 + i) for i in range(10)]
    inv = np.abs(_rand(n, 30)) + 0.5
    got = fused_vma_dots_batched_ref(*map(_t, vecs), _t(inv), _t(ALPHA), _t(BETA))
    for lane in range(K):
        one = fused_vma_dots_ref(*[_t(v[lane]) for v in vecs], _t(inv), float(ALPHA[lane]),
                                 float(BETA[lane]))
        for g, o in zip(got, one):
            assert torch.equal(g[lane], o)
    want = jax.vmap(lambda *a: jk.fused_vma_dots(*a[:10], jnp.asarray(inv), a[10], a[11]))(
        *map(jnp.asarray, vecs), jnp.asarray(ALPHA), jnp.asarray(BETA))
    for g, w in zip(got[:9], want[:9]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VEC)
    np.testing.assert_allclose(got[9].numpy(), np.asarray(want[9]), **DOTS)
    # the wrapper on the CPU: an inactive lane keeps every vector, its dots are 0
    work = [_t(v) for v in vecs]
    out = fused_vma_dots_batched(*work, _t(inv), _t(ALPHA), _t(BETA),
                                 torch.tensor([True, False, True]))
    for w_, v in zip(work, vecs):
        assert torch.equal(w_[1], _t(v[1]))
    assert torch.equal(out[8][0], got[8][0]) and not out[9][1].any()


def _check_fused_iter():
    from repro.kernels.fused_iter import fused_iter_tile

    J = jsp.poisson27(7)
    t = fused_iter_tile(J.bandwidth, TILE)
    n_pad = jceil_to(J.n, t)
    data = np.zeros((len(J.offsets), n_pad), np.float32)
    data[:, : J.n] = np.asarray(J.data)
    vecs = []
    for i in range(9):
        v = np.zeros((K, n_pad), np.float32)
        v[:, : J.n] = _rand((K, J.n), 40 + i)
        vecs.append(v)
    inv = np.zeros(n_pad, np.float32)
    inv[: J.n] = 1.0 / np.asarray(J.diagonal())
    got = fused_iter_batched_ref(_t(data), J.offsets, *map(_t, vecs), _t(inv), _t(ALPHA),
                                 _t(BETA))
    for lane in range(K):
        *one, dots = fused_iter_ref(_t(data), J.offsets, *[_t(v[lane]) for v in vecs], _t(inv),
                                    float(ALPHA[lane]), float(BETA[lane]))
        for g, o in zip(got[:9], one):
            assert torch.equal(g[lane], o)
        assert torch.equal(got[9][lane], torch.stack(list(dots)))
    jdata, jinv = jnp.asarray(data), jnp.asarray(inv)
    want = jax.vmap(lambda *a: jk.fused_iter_step(jdata, J.offsets, *a[:9], jinv, a[9], a[10],
                                                  tile=t))(
        *map(jnp.asarray, vecs), jnp.asarray(ALPHA), jnp.asarray(BETA))
    for g, w in zip(got[:9], want[:9]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VEC)
    np.testing.assert_allclose(got[9].numpy(), np.asarray(want[9]), **DOTS)
    # the wrapper on the CPU: an inactive lane keeps every vector, m carried across
    work = [_t(v) for v in vecs[:8]]
    m_out = torch.empty(K, n_pad)
    before = fused_iter_batched.launches
    fused_iter_batched(_t(data), J.offsets, *work, _t(vecs[8]), m_out, _t(inv), _t(ALPHA),
                       _t(BETA), torch.tensor([True, True, False]))
    assert fused_iter_batched.launches == before  # the plain version launches nothing
    for w_, v in zip(work, vecs):
        assert torch.equal(w_[2], _t(v[2]))
    assert torch.equal(m_out[2], _t(vecs[8][2])) and torch.equal(m_out[0], got[8][0])


@pytest.mark.parametrize("kernel", ["spmv_dia", "spmv_bell", "fused_vma", "fused_iter"])
def test_batched_plain_versions(kernel):
    {"spmv_dia": _check_dia, "spmv_bell": _check_bell, "fused_vma": _check_fused_vma,
     "fused_iter": _check_fused_iter}[kernel]()


def test_bf16_lane_spmv_matches_jax():
    """The bf16 lane SPMV (bf16 data and x, f32 sums, f32 y) against
    ``jax.vmap`` of the JAX package's ``spmv_dia_bf16`` on the same numpy
    inputs: both sum the same exact bf16 products in f32, in diagonal order
    (rtol 1e-6); lane by lane it is the 1-D plain version's bits, and the
    engine takes (k, n) on the CPU as on the card."""
    J = jsp.poisson27(7)
    A = convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")
    A16 = A.with_dtype(torch.bfloat16)
    X = _rand((K, A.n), 3)
    X16 = _t(X).to(torch.bfloat16)
    got = spmv_dia_batched_bf16_ref(A16.data, A.offsets, X16)
    assert got.dtype == torch.float32
    want = jax.vmap(lambda x: jsp.spmv_dia_bf16(J, x))(jnp.asarray(X16.float().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    for lane in range(K):
        assert torch.equal(got[lane], spmv_dia_ref(A16.data, A.offsets, X16[lane],
                                                   torch.float32))
    act = torch.tensor([True, False, True])
    masked = spmv_dia_batched_bf16(A16, X16, act)  # the wrapper on the CPU: the plain version
    assert torch.equal(masked[0], got[0]) and not masked[1].any()
    np.testing.assert_allclose(tsp.spmv(A, _t(X), engine="bf16").numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)

