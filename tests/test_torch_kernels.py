"""The port's three kernel modules against the JAX package's kernels.

On the CPU each port wrapper runs its plain version; those are held
against the JAX Pallas kernels run in interpret mode (with a small tile,
so halos cross tiles) on the same numpy inputs. Tolerances are
``tests/test_kernels.py``'s: f32 vectors rtol/atol 1e-5; dots rtol 1e-4,
atol 1e-3 (the reduction order differs); bf16 SPMV rtol 2e-2.

The CUDA kernels themselves are held against these plain versions on the
card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
import repro.sparse as jsp
from repro.kernels.common import ceil_to as jceil_to
from repro_torch import convert
from repro_torch.kernels import (
    fused_iter_ref,
    fused_iter_step,
    fused_vma_dots,
    fused_vma_dots_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
)
from repro_torch.kernels.common import (
    BLOCK,
    ceil_to,
    check_active,
    check_distinct,
    check_vectors,
    device_scalar,
    pad1d,
)

VEC = dict(rtol=1e-5, atol=1e-5)
DOTS = dict(rtol=1e-4, atol=1e-3)
TILE = 256  # small Pallas tile: several grid steps, halos across tiles
OPS = [("poisson27", 7), ("poisson125", 8)]


def _rand_vecs(k, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _pair(name, n):
    J = getattr(jsp, name)(n)
    return J, convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# spmv_dia
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", OPS)
def test_spmv_ref_matches_pallas(name, n):
    J, A = _pair(name, n)
    (x,) = _rand_vecs(1, A.n, 0)
    want = np.asarray(jk.spmv_dia_pallas(J, jnp.asarray(x), tile=TILE))
    np.testing.assert_allclose(spmv_dia_ref(A.data, A.offsets, _t(x)).numpy(), want, **VEC)


@pytest.mark.parametrize("name,n", OPS)
def test_spmv_bf16_ref_matches_pallas(name, n):
    J, A = _pair(name, n)
    (x,) = _rand_vecs(1, A.n, 1)
    J16 = J.with_dtype(jnp.bfloat16)
    want = np.asarray(jk.spmv_dia_pallas(J16, jnp.asarray(x, jnp.bfloat16), tile=TILE,
                                         out_dtype=jnp.float32))
    A16 = A.with_dtype(torch.bfloat16)
    got = spmv_dia_ref(A16.data, A.offsets, _t(x).to(torch.bfloat16), torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-5)


def test_spmv_wrapper_on_cpu_runs_plain_version():
    _, A = _pair("poisson27", 7)
    (x,) = _rand_vecs(1, A.n, 2)
    before = spmv_dia_cuda.launches
    got = spmv_dia_cuda(A, _t(x))
    assert torch.equal(got, spmv_dia_ref(A.data, A.offsets, _t(x)))
    assert spmv_dia_cuda.launches == before  # counts kernel launches only


# ---------------------------------------------------------------------------
# fused_vma
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [343, 1000, 4096])
def test_fused_vma_ref_matches_pallas(n):
    vecs = _rand_vecs(10, n, 3)
    inv = np.abs(_rand_vecs(1, n, 4)[0]) + 0.5
    alpha, beta = 0.37, 0.81
    want = jk.fused_vma_dots(*map(jnp.asarray, vecs), jnp.asarray(inv), alpha, beta)
    got = fused_vma_dots_ref(*map(_t, vecs), _t(inv), alpha, beta)
    for g, w in zip(got[:9], want[:9]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VEC)
    np.testing.assert_allclose(got[9].numpy(), np.asarray(want[9]), **DOTS)


def test_fused_vma_wrapper_updates_in_place():
    n = 700
    vecs = [_t(v) for v in _rand_vecs(10, n, 5)]
    inv = _t(np.abs(_rand_vecs(1, n, 6)[0]) + 0.5)
    want = fused_vma_dots_ref(*[v.clone() for v in vecs], inv, 0.3, 0.6)
    before = fused_vma_dots.launches
    got = fused_vma_dots(*vecs, inv, torch.tensor(0.3), torch.tensor(0.6))
    inputs = vecs[:8] + vecs[9:10]  # z q s p x r u w, then m (n is read only)
    for g, t, w in zip(got[:9], inputs, want[:9]):
        assert g is t
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(got[9], want[9], rtol=0, atol=0)
    assert fused_vma_dots.launches == before


def test_fused_vma_inactive_is_a_no_op():
    n = 300
    vecs = [_t(v) for v in _rand_vecs(10, n, 7)]
    keep = [v.clone() for v in vecs]
    got = fused_vma_dots(*vecs, torch.ones(n), 0.3, 0.6, torch.tensor(False))
    for v, k in zip(vecs, keep):
        assert torch.equal(v, k)
    assert torch.equal(got[9], torch.zeros(3))


# ---------------------------------------------------------------------------
# fused_iter
# ---------------------------------------------------------------------------

def _fused_iter_operands(J, seed):
    """Pallas-padded operands (tile TILE) and the port's, from one numpy draw."""
    from repro.kernels.fused_iter import fused_iter_tile

    t = fused_iter_tile(J.bandwidth, TILE)
    n_pad = jceil_to(J.n, t)
    data = np.zeros((len(J.offsets), n_pad), np.float32)
    data[:, : J.n] = np.asarray(J.data)
    vecs = []
    for v in _rand_vecs(9, J.n, seed):
        p = np.zeros(n_pad, np.float32)
        p[: J.n] = v
        vecs.append(p)
    inv = np.zeros(n_pad, np.float32)
    inv[: J.n] = 1.0 / np.asarray(J.diagonal())
    return t, data, vecs, inv


@pytest.mark.parametrize("name,n", OPS)
def test_fused_iter_ref_matches_pallas(name, n):
    J = getattr(jsp, name)(n)
    t, data, vecs, inv = _fused_iter_operands(J, 8)
    assert data.shape[1] > t  # several tiles: the halo BlockSpecs are exercised
    want = jk.fused_iter_step(jnp.asarray(data), J.offsets, *map(jnp.asarray, vecs),
                              jnp.asarray(inv), jnp.float32(0.3), jnp.float32(0.7), tile=t)
    got = fused_iter_ref(_t(data), J.offsets, *map(_t, vecs), _t(inv), 0.3, 0.7)
    for g, w in zip(got[:9], want[:9]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VEC)
    dots = torch.stack(list(got[9])).numpy()
    np.testing.assert_allclose(dots, np.asarray(want[9]), **DOTS)
    for g in got[:9]:  # the padded tail stays exactly zero
        assert not g[J.n:].any()


def test_fused_iter_wrapper_ping_pongs_m():
    _, A = _pair("poisson27", 7)
    n_pad = ceil_to(A.n, BLOCK)
    data = torch.nn.functional.pad(A.data, (0, n_pad - A.n))
    vecs = [pad1d(_t(v), n_pad) for v in _rand_vecs(9, A.n, 9)]
    inv = pad1d(1.0 / A.diagonal(), n_pad)
    m_in, m_keep = vecs[8], vecs[8].clone()
    m_out = torch.empty_like(m_in)
    want = fused_iter_ref(data, A.offsets, *[v.clone() for v in vecs], inv, 0.3, 0.7)
    got = fused_iter_step(data, A.offsets, *vecs[:8], m_in, m_out, inv, 0.3, 0.7)
    assert got[8] is m_out and torch.equal(m_in, m_keep)
    for g, w in zip(got[:9], want[:9]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert not g[A.n:].any()
    # inactive: only m is carried across
    keep = [v.clone() for v in vecs[:8]]
    m_out2 = torch.empty_like(m_in)
    got = fused_iter_step(data, A.offsets, *vecs[:8], m_out, m_out2, inv, 0.3, 0.7,
                          torch.tensor(False))
    assert torch.equal(m_out2, m_out) and torch.equal(got[9], torch.zeros(3))
    for v, k in zip(vecs[:8], keep):
        assert torch.equal(v, k)


# ---------------------------------------------------------------------------
# the wrappers' argument checks (the CUDA path raises on what it cannot take)
# ---------------------------------------------------------------------------

def test_argument_checks():
    cpu = torch.device("cpu")
    a = torch.zeros(8)
    check_vectors(("a",), (a,), length=8, device=cpu)
    with pytest.raises(TypeError, match="float32"):
        check_vectors(("a",), (a.double(),), length=8, device=cpu)
    with pytest.raises(ValueError, match="shape"):
        check_vectors(("a",), (a,), length=9, device=cpu)
    with pytest.raises(ValueError, match="contiguous"):
        check_vectors(("a",), (torch.zeros(16)[::2],), length=8, device=cpu)
    with pytest.raises(ValueError, match="share memory"):
        check_distinct(("a", "b"), (a, a))
    assert device_scalar(0.5, cpu).dtype == torch.float32
    with pytest.raises(ValueError, match="scalar"):
        device_scalar(torch.ones(2), cpu)
    assert check_active(None, cpu) is None
    with pytest.raises(ValueError, match="0-d bool"):
        check_active(torch.tensor(1), cpu)
