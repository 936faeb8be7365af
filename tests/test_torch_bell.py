"""The port's general-sparsity layer against the JAX package, on the CPU.

Generators: bit-identical data. Conversions (``csr_from_dia``,
``bell_from_csr``, ``dia_from_csr``, ``csr_device_from_host``,
``csr_from_dense``, the host diagonal and dense form): equal arrays,
dtypes included. SPMV engines: the Bell gather and the CSR scatter and
segment sum against JAX's, rtol 1e-5 / atol 1e-5 (f32 sums in another
order). Kernel plain versions against the JAX Pallas kernels run in
interpret mode: f32 vectors 1e-5, dots 1e-4; bf16 2e-2 for vectors and
3e-2 for dots (the JAX suite's own bands).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
import repro.sparse as jsp
from repro_torch import convert
from repro_torch import sparse as tsp
from repro_torch.kernels import fused_dots, fused_dots_ref, spmv_bell_cuda, spmv_bell_ref
from repro_torch.plan import operator_fingerprint
from repro_torch.sparse import formats

VEC = dict(rtol=1e-5, atol=1e-5)
MATRICES = [("bcsstk15", 0.05), ("Queen_4147", 0.002)]


def _x(n, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _forms(name, scale):
    """(JAX DIA, port DIA, JAX host CSR, port host CSR) of one Table-I analogue."""
    J = jsp.table1_matrix(name, scale=scale)
    A = tsp.table1_matrix(name, scale=scale, device="cpu")
    return J, A, jsp.csr_from_dia(J), tsp.csr_from_dia(A)


@pytest.mark.parametrize("spec", [("bcsstk15", 0.05, 0), ("Queen_4147", 0.002, 0),
                                  ("synthetic", 700, 3)])
def test_generators_bit_identical_to_jax(spec):
    name, arg, seed = spec
    if name == "synthetic":
        J = jsp.synthetic_spd_dia(arg, 9.0, seed=seed)
        A = tsp.synthetic_spd_dia(arg, 9.0, seed=seed, device="cpu")
    else:
        J = jsp.table1_matrix(name, scale=arg, seed=seed)
        A = tsp.table1_matrix(name, scale=arg, seed=seed, device="cpu")
    assert A.offsets == J.offsets and A.n == J.n and A.data.dtype == torch.float32
    assert np.array_equal(A.data.numpy(), np.asarray(J.data))
    assert tsp.TABLE1 == jsp.TABLE1


@pytest.mark.parametrize("name,scale", MATRICES)
def test_conversions_equal_jax_arrays(name, scale):
    J, A, jc, tc = _forms(name, scale)
    for field in ("indptr", "indices", "data"):
        got, want = getattr(tc, field), getattr(jc, field)
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert tc.nnz == jc.nnz == J.nnz()
    assert np.array_equal(tc.diagonal(), jc.diagonal())
    for slots in (None, jc.row_nnz().max() + 3):
        jb, tb = jsp.bell_from_csr(jc, slots), tsp.bell_from_csr(tc, slots, device="cpu")
        assert tb.cols.dtype == torch.int32 and tb.n == jb.n
        assert np.array_equal(tb.cols.numpy(), np.asarray(jb.cols))
        assert np.array_equal(tb.vals.numpy(), np.asarray(jb.vals))
    with pytest.raises(ValueError, match="slots_per_row"):
        tsp.bell_from_csr(tc, 2, device="cpu")
    jd, td = jsp.dia_from_csr(jc), tsp.dia_from_csr(tc, device="cpu")
    assert td.offsets == jd.offsets and np.array_equal(td.data.numpy(), np.asarray(jd.data))
    jdev, tdev = jsp.csr_device_from_host(jc), tsp.csr_device_from_host(tc, device="cpu")
    for field in ("rows", "cols", "vals"):
        got, want = getattr(tdev, field).numpy(), np.asarray(getattr(jdev, field))
        assert got.dtype == want.dtype and np.array_equal(got, want), field
    assert np.array_equal(tdev.diagonal().numpy(), np.asarray(jdev.diagonal()))
    assert np.array_equal(tb.diagonal().numpy(), np.asarray(jb.diagonal()))
    # BellMatrix.column_span (the lane kernel's window size) is the largest
    # |col - row| over the nonzero slots: the DIA form's widest offset,
    # padding slots (column 0, value 0) left out, the same when computed a
    # chunk of rows at a time, and not part of the operator's identity
    B = tsp.bell_from_csr(tc, device="cpu")
    before = operator_fingerprint(B)
    assert B.column_span == max(abs(o) for o in A.offsets) == A.bandwidth
    assert operator_fingerprint(B) == before
    chunked = tsp.BellMatrix(B.cols, B.vals, B.n)
    old = formats._SPAN_CHUNK
    formats._SPAN_CHUNK = 7
    try:
        assert chunked.column_span == B.column_span
    finally:
        formats._SPAN_CHUNK = old
    empty = tsp.BellMatrix(torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2), 4)
    assert empty.column_span == 0  # padding only
    dense = jc.to_dense()[:90, :90].copy()
    dense[5, :] = 0.0  # an empty row
    jc, tc = jsp.csr_from_dense(dense), tsp.csr_from_dense(dense)
    for field in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(tc, field), getattr(jc, field)), field
    assert np.array_equal(tc.to_dense(), jc.to_dense())
    assert np.array_equal(tc.to_dense(), dense)
    assert np.array_equal(tc.diagonal(), jc.diagonal())


@pytest.mark.parametrize("engine", ["bell", "csr", "segsum"])
def test_spmv_engines_match_jax(engine):
    J, A, jc, tc = _forms("Queen_4147", 0.002)
    x = _x(A.n, 1)
    if engine == "bell":
        JA, TA, jfn, tfn = (jsp.bell_from_csr(jc), tsp.bell_from_csr(tc, device="cpu"),
                            jsp.spmv_bell, tsp.spmv_bell)
    else:
        JA, TA = jsp.csr_device_from_host(jc), tsp.csr_device_from_host(tc, device="cpu")
        jfn, tfn = ((jsp.spmv_csr, tsp.spmv_csr) if engine == "csr"
                    else (jsp.spmv_csr_segsum, tsp.spmv_csr_segsum))
    got = tfn(TA, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(JA, jnp.asarray(x))), **VEC)
    np.testing.assert_allclose(TA.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jsp.spmv_dia(J, jnp.asarray(x))), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmv_bell_ref_matches_pallas(dtype):
    _, _, jc, tc = _forms("bcsstk15", 0.2)  # N = 789, R = 29: several 512-row tiles
    jb = jsp.bell_from_csr(jc)
    tb = tsp.bell_from_csr(tc, device="cpu")
    x = _x(tb.n, 2)
    if dtype == "bfloat16":
        jb, tb = jb.with_dtype(jnp.bfloat16), tb.with_dtype(torch.bfloat16)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jk.spmv_bell_pallas(jb, jx), np.float64)
    before = spmv_bell_cuda.launches
    got = spmv_bell_cuda(tb, tx)  # the wrapper runs its plain version on the CPU
    assert spmv_bell_cuda.launches == before and got.dtype == tx.dtype
    assert torch.equal(got, spmv_bell_ref(tb.cols, tb.vals, tx))
    tol = VEC if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.double().numpy(), want, **tol)
    # a converged solve's flag: the kernel's plain version writes zeros
    assert torch.equal(spmv_bell_cuda(tb, tx, torch.tensor(True)), got)
    assert torch.equal(spmv_bell_cuda(tb, tx, torch.tensor(False)), torch.zeros_like(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dots_ref_matches_pallas(dtype):
    n = 20_000  # not a multiple of the Pallas (64 x 128) tile
    r, u, w = (_x(n, 10 + i) for i in range(3))
    jargs = [jnp.asarray(a, dtype) for a in (r, u, w)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (r, u, w)]
    want = np.asarray(jk.fused_dots(*jargs))
    before = fused_dots.launches
    got = fused_dots(*targs)
    assert fused_dots.launches == before and got.dtype == torch.float32
    assert torch.equal(got, fused_dots_ref(*targs))
    tol = dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else dict(rtol=3e-2, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert float(fused_dots(targs[1], targs[1], targs[1])[2]) >= 0


def test_engine_resolution_and_fallbacks():
    _, A, _, tc = _forms("bcsstk15", 0.05)
    B = tsp.bell_from_csr(tc, device="cpu")
    C = tsp.csr_device_from_host(tc, device="cpu")
    assert tsp.spmv_engines(B) == ("cuda", "torch")
    assert tsp.spmv_engines(C) == ("segsum", "torch")
    assert tsp.resolve_engine(B, "auto") == "torch"  # the caller put B on the CPU
    assert tsp.resolve_engine(C, "auto") == "segsum"
    assert tsp.resolve_engine(C, "cuda") == "segsum"  # CSR has no CUDA kernel
    with pytest.raises(ValueError, match="no SPMV engine"):
        tsp.resolve_engine(B, "bf16")
    x = torch.from_numpy(_x(A.n, 3))
    dense = torch.from_numpy(tc.to_dense())
    assert tsp.resolve_engine(dense, "auto") == "torch"
    torch.testing.assert_close(tsp.spmv(dense, x), tsp.spmv(B, x), **VEC)
    op = tsp.as_operator(lambda v: tsp.spmv(C, v), n=A.n, diag=A.diagonal())
    assert op.device == torch.device("cpu") and tsp.spmv_engines(op) == ("torch",)
    assert tsp.resolve_engine(op, "cuda") == "torch"
    torch.testing.assert_close(tsp.spmv(op, x), tsp.spmv(C, x), rtol=0, atol=0)
    assert tsp.as_operator(B) is B and tsp.as_operator(dense) is dense
    with pytest.raises(ValueError, match="needs n="):
        tsp.as_operator(lambda v: v)
    with pytest.raises(TypeError, match="cannot adapt"):
        tsp.as_operator(3)
    with pytest.raises(ValueError, match="no diagonal"):
        tsp.FunctionOperator(fn=lambda v: v, n=4, device="cpu").diagonal()


def test_array_converters_round_trip():
    _, _, jc, tc = _forms("bcsstk15", 0.05)
    jb, jcd = jsp.bell_from_csr(jc), jsp.csr_device_from_host(jc)
    B = convert.bell_from_arrays(np.asarray(jb.cols), np.asarray(jb.vals), jb.n, device="cpu")
    C = convert.csr_from_arrays(np.asarray(jcd.rows), np.asarray(jcd.cols), np.asarray(jcd.vals),
                                jcd.n, device="cpu")
    assert B.cols.dtype == C.rows.dtype == C.cols.dtype == torch.int32
    assert np.array_equal(B.vals.numpy(), np.asarray(jb.vals))
    assert np.array_equal(C.cols.numpy(), np.asarray(jcd.cols))
    assert B.columns_in_range
    with pytest.raises(ValueError, match="must both be"):
        convert.bell_from_arrays(np.asarray(jb.cols)[:, :-1], np.asarray(jb.vals), jb.n,
                                 device="cpu")
    with pytest.raises(ValueError, match="inv_blocks shape"):
        convert.block_jacobi_from_arrays(np.zeros((4, 2, 3), np.float32), 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsp.bell_from_csr(tc)  # the converters default to CUDA, as every entry point

