"""The DIA lane kernels on the card: the lane SPMV (f32 and bf16) and the
bf16-band whole iteration.

Every test here is marked ``cuda`` and skips where there is no GPU; on the
card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda_dia.py``. The file imports neither JAX nor ``repro``.
Each lane entry is held against its plain version (f32 vectors rtol/atol
1e-5; the bf16 SPMV sums the same exact bf16 products in f32, so 1e-5
too; dots rtol 1e-4 with atol 1e-6·Σ|aᵢbᵢ|, tests/test_kernels.py's) and,
lane by lane, bit for bit against the single-rhs kernel on that lane: the
lane kernels add each row's products in the single kernel's order. A lane
whose flag is False gets 0 (SPMV) or is left bit for bit untouched
(fused_iter).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    fused_iter_batched,
    fused_iter_batched_ref,
    fused_iter_step,
    spmv_dia_batched,
    spmv_dia_batched_bf16,
    spmv_dia_batched_bf16_ref,
    spmv_dia_batched_ref,
    spmv_dia_cuda,
)
from repro_torch.kernels.common import BLOCK, ceil_to
from repro_torch.sparse import poisson27, poisson125, synthetic_spd_dia

VEC = dict(rtol=1e-5, atol=1e-5)
SPMV_LANES = (1, 2, 3, 8, 11)  # 11: two launches (8 + 3); lane 1 inactive where k > 1
# the widest window a group may span at 2-8 bf16 lanes (csrc/common.cuh's
# make_tile_plan at 8 lanes: 2,152 columns; f32: 560)
WIDEST_GROUP = 2_152

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operator(name, device):
    """poisson27 at an odd N (every lane's row starts mid-sector); a small
    poisson125 (runs of 5 offsets, n % 4 == 0); isolated far offsets with
    n % 4 == 3 (runs of 1, and the near band's run of 13); and a band far
    wider than any window (several groups)."""
    if name == "poisson27":
        return poisson27(37, device=device)  # N = 50,653
    if name == "poisson125":
        return poisson125(24, device=device)  # N = 13,824
    if name == "isolated":
        return synthetic_spd_dia(20_003, 27, bandwidth=250, seed=4, device=device)
    A = synthetic_spd_dia(40_001, 27, bandwidth=6_000, seed=5, device=device)
    assert max(A.offsets) - min(A.offsets) > 2 * WIDEST_GROUP
    return A


def _lanes(k, n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)


def _flags(k, device):
    """Lane 1 (when there is one) inactive, the others active."""
    act = torch.ones(k, dtype=torch.bool, device=device)
    if k > 1:
        act[1] = False
    return act


@pytest.mark.parametrize("op", ["poisson27", "poisson125", "isolated", "wide"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spmv_dia_batched(cuda, dtype, op):
    A = _operator(op, cuda)
    if dtype == "bf16":
        A = A.with_dtype(torch.bfloat16)
        fn, ref = spmv_dia_batched_bf16, spmv_dia_batched_bf16_ref

        def single(x1):
            return spmv_dia_cuda(A, x1, out_dtype=torch.float32)
    else:
        fn, ref = spmv_dia_batched, spmv_dia_batched_ref

        def single(x1):
            return spmv_dia_cuda(A, x1)
    for k in SPMV_LANES:
        X = _lanes(k, A.n, k, cuda).to(A.dtype)
        act = _flags(k, cuda)
        before = fn.launches
        Y = fn(A, X, act)
        torch.cuda.synchronize()
        assert fn.launches == before + -(-k // 8)
        assert Y.dtype == torch.float32
        torch.testing.assert_close(Y, ref(A.data, A.offsets, X, act), **VEC)
        for lane in range(k):
            if not act[lane]:
                assert not Y[lane].any(), (k, lane)
                continue
            assert torch.equal(Y[lane], single(X[lane])), (k, lane)
        # no flag: every lane computed
        assert torch.equal(fn(A, X)[0], Y[0])


def _assert_dots(got, want, terms):
    scale = max(float(t.abs().sum()) for t in terms)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)


FUSED_LANES = (1, 2, 3, 4, 5, 6, 7, 8, 11)


def _band_case(name, device):
    """(band, offsets, inv, n, zero tail from) of a bf16-band case: the
    operators above, a small one below one 1024-row tile (n % 4 == 1), one
    with n % 4 == 2, and poisson27 padded to whole 256-row blocks with a zero
    tail, as the solver keeps it (n % 4 == 0)."""
    if name == "small":
        A = poisson27(9, device=device)  # N = 729
    elif name == "n2":
        A = synthetic_spd_dia(30_002, 27, bandwidth=100, seed=7, device=device)
    elif name == "padded":
        A = poisson27(37, device=device)
        n_pad = ceil_to(A.n, BLOCK)
        data = torch.nn.functional.pad(A.data, (0, n_pad - A.n))
        inv = torch.nn.functional.pad(1.0 / A.diagonal(), (0, n_pad - A.n))
        return data.to(torch.bfloat16).contiguous(), A.offsets, inv, n_pad, A.n
    else:
        A = _operator(name, device)
    return A.data.to(torch.bfloat16).contiguous(), A.offsets, 1.0 / A.diagonal(), A.n, A.n


@pytest.mark.parametrize("op", ["padded", "poisson27", "poisson125", "isolated", "wide", "small",
                                "n2"])
def test_fused_iter_bf16_band(cuda, op):
    """The bf16-band instance (make_fused_iter_core(A, data_dtype=bf16)) at
    1-8 and 11 lanes, on operators whose n % 4 is 0, 1, 2 and 3, one below
    a row tile and ones with several groups of diagonals: against its plain
    version, each active lane bit for bit the single bf16 instance on that
    lane, and the inactive lane untouched."""
    data, offsets, inv, n, tail = _band_case(op, cuda)
    assert data.shape == (len(offsets), n)
    for k in FUSED_LANES:
        vecs = [_lanes(k, n, 40 + 10 * k + i, cuda) for i in range(9)]
        for v in vecs:
            v[:, tail:] = 0
        alpha = torch.linspace(0.2, 0.4, k, device=cuda)
        beta = torch.linspace(0.5, 0.7, k, device=cuda)
        act = _flags(k, cuda)
        want = fused_iter_batched_ref(data, offsets, *vecs, inv, alpha, beta)
        work = [v.clone() for v in vecs[:8]]
        m_out = torch.empty_like(vecs[8])
        before = fused_iter_batched.launches
        got = fused_iter_batched(data, offsets, *work, vecs[8], m_out, inv, alpha, beta, act)
        torch.cuda.synchronize()
        assert fused_iter_batched.launches == before + -(-k // 8)
        for lane in range(k):
            if not act[lane]:
                for v, v0 in zip(work, vecs[:8]):
                    assert torch.equal(v[lane], v0[lane]), (k, lane)
                assert torch.equal(m_out[lane], vecs[8][lane]), (k, lane)
                assert torch.equal(got[9][lane], torch.zeros(3, device=cuda)), (k, lane)
                continue
            s_out = torch.empty(n, device=cuda)
            single = fused_iter_step(data, offsets, *[v[lane].clone() for v in vecs[:8]],
                                     vecs[8][lane], s_out, inv, alpha[lane], beta[lane])
            for g, w, s in zip(got[:9], want[:9], single[:9]):
                torch.testing.assert_close(g[lane], w[lane], **VEC)
                assert torch.equal(g[lane], s), (k, lane)
            _assert_dots(got[9][lane], want[9][lane],
                         (want[5][lane] * want[6][lane], want[7][lane] * want[6][lane],
                          want[6][lane] * want[6][lane]))
            assert torch.equal(got[9][lane], single[9]), (k, lane)
        if tail < n:
            assert not any(v[:, tail:].any() for v in got[:9])  # the padded tail stays 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_iter_step(data.half(), offsets, *[v[0].clone() for v in vecs[:8]], vecs[8][0],
                        torch.empty(n, device=cuda), inv, 0.3, 0.6)
