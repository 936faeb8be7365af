"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU; on
the card run ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
The file imports neither JAX nor ``repro``: the card's machine has no JAX.
Tolerances: f32 vectors rtol/atol 1e-5; dots rtol 1e-4 with atol
1e-6·Σ|aᵢbᵢ| (f32 sums in another order); bf16 SPMV rtol 2e-2; bf16
dots rtol 1e-3 (f32 sums of the same bf16 products); fused AdamW p rtol/atol
1e-5 (f32) and 2e-2 (bf16), m and v rtol 1e-5 / atol 1e-6; attention 2e-5
(f32) and 4e-2 (bf16) (tests/test_kernels.py's); a train step's loss rtol
1e-4 against the same step on the CPU (f32 sums in another order).
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.kernels import (
    adamw_hyper,
    flash_attention,
    flash_attention_ref,
    fused_adamw,
    fused_adamw_ref,
    fused_dots,
    fused_dots_ref,
    fused_iter_ref,
    fused_iter_step,
    fused_vma_dots,
    fused_vma_dots_ref,
    spmv_bell_cuda,
    spmv_bell_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
)
from repro_torch.models import build_model, make_generator
from repro_torch.sparse import (
    bell_from_csr,
    csr_device_from_host,
    csr_from_dia,
    poisson27,
    poisson125,
    synthetic_spd_dia,
    table1_matrix,
)
from repro_torch.train import (
    AdamWConfig,
    TrainConfig,
    TrainState,
    adamw_init,
    batch_to_device,
    init_train_state,
    make_train_step,
)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmv_bell_matches_plain(cuda, dtype):
    ops = [table1_matrix("bcsstk15", device=cuda)]  # N = 3,948, R = 29: a warp per row
    ops += [synthetic_spd_dia(n, k, seed=1, device=cuda) for n, k in ((1000, 9), (777, 5), (500, 3))]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for D in ops:  # R = 29, 9, 5, 3: lane groups of 32, 16, 8 and 4
        B = bell_from_csr(csr_from_dia(D), device=cuda).with_dtype(dtype)
        x = _randn(B.n, 1, cuda).to(dtype)
        before = spmv_bell_cuda.launches
        got = spmv_bell_cuda(B, x)
        assert got.dtype == dtype and spmv_bell_cuda.launches == before + 1
        torch.testing.assert_close(got.float(), spmv_bell_ref(B.cols, B.vals, x).float(), **tol)
        assert torch.equal(got, spmv_bell_cuda(B, x))  # fixed-order lane sums
        on, off = (torch.tensor(f, device=cuda) for f in (True, False))
        assert torch.equal(spmv_bell_cuda(B, x, on), got)
        assert torch.equal(spmv_bell_cuda(B, x, off), torch.zeros_like(got))  # converged
    with pytest.raises(TypeError, match="f32 or bf16"):
        spmv_bell_cuda(B.with_dtype(torch.float64), x.double())


def test_spmv_bell_takes_more_than_2m_rows(cuda):
    n = 2 * 1024 * 1024 + 12_345  # above the TPU kernel's VMEM limit
    B = bell_from_csr(csr_from_dia(synthetic_spd_dia(n, 5, seed=2, device=cuda)), device=cuda)
    x = _randn(n, 3, cuda)
    before = spmv_bell_cuda.launches
    got = spmv_bell_cuda(B, x)
    torch.cuda.synchronize()
    assert spmv_bell_cuda.launches == before + 1
    torch.testing.assert_close(got, spmv_bell_ref(B.cols, B.vals, x), **VEC)
    bad = B.cols.clone()
    bad[7, 0] = n
    with pytest.raises(ValueError, match="outside"):
        spmv_bell_cuda(type(B)(bad, B.vals, n), x)


@pytest.mark.parametrize("n", [3_948, 4_147_110])
def test_fused_dots_matches_plain(cuda, n):
    r, u, w = (_randn(n, 30 + i, cuda) for i in range(3))
    before = fused_dots.launches
    got = fused_dots(r, u, w)
    assert fused_dots.launches == before + 1 and got.dtype == torch.float32
    _assert_dots(got, fused_dots_ref(r, u, w), (r * u, w * u, u * u))
    assert torch.equal(got, fused_dots(r, u, w))  # no atomics: the same bits every run
    h = [v.to(torch.bfloat16) for v in (r, u, w)]
    torch.testing.assert_close(fused_dots(*h), fused_dots_ref(*h), rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="shape"):
        fused_dots(r, u[:-1], w)


def test_general_format_solves_launch_their_kernels(cuda):
    D = table1_matrix("Queen_4147", scale=0.01, device=cuda)
    csr = csr_from_dia(D)
    B, C = bell_from_csr(csr, device=cuda), csr_device_from_host(csr, device=cuda)
    b = D.matvec(torch.full((D.n,), D.n ** -0.5, device=cuda))
    runs = {}
    for label, A, method, engine in (("bell", B, "pipecg", "auto"), ("csr", C, "pipecg", "auto"),
                                     ("bell-torch", B, "pipecg", "torch"),
                                     ("pcg", B, "pcg", "auto")):
        p = repro_torch.plan(A, method=method, engine=engine, atol=0.0, rtol=1e-5, maxiter=200)
        spmv_bell_cuda.launches = fused_vma_dots.launches = 0
        res = p.solve(b)
        d = p.describe()
        runs[label] = (d.get("core"), d["spmv"], int(res.iterations), res.steps,
                       spmv_bell_cuda.launches, fused_vma_dots.launches, bool(res.converged))
    it, steps = runs["bell"][2], runs["bell"][3]
    assert runs["bell"] == ("cuda", "cuda", it, steps, 3 + steps, steps, True)
    assert runs["csr"][:2] == ("cuda", "segsum") and runs["csr"][4:] == (0, runs["csr"][3], True)
    assert runs["bell-torch"][:2] == ("torch", "torch") and runs["bell-torch"][4:6] == (0, 0)
    pcg = runs["pcg"]
    assert pcg[:2] == (None, "cuda") and pcg[4:] == (1 + pcg[3], 0, True)
    assert abs(pcg[2] - it) <= 2 and runs["csr"][2] == it == runs["bell-torch"][2]


def test_fused_adam_matches_plain(cuda):
    for p_dtype, g_dtype, n in [(p_, g_, n) for p_, g_ in ((torch.float32, torch.float32),
                                                         (torch.bfloat16, torch.bfloat16),
                                                         (torch.bfloat16, torch.float32))
                                for n in (1, 4_097, 1_000_003)]:  # ragged: masked tail
        p = _randn(n, 40, cuda).to(p_dtype)
        g = _randn(n, 41, cuda).to(g_dtype)
        m, v = _randn(n, 42, cuda) * 0.1, _randn(n, 43, cuda).abs() * 0.01
        for step in (1, 10):
            hyper = adamw_hyper(3e-4, 0.9, 0.999, 1e-8, 0.1, torch.tensor(step, device=cuda))
            want = fused_adamw_ref(p, g, m, v, hyper)
            before = fused_adamw.launches
            got = fused_adamw(p, g, m, v, hyper)
            torch.cuda.synchronize()
            assert fused_adamw.launches == before + 1 and got[0] is p
            # bit for bit: IEEE _rn intrinsics in the plain version's order
            for name, a, b in zip("pmv", (p, m, v), want):
                assert torch.equal(a, b), (name, p_dtype, g_dtype, n, step)
    with pytest.raises(TypeError, match="f32/f32"):
        fused_adamw(p.double(), g.double(), m, v, hyper)
    with pytest.raises(ValueError, match="distinct"):
        fused_adamw(p, g, m, m, hyper)


def test_flash_attention_matches_plain(cuda):
    cases = [((2, 256, 4, 2, 64), 256, True), ((1, 96, 8, 2, 128), 96, True),  # 4:1 GQA, ragged
             ((1, 128, 2, 2, 32), 256, False), ((2, 512, 16, 8, 128), 512, True),
             ((1, 128, 8, 2, 128), 256, False),  # full attention, Tk = 2 Tq
             ((2, 96, 4, 4, 16), 96, True),  # hd 16, padded to 32
             ((1, 96, 4, 1, 20), 96, True)]  # hd 20: 40-byte bf16 rows, element copies; 4:1
    for dtype, ((B, T, H, KV, hd), Tk, causal) in [(d, c) for d in (torch.float32, torch.bfloat16)
                                                   for c in cases]:
        q = _randn(B * T * H * hd, 50, cuda).reshape(B, T, H, hd).to(dtype)
        k = _randn(B * Tk * KV * hd, 51, cuda).reshape(B, Tk, KV, hd).to(dtype)
        v = _randn(B * Tk * KV * hd, 52, cuda).reshape(B, Tk, KV, hd).to(dtype)
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1 and got.dtype == dtype
        assert torch.equal(got, flash_attention(q, k, v, causal=causal))  # no atomics: same bits
        want = flash_attention_ref(q, k, v, causal).double()
        if dtype == torch.float32:
            torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=2e-5)
        else:  # per output row: the plain version rounds the probabilities to bf16
            rel = (got.double() - want).norm(dim=-1) / want.norm(dim=-1)
            assert float(rel.max()) <= 1e-2, (B, T, H, KV, hd, Tk, causal, float(rel.max()))
    with pytest.raises(ValueError, match="%"):
        flash_attention(q[:, :100], k[:, :100], v[:, :100], q_tile=64)


def test_reduced_train_step_on_the_card(cuda):
    cfg = reduced(get_config("internlm2-1.8b"))
    api = build_model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0, apply_fused=True))
    cpu = init_train_state(api, make_generator(0, "cpu"))
    params = api.init_params(make_generator(0, "cpu")).to(cuda)  # the same draws
    gpu = TrainState(params, adamw_init(dict(params.named_parameters())),
                     torch.zeros((), dtype=torch.int32, device=cuda))
    step = make_train_step(api, tc)
    dc = SyntheticConfig(batch=4, seq_len=64, vocab_size=cfg.vocab_size, seed=1)
    n_tensors = len(list(params.parameters()))
    fused_adamw.launches = 0
    for s in range(3):
        batch = batch_for_step(dc, s)
        cpu, m_cpu = step(cpu, batch_to_device(batch, "cpu"))
        gpu, m_gpu = step(gpu, batch_to_device(batch, cuda))
        torch.testing.assert_close(m_gpu["loss"].cpu(), m_cpu["loss"], rtol=1e-4, atol=0)
    torch.cuda.synchronize()
    assert fused_adamw.launches == 3 * n_tensors == 3 * (3 + 4 * 9)
    assert int(gpu.step) == 3 and gpu.params.embedding.device.type == "cuda"
