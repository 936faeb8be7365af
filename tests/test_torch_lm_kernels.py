"""The plain versions of the port's LM kernels (``fused_adam``,
``flash_attn``) against the JAX package's Pallas kernels run in interpret
mode on the CPU, at ``tests/test_kernels.py``'s shapes, dtypes and
tolerances: AdamW p rtol/atol 1e-5 (f32) and 2e-2 (bf16), m and v rtol
1e-5 / atol 1e-6; attention 2e-5 (f32) and 4e-2 (bf16). Inputs come from
numpy seeds. On CPU tensors each wrapper runs its plain version and
launches nothing; the kernels themselves run in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import fused_adamw as jadamw
from repro_torch.kernels import adamw_hyper, flash_attention, fused_adamw, fused_adamw_ref

SIZES = [100, 1023, 4096, 20000]
DTYPES = [torch.float32, torch.bfloat16]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)


def _pair(shape, dtype, seed):
    """The same draws as a torch tensor and a JAX array that share no memory.

    On the CPU ``jnp.asarray`` may alias a 64-byte-aligned numpy buffer, and
    ``torch.from_numpy(a).to(torch.float32)`` is ``a`` itself: ``fused_adamw``
    writes p in place while JAX's asynchronous dispatch may still be reading
    it, so the torch side gets its own copy."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.tensor(a).to(dtype), jnp.asarray(a).astype(JDT[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_adam_matches_jax(dtype):
    for n in SIZES:
        p, jp = _pair(n, dtype, 1)
        g, jg = _pair(n, dtype, 2)
        m, v = torch.zeros(n), torch.zeros(n)
        jm, jv = jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32)
        for step in (1.0, 10.0):
            jp, jm, jv = jadamw(jp, jg, jm, jv, lr=3e-4, wd=0.1, step=step, interpret=True)
            hyper = adamw_hyper(3e-4, 0.9, 0.999, 1e-8, 0.1, torch.tensor(step))
            fused_adamw(p, g, m, v, hyper)
            np.testing.assert_allclose(p.double().numpy(), np.asarray(jp, np.float64),
                                       **_tol(dtype))
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_fused_adam_wrapper_on_cpu_is_in_place_and_launches_nothing():
    p = torch.from_numpy(np.random.default_rng(3).standard_normal(500).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(500).astype(np.float32))
    m, v = torch.full((500,), 0.1), torch.full((500,), 0.2)
    hyper = adamw_hyper(1e-3, 0.9, 0.999, 1e-8, 0.0, torch.tensor(3, dtype=torch.int32))
    b = np.float32([0.9, 0.999])
    np.testing.assert_allclose(hyper.numpy(), [1e-3, 0.9, 0.999, 1e-8, 0.0, *(1 - b**3)],
                               rtol=1e-6)  # the bias corrections in f32, as JAX's wrapper
    want = fused_adamw_ref(p, g, m, v, hyper)
    before = fused_adamw.launches
    ptrs = [t.data_ptr() for t in (p, m, v)]
    out = fused_adamw(p, g, m, v, hyper)
    assert [t.data_ptr() for t in out] == ptrs and fused_adamw.launches == before
    for got, w in zip(out, want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_jax(dtype):
    for B, T, H, KV, hd in [(2, 256, 4, 2, 64), (1, 128, 8, 8, 32), (2, 384, 6, 3, 64),
                            (1, 256, 4, 1, 16)]:
        q, jq = _pair((B, T, H, hd), dtype, 0)
        k, jk = _pair((B, T, KV, hd), dtype, 1)
        v, jv = _pair((B, T, KV, hd), dtype, 2)
        want = jflash(jq, jk, jv, q_tile=128, kv_tile=128, interpret=True)
        got = flash_attention(q, k, v, q_tile=128, kv_tile=128)
        assert got.dtype == dtype and got.shape == (B, T, H, hd)
        tol = 4e-2 if dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_attention_noncausal_longer_keys():
    q, jq = _pair((1, 128, 2, 32), torch.float32, 0)
    k, jk = _pair((1, 256, 2, 32), torch.float32, 1)
    v, jv = _pair((1, 256, 2, 32), torch.float32, 2)
    want = jflash(jq, jk, jv, causal=False, q_tile=128, kv_tile=128, interpret=True)
    got = flash_attention(q, k, v, causal=False, q_tile=128, kv_tile=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_attention_divisibility_guard():
    q = torch.zeros(1, 100, 2, 32)
    with pytest.raises(ValueError, match="%"):
        flash_attention(q, q[:, :, :2], q[:, :, :2], q_tile=64)
    with pytest.raises(ValueError, match="%"):  # the JAX wrapper raises alike
        jflash(jnp.zeros((1, 100, 2, 32)), jnp.zeros((1, 100, 2, 32)),
               jnp.zeros((1, 100, 2, 32)), q_tile=64, interpret=True)
    with pytest.raises(ValueError, match="pair"):
        flash_attention(q, torch.zeros(1, 100, 3, 32), torch.zeros(1, 100, 3, 32))
