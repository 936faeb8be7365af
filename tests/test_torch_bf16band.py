"""The bf16-band whole-iteration core against the JAX package, on the CPU.

The port's ``make_fused_iter_core(A, data_dtype=torch.bfloat16)`` pins the
padded band in bf16 and keeps the vectors f32, as the JAX package's
``make_fused_iter_core(J, data_dtype=jnp.bfloat16)`` does. Here the core
runs its plain version, the JAX core its Pallas kernel in interpret mode,
on the same seeded numpy inputs: both sum the exact f32 upcasts of the
same bf16 band, so one iteration agrees at f32 vectors rtol/atol 1e-5 and
dots rtol 1e-4 / atol 1e-3 (``tests/test_torch_kernels.py``'s; sums in
another order), and a Jacobi-PIPECG solve through either core takes the
same iterations with the history within 1e-4
(``torch_parity.assert_same_solve``). The CUDA entry is held against this
plain version on the card in ``tests/test_torch_cuda_dia.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_same_solve, operator, rhs

from repro.core.iteration import make_fused_iter_core as jax_core
from repro.core.pipecg import pipecg as jax_pipecg
from repro.core.preconditioners import jacobi as jax_jacobi
from repro_torch.core.iteration import make_fused_iter_core
from repro_torch.core.pipecg import pipecg
from repro_torch.core.preconditioners import jacobi

VEC = dict(rtol=1e-5, atol=1e-5)
DOTS = dict(rtol=1e-4, atol=1e-3)
TILE = 256  # small Pallas tile: several grid steps
ALPHA = np.array([0.3, 0.25, 0.37, 0.21, 0.33, 0.28, 0.4, 0.31], np.float32)
BETA = np.array([0.6, 0.81, 0.5, 0.72, 0.55, 0.9, 0.64, 0.77], np.float32)


def _padded(a, n_pad):
    out = np.zeros((*a.shape[:-1], n_pad), np.float32)
    out[..., : a.shape[-1]] = a
    return out


@pytest.mark.parametrize("k", [1, 3, 8])
def test_bf16_band_iteration_matches_jax(k):
    """One iteration through each core, as one vector (k = 1) and as k = 3
    and 8 lanes (``jax.vmap`` of the JAX core; 8 is the card kernel's widest
    launch; n = 343 is no multiple of 4); each lane of the port's batched
    plain version is its 1-D version's bits."""
    J, A = operator(7)
    jc = jax_core(J, tile=TILE, interpret=True, data_dtype=jnp.bfloat16)
    tc = make_fused_iter_core(A, data_dtype=torch.bfloat16)
    assert tc.padded_data.dtype == torch.bfloat16 and jc.padded_data.dtype == jnp.bfloat16
    n = A.n
    np.testing.assert_array_equal(tc.padded_data[:, :n].float().numpy(),
                                  np.asarray(jc.padded_data[:, :n].astype(jnp.float32)))
    rng = np.random.default_rng(7)
    vecs = [rng.standard_normal((k, n)).astype(np.float32) for _ in range(9)]
    inv = (1.0 / np.asarray(J.diagonal())).astype(np.float32)
    alpha, beta = ALPHA[:k], BETA[:k]

    jv = [jnp.asarray(_padded(v, jc.n_pad)) for v in vecs]
    jinv = jnp.asarray(_padded(inv, jc.n_pad))
    lanes = jax.vmap(jc, in_axes=(0,) * 9 + (None, 0, 0))
    *jvecs, jdots = lanes(*jv, jinv, jnp.asarray(alpha), jnp.asarray(beta))
    jdots = np.stack([np.asarray(d) for d in jdots], axis=-1)  # (k, 3)

    tv = [torch.from_numpy(_padded(v, tc.n_pad)) for v in vecs]
    tinv = torch.from_numpy(_padded(inv, tc.n_pad))
    work = [v.clone() for v in tv[:8]]
    m_out = torch.empty_like(tv[8])
    if k == 1:  # one vector: the 1-D path of the core
        *tvecs, tdots = tc(*[v[0] for v in work], tv[8][0], m_out[0], tinv, float(alpha[0]),
                           float(beta[0]))
        tvecs = [v[None] for v in tvecs]
    else:
        *tvecs, tdots = tc(*work, tv[8], m_out, tinv, torch.from_numpy(alpha),
                           torch.from_numpy(beta))
    tdots = torch.stack(list(tdots), dim=-1).reshape(k, 3)
    for g, w in zip(tvecs, jvecs):
        np.testing.assert_allclose(g[:, :n].numpy(), np.asarray(w)[:, :n], **VEC)
        assert not g[:, n:].any()  # the padded tail stays 0
    np.testing.assert_allclose(tdots.numpy(), jdots, **DOTS)
    for lane in range(k):
        one = [v[lane].clone() for v in tv[:8]]
        *vecs1, dots1 = tc(*one, tv[8][lane], torch.empty(tc.n_pad), tinv, float(alpha[lane]),
                           float(beta[lane]))
        for g, o in zip(tvecs, vecs1):
            assert torch.equal(g[lane], o)
        assert torch.equal(tdots[lane], torch.stack(list(dots1)))


def test_bf16_band_pipecg_matches_jax():
    """A Jacobi-PIPECG solve through the bf16-band core on each side: the
    same iterations, history and x (``assert_same_solve``)."""
    J, A = operator(8)
    b = rhs(J, "smooth")
    kw = dict(atol=1e-5, maxiter=200)
    jres = jax_pipecg(J, jnp.asarray(b), M=jax_jacobi(J),
                      core=jax_core(J, tile=TILE, interpret=True, data_dtype=jnp.bfloat16), **kw)
    res = pipecg(A, torch.from_numpy(b), M=jacobi(A),
                 core=make_fused_iter_core(A, data_dtype=torch.bfloat16), **kw)
    assert int(res.iterations) > 5
    assert_same_solve(res, jres)
