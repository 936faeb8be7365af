"""The port's encoder-decoder family (whisper-tiny) against the JAX
package's on the CPU, at the reduced config: ``gelu_mlp`` (f32 and bf16),
``sinusoidal``/``sinusoidal_at``, the encoder, forward logits, the prefill
cache, ``decode`` from a JAX cache carried across, teacher-forced decode,
greedy ``generate``, the converter's round trip, ``decode_step_bytes``
against a hand count, the dtype refusal and the full config.

Tolerances (tests/torch_families.py): logits, caches and encoder states
rtol 1e-4 / atol 1e-5 (f32, as tests/test_torch_lm.py); one f32 layer and
the sinusoid tables atol 1e-5 (their angles reach 1,499 rad at 1,500
frames, where the two libraries' f32 pow and sin differ by up to 3.8e-6);
bf16 within 3 bf16 eps per row
(as tests/test_torch_ssm_bf16.py); tokens and ``sinusoidal_at`` rows
exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models import mlp as jmlp
from repro_torch import configs
from repro_torch.launch import serve_lm
from repro_torch.launch.precision import rows_err
from repro_torch.models import build_model, encdec, mlp

import torch_families as fam

NAME = "whisper-tiny"
LAYER = dict(rtol=1e-5, atol=1e-6)
TABLE = dict(rtol=0, atol=1e-5)
BF16_ROW = 3 * torch.finfo(torch.bfloat16).eps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    d, f = 64, 96
    arrays = {"w_up": rng.standard_normal((d, f)) / 8, "b_up": rng.standard_normal(f) / 4,
              "w_down": rng.standard_normal((f, d)) / 10, "b_down": rng.standard_normal(d) / 4}
    x = rng.standard_normal((2, 5, d))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want = jmlp.gelu_mlp({k: jnp.asarray(v, jdt) for k, v in arrays.items()}, jnp.asarray(x, jdt))
    got = mlp.gelu_mlp({k: torch.tensor(v, dtype=torch.float32).to(tdt) for k, v in
                        arrays.items()}, torch.tensor(x, dtype=torch.float32).to(tdt))
    assert got.dtype == tdt
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LAYER)
        # the tanh approximation, as jax.nn.gelu's default; the exact GELU is off
        exact = mlp.gelu_mlp({k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()},
                             torch.tensor(x, dtype=torch.float32))
        assert torch.equal(got, exact)
        h = torch.tensor(x, dtype=torch.float32) @ torch.tensor(arrays["w_up"],
                                                                dtype=torch.float32)
        h = h + torch.tensor(arrays["b_up"], dtype=torch.float32)
        erf = torch.nn.functional.gelu(h) @ torch.tensor(arrays["w_down"], dtype=torch.float32)
        assert rows_err(erf + torch.tensor(arrays["b_down"], dtype=torch.float32), want) > 1e-5
    else:
        assert rows_err(got.float(), want) <= BF16_ROW
    zero = build_model(configs.reduced(configs.get_config(NAME))).empty_params("cpu")
    assert not zero.dec_layers[0].mlp.b_up.any() and not zero.dec_layers[0].mlp.b_down.any()


def test_sinusoidal_matches_jax_and_rows_are_bitwise():
    for T, d in ((32, 64), (1500, 384)):
        want = np.asarray(jencdec.sinusoidal(T, d, jnp.float32))
        got = encdec.sinusoidal(T, d, torch.float32)
        assert got.shape == (T, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TABLE)
        for p in (0, 1, 7, T // 2, T - 1):
            assert torch.equal(encdec.sinusoidal_at(p, d, torch.float32), got[p])
            np.testing.assert_allclose(
                encdec.sinusoidal_at(p, d, torch.float32).numpy(),
                np.asarray(jencdec.sinusoidal_at(jnp.int32(p), d, jnp.float32)), **TABLE)
            assert torch.equal(encdec.sinusoidal_at(p, d, torch.bfloat16),
                               encdec.sinusoidal(T, d, torch.bfloat16)[p])
    # computed in f32, then cast
    assert torch.equal(encdec.sinusoidal(64, 64, torch.bfloat16),
                       encdec.sinusoidal(64, 64, torch.float32).to(torch.bfloat16))


def test_encoder_matches_jax():
    japi, jparams, api, params = fam.models(NAME)
    _, frames = fam.extra(api.cfg, 2)
    want = jencdec.encdec_encode(jparams, jnp.asarray(frames), japi.cfg)
    with torch.no_grad():
        got = encdec.encdec_encode(params, torch.from_numpy(frames), api.cfg)
    assert got.shape == (2, api.cfg.enc_seq, api.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **fam.LOGITS)


def test_forward_matches_jax():
    fam.check_forward(NAME)


def test_prefill_cache_matches_jax():
    fam.check_prefill_cache(NAME, encdec.EncDecCache)


def test_decode_from_a_jax_cache_matches_jax():
    fam.check_decode_from_jax_cache(NAME, encdec.EncDecCache)


def test_teacher_forced_decode_equals_forward():
    fam.check_teacher_forcing(NAME)


def test_greedy_generate_matches_jax():
    fam.check_generate(NAME)


def test_converter_round_trips():
    fam.check_converter_round_trip(NAME, ("enc_layers", "dec_layers"))


def test_decode_step_bytes_by_hand_and_launcher(capsys):
    cfg = configs.get_config(NAME)
    d, V, L, B, S, T_enc = 384, 51865, 4, 8, 128, 1500
    # a layer: two LayerNorms (scale, bias), q/k/v/o and their three biases,
    # the GELU MLP's two matrices and two biases; then the final LayerNorm
    enc = L * (2 * 2 * d + 4 * d * d + 3 * d + 2 * d * 1536 + 1536 + d) + 2 * d
    weights = 56_393_472 - V * d - enc + B * d
    cache = 2 * L * B * 6 * 64 * (S + 1)
    want = 2 * (weights + B * V + cache + L * B * T_enc * d)
    assert serve_lm.decode_step_bytes(cfg, B, S) == want
    assert serve_lm.decode_step_cross_flops(cfg, B) == L * 2 * (B * T_enc) * d * d * 2
    serve_lm.main(["--device", "cpu", "--arch", NAME, "--batch", "2", "--prompt-len", "8",
                   "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert "family=encdec" in out and "generated 12 tokens" in out


def test_dtype_refusal():
    fam.check_dtype_refusal(NAME)


def test_config_equals_jax_and_full_count():
    cfg, jcfg = configs.get_config(NAME), jconfigs.get_config(NAME)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert build_model(cfg).n_params() == jbuild_model(jcfg).n_params() == 56_393_472
    r, jr = configs.reduced(cfg), jconfigs.reduced(jcfg)
    assert dataclasses.asdict(r) == dataclasses.asdict(jr)
