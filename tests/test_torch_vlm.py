"""The port's VLM family (llama-3.2-vision-11b) against the JAX package's
on the CPU, at the reduced config (3 groups of 1 self + 1 cross layer):
one gated cross layer (f32 and bf16), forward logits, the prefill cache,
``decode`` from a JAX cache carried across, teacher-forced decode, greedy
``generate``, the converter's round trip, ``decode_step_bytes`` and the
cross K/V FLOPs against a hand count, the dtype refusal and the full
config (8 groups of 4 self + 1 cross).

The cross gates are zero at init, where a cross layer adds nothing and a
wrong cross-attention would pass: every parity test sets them to 0.5 in
both packages (tests/torch_families.py), and one test checks the logits
move with the gate. Tolerances: as tests/test_torch_encdec.py (logits and
caches rtol 1e-4 / atol 1e-5; one f32 layer rtol 1e-5 / atol 1e-6; bf16
within 3 bf16 eps per row; tokens exactly equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.models import vlm as jvlm
from repro_torch import configs
from repro_torch.launch import serve_lm
from repro_torch.launch.precision import rows_err
from repro_torch.models import build_model, vlm

import torch_families as fam

NAME = "llama-3.2-vision-11b"
LAYER = dict(rtol=1e-5, atol=1e-6)
BF16_ROW = 3 * torch.finfo(torch.bfloat16).eps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_layer_matches_jax(dtype):
    japi, jparams, api, params = fam.models(NAME, dtype=dtype)
    cfg = api.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    _, img = fam.extra(cfg, 2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jlp = jax.tree.map(lambda a: a[1], jparams["cross_layers"])
    want = jvlm._cross_apply(jlp, jnp.asarray(x, jdt), jnp.asarray(img, jdt), japi.cfg)
    with torch.no_grad():
        got = vlm._cross_apply(params["cross_layers"][1], torch.from_numpy(x).to(api.dtype),
                               torch.from_numpy(img).to(api.dtype), cfg)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LAYER)
    else:
        assert got.dtype == torch.bfloat16 and rows_err(got.float(), want) <= BF16_ROW


def test_forward_matches_jax_and_moves_with_the_gate():
    fam.check_forward(NAME)
    _, _, api, params = fam.models(NAME)
    _, b = fam.batches(api.cfg, fam.tokens((2, 12), api.cfg.vocab_size))
    with torch.no_grad():
        gated = api.forward(params, b)
        for lp in params["cross_layers"]:
            lp["cross"]["gate"].zero_()
        shut = api.forward(params, b)
        moved = api.forward(params, {**b, "img_feats": 2 * b["img_feats"]})
    assert rows_err(shut, gated) > 1e-2  # the gated cross-attention takes part
    # a zero gate shuts the image out: the model is its text-only backbone
    assert torch.equal(shut, moved)


def test_prefill_cache_matches_jax():
    fam.check_prefill_cache(NAME, vlm.VLMCache)


def test_decode_from_a_jax_cache_matches_jax():
    fam.check_decode_from_jax_cache(NAME, vlm.VLMCache)


def test_teacher_forced_decode_equals_forward():
    fam.check_teacher_forcing(NAME)


def test_greedy_generate_matches_jax():
    fam.check_generate(NAME)


def test_converter_round_trips():
    fam.check_converter_round_trip(NAME, ("self_layers", "cross_layers"))
    _, _, _, params = fam.models(NAME)
    assert [lp["cross"]["gate"].item() for lp in params["cross_layers"]] == [fam.GATE] * 3
    assert params["cross_layers"][0]["cross"]["gate"].shape == (1,)


def test_decode_step_bytes_and_flops_by_hand_and_launcher(capsys):
    cfg = configs.get_config(NAME)
    d, V, B, S, n_img, kv = 4096, 128256, 8, 576, 1601, 8 * 128
    weights = 9_775_157_256 - d * V + B * d  # untied head out; embedding rows
    caches = 2 * 32 * B * kv * (S + 1)
    want = 2 * (weights + B * V + caches + 8 * B * n_img * d)
    assert serve_lm.decode_step_bytes(cfg, B, S) == want
    flops = serve_lm.decode_step_cross_flops(cfg, B)
    assert flops == 8 * 2 * (B * n_img) * d * kv * 2
    assert 1.7e12 < flops < 1.75e12  # ~1.7 TFLOP a step at batch 8
    serve_lm.main(["--device", "cpu", "--arch", NAME, "--batch", "2", "--prompt-len", "8",
                   "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert "family=vlm" in out and "generated 12 tokens" in out


def test_dtype_refusal():
    fam.check_dtype_refusal(NAME)
    _, _, api, params = fam.models(NAME, dtype="bfloat16")
    cache = api.init_cache(2, 8, device="cpu")
    cache = cache._replace(img_feats=cache.img_feats.float())
    with torch.no_grad(), pytest.raises(ValueError, match="img_feats"):
        api.decode(params, torch.zeros((2, 1), dtype=torch.int32), cache, 0)


def test_config_equals_jax_and_full_layout():
    cfg, jcfg = configs.get_config(NAME), jconfigs.get_config(NAME)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    api = build_model(cfg)
    assert api.n_params() == jbuild_model(jcfg).n_params() == 9_775_157_256
    assert vlm._groups(cfg) == (8, 4)
    assert len(api.layout["self_layers"]) == 32 and len(api.layout["cross_layers"]) == 8
    r, jr = configs.reduced(cfg), jconfigs.reduced(jcfg)
    assert dataclasses.asdict(r) == dataclasses.asdict(jr)
    cache = build_model(r).init_cache(2, 8, device="cpu")
    assert cache.self_kv.k.shape == (3, 2, 8, r.n_kv_heads, r.head_dim_)
    assert cache.img_feats.shape == (2, r.n_img_tokens, r.d_model)
