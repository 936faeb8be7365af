"""Shared helpers of the encoder-decoder and VLM parity tests
(tests/test_torch_encdec.py, tests/test_torch_vlm.py): the two packages'
models from one JAX init carried across, with numpy noise on every leaf
and, for the VLM, every cross gate set to GATE (the zero-init gate would
make a cross layer add nothing, and a wrong cross-attention pass); the
family's stub inputs; and the checks both files run on their model.

Tolerances: logits, caches and encoder states rtol 1e-4 / atol 1e-5, as
tests/test_torch_lm.py (the same f32 math in another order of sums);
tokens exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.serve import engine as jengine
from repro_torch import configs, convert
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, generate, prefill_cache

LOGITS = dict(rtol=1e-4, atol=1e-5)
GATE = 0.5
EXTRA = {"encdec": "frames", "vlm": "img_feats"}


def models(name, seed=0, **kw):
    """(JAX api, JAX params, port api, port params) of one reduced config."""
    jcfg = jconfigs.reduced(jconfigs.get_config(name), **kw)
    japi = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    if jcfg.family == "vlm":
        gate = tree["cross_layers"]["cross"]["gate"]
        tree["cross_layers"]["cross"]["gate"] = np.full_like(gate, GATE)
    cfg = configs.reduced(configs.get_config(name), **kw)
    return (japi, jax.tree.map(jnp.asarray, tree), build_model(cfg),
            convert.lm_params_from_arrays(cfg, tree, device="cpu"))


def extra(cfg, batch, seed=7):
    """(name, f32 array) of the family's stub input: encoder frames or
    image features, std 0.5 so the cross layers move the logits."""
    n = cfg.enc_seq if cfg.family == "encdec" else cfg.n_img_tokens
    rng = np.random.default_rng(seed)
    return EXTRA[cfg.family], (0.5 * rng.standard_normal((batch, n, cfg.d_model))).astype(
        np.float32)


def batches(cfg, tokens):
    """The same batch for JAX and the port."""
    name, a = extra(cfg, tokens.shape[0])
    return ({"tokens": jnp.asarray(tokens), name: jnp.asarray(a)},
            {"tokens": torch.from_numpy(tokens), name: torch.from_numpy(a)})


def tokens(shape, vocab, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def check_forward(name):
    japi, jparams, api, params = models(name)
    jb, b = batches(api.cfg, tokens((2, 24), api.cfg.vocab_size))
    want = japi.forward(jparams, jb)
    with torch.no_grad():
        got = api.forward(params, b)
    assert got.shape == (2, 24, api.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def check_prefill_cache(name, cache_type):
    japi, jparams, api, params = models(name)
    T, S = 12, 20
    jb, b = batches(api.cfg, tokens((2, T), api.cfg.vocab_size))
    jlogits, pf = japi.prefill(jparams, jb)
    jcache = jengine._copy_prefill(japi, japi.init_cache(2, S), pf, T, jb)
    with torch.no_grad():
        logits, cache = prefill_cache(api, params, b, S)
    assert isinstance(cache, cache_type)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    for got, want in zip(jax.tree.leaves(tuple(cache), is_leaf=torch.is_tensor),
                         jax.tree.leaves(jcache)):
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert not cache.self_kv.k[:, :, T:].any()


def check_decode_from_jax_cache(name, cache_type):
    """Three decode steps from a JAX cache carried across."""
    japi, jparams, api, params = models(name)
    T, S = 10, 16
    toks = tokens((2, T + 3), api.cfg.vocab_size)
    jb, _ = batches(api.cfg, toks[:, :T])
    _, pf = japi.prefill(jparams, jb)
    jcache = jengine._copy_prefill(japi, japi.init_cache(2, S), pf, T, jb)
    cache = convert.state_from_arrays(cache_type, jax.tree.map(np.asarray, jcache), device="cpu")
    for i in range(3):
        jlogits, jcache = japi.decode(jparams, jnp.asarray(toks[:, T + i:T + i + 1]), jcache,
                                      jnp.int32(T + i))
        with torch.no_grad():
            logits, out = api.decode(params, torch.from_numpy(toks[:, T + i:T + i + 1]), cache,
                                     T + i)
        assert out is cache and logits.shape == (2, 1, api.cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    np.testing.assert_allclose(cache.self_kv.k.numpy(), np.asarray(jcache.self_kv.k), **LOGITS)
    np.testing.assert_allclose(cache.self_kv.v.numpy(), np.asarray(jcache.self_kv.v), **LOGITS)


def check_teacher_forcing(name):
    """Decode fed the true tokens gives the forward's logits and k/v."""
    _, _, api, params = models(name)
    T0, T = 6, 18
    _, b = batches(api.cfg, tokens((3, T), api.cfg.vocab_size))
    ex = {k: v for k, v in b.items() if k != "tokens"}
    toks = b["tokens"]
    with torch.no_grad():
        full = api.forward(params, b)
        logits, cache = prefill_cache(api, params, {"tokens": toks[:, :T0], **ex}, T)
        steps = [logits[:, -1:]]
        for pos in range(T0, T - 1):
            lg, cache = api.decode(params, toks[:, pos:pos + 1], cache, pos)
            steps.append(lg)
        _, whole = api.prefill(params, {"tokens": toks[:, :T - 1], **ex})
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, T0 - 1:T - 1].numpy(),
                               **LOGITS)
    np.testing.assert_allclose(cache.self_kv.k[:, :, :T - 1].numpy(), whole.self_kv.k.numpy(),
                               **LOGITS)


def check_generate(name):
    japi, jparams, api, params = models(name)
    jb, b = batches(api.cfg, tokens((3, 10), api.cfg.vocab_size))
    want = jengine.generate(japi, jparams, jb, jengine.ServeConfig(max_new_tokens=8))
    got = generate(api, params, b, ServeConfig(max_new_tokens=8))
    assert got.dtype == torch.int32 and got.shape == (3, 18)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_converter_round_trip(name, groups):
    japi, jparams, api, params = models(name)
    back = convert.lm_arrays_from_params(api.cfg, params)
    assert sorted(back) == sorted(jparams)
    for g in groups:
        assert len(params[g]) == int(np.shape(jax.tree.leaves(jparams[g])[0])[0])
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(w))
    again = convert.lm_params_from_arrays(api.cfg, back, device="cpu")
    for (k, t), (_, u) in zip(params.named_parameters(), again.named_parameters()):
        assert torch.equal(t, u), k


def check_dtype_refusal(name):
    """A bf16 model refuses an f32 extra (JAX's bf16 models raise on it or
    promote quietly) and takes the extra in bf16."""
    _, _, api, params = models(name, dtype="bfloat16")
    _, b = batches(api.cfg, tokens((2, 8), api.cfg.vocab_size))
    key = EXTRA[api.cfg.family]
    with torch.no_grad():
        with pytest.raises(ValueError, match=f"{key} is torch.float32.*bfloat16"):
            api.forward(params, b)
        logits = api.forward(params, {**b, key: b[key].to(torch.bfloat16)})
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
