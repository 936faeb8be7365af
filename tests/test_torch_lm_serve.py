"""The port's LM serving against the JAX package's on the CPU: the prefill
cache, ``_sdpa_decode``, one ``decode`` step, teacher-forced decode,
``generate`` (greedy, with ``eos_id``, sampled), ``cross_attention`` and
the ``launch.serve_lm`` launcher, for the dense and MoE families at the
reduced configs in f32.

Inputs come from numpy seeds, or from the JAX package's init carried
across with the converter. Tolerances: logits and caches rtol 1e-4 /
atol 1e-5, as tests/test_torch_lm.py (the same f32 math in another order
of sums); ``_sdpa_decode`` and ``cross_attention`` rtol 1e-5 / atol 1e-6
(one layer); tokens exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.serve import engine as jengine
from repro_torch import configs, convert
from repro_torch.launch import serve_lm
from repro_torch.models import build_model
from repro_torch.models.attention import KVCache, _sdpa_decode, cross_attention
from repro_torch.serve import ServeConfig, generate, make_decode_step

LOGITS = dict(rtol=1e-4, atol=1e-5)
LAYER = dict(rtol=1e-5, atol=1e-6)
FAMILIES = {"dense": "internlm2-1.8b", "moe": "olmoe-1b-7b"}


def _models(name, seed=0, **kw):
    """(JAX api, JAX params, port api, port params) of one reduced config,
    numpy noise on every leaf so the unit norm scales take part too."""
    jcfg = jconfigs.reduced(jconfigs.get_config(name), **kw)
    japi = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    cfg = configs.reduced(configs.get_config(name), **kw)
    return (japi, jax.tree.map(jnp.asarray, tree), build_model(cfg),
            convert.lm_params_from_arrays(cfg, tree, device="cpu"))


def _tokens(shape, vocab, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_cache_matches_jax(family):
    japi, jparams, api, params = _models(FAMILIES[family])
    tokens = _tokens((2, 24), api.cfg.vocab_size)
    jlogits, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, cache = api.prefill(params, {"tokens": torch.from_numpy(tokens)})
    cfg = api.cfg
    assert cache.k.shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim_)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **LOGITS)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **LOGITS)


@pytest.mark.parametrize("pos", [0, 1, 11])
def test_sdpa_decode_matches_jax(pos):
    B, S, H, KV, hd = 3, 12, 4, 2, 16
    rng = np.random.default_rng(pos)
    q, k_cur, v_cur = (rng.standard_normal(s).astype(np.float32)
                       for s in ((B, 1, H, hd), (B, 1, KV, hd), (B, 1, KV, hd)))
    ck, cv = (rng.standard_normal((B, S, KV, hd)).astype(np.float32) for _ in range(2))
    want = jattention._sdpa_decode(jnp.asarray(q), jnp.asarray(k_cur), jnp.asarray(v_cur),
                                   jattention.KVCache(jnp.asarray(ck), jnp.asarray(cv)), pos,
                                   H // KV)
    t = torch.from_numpy
    got = _sdpa_decode(t(q), t(k_cur), t(v_cur), KVCache(t(ck), t(cv)), pos, H // KV)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    # positions >= pos are never read: garbage there changes no bit
    ck[:, pos:], cv[:, pos:] = 1e3, -1e3
    again = _sdpa_decode(t(q), t(k_cur), t(v_cur), KVCache(t(ck), t(cv)), pos, H // KV)
    assert torch.equal(again, got)
    if pos == 0:  # only the current token: the output is its v, per group
        np.testing.assert_allclose(got.numpy(), np.repeat(v_cur, H // KV, axis=2), **LAYER)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_step_matches_jax(family):
    japi, jparams, api, params = _models(FAMILIES[family])
    T, S = 16, 24
    tokens = _tokens((2, T + 1), api.cfg.vocab_size)
    batch = {"tokens": jnp.asarray(tokens[:, :T])}
    _, pf = japi.prefill(jparams, batch)
    jcache = jengine._copy_prefill(japi, japi.init_cache(2, S), pf, T, batch)
    cache = convert.kv_cache_from_arrays(np.asarray(jcache.k), np.asarray(jcache.v), device="cpu")
    jlogits, jcache = japi.decode(jparams, jnp.asarray(tokens[:, T:]), jcache, T)
    step = make_decode_step(api)
    with torch.no_grad():
        logits, out = step(params, torch.from_numpy(tokens[:, T:]), cache, T)
    assert out is cache  # the port writes the preallocated cache in place
    assert logits.shape == (2, 1, api.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    np.testing.assert_allclose(out.k.numpy(), np.asarray(jcache.k), **LOGITS)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(jcache.v), **LOGITS)
    assert not out.k[:, :, T + 1:].any()


def test_teacher_forced_decode_equals_forward():
    _, _, api, params = _models("internlm2-1.8b")
    T0, T = 10, 26
    tokens = torch.from_numpy(_tokens((3, T), api.cfg.vocab_size))
    with torch.no_grad():
        full = api.forward(params, {"tokens": tokens})
        logits, pf = api.prefill(params, {"tokens": tokens[:, :T0]})
        cache = api.init_cache(3, T, device="cpu")
        cache.k[:, :, :T0], cache.v[:, :, :T0] = pf.k, pf.v
        steps = [logits[:, -1:]]
        for pos in range(T0, T - 1):
            lg, cache = api.decode(params, tokens[:, pos:pos + 1], cache, pos)
            steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, T0 - 1:T - 1].numpy(),
                               **LOGITS)
    with torch.no_grad():  # the decoded k/v are the forward's
        _, whole = api.prefill(params, {"tokens": tokens[:, :T - 1]})
    np.testing.assert_allclose(cache.k[:, :, :T - 1].numpy(), whole.k.numpy(), **LOGITS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_generate_matches_jax(family):
    japi, jparams, api, params = _models(FAMILIES[family])
    tokens = _tokens((3, 12), api.cfg.vocab_size)
    want = jengine.generate(japi, jparams, {"tokens": jnp.asarray(tokens)},
                            jengine.ServeConfig(max_new_tokens=10))
    got = generate(api, params, {"tokens": torch.from_numpy(tokens)},
                   ServeConfig(max_new_tokens=10))
    assert got.dtype == torch.int32 and got.shape == (3, 22)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_with_eos_matches_jax_and_leaves_a_zero_tail():
    japi, jparams, api, params = _models("olmoe-1b-7b", seed=1)
    T, n = 8, 24
    # two prompts, each twice: capacity drops in the prefill still part the copies
    tokens = np.tile(_tokens((2, T), api.cfg.vocab_size, seed=2), (2, 1))
    greedy = np.asarray(jengine.generate(japi, jparams, {"tokens": jnp.asarray(tokens)},
                                         jengine.ServeConfig(max_new_tokens=n)))[:, T + 1:]
    # an eos that every row emits, at different steps, well before the end
    first = {int(t): [list(row).index(t) if t in row else n for row in greedy]
             for t in np.unique(greedy)}
    eos = min(first, key=lambda t: (max(first[t]), -len(set(first[t]))))
    assert max(first[eos]) < n - 3 and len(set(first[eos])) > 1, first[eos]
    sc = ServeConfig(max_new_tokens=n, eos_id=eos)
    want = np.asarray(jengine.generate(japi, jparams, {"tokens": jnp.asarray(tokens)},
                                       jengine.ServeConfig(max_new_tokens=n, eos_id=eos)))
    stop = T + 1 + max(first[eos]) + 1  # after the last row's eos every column is 0
    assert not want[:, stop:].any() and want[:, stop - 1].all()
    for poll in (1, 3, 8):
        got = generate(api, params, {"tokens": torch.from_numpy(tokens)}, sc, poll_every=poll)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_is_seeded_and_tends_to_greedy():
    _, _, api, params = _models("internlm2-1.8b")
    batch = {"tokens": torch.from_numpy(_tokens((4, 8), api.cfg.vocab_size))}

    def run(temperature, seed):
        gen = torch.Generator().manual_seed(seed)
        return generate(api, params, batch, ServeConfig(max_new_tokens=12,
                                                        temperature=temperature), gen)

    a, b, c = run(1.0, 3), run(1.0, 3), run(1.0, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, run(0.0, 3))
    assert torch.equal(run(1e-6, 3), run(0.0, 3))


def test_cross_attention_matches_jax():
    cfg = configs.reduced(configs.get_config("qwen2.5-14b"))  # qkv_bias, GQA 2:1
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen2.5-14b"))
    rng = np.random.default_rng(7)
    d, hd = cfg.d_model, cfg.head_dim_
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d), "bq": (qd,),
         "bk": (kvd,), "bv": (kvd,), "gate": (1,)}
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for n, s in p.items()}
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    feats = rng.standard_normal((2, 13, d)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    for gated in (False, True):
        want = jattention.cross_attention(jp, jnp.asarray(x), jnp.asarray(feats), jcfg, gated)
        got = cross_attention(tp, torch.from_numpy(x), torch.from_numpy(feats), cfg, gated)
        assert got.shape == (2, 9, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_serve_lm_launcher_on_cpu(capsys):
    serve_lm.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--batch", "2",
                   "--prompt-len", "8", "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b family=moe" in out and "device=cpu" in out
    assert "generated 12 tokens" in out and "seq 1: ..." in out
    # the decode bound's bytes: internlm2-1.8b at batch 8, 576 positions, bf16
    cfg = configs.get_config("internlm2-1.8b")
    weights = 1_889_110_016 - cfg.vocab_size * cfg.d_model + 8 * cfg.d_model
    cache = 2 * 24 * 8 * 8 * 128 * (576 + 1)
    assert serve_lm.decode_step_bytes(cfg, 8, 576) == 2 * (weights + cache + 8 * cfg.vocab_size)
