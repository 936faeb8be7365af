"""The port's SSM (xlstm-1.3b) and hybrid (zamba2-2.7b) families against
the JAX package's on the CPU, at the reduced configs in f32: the forward,
the prefill state, ``decode`` from a JAX state carried across, teacher-
forced decode, greedy ``generate`` (with and without ``eos_id``), the
converter's stacked groups, the chunk refusal, ``decode_step_bytes`` and
the ``launch.serve_lm`` launcher.

Weights are the JAX package's init carried across by the converter, plus
numpy noise on every leaf. Tolerances: logits and every state leaf rtol
1e-4 / atol 1e-5, as tests/test_torch_lm_serve.py; tokens exactly equal.
The port's decode updates its state in place.
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
from repro_torch.launch import serve_lm
from repro_torch.models import build_model, mamba, xlstm
from repro_torch.serve import ServeConfig, generate, prefill_cache

LOGITS = dict(rtol=1e-4, atol=1e-5)
FAMILIES = {"hybrid": "zamba2-2.7b", "ssm": "xlstm-1.3b"}
STATE_TYPES = {"hybrid": mamba.ZambaState, "ssm": xlstm.XLSTMState}


def _models(name, seed=0):
    """(JAX api, JAX params, port api, port params) of one reduced config."""
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    japi = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    cfg = configs.reduced(configs.get_config(name))
    return (japi, jax.tree.map(jnp.asarray, tree), build_model(cfg),
            convert.lm_params_from_arrays(cfg, tree, device="cpu"))


def _tokens(shape, vocab, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _leaves(state):
    """The tensors of a port state, in the JAX state's leaf order."""
    return jax.tree.leaves(tuple(state), is_leaf=lambda x: isinstance(x, torch.Tensor))


def _states_close(got, want):
    want = jax.tree.leaves(want)
    got = _leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGITS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_matches_jax(family):
    japi, jparams, api, params = _models(FAMILIES[family])
    tokens = _tokens((2, 32), api.cfg.vocab_size)
    jlogits, jstate = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        full = api.forward(params, {"tokens": torch.from_numpy(tokens)})
        logits, state = api.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 32, api.cfg.vocab_size)
    np.testing.assert_allclose(full.numpy(), np.asarray(jlogits), **LOGITS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    _states_close(state, jstate)
    if family == "hybrid":
        assert state.pos.dtype == torch.int32 and int(state.pos) == 32


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_step_matches_jax(family):
    japi, jparams, api, params = _models(FAMILIES[family])
    T, S = 16, 24
    tokens = _tokens((2, T + 1), api.cfg.vocab_size)
    batch = {"tokens": jnp.asarray(tokens[:, :T])}
    _, pf = japi.prefill(jparams, batch)
    jstate = jengine._copy_prefill(japi, japi.init_cache(2, S), pf, T, batch)
    state = convert.state_from_arrays(STATE_TYPES[family], jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    jlogits, jstate = japi.decode(jparams, jnp.asarray(tokens[:, T:]), jstate, T)
    with torch.no_grad():
        logits, out = api.decode(params, torch.from_numpy(tokens[:, T:]), state, T)
    assert out is state  # stepped in place
    assert logits.shape == (2, 1, api.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    _states_close(out, jstate)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_teacher_forced_decode_equals_forward(family, monkeypatch):
    _, _, api, params = _models(FAMILIES[family])
    T0, n = 16, 16
    tokens = torch.from_numpy(_tokens((3, T0 + n), api.cfg.vocab_size))

    def no_zero_state(*args, **kwargs):  # prefill_cache allocates only a KV cache
        raise AssertionError("prefill_cache allocated a whole zero state")

    monkeypatch.setattr(type(api), "init_cache", no_zero_state)
    with torch.no_grad():
        full = api.forward(params, {"tokens": tokens})
        _, state = prefill_cache(api, params, {"tokens": tokens[:, :T0]}, T0 + n)
    if family == "hybrid":
        assert state.attn_kv.k.shape[2] == T0 + n
    with torch.no_grad():
        steps = []
        for pos in range(T0, T0 + n):
            lg, state = api.decode(params, tokens[:, pos:pos + 1], state, pos)
            steps.append(lg)
        # the recurrence's state is the chunked pass's over all the tokens
        _, whole = api.prefill(params, {"tokens": tokens})
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, T0:].numpy(), **LOGITS)
    for g, w in zip(_leaves(state), _leaves(whole)):  # the KV cache too, for hybrid
        np.testing.assert_allclose(g.numpy(), w.numpy(), **LOGITS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_generate_matches_jax(family):
    japi, jparams, api, params = _models(FAMILIES[family])
    tokens = _tokens((3, 16), api.cfg.vocab_size)
    want = jengine.generate(japi, jparams, {"tokens": jnp.asarray(tokens)},
                            jengine.ServeConfig(max_new_tokens=10))
    got = generate(api, params, {"tokens": torch.from_numpy(tokens)},
                   ServeConfig(max_new_tokens=10))
    assert got.dtype == torch.int32 and got.shape == (3, 26)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_with_eos_matches_jax(family):
    japi, jparams, api, params = _models(FAMILIES[family], seed=1)
    T, n = 16, 24
    tokens = _tokens((3, T), api.cfg.vocab_size, seed=2)
    greedy = np.asarray(jengine.generate(japi, jparams, {"tokens": jnp.asarray(tokens)},
                                         jengine.ServeConfig(max_new_tokens=n)))[:, T + 1:]
    # the token that every row emits soonest, else row 0's fourth
    first = {int(t): max(list(row).index(t) for row in greedy)
             for t in np.unique(greedy) if all(t in row for row in greedy)}
    eos = min(first, key=first.get) if first else int(greedy[0, 3])
    want = np.asarray(jengine.generate(japi, jparams, {"tokens": jnp.asarray(tokens)},
                                       jengine.ServeConfig(max_new_tokens=n, eos_id=eos)))
    assert not want[:, -1].any()  # every row stopped, so the loop ended early
    for poll in (1, 8):
        got = generate(api, params, {"tokens": torch.from_numpy(tokens)},
                       ServeConfig(max_new_tokens=n, eos_id=eos), poll_every=poll)
        np.testing.assert_array_equal(got.numpy(), want)


def test_converter_round_trip_and_chunk_refusal():
    for name, groups in (("zamba2-2.7b", {"mamba": 4}), ("xlstm-1.3b", {"mlstm": 2, "slstm": 2})):
        japi, jparams, api, params = _models(name)
        tree = jax.tree.map(np.asarray, jparams)
        back = convert.lm_arrays_from_params(api.cfg, params)
        assert jax.tree.structure(tree) == jax.tree.structure(back)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, b)
        for g, count in groups.items():
            assert len(params[g]) == count and back[g]["w_out"].shape[0] == count
        if name == "zamba2-2.7b":  # one set of shared weights, unstacked
            assert back["shared_attn"]["attn"]["wq"].shape == (64, 32)
        # T not a multiple of the chunk: refused, never padded
        with pytest.raises(ValueError, match="multiple of the chunk"):
            api.prefill(params, {"tokens": torch.zeros((1, api.cfg.chunk + 1), dtype=torch.int32)})
        with pytest.raises(AssertionError):
            japi.prefill(jparams, {"tokens": jnp.zeros((1, api.cfg.chunk + 1), jnp.int32)})


def test_decode_step_bytes_from_the_state_shapes():
    for name in FAMILIES.values():
        for cfg, batch, seq in ((configs.reduced(configs.get_config(name)), 2, 24),
                                (configs.get_config(name), 8, 576)):
            api = build_model(cfg)
            item = 2 if cfg.dtype == "bfloat16" else 4
            state = api.init_cache(batch, seq, device="meta")  # shapes only
            leaves = _leaves(state)
            if cfg.family == "hybrid":
                kv = state.attn_kv.k.numel() * item  # one of k, v
                new_kv = 2 * kv // seq
                recurrent = sum(t.numel() * t.element_size() for t in leaves[:3])
                cache = 2 * kv + new_kv
            else:
                recurrent = sum(t.numel() * 4 for t in leaves)
                cache = 0
            weights = api.n_params() - cfg.vocab_size * cfg.d_model + batch * cfg.d_model
            want = item * (weights + batch * cfg.vocab_size) + 2 * recurrent + cache
            assert serve_lm.decode_step_bytes(cfg, batch, seq) == want, name
    # full width at batch 8 x 576: zamba2 ~6.3 GB, xlstm ~18.1 GB (5.64 GB of state, twice)
    assert round(serve_lm.decode_step_bytes(configs.get_config("zamba2-2.7b"), 8, 576) / 1e9,
                 1) == 6.3
    assert round(serve_lm.decode_step_bytes(configs.get_config("xlstm-1.3b"), 8, 576) / 1e9,
                 1) == 18.1


@pytest.mark.parametrize("arch", sorted(FAMILIES.values()))
def test_serve_lm_launcher_on_cpu(capsys, arch):
    serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "16",
                   "--new-tokens", "6"])
    out = capsys.readouterr().out
    family = build_model(configs.reduced(configs.get_config(arch))).cfg.family
    assert f"arch={arch} family={family}" in out and "device=cpu" in out
    assert "generated 12 tokens" in out and "seq 1: ..." in out
