"""The port's LM substrate against the JAX package's on the CPU: configs,
synthetic data, the init rule, the parameter converter, the dense
forward and the loss.

Inputs come from numpy seeds (or the JAX package's own init, carried
across with the converter). Tolerances: forward logits in f32 rtol 1e-4
(atol 1e-5), the same math in another order of f32 sums; the loss rtol
1e-6; data and converted arrays exactly equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
from repro.models import build_model as jbuild_model
from repro.train import init_train_state as jinit_train_state
from repro.train import loss as jloss
from repro_torch import configs, convert
from repro_torch.data import SyntheticConfig, batch_for_step, prefetch_batches
from repro_torch.models import build_model, make_generator
from repro_torch.train import ce_loss, next_token_loss

DENSE = ["internlm2-1.8b", "qwen3-8b", "qwen2.5-14b", "stablelm-1.6b"]


def _jax_params(cfg_kw, name="internlm2-1.8b", seed=0, perturb=True):
    """A reduced JAX model's parameters as numpy arrays; ``perturb`` adds
    numpy noise to every leaf so zero-initialised biases and unit norm
    scales take part in the comparison too."""
    jcfg = jconfigs.reduced(jconfigs.get_config(name), **cfg_kw)
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init_params(jax.random.PRNGKey(seed)))
    if perturb:
        rng = np.random.default_rng(seed)
        tree = jax.tree.map(
            lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    return jcfg, configs.reduced(configs.get_config(name), **cfg_kw), tree


def test_configs_equal_jax_field_by_field():
    assert configs.list_configs() == jconfigs.list_configs()  # all ten, every family
    for name in configs.list_configs():
        want, got = jconfigs.get_config(name), configs.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert dataclasses.asdict(configs.reduced(got)) == dataclasses.asdict(jconfigs.reduced(want))
        assert dataclasses.asdict(configs.reduced(got, attn_chunk=16)) == dataclasses.asdict(
            jconfigs.reduced(want, attn_chunk=16))
        assert build_model(got).n_params() == jbuild_model(want).n_params(), name
    assert configs.SHAPES == {k: configs.ShapeConfig(**dataclasses.asdict(v))
                              for k, v in jconfigs.SHAPES.items()}
    full = build_model(configs.get_config("internlm2-1.8b"))
    assert full.n_params() == 1_889_110_016
    unknown = configs.reduced(dataclasses.replace(configs.get_config("internlm2-1.8b"),
                                                  family="retnet"))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(unknown)


def test_synthetic_batches_bit_equal():
    dc = SyntheticConfig(batch=4, seq_len=33, vocab_size=92544, seed=3)
    jdc = jdata.SyntheticConfig(batch=4, seq_len=33, vocab_size=92544, seed=3)
    for step in (0, 7, 1234):
        a, b = batch_for_step(dc, step), jdata.batch_for_step(jdc, step)
        assert a.keys() == b.keys() and a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    got = list(prefetch_batches(dc, 5, 4))
    want = list(jdata.prefetch_batches(jdc, 5, 4))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_init_statistics_follow_the_jax_rule():
    cfg = configs.reduced(configs.get_config("qwen2.5-14b"), vocab_size=8192, d_model=128,
                          d_ff=384, n_heads=4, n_kv_heads=2, head_dim=32, dtype="bfloat16")
    params = build_model(cfg).init_params(make_generator(0, "cpu"))
    named = dict(params.named_parameters())
    assert all(t.dtype == torch.bfloat16 for t in named.values())

    def std_ok(name, fan_in):
        t = named[name].detach().float()
        assert abs(float(t.mean())) < 0.05 / math.sqrt(fan_in), name
        assert float(t.std()) == pytest.approx(1 / math.sqrt(fan_in), rel=0.05), name

    std_ok("embedding", 8192)  # fan_in = shape[-2] = V, not d
    std_ok("lm_head", 128)
    std_ok("layers.0.attn.wq", 128)
    std_ok("layers.3.mlp.w_down", 384)
    assert torch.equal(named["layers.1.attn_norm.scale"].float(), torch.ones(128))
    assert torch.equal(named["layers.2.attn.bk"].float(), torch.zeros(64))
    other = build_model(cfg).init_params(make_generator(1, "cpu"))
    assert not torch.equal(other.embedding, params.embedding)
    again = build_model(cfg).init_params(make_generator(0, "cpu"))
    assert torch.equal(again.layers[3].mlp.w_up, params.layers[3].mlp.w_up)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips(dtype):
    jcfg, cfg, tree = _jax_params({"dtype": dtype}, "qwen3-8b", perturb=False)
    params = convert.lm_params_from_arrays(cfg, tree, device="cpu")
    assert len(list(params.named_parameters())) == 3 + 4 * 11  # qk_norm: 11 per layer
    back = convert.lm_arrays_from_params(cfg, params)
    flat_t, flat_b = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(flat_t, flat_b):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    jstate = jax.tree.map(np.asarray, jinit_train_state(jbuild_model(jcfg), jax.random.PRNGKey(1)))
    state = convert.train_state_from_arrays(cfg, jstate, device="cpu")
    assert int(state.step) == 0 and int(state.opt.step) == 0 and float(state.opt.prev_norm) == 1.0
    assert state.opt.m.keys() == dict(state.params.named_parameters()).keys()
    assert all(m.dtype == torch.float32 and not m.any() for m in state.opt.m.values())
    with pytest.raises(ValueError, match="names differ"):
        convert.lm_params_from_arrays(cfg, {**tree, "extra": np.zeros(3)}, device="cpu")


@pytest.mark.parametrize("name,kw", [
    ("internlm2-1.8b", {}),
    ("qwen3-8b", {}),                        # qk_norm
    ("qwen2.5-14b", {}),                     # qkv_bias
    ("stablelm-1.6b", {}),                   # layernorm, MHA
    ("internlm2-1.8b", {"attn_chunk": 16}),  # blocked-causal attention
])
def test_forward_matches_jax(name, kw):
    jcfg, cfg, tree = _jax_params(kw, name)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want = np.asarray(jbuild_model(jcfg).forward(jax.tree.map(jnp.asarray, tree),
                                                 {"tokens": jnp.asarray(tokens)}))
    api = build_model(cfg)
    params = convert.lm_params_from_arrays(cfg, tree, device="cpu")
    with torch.no_grad():
        got = api.forward(params, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert got.shape == want.shape == (2, 64, cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_losses_match_jax_with_z_loss():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((3, 17, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 17)).astype(np.int32)
    for z in (0.0, 1e-3):
        got = ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=z)
        want = jloss.ce_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        got = next_token_loss(torch.from_numpy(logits), torch.from_numpy(labels), z_loss=z)
        want = jloss.next_token_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    want = jloss.ce_loss(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16), jnp.asarray(labels))
    np.testing.assert_allclose(float(ce_loss(bf, torch.from_numpy(labels))), float(want), rtol=1e-6)
