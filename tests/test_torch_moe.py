"""The port's MoE family against the JAX package's on the CPU: the two
configs, the capacity rule, ``moe_ffn`` (normal capacity, dropped
assignments, and a zero router where every expert ties), the MoE LM
forward, the converter and two train steps.

Inputs come from numpy seeds, or from the JAX package's init carried
across with the converter. Tolerances (f32): ``moe_ffn`` y rtol 1e-5 /
atol 1e-6 and aux rtol 1e-6 (one layer, the same products summed in
another order); LM logits rtol 1e-4 / atol 1e-5, as tests/test_torch_lm.py;
train steps at tests/test_torch_train.py's (losses rtol 1e-5, grad norms
rtol 1e-4, parameters rtol 1e-4 / atol 5e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.train as jtrain
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro_torch import configs, convert
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.models import build_model
from repro_torch.models.moe import moe_capacity, moe_ffn, top_k_stable
from repro_torch.train import AdamWConfig, TrainConfig, batch_to_device, make_train_step

MOE = {"olmoe-1b-7b": 6_919_100_416, "granite-moe-1b-a400m": 1_334_628_352}
LOGITS = dict(rtol=1e-4, atol=1e-5)


def _jax_params(name, seed=0, **kw):
    """A reduced JAX MoE model's parameters as numpy arrays, with numpy
    noise on every leaf so the unit norm scales take part too."""
    jcfg = jconfigs.reduced(jconfigs.get_config(name), **kw)
    tree = jax.tree.map(np.asarray, jbuild_model(jcfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    return jcfg, configs.reduced(configs.get_config(name), **kw), tree


def test_moe_configs_equal_jax_field_by_field():
    for name, n in MOE.items():
        want, got = jconfigs.get_config(name), configs.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        small = configs.reduced(got)
        assert dataclasses.asdict(small) == dataclasses.asdict(jconfigs.reduced(want))
        assert build_model(got).n_params() == jbuild_model(want).n_params() == n, name
        assert build_model(small).n_params() == jbuild_model(jconfigs.reduced(want)).n_params()
    assert set(MOE) < set(configs.list_configs())


def test_moe_capacity_matches_jax_over_a_grid():
    for n_tok in (1, 7, 8, 64, 4096, 4103):
        for k, e in ((1, 4), (2, 8), (8, 32), (8, 64)):
            for cf in (0.5, 1.0, 1.25, 2.0):
                assert moe_capacity(n_tok, k, e, cf) == jmoe.moe_capacity(n_tok, k, e, cf), (
                    n_tok, k, e, cf)


def test_top_k_order_matches_jax_on_ties():
    # values from a handful of levels: most rows hold ties across the k-th place
    x = np.random.default_rng(0).integers(0, 4, (256, 64)).astype(np.float32) / 4
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 8)
    vals, idx = top_k_stable(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("case", ["normal", "dropped", "zero_router"])
def test_moe_ffn_matches_jax(case):
    T, d, f, E, k = 48, 32, 24, 8, 2
    rng = np.random.default_rng(3)
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    if case == "zero_router":  # every probability 1/E: top-k picks experts 0..k-1 for all
        p["router"] = np.zeros((d, E))
    p = {n: a.astype(np.float32) for n, a in p.items()}
    x = rng.standard_normal((T, d)).astype(np.float32)
    cf = 0.5 if case == "dropped" else 1.25
    jy, jaux = jmoe.moe_ffn({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), k, cf)
    y, aux = moe_ffn({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x), k, cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    C = moe_capacity(T, k, E, cf)
    if case == "dropped":
        assert C == 8 and T * k > E * C  # assignments must be dropped
    if case == "zero_router":
        # experts 0 and 1 take every token; only the first C keep both gates
        vals, idx = top_k_stable(torch.full((T, E), 1.0 / E), k)
        assert idx.tolist() == [[0, 1]] * T
        assert not y[C:].any() and y[:C].abs().sum() > 0
        assert float(aux) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_moe_lm_forward_matches_jax(name):
    jcfg, cfg, tree = _jax_params(name)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlogits, jaux = jbuild_model(jcfg).forward(jax.tree.map(jnp.asarray, tree),
                                               {"tokens": jnp.asarray(tokens)})
    params = convert.lm_params_from_arrays(cfg, tree, device="cpu")
    with torch.no_grad():
        logits, aux = build_model(cfg).forward(params, {"tokens": torch.from_numpy(tokens)})
    assert logits.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGITS)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_converter_round_trips():
    jcfg, cfg, tree = _jax_params("olmoe-1b-7b")
    params = convert.lm_params_from_arrays(cfg, tree, device="cpu")
    named = dict(params.named_parameters())
    assert named["layers.3.moe.w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    np.testing.assert_array_equal(named["layers.2.moe.router"].detach().numpy(),
                                  tree["layers"]["moe"]["router"][2])
    back = convert.lm_arrays_from_params(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_two_train_steps_match_jax():
    name = "granite-moe-1b-a400m"
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    cfg = configs.reduced(configs.get_config(name))
    japi, api = jbuild_model(jcfg), build_model(cfg)
    jstate = jtrain.init_train_state(japi, jax.random.PRNGKey(0))
    state = convert.train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    opt = dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0)
    jstep = jax.jit(jtrain.make_train_step(
        japi, jtrain.TrainConfig(optimizer=jtrain.AdamWConfig(**opt))))
    step = make_train_step(api, TrainConfig(optimizer=AdamWConfig(**opt)))
    dc = SyntheticConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size, seed=1)
    for s in range(2):
        batch = batch_for_step(dc, s)
        jstate, jm = jstep(jstate, {n: jnp.asarray(v) for n, v in batch.items()})
        state, m = step(state, batch_to_device(batch, "cpu"))
        for key in ("loss", "nll", "aux"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["aux"]) > 0
    back = convert.lm_arrays_from_params(cfg, state.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=5e-5)
