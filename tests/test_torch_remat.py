"""Remat in every family of the port, against the JAX package's on the
CPU at the reduced configs in f32.

* three train steps of the SSM, hybrid, encoder-decoder, VLM and MoE
  families under remat against JAX's jitted step (loss, grad norm, the
  updated parameters), as tests/test_torch_train.py does for dense;
* in every family the three modes (False, True, "save_collectives") give
  the same loss and the same gradients, and a cache or state asked of a
  remat forward raises;
* "save_collectives" trains stablelm-1.6b to JAX's loss and grad norm
  (tests/test_models_smoke.py::test_save_collectives_remat_matches);
* the selective policy saves the ``attn_out`` and ``mlp_out`` values: the
  backward's recompute runs no tagged op in a dense stack (a recompute
  hook counts them), while every other op of the layer runs again;
* the GLA gate's gradient is finite at decays up to 14 a step, where
  JAX's (whose mask follows ``exp``) is not.

Tolerances: losses rtol 1e-5, grad norms rtol 1e-4 (tests/test_torch_train.py),
parameters after the steps rtol 1e-4 / atol 1e-4, a tenth of one step's
move at lr 1e-3: tests/test_torch_train.py's atol 5e-5 holds for its
dense model, but here one parameter of 6,144 (zamba2) and of 8,192
(stablelm, after one step, where Adam moves each parameter by about lr
times the sign of its gradient) reached 7-8e-5. The attention key bias is
not compared: softmax is unchanged by a constant added to a query's
scores, so its gradient is zero up to rounding, and Adam turns that
rounding into moves up to lr (whisper's 128 entries differ in sign). The port's
remat modes against each other: equal losses, gradients rtol 1e-6 / atol
1e-7 (the same ops, recomputed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jconfigs
import repro.train as jtrain
from repro.models import build_model as jbuild_model
from repro.models import gla as jgla
from repro_torch import configs, convert
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.models import (
    build_model,
    encdec,
    gla,
    make_generator,
    mamba,
    moe_lm,
    transformer,
    vlm,
    xlstm,
)
from repro_torch.train import AdamWConfig, TrainConfig, batch_to_device, make_train_step

FAMILIES = {"dense": "internlm2-1.8b", "moe": "olmoe-1b-7b", "ssm": "xlstm-1.3b",
            "hybrid": "zamba2-2.7b", "encdec": "whisper-tiny", "vlm": "llama-3.2-vision-11b"}
OPT = dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0)
# Adam moves a parameter by lr m / (sqrt(v) + eps): where a gradient lies
# within a few eps of 0, rounding sets a fraction of the lr-sized move
PARAM_ATOL = 1e-4


def _train_parity(name, remat, steps=3):
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    cfg = configs.reduced(configs.get_config(name))
    japi, api = jbuild_model(jcfg), build_model(cfg)
    jstate = jtrain.init_train_state(japi, jax.random.PRNGKey(0))
    if cfg.family == "vlm":  # open the zero-init gates, in both packages
        gates = jstate.params["cross_layers"]["cross"]["gate"]
        jstate = jstate._replace(params={**jstate.params, "cross_layers": {
            **jstate.params["cross_layers"], "cross": {
                **jstate.params["cross_layers"]["cross"], "gate": jnp.full_like(gates, 0.5)}}})
    state = convert.train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jtrain.make_train_step(
        japi, jtrain.TrainConfig(optimizer=jtrain.AdamWConfig(**OPT), remat=remat)))
    step = make_train_step(api, TrainConfig(optimizer=AdamWConfig(**OPT), remat=remat))
    # 32 tokens: two chunks of the reduced SSM and hybrid configs
    dc = SyntheticConfig(batch=2, seq_len=32, vocab_size=cfg.vocab_size, seed=1)
    for s in range(steps):
        batch = batch_for_step(dc, s, cfg)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch_to_device(batch, "cpu", api.dtype))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    back = jax.tree_util.tree_leaves_with_path(convert.lm_arrays_from_params(cfg, state.params))
    for (path, a), b in zip(back, jax.tree.leaves(jstate.params)):
        if path[-1].key == "bk":  # its gradient is rounding noise (see above)
            continue
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=PARAM_ATOL)


@pytest.mark.parametrize("name,remat", [
    ("xlstm-1.3b", True), ("zamba2-2.7b", True), ("whisper-tiny", True),
    ("llama-3.2-vision-11b", "save_collectives"), ("olmoe-1b-7b", "save_collectives")])
def test_three_train_steps_match_jax(name, remat):
    _train_parity(name, remat)


def test_save_collectives_matches_jax_on_stablelm():
    _train_parity("stablelm-1.6b", "save_collectives", steps=1)


def _loss_and_grads(api, params, batch, remat):
    out = api.forward(params, batch, remat=remat)
    logits = out[0] if isinstance(out, tuple) else out
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, logits.shape[-1]), batch["tokens"][:, 1:].reshape(-1).long())
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_modes_agree(family):
    cfg = configs.reduced(configs.get_config(FAMILIES[family]))
    api = build_model(cfg)
    params = api.init_params(make_generator(0, "cpu"))
    if family == "vlm":
        for lp in params["cross_layers"]:
            torch.nn.init.constant_(lp["cross"]["gate"], 0.5)
    batch = batch_to_device(batch_for_step(SyntheticConfig(2, 32, cfg.vocab_size, seed=2), 0, cfg),
                            "cpu", api.dtype)
    loss0, g0 = _loss_and_grads(api, params, batch, False)
    for remat in (True, "save_collectives"):
        loss, g = _loss_and_grads(api, params, batch, remat)
        assert float(loss) == float(loss0), remat
        for a, b in zip(g, g0):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        api.forward(params, batch, remat="save_everything")
    with pytest.raises(ValueError, match="needs remat=False"):
        with torch.no_grad():
            fwd = {"dense": transformer.dense_lm_forward, "moe": moe_lm.moe_lm_forward,
                   "ssm": xlstm.xlstm_forward, "hybrid": mamba.zamba_forward,
                   "encdec": encdec.encdec_forward, "vlm": vlm.vlm_forward}[family]
            extras = api._extras(batch)
            keyword = "return_state" if family in ("ssm", "hybrid") else "return_cache"
            fwd(params, batch["tokens"], *extras, cfg, remat=True, **{keyword: True})


class _Ops(TorchDispatchMode):
    """Counts the ops dispatched while it is on (a recompute hook)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_selective_policy_saves_the_tagged_values():
    cfg = configs.reduced(configs.get_config("internlm2-1.8b"))
    api = build_model(cfg)
    params = api.init_params(make_generator(0, "cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=make_generator(3, "cpu"))
    counts = {}
    for remat in (False, True, "save_collectives"):
        fwd, bwd = _Ops(), _Ops()
        with fwd:
            loss = api.forward(params, {"tokens": tokens}, remat=remat).float().logsumexp(-1).sum()
        with bwd:
            loss.backward()
        counts[remat] = (fwd.counts, bwd.counts)
    L = cfg.n_layers
    TAG = torch.ops.repro_torch.checkpoint_name.default
    # the tags run only in a save_collectives region: two a layer
    assert TAG not in counts[False][0] and TAG not in counts[True][0]
    assert counts["save_collectives"][0][TAG] == 2 * L
    # the backward's recompute reads the saved values: no tag runs again ...
    assert TAG not in counts["save_collectives"][1]
    # ... while the rest of each layer is recomputed, as under remat=True
    mm = torch.ops.aten.mm.default
    assert counts[True][1][mm] == counts["save_collectives"][1][mm] > counts[False][1][mm]


def test_gla_gate_gradient_is_finite_at_large_decays():
    rng = np.random.default_rng(0)
    B, T, H, D, chunk = 2, 32, 2, 8, 16
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))
    b = rng.uniform(0.0, 1.0, (B, T, H)).astype(np.float32)
    jax_finite = {}
    for decay in (1.0, 6.0, 10.0, 14.0):
        log_a = np.full((B, T, H), -decay, np.float32)
        la = torch.from_numpy(log_a).requires_grad_()
        y, _ = gla.gla_chunked(*map(torch.from_numpy, (q, k, v)), la, torch.from_numpy(b), chunk)
        (g,) = torch.autograd.grad(y.sum(), la)
        assert bool(torch.isfinite(g).all()), decay

        def jloss(a):
            return jgla.gla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), a,
                                    jnp.asarray(b), chunk)[0].sum()

        jg = np.asarray(jax.grad(jloss)(jnp.asarray(log_a)))
        jax_finite[decay] = bool(np.isfinite(jg).all())
        if jax_finite[decay]:
            np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-5)
    # JAX masks after exp: e^{15 x 6} overflows f32 inside a 16-chunk, and
    # where's gradient times inf is nan
    assert jax_finite == {1.0: True, 6.0: False, 10.0: False, 14.0: False}
