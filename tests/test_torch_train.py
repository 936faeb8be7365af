"""The port's training substrate on the CPU against the JAX package's:
AdamW (tree and fused updates, clip, pipelined clip), the schedule, whole
train steps from converted weights, checkpoints, crash recovery and the
launcher.

Inputs come from numpy seeds or from the JAX package's init carried
across with the converter. Tolerances: optimizer outputs rtol 1e-5 /
atol 1e-6 (f32, other rounding of the bias corrections; the JAX suite's
fused-vs-tree tolerance); train-step losses rtol 1e-5 and grad norms
rtol 1e-4 (f32 sums in another order); parameters after three steps
rtol 1e-4 / atol 5e-5, a twentieth of one step's move at lr 1e-3 (Adam
divides m by sqrt(v), so where m nearly cancels across steps a gradient
that differs in its last bits moves that parameter by lr times a larger
relative error). Checkpoint restores and crash replays are bit-exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.train as jtrain
from repro.models import build_model as jbuild_model
from repro_torch import configs, convert
from repro_torch.ckpt import available_steps, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.launch import train as launcher
from repro_torch.models import build_model, make_generator
from repro_torch.runtime import CheckpointManager, run_with_recovery
from repro_torch.train import (
    AdamWConfig,
    TrainConfig,
    adamw_init,
    adamw_update,
    batch_to_device,
    init_train_state,
    make_train_step,
    warmup_cosine,
)

OPT = dict(rtol=1e-5, atol=1e-6)


def _cfgs(**kw):
    name = "internlm2-1.8b"
    return (jconfigs.reduced(jconfigs.get_config(name), **kw),
            configs.reduced(configs.get_config(name), **kw))


def _state(cfg, seed=0):
    return init_train_state(build_model(cfg), make_generator(seed, "cpu"))


@pytest.mark.parametrize("case", ["weight_decay", "clip", "pipelined_clip"])
def test_adamw_update_matches_jax(case):
    kw = {"weight_decay": dict(lr=1e-3, weight_decay=0.1),
          "clip": dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0),
          "pipelined_clip": dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0, pipelined_clip=True)}
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal(300).astype(np.float32),
              "b": rng.standard_normal((64, 8)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 0.2)]
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = jtrain.adamw_init(jp)
    jcfg = jtrain.AdamWConfig(**kw[case])
    ports = {}
    for fused in (False, True):
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ports[fused] = (p, adamw_init(p), AdamWConfig(**kw[case], apply_fused=fused))
    for g in grads:
        jp, js, jm = jtrain.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
        for fused, (p, st, cfg) in ports.items():
            tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
            _, st, m = adamw_update(p, tg, st, cfg)
            ports[fused] = (p, st, cfg)
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(float(st.prev_norm), float(js.prev_norm), rtol=1e-6)
            assert int(st.step) == int(js.step)
            for k in params:
                np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), **OPT)
                np.testing.assert_allclose(st.m[k].numpy(), np.asarray(js.m[k]), **OPT)
                np.testing.assert_allclose(st.v[k].numpy(), np.asarray(js.v[k]), **OPT)


def test_warmup_cosine_matches_jax():
    for args in ((1.0, 10, 100), (3e-3, 20, 30), (1e-3, 0, 5)):
        f, jf = warmup_cosine(*args), jtrain.warmup_cosine(*args)
        got = [float(f(torch.tensor(s, dtype=torch.int32))) for s in range(0, 120, 3)]
        want = [float(jf(jnp.int32(s))) for s in range(0, 120, 3)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert float(warmup_cosine(1.0, 10, 100)(torch.tensor(0))) == 0.0


@pytest.mark.parametrize("micro,remat,fused", [(1, False, False), (2, False, True),
                                               (1, True, False)])
def test_three_train_steps_match_jax(micro, remat, fused):
    jcfg, cfg = _cfgs()
    japi, api = jbuild_model(jcfg), build_model(cfg)
    jstate = jtrain.init_train_state(japi, jax.random.PRNGKey(0))
    state = convert.train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    opt = dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0)
    jstep = jax.jit(jtrain.make_train_step(
        japi, jtrain.TrainConfig(optimizer=jtrain.AdamWConfig(**opt), microbatches=micro,
                                 remat=remat)))
    step = make_train_step(api, TrainConfig(optimizer=AdamWConfig(**opt, apply_fused=fused),
                                            microbatches=micro, remat=remat))
    dc = SyntheticConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size, seed=1)
    for s in range(3):
        batch = batch_for_step(dc, s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch_to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["tokens"]) == float(jm["tokens"]) == 128.0
    assert int(state.step) == int(jstate.step) == 3
    back = convert.lm_arrays_from_params(cfg, state.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=5e-5)


def test_loss_decreases():
    """As tests/test_train.py::TestTrainLoop::test_loss_decreases."""
    _, cfg = _cfgs()
    api = build_model(cfg)
    step = make_train_step(api, TrainConfig(optimizer=AdamWConfig(lr=3e-3, clip_norm=1.0,
                                                                   apply_fused=True)))
    state = _state(cfg)
    dc = SyntheticConfig(batch=4, seq_len=64, vocab_size=cfg.vocab_size, seed=1)
    losses = []
    for s in range(80):
        state, m = step(state, batch_to_device(batch_for_step(dc, s), "cpu"))
        losses.append(float(m["loss"]))
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    assert tail < head * 0.8, (head, tail, losses[::16])
    assert int(state.step) == 80 and int(state.opt.step) == 80


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    _, cfg = _cfgs(dtype="bfloat16")
    state = _state(cfg)
    state.opt.m["embedding"].normal_()
    save_checkpoint(str(tmp_path), 5, state)
    assert latest_step(str(tmp_path)) == 5
    other = _state(cfg, seed=1)
    restored = restore_checkpoint(str(tmp_path), 5, other)
    assert restored is other
    a = convert.lm_arrays_from_params(cfg, state.params)
    assert dict(state.params.named_parameters())["embedding"].dtype == torch.bfloat16
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(convert.lm_arrays_from_params(cfg,
                                                                                   other.params))):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(other.opt.m["embedding"], state.opt.m["embedding"])
    assert torch.equal(other.step, state.step) and other.step.dtype == torch.int32


def test_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.empty(8, 4)})
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(str(tmp_path), 1, {"u": torch.empty(4, 4)})


def test_retention_gc_and_empty_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=2, async_save=False)
    state = {"w": torch.zeros(2)}
    for s in range(1, 6):
        state["w"] += 1
        mgr.maybe_save(s, state)
    assert available_steps(str(tmp_path)) == [4, 5]
    restored, s = mgr.restore_latest({"w": torch.empty(2)})
    assert s == 5 and torch.equal(restored["w"], torch.full((2,), 5.0))
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest({"w": torch.empty(2)}) == (None, None)


@pytest.mark.parametrize("crash_at,save_every", [(5, 2), (3, 10)])
def test_recovery_replays_exactly(tmp_path, crash_at, save_every):
    """Inject a crash mid-run; the supervised loop resumes from the newest
    checkpoint (or, with none yet, from the initial state) and ends
    bit-identical to the crash-free run."""
    _, cfg = _cfgs()
    step = make_train_step(build_model(cfg), TrainConfig(optimizer=AdamWConfig(lr=1e-3)))
    dc = SyntheticConfig(batch=2, seq_len=32, vocab_size=cfg.vocab_size, seed=9)

    def step_fn_factory(crash=None):
        fired = {"done": False}

        def fn(state, s):
            if crash is not None and s == crash and not fired["done"]:
                fired["done"] = True
                raise RuntimeError("injected node failure")
            return step(state, batch_to_device(batch_for_step(dc, s), "cpu"))[0]

        return fn

    ref = _state(cfg)
    for s in range(8):
        ref = step_fn_factory()(ref, s)
    mgr = CheckpointManager(str(tmp_path), save_every=save_every, keep=5, async_save=False)
    final, end = run_with_recovery(step_fn_factory(crash_at), _state(cfg), 8, mgr,
                                   max_restarts=2, reinit=lambda: _state(cfg))
    assert end == 8 and int(final.step) == 8
    for (k, a), (_, b) in zip(ref.params.named_parameters(), final.params.named_parameters()):
        assert torch.equal(a, b), k
    assert latest_step(str(tmp_path)) == 8  # the loop always saves at its end


def test_launcher_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--batch", "2", "--seq", "32", "--fused-optimizer",
            "--ckpt-dir", str(tmp_path), "--save-every", "2"]
    launcher.main(args + ["--steps", "3"])
    launcher.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "arch=internlm2-1.8b family=dense" in out and "device=cpu" in out
    assert "step    0 loss=" in out and "finished at step 3" in out
    assert "resumed from step 3" in out and "finished at step 5" in out
    assert os.path.isdir(tmp_path / "step_5")
