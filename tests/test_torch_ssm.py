"""The port's SSM and hybrid layers against the JAX package's on the CPU:
the chunked GLA engine (``gla_chunked``, ``gla_step``), Mamba-2's causal
conv and block, and the xLSTM blocks (mLSTM, sLSTM), at the reduced
configs in f32; the full configs' parameter counts; and the
``launch.precision`` tool at the reduced configs.

Inputs and layer weights are drawn from numpy seeds. Tolerance rtol 1e-5
per layer, atol 1e-6 of the output's largest magnitude (at least 1e-6):
the same f32 math in another order of sums. A block's output carries its
O(1) residual input, and near its zeros only an absolute bound holds; on
the mLSTM block both packages lie 3-4e-6 from a float64 run of the port
where the output reaches 5. The port's one-token steps update their state
in place, so the port is given clones and JAX the originals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.models import gla as jgla
from repro.models import mamba as jmamba
from repro.models import xlstm as jxlstm
from repro.models.common import ParamSpec as JParamSpec
from repro_torch import configs
from repro_torch.launch import precision
from repro_torch.models import build_model
from repro_torch.models import gla, mamba, xlstm

RTOL, ATOL = 1e-5, 1e-6
B, T, H, DK, DV, CHUNK = 2, 32, 3, 8, 5, 8


def _cfgs(name):
    return (jconfigs.reduced(jconfigs.get_config(name)),
            configs.reduced(configs.get_config(name)))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


def _gla_inputs(seed, steps=T, decay=(0.01, 0.5)):
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k = (rng.standard_normal((B, steps, H, DK)).astype(f) for _ in range(2))
    v = rng.standard_normal((B, steps, H, DV)).astype(f)
    log_a = -rng.uniform(*decay, (B, steps, H)).astype(f)
    b = rng.uniform(0.0, 1.0, (B, steps, H)).astype(f)
    S = rng.standard_normal((B, H, DK, DV)).astype(f)
    n = rng.standard_normal((B, H, DK)).astype(f)
    return (q, k, v, log_a, b), (S, n)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _layer(spec_tree, seed):
    """Numpy weights for a JAX layer spec tree: normals at std
    scale / sqrt(fan_in), ones and zeros perturbed so every leaf counts."""
    rng = np.random.default_rng(seed)

    def draw(s):
        noise = rng.standard_normal(s.shape)
        if s.init == "normal":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            return (noise * s.scale / np.sqrt(fan_in)).astype(np.float32)
        base = s.scale if s.init == "ones" else 0.0
        return (base + 0.1 * noise).astype(np.float32)

    tree = jax.tree.map(draw, spec_tree, is_leaf=lambda x: isinstance(x, JParamSpec))
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("from_state", [False, True])
def test_gla_chunked_matches_jax(normalize, from_state):
    # from a state: decays strong enough that e^{A_t - A_s}, s > t, overflows
    # f32 in JAX's order (exp before the mask)
    x, st = _gla_inputs(1, decay=(2.0, 14.0) if from_state else (0.01, 0.5))
    jstate = jgla.GLAState(*map(jnp.asarray, st)) if from_state else None
    state = gla.GLAState(*_t(st)) if from_state else None
    y_w, s_w = jgla.gla_chunked(*map(jnp.asarray, x), CHUNK, state=jstate, normalize=normalize)
    y, s = gla.gla_chunked(*_t(x), CHUNK, state=state, normalize=normalize)
    assert y.dtype == torch.float32 and y.shape == (B, T, H, DV)
    assert torch.isfinite(y).all()
    _close(y, y_w)
    _close(s.S, s_w.S)
    _close(s.n, s_w.n)
    if from_state:  # the given state is read, never written
        np.testing.assert_array_equal(state.S.numpy(), st[0])


def test_gla_step_matches_jax_and_updates_in_place():
    x, st = _gla_inputs(2, steps=1)
    for normalize in (False, True):
        one = [a[:, 0] for a in x]
        y_w, s_w = jgla.gla_step(*map(jnp.asarray, one), jgla.GLAState(*map(jnp.asarray, st)),
                                 normalize=normalize)
        state = gla.GLAState(*_t(st))
        y, s = gla.gla_step(*_t(one), state, normalize=normalize)
        assert s.S is state.S and s.n is state.n
        _close(y, y_w)
        _close(s.S, s_w.S)
        _close(s.n, s_w.n)


def test_chunked_equals_a_loop_of_steps():
    x, st = _gla_inputs(3)
    y, s = gla.gla_chunked(*_t(x), CHUNK, state=gla.GLAState(*_t(st)), normalize=True)
    state = gla.GLAState(*_t(st))
    ys = []
    for t in range(T):
        yt, state = gla.gla_step(*[a[:, t] for a in _t(x)], state, normalize=True)
        ys.append(yt)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    _close(state.S, s.S)
    _close(state.n, s.n)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        gla.gla_chunked(*[a[:, :T - 1] for a in _t(x)], CHUNK)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    tail = rng.standard_normal((B, 3, 6)).astype(np.float32)
    for tl in (None, tail):
        y_w, tail_w = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                          None if tl is None else jnp.asarray(tl))
        given = None if tl is None else torch.from_numpy(tl.copy())
        y, new_tail = mamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w), given)
        _close(y, y_w)
        _close(new_tail, tail_w)
        if given is not None:  # the new tail holds no view of the old
            assert new_tail.untyped_storage().data_ptr() != given.untyped_storage().data_ptr()


@pytest.mark.parametrize("step", [False, True])
def test_mamba_apply_matches_jax(step):
    jcfg, cfg = _cfgs("zamba2-2.7b")
    jlp, lp = _layer(jmamba.mamba_block_params(jcfg), 5)
    rng = np.random.default_rng(6)
    nh, stt = cfg.ssm_heads_, cfg.ssm_state
    f = np.float32
    x = rng.standard_normal((B, 1 if step else 2 * cfg.chunk, cfg.d_model)).astype(f)
    st = (rng.standard_normal((B, nh, stt, cfg.d_inner // nh)).astype(f),
          rng.standard_normal((B, nh, stt)).astype(f))
    tail = rng.standard_normal((B, 3, cfg.d_inner + 2 * stt)).astype(f)
    y_w, s_w, tail_w = jmamba.mamba_apply(jlp, jnp.asarray(x), jcfg,
                                          jgla.GLAState(*map(jnp.asarray, st)),
                                          jnp.asarray(tail), step=step)
    with torch.no_grad():
        y, s, new_tail = mamba.mamba_apply(lp, torch.from_numpy(x), cfg, gla.GLAState(*_t(st)),
                                           torch.from_numpy(tail), step=step)
    _close(y, y_w)
    _close(s.S, s_w.S)
    _close(s.n, s_w.n)
    _close(new_tail, tail_w)


def test_mlstm_apply_matches_jax():
    jcfg, cfg = _cfgs("xlstm-1.3b")
    jlp, lp = _layer(jxlstm._mlstm_params(jcfg), 7)
    rng = np.random.default_rng(8)
    nh, dk = cfg.ssm_heads_, cfg.d_inner // cfg.ssm_heads_
    st = (rng.standard_normal((B, nh, dk, dk)).astype(np.float32),
          rng.standard_normal((B, nh, dk)).astype(np.float32))
    for step, state in ((False, None), (True, st)):
        x = rng.standard_normal((B, 1 if step else 2 * cfg.chunk, cfg.d_model)).astype(np.float32)
        y_w, s_w = jxlstm._mlstm_apply(
            jlp, jnp.asarray(x), jcfg,
            None if state is None else jgla.GLAState(*map(jnp.asarray, state)), step=step)
        with torch.no_grad():
            y, s = xlstm._mlstm_apply(lp, torch.from_numpy(x), cfg,
                                      None if state is None else gla.GLAState(*_t(state)),
                                      step=step)
        _close(y, y_w)
        _close(s.S, s_w.S)
        _close(s.n, s_w.n)


@pytest.mark.parametrize("step", [False, True])
def test_slstm_apply_matches_jax(step):
    jcfg, cfg = _cfgs("xlstm-1.3b")
    jlp, lp = _layer(jxlstm._slstm_params(jcfg), 9)
    rng = np.random.default_rng(10)
    nh = cfg.ssm_heads_
    shape = (B, nh, cfg.d_model // nh)
    x = rng.standard_normal((B, 1 if step else 2 * cfg.chunk, cfg.d_model)).astype(np.float32)
    # ir up to ~20: exp(minimum(ir, 10)) caps the input gate
    x[..., :4] *= 30.0
    st = tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3)) if step else None
    y_w, s_w = jxlstm._slstm_apply(jlp, jnp.asarray(x), jcfg,
                                   None if st is None else tuple(map(jnp.asarray, st)), step=step)
    with torch.no_grad():
        y, s = xlstm._slstm_apply(lp, torch.from_numpy(x), cfg,
                                  None if st is None else tuple(_t(st)), step=step)
    _close(y, y_w)
    for a, b in zip(s, s_w):
        _close(a, b)


def test_full_config_parameter_counts_equal_jax():
    for name, want in (("zamba2-2.7b", 2_415_743_552), ("xlstm-1.3b", 3_529_460_048)):
        got = build_model(configs.get_config(name)).n_params()
        assert got == jbuild_model(jconfigs.get_config(name)).n_params() == want, name


def test_precision_tool_on_cpu(capsys):
    # the tool's reports at the reduced configs, the device being the host
    for name, _group, _cuts in precision.MODELS:
        cfg = configs.reduced(configs.get_config(name), dtype="bfloat16")
        precision.depth_report(cfg, "cpu", 2, 2 * cfg.chunk, ())
        precision.host_report(cfg, "cpu")
    lines = capsys.readouterr().out.splitlines()
    per_model = 1 + len(precision.PROMPT_SEEDS)
    assert len(lines) == 2 * per_model
    for line in lines[::per_model]:  # f32 teacher-forced decode: the forward's logits
        f32 = float(line.split("f32 ")[1].split(";")[0])
        assert f32 < 1e-5, line
    for i, line in enumerate(lines):  # device and host are one here: the same bits
        if i % per_model:
            assert "tokens equal, prefill 0.000e+00, one decode step 0.000e+00" in line, line
