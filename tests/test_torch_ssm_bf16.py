"""The port's SSM and hybrid layers and models in bf16 against the JAX
package's bf16 on the CPU (tests/test_torch_ssm.py holds them in f32).

Per layer (``mamba_apply``, ``_mlstm_apply``, ``_slstm_apply``, chunked
and one step, at the reduced configs with bf16 weights and inputs): every
output and state leaf within BF16_ROW per row (the largest
||d|| / ||ref|| over the last axis), a few bf16 ulps. The packages keep
the same casts, but do not round alike: XLA's bf16 ``silu`` differs from
PyTorch's in the last bit of 27-39% of its values, which moves a Mamba
block's f32 state by up to 1.3e-2 per row and a block's output by up to
1.2e-2 (six seeds). So each layer is held a second time against JAX with
``jax.nn.silu`` computed in f32 and rounded once, as ``F.silu`` rounds:
there the one-step outputs are equal and the f32 states lie within a
layer's limit, below what each cast JAX keeps would move them if the
port dropped it (k / sqrt(dk) in x's dtype, the gate pre-activations
summed in the weights' dtype, dt_raw in f32 plus the bf16 dt_bias, D in
x's dtype). The conv tail is a slice of the input: equal.

Per model: the port's bf16 forward lies from JAX's f32 forward (the same
weights) no farther than BF16_FAR x JAX's own bf16 forward does, at the
reduced configs and at 12 layers of width 256, where bf16 rounding alone
moves the xlstm model's logits by O(1) per row. Measured ratios 0.67-1.19.
"""
import dataclasses

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
from repro_torch import configs, convert
from repro_torch.launch.precision import rows_err
from repro_torch.models import build_model
from repro_torch.models import gla, mamba, xlstm

BF16_ROW = 3 * torch.finfo(torch.bfloat16).eps  # 2.3e-2: three ulps of 1
# with JAX's silu rounded once: a bf16 leaf within one ulp of 1; an f32
# state within a layer's own limit (the largest of six seeds: Mamba 2.1e-6,
# mLSTM 2.1e-4, sLSTM 7.8e-4, whose gates pass through exp)
ONCE_BF16_ROW = torch.finfo(torch.bfloat16).eps
MAMBA_F32_ROW, MLSTM_F32_ROW, SLSTM_F32_ROW = 1e-4, 5e-4, 2e-3
BF16_FAR = 1.5
B = 2


def _cfgs(name):
    return (jconfigs.reduced(jconfigs.get_config(name), dtype="bfloat16"),
            configs.reduced(configs.get_config(name), dtype="bfloat16"))


def _layer(spec_tree, seed):
    """bf16 weights for a JAX layer spec tree, drawn as tests/test_torch_ssm.py
    draws them in f32 and rounded once (the same bits in both packages)."""
    rng = np.random.default_rng(seed)

    def draw(s):
        noise = rng.standard_normal(s.shape)
        if s.init == "normal":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            return (noise * s.scale / np.sqrt(fan_in)).astype(np.float32)
        base = s.scale if s.init == "ones" else 0.0
        return (base + 0.1 * noise).astype(np.float32)

    tree = jax.tree.map(draw, spec_tree, is_leaf=lambda x: isinstance(x, JParamSpec))
    return (jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree),
            jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree))


def _bf16(a: np.ndarray):
    """(JAX, port) bf16 copies of one f32 array."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a.copy()).to(torch.bfloat16)


def _f32(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _silu_rounded_once(x):
    """silu in f32, rounded once to x's dtype, as PyTorch's ``F.silu``."""
    xf = x.astype(jnp.float32)
    return (xf * jax.nn.sigmoid(xf)).astype(x.dtype)


def _close(got, want, what: str, f32_row: float | None = None):
    """Each leaf of ``got`` (the port's) within BF16_ROW per row of
    ``want`` (JAX's); or, given ``f32_row``, a bf16 leaf within
    ONCE_BF16_ROW and an f32 leaf within ``f32_row``."""
    for name, g, w in zip(what.split(), got, want):
        bf16 = w.dtype == jnp.bfloat16
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32), name
        limit = BF16_ROW if f32_row is None else ONCE_BF16_ROW if bf16 else f32_row
        err = rows_err(g.float(), torch.from_numpy(np.array(w.astype(jnp.float32))))
        assert err <= limit, f"{name}: per-row {err:.3e} > {limit:.3e}"


def _both(run_jax, got, what: str, f32_row: float):
    """The port's leaves ``got`` against JAX's as it is, then against JAX's
    with silu rounded once, where the packages round alike: there a cast
    JAX keeps and the port drops moves a state beyond ``f32_row``."""
    _close(got, run_jax(), what)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.nn, "silu", _silu_rounded_once)
        _close(got, run_jax(), what, f32_row)


@pytest.mark.parametrize("step", [False, True])
def test_mamba_apply_bf16_matches_jax(step):
    jcfg, cfg = _cfgs("zamba2-2.7b")
    jlp, lp = _layer(jmamba.mamba_block_params(jcfg), 5)
    rng = np.random.default_rng(6)
    nh, stt = cfg.ssm_heads_, cfg.ssm_state
    f = np.float32
    jx, x = _bf16(rng.standard_normal((B, 1 if step else 2 * cfg.chunk, cfg.d_model)).astype(f))
    st = (rng.standard_normal((B, nh, stt, cfg.d_inner // nh)).astype(f),
          rng.standard_normal((B, nh, stt)).astype(f))
    jtail, tail = _bf16(rng.standard_normal((B, 3, cfg.d_inner + 2 * stt)).astype(f))
    def run_jax():
        y, s, tail = jmamba.mamba_apply(jlp, jx, jcfg, jgla.GLAState(*map(jnp.asarray, st)),
                                        jtail, step=step)
        return y, s.S, s.n, tail

    with torch.no_grad():
        y, s, new_tail = mamba.mamba_apply(lp, x, cfg, gla.GLAState(*_f32(st)), tail, step=step)
    _both(run_jax, (y, s.S, s.n), "y S n", MAMBA_F32_ROW)
    np.testing.assert_array_equal(new_tail.float().numpy(),
                                  np.array(run_jax()[3].astype(jnp.float32)))


@pytest.mark.parametrize("step", [False, True])
def test_mlstm_apply_bf16_matches_jax(step):
    jcfg, cfg = _cfgs("xlstm-1.3b")
    jlp, lp = _layer(jxlstm._mlstm_params(jcfg), 7)
    rng = np.random.default_rng(8)
    nh, dk = cfg.ssm_heads_, cfg.d_inner // cfg.ssm_heads_
    st = (rng.standard_normal((B, nh, dk, dk)).astype(np.float32),
          rng.standard_normal((B, nh, dk)).astype(np.float32)) if step else None
    jx, x = _bf16(rng.standard_normal((B, 1 if step else 2 * cfg.chunk,
                                       cfg.d_model)).astype(np.float32))
    def run_jax():
        y, s = jxlstm._mlstm_apply(jlp, jx, jcfg,
                                   None if st is None else jgla.GLAState(*map(jnp.asarray, st)),
                                   step=step)
        return y, s.S, s.n

    with torch.no_grad():
        y, s = xlstm._mlstm_apply(lp, x, cfg, None if st is None else gla.GLAState(*_f32(st)),
                                  step=step)
    _both(run_jax, (y, s.S, s.n), "y S n", MLSTM_F32_ROW)


@pytest.mark.parametrize("step", [False, True])
def test_slstm_apply_bf16_matches_jax(step):
    jcfg, cfg = _cfgs("xlstm-1.3b")
    jlp, lp = _layer(jxlstm._slstm_params(jcfg), 9)
    rng = np.random.default_rng(10)
    nh = cfg.ssm_heads_
    shape = (B, nh, cfg.d_model // nh)
    x = rng.standard_normal((B, 1 if step else 2 * cfg.chunk, cfg.d_model)).astype(np.float32)
    x[..., :4] *= 30.0  # input-gate pre-activations past the cap of 10
    jx, x = _bf16(x)
    st = tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3)) if step else None
    def run_jax():
        y, s = jxlstm._slstm_apply(jlp, jx, jcfg,
                                   None if st is None else tuple(map(jnp.asarray, st)), step=step)
        return (y, *s)

    with torch.no_grad():
        y, s = xlstm._slstm_apply(lp, x, cfg, None if st is None else tuple(_f32(st)), step=step)
    _both(run_jax, (y, *s), "y c n h", SLSTM_F32_ROW)


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
@pytest.mark.parametrize("deep", [False, True])
def test_bf16_forward_as_far_from_f32_as_jax_bf16(family, deep):
    name = {"hybrid": "zamba2-2.7b", "ssm": "xlstm-1.3b"}[family]
    over = dict(n_layers=12, d_model=256) if deep else {}
    jcfg = jconfigs.reduced(jconfigs.get_config(name), **over)
    japi32 = jbuild_model(jcfg)
    japi16 = jbuild_model(dataclasses.replace(jcfg, dtype="bfloat16"))
    tree = jax.tree.map(np.asarray, japi32.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    cfg = configs.reduced(configs.get_config(name), dtype="bfloat16", **over)
    api, params = build_model(cfg), convert.lm_params_from_arrays(cfg, tree, device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 2 * cfg.chunk))
    tokens = tokens.astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    f32 = torch.from_numpy(np.array(japi32.forward(jax.tree.map(jnp.asarray, tree), batch)))
    j16 = japi16.forward(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree), batch)
    j16 = torch.from_numpy(np.array(j16.astype(jnp.float32)))
    with torch.no_grad():
        t16 = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert t16.dtype == torch.bfloat16
    port, ref = rows_err(t16.float(), f32), rows_err(j16, f32)
    assert port <= BF16_FAR * ref, f"port bf16 {port:.3e} against JAX bf16 {ref:.3e}"
