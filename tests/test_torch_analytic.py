"""The port's analytic FLOP/byte model and its abstract (meta-device)
state against the JAX package's on the CPU, for all ten configs at full
width and the four dry-run shapes:

* ``param_count``, ``active_param_count``, ``model_flops_simple``,
  ``analytic_flops`` and ``analytic_hbm_bytes`` (launch/analytic.py):
  counts equal, floats within 1e-12 relative (the same arithmetic in the
  same order);
* every parameter's shape, dtype and logical axes against JAX's
  ``abstract_params``/``param_logical_axes`` (JAX's stacked (L, ...)
  leaf with its leading "layers" axis against each of the port's
  per-layer leaves);
* ``input_specs`` for every config and shape (the decode cache leaf for
  leaf) and ``abstract_train_state``'s bytes against JAX's
  ``eval_shape``; all of it on ``meta``, nothing allocated;
* ``torch.utils.flop_counter.FlopCounterMode`` over the reduced dense
  forward within 1% of ``analytic_flops`` (both count the projections,
  the full T x T scores, the MLP and the unembedding).
"""
import math
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jconfigs
import repro.launch.analytic as jan
from repro.models import build_model as jbuild_model
from repro.train.train_step import abstract_train_state as jabstract_train_state
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analytic as an
from repro_torch.launch.sharding import tree_leaves
from repro_torch.models import build_model, make_generator
from repro_torch.train import abstract_train_state

CONFIGS = configs.list_configs()
DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def _shapes():
    return [(s, configs.SHAPES[s], jconfigs.SHAPES[s]) for s in configs.SHAPES]


def test_analytic_counts_equal_jax():
    for name in CONFIGS:
        cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
        assert an.param_count(cfg) == jan.param_count(jcfg)
        assert an.active_param_count(cfg) == jan.active_param_count(jcfg)
        assert isinstance(an.param_count(cfg), int)


@pytest.mark.parametrize("fn", ["model_flops_simple", "analytic_flops", "analytic_hbm_bytes"])
def test_analytic_floats_equal_jax(fn):
    for name in CONFIGS:
        cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
        for sname, shape, jshape in _shapes():
            got, want = getattr(an, fn)(cfg, shape), getattr(jan, fn)(jcfg, jshape)
            assert got == pytest.approx(want, rel=1e-12, abs=0), (name, sname)
            assert got > 0


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_abstract_params_and_axes_match_jax():
    for name in CONFIGS:
        japi, api = jbuild_model(jconfigs.get_config(name)), build_model(configs.get_config(name))
        jabs, jaxes = _flat(japi.abstract_params()), _flat(japi.param_logical_axes())
        params, axes = api.abstract_params(), api.param_logical_axes()
        named = dict(params.named_parameters())
        n = 0
        for path, sds in jabs.items():
            layers = axes[path[0]] if isinstance(axes[path[0]], list) else None
            for i in range(len(layers)) if layers is not None else [None]:
                key = path if i is None else (path[0], str(i), *path[1:])
                t = named[".".join(key)]
                ax = axes[path[0]][i] if i is not None else axes[path[0]]
                for k in path[1:]:
                    ax = ax[k]
                want_shape, want_axes = tuple(sds.shape), jaxes[path]
                if i is not None:  # one layer of JAX's stacked leaf
                    assert want_shape[0] == len(layers) and want_axes[0] == "layers"
                    want_shape, want_axes = want_shape[1:], want_axes[1:]
                assert tuple(t.shape) == want_shape, (name, key)
                assert t.dtype == DTYPES[sds.dtype], (name, key)
                assert tuple(ax) == tuple(want_axes), (name, key)
                n += 1
        assert n == len(named), name


def test_input_specs_match_jax():
    for name in CONFIGS:
        japi, api = jbuild_model(jconfigs.get_config(name)), build_model(configs.get_config(name))
        for sname, shape, jshape in _shapes():
            jspecs, specs = japi.input_specs(jshape), api.input_specs(shape)
            assert set(specs) == set(jspecs), (name, sname)
            for k, js in jspecs.items():
                jl, pl = jax.tree.leaves(js), tree_leaves(specs[k])
                assert [tuple(x.shape) for x in pl] == [tuple(x.shape) for x in jl], (name, k)
                assert [x.dtype for x in pl] == [DTYPES[x.dtype] for x in jl], (name, sname, k)
                assert {x.device.type for x in pl} == {"meta"}


def _nbytes(leaves):
    return sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize for x in leaves)


def test_abstract_train_state_bytes_match_jax():
    for name in CONFIGS:
        japi, api = jbuild_model(jconfigs.get_config(name)), build_model(configs.get_config(name))
        state = abstract_train_state(api)
        leaves = (list(state.params.parameters()) + list(state.opt.m.values())
                  + list(state.opt.v.values()) + [state.opt.step, state.opt.prev_norm, state.step])
        got = sum(t.numel() * t.element_size() for t in leaves)
        assert got == _nbytes(jax.tree.leaves(jabstract_train_state(japi))), name
        assert {t.dtype for t in state.opt.m.values()} == {torch.float32}
        assert state.step.dtype == state.opt.step.dtype == torch.int32


def test_nothing_allocated_off_meta():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB on Linux
    api = build_model(configs.get_config("qwen2.5-14b"))  # 14.8e9 parameters
    state = abstract_train_state(api)
    leaves = (list(state.params.parameters()) + list(state.opt.m.values())
              + list(state.opt.v.values()) + [state.opt.step, state.opt.prev_norm, state.step]
              + tree_leaves(api.input_specs(configs.SHAPES["decode_32k"])))
    assert {t.device.type for t in leaves} == {"meta"}
    assert sum(t.numel() * t.element_size() for t in leaves) > 150e9
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert grown < 1 << 20, f"peak RSS grew {grown} KiB"  # under 1 GiB


def test_flop_counter_matches_analytic_on_reduced_dense():
    cfg = configs.reduced(configs.get_config("internlm2-1.8b"))
    api = build_model(cfg)
    params = api.init_params(make_generator(0, "cpu"))
    B, T = 2, 64
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        api.forward(params, {"tokens": tokens.to(torch.int32)})
    want = an.analytic_flops(cfg, ShapeConfig("prefill", T, B, "prefill"))
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-2)
