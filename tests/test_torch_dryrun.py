"""The port's dry-run (``python -m repro_torch.launch.dryrun``) against the
JAX package on the CPU: the whisper-tiny train_4k cell's program, mesh,
vocabulary fallback and analytic figures (JAX's functions, equal); the
long_500k skip of a full-attention config; the CLI's record file; the
whole 10 x 4 x 2 sweep, untraced, classified as JAX's dry-run classifies it
(ok, or the quadratic long_500k skip); and ``argument_bytes_per_device`` equal to
the sum of the blocks of JAX's own shardings on ``AbstractMesh``
(``NamedSharding.shard_shape``), built as JAX's dry-run builds its
``in_shardings``, of the arguments its compiled step keeps. Everything runs on the meta device: no allocation.
"""
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax._src.interpreters import partial_eval as pe
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
import repro.launch.analytic as jan
import repro.launch.sharding as jsh
from repro.models import build_model as jbuild_model
from repro.train import AdamWConfig as jAdamWConfig
from repro.train import TrainConfig as jTrainConfig
from repro.train import abstract_train_state as jabstract_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train.optimizer import AdamWState as jAdamWState
from repro.train.train_step import TrainState as jTrainState
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.sharding import tree_leaves
from repro_torch.models import build_model


def test_run_cell_whisper_train():
    rec = dryrun.run_cell("whisper-tiny", "train_4k", False, verbose=False)
    assert rec["status"] == "ok" and rec["program"] == "train_step" and rec["mesh"] == "16x16"
    # whisper's vocabulary (51865) cannot split 16 ways: logged
    assert any(f["axis"] == "vocab" for f in rec["sharding_fallbacks"])
    jcfg, jshape = jconfigs.get_config("whisper-tiny"), jconfigs.SHAPES["train_4k"]
    assert rec["analytic"] == {
        "model_flops_6nd": jan.model_flops_simple(jcfg, jshape),
        "detailed_flops": jan.analytic_flops(jcfg, jshape),
        "hbm_bytes": jan.analytic_hbm_bytes(jcfg, jshape),
        "params": jan.param_count(jcfg),
    }
    terms = rec["roofline_analytic"]
    assert terms["collective_s"] == 0.0 and terms["collective_counted"] is False
    assert terms["bound_s"] == max(terms["compute_s"], terms["memory_s"]) > 0
    for key in ("compile_s", "hlo", "hlo_raw_cost_analysis", "roofline_hlo",
                "model_vs_hlo_flops"):
        assert key not in rec  # JAX's own names: the traced half has its own
    for key in ("traced", "collectives", "roofline_traced", "model_vs_traced_flops"):
        assert key in rec


def test_long500k_skip_reason():
    rec = dryrun.run_cell("qwen3-8b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


def test_cli_writes_the_record(tmp_path, capsys):
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k", "--mesh", "single",
                      "--out", str(tmp_path)])
    assert rc == 0
    rec = json.load(open(tmp_path / "whisper-tiny_train_4k_single.json"))
    assert rec["status"] == "ok" and rec["program"] == "train_step"
    assert rec["memory"]["argument_bytes_per_device"] > 0
    assert "0 failures" in capsys.readouterr().out


def test_sweep_classifies_every_cell_as_jax(tmp_path):
    # untraced: the xlstm sLSTM time loop runs 32,768 steps a prefill on meta
    assert dryrun.main(["--out", str(tmp_path), "--no-trace"]) == 0
    recs = [json.load(open(p)) for p in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == 80
    for rec in recs:
        jcfg = jconfigs.get_config(rec["arch"])
        skip = rec["shape"] == "long_500k" and not jcfg.subquadratic  # JAX's rule
        assert rec["status"] == ("skipped" if skip else "ok"), rec["arch"]
        if not skip:
            assert rec["program"] == {"train": "train_step", "prefill": "prefill",
                                      "decode": "serve_step"}[jconfigs.SHAPES[rec["shape"]].kind]


def _jax_argument_bytes(arch, shape_name, multi, layout):
    """What JAX's dry-run passes as arguments, as blocks of its shardings,
    built as its ``_lower_cell`` builds the step program and its
    ``in_shardings``, less what ``jit`` prunes (``keep_unused`` is False):
    the inputs that ``dce_jaxpr`` finds the step's jaxpr never reads (as
    ``jit``'s own pruning does), such as the train step's ``labels``
    (tests/test_torch_dryrun_partitioned.py and
    tests/test_torch_dryrun_families.py hold the sum to
    ``memory_analysis().argument_size_in_bytes``)."""
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
            else AbstractMesh((16, 16), ("data", "model")))
    rules = jsh.DEFAULT_RULES()
    api = jbuild_model(jconfigs.get_config(arch))
    shape = jconfigs.SHAPES[shape_name]
    p_sh = jsh.param_shardings(api, mesh, rules)
    specs = api.input_specs(shape)
    sc = jsh.scalar_sharding(mesh)
    if shape.kind == "train":
        step = jmake_train_step(api, jTrainConfig(
            optimizer=jAdamWConfig(lr=1e-4, clip_norm=1.0), remat=True))
        args = (jabstract_train_state(api), specs)
        shardings = (jTrainState(params=p_sh, opt=jAdamWState(m=p_sh, v=p_sh, step=sc,
                                                              prev_norm=sc), step=sc),
                     jsh.batch_shardings(specs, mesh, rules))
    elif shape.kind == "prefill":
        step, args = api.prefill, (api.abstract_params(), specs)
        shardings = (p_sh, jsh.batch_shardings(specs, mesh, rules))
    else:
        step = api.decode
        args = (api.abstract_params(), specs["token"], specs["cache"],
                jax.ShapeDtypeStruct((), jnp.int32))
        shardings = (p_sh, jsh.batch_shardings({"token": specs["token"]}, mesh, rules)["token"],
                     jsh.cache_shardings(specs["cache"], shape, mesh, rules, layout=layout), sc)
    closed = jax.make_jaxpr(step)(*args)
    _, used = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    leaves, shards = jax.tree.leaves(args), jax.tree.leaves(shardings)
    assert len(leaves) == len(shards) == len(used)
    return sum(math.prod(s.shard_shape(x.shape)) * jnp.dtype(x.dtype).itemsize
               for x, s, u in zip(leaves, shards, used) if u)


@pytest.mark.parametrize("arch,shape,multi,layout", [
    ("whisper-tiny", "train_4k", False, "default"),
    ("olmoe-1b-7b", "train_4k", True, "default"),
    ("qwen2.5-14b", "prefill_32k", True, "default"),
    ("llama-3.2-vision-11b", "decode_32k", False, "default"),
    ("zamba2-2.7b", "long_500k", True, "seq_model"),
    ("xlstm-1.3b", "decode_32k", False, "seq_model"),
])
def test_argument_bytes_equal_jax_shardings(arch, shape, multi, layout):
    rec = dryrun.run_cell(arch, shape, multi, verbose=False, variant={"cache_layout": layout})
    assert rec["memory"]["argument_bytes_per_device"] == _jax_argument_bytes(
        arch, shape, multi, layout)


class _Reads(torch.utils._python_dispatch.TorchDispatchMode):
    """The storages the ops run under it read: every tensor argument but
    the destination of an op that overwrites it whole."""

    _OVERWRITE = {torch.ops.aten.fill_, torch.ops.aten.zero_, torch.ops.aten.copy_}

    def __init__(self):
        super().__init__()
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat = torch.utils._pytree.tree_leaves((args, kwargs or {}))
        skip = flat[:1] if func.overloadpacket in self._OVERWRITE else []
        self.read |= {t.untyped_storage()._cdata for t in flat
                      if isinstance(t, torch.Tensor) and not any(t is u for u in skip)}
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b",
                                  "whisper-tiny", "llama-3.2-vision-11b"])
def test_decode_reads_what_the_model_declares(arch):
    """``ModelApi.decode_reads``, which the dry run's serve step prunes by,
    against what ``decode`` reads on the meta device, in each family: a
    parameter or cache field is declared read exactly when an op reads it
    (a declared-unread position goes in as None, which nothing can read)."""
    api = build_model(configs.reduced(configs.get_config(arch)))
    params, specs = api.abstract_params(), api.input_specs(ShapeConfig("s", 16, 2, "decode"))
    cache = specs["cache"]
    storage = lambda t: t.untyped_storage()._cdata  # noqa: E731
    mode = _Reads()
    with torch.no_grad(), mode:
        api.decode(params, specs["token"], cache, 15 if api.decode_reads("pos") else None)
    assert api.decode_reads("token") and storage(specs["token"]) in mode.read
    for k, t in params.named_parameters():
        assert api.decode_reads("params." + k) == (storage(t) in mode.read), k
    for f, t in zip(cache._fields, cache):
        read = any(storage(x) in mode.read for x in tree_leaves(t))
        assert api.decode_reads("cache." + f) == read, f
