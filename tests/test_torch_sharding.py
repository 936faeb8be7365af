"""The port's mesh and sharding rules against the JAX package's on the CPU:
``resolve_spec`` on tests/test_sharding_roofline.py's seven cases;
``param_shardings``, ``batch_shardings`` and ``cache_shardings`` (both
layouts) of all ten configs on the 16x16 and 2x16x16 meshes against
JAX's on ``jax.sharding.AbstractMesh`` (the same spec leaf for leaf, and
the same ``rules.dropped``; JAX's stacked (L, ...) leaf with its leading
"layers" axis against the port's per-layer leaf); the activation hints of
a reduced forward of each family (the set of (shape, logical axes) the
resolver sees); ``make_production_mesh`` and ``make_solver_mesh_from``.

Specs and drops are compared exactly: they are integer arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro.launch.sharding as jsh
from repro.models import build_model as jbuild_model
from repro.models.common import use_sharding_rules as juse_sharding_rules
from repro_torch import configs
from repro_torch.core.comm import SolverMesh
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (DATA_AXES, MODEL_AXIS, Mesh, make_production_mesh,
                                     make_solver_mesh_from)
from repro_torch.models import build_model, make_generator
from repro_torch.models.common import use_sharding_rules

CONFIGS = configs.list_configs()


class FakeMesh:
    """Only .shape is consulted by resolve_spec."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESH = FakeMesh(data=16, model=16)
MESH_MP = FakeMesh(pod=2, data=16, model=16)

# tests/test_sharding_roofline.py:23-57: (shape, logical axes, mesh, expected spec, logs a drop)
CASES = {
    "basic_2d": ((8192, 4096), ("embed", "heads_flat"), MESH, (None, "model"), False),
    "batch_multi_axis": ((256, 4096), ("batch", None), MESH_MP, (("pod", "data"), None), False),
    "batch_single_pod": ((256, 4096), ("batch", None), MESH, ("data", None), False),
    "nondivisible_dropped": ((51865, 384), ("vocab", "embed"), MESH, (None, None), True),
    "batch_prefix_fallback": ((2, 64), ("batch", None), MESH_MP, ("pod", None), False),
    "no_duplicate_mesh_axes": ((1024, 2048), ("vocab", "mlp"), MESH, ("model", None), False),
    "vocab_divisible": ((152064, 5120), ("vocab", "embed"), MESH, ("model", None), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resolve_spec_matches_jax(case):
    shape, logical, mesh, want, drops = CASES[case]
    jrules, rules = jsh.DEFAULT_RULES(), sh.DEFAULT_RULES()
    jspec = jsh.resolve_spec(shape, logical, mesh, jrules)
    spec = sh.resolve_spec(shape, logical, mesh, rules)
    assert jspec == JP(*want)
    assert tuple(spec) == tuple(jspec) == want
    assert rules.dropped == jrules.dropped
    assert bool(rules.dropped) == drops


def _meshes(multi):
    if multi:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model")), make_production_mesh(True)
    return AbstractMesh((16, 16), ("data", "model")), make_production_mesh(False)


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict (JAX's layout trees)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _port_leaf(tree, path):
    """The port's leaf at a JAX path; a per-layer list at the path's head
    gives every layer's leaf."""
    node = tree[path[0]]
    layers = node if isinstance(node, list) else [node]
    out = []
    for layer in layers:
        x = layer
        for k in path[1:]:
            x = x[k]
        out.append(x)
    return isinstance(node, list), out


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_param_shardings_match_jax(multi):
    jmesh, mesh = _meshes(multi)
    for name in CONFIGS:
        japi = jbuild_model(jconfigs.get_config(name))
        api = build_model(configs.get_config(name))
        jrules, rules = jsh.DEFAULT_RULES(), sh.DEFAULT_RULES()
        jtree = _flat(jsh.param_shardings(japi, jmesh, jrules))
        jaxes = _flat(japi.param_logical_axes())
        tree = sh.param_shardings(api, mesh, rules)
        axes_tree = api.param_logical_axes()
        assert len(sh.named_shardings(tree)) == len(dict(api.abstract_params().named_parameters()))
        n_port = 0
        for path, js in jtree.items():
            stacked, leaves = _port_leaf(tree, path)
            _, axes = _port_leaf(axes_tree, path)
            want = tuple(js.spec)
            if stacked:  # JAX's leading "layers" axis maps to no mesh axis
                assert want[0] is None and jaxes[path][0] == "layers", (name, path)
                want, jax_axes = want[1:], jaxes[path][1:]
            else:
                jax_axes = jaxes[path]
            assert all(a == jax_axes for a in axes), (name, path, axes, jax_axes)
            for s in leaves:
                assert tuple(s.spec) == want, (name, path, s.spec, want)
            n_port += len(leaves)
        assert n_port == len(sh.named_shardings(tree)), name
        assert rules.dropped == jrules.dropped, name
    assert name == CONFIGS[-1]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_batch_and_cache_shardings_match_jax(multi):
    jmesh, mesh = _meshes(multi)
    for name in CONFIGS:
        japi = jbuild_model(jconfigs.get_config(name))
        api = build_model(configs.get_config(name))
        for sname, shape in configs.SHAPES.items():
            jrules, rules = jsh.DEFAULT_RULES(), sh.DEFAULT_RULES()
            jspecs, specs = japi.input_specs(jconfigs.SHAPES[sname]), api.input_specs(shape)
            if shape.kind != "decode":
                jb = jsh.batch_shardings(jspecs, jmesh, jrules)
                b = sh.batch_shardings(specs, mesh, rules)
                assert set(b) == set(jb), (name, sname)
                for k in jb:
                    assert tuple(b[k].spec) == tuple(jb[k].spec), (name, sname, k)
                assert rules.dropped == jrules.dropped, (name, sname)
                continue
            jtok = jsh.batch_shardings({"token": jspecs["token"]}, jmesh, jrules)["token"]
            tok = sh.batch_shardings({"token": specs["token"]}, mesh, rules)["token"]
            assert tuple(tok.spec) == tuple(jtok.spec)
            for layout in ("default", "seq_model"):
                jc = jsh.cache_shardings(jspecs["cache"], jconfigs.SHAPES[sname], jmesh, jrules,
                                         layout=layout)
                c = sh.cache_shardings(specs["cache"], shape, mesh, rules, layout=layout)
                jleaves = jax.tree.leaves(jspecs["cache"])
                leaves = sh.tree_leaves(specs["cache"])
                assert [tuple(x.shape) for x in leaves] == [tuple(x.shape) for x in jleaves]
                got = [tuple(s.spec) for s in sh.tree_leaves(c)]
                want = [tuple(s.spec) for s in jax.tree.leaves(jc)]
                assert got == want, (name, sname, layout)
            assert rules.dropped == jrules.dropped, (name, sname)


def _recorder(seen):
    def resolver(shape, logical):
        seen.add((tuple(int(d) for d in shape), tuple(logical)))
        return None  # JAX's shard_hint then returns x unchanged
    return resolver


FAMILIES = ["internlm2-1.8b", "olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b", "whisper-tiny",
            "llama-3.2-vision-11b"]


def test_activation_hints_match_jax():
    for name in FAMILIES:
        _hints_match(name)


def _hints_match(name):
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    cfg = configs.reduced(configs.get_config(name))
    japi, api = jbuild_model(jcfg), build_model(cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jbatch, batch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if cfg.family in ("encdec", "vlm"):
        key, n = (("frames", cfg.enc_seq) if cfg.family == "encdec"
                  else ("img_feats", cfg.n_img_tokens))
        x = np.random.default_rng(1).standard_normal((2, n, cfg.d_model)).astype(np.float32)
        jbatch[key], batch[key] = jnp.asarray(x), torch.from_numpy(x)
    jseen, seen = set(), set()
    with juse_sharding_rules(_recorder(jseen)):
        japi.forward(japi.init_params(jax.random.PRNGKey(0)), jbatch)
    with use_sharding_rules(_recorder(seen)), torch.no_grad():
        api.forward(api.init_params(make_generator(0, "cpu")), batch)
    assert jseen and seen == jseen, (sorted(seen ^ jseen))
    # under the real rules the port logs the hints it cannot honour, as JAX does
    mesh = make_production_mesh(False)
    rules, jrules = sh.DEFAULT_RULES(), jsh.DEFAULT_RULES()
    with use_sharding_rules(sh.make_resolver(mesh, rules)), torch.no_grad():
        api.forward(api.init_params(make_generator(0, "cpu")), batch)
    for shape, logical in sorted(jseen):
        jsh.resolve_spec(shape, logical, _meshes(False)[0], jrules)
    assert sorted(set(rules.dropped)) == sorted(set(jrules.dropped)) != []


def test_production_mesh_and_solver_mesh():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi)
        assert isinstance(mesh, Mesh) and mesh.axis_names == axes
        assert tuple(mesh.shape.items()) == tuple(zip(axes, shape))
        assert mesh.devices.shape == shape and mesh.size == int(np.prod(shape))
        assert {d.type for d in mesh.devices.flat} == {"meta"}
        solver = make_solver_mesh_from(mesh)
        assert isinstance(solver, SolverMesh)
        assert solver.n_shards == mesh.size and solver.axis_names == ("rows",)
        assert list(solver.devices) == list(mesh.devices.flat)
    assert DATA_AXES == ("pod", "data") and MODEL_AXIS == "model"
    cpus = ["cpu"] * 300
    mesh = make_production_mesh(False, devices=cpus)
    assert {d.type for d in mesh.devices.flat} == {"cpu"} and mesh.size == 256
    with pytest.raises(RuntimeError, match="needs 512 devices but only 300"):
        make_production_mesh(True, devices=cpus)
    # a NamedSharding's block and slice on a small host mesh
    small = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("data", "model"))
    ns = sh.NamedSharding(small, sh.P("data", None, "model"))
    t = torch.arange(4 * 3 * 8).reshape(4, 3, 8)
    assert ns.shard_shape(t.shape) == (2, 3, 2)
    torch.testing.assert_close(ns.local(t, {"data": 1, "model": 2}), t[2:4, :, 4:6])
