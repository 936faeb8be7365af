"""The port's sharded MoE dispatch (``moe_ffn_sharded`` over
``launch.mesh.shard_map``) against the JAX package on the CPU.

The reduced olmoe-1b-7b and granite-moe-1b-a400m, at no-drop capacity
(``moe_capacity_factor = n_experts``, as tests/test_moe_sharded.py), on
(2, 4) and (1, 8) host meshes: the port's forward under
``use_sharding_rules(resolver, mesh)`` against JAX's forward on the same
weights (carried across with the converter), which takes ``moe_ffn``
without a mesh. Logits within 1e-5 per row (||d|| / ||ref||; JAX's own
sharded-vs-unsharded gate is 2e-3 elementwise): the same f32 products,
each token's expert outputs added in another order. aux against the mean
over the data shards of JAX's aux on each shard's rows, rtol 1e-6 (aux is
a per-shard estimator, so it differs from the whole batch's). Also: one
``model`` all-reduce and one aux all-reduce per layer; the sharded path
taken exactly when JAX's condition holds.

The backward: every parameter's gradient of the whole batch's nll plus
0.01 x aux (the forward's mean over the data shards) against ``jax.grad``
of the same loss in JAX, unsharded (aux there the mean of JAX's aux on each
data shard's rows), within 1e-5 per tensor (||d|| / ||ref||, f32); the
backward's all-reduces by tag; ``remat=True`` against no remat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.moe as jmoe
import repro.models.moe_lm as jmoe_lm
from repro.models import build_model as jbuild_model
from repro.models.common import use_sharding_rules as juse_sharding_rules
from repro.train.loss import next_token_loss as jnext_token_loss
from repro_torch import configs, convert
from repro_torch.launch.mesh import Mesh, shard_map
from repro_torch.launch.sharding import DEFAULT_RULES, P, make_resolver
from repro_torch.models import build_model, moe_lm
from repro_torch.models.common import use_sharding_rules
from repro_torch.train.loss import next_token_loss

ROW = 1e-5
AUX_RTOL = 1e-6
GRAD = 1e-5  # ||d|| / ||ref|| per parameter tensor, f32
AUX_WEIGHT = 0.01


def _host_mesh(data, model):
    return Mesh(np.array(["cpu"] * (data * model), dtype=object).reshape(data, model),
                ("data", "model"))


def _models(name):
    jcfg = jconfigs.reduced(jconfigs.get_config(name))
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=float(jcfg.n_experts))
    cfg = configs.reduced(configs.get_config(name))
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
    japi = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    params = convert.lm_params_from_arrays(cfg, tree, device="cpu")
    return japi, jax.tree.map(jnp.asarray, tree), build_model(cfg), params


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "granite-moe-1b-a400m"])
def test_sharded_forward_matches_jax(name, shape):
    japi, jparams, api, params = _models(name)
    cfg = api.cfg
    data, model = shape
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    mesh = _host_mesh(data, model)
    assert moe_lm.sharded_moe_applies(mesh, cfg, tokens.shape[0])
    with use_sharding_rules(make_resolver(mesh, DEFAULT_RULES()), mesh), torch.no_grad():
        logits, aux = api.forward(params, {"tokens": torch.from_numpy(tokens)})
    jlogits, _ = japi.forward(jparams, {"tokens": jnp.asarray(tokens)})
    ref = np.asarray(jlogits, np.float64)
    got = logits.double().numpy()
    rows = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rows.max() <= ROW, rows.max()
    b = tokens.shape[0] // data
    jaux = [float(japi.forward(jparams, {"tokens": jnp.asarray(tokens[s * b:(s + 1) * b])})[1])
            for s in range(data)]
    np.testing.assert_allclose(float(aux), np.mean(jaux), rtol=AUX_RTOL)
    # one psum over "model" and one over the batch axes per MoE layer
    assert mesh.counts["allreduce.model"] == cfg.n_layers
    assert mesh.counts["allreduce.aux"] == cfg.n_layers
    assert mesh.counts["allreduce"] == 2 * cfg.n_layers


class FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


def test_sharded_path_taken_exactly_when_jax_condition_holds(monkeypatch):
    jcfg = jconfigs.reduced(jconfigs.get_config("olmoe-1b-7b"))
    cfg = configs.reduced(configs.get_config("olmoe-1b-7b"))
    assert cfg.n_experts == jcfg.n_experts == 8
    japi, api = jbuild_model(jcfg), build_model(cfg)
    jlp = jax.tree.map(lambda a: a[0], japi.init_params(jax.random.PRNGKey(0))["layers"])
    params = api.init_params(torch.Generator().manual_seed(0))
    calls = []

    def jrecord(p, x3, *a, **k):
        calls.append("jax")
        return jnp.zeros_like(x3), jnp.float32(0.0)

    def record(p, x3, *a, **k):
        calls.append("port")
        return torch.zeros_like(x3), torch.zeros(())

    monkeypatch.setattr(jmoe, "moe_ffn_sharded", jrecord)
    monkeypatch.setattr(moe_lm, "moe_ffn_sharded", record)
    grid = [(None, 4), (FakeMesh(data=2), 4), (FakeMesh(data=2, model=3), 4),
            (FakeMesh(data=2, model=4), 4), (FakeMesh(data=2, model=4), 3),
            (FakeMesh(data=1, model=8), 3), (FakeMesh(model=16), 2),
            (FakeMesh(pod=2, data=2, model=2), 2), (FakeMesh(pod=2, data=4, model=2), 6),
            (FakeMesh(pod=2, data=4, model=8), 8)]
    taken = []
    for mesh, B in grid:
        calls.clear()
        x = np.random.default_rng(0).standard_normal((B, 4, cfg.d_model)).astype(np.float32)
        with juse_sharding_rules(lambda *a: None, mesh):
            jmoe_lm._moe_layer_apply(jlp, jnp.asarray(x), jcfg)
        with use_sharding_rules(lambda *a: None, mesh), torch.no_grad():
            moe_lm._moe_layer_apply(params["layers"][0], torch.from_numpy(x), cfg)
        assert calls in ([], ["jax", "port"]), (mesh and mesh.shape, B, calls)
        assert moe_lm.sharded_moe_applies(mesh, cfg, B) == bool(calls)
        taken.append(bool(calls))
    assert any(taken) and not all(taken)


def test_shard_map_slices_runs_and_assembles():
    mesh = _host_mesh(2, 4)
    x = torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 3, 8)
    w = torch.arange(8 * 5, dtype=torch.float32).reshape(8, 5)

    def body(comm, xb, wb):
        assert xb.shape == (2, 3, 8) and wb.shape == (2, 5)
        part = xb[..., 2 * comm.axis_index("model"):][..., :2] @ wb  # this shard's 2 rows of w
        total = comm.allreduce(part, axes="model", tag="model").wait()
        rows = comm.allreduce(torch.tensor(float(xb.shape[0])), axes=("data",)).wait()
        return total, rows

    fn = shard_map(body, mesh, in_specs=(P("data", None, None), P("model", None)),
                   out_specs=(P("data", None, None), P()))
    y, rows = fn(x, w)
    torch.testing.assert_close(y, x @ w, rtol=0, atol=0)
    assert float(rows) == 4.0
    assert mesh.counts == {"allreduce": 2, "allreduce.model": 1}


def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)


def _port_grads(api, params, tokens, mesh, remat=False):
    named = dict(params.named_parameters())
    with use_sharding_rules(make_resolver(mesh, DEFAULT_RULES()), mesh):
        logits, aux = api.forward(params, {"tokens": torch.from_numpy(tokens)}, remat=remat)
        loss = next_token_loss(logits, torch.from_numpy(tokens)) + AUX_WEIGHT * aux
        grads = torch.autograd.grad(loss, list(named.values()))
    return dict(zip(named, grads))


def _jax_grads(japi, jparams, tokens, data, cfg):
    """jax.grad of the whole batch's nll plus 0.01 x the mean over the data
    shards of JAX's aux on each shard's rows, unsharded, as port tensors."""
    b = tokens.shape[0] // data

    def loss(p):
        logits, _ = japi.forward(p, {"tokens": jnp.asarray(tokens)})
        auxes = [japi.forward(p, {"tokens": jnp.asarray(tokens[s * b:(s + 1) * b])})[1]
                 for s in range(data)]
        return jnext_token_loss(logits, jnp.asarray(tokens)) + AUX_WEIGHT * sum(auxes) / data

    g = jax.tree.map(np.asarray, jax.grad(loss)(jparams))
    return dict(convert.lm_params_from_arrays(cfg, g, device="cpu").named_parameters())


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "granite-moe-1b-a400m"])
def test_sharded_grads_match_jax(name, shape):
    japi, jparams, api, params = _models(name)
    cfg = api.cfg
    tokens = _tokens(cfg)
    got = _port_grads(api, params, tokens, _host_mesh(*shape))
    want = _jax_grads(japi, jparams, tokens, shape[0], cfg)
    assert set(got) == set(want)
    for k, g in got.items():
        ref = want[k].detach().double()
        err = float((g.double() - ref).norm() / ref.norm())
        assert err <= GRAD, (k, err)


def test_sharded_backward_collectives_by_tag():
    _, _, api, params = _models("olmoe-1b-7b")
    cfg = api.cfg
    mesh = _host_mesh(2, 4)
    _port_grads(api, params, _tokens(cfg), mesh)
    L = cfg.n_layers
    # forward: psum(y, model) and the aux mean; backward: the transposes of
    # the in_specs: x over "model", the router over every axis, and each of
    # the three expert weights over the batch axes
    assert mesh.counts == {"allreduce": 7 * L, "allreduce.model": L, "allreduce.aux": L,
                           "allreduce.grad_x": L, "allreduce.grad_router": L,
                           "allreduce.grad_experts": 3 * L}
    # result bytes a shard, by group: x's block (2 x 16 x d f32) over the 4 model
    # shards, the router over all 8, the experts' blocks over the 2 data shards
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    assert mesh.coll_bytes[("allreduce", 8)] == L * d * E * 4
    assert mesh.coll_bytes[("allreduce", 2)] == L * (4 + 3 * (E // 4) * d * f * 4)
    assert mesh.coll_bytes[("allreduce", 4)] == L * 2 * (2 * 16 * d * 4)


def test_sharded_remat_gives_the_same_grads():
    _, _, api, params = _models("granite-moe-1b-a400m")
    tokens = _tokens(api.cfg)
    plain = _port_grads(api, params, tokens, _host_mesh(2, 4))
    remat_mesh = _host_mesh(2, 4)
    remat = _port_grads(api, params, tokens, remat_mesh, remat=True)
    for k, g in plain.items():
        torch.testing.assert_close(remat[k], g, rtol=0, atol=0)
    # remat reruns each layer's forward region once more in the backward
    L = api.cfg.n_layers
    assert remat_mesh.counts["allreduce.model"] == 2 * L
    assert remat_mesh.counts["allreduce.grad_x"] == L
