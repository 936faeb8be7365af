"""The dry run's traced half: ``launch.roofline.analyze_program`` (the
port's counterpart of JAX's ``analyze_hlo``) and the records
``launch.dryrun.run_cell`` writes with it, against the JAX package on the
CPU.

* FLOPs of the reduced internlm2-1.8b prefill, decode and train step
  (AdamW with a clip, remat on: what the dry run traces) against
  ``analyze_hlo`` of JAX's same program, lowered and compiled on one CPU
  device as tests/test_sharding_roofline.py does: equal within 1e-6
  (they are the same matmuls; the remat recompute is in both).
* The census against ``FlopCounterMode`` on the same meta program, and
  hbm and peak bytes of a toy program counted by hand.
* Nothing runs off ``meta``, at full size too (internlm2-1.8b's prefill_32k
  holds over a TiB of attention scores); a ``shard_map`` region on a meta mesh is
  counted on every shard, its collectives by kind with ring factors.
* The whisper-tiny train_4k record holds the counterparts of JAX's keys,
  and its fallbacks are exactly JAX's: the parameters' drops and those of
  the activation hints that JAX's forward resolves at full size.
* The olmoe-1b-7b train_4k cell with ``moe_shard_map`` (one layer group)
  runs the sharded MoE forward and backward on the 16 x 16 meta mesh and
  counts its nine all-reduces a layer.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jconfigs
import repro.launch.sharding as jsh
from repro.configs.base import ShapeConfig as JShape
from repro.launch.roofline import HloAnalysis, analyze_hlo
from repro.models import build_model as jbuild_model
from repro.models.common import use_sharding_rules as juse_sharding_rules
from repro.train import AdamWConfig, TrainConfig, abstract_train_state, make_train_step
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, shard_map
from repro_torch.launch.roofline import analyze_program, wire_bytes
from repro_torch.launch.sharding import P
from repro_torch.models import build_model

FLOPS_RTOL = 1e-6


def _jax_program(japi, kind, T, B):
    """JAX's step program of this kind, lowered as JAX's dry run lowers it."""
    specs = japi.input_specs(JShape("x", T, B, kind))
    if kind == "prefill":
        return jax.jit(japi.prefill).lower(japi.abstract_params(), specs)
    if kind == "decode":
        return jax.jit(lambda p, t, c, pos: japi.decode(p, t, c, pos)).lower(
            japi.abstract_params(), specs["token"], specs["cache"], jnp.int32(T - 1))
    step = make_train_step(japi, TrainConfig(optimizer=AdamWConfig(lr=1e-4, clip_norm=1.0),
                                             remat=True))
    return jax.jit(step).lower(abstract_train_state(japi), specs)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_flops_equal_jax_analyze_hlo(kind):
    name, T, B = "internlm2-1.8b", 32, 2
    japi = jbuild_model(jconfigs.reduced(jconfigs.get_config(name)))
    hl = analyze_hlo(_jax_program(japi, kind, T, B).compile().as_text())
    api = build_model(configs.reduced(configs.get_config(name)))
    census = analyze_program(dryrun._step_program(api, ShapeConfig("x", T, B, kind), {}))
    assert hl.flops > 0
    assert census.flops == pytest.approx(hl.flops, rel=FLOPS_RTOL)
    assert census.devices == {"meta"} and census.n_ops > 0


def test_flops_equal_flop_counter_mode():
    api = build_model(configs.reduced(configs.get_config("olmoe-1b-7b")))
    shape = ShapeConfig("x", 32, 4, "train")
    census = analyze_program(dryrun._step_program(api, shape, {}))
    with FlopCounterMode(display=False) as fc:
        dryrun._step_program(api, shape, {})()
    assert census.flops == fc.get_total_flops() > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_nothing_runs_off_meta_at_full_size(shape):
    api = build_model(configs.get_config("internlm2-1.8b"))
    census = analyze_program(dryrun._step_program(api, configs.SHAPES[shape], {}))
    assert census.devices == {"meta"}
    assert census.peak_live_bytes > 2**40 if shape == "prefill_32k" else census.n_ops > 0


def test_toy_program_bytes_and_peak_by_hand():
    x = torch.empty((4, 8), device="meta")
    w = torch.empty((8, 16), device="meta")

    def prog(x, w):
        y = x @ w          # mm: reads 128 + 512 B, writes 256 B; 2 * 4 * 16 * 8 FLOPs
        z = y.t()          # a view: no traffic, no storage
        s = torch.relu(z)  # reads 256 B, writes 256 B; y and s alive: 512 B
        del y, z
        return s.sum()     # reads 256 B, writes 4 B; y is gone: 260 B

    census = analyze_program(prog, x, w)
    assert census.flops == 2 * 4 * 16 * 8
    assert census.hbm_bytes == (128 + 512 + 256) + (256 + 256) + (256 + 4)
    assert census.peak_live_bytes == 512
    assert census.ops_by_class == {"matmul": 1, "view": 1, "elementwise": 1, "reduction": 1}
    assert census.bytes_by_op == {"aten.mm": 896, "aten.relu": 512, "aten.sum": 260}
    # an in-place update moves its bytes but creates no storage
    census = analyze_program(lambda t: t.add_(1.0), x)
    assert census.hbm_bytes == 256 and census.peak_live_bytes == 0


def test_shard_map_region_counted_on_every_shard():
    mesh = Mesh(np.array(["meta"] * 8, dtype=object).reshape(2, 4), ("data", "model"))
    x = torch.empty((4, 3, 8), device="meta")
    w = torch.empty((8, 5), device="meta")

    def body(comm, xb, wb):  # xb (2, 3, 8), wb (2, 5): this shard's rows of w
        part = xb[..., :2] @ wb
        return comm.allreduce(part, axes="model", tag="model").wait(), part.sum()

    fn = shard_map(body, mesh, in_specs=(P("data", None, None), P("model", None)),
                   out_specs=(P("data", None, None), P()))
    with torch.no_grad():
        census = analyze_program(fn, x, w, mesh=mesh)
    assert census.devices == {"meta"}
    assert census.flops == 8 * 2 * (2 * 3 * 5) * 2  # every shard's product
    assert mesh.counts == {"allreduce": 1, "allreduce.model": 1}
    assert census.coll_by_kind_count == {"allreduce": 1}
    block = 2 * 3 * 5 * 4  # the (2, 3, 5) f32 block, over the 4 model shards
    assert census.wire_bytes == census.coll_by_kind_bytes["allreduce"] == 2 * block * 3 / 4


def test_wire_bytes_are_analyze_hlo_ring_factors():
    for ours, theirs in (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                         ("alltoall", "all-to-all"), ("shift", "collective-permute")):
        for group in (2, 16, 256):
            hl = HloAnalysis()
            hl.add_coll(theirs, 4096, group, 1.0)
            assert wire_bytes(ours, 4096, group) == hl.wire_bytes


def test_whisper_train_record_and_fallbacks_are_jax():
    rec = dryrun.run_cell("whisper-tiny", "train_4k", False, verbose=False)
    assert rec["trace_s"] > 0 and rec["traced"]["n_ops"] > 0
    for k in ("flops_per_chip", "hbm_bytes_per_chip", "wire_bytes_per_chip"):
        assert k in rec["traced"]
    # one device's share: the partitioner's all-reduces and all-gathers are counted
    assert rec["traced"]["flops_per_chip"] > 0 and rec["traced"]["wire_bytes_per_chip"] > 0
    assert set(rec["collectives"]) >= {"wire_bytes_per_chip", "by_kind_bytes", "by_kind_count"}
    assert rec["collectives"]["by_kind_count"]["allreduce"] > 0
    assert rec["collectives"]["regions"] == {"counts": {}, "wire_bytes_per_chip": 0.0}
    mem = rec["memory"]
    assert mem["peak_bytes_per_device"] == mem["argument_bytes_per_device"] + \
        mem["temp_bytes_per_device"] > mem["argument_bytes_per_device"]
    assert rec["roofline_traced"]["collective_counted"] == dryrun.COLLECTIVES_COUNTED
    assert rec["model_vs_traced_flops"] == pytest.approx(
        rec["analytic"]["model_flops_6nd"] / (rec["traced"]["flops_per_chip"] * 256))
    # JAX's drops: its parameters', then the activation hints its forward
    # resolves (traced abstractly at full size)
    jcfg = jconfigs.get_config("whisper-tiny")
    japi = jbuild_model(jcfg)
    mesh, rules = AbstractMesh((16, 16), ("data", "model")), jsh.DEFAULT_RULES()
    jsh.param_shardings(japi, mesh, rules)
    specs = japi.input_specs(jconfigs.SHAPES["train_4k"])
    batch = {k: v for k, v in specs.items() if k != "labels"}
    def resolve(shape, logical):  # resolve (and log) the hint; constrain nothing
        jsh.resolve_spec(shape, logical, mesh, rules)

    with juse_sharding_rules(resolve):
        jax.eval_shape(japi.forward, japi.abstract_params(), batch)
    want = {(tuple(s), a, w) for s, a, w in rules.dropped}
    got = {(tuple(f["shape"]), f["axis"], f["why"]) for f in rec["sharding_fallbacks"]}
    assert got == want
    assert any(s[0] == 256 for s, _, _ in got)  # an activation's drop, not only the weights'


def test_olmoe_shard_map_cell_traces_both_regions():
    variant = {"moe_shard_map": True, "groups": 1}
    rec = dryrun.run_cell("olmoe-1b-7b", "train_4k", False, verbose=False, variant=variant)
    assert rec["status"] == "ok" and rec["variant"] == variant
    cfg = configs.get_config("olmoe-1b-7b")
    # a layer: psum(y) and the aux mean, again in the remat recompute, then
    # the backward's grad_x, grad_router and three grad_experts (the regions'
    # own; the placements' collectives come on top of them)
    regions = rec["collectives"]["regions"]
    assert {k: v for k, v in regions["counts"].items() if "." not in k} == {"allreduce": 9}
    assert rec["collectives"]["by_kind_count"]["allreduce"] > 9
    B_loc, T, d, f = 256 // 16, 4096, cfg.d_model, cfg.d_ff
    y, aux = B_loc * T * d * 2, 4  # a shard's block of y (bf16), the aux scalar
    router, expert = d * cfg.n_experts * 2, (cfg.n_experts // 16) * d * f * 2
    want = (2 * (wire_bytes("allreduce", y, 16) + wire_bytes("allreduce", aux, 16))
            + wire_bytes("allreduce", y, 16) + wire_bytes("allreduce", router, 256)
            + 3 * wire_bytes("allreduce", expert, 16))
    assert regions["wire_bytes_per_chip"] == pytest.approx(want, rel=1e-12)
    assert rec["traced"]["wire_bytes_per_chip"] > regions["wire_bytes_per_chip"]
    assert rec["roofline_traced"]["collective_s"] > 0
    # the same cell without the variant runs moe_ffn on the whole batch: no region
    plain = dryrun.run_cell("olmoe-1b-7b", "train_4k", False, verbose=False,
                            variant={"groups": 1})
    assert plain["collectives"]["regions"]["counts"] == {}
    assert math.isclose(plain["analytic"]["detailed_flops"], rec["analytic"]["detailed_flops"])
