"""The dry-run of the production meshes, as the JAX package's
``launch/dryrun.py``: for every (architecture x input shape) cell, on

    single-pod : 16 x 16        ("data", "model")        = 256 devices
    multi-pod  : 2 x 16 x 16    ("pod", "data", "model") = 512 devices

it places the step program's arguments (``train_step`` for train shapes,
``prefill`` for prefill shapes, ``serve_step``, one token against a
seq_len cache, for decode shapes) under the sharding rules, runs that
program on the ``meta`` device under the census of
``launch/roofline.analyze_program`` (JAX lowers and compiles it), and
writes a JSON record per cell. Everything is built on the ``meta`` device
(the mesh too): nothing is allocated and no kernel runs.

Each record holds ``status`` (``long_500k`` is skipped for full quadratic
attention), ``program``, ``memory.argument_bytes_per_device`` (the sum of
the blocks one device holds: the parameters, plus AdamW's m and v and the
step counters when training, plus the batch, plus the cache when
decoding), ``analytic`` (``launch/analytic.py``), ``roofline_analytic``
(``launch/roofline.roofline_terms`` of the analytic FLOPs and bytes per
device at the H100's rates; the collective term is 0 and marked not
counted), ``sharding_fallbacks`` (the rules' drops, each once) and
``variant`` (``cache_layout`` picks the cache layout, ``attn_chunk`` the
config's attention chunk, ``groups`` cuts the depth to that many layer
groups as JAX's ``_with_groups`` does, ``remat`` and ``pipelined_clip``
set the train step's, and ``moe_shard_map`` runs the MoE layers through
``moe_ffn_sharded`` on the meta mesh, forward and backward).

The traced half (``trace=True``, the default; JAX's keys in brackets):

* ``trace_s`` (``lower_s``, ``compile_s``): seconds to run the program
  on ``meta``;
* ``memory.temp_bytes_per_device`` (the memory analysis's temp bytes):
  the census's peak of live storages the program created, over the
  devices; ``memory.peak_bytes_per_device``: that plus the argument
  bytes;
* ``traced`` (``hlo``): ``flops_per_chip``, ``hbm_bytes_per_chip``,
  ``wire_bytes_per_chip`` and ``n_ops`` (JAX's ``n_whiles``: eager code
  has no loop to count);
* ``collectives`` (the same keys as JAX's): the ``shard_map`` regions'
  all-reduces, their wire bytes a device by kind and their count;
* ``roofline_traced`` (``roofline_hlo``) and ``model_vs_traced_flops``
  (``model_vs_hlo_flops``: the 6ND FLOPs over the traced FLOPs);
* ``sharding_fallbacks`` now also holds the drops of the activation
  hints, which fire while the program runs under the rules, as JAX logs
  them while it lowers.

The port has no SPMD partitioner: the program runs at the global shapes,
so "per chip" is the global count divided by the mesh size, an ideal
split, where JAX's are the partitioned program's own. Only the explicit
``shard_map`` regions' collectives are counted (``collective_counted``:
"shard_map regions"), not the GSPMD collectives JAX's partitioner adds.
``hlo_raw_cost_analysis`` has no counterpart and is left out.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny \\
        --shape train_4k --mesh single --out /tmp/x
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace

import torch

from ..configs import SHAPES, get_config, list_configs
from ..models import build_model
from ..models.common import use_sharding_rules
from ..train.optimizer import AdamWConfig
from ..train.train_step import TrainConfig, abstract_train_state, make_train_step
from .analytic import analytic_flops, analytic_hbm_bytes, model_flops_simple, param_count
from .mesh import make_production_mesh
from .roofline import analyze_program, roofline_terms
from .sharding import (
    DEFAULT_RULES,
    batch_shardings,
    cache_shardings,
    make_resolver,
    named_shardings,
    param_shardings,
    scalar_sharding,
    sharded_bytes,
    tree_leaves,
)

__all__ = ["run_cell", "main", "step_train_config"]


def _argument_pairs(api, shape, mesh, rules, variant: dict):
    """(program, [(tensor, sharding)] of the step program's arguments)."""
    p_sh = named_shardings(param_shardings(api, mesh, rules))
    specs = api.input_specs(shape)
    sc = scalar_sharding(mesh)
    if shape.kind == "train":
        state = abstract_train_state(api)
        pairs = [(t, p_sh[k]) for k, t in state.params.named_parameters()]
        for moments in (state.opt.m, state.opt.v):
            pairs += [(t, p_sh[k]) for k, t in moments.items()]
        pairs += [(state.opt.step, sc), (state.opt.prev_norm, sc), (state.step, sc)]
        b_sh = batch_shardings(specs, mesh, rules)
        return "train_step", pairs + [(specs[k], b_sh[k]) for k in specs]
    params = [(t, p_sh[k]) for k, t in api.abstract_params().named_parameters()]
    if shape.kind == "prefill":
        b_sh = batch_shardings(specs, mesh, rules)
        return "prefill", params + [(specs[k], b_sh[k]) for k in specs]
    c_sh = cache_shardings(specs["cache"], shape, mesh, rules,
                           layout=variant.get("cache_layout", "default"))
    tok_sh = batch_shardings({"token": specs["token"]}, mesh, rules)["token"]
    cache = list(zip(tree_leaves(specs["cache"]), tree_leaves(c_sh)))
    return "serve_step", params + [(specs["token"], tok_sh)] + cache + [(specs["pos"], sc)]


def _group_size(cfg) -> int:
    """Layers a repeating group holds (JAX's ``_group_size``)."""
    if cfg.family == "ssm":
        return cfg.slstm_every
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family == "vlm":
        return cfg.cross_attn_every
    return 1


def _with_groups(cfg, groups: int):
    """The config cut to ``groups`` layer groups (JAX's ``_with_groups``)."""
    new = {"n_layers": groups * _group_size(cfg)}
    if cfg.family == "encdec":
        new["n_enc_layers"] = groups
    return replace(cfg, **new)


def step_train_config(variant: dict | None = None) -> TrainConfig:
    """The train step the dry run traces (JAX's ``_lower_cell``): AdamW at
    lr 1e-4 with a clip at norm 1, remat on unless the variant says."""
    variant = variant or {}
    return TrainConfig(
        optimizer=AdamWConfig(lr=1e-4, clip_norm=1.0,
                              pipelined_clip=variant.get("pipelined_clip", False)),
        remat=variant.get("remat", True))


def _step_program(api, shape, variant: dict):
    """The step program of a cell on the meta device, as a thunk: JAX's
    ``_lower_cell`` lowers the same three programs. ``train_step`` on
    ``abstract_train_state`` and ``input_specs``; ``prefill``; and the
    ``serve_step``, one ``decode`` at pos = seq_len - 1 on the meta cache.
    The two serving programs run under ``torch.no_grad``, as the port's
    serving entry points do (the parameters require grad: autograd would
    keep every activation alive)."""
    specs = api.input_specs(shape)
    if shape.kind == "train":
        step = make_train_step(api, step_train_config(variant))
        state = abstract_train_state(api)
        return lambda: step(state, specs)
    params = api.abstract_params()
    if shape.kind == "prefill":
        return torch.no_grad()(lambda: api.prefill(params, specs))
    return torch.no_grad()(
        lambda: api.decode(params, specs["token"], specs["cache"], shape.seq_len - 1))


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, trace: bool = True,
             verbose: bool = True, variant: dict | None = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    variant = variant or {}
    if variant.get("attn_chunk"):
        cfg = replace(cfg, attn_chunk=int(variant["attn_chunk"]))
    if variant.get("groups"):
        cfg = _with_groups(cfg, int(variant["groups"]))
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "status": "ok",
        "variant": variant,
    }
    if shape_name == "long_500k" and not cfg.subquadratic:
        rec["status"] = "skipped"
        rec["reason"] = "full quadratic attention at 524288 — skipped by design"
        return rec

    n_chips = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = DEFAULT_RULES()
    t0 = time.perf_counter()
    api = build_model(cfg)
    program, pairs = _argument_pairs(api, shape, mesh, rules, variant)
    rec["program"] = program
    rec["memory"] = {"argument_bytes_per_device": sharded_bytes(pairs)}
    if trace:
        t1 = time.perf_counter()
        thunk = _step_program(api, shape, variant)
        with use_sharding_rules(make_resolver(mesh, rules),
                                mesh if variant.get("moe_shard_map") else None):
            census = analyze_program(thunk, mesh=mesh)
        rec["trace_s"] = time.perf_counter() - t1
        temp = census.peak_live_bytes / n_chips
        rec["memory"]["temp_bytes_per_device"] = temp
        rec["memory"]["peak_bytes_per_device"] = rec["memory"]["argument_bytes_per_device"] + temp
        rec["traced"] = {
            "flops_per_chip": census.flops / n_chips,
            "hbm_bytes_per_chip": census.hbm_bytes / n_chips,
            "wire_bytes_per_chip": census.wire_bytes,
            "n_ops": census.n_ops,
            "ops_by_class": census.ops_by_class,
        }
        rec["collectives"] = {
            "wire_bytes_per_chip": census.wire_bytes,
            "by_kind_bytes": census.coll_by_kind_bytes,
            "by_kind_count": census.coll_by_kind_count,
            "collective_counted": "shard_map regions",
        }
    # each drop once, in the order the rules met them (a hint fires once a layer)
    rec["sharding_fallbacks"] = [
        {"shape": list(s), "axis": a, "why": w} for (s, a, w) in dict.fromkeys(rules.dropped)
    ][:20]
    rec["analytic"] = {
        "model_flops_6nd": model_flops_simple(cfg, shape),
        "detailed_flops": analytic_flops(cfg, shape),
        "hbm_bytes": analytic_hbm_bytes(cfg, shape),
        "params": param_count(cfg),
    }
    an = rec["analytic"]
    terms = roofline_terms(an["detailed_flops"] / n_chips, an["hbm_bytes"] / n_chips, 0.0)
    terms["collective_counted"] = False  # the analytic model counts no collective
    rec["roofline_analytic"] = terms
    if trace:
        tr = rec["traced"]
        rec["roofline_traced"] = roofline_terms(tr["flops_per_chip"], tr["hbm_bytes_per_chip"],
                                                tr["wire_bytes_per_chip"])
        rec["roofline_traced"]["collective_counted"] = "shard_map regions"
        rec["model_vs_traced_flops"] = (an["model_flops_6nd"] / (tr["flops_per_chip"] * n_chips)
                                        if tr["flops_per_chip"] else None)
    rec["seconds"] = time.perf_counter() - t0
    if verbose:
        ratio = tr["flops_per_chip"] * n_chips / an["detailed_flops"] if trace else 0.0
        traced = (f" trace={rec['trace_s']:6.1f}s peak/dev="
                  f"{rec['memory']['peak_bytes_per_device'] / 2**30:8.3f}GiB "
                  f"traced/analytic flops={ratio:.3f}" if trace else "")
        print(
            f"[{rec['mesh']}] {arch:24s} {shape_name:12s} {program:10s} "
            f"args/dev={rec['memory']['argument_bytes_per_device'] / 2**30:8.3f}GiB "
            f"dom={terms['dominant']:8s} bound={terms['bound_s'] * 1e3:9.3f}ms{traced}",
            flush=True,
        )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry-run of the production meshes (meta device)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-trace", action="store_true",
                    help="place the arguments only; do not run the step program on meta")
    args = ap.parse_args(argv)

    archs = list_configs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                try:
                    rec = run_cell(arch, shape, mp, trace=not args.no_trace)
                except Exception as e:  # a failure here is a bug in the port
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                    failures.append(tag)
                    print(f"FAILED {tag}: {e}", flush=True)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1, default=float)
    print(f"\ndone; {len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
