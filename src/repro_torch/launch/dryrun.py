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
the blocks one device holds of the arguments the program reads: the
parameters, plus AdamW's m and v and the step counters when training,
plus the batch, plus the cache when decoding; JAX's ``jit`` prunes the
arguments a program never reads, and so does the port: see
``_argument_pairs``),
``analytic`` (``launch/analytic.py``), ``roofline_analytic``
(``launch/roofline.roofline_terms`` of the analytic FLOPs and bytes per
device at the H100's rates; the collective term is 0 and marked not
counted), ``sharding_fallbacks`` (the rules' drops, each once) and
``variant`` (``cache_layout`` picks the cache layout, ``attn_chunk`` the
config's attention chunk, ``groups`` cuts the depth to that many layer
groups as JAX's ``_with_groups`` does, ``remat`` and ``pipelined_clip``
set the train step's, and ``moe_shard_map`` runs the MoE layers through
``moe_ffn_sharded`` on the meta mesh, forward and backward).

The traced half (``trace=True``, the default; JAX's keys in brackets)
counts one device's share of the SPMD-partitioned program, as JAX's
figures are those of the program its partitioner made: ``_trace_cell``
(JAX's ``_lower_cell``) runs the step program on ``meta`` under the census
of ``launch/roofline.analyze_program`` with the arguments' shardings, and
``launch/spmd.py`` propagates a placement to every tensor (the arguments'
shardings, the activation hints, a tensor's for its gradient, and a
rule table of aten ops), so every op is counted at the block one device
holds and every reshard the placements imply is a collective:

* ``trace_s`` (``lower_s``, ``compile_s``): seconds to run the program
  on ``meta``;
* ``memory.temp_bytes_per_device`` (the memory analysis's temp bytes):
  the peak of the live storages the program created, at one device's
  blocks; ``memory.peak_bytes_per_device``: that plus the argument bytes;
* ``traced`` (``hlo``): ``flops_per_chip``, ``hbm_bytes_per_chip`` (at
  the eager op boundary, where XLA counts at its fusion boundary),
  ``wire_bytes_per_chip`` and ``n_ops`` (JAX's ``n_whiles``: eager code
  has no loop to count);
* ``collectives`` (the same keys as JAX's): the collectives a device
  runs by kind (``allreduce``, ``allgather``, ``alltoall``, ``shift`` for
  JAX's all-reduce, all-gather, all-to-all, collective-permute), their
  wire bytes a device by ``analyze_hlo``'s ring factors and their count
  (one per reshard: XLA combines some, so counts differ where bytes
  agree); ``collective_counted`` names both sources, and ``regions``
  holds the ``shard_map`` regions' own counts by kind and tag and their
  wire bytes;
* ``roofline_traced`` (``roofline_hlo``) and ``model_vs_traced_flops``
  (``model_vs_hlo_flops``: the 6ND FLOPs over the traced FLOPs of all
  devices);
* ``sharding_fallbacks`` now also holds the drops of the activation
  hints, which fire while the program runs under the rules, as JAX logs
  them while it lowers.

On the 2 x 4 mesh of 8 CPU devices the FLOPs and argument bytes equal
JAX's compiled program's, and the wire and temp bytes lie within 2x of
them, in every family (tests/test_torch_dryrun_partitioned.py and
tests/test_torch_dryrun_families.py, which hold five FLOP gaps that are
the reference program's own to the byte; PERF.md).
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

__all__ = ["run_cell", "main", "step_train_config", "COLLECTIVES_COUNTED"]

# what ``collectives`` counts: both kinds of collective a device runs
COLLECTIVES_COUNTED = "shard_map regions and the placements' reshards"


def _arguments(api, shape):
    """The step program's arguments on the meta device: (the train state
    for a train shape, else the parameters; ``input_specs``)."""
    specs = api.input_specs(shape)
    if shape.kind == "train":
        return abstract_train_state(api), specs
    return api.abstract_params(), specs


def _argument_pairs(api, shape, mesh, rules, variant: dict, args=None):
    """(program, [(tensor, sharding)] of the step program's arguments), of
    ``args`` (``_arguments``) when given. As JAX's ``jit`` prunes the
    arguments a program never reads, these are left out: the train step's
    ``labels`` (its loss shifts ``tokens``) and AdamW's ``prev_norm`` (read
    by the pipelined clip only), and of the serve step what the model's
    ``decode`` does not read (``ModelApi.decode_reads``)."""
    p_sh = named_shardings(param_shardings(api, mesh, rules))
    tree, specs = args if args is not None else _arguments(api, shape)
    sc = scalar_sharding(mesh)
    if shape.kind == "train":
        pairs = [(t, p_sh[k]) for k, t in tree.params.named_parameters()]
        for moments in (tree.opt.m, tree.opt.v):
            pairs += [(t, p_sh[k]) for k, t in moments.items()]
        pairs += [(tree.opt.step, sc), (tree.step, sc)]
        if variant.get("pipelined_clip"):
            pairs.append((tree.opt.prev_norm, sc))
        b_sh = batch_shardings(specs, mesh, rules)
        return "train_step", pairs + [(specs[k], b_sh[k]) for k in specs if k != "labels"]
    if shape.kind == "prefill":
        b_sh = batch_shardings(specs, mesh, rules)
        params = [(t, p_sh[k]) for k, t in tree.named_parameters()]
        return "prefill", params + [(specs[k], b_sh[k]) for k in specs]
    reads = api.decode_reads
    params = [(t, p_sh[k]) for k, t in tree.named_parameters() if reads("params." + k)]
    cache = specs["cache"]
    c_sh = cache_shardings(cache, shape, mesh, rules,
                           layout=variant.get("cache_layout", "default"))
    tok_sh = batch_shardings({"token": specs["token"]}, mesh, rules)["token"]
    kept = [pair for f, t, sh in zip(cache._fields, cache, c_sh) if reads("cache." + f)
            for pair in zip(tree_leaves(t), tree_leaves(sh))]
    pos = [(specs["pos"], sc)] if reads("pos") else []
    return "serve_step", params + [(specs["token"], tok_sh)] + kept + pos


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


def _step_program(api, shape, variant: dict, args=None):
    """The step program of a cell on the meta device, as a thunk: JAX's
    ``_lower_cell`` lowers the same three programs. ``train_step`` on
    ``abstract_train_state`` and ``input_specs``; ``prefill``; and the
    ``serve_step``, one ``decode`` at pos = seq_len - 1 on the meta cache.
    The two serving programs run under ``torch.no_grad``, as the port's
    serving entry points do (the parameters require grad: autograd would
    keep every activation alive). ``args`` (``_arguments``) are the
    tensors it runs on, fresh ones when None."""
    tree, specs = args if args is not None else _arguments(api, shape)
    if shape.kind == "train":
        step = make_train_step(api, step_train_config(variant))
        return lambda: step(tree, specs)
    if shape.kind == "prefill":
        return torch.no_grad()(lambda: api.prefill(tree, specs))
    return torch.no_grad()(
        lambda: api.decode(tree, specs["token"], specs["cache"], shape.seq_len - 1))


def _trace_cell(cfg, shape, mesh, rules, variant: dict | None = None):
    """JAX's ``_lower_cell(cfg, shape, mesh, rules, variant)``: the cell's
    step program with its arguments placed on ``mesh`` under ``rules``,
    counted at one device's share (``launch/roofline.analyze_program``).
    Returns (program, [(argument, sharding)], the census, seconds)."""
    variant = variant or {}
    api = build_model(cfg)
    args = _arguments(api, shape)
    program, pairs = _argument_pairs(api, shape, mesh, rules, variant, args)
    thunk = _step_program(api, shape, variant, args)
    t0 = time.perf_counter()
    with use_sharding_rules(make_resolver(mesh, rules),
                            mesh if variant.get("moe_shard_map") else None):
        census = analyze_program(thunk, mesh=mesh, shardings=pairs)
    return program, pairs, census, time.perf_counter() - t0


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
    if trace:
        program, pairs, census, rec["trace_s"] = _trace_cell(cfg, shape, mesh, rules, variant)
    else:
        api = build_model(cfg)
        program, pairs = _argument_pairs(api, shape, mesh, rules, variant)
    rec["program"] = program
    rec["memory"] = {"argument_bytes_per_device": sharded_bytes(pairs)}
    if trace:
        temp = census.peak_live_bytes
        rec["memory"]["temp_bytes_per_device"] = temp
        rec["memory"]["peak_bytes_per_device"] = rec["memory"]["argument_bytes_per_device"] + temp
        rec["traced"] = {
            "flops_per_chip": census.flops,
            "hbm_bytes_per_chip": census.hbm_bytes,
            "wire_bytes_per_chip": census.wire_bytes,
            "n_ops": census.n_ops,
            "ops_by_class": census.ops_by_class,
        }
        rec["collectives"] = {
            "wire_bytes_per_chip": census.wire_bytes,
            "by_kind_bytes": census.coll_by_kind_bytes,
            "by_kind_count": census.coll_by_kind_count,
            "collective_counted": COLLECTIVES_COUNTED,
            # the shard_map regions' own collectives, by kind and tag
            "regions": {"counts": census.region_counts,
                        "wire_bytes_per_chip": census.region_wire_bytes},
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
        rec["roofline_traced"]["collective_counted"] = COLLECTIVES_COUNTED
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
