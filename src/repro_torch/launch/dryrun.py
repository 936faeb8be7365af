"""The dry-run of the production meshes, as the JAX package's
``launch/dryrun.py``: for every (architecture x input shape) cell, on

    single-pod : 16 x 16        ("data", "model")        = 256 devices
    multi-pod  : 2 x 16 x 16    ("pod", "data", "model") = 512 devices

it places the step program's arguments (``train_step`` for train shapes,
``prefill`` for prefill shapes, ``serve_step``, one token against a
seq_len cache, for decode shapes) under the sharding rules, and writes a
JSON record per cell. Everything is built on the ``meta`` device (the
mesh too): nothing is allocated and nothing runs.

Each record holds ``status`` (``long_500k`` is skipped for full quadratic
attention), ``program``, ``memory.argument_bytes_per_device`` (the sum of
the blocks one device holds: the parameters, plus AdamW's m and v and the
step counters when training, plus the batch, plus the cache when
decoding), ``analytic`` (``launch/analytic.py``), ``roofline_analytic``
(``launch/roofline.roofline_terms`` of the analytic FLOPs and bytes per
device at the H100's rates; the collective term is 0 and marked not
counted), ``sharding_fallbacks`` (the rules' drops for those arguments)
and ``variant`` (``cache_layout`` picks the cache layout, ``attn_chunk``
the config's attention chunk).

JAX's half that lowers and compiles the program has no torch
counterpart, so these keys are left out rather than filled with zeros:
``lower_s``, ``compile_s``, the memory analysis's output, temp, alias
and peak bytes, ``hlo_raw_cost_analysis``, ``hlo``, ``collectives``,
``roofline_hlo`` and ``model_vs_hlo_flops``. For the same reason the
drops that JAX's lowering logs for activation hints are not in
``sharding_fallbacks``: the port logs those when a forward runs under
``use_sharding_rules``.

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

from ..configs import SHAPES, get_config, list_configs
from ..models import build_model
from ..train.train_step import abstract_train_state
from .analytic import analytic_flops, analytic_hbm_bytes, model_flops_simple, param_count
from .mesh import make_production_mesh
from .roofline import roofline_terms
from .sharding import (
    DEFAULT_RULES,
    batch_shardings,
    cache_shardings,
    named_shardings,
    param_shardings,
    scalar_sharding,
    sharded_bytes,
    tree_leaves,
)

__all__ = ["run_cell", "main"]


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


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, verbose: bool = True,
             variant: dict | None = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    variant = variant or {}
    if variant.get("attn_chunk"):
        cfg = replace(cfg, attn_chunk=int(variant["attn_chunk"]))
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
    program, pairs = _argument_pairs(build_model(cfg), shape, mesh, rules, variant)
    rec["program"] = program
    rec["memory"] = {"argument_bytes_per_device": sharded_bytes(pairs)}
    rec["sharding_fallbacks"] = [
        {"shape": list(s), "axis": a, "why": w} for (s, a, w) in rules.dropped[:20]
    ]
    rec["analytic"] = {
        "model_flops_6nd": model_flops_simple(cfg, shape),
        "detailed_flops": analytic_flops(cfg, shape),
        "hbm_bytes": analytic_hbm_bytes(cfg, shape),
        "params": param_count(cfg),
    }
    an = rec["analytic"]
    terms = roofline_terms(an["detailed_flops"] / n_chips, an["hbm_bytes"] / n_chips, 0.0)
    terms["collective_counted"] = False  # no lowered program to count collectives in
    rec["roofline_analytic"] = terms
    rec["seconds"] = time.perf_counter() - t0
    if verbose:
        print(
            f"[{rec['mesh']}] {arch:24s} {shape_name:12s} {program:10s} "
            f"args/dev={rec['memory']['argument_bytes_per_device'] / 2**30:8.3f}GiB "
            f"dom={terms['dominant']:8s} bound={terms['bound_s'] * 1e3:9.3f}ms",
            flush=True,
        )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry-run of the production meshes (meta device)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="build/dryrun")
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
                    rec = run_cell(arch, shape, mp)
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
