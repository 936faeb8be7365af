"""The dry run's per-device figures against JAX's program compiled on a
("data", "model") mesh of forced CPU devices: helpers of the dry-run
tests, and a script that prints the comparison for any cells.

    PYTHONPATH=src python tests/dryrun_parity.py olmoe-1b-7b:train \\
        olmoe-1b-7b:train:moe_shard_map zamba2-2.7b:decode [--mesh 2x4] [--full]

A cell is ``arch:kind[:variant flag,...]`` (a flag is a variant key set to
True, as ``moe_shard_map``, or ``key=value`` with a JSON value, as
``remat=false``), at the ``reduced`` config unless ``--full``,
batch 8 x 256 unless ``--batch``/``--seq``. JAX's side runs in a
subprocess whose ``XLA_FLAGS`` force 8 host devices before JAX starts (its
dry-run module sets ``XLA_FLAGS`` at import, so it is imported only
there): ``_lower_cell`` lowers each cell, the compiled program gives
``memory_analysis`` and ``analyze_hlo``. The port's side is
``launch/dryrun._trace_cell`` on a meta mesh of the same shape, traced in
this process while JAX compiles.

Printed per cell: FLOPs a device (port, JAX, port - JAX), argument bytes
(port - JAX), and port / JAX for the all-gather bytes, the wire bytes and
the temp bytes, with the seconds each side took. ``--hlo DIR`` keeps
each compiled program's HLO text (where a gap's instructions are found).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# the port's collective kinds by JAX's names
KINDS = {"allreduce": "all-reduce", "allgather": "all-gather", "alltoall": "all-to-all",
         "shift": "collective-permute"}

_JAX_RUN = """
import json, os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro import configs
from repro.compat import AxisType, make_mesh
from repro.configs.base import ShapeConfig
from repro.launch import dryrun  # sets XLA_FLAGS for later processes; these devices stay
from repro.launch.roofline import analyze_hlo
from repro.launch.sharding import DEFAULT_RULES
cells, shape, seq, batch, hlo_dir = json.loads(sys.argv[1])
n = shape[0] * shape[1]
assert jax.device_count() >= n, jax.device_count()
mesh = make_mesh(tuple(shape), ("data", "model"), devices=jax.devices()[:n],
                 axis_types=(AxisType.Auto,) * 2)
for arch, reduced, kind, variant in cells:
    cfg = configs.get_config(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    t0 = time.perf_counter()
    lowered, _ = dryrun._lower_cell(cfg, ShapeConfig("s", seq, batch, kind), mesh,
                                    DEFAULT_RULES(), variant)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    text = compiled.as_text()
    hl = analyze_hlo(text)
    if hlo_dir:
        name = "_".join([arch, kind] + sorted(variant)) + f"_{shape[0]}x{shape[1]}.hlo.txt"
        open(os.path.join(hlo_dir, name), "w").write(text)
    print("JSON" + json.dumps(dict(
        flops=hl.flops, wire=hl.wire_bytes, by_kind_bytes=hl.coll_by_kind_bytes,
        args=int(ma.argument_size_in_bytes), temp=int(ma.temp_size_in_bytes),
        seconds=time.perf_counter() - t0)), flush=True)
"""


_PORT_RUN = """
import json, sys
sys.path.insert(0, sys.argv[2])
import dryrun_parity as parity
cells, shape, seq, batch = json.loads(sys.argv[1])
for arch, reduced, kind, variant in cells:
    print("JSON" + json.dumps(parity.port_cell(arch, reduced, kind, variant, tuple(shape), seq,
                                               batch)), flush=True)
"""


def start_port(cells, shape=(2, 4), seq=256, batch=8) -> subprocess.Popen:
    """:func:`port_cell` of ``cells`` in a subprocess, so that a slow cell
    traces beside the others; its figures come with :func:`collect`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    arg = json.dumps([[list(c) for c in cells], list(shape), seq, batch])
    return subprocess.Popen([sys.executable, "-c", _PORT_RUN, arg, HERE], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def start_jax(cells, shape=(2, 4), seq=256, batch=8, n_devices=8,
              hlo_dir=None) -> subprocess.Popen:
    """Start JAX's side for ``cells`` [(arch, reduced, kind, variant)]; its
    figures come with :func:`collect`. ``hlo_dir``: write each compiled
    program's HLO text there. It runs as ``conftest.run_multidevice`` runs
    its code, but in the background, so that JAX compiles while the port
    traces the same cells."""
    from conftest import SUBPROCESS_ENV  # run_multidevice's environment, but not blocking

    env = dict(SUBPROCESS_ENV)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC
    arg = json.dumps([[list(c) for c in cells], list(shape), seq, batch,
                      os.path.abspath(hlo_dir) if hlo_dir else None])
    return subprocess.Popen([sys.executable, "-c", _JAX_RUN, arg], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def collect(proc: subprocess.Popen, timeout: float = 300) -> list:
    """The figures of each cell of a :func:`start_jax` or :func:`start_port`
    subprocess, in order (AssertionError if it failed)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"the subprocess ran over {timeout} s\n{err[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"the subprocess failed (rc={proc.returncode})\n{out}\n"
                             f"{err[-4000:]}")
    return [json.loads(ln[4:]) for ln in out.splitlines() if ln.startswith("JSON")]


def meta_mesh(shape=(2, 4)):
    from repro_torch.launch.mesh import Mesh

    return Mesh(np.array(["meta"] * (shape[0] * shape[1]), dtype=object).reshape(shape),
                ("data", "model"))


def port_cell(arch, reduced, kind, variant, shape=(2, 4), seq=256, batch=8) -> dict:
    """The port's figures of one cell: ``dryrun._trace_cell`` on a meta mesh."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import DEFAULT_RULES, sharded_bytes

    cfg = configs.get_config(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    _, pairs, census, secs = dryrun._trace_cell(cfg, ShapeConfig("s", seq, batch, kind),
                                                meta_mesh(shape), DEFAULT_RULES(), variant)
    return dict(flops=census.flops, args=sharded_bytes(pairs), temp=census.peak_live_bytes,
                wire=census.wire_bytes, by_kind_bytes=dict(census.coll_by_kind_bytes),
                devices=sorted(census.devices), seconds=secs)


def ratio(a: float, b: float):
    """a / b; 1.0 when both are 0, None when only b is."""
    if b:
        return a / b
    return 1.0 if not a else None


def compare(port: dict, jax: dict) -> dict:
    """Port against JAX: FLOPs and argument bytes as differences, the
    rest as ratios (all-gather, wire, temp)."""
    return dict(
        flops_diff=port["flops"] - jax["flops"], flops_ratio=ratio(port["flops"], jax["flops"]),
        args_diff=port["args"] - jax["args"],
        allgather=ratio(port["by_kind_bytes"].get("allgather", 0.0),
                        jax["by_kind_bytes"].get(KINDS["allgather"], 0.0)),
        wire=ratio(port["wire"], jax["wire"]), temp=ratio(port["temp"], jax["temp"]))


def _parse(spec: str):
    arch, kind, *flags = spec.split(":")
    variant = {}
    for f in filter(None, ",".join(flags).split(",")):
        key, _, value = f.partition("=")
        variant[key] = json.loads(value) if value else True
    return arch, kind, variant


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+", help="arch:kind[:variant flag or key=value,...]")
    ap.add_argument("--mesh", default="2x4", help="data x model (at most 8 devices)")
    ap.add_argument("--full", action="store_true", help="the full config, not `reduced`")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hlo", metavar="DIR", help="write each compiled program's HLO text here")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    cells = [(a, not args.full, k, v) for a, k, v in map(_parse, args.cells)]
    if args.hlo:
        os.makedirs(args.hlo, exist_ok=True)
    proc = start_jax(cells, shape, args.seq, args.batch, hlo_dir=args.hlo)
    ports = [port_cell(*c, shape=shape, seq=args.seq, batch=args.batch) for c in cells]
    jaxs = collect(proc)
    fmt = lambda x: "-" if x is None else f"{x:.6f}"  # noqa: E731
    for (arch, _, kind, variant), p, j in zip(cells, ports, jaxs):
        c = compare(p, j)
        print(f"{arch} {kind} {variant or ''} on {args.mesh}: FLOPs port {p['flops']:,.0f} "
              f"JAX {j['flops']:,.0f} (port - JAX {c['flops_diff']:+,.0f}, ratio "
              f"{fmt(c['flops_ratio'])}); args port - JAX {c['args_diff']:+,}; port / JAX: "
              f"all-gather {fmt(c['allgather'])} ({p['by_kind_bytes'].get('allgather', 0):,.0f} "
              f"/ {j['by_kind_bytes'].get('all-gather', 0):,.0f}), wire {fmt(c['wire'])}, "
              f"temp {fmt(c['temp'])}; traced in {p['seconds']:.2f} s, compiled in "
              f"{j['seconds']:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"({time.perf_counter() - t0:.1f} s)")
    raise SystemExit(rc)
