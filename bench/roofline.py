"""The yardstick of the kernels' share of their roofline: the least HBM
bytes a PIPECG step needs, and the H100's published peaks.

A step of Jacobi-PIPECG (Alg. 2, lines 10-22) must read the operator
once, the Jacobi inverse diagonal once, and the recurrence's nine
vectors z, q, s, p, x, r, u, w, m once each, and write those nine once
each; n = A m is consumed inside the step and need not reach HBM. That
count holds whichever kernels do the step, so it survives a PR that
fuses or renames kernels. A batched step reads the operator and the
diagonal once for all its lanes and the vectors once per live lane.
Each configuration's form (``forms/<form>.py``) gives the operator's
stored bytes.
"""
from __future__ import annotations

import subprocess
from collections import defaultdict

from bench import catalog

# NVIDIA H100 SXM5 80 GB data sheet (dense): 3.35 TB/s of HBM3, the
# figure repro_torch.launch.roofline's HW table holds; rated at 700 W
HBM_BYTES_PER_S = 3.35e12
VECTOR_BYTES = 4       # float32
STATE_VECTORS = 9      # z q s p x r u w m: each read and written once a step


def operator_shape(cfg: dict):
    op = catalog.module("operators", cfg["operator"])
    return op.rows(cfg), op.offsets(cfg)


def step_bytes(cfg: dict) -> tuple[int, int]:
    """(bytes read once a step: operator + inverse diagonal, bytes per live lane)."""
    n, offs = operator_shape(cfg)
    stored = catalog.module("forms", cfg["form"]).stored_bytes(offs, n)
    return stored + n * VECTOR_BYTES, 2 * STATE_VECTORS * n * VECTOR_BYTES


def solve_bytes(cfg: dict, iterations) -> int:
    """Least bytes of single solves' live steps (one lane each)."""
    shared, lane = step_bytes(cfg)
    return sum(int(i) for i in iterations) * (shared + lane)


def bucket_bytes(cfg: dict, buckets) -> int:
    """Least bytes of lane-batched buckets: ``buckets`` is an iterable of
    each bucket's per-request iteration counts. A bucket's step is live
    while any lane is; a lane's vectors move while it is live."""
    shared, lane = step_bytes(cfg)
    total = 0
    for iters in buckets:
        iters = [int(i) for i in iters]
        total += max(iters, default=0) * shared + sum(iters) * lane
    return total


def share(bytes_moved: int, device_s: float):
    """Percent of the HBM roofline, or None where nothing was measured."""
    if bytes_moved <= 0 or not device_s or device_s <= 0:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / device_s


def group_buckets(requests) -> list:
    """Per-request iteration counts grouped by the bucket that served them
    (requests of one bucket share its ``bucket`` key)."""
    groups = defaultdict(list)
    for r in requests:
        groups[r.bucket].append(r.iterations)
    return list(groups.values())


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them ('' if it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""
