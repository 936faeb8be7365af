"""Times the DIA lane kernels on the card: ``python -m repro_torch.launch.bench_lanes``

The lane rows of ``chip_smoke.py`` (phase 6a) at ``poisson125(128)``, alone
and with quartiles, so two trees can be compared on one card: copy this file
to the other tree's ``repro_torch/launch/`` and run it there too, alternating
the trees (it uses only the sparse generators and four kernel wrappers, whose
signatures both trees share). Rows, each the median and quartiles over
``--repeats`` timings of the mean ms of 10 calls (CUDA events), beside the
bytes bound at 3.35 TB/s and its share of the time:

- ``fused_iter`` with a bf16 band (``fused_iter_bf16band_f32``) at k = 1,
  2, 4, 8, and with an f32 band at k = 1 and 8;
- ``spmv_dia_batched`` in f32 and bf16 at k = 8.

``bits`` holds a SHA-256 of the outputs of one call of each ``fused_iter``
row on seeded inputs: two trees whose hashes agree computed the same bits.

Prints the card's name and power limit, then one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess

import torch

from ..kernels import fused_iter_batched, fused_iter_step, spmv_dia_batched, spmv_dia_batched_bf16
from ..sparse import poisson125

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def _per_call(fn, repeats: int, reps: int = 10):
    """Quartiles of the CUDA-event ms per call over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    q = statistics.quantiles(out, n=4)
    return {"median": statistics.median(out), "q1": q[0], "q3": q[2]}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--label", default="", help="a name for this run in the JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_lanes needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)
    dev = torch.device("cuda")
    A = poisson125(128, device=dev)
    A16 = A.with_dtype(torch.bfloat16)
    n, kd = A.n, A.n_diags
    inv = 1.0 / A.diagonal()
    gen = torch.Generator(device=dev)
    rows, bits = {}, {}

    def lanes(k, seed, scale=1.0):
        gen.manual_seed(seed)
        return torch.randn(k, n, generator=gen, device=dev) * scale

    def row(label, fn, nbytes):
        t = _per_call(fn, args.repeats)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[label] = dict(t, bound_ms=bound, share=bound / t["median"])

    for band, size, ks in ((A16.data, 2, (1, 2, 4, 8)), (A.data, 4, (1, 8))):
        name = "bf16 band" if size == 2 else "f32 band"
        for k in ks:
            # bits: one call on unit-scale inputs; times: small alpha, beta and
            # vectors, so repeated calls stay bounded
            vecs = [lanes(k, 100 + i) for i in range(9)]
            m_out = torch.empty_like(vecs[8])
            a = torch.linspace(0.2, 0.4, k, device=dev)
            b = torch.linspace(0.5, 0.7, k, device=dev)
            if k == 1:
                out = fused_iter_step(band, A.offsets, *[v[0] for v in vecs], m_out[0], inv, a[0],
                                      b[0])
            else:
                out = fused_iter_batched(band, A.offsets, *vecs[:8], vecs[8], m_out, inv, a, b)
            bits[f"fused_iter {name} k={k}"] = _digest(out)
            del vecs, out
            vt = [lanes(k, 200 + i, 1e-3) for i in range(9)]
            at = torch.full((k,), 1e-3, device=dev)
            if k == 1:
                v1 = [v[0] for v in vt]
                fn = lambda: fused_iter_step(band, A.offsets, *v1, m_out[0], inv, at[0], at[0])
            else:
                fn = lambda: fused_iter_batched(band, A.offsets, *vt, m_out, inv, at, at)
            row(f"fused_iter {name} k={k}", fn, kd * n * size + n * 4 + k * n * 72 + k * 21)
            del vt, m_out
    for label, op, fn, size in (("spmv_dia_batched f32", A, spmv_dia_batched, 4),
                                ("spmv_dia_batched bf16", A16, spmv_dia_batched_bf16, 2)):
        X = lanes(8, 300).to(op.dtype)
        row(f"{label} k=8", lambda: fn(op, X), kd * n * size + 8 * n * (size + 4))
        del X
    print(json.dumps({"label": args.label, "card": card, "torch": torch.__version__,
                      "repeats": args.repeats, "rows": rows, "bits": bits}))


if __name__ == "__main__":
    main()
