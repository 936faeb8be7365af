#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, TF32 off; the CUDA kernels are built from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a.
2. every kernel against its plain PyTorch version on the card, at the
   main path's shape (poisson125(128): N = 2,097,152, 125 diagonals) and
   at a ragged poisson27(37) (N = 50,653), padded and unpadded; kernel
   and plain-version times (median of CUDA-event timings), the bytes
   bound, and for spmv_dia a torch.sparse CSR matvec as a yardstick.
3. solves of poisson125(128) through ``repro_torch.plan(A,
   method="pipecg", engine=..., M="jacobi")`` with b = A (1/sqrt(N)),
   atol 0, rtol 1e-3, for engine auto (-> fused_iter), cuda and torch:
   equal iteration counts, histories within rtol 1e-3, true residual
   (float64, scipy) below 1e-2, and the launch counters of each path;
   one spmv_engine="bf16" run is reported, not asserted.
4. a fixed 200 iterations per engine, median of 5, ms per iteration.

The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

VEC = dict(rtol=1e-5, atol=1e-5)   # f32 vectors (tests/test_kernels.py)
DOT_RTOL = 1e-4                    # dots; atol 1e-6 * sum|a_i b_i| (f32 sums, another order)
BF16 = dict(rtol=2e-2, atol=1e-3)  # bf16 SPMV
SOLVE_RTOL = 1e-3                  # f32 Jacobi-PIPECG stalls near 1e-4 on poisson125
TIMED_ITERS = 200
REPLACES = {
    "spmv_dia": "src/repro/kernels/spmv_dia/kernel.py:37",
    "fused_vma": "src/repro/kernels/fused_vma/kernel.py:71",
    "fused_iter": "src/repro/kernels/fused_iter/kernel.py:95",
}
SOURCES = {
    "spmv_dia": "src/repro_torch/kernels/csrc/spmv_dia.cu",
    "fused_vma": "src/repro_torch/kernels/csrc/fused_vma.cu",
    "fused_iter": "src/repro_torch/kernels/csrc/fused_iter.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_rates(name: str):
    """(bytes/s, f32 flop/s) from the data sheets, by the card's name."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    if "H200" in name:
        return 4.8e12, 67e12
    return 3.35e12, 67e12  # H100 SXM


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's package is not at {SRC}/repro_torch")
    sys.path.insert(0, SRC)
    import numpy as np

    import repro_torch
    from repro_torch.kernels import (
        fused_iter_ref,
        fused_iter_step,
        fused_vma_dots,
        fused_vma_dots_ref,
        spmv_dia_cuda,
        spmv_dia_ref,
    )
    from repro_torch.kernels.common import BLOCK, build_info, ceil_to, library, pad1d
    from repro_torch.sparse import DIAMatrix, poisson27, poisson125, spmv

    dev = torch.device("cuda")
    record: dict = {}

    # ------------------------------------------------------------------ 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card line: {smi.stderr.strip()}")
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    library()
    info = build_info()
    log(f"kernel library: {info['path']} built in {info['seconds']:.1f} s (cached={info['cached']})")
    for line in info["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"  nvcc: {line.strip()}")
    bw_peak, f32_peak = peak_rates(name)
    record.update(card=card, device=name, torch=torch.__version__, cuda=torch.version.cuda,
                  build_seconds=info["seconds"], peak_bytes_per_s=bw_peak,
                  peak_f32_flops=f32_peak)

    def sync():
        torch.cuda.synchronize()

    def timed(fn, reps: int, repeats: int = 5) -> float:
        """Median over ``repeats`` of the mean ms of ``reps`` calls (CUDA events)."""
        fn()
        sync()
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
        return statistics.median(out)

    def check(label, got, want, rtol, atol) -> float:
        err = float((got.double() - want.double()).abs().max())
        if not torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol):
            fail(f"{label}: kernel and plain version disagree (max abs err {err:.3e})")
        return err

    def check_dots(label, got, want, scale) -> float:
        err = float((got.double() - want.double()).abs().max())
        if not torch.allclose(got.double(), want.double(), rtol=DOT_RTOL, atol=1e-6 * scale):
            fail(f"{label}: dots disagree: {got.tolist()} vs {want.tolist()}")
        return err

    # ------------------------------------------------------------------ 2
    t0 = time.perf_counter()
    A = poisson125(128, device=dev)
    log(f"poisson125(128): N={A.n} diagonals={A.n_diags} bandwidth={A.bandwidth} "
        f"built in {time.perf_counter() - t0:.1f} s")
    A27 = poisson27(37, device=dev)
    N = A.n
    k = A.n_diags
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(n):
        return torch.randn(n, generator=gen, device=dev)

    errs = {"spmv_dia": 0.0, "spmv_dia_bf16": 0.0, "fused_vma": 0.0, "fused_iter": 0.0}

    def operator_cases(Aop):
        """(label, operator, length) — as given, and padded to the block."""
        cases = [("", Aop, Aop.n)]
        n_pad = ceil_to(Aop.n, BLOCK)
        if n_pad != Aop.n:
            dp = torch.nn.functional.pad(Aop.data, (0, n_pad - Aop.n)).contiguous()
            cases.append(("padded", DIAMatrix(dp, Aop.offsets, n_pad), Aop.n))
        return cases

    for tag, Aop in (("poisson125(128)", A), ("poisson27(37)", A27)):
        for pad_tag, Ak, n_real in operator_cases(Aop):
            label = f"{tag}{' ' + pad_tag if pad_tag else ''}"
            n = Ak.n
            x = pad1d(randn(n_real), n)
            y = spmv_dia_cuda(Ak, x)
            errs["spmv_dia"] = max(errs["spmv_dia"], check(
                f"spmv_dia {label}", y, spmv_dia_ref(Ak.data, Ak.offsets, x), **VEC))
            A16, x16 = Ak.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
            y16 = spmv_dia_cuda(A16, x16, out_dtype=torch.float32)
            errs["spmv_dia_bf16"] = max(errs["spmv_dia_bf16"], check(
                f"spmv_dia bf16 {label}", y16,
                spmv_dia_ref(A16.data, Ak.offsets, x16, torch.float32), **BF16))

            vecs = [pad1d(randn(n_real), n) for _ in range(10)]
            inv = pad1d(1.0 / Ak.diagonal()[:n_real], n)
            want = fused_vma_dots_ref(*vecs, inv, 0.3, 0.6)
            got = fused_vma_dots(*[v.clone() for v in vecs], inv, 0.3, 0.6)
            for g, w in zip(got[:9], want[:9]):
                errs["fused_vma"] = max(errs["fused_vma"], check(f"fused_vma {label}", g, w, **VEC))
            scale = float(torch.stack([(want[5] * want[6]).abs().sum(),
                                       (want[7] * want[6]).abs().sum(),
                                       (want[6] * want[6]).sum()]).max())
            check_dots(f"fused_vma {label}", got[9], want[9], scale)

            vecs = vecs[:9]
            want = fused_iter_ref(Ak.data, Ak.offsets, *vecs, inv, 0.3, 0.6)
            m_out = torch.empty_like(vecs[8])
            got = fused_iter_step(Ak.data, Ak.offsets, *[v.clone() for v in vecs[:8]], vecs[8],
                                  m_out, inv, 0.3, 0.6)
            for g, w in zip(got[:9], want[:9]):
                errs["fused_iter"] = max(errs["fused_iter"], check(f"fused_iter {label}", g, w, **VEC))
            scale = float(torch.stack([(want[5] * want[6]).abs().sum(),
                                       (want[7] * want[6]).abs().sum(),
                                       (want[6] * want[6]).sum()]).max())
            check_dots(f"fused_iter {label}", got[9], torch.stack(list(want[9])), scale)
            if n != n_real:
                for out in (y, y16, *got[:9]):
                    if out[n_real:].any():
                        fail(f"{label}: the padded tail is not exactly 0")
            sync()
            log(f"kernels agree with their plain versions on {label} (N={n})")
    log("max abs err: " + json.dumps(errs))

    # kernel and plain-version times at the main path's shape
    x = randn(N)
    vecs = [randn(N) * 1e-3 for _ in range(10)]
    inv = 1.0 / A.diagonal()
    m_out = torch.empty_like(vecs[8])
    a_s = torch.tensor(1e-3, device=dev)
    b_s = torch.tensor(1e-3, device=dev)
    A16, x16 = A.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
    times = {
        "spmv_dia": (timed(lambda: spmv_dia_cuda(A, x), 20),
                     timed(lambda: spmv_dia_ref(A.data, A.offsets, x), 2, 3)),
        "spmv_dia_bf16": (timed(lambda: spmv_dia_cuda(A16, x16, out_dtype=torch.float32), 20),
                          timed(lambda: spmv_dia_ref(A16.data, A.offsets, x16, torch.float32), 2, 3)),
        "fused_vma": (timed(lambda: fused_vma_dots(*vecs, inv, a_s, b_s), 50),
                      timed(lambda: fused_vma_dots_ref(*vecs, inv, a_s, b_s), 5, 3)),
        "fused_iter": (timed(lambda: fused_iter_step(A.data, A.offsets, *vecs[:9], m_out, inv,
                                                     a_s, b_s), 20),
                       timed(lambda: fused_iter_ref(A.data, A.offsets, *vecs[:9], inv, a_s, b_s),
                             2, 3)),
    }
    del A16, x16

    # torch.sparse CSR matvec of the same operator: a yardstick the port never calls
    offs = torch.tensor(A.offsets, device=dev)
    cols = torch.arange(N, device=dev)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < N)
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow, cols[valid], A.data.t()[valid], size=(N, N),
                                  check_invariants=False)
    del cols, valid
    check("torch.sparse CSR yardstick", torch.mv(csr, x), spmv_dia_cuda(A, x), **VEC)
    library_ms = timed(lambda: torch.mv(csr, x), 20)
    nnz = csr.values().numel()
    del csr, crow
    torch.cuda.empty_cache()

    # least bytes each kernel must move at this shape (inputs read once,
    # outputs written once) and the f32 operations it does
    work = {
        "spmv_dia": (k * N * 4 + N * 4 + N * 4, 2 * k * N),
        "spmv_dia_bf16": (k * N * 2 + N * 2 + N * 4, 2 * k * N),
        "fused_vma": (11 * N * 4 + 9 * N * 4 + 8 + 12, 23 * N),
        "fused_iter": (k * N * 4 + 10 * N * 4 + 9 * N * 4 + 8 + 12, 2 * k * N + 23 * N),
    }
    bounds = {}
    for kname, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / bw_peak * 1e3, ops / f32_peak * 1e3
        bounds[kname] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        log(f"{kname}: {times[kname][0]:.4f} ms (bound {bounds[kname][0]:.4f} ms, "
            f"{nbytes / times[kname][0] / 1e6:.0f} GB/s), plain {times[kname][1]:.3f} ms")
    log(f"torch.sparse CSR matvec (nnz={nnz}): {library_ms:.4f} ms")

    # ------------------------------------------------------------------ 3
    import scipy.sparse as sp

    xstar = torch.full((N,), 1.0 / math.sqrt(N), device=dev)
    b = spmv(A, xstar)
    data64 = A.data.double().cpu().numpy()
    shifted = np.zeros_like(data64)  # scipy's DIA stores A[c - off, c] at column c
    for j, o in enumerate(A.offsets):
        if o >= 0:
            shifted[j, o:] = data64[j, : N - o]
        else:
            shifted[j, : N + o] = data64[j, -o:]
    A64 = sp.dia_matrix((shifted, np.asarray(A.offsets)), shape=(N, N))
    del data64, shifted
    b64 = A64 @ (np.ones(N) / math.sqrt(N))

    def true_residual(xs):
        r = b64 - A64 @ xs.double().cpu().numpy()
        return float(np.linalg.norm(r) / np.linalg.norm(b64))

    counters = {"spmv_dia": spmv_dia_cuda, "fused_vma": fused_vma_dots,
                "fused_iter": fused_iter_step}

    def drive(engine, **kw):
        p = repro_torch.plan(A, method="pipecg", engine=engine, M="jacobi", atol=0.0,
                             rtol=SOLVE_RTOL, maxiter=2000, **kw)
        for f in counters.values():
            f.launches = 0
        sync()
        t = time.perf_counter()
        res = p.solve(b)
        sync()
        wall = time.perf_counter() - t
        launches = {kn: f.launches for kn, f in counters.items()}
        out = dict(describe=p.describe(), iterations=int(res.iterations), steps=res.steps,
                   converged=bool(res.converged), residual_norm=float(res.residual_norm),
                   true_residual=true_residual(res.x), wall_s=wall, launches=launches,
                   history=res.history[: int(res.iterations) + 1].cpu().numpy())
        log(f"solve engine={engine} {kw or ''}: core={out['describe']['core']} "
            f"iterations={out['iterations']} steps={out['steps']} "
            f"(no-op steps {out['steps'] - out['iterations']}) converged={out['converged']} "
            f"true_rel_residual={out['true_residual']:.3e} wall={wall:.3f} s launches={launches}")
        return out

    runs = {e: drive(e) for e in ("auto", "cuda", "torch")}
    auto, cuda_run, plain = runs["auto"], runs["cuda"], runs["torch"]
    if auto["describe"]["core"] != "fused_iter":
        fail(f"engine='auto' resolved to {auto['describe']['core']}, not fused_iter")
    for e, r in runs.items():
        if not r["converged"]:
            fail(f"engine={e} did not converge")
        if not r["true_residual"] < 1e-2:
            fail(f"engine={e} true residual {r['true_residual']:.3e} >= 1e-2")
        if r["describe"]["replace_every"] != 0:
            fail(f"engine={e} ran residual replacement")
    its = {e: r["iterations"] for e, r in runs.items()}
    if len(set(its.values())) != 1:
        fail(f"iteration counts differ: {its}")
    h0 = plain["history"][0]
    for e in ("auto", "cuda"):
        if not np.allclose(runs[e]["history"], plain["history"], rtol=1e-3, atol=1e-5 * h0):
            fail(f"history of engine={e} differs from engine=torch")
    want = {"auto": {"spmv_dia": 2, "fused_vma": 0, "fused_iter": auto["steps"]},
            "cuda": {"spmv_dia": 3 + cuda_run["steps"], "fused_vma": cuda_run["steps"],
                     "fused_iter": 0},
            "torch": {"spmv_dia": 0, "fused_vma": 0, "fused_iter": 0}}
    for e, r in runs.items():
        if r["launches"] != want[e]:
            fail(f"engine={e}: launches {r['launches']} != expected {want[e]}")
    bf16 = drive("cuda", spmv_engine="bf16")
    log(f"bf16 SPMV run (replace_every={bf16['describe']['replace_every']}): "
        f"converged={bf16['converged']} true_rel_residual={bf16['true_residual']:.3e}")
    if bf16["launches"]["spmv_dia"] == 0:
        fail("the bf16 run launched no spmv_dia kernel")

    # ------------------------------------------------------------------ 4
    per_iter = {}
    for label, engine, kw in (("auto", "auto", {}), ("cuda", "cuda", {}),
                              ("cuda+bf16", "cuda", {"spmv_engine": "bf16"}),
                              ("torch", "torch", {})):
        p = repro_torch.plan(A, method="pipecg", engine=engine, M="jacobi", atol=0.0, rtol=0.0,
                             maxiter=TIMED_ITERS, **kw)
        res = p.solve(b)
        if int(res.iterations) != TIMED_ITERS:
            fail(f"fixed-count run of {label} ran {int(res.iterations)} iterations")
        ms = timed(lambda: p.solve(b), 1) / TIMED_ITERS
        per_iter[label] = ms
        log(f"engine={label}: {ms:.4f} ms per iteration ({TIMED_ITERS} iterations, median of 5)")

    # ------------------------------------------------------------------ 5
    kernels = []
    for kname in ("spmv_dia", "spmv_dia_bf16", "fused_vma", "fused_iter"):
        base = "spmv_dia" if kname.startswith("spmv_dia") else kname
        path = {"spmv_dia": "auto", "spmv_dia_bf16": "cuda+bf16", "fused_vma": "cuda",
                "fused_iter": "auto"}[kname]
        launches = (bf16 if path == "cuda+bf16" else runs[path])["launches"][base]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[base], "replaces": REPLACES[base],
            "path": path, "launches": launches, "max_abs_err": errs[kname],
            "ms": times[kname][0], "plain_ms": times[kname][1], "bound_ms": bounds[kname][0],
            "bound_by": bounds[kname][1], "library_ms": library_ms if kname == "spmv_dia" else None,
        })
    summary = {
        "solves": {e: {kk: v for kk, v in r.items() if kk != "history"}
                   for e, r in {**runs, "cuda+bf16": bf16}.items()},
        "ms_per_iteration": per_iter, "kernels": kernels, **record,
    }
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
