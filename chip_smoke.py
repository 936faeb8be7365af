#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, TF32 off; the CUDA kernels are built from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a.
2. the DIA kernels against their plain PyTorch versions on the card, at
   the DIA path's shape (poisson125(128): N = 2,097,152, 125 diagonals)
   and at a ragged poisson27(37) (N = 50,653), padded and unpadded;
   kernel and plain-version times (median of CUDA-event timings), the
   bytes bound, and for spmv_dia a torch.sparse CSR matvec as a yardstick.
2b. the general-sparsity kernels: spmv_bell (f32 and bf16) at
   Queen_4147's Block-ELLPACK form (N = 4,147,110, R = 79, above the TPU
   kernel's 2M-row limit) and at the ragged bcsstk15 (N = 3,948), and
   fused_dots at N = 4,147,110 and 3,948 (f32 and bf16), against their
   plain versions; times, bounds, and yardsticks the port never calls
   (torch.mv on a torch.sparse CSR tensor, f32 and, where PyTorch takes
   it, bf16; three torch.dot calls).
3. solves of poisson125(128) through ``repro_torch.plan(A,
   method="pipecg", engine=..., M="jacobi")`` with b = A (1/sqrt(N)),
   atol 0, rtol 1e-3, for engine auto (-> fused_iter), cuda and torch:
   equal iteration counts, histories within rtol 1e-3, true residual
   (float64, scipy) below 1e-2, and the launch counters of each path;
   one spmv_engine="bf16" run is reported, not asserted.
3b. solves of Queen_4147 (b = A (1/sqrt(N)), atol 0, rtol 1e-3): pipecg
   on the Bell form (auto -> cuda core + spmv_bell, and torch), the CSR
   form (auto -> segsum) and the DIA form (auto -> fused_iter), pcg and
   chronopoulos on the Bell form: one pipecg iteration count, histories
   within rtol 1e-3, the baselines within 2 iterations of it, every true
   residual below 1e-2, the launch counters of each path. A bf16 pcg
   solve of the Bell form is reported, not asserted.
4. a fixed 200 iterations per engine on poisson125(128), median of 5, ms
   per iteration.
4b. the same on Queen_4147 for Bell auto, CSR auto, DIA auto, pcg and
   chronopoulos, at the largest count up to 200 that every one of them
   completes (the f32 residual may reach its floor and stop a run early),
   and the marginal ms per iteration of that count's second half; then
   ms per solve to rtol 1e-3 on each path, median of 5.

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
BF16_DOT_RTOL = 1e-3               # f32 sums of the same (exact) bf16 products
SOLVE_RTOL = 1e-3                  # f32 Jacobi-PIPECG stalls near 1e-4 on poisson125
TIMED_ITERS = 200
BASELINE_BAND = 2                  # pcg/chronopoulos vs pipecg iterations (tests/test_solvers.py)
REPLACES = {
    "spmv_dia": "src/repro/kernels/spmv_dia/kernel.py:37",
    "fused_vma": "src/repro/kernels/fused_vma/kernel.py:71",
    "fused_iter": "src/repro/kernels/fused_iter/kernel.py:95",
    "spmv_bell": "src/repro/kernels/spmv_bell/kernel.py:30",
    "fused_dots": "src/repro/kernels/fused_dot/kernel.py:27",
}
SOURCES = {
    "spmv_dia": "src/repro_torch/kernels/csrc/spmv_dia.cu",
    "fused_vma": "src/repro_torch/kernels/csrc/fused_vma.cu",
    "fused_iter": "src/repro_torch/kernels/csrc/fused_iter.cu",
    "spmv_bell": "src/repro_torch/kernels/csrc/spmv_bell.cu",
    "fused_dots": "src/repro_torch/kernels/csrc/fused_dot.cu",
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
        fused_dots,
        fused_dots_ref,
        fused_iter_ref,
        fused_iter_step,
        fused_vma_dots,
        fused_vma_dots_ref,
        spmv_bell_cuda,
        spmv_bell_ref,
        spmv_dia_cuda,
        spmv_dia_ref,
    )
    from repro_torch.kernels.common import BLOCK, build_info, ceil_to, library, pad1d
    from repro_torch.sparse import (
        DIAMatrix,
        bell_from_csr,
        csr_device_from_host,
        csr_from_dia,
        poisson27,
        poisson125,
        spmv,
        table1_matrix,
    )

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
    library = {"spmv_dia": timed(lambda: torch.mv(csr, x), 20)}
    nnz = csr.values().numel()
    del csr, crow
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 2b
    t0 = time.perf_counter()
    Q = table1_matrix("Queen_4147", device=dev)
    t_gen = time.perf_counter() - t0
    qcsr = csr_from_dia(Q)
    QB = bell_from_csr(qcsr, device=dev)
    QC = csr_device_from_host(qcsr, device=dev)
    sync()
    QN, R = QB.n, QB.slots_per_row
    log(f"Queen_4147: N={QN} diagonals={Q.n_diags} bandwidth={Q.bandwidth} nnz={qcsr.nnz} "
        f"R={R}; generated in {t_gen:.1f} s, converted (CSR, Bell, device CSR) in "
        f"{time.perf_counter() - t0 - t_gen:.1f} s")
    if QN <= 2 * 1024 * 1024 or qcsr.nnz != Q.nnz():
        fail(f"Queen_4147 is not the full operator (N={QN}, nnz={qcsr.nnz})")
    BK = bell_from_csr(csr_from_dia(table1_matrix("bcsstk15", device=dev)), device=dev)
    errs.update(spmv_bell=0.0, spmv_bell_bf16=0.0, fused_dots=0.0)
    for label, B in (("Queen_4147", QB), ("bcsstk15", BK)):
        x = randn(B.n)
        before = spmv_bell_cuda.launches
        y = spmv_bell_cuda(B, x)
        errs["spmv_bell"] = max(errs["spmv_bell"], check(
            f"spmv_bell {label}", y, spmv_bell_ref(B.cols, B.vals, x), **VEC))
        B16, x16 = B.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
        y16 = spmv_bell_cuda(B16, x16)
        errs["spmv_bell_bf16"] = max(errs["spmv_bell_bf16"], check(
            f"spmv_bell bf16 {label}", y16, spmv_bell_ref(B16.cols, B16.vals, x16), **BF16))
        sync()
        if spmv_bell_cuda.launches != before + 2:
            fail(f"spmv_bell {label}: {spmv_bell_cuda.launches - before} launches, not 2")
        log(f"spmv_bell (f32, bf16) agrees with its plain version on {label} "
            f"(N={B.n}, R={B.slots_per_row}) and launched there")
        del B16, x16
    for n in (QN, BK.n):
        r, u, w = randn(n), randn(n), randn(n)
        before = fused_dots.launches
        got = fused_dots(r, u, w)
        scale = float(torch.stack([(r * u).abs().sum(), (w * u).abs().sum(), (u * u).sum()]).max())
        errs["fused_dots"] = max(errs["fused_dots"], check_dots(
            f"fused_dots N={n}", got, fused_dots_ref(r, u, w), scale))
        h = [v.to(torch.bfloat16) for v in (r, u, w)]
        got16, want16 = fused_dots(*h), fused_dots_ref(*h)
        if not torch.allclose(got16.double(), want16.double(), rtol=BF16_DOT_RTOL,
                              atol=1e-6 * scale):
            fail(f"fused_dots bf16 N={n}: {got16.tolist()} vs {want16.tolist()}")
        sync()
        if fused_dots.launches != before + 2:
            fail(f"fused_dots N={n}: {fused_dots.launches - before} launches, not 2")
        log(f"fused_dots (f32, bf16) agrees with its plain version at N={n}")
    del BK
    log("max abs err: " + json.dumps(errs))

    # kernel and plain-version times at Queen_4147's shape
    x = randn(QN)
    QB16, xq16 = QB.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
    r, u, w = randn(QN), randn(QN), randn(QN)
    times.update({
        "spmv_bell": (timed(lambda: spmv_bell_cuda(QB, x), 20),
                      timed(lambda: spmv_bell_ref(QB.cols, QB.vals, x), 2, 3)),
        "spmv_bell_bf16": (timed(lambda: spmv_bell_cuda(QB16, xq16), 20),
                           timed(lambda: spmv_bell_ref(QB16.cols, QB16.vals, xq16), 2, 3)),
        "fused_dots": (timed(lambda: fused_dots(r, u, w), 50),
                       timed(lambda: fused_dots_ref(r, u, w), 5, 3)),
    })
    queen_dia_ms = timed(lambda: spmv_dia_cuda(Q, x), 20)
    # yardsticks the port never calls: cuSPARSE through torch.mv on the same
    # operator; no single PyTorch call computes the three dots
    qcsr_t = torch.sparse_csr_tensor(
        torch.from_numpy(qcsr.indptr).to(dev), torch.from_numpy(qcsr.indices).to(dev),
        torch.from_numpy(qcsr.data).to(dev), size=(QN, QN), check_invariants=False)
    check("torch.sparse CSR yardstick (Queen_4147)", torch.mv(qcsr_t, x), spmv_bell_cuda(QB, x),
          **VEC)
    library["spmv_bell"] = timed(lambda: torch.mv(qcsr_t, x), 20)
    # the same yardstick in bf16, where this PyTorch build takes it
    qcsr_t16 = torch.sparse_csr_tensor(qcsr_t.crow_indices(), qcsr_t.col_indices(),
                                       qcsr_t.values().to(torch.bfloat16), size=(QN, QN),
                                       check_invariants=False)
    del qcsr_t
    try:
        y_lib16 = torch.mv(qcsr_t16, xq16)
        sync()
    except (RuntimeError, NotImplementedError) as exc:  # no bf16 sparse matvec here
        record["library_bf16_refused"] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
        log(f"torch.mv on a bf16 sparse CSR tensor: refused ({record['library_bf16_refused']})")
    else:
        # a yardstick only: its accumulation order and type are cuSPARSE's,
        # so it may differ from the kernel by a bf16 rounding step of y
        y16 = spmv_bell_cuda(QB16, xq16).double()
        record["library_bf16_max_abs_err"] = float((y_lib16.double() - y16).abs().max())
        record["library_bf16_max_abs_y"] = float(y16.abs().max())
        library["spmv_bell_bf16"] = timed(lambda: torch.mv(qcsr_t16, xq16), 20)
        log(f"torch.mv on a bf16 sparse CSR tensor: {library['spmv_bell_bf16']:.4f} ms, max abs "
            f"diff from spmv_bell bf16 {record['library_bf16_max_abs_err']:.3e} "
            f"(max |y| {record['library_bf16_max_abs_y']:.3e})")
        del y16
        del y_lib16
    three_dots_ms = timed(lambda: (torch.dot(r, u), torch.dot(w, u), torch.dot(u, u)), 50)
    del qcsr_t16, QB16, xq16, r, u, w
    torch.cuda.empty_cache()

    # least bytes each kernel must move at its shape (inputs read once,
    # outputs written once) and the f32 operations it does: the DIA
    # kernels at poisson125(128), the general-sparsity ones at Queen_4147
    work = {
        "spmv_dia": (k * N * 4 + N * 4 + N * 4, 2 * k * N),
        "spmv_dia_bf16": (k * N * 2 + N * 2 + N * 4, 2 * k * N),
        "fused_vma": (11 * N * 4 + 9 * N * 4 + 8 + 12, 23 * N),
        "fused_iter": (k * N * 4 + 10 * N * 4 + 9 * N * 4 + 8 + 12, 2 * k * N + 23 * N),
        "spmv_bell": (QN * R * (4 + 4) + QN * 4 + QN * 4, 2 * QN * R),
        "spmv_bell_bf16": (QN * R * (4 + 2) + QN * 2 + QN * 2, 2 * QN * R),
        "fused_dots": (3 * QN * 4 + 12, 6 * QN),
    }
    bounds = {}
    for kname, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / bw_peak * 1e3, ops / f32_peak * 1e3
        bounds[kname] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        log(f"{kname}: {times[kname][0]:.4f} ms (bound {bounds[kname][0]:.4f} ms, "
            f"{nbytes / times[kname][0] / 1e6:.0f} GB/s), plain {times[kname][1]:.3f} ms")
    log(f"torch.sparse CSR matvec (nnz={nnz}): {library['spmv_dia']:.4f} ms")
    log(f"Queen_4147: torch.sparse CSR matvec (nnz={qcsr.nnz}): {library['spmv_bell']:.4f} ms; "
        f"three torch.dot calls: {three_dots_ms:.4f} ms; spmv_dia on its DIA form: "
        f"{queen_dia_ms:.4f} ms (bound {(Q.n_diags * QN * 4 + 8 * QN) / bw_peak * 1e3:.4f} ms)")
    del qcsr

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

    def relative_residual(M64, rhs64):
        def fn(xs):
            r = rhs64 - M64 @ xs.double().cpu().numpy()
            return float(np.linalg.norm(r) / np.linalg.norm(rhs64))
        return fn

    true_residual = relative_residual(A64, b64)
    counters = {"spmv_dia": spmv_dia_cuda, "fused_vma": fused_vma_dots,
                "fused_iter": fused_iter_step, "spmv_bell": spmv_bell_cuda,
                "fused_dots": fused_dots}

    def drive(engine, op=None, rhs=None, resid=None, method="pipecg", maxiter=2000, **kw):
        """One solve through the plan API, counters set to 0 just before it."""
        op = A if op is None else op
        rhs = b if rhs is None else rhs
        resid = true_residual if resid is None else resid
        p = repro_torch.plan(op, method=method, engine=engine, M="jacobi", atol=0.0,
                             rtol=SOLVE_RTOL, maxiter=maxiter, **kw)
        for f in counters.values():
            f.launches = 0
        sync()
        t = time.perf_counter()
        res = p.solve(rhs)
        sync()
        wall = time.perf_counter() - t
        launches = {kn: f.launches for kn, f in counters.items()}
        out = dict(describe=p.describe(), iterations=int(res.iterations), steps=res.steps,
                   converged=bool(res.converged), residual_norm=float(res.residual_norm),
                   true_residual=resid(res.x), wall_s=wall, launches=launches,
                   history=res.history[: int(res.iterations) + 1].float().cpu().numpy())
        d = out["describe"]
        log(f"solve {method} {d['operator']} engine={engine} {kw or ''}: core={d.get('core')} "
            f"spmv={d['spmv']} iterations={out['iterations']} steps={out['steps']} "
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

    def expect(**nonzero):
        """Launch counts of one run: the given ones, 0 for every other kernel."""
        return {kn: nonzero.get(kn, 0) for kn in counters}

    want = {"auto": expect(spmv_dia=2, fused_iter=auto["steps"]),
            "cuda": expect(spmv_dia=3 + cuda_run["steps"], fused_vma=cuda_run["steps"]),
            "torch": expect()}
    for e, r in runs.items():
        if r["launches"] != want[e]:
            fail(f"engine={e}: launches {r['launches']} != expected {want[e]}")
    bf16 = drive("cuda", spmv_engine="bf16")
    log(f"bf16 SPMV run (replace_every={bf16['describe']['replace_every']}): "
        f"converged={bf16['converged']} true_rel_residual={bf16['true_residual']:.3e}")
    if bf16["launches"]["spmv_dia"] == 0:
        fail("the bf16 run launched no spmv_dia kernel")

    # ----------------------------------------------------------------- 3b
    q64 = Q.data.double().cpu().numpy()
    shifted = np.zeros_like(q64)
    for j, o in enumerate(Q.offsets):
        if o >= 0:
            shifted[j, o:] = q64[j, : QN - o]
        else:
            shifted[j, : QN + o] = q64[j, -o:]
    Q64 = sp.dia_matrix((shifted, np.asarray(Q.offsets)), shape=(QN, QN))
    del q64, shifted
    qb = spmv(Q, torch.full((QN,), 1.0 / math.sqrt(QN), device=dev))
    q_resid = relative_residual(Q64, Q64 @ (np.ones(QN) / math.sqrt(QN)))
    qkw = dict(rhs=qb, resid=q_resid)
    qruns = {
        "bell-auto": drive("auto", QB, **qkw),
        "bell-torch": drive("torch", QB, **qkw),
        "csr-auto": drive("auto", QC, **qkw),
        "dia-auto": drive("auto", Q, **qkw),
        "pcg": drive("auto", QB, method="pcg", **qkw),
        "chronopoulos": drive("auto", QB, method="chronopoulos", **qkw),
    }
    resolved = {label: (r["describe"].get("core"), r["describe"]["spmv"])
                for label, r in qruns.items()}
    want_resolved = {"bell-auto": ("cuda", "cuda"), "bell-torch": ("torch", "torch"),
                     "csr-auto": ("cuda", "segsum"), "dia-auto": ("fused_iter", "cuda"),
                     "pcg": (None, "cuda"), "chronopoulos": (None, "cuda")}
    if resolved != want_resolved:
        fail(f"Queen_4147 paths resolved to {resolved}, expected {want_resolved}")
    for label, r in qruns.items():
        if not r["converged"]:
            fail(f"Queen_4147 {label} did not converge")
        if not r["true_residual"] < 1e-2:
            fail(f"Queen_4147 {label}: true residual {r['true_residual']:.3e} >= 1e-2")
    pipe = ("bell-auto", "bell-torch", "csr-auto", "dia-auto")
    q_its = {label: qruns[label]["iterations"] for label in qruns}
    if len({q_its[label] for label in pipe}) != 1:
        fail(f"Queen_4147 pipecg iteration counts differ: {q_its}")
    q_it = q_its["bell-auto"]
    for label in ("pcg", "chronopoulos"):
        if abs(q_its[label] - q_it) > BASELINE_BAND:
            fail(f"Queen_4147 {label}: {q_its[label]} iterations, pipecg {q_it}")
    qh0 = qruns["bell-torch"]["history"][0]
    for label in pipe:
        if not np.allclose(qruns[label]["history"], qruns["bell-torch"]["history"], rtol=1e-3,
                           atol=1e-5 * qh0):
            fail(f"Queen_4147 history of {label} differs from bell-torch")
    st = {label: r["steps"] for label, r in qruns.items()}
    want = {"bell-auto": expect(spmv_bell=3 + st["bell-auto"], fused_vma=st["bell-auto"]),
            "bell-torch": expect(),
            "csr-auto": expect(fused_vma=st["csr-auto"]),
            "dia-auto": expect(spmv_dia=2, fused_iter=st["dia-auto"]),
            "pcg": expect(spmv_bell=1 + st["pcg"]),
            "chronopoulos": expect(spmv_bell=2 + st["chronopoulos"])}
    for label, r in qruns.items():
        if r["launches"] != want[label]:
            fail(f"Queen_4147 {label}: launches {r['launches']} != expected {want[label]}")
    log(f"Queen_4147 solves agree: pipecg {q_it} iterations on every form, "
        f"pcg {q_its['pcg']}, chronopoulos {q_its['chronopoulos']}")
    QB16 = QB.with_dtype(torch.bfloat16)
    qruns["pcg-bf16"] = drive("auto", QB16, method="pcg", maxiter=200, rhs=qb.to(torch.bfloat16),
                              resid=q_resid)
    log(f"bf16 pcg on the Bell form: converged={qruns['pcg-bf16']['converged']} "
        f"true_rel_residual={qruns['pcg-bf16']['true_residual']:.3e}")
    if qruns["pcg-bf16"]["launches"] != expect(spmv_bell=1 + qruns["pcg-bf16"]["steps"]):
        fail(f"bf16 pcg launches {qruns['pcg-bf16']['launches']}")
    del QB16

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

    # ----------------------------------------------------------------- 4b
    qcases = {"bell-auto": (QB, "pipecg"), "csr-auto": (QC, "pipecg"), "dia-auto": (Q, "pipecg"),
              "pcg": (QB, "pcg"), "chronopoulos": (QB, "chronopoulos")}

    def fixed_plan(label, count):
        op, method = qcases[label]
        return repro_torch.plan(op, method=method, engine="auto", M="jacobi", atol=0.0,
                                rtol=0.0, maxiter=count)

    completed = {label: int(fixed_plan(label, TIMED_ITERS).solve(qb).iterations)
                 for label in qcases}
    q_fixed = min(completed.values())
    log(f"Queen_4147 fixed-count runs completed {completed} of {TIMED_ITERS} iterations; "
        f"timing {q_fixed} on every path")
    if q_fixed < 2:
        fail("a Queen_4147 fixed-count run completed fewer than 2 iterations")
    # a short count amortizes set-up (1-3 SPMVs) over few iterations, so the
    # marginal time of the second half of the count is reported beside it
    q_half = q_fixed // 2
    q_per_iter, q_marginal = {}, {}
    for label in qcases:
        solve_ms = {}
        for count in (q_fixed, q_half):
            p = fixed_plan(label, count)
            if int(p.solve(qb).iterations) != count:
                fail(f"Queen_4147 fixed-count run of {label} did not repeat {count} iterations")
            solve_ms[count] = timed(lambda: p.solve(qb), 1)
        q_per_iter[label] = solve_ms[q_fixed] / q_fixed
        q_marginal[label] = (solve_ms[q_fixed] - solve_ms[q_half]) / (q_fixed - q_half)
        log(f"Queen_4147 {label}: {q_per_iter[label]:.4f} ms per iteration "
            f"({q_fixed} iterations, median of 5); marginal {q_marginal[label]:.4f} ms "
            f"(iterations {q_half + 1}-{q_fixed})")

    # what a user pays for one Queen_4147 solve to rtol 1e-3: the converged
    # iterations plus the no-op steps up to the host's poll
    q_solve_ms = {}
    for label, (op, method) in qcases.items():
        p = repro_torch.plan(op, method=method, engine="auto", M="jacobi", atol=0.0,
                             rtol=SOLVE_RTOL, maxiter=2000)
        q_solve_ms[label] = timed(lambda: p.solve(qb), 1)
        log(f"Queen_4147 {label}: {q_solve_ms[label]:.4f} ms per solve to rtol {SOLVE_RTOL} "
            f"({qruns[label]['iterations']} iterations, {qruns[label]['steps']} steps, "
            f"median of 5)")

    # ------------------------------------------------------------------ 5
    # the path whose run each kernel's launches are read from (None: the
    # kernel is on no solver path, in the JAX package either)
    paths = {"spmv_dia": ("poisson125 auto", runs["auto"]),
             "spmv_dia_bf16": ("poisson125 cuda+bf16", bf16),
             "fused_vma": ("poisson125 cuda", runs["cuda"]),
             "fused_iter": ("poisson125 auto", runs["auto"]),
             "spmv_bell": ("Queen_4147 bell-auto", qruns["bell-auto"]),
             "spmv_bell_bf16": ("Queen_4147 pcg-bf16", qruns["pcg-bf16"]),
             "fused_dots": (None, None)}
    kernels = []
    for kname, (path, run) in paths.items():
        base = kname.removesuffix("_bf16")
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[base], "replaces": REPLACES[base],
            "path": path, "launches": 0 if run is None else run["launches"][base],
            "max_abs_err": errs[kname], "ms": times[kname][0], "plain_ms": times[kname][1],
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
            "library_ms": library.get(kname),
        })
    summary = {
        "solves": {e: {kk: v for kk, v in r.items() if kk != "history"}
                   for e, r in {**runs, "cuda+bf16": bf16}.items()},
        "queen_solves": {e: {kk: v for kk, v in r.items() if kk != "history"}
                         for e, r in qruns.items()},
        "ms_per_iteration": per_iter, "queen_ms_per_iteration": q_per_iter,
        "queen_marginal_ms_per_iteration": q_marginal, "queen_solve_ms": q_solve_ms,
        "queen_fixed_iterations": q_fixed, "queen_completed": completed,
        "queen_dia_spmv_ms": queen_dia_ms, "three_torch_dots_ms": three_dots_ms,
        "kernels": kernels, **record,
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
