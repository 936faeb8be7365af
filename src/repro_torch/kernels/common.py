"""Shared pieces of the port's kernels: padding helpers, the device rule,
and the build and loader of the hand-written CUDA library.

The CUDA sources under ``csrc/`` are compiled at first use with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, which
``ctypes`` loads (no PyTorch headers, so a build takes seconds). The
library is cached under ``build/kernels/`` of the checkout, keyed by a
hash of the sources and flags. Each ``csrc/*.cu`` is compiled to an
object in its own ``nvcc`` process, all started together, then linked.

The JAX package's jaxpr census has no counterpart here: each kernel
wrapper keeps a plain integer ``launches`` counter instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = [
    "BLOCK",
    "MAX_DIAGS",
    "ceil_to",
    "pad1d",
    "resolve_device",
    "library",
    "build_info",
    "stream_ptr",
    "check_vectors",
    "check_distinct",
    "device_scalar",
    "check_active",
]

BLOCK = 256       # threads per block of every kernel (csrc/common.cuh: REPRO_BLOCK)
MAX_DIAGS = 256   # diagonals a DIA kernel takes by value (csrc/common.cuh: REPRO_MAX_DIAGS)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None
_BUILD_INFO: dict = {}


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad1d(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor to length n_pad (the same tensor if no pad)."""
    n = x.shape[0]
    if n == n_pad:
        return x
    return torch.nn.functional.pad(x, (0, n_pad - n))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises RuntimeError when CUDA is asked for and not available; the
    port never moves to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_vectors(names, vecs, *, length: int, device: torch.device) -> None:
    """Every vector a kernel takes: 1-D float32, contiguous, on ``device``."""
    for name, v in zip(names, vecs):
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, expected {device}")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, got {v.dtype}")
        if v.dim() != 1 or v.shape[0] != length:
            raise ValueError(f"{name} must have shape ({length},), got {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_distinct(names, tensors) -> None:
    """The kernels take every vector ``__restrict__``: no two may share memory."""
    seen = {}
    for name, t in zip(names, tensors):
        ptr = t.data_ptr()
        if ptr in seen:
            raise ValueError(f"{name} and {seen[ptr]} share memory; the kernel needs distinct buffers")
        seen[ptr] = name


def device_scalar(v, device: torch.device) -> torch.Tensor:
    """alpha/beta as a float32 0-d tensor on ``device`` (read by pointer)."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    if t.dim() != 0:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t


def check_active(active, device: torch.device):
    """The device-side 'solve still running' flag: None or a 0-d bool tensor."""
    if active is None:
        return None
    if active.dtype != torch.bool or active.dim() != 0 or active.device != device:
        raise ValueError(f"active must be a 0-d bool tensor on {device}")
    return active


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")
    return found


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    key = h.hexdigest()[:16]
    out = BUILD_DIR / f"librepro_torch_{key}.so"
    log_path = BUILD_DIR / f"librepro_torch_{key}.log"
    if out.exists():
        _BUILD_INFO.update(path=str(out), seconds=0.0, cached=True,
                           log=log_path.read_text() if log_path.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{key}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            for other in procs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    log = "\n".join(logs)
    log_path.write_text(log)
    _BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, cached=False, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(_build()))
    return _LIB


def build_info() -> dict:
    """Path, build seconds, whether it was cached, and nvcc's output."""
    return dict(_BUILD_INFO)
