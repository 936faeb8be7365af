"""Process environment applied BEFORE importing torch.

The CUDA caching allocator reads ``PYTORCH_CUDA_ALLOC_CONF`` when it is
first used and the CUDA driver reads ``CUDA_MODULE_LOADING`` when the
context is made, so both must be in the environment before ``import
torch`` (to be safe about import order). This module therefore imports
nothing heavy (no torch, no numpy) and is safe to import first in any
entrypoint:

    from repro_torch.launch.env import apply_env
    apply_env()                   # BEFORE any torch import
    import torch

``apply_env`` is import-order safe and idempotent: it is a silent no-op
for every variable already set (an operator's explicit environment
always wins), and a no-op with a warning when torch was imported first
(setting the variables then may do nothing, which is worse than saying
so). ``launch/serve.py`` and ``launch/solve.py`` call it on startup.

LD_PRELOAD (tcmalloc) cannot take effect from inside a running process:
:func:`tcmalloc_note` returns the export line to put in a wrapper script
when a system tcmalloc exists and none is preloaded.
"""
from __future__ import annotations

import os
import sys
import warnings
from typing import Dict, Mapping, Optional

__all__ = ["apply_env", "tcmalloc_note", "DEFAULT_ENV", "TCMALLOC_PATHS"]

# variables applied when (and only when) absent
DEFAULT_ENV: Dict[str, str] = {
    # grow segments in place: a server's bucket sizes and a plan's padded
    # vectors come and go without fragmenting the caching allocator
    "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
    # load each kernel module at its first launch, not all at context creation
    "CUDA_MODULE_LOADING": "LAZY",
}

TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def tcmalloc_note(env: Mapping[str, str] = os.environ) -> Optional[str]:
    """The LD_PRELOAD line a launcher script should add, or None."""
    if env.get("LD_PRELOAD"):
        return None
    for path in TCMALLOC_PATHS:
        if os.path.exists(path):
            return f"export LD_PRELOAD={path}  # faster malloc (set before launch)"
    return None


def apply_env(extra: Optional[Mapping[str, str]] = None,
              env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Set the pre-torch environment; returns {var: value} actually set.

    ``extra`` adds variables beside :data:`DEFAULT_ENV` (applied on the
    same terms). Every variable already present in ``env`` is left
    untouched. If torch is already imported (and ``env`` is the real
    ``os.environ``), nothing is set and a warning explains why.
    """
    real = env is None
    if env is None:
        env = os.environ  # type: ignore[assignment]
    if real and "torch" in sys.modules:
        warnings.warn(
            "repro_torch.launch.env.apply_env() called after torch was imported: the "
            "allocator and CUDA settings may already be read, so nothing was changed. "
            "Call apply_env() before the first torch import.",
            stacklevel=2,
        )
        return {}
    applied: Dict[str, str] = {}
    for k, v in {**DEFAULT_ENV, **(extra or {})}.items():
        if k not in env:
            env[k] = v
            applied[k] = v
    return applied
