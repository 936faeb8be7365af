"""The plain reference that decides ``correct``: float64 PyTorch on the
benchmark's own operator data (the band its generator makes from the
seed), never on anything the program made. Imports nothing of the program.

For each answer x to a right side b it works out, in float64, the true
preconditioned residual ``||D^-1 (b - A x)||`` (D = diag A, the Jacobi
preconditioner the solves use, whose norm their stopping test reads) and
sets it against ``||D^-1 b||``. Its readings:

* ``true_resid``: the worst true relative residual;
* ``resid_gap``: the worst distance between it and the residual the
  program reported with the answer (relative to ``||D^-1 b||`` too), so
  an answer that says it converged must have;
* ``unconverged``: answers not reported converged (exact: limit 0),
  and ``unanswered``: requests due in the window that never came back.

A configuration's ``limits`` name the numbers its cells compare.
"""
from __future__ import annotations

import math

import torch

__all__ = ["band_matvec", "ReferenceOperator"]


def band_matvec(offsets, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_j data[j, i] * x[i + offsets[j]], columns outside [0, n) skipped."""
    n = data.shape[1]
    y = torch.zeros(n, dtype=data.dtype, device=data.device)
    for j, o in enumerate(offsets):
        if o >= 0:
            y[: n - o] += data[j, : n - o] * x[o:]
        else:
            y[-o:] += data[j, -o:] * x[: n + o]
    return y


class ReferenceOperator:
    """The operator in float64, regenerated from the configuration and seed."""

    def __init__(self, offsets, data: torch.Tensor):
        self.offsets = tuple(int(o) for o in offsets)
        self.data = data.to(torch.float64)
        self.inv_diag = 1.0 / self.data[self.offsets.index(0)]

    def judge(self, b: torch.Tensor, x: torch.Tensor, reported_norm: float) -> dict:
        """(true relative residual, its gap to the reported one) of one answer."""
        b64 = b.to(torch.float64)
        r = b64 - band_matvec(self.offsets, self.data, x.to(torch.float64))
        u0 = float(torch.linalg.vector_norm(self.inv_diag * b64))
        true = float(torch.linalg.vector_norm(self.inv_diag * r)) / u0
        claimed = float(reported_norm) / u0
        if not math.isfinite(true) or not math.isfinite(claimed):
            return {"true_resid": math.inf, "resid_gap": math.inf}
        return {"true_resid": true, "resid_gap": abs(true - claimed)}
