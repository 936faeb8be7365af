"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (one chip: no exchange between chips to drop).
The chip check is skipped: the cells run at tiny sizes on the CPU."""
import dataclasses

import pytest
import torch

from bench import _tiny

SOLVE = ["poisson125.solve"]
SERVE = ["poisson125.serve"]


def _unchanged_core(z, q, s, p, x, r, u, w, n, m, inv_diag, alpha, beta, active=None):
    from repro_torch.core.iteration import dot_f32

    return z, q, s, p, x, r, u, w, m, (dot_f32(r, u), dot_f32(w, u), dot_f32(u, u))


@pytest.mark.parametrize("workload", SOLVE + SERVE)
def test_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from repro_torch.core import iteration

    monkeypatch.setitem(iteration._CORES, "torch", _unchanged_core)
    ok, out = _tiny.run(workload, seconds=0.2)
    assert not ok and out["checks"]["unconverged"]["value"] > 0


@pytest.mark.parametrize("workload", SERVE)
def test_half_the_batch_left_out(workload, monkeypatch):
    from repro_torch.plan import SolverPlan

    solve_batched = SolverPlan.solve_batched

    def half(self, B, *a, **kw):
        res = solve_batched(self, B, *a, **kw)
        live = torch.nonzero(B.abs().sum(dim=1) > 0).flatten()  # not the bucket's padding
        kept, left_out = live[: (len(live) + 1) // 2], live[(len(live) + 1) // 2:]
        x = res.x.clone()
        x[left_out] = x[kept].mean(dim=0)  # the lanes left out get the mean of the rest
        return dataclasses.replace(res, x=x)

    monkeypatch.setattr(SolverPlan, "solve_batched", half)
    ok, out = _tiny.run(workload, rate_per_s=150.0)
    assert not ok and out["checks"]["true_resid"]["value"] > out["checks"]["true_resid"]["limit"]


@pytest.mark.parametrize("workload", SOLVE + SERVE)
def test_answer_altered_where_it_is_produced(workload, monkeypatch):
    from repro_torch.plan import SolverPlan

    def altered(fn):
        def wrapper(self, B, *a, **kw):
            res = fn(self, B, *a, **kw)
            return dataclasses.replace(res, x=res.x * torch.tensor(1.1, dtype=res.x.dtype))
        return wrapper

    monkeypatch.setattr(SolverPlan, "solve", altered(SolverPlan.solve))
    monkeypatch.setattr(SolverPlan, "solve_batched", altered(SolverPlan.solve_batched))
    ok, out = _tiny.run(workload)
    assert not ok and out["checks"]["true_resid"]["value"] > out["checks"]["true_resid"]["limit"]
