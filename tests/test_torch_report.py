"""The port's telemetry against the JAX package's: ``SolveReport`` of the
same solve on the CPU, the structural bytes model, convergence curves,
the environment fingerprint and ``comparable_env``, ``plan.last_report``
(set only with observability on) and the plan's solve metrics.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.obs as jobs
import repro_torch
import repro_torch.obs as obs
from repro_torch.launch.roofline import HW, roofline_terms
from torch_parity import operator, rhs


@pytest.fixture(autouse=True)
def _obs_clean():
    for o in (obs, jobs):
        o.disable()
        o.reset_metrics()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset_metrics()


def _pair_solves(method="pipecg", **kw):
    J, A = operator(7)
    b = rhs(J, "smooth")
    jp = repro.plan(J, method=method, M="jacobi", atol=1e-6, maxiter=300, **kw)
    tp = repro_torch.plan(A, method=method, M="jacobi", atol=1e-6, maxiter=300, **kw)
    return jp, tp, jnp.asarray(b), torch.from_numpy(b)


def test_solve_report_matches_jax():
    obs.enable()
    jobs.enable()
    jp, tp, jb, tb = _pair_solves()
    jp.solve(jb)
    tp.solve(tb)
    assert tp.last_report.cold_start and tp.last_report.time_per_iter_s is None
    jp.solve(2.0 * jb)
    tp.solve(2.0 * tb)
    j, t = jp.last_report, tp.last_report
    assert not t.cold_start and t.time_s > 0 and t.time_per_iter_s > 0
    for k in ("method", "engine", "operator", "n", "dtype", "distributed", "iterations",
              "converged", "replace_every", "rr_events", "trace_count"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.core == "torch" and j.core == "jnp"  # the same core under each package's name
    assert t.est_bytes_per_iter == j.est_bytes_per_iter
    np.testing.assert_allclose(t.curve, j.curve, rtol=1e-4, atol=1e-6 * j.curve[0])
    np.testing.assert_allclose(t.residual_norm, j.residual_norm, rtol=1e-4,
                               atol=1e-6 * j.curve[0])
    # a plan on the CPU launches no hand-written kernel; no HBM figure from a CPU run
    assert t.launches_per_iter == 0
    assert t.achieved_gbs is None and t.frac_of_hbm_peak is None
    d = json.loads(t.to_json())
    assert set(d) == set(j.to_dict())
    assert len(d["curve"]) == t.iterations + 1
    s = t.summary()
    assert "launches" in s and "env" in s and f"{t.iterations} iters" in s


def test_last_report_only_with_obs_enabled():
    _, tp, _, tb = _pair_solves()
    tp.solve(tb)
    tp.solve_batched(torch.stack([tb, tb]))
    assert tp.last_report is None
    assert all(m.get("value", 0) == 0 and m.get("count", 0) == 0
               for m in obs.snapshot().values())
    obs.enable()
    tp.solve(tb)
    assert tp.last_report is not None and tp.last_report.iterations > 0


def test_plan_metrics_recorded():
    obs.enable()
    _, tp, _, tb = _pair_solves()
    tp.solve(tb)
    tp.solve(tb)
    snap = obs.snapshot()
    assert snap["plan.solves"]["value"] == 2
    assert snap["plan.cold_solves"]["value"] == 1
    assert snap["plan.solve_time_s"]["count"] == 1
    assert snap["plan.cold_solve_time_s"]["count"] == 1
    assert snap["plan.solve_iterations"]["count"] == 2
    tp.solve_batched(torch.stack([tb, 1e-8 * tb]))
    snap = obs.snapshot()
    assert snap["plan.batched_solves"]["value"] == 1
    assert snap["plan.batched_rhs"]["value"] == 2


def test_batched_report_uses_worst_lane():
    obs.enable()
    _, tp, _, tb = _pair_solves()
    res = tp.solve_batched(torch.stack([tb, 1e-8 * tb]))
    iters = obs.iterations_from_history(res.history)
    assert tp.last_report.iterations == int(iters.max())
    assert len(tp.last_report.curve) == int(iters.max()) + 1


def test_rr_events_match_jax():
    obs.enable()
    jobs.enable()
    jp, tp, jb, tb = _pair_solves(replace_every=5)
    jp.solve(jb)
    tp.solve(tb)
    j, t = jp.last_report, tp.last_report
    assert t.replace_every == j.replace_every == 5
    assert t.rr_events == j.rr_events == t.iterations // 5


def test_distributed_report():
    obs.enable()
    J, A = operator(7)
    tb = torch.from_numpy(rhs(J, "smooth"))
    p = repro_torch.plan(A, method="h3", shards=2, devices=("cpu", "cpu"), atol=1e-6)
    p.solve(tb)
    rep = p.last_report
    assert rep.distributed and rep.method == "h3" and rep.core is None
    assert rep.converged and rep.launches_per_iter == 0


def test_convergence_curve_matches_jax():
    h = np.array([1.0, 0.5, 0.25, np.nan, np.nan], np.float32)
    full = np.array([1.0, 0.5, 0.25], np.float32)
    batch = np.stack([h, np.array([1.0, 0.1, np.nan, np.nan, np.nan], np.float32)])
    for a in (h, full, torch.from_numpy(h)):
        np.testing.assert_array_equal(obs.convergence_curve(a),
                                      jobs.convergence_curve(np.asarray(a)))
    for ours, theirs in zip(obs.convergence_curve(batch), jobs.convergence_curve(batch)):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(obs.iterations_from_history(batch),
                                  jobs.iterations_from_history(batch))
    with pytest.raises(ValueError, match="1-D or 2-D"):
        obs.convergence_curve(np.zeros((2, 2, 2)))


def test_structural_bytes_match_jax():
    for ours, theirs in (("torch", "jnp"), ("cuda", "pallas"), ("fused_iter", "fused_iter")):
        for nd, eb in ((27, 4), (125, 4), (125, 2)):
            assert (obs.structural_bytes_per_elem(ours, nd, eb)
                    == jobs.structural_bytes_per_elem(theirs, nd, eb))
            assert obs.structural_bytes_per_elem(theirs, nd, eb) == \
                jobs.structural_bytes_per_elem(theirs, nd, eb)
    assert obs.structural_bytes_per_elem("not-a-core", 27) is None


def test_env_fingerprint_and_comparable_env():
    e = obs.env_fingerprint()
    assert e["torch_version"] == torch.__version__ and e["cuda_version"] == torch.version.cuda
    assert e["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert obs.comparable_env(e, dict(e))
    for key, other in (("device_kind", "NVIDIA H100 80GB HBM3"), ("power_limit", "350.00 W"),
                       ("torch_version", "0.0"), ("cuda_version", "11.0"), ("backend", "tpu")):
        assert not obs.comparable_env(e, dict(e, **{key: other})), key
    # a record of the JAX package names another stack: never comparable
    assert not obs.comparable_env(e, jobs.env_fingerprint())


def test_roofline_terms_on_the_h100_table():
    assert HW["hbm_bw"] == 3.35e12 and HW["peak_flops"] == 989e12
    t = roofline_terms(989e12, 3.35e12 * 2, 0.0)
    assert t["dominant"] == "memory" and t["bound_s"] == pytest.approx(2.0)
    assert t["compute_s"] == pytest.approx(1.0) and t["collective_s"] == 0.0
