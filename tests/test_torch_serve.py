"""The port's serving tier (``repro_torch.serve``) on the CPU, beside the JAX package's.

Counterparts of ``tests/test_serve.py``: the queue's bucket-close policy
and backpressure, the router (decade tolerance buckets, content keys,
async builds, LRU eviction that skips pinned entries, one hash per
operator), warm-start manifests (a manifest the JAX package wrote lands
on the same pool key and the same ``describe()`` in the port),
``SolverServer`` end to end (answers equal to ``plan.solve``'s, two
runners per plan in steady state, graceful drain), ``CountingOperator``,
``SolverEngine``'s bucket metrics, the telemetry's disabled path, the
kernel library's locked first build, and the launchers. Served answers
are held to ``plan.solve`` of the same rhs at rtol 1e-4 / atol 1e-5 on x
(the same lanes, f32 sums of another batch size).
"""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.serve as jserve
import repro.sparse as jsp
import repro_torch
import repro_torch.obs as obs
from repro_torch import convert
from repro_torch.kernels import common
from repro_torch.plan import operator_fingerprint
from repro_torch.serve import (
    DeadlineExceeded,
    PlanPool,
    QueueFull,
    RequestQueue,
    ServerClosed,
    SolveRequest,
    SolverEngine,
    SolverServer,
    bucket_waste,
    load_manifest,
    pool_key,
    tolerance_bucket,
)
from repro_torch.serve.warmstart import _describe_stable
from repro_torch.sparse import CountingOperator, FunctionOperator, poisson27, spmv

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    obs.reset_metrics()
    yield
    obs.disable()
    obs.reset_metrics()


def _system(grid=5):
    A = poisson27(grid, **CPU)
    xstar = torch.ones(A.n) / A.n ** 0.5
    return A, xstar, spmv(A, xstar)


def _req(atol=1e-5, **kw):
    return SolveRequest(b=None, atol=atol, **kw)


# ---------------------------------------------------------------------------
# queue
# ---------------------------------------------------------------------------

def test_queue_closes_full_or_on_timeout_from_the_first_request():
    obs.enable()
    q = RequestQueue(max_depth=16)
    for _ in range(5):
        q.put(_req())
    assert len(q.next_batch(max_batch=4, max_wait=10.0)) == 4  # full: no wait
    t0 = time.monotonic()
    assert len(q.next_batch(max_batch=4, max_wait=0.05)) == 1  # timeout
    assert time.monotonic() - t0 < 1.0
    snap = obs.snapshot()
    assert snap["serve.queue.closed_full"]["value"] == 1.0
    assert snap["serve.queue.closed_timeout"]["value"] == 1.0


def test_queue_backpressure_deadlines_close_and_fail_all():
    obs.enable()
    q = RequestQueue(max_depth=2)
    q.put(_req())
    q.put(_req(deadline=time.monotonic() - 1.0))  # already expired
    with pytest.raises(QueueFull):
        q.put(_req())
    batch = q.next_batch(max_batch=4, max_wait=0.01)
    assert len(batch) == 1  # the expired one failed fast instead
    assert obs.snapshot()["serve.rejects.deadline"]["value"] == 1.0
    q.put(_req())
    q.close()
    with pytest.raises(ServerClosed):
        q.put(_req())
    assert len(q.next_batch(max_batch=4, max_wait=0.01)) == 1  # closed still drains
    assert q.next_batch(max_batch=4, max_wait=0.01) is None
    q2 = RequestQueue()
    reqs = [_req(), _req()]
    for r in reqs:
        q2.put(r)
    assert q2.fail_all(RuntimeError("build failed")) == 2
    with pytest.raises(RuntimeError):
        reqs[0].future.result(timeout=1.0)
    with pytest.raises(DeadlineExceeded):
        raise DeadlineExceeded("exported")


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def test_router_decades_async_build_and_pinned_lru():
    assert tolerance_bucket(3e-6) == pytest.approx(1e-6)
    assert tolerance_bucket(0.0) == 0.0 and tolerance_bucket(None) == 0.0
    cfg = dict(method="pipecg", engine="torch", M="jacobi", atol=3e-6, rtol=0.0, maxiter=100)
    assert pool_key("fp", cfg) == pool_key("fp", {**cfg, "atol": 8e-6})
    assert pool_key("fp", cfg) != pool_key("fp", {**cfg, "atol": 3e-5})
    assert pool_key("fp", cfg) == jserve.pool_key("fp", cfg)  # the JAX package's key
    obs.enable()
    A, _, b = _system(4)
    pool = PlanPool(max_plans=2)
    e1, created = pool.get_or_create(A, {**cfg, "atol": 1e-4})
    again, created2 = pool.get_or_create(A, {**cfg, "atol": 1e-4})
    assert created and again is e1 and not created2
    assert bool(e1.wait(timeout=60).solve(b).converged)
    e2, _ = pool.get_or_create(A, {**cfg, "atol": 1e-5})
    e2.wait(timeout=60)
    with e1.pinned():  # e1 is LRU but in flight: e2 goes instead
        e3, _ = pool.get_or_create(A, {**cfg, "atol": 1e-6})
        keys = [e.key for e in pool.entries()]
        assert e1.key in keys and e3.key in keys and e2.key not in keys
    bad, _ = pool.get_or_create(A, {**cfg, "method": "no-such-method"})
    with pytest.raises(ValueError):
        bad.wait(timeout=60)
    snap = obs.snapshot()
    assert snap["serve.router.hits"]["value"] == 1.0
    assert snap["serve.router.fingerprints"]["value"] == 1.0  # one hash for the operator


def test_operator_fingerprint_equals_jax():
    J = jsp.poisson27(6)
    A = convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, **CPU)
    assert operator_fingerprint(A) == repro.plan.operator_fingerprint(J)
    assert operator_fingerprint(poisson27(6, **CPU)) == operator_fingerprint(A)
    assert operator_fingerprint(poisson27(5, **CPU)) != operator_fingerprint(A)
    dense = np.random.default_rng(0).standard_normal((12, 12)).astype(np.float32)
    assert operator_fingerprint(torch.from_numpy(dense)) == \
        repro.plan.operator_fingerprint(jnp.asarray(dense))
    from repro_torch.sparse import bell_from_csr, csr_from_dia

    B1 = bell_from_csr(csr_from_dia(A), **CPU)
    B2 = bell_from_csr(csr_from_dia(poisson27(6, **CPU)), **CPU)
    assert operator_fingerprint(B1) == operator_fingerprint(B2) != operator_fingerprint(A)
    fop = FunctionOperator(fn=lambda x: 2 * x, n=8, **CPU)
    assert operator_fingerprint(fop).startswith("id:")
    assert operator_fingerprint(CountingOperator(A)).startswith("id:")


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

def test_jax_manifest_lands_on_the_same_pool_key(tmp_path):
    J = jsp.poisson27(6)
    jp = repro.plan(J, method="pipecg", engine="auto", M="jacobi", atol=1e-5, maxiter=100)
    path = str(tmp_path / "jax_plans.json")
    jdoc = jserve.save_manifest(path, [jp], serve={"max_batch": 3})
    (p, entry), = load_manifest(path, device="cpu", warm=True)[0]
    fp = entry["fingerprint"]
    assert operator_fingerprint(p.A) == fp == repro.plan.operator_fingerprint(J)
    assert pool_key(fp, p.config()) == jserve.pool_key(fp, jp.config())
    got, saved = _describe_stable(p), jdoc["plans"][0]["describe"]
    jax_names = {"jnp": "torch", "pallas": "cuda"}  # the port's names of JAX's engines
    shared = set(saved) & set(got)
    assert shared >= {"method", "engine", "n", "dtype", "operator", "preconditioner", "atol",
                      "rtol", "maxiter", "core", "spmv_engine", "replace_every"}
    assert {k: got[k] for k in shared} == {k: jax_names.get(saved[k], saved[k]) for k in shared}
    assert p.trace_count == 2  # warmed: the single runner and the 3-bucket one
    bj = np.asarray(jsp.spmv(J, jnp.ones(J.n)))
    res = p.solve_batched(torch.from_numpy(np.stack([bj, 2.0 * bj, -bj])))
    assert p.trace_count == 2 and bool(res.converged.all())


def test_port_manifest_round_trip_warm_server_and_strict(tmp_path):
    A, _, b = _system(4)
    path = str(tmp_path / "plans.json")
    with SolverServer(max_batch=3, max_wait_ms=2.0, engine="torch", atol=1e-5,
                      maxiter=100) as srv:
        srv.submit(A, b).result(timeout=120)
        srv.save_manifest(path)
    srv2 = SolverServer.from_manifest(path, device="cpu")
    try:
        assert srv2.max_batch == 3
        (plan2,) = srv2.plans()
        assert plan2.trace_count == 2  # single + bucket, built at boot
        futs = srv2.submit_many(A, [b, 2.0 * b, -b], **plan2.config())
        assert all(f.result(timeout=120).converged for f in futs)
        futs[0].result()
        assert srv2.plans()[0].trace_count == 2  # routed onto the adopted plan, no new runner
    finally:
        srv2.shutdown(drain=True)
    doc = json.load(open(path))
    doc["plans"][0]["operator"]["params"]["n"] = 999  # a spec that no longer reproduces it
    doc["plans"][0]["operator"]["params"]["data"] = [[1.0] * 999]
    doc["plans"][0]["operator"]["params"]["offsets"] = [0]
    json.dump(doc, open(path, "w"))
    with pytest.raises(ValueError, match="fingerprint"):
        load_manifest(path, warm=False, device="cpu")


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_server_answers_equal_plan_solve_with_two_runners():
    A, xstar, b = _system(5)
    scales = [2.0, -1.0, 0.5, 3.0, 1e-3]
    with SolverServer(max_batch=3, max_wait_ms=5.0, engine="torch", atol=1e-5,
                      maxiter=200) as srv:
        r0 = srv.submit(A, b).result(timeout=120)  # builds the single runner first
        results = [f.result(timeout=120) for f in srv.submit_many(A, [c * b for c in scales])]
        (plan,) = srv.plans()
    assert plan.trace_count == 2
    torch.testing.assert_close(r0.x, xstar, rtol=1e-3, atol=1e-4)
    direct = repro_torch.plan(A, method="pipecg", engine="torch", M="jacobi", atol=1e-5,
                              maxiter=200)
    for c, r in zip(scales, results):
        ref = direct.solve(c * b)
        assert r.converged and r.iterations == int(ref.iterations)  # honest per request
        torch.testing.assert_close(r.x, ref.x, rtol=1e-4, atol=1e-5)
        assert 0 < r.bucket_occupancy <= 1.0


def test_server_drain_and_shutdown_without_drain():
    A, _, b = _system(4)
    srv = SolverServer(max_batch=4, max_wait_ms=2.0, engine="torch", atol=1e-5, maxiter=100)
    futs = srv.submit_many(A, [(1.0 + 0.25 * i) * b for i in range(11)])
    srv.shutdown(drain=True)
    assert all(f.result(timeout=120).converged for f in futs)  # zero dropped
    with pytest.raises(ServerClosed):
        srv.submit(A, b)
    srv = SolverServer(max_batch=4, max_wait_ms=50.0, engine="torch", atol=1e-5, maxiter=100)
    futs = srv.submit_many(A, [b, 2.0 * b])
    srv.shutdown(drain=False)
    for f in futs:  # queued requests fail; a bucket already popped may still finish
        try:
            assert f.result(timeout=120).converged
        except ServerClosed:
            pass


def test_server_tolerance_decade_shares_a_plan_tightest_wins():
    A, _, b = _system(4)
    with SolverServer(max_batch=2, max_wait_ms=20.0, engine="torch", maxiter=200) as srv:
        f1 = srv.submit(A, b, atol=9e-6)
        f2 = srv.submit(A, 2.0 * b, atol=2e-6)  # the same decade, tighter
        r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
        assert len(srv.plans()) == 1
    rdirect = repro_torch.plan(A, engine="torch", atol=2e-6, maxiter=200).solve(b)
    assert r1.residual_norm <= float(rdirect.residual_norm) * 1.5 + 1e-12
    assert r1.converged and r2.converged


# ---------------------------------------------------------------------------
# CountingOperator, SolverEngine metrics, telemetry, the library lock, launchers
# ---------------------------------------------------------------------------

def test_counting_operator_counts():
    A, _, b = _system(4)
    C = CountingOperator(A)
    torch.testing.assert_close(C.matvec(b), spmv(A, b))
    assert C.calls == 1
    C.reset()
    p = repro_torch.plan(C, method="pipecg", engine="torch", M="jacobi", atol=1e-5, maxiter=100)
    res = p.solve(b)
    # calls: set-up plus every loop step as run; applications: the JAX
    # package's count, set-up plus the iterations
    assert bool(res.converged) and C.calls == 3 + res.steps
    assert C.applications(res) == 3 + int(res.iterations) <= C.calls
    C.reset()
    resb = p.solve_batched(torch.stack([b, 2.0 * b]))  # one call applies every lane
    assert C.calls == 3 + resb.steps
    assert C.applications(resb) == 2 * 3 + int(resb.iterations.sum())
    C.reset()
    res = repro_torch.plan(C, method="pcg", engine="torch", atol=1e-5, maxiter=100).solve(b)
    assert C.calls == 1 + res.steps and C.applications(res, setup=1) == 1 + int(res.iterations)


def test_engine_bucket_metrics():
    obs.enable()
    A, _, b = _system(4)
    B = torch.stack([(1.0 + 0.1 * i) * b for i in range(10)])
    eng = SolverEngine(A, M="jacobi", method="pipecg", engine="torch", atol=1e-5, maxiter=100,
                       max_batch=4)
    res = eng.solve_batch(B)
    snap = obs.snapshot()
    assert snap["serve.buckets"]["value"] == 3.0  # 4 + 4 + 2 (padded to 4)
    assert snap["serve.padded_lanes"]["value"] == 2.0
    assert res.x.shape == B.shape and res.iterations.shape == (10,)
    assert eng.plan.trace_count == 1  # every bucket runs the one 4-lane runner
    single = repro_torch.plan(A, engine="torch", atol=1e-5, maxiter=100)
    assert res.iterations.tolist() == [int(single.solve(x).iterations) for x in B]
    obs.reset_metrics()
    SolverEngine(A, engine="torch", atol=1e-5, maxiter=100).solve_batch(B[:3])
    snap = obs.snapshot()  # the un-split path still records one full bucket
    assert snap["serve.buckets"]["value"] == 1.0 and snap["serve.padded_lanes"]["value"] == 0.0
    assert bucket_waste([3, 5, 7, 7], 2) == 2 and bucket_waste([], 4) == 0


def test_disabled_telemetry_records_nothing():
    obs.clear_spans()
    A, _, b = _system(4)
    with obs.span("outer") as sp:
        assert sp is None
    obs.counter("x").inc()
    obs.histogram("h").record(1.0)
    with SolverServer(max_batch=2, engine="torch", atol=1e-5, maxiter=100) as srv:
        srv.submit(A, b).result(timeout=120)
    assert obs.span_tree() == ()
    assert all(v.get("value", 0) == 0 and v.get("count", 0) == 0 for v in obs.snapshot().values())
    obs.enable()
    with obs.span("outer", k=1):
        with obs.span("inner"):
            pass
    (root,) = obs.span_tree()[-1:]
    assert root.name == "outer" and root.find("inner") is not None
    obs.clear_spans()


def test_library_builds_once_from_two_threads_and_counts_under_a_lock(monkeypatch, tmp_path):
    builds = []
    lib_path = tmp_path / "lib.so"

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # both threads arrive while the first builds
        return lib_path

    monkeypatch.setattr(common, "_LIB", None)
    monkeypatch.setattr(common, "_build", slow_build)
    monkeypatch.setattr(common.ctypes, "CDLL", lambda path: ("loaded", path))
    got = []
    threads = [threading.Thread(target=lambda: got.append(common.library())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(builds) == 1 and got == [("loaded", str(lib_path))] * 2

    def wrapper():
        pass

    # more threads than cores, switching often: a lost update would show
    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [common.count_launch(wrapper)
                                                    for _ in range(2_000)]) for _ in range(32)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 64_000


def test_launchers_on_the_cpu(tmp_path):
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    manifest = str(tmp_path / "m.json")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--matrix",
         "poisson27:5", "--requests", "12", "--max-batch", "3", "--expect-two-programs",
         "--save-manifest", manifest], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "steady state OK" in out.stdout and "PYTORCH_CUDA_ALLOC_CONF" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--manifest",
         manifest, "--requests", "8"], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "warm start OK" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--device", "cpu", "--matrix",
         "poisson27:5", "--rhs", "3"], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "traces=2" in out.stdout
    from repro_torch.launch.env import apply_env

    fake = {"CUDA_MODULE_LOADING": "EAGER"}
    assert apply_env(env=fake) == {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    assert fake["CUDA_MODULE_LOADING"] == "EAGER"  # the operator's setting wins
