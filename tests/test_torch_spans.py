"""The span recorder of ``repro_torch.obs`` on the CPU: free and silent
while off, never waiting for the device with ``enable(reports=False)``,
and the span trees the solver loop and the serving tier record.

The host reads that would wait for a card (``torch.cuda.synchronize``,
``Tensor.item``/``tolist``/``cpu``/``__bool__``) are counted by patching
them; the plan's device is made to read "cuda" where a test must see the
synchronisation that ``enable()`` adds.
"""
import math
import threading
import time

import pytest
import torch

import repro_torch
import repro_torch.obs as obs
from repro_torch.core.iteration import POLL_EVERY
from repro_torch.plan import SolverPlan
from repro_torch.serve import SolverServer
from repro_torch.sparse import poisson27, spmv

HOST_READS = ("item", "tolist", "cpu", "__bool__")


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    obs.reset_metrics()
    obs.clear_spans()
    yield
    obs.disable()
    obs.reset_metrics()
    obs.clear_spans()


def _system(grid=6):
    A = poisson27(grid, device="cpu")
    xstar = torch.ones(A.n) / A.n ** 0.5
    return A, spmv(A, xstar)


def _plan(A, **kw):
    return repro_torch.plan(A, method="pipecg", M="jacobi", engine="torch", atol=0.0,
                            **dict(dict(rtol=1e-5, maxiter=200), **kw))


class _Counts:
    """Counts calls of the patched host reads and of ``torch.cuda.synchronize``."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(HOST_READS + ("synchronize",), 0)
        for name in HOST_READS:
            monkeypatch.setattr(torch.Tensor, name, self._counted(name, getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch.cuda, "synchronize", self._counted("synchronize", lambda *a: None))

    def _counted(self, name, fn):
        def wrapper(*a, **kw):
            self.n[name] += 1
            return fn(*a, **kw)
        return wrapper

    def take(self) -> dict:
        out = dict(self.n)
        self.n.update(dict.fromkeys(self.n, 0))
        return out


def _bits(t):
    """A tensor as its bit patterns, so NaN tails compare equal."""
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def _names(sp):
    return [c.name for c in sp.children]


def _fake_cuda(monkeypatch):
    """The plan reads its device as the card, so ``_timed`` would synchronise."""
    monkeypatch.setattr(SolverPlan, "device", property(lambda self: torch.device("cuda")))


def test_a_span_site_while_off_returns_one_shared_noop():
    assert obs.span("a") is obs.span("b", k=3)
    with obs.span("a") as sp:
        assert sp is None
    obs.record_span("serve.queue", 1, 2, request=0)
    assert obs.span_tree() == () and not obs.enabled() and not obs.reports()


def test_off_and_reports_false_never_synchronise_and_keep_the_solve_bit_for_bit(monkeypatch):
    A, b = _system()
    p = _plan(A)
    p.solve(b)  # builds the runner
    B = torch.stack([b, 0.5 * b, 2.0 * b])
    p.solve_batched(B)
    _fake_cuda(monkeypatch)
    counts = _Counts(monkeypatch)
    off, off_b = p.solve(b), p.solve_batched(B)
    assert counts.take()["synchronize"] == 0 and obs.span_tree() == ()

    obs.enable(reports=False)
    on, on_b = p.solve(b), p.solve_batched(B)
    assert counts.take()["synchronize"] == 0
    assert p.last_report is None and obs.reports() is False
    assert [s.name for s in obs.span_tree()] == ["plan.solve", "plan.solve_batched"]
    for x, y in ((off, on), (off_b, on_b)):
        assert x.steps == y.steps
        for f in ("x", "iterations", "history", "residual_norm", "converged"):
            assert torch.equal(_bits(getattr(x, f)), _bits(getattr(y, f))), f

    obs.enable()  # the control: reports synchronise, time and report each solve
    p.solve(b)
    assert counts.take()["synchronize"] >= 1 and p.last_report is not None


@pytest.mark.parametrize("path", ["plan", "server"])
def test_the_recorder_adds_no_host_read(monkeypatch, path):
    """Every host read of a solve or a served bucket is the program's own:
    as many with the recorder on (``reports=False``) as off."""
    A, b = _system(5)
    B = [(1.0 + 0.25 * i) * b for i in range(3)]
    if path == "plan":
        p = _plan(A)
        p.solve(b)

        def work():
            p.solve(b)
            p.solve_batched(torch.stack(B))
    else:
        srv = SolverServer(max_batch=3, max_wait_ms=500.0, engine="torch", atol=1e-5,
                           maxiter=200)
        srv.submit(A, b).result(timeout=120)  # builds both runners
        for f in srv.submit_many(A, B):
            f.result(timeout=120)

        def work():
            for f in srv.submit_many(A, B):
                f.result(timeout=120)
    counts = _Counts(monkeypatch)
    work()
    off = counts.take()
    obs.enable(reports=False)
    work()
    on = counts.take()
    obs.disable()
    if path == "server":
        srv.shutdown(drain=True)
    assert on == off and on["synchronize"] == 0 and on["__bool__"] > 0
    assert obs.span_tree()  # the recorder did record


@pytest.mark.parametrize("rtol, maxiter", [(1e-5, 200), (0.0, 37)], ids=["converged", "maxiter"])
def test_solve_tree_polls_and_attributes(rtol, maxiter):
    A, b = _system()
    p = _plan(A, rtol=rtol, maxiter=maxiter)
    obs.enable(reports=False)
    t0 = time.monotonic_ns()
    res = p.solve(b)
    t1 = time.monotonic_ns()
    (root,) = obs.span_tree()
    assert root.name == "plan.solve" and root.attrs == {"k": 1}
    assert _names(root) == ["pipecg.init", "pipecg.loop"]
    init, loop = root.children
    polls = loop.children
    assert {c.name for c in polls} == {"pipecg.poll"} and not init.children
    assert loop.attrs == {"steps": res.steps, "polls": len(polls)}
    if maxiter == 37:  # ran out: the polls at k = 0, 16, 32
        assert res.steps == 37 and len(polls) == math.ceil(37 / POLL_EVERY)
    else:  # stopped by the poll before step `steps`, which is a multiple of 16
        assert res.steps % POLL_EVERY == 0 and len(polls) == res.steps // POLL_EVERY + 1
    tid = threading.get_ident()
    ids = {root.span_id, init.span_id, loop.span_id} | {c.span_id for c in polls}
    assert len(ids) == 3 + len(polls)
    assert root.parent_id is None and init.parent_id == loop.parent_id == root.span_id
    assert all(c.parent_id == loop.span_id for c in polls)
    for sp in (root, init, loop, *polls):
        assert sp.thread == tid and t0 <= sp.start_ns <= sp.end_ns <= t1
    assert init.end_ns <= loop.start_ns and root.start_ns <= init.start_ns
    assert loop.end_ns <= root.end_ns
    d = root.to_dict()
    assert {"id", "parent", "thread", "start_ns", "end_ns", "attrs"} <= set(d)
    assert d["children"][1]["attrs"]["polls"] == len(polls)


def test_solve_batched_span_carries_k():
    A, b = _system()
    p = _plan(A)
    obs.enable(reports=False)
    res = p.solve_batched(torch.stack([b, 3.0 * b]))
    (root,) = obs.span_tree()
    assert root.name == "plan.solve_batched" and root.attrs == {"k": 2}
    assert _names(root) == ["pipecg.init", "pipecg.loop"]
    assert root.children[1].attrs["steps"] == res.steps


def test_record_span_takes_explicit_bounds_on_no_thread():
    obs.enable(reports=False)
    done = threading.Event()
    threading.Thread(target=lambda: (obs.record_span("serve.queue", 5, 9, request=3),
                                     done.set())).start()
    assert done.wait(10)
    (sp,) = obs.span_tree()
    assert (sp.name, sp.start_ns, sp.end_ns, sp.attrs) == ("serve.queue", 5, 9, {"request": 3})
    assert sp.thread is None and sp.parent_id is None and sp.duration_s == pytest.approx(4e-9)


def test_server_spans_name_every_request_once():
    A, b = _system(5)
    B = [(1.0 + 0.5 * i) * b for i in range(7)]
    obs.enable(reports=False)
    with SolverServer(max_batch=4, max_wait_ms=500.0, engine="torch", atol=1e-5,
                      maxiter=200) as srv:
        results = [f.result(timeout=120) for f in srv.submit_many(A, B)]
    spans = obs.span_tree()
    by_name = {}
    for sp in spans:
        by_name.setdefault(sp.name, []).append(sp)
    ids = sorted(r.request_id for r in results)
    assert len(set(ids)) == len(B)
    assert sorted(sp.attrs["request"] for sp in by_name["serve.admit"]) == ids
    assert sorted(sp.attrs["request"] for sp in by_name["serve.queue"]) == ids
    buckets = by_name["serve.bucket"]
    assert sorted(i for sp in buckets for i in sp.attrs["requests"]) == ids
    assert len({sp.attrs["bucket"] for sp in buckets}) == len(buckets)
    worker = {sp.thread for sp in buckets}
    assert len(worker) == 1 and all(sp.thread in worker for sp in by_name["serve.wait"])
    for q in by_name["serve.queue"]:
        assert q.thread is None and q.start_ns <= q.end_ns
    for sp in buckets:
        assert sp.attrs["k"] == len(sp.attrs["requests"])
        plan_span = sp.children[-3] if sp.attrs["k"] > 1 else sp.children[0]
        assert plan_span.name == ("plan.solve_batched" if sp.attrs["k"] > 1 else "plan.solve")
        assert _names(sp)[-2:] == ["serve.readback", "serve.deliver"]
        if sp.attrs["k"] > 1:
            assert _names(sp)[0] == "serve.assemble" and sp.attrs["size"] == 4
        loop = plan_span.find("pipecg.loop")
        mine = [r for r in results if r.request_id in sp.attrs["requests"]]
        assert {r.steps for r in mine} == {sp.attrs["steps"]} == {loop.attrs["steps"]}
        assert sp.attrs["iterations"] == max(r.iterations for r in mine)
