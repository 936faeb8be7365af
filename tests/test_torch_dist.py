"""The port's distributed path against the JAX package, in process, on a
host-only mesh (``devices=("cpu",) * n``): partitions and sharded blocks
exactly, the performance model to 1e-12, the depth-l loop against JAX's,
every method against JAX's single-device pipecg at the reference's own
bounds (``tests/test_distributed.py``), the reductions per iteration
from the communicator's counters, the refusals, a shard that raises, a
rank that stalls, and 16 ranks hammering the collectives.
"""
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as jsp
from repro.core import jacobi as jjacobi, pcg as jpcg, pipecg as jpipecg
from repro.core.iteration import make_deep_pipecg_core as jdeep
from repro.core.perfmodel import StragglerTracker as JTracker
from repro.core.perfmodel import decompose as jdecompose, relative_weights as jrelative_weights
from repro.core.reduce import make_reducer as jmake_reducer
import repro_torch
from repro_torch import convert
from repro_torch.core import SolverMesh, jacobi
from repro_torch.core.distributed import (
    build_distributed_solver,
    make_solver_mesh,
    reductions_per_iteration,
    register_dist_spmv,
    spmv_halo,
)
from repro_torch.core.iteration import make_deep_pipecg_core
from repro_torch.core.perfmodel import StragglerTracker, decompose, relative_weights
from repro_torch.sparse import (
    balanced_nnz,
    balanced_rows,
    partition_stats,
    shard_dia,
    shard_vector,
    spmv,
    unshard_vector,
)

CPU4 = ("cpu",) * 4


def _pair(J):
    return convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")


def test_partitions_and_blocks_match_jax():
    J = jsp.synthetic_spd_dia(1000, 9.0, seed=3, bandwidth=16)
    A = _pair(J)
    row_nnz = np.asarray((np.asarray(J.data) != 0).sum(axis=0))
    np.testing.assert_array_equal(balanced_rows(A.n, 7), jsp.balanced_rows(J.n, 7))
    for w in (None, np.array([2.0, 1.0, 1.0, 1.0]), np.array([0.98, 0.02])):
        parts = 4 if w is None else len(w)
        np.testing.assert_array_equal(balanced_nnz(row_nnz, parts, w),
                                      jsp.balanced_nnz(row_nnz, parts, w))
        np.testing.assert_array_equal(decompose(A, parts, w), jdecompose(J, parts, w))
    bounds = decompose(A, 4, np.array([2.0, 1.0, 1.0, 1.0]))
    assert partition_stats(A, bounds) == jsp.partition_stats(J, bounds)
    # every block bit for bit JAX's on the shard's valid rows
    for b in (bounds, balanced_rows(A.n, 4)):
        As, Js = shard_dia(A, b, CPU4), jsp.shard_dia(J, b)
        assert As.rows == tuple(np.asarray(Js.rows_valid).tolist())
        for p, blk in enumerate(As.blocks):
            np.testing.assert_array_equal(blk.numpy(), np.asarray(Js.data[p])[:, : As.rows[p]])
    # an unequal shard narrower than the band is refused, as JAX refuses it
    narrow = np.array([0, 10, 500, 1000])
    with pytest.raises(ValueError, match="bandwidth"):
        jsp.shard_dia(J, narrow)
    with pytest.raises(ValueError, match="bandwidth"):
        shard_dia(A, narrow)


def test_perfmodel_matches_jax():
    times = np.array([3.5e-4, 1.7e-2, 2.2e-2])
    np.testing.assert_allclose(relative_weights(times), jrelative_weights(times),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(relative_weights(1 / times, are_times=False),
                               jrelative_weights(1 / times, are_times=False), rtol=0, atol=1e-12)
    ours, theirs = StragglerTracker(3), JTracker(3)
    rng = np.random.default_rng(4)
    for _ in range(6):
        t = rng.uniform(1e-3, 5e-3, 3)
        ours.update(t)
        theirs.update(t)
        assert ours.needs_rebalance() == theirs.needs_rebalance()
    np.testing.assert_allclose(ours.ewma, theirs.ewma, rtol=0, atol=1e-12)
    assert abs(ours.imbalance - theirs.imbalance) < 1e-12
    np.testing.assert_allclose(ours.proposed_weights(), theirs.proposed_weights(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("l", [1, 2, 3])
def test_deep_core_matches_jax(l):
    J = jsp.synthetic_spd_dia(1000, 9.0, seed=3, bandwidth=16)
    A = _pair(J)
    JM = jjacobi(J)
    b_np = np.random.default_rng(0).standard_normal(J.n).astype(np.float32)
    jb = jnp.asarray(b_np)
    jloop = jdeep(l)
    ji, jx, _, jconv, _ = jax.jit(lambda bb: jloop(
        bb, jnp.zeros_like(bb), spmv_fn=lambda v: jsp.spmv(J, v),
        reducer=jmake_reducer("local"), inv_diag=JM.inv_diag,
        atol=1e-6, rtol=0.0, maxiter=200))(jb)
    jref = jpcg(J, jb, M=JM, atol=1e-6, maxiter=200)

    loop = make_deep_pipecg_core(l)
    assert loop.pipeline_depth == l
    b = torch.from_numpy(b_np)
    i, x, norm, conv, hist, steps = loop(
        b, torch.zeros_like(b), spmv_fn=lambda v: spmv(A, v), inv_diag=jacobi(A).inv_diag,
        atol=1e-6, rtol=0.0, maxiter=200)
    assert bool(conv) and bool(jconv)
    it = int(i)
    assert abs(it - int(ji)) <= max(1, l - 1)
    assert abs(it - int(jref.iterations)) <= max(1, l - 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-4)
    assert hist.shape == (201,) and not np.isnan(hist[: it + 1].numpy()).any()
    assert np.isnan(hist[it + 1:].numpy()).all()
    assert steps % l == 0 and steps >= it


# (method, kwargs of the plan, reductions per iteration)
METHODS = {
    "h1": (dict(shards=4), 3.0),
    "h2": (dict(shards=4), 1.0),
    "h3": (dict(shards=4), 1.0),
    "h3-weighted": (dict(shards=4, weights=[2, 1, 1, 1]), 1.0),
    "h4": (dict(shards=4, sub=2), 2.0),
    "pl2": (dict(shards=4), 0.5),
    "pl3": (dict(shards=4), 1 / 3),
}


@pytest.mark.parametrize("name", list(METHODS))
def test_method_on_cpu_mesh(name):
    kw, reductions = METHODS[name]
    J = jsp.poisson27(12)
    A = _pair(J)
    jxstar = jnp.ones((J.n,)) / jnp.sqrt(J.n)
    jb = jsp.spmv(J, jxstar)
    ref = jpipecg(J, jb, M=jjacobi(J), atol=1e-6, maxiter=1000)
    b = torch.from_numpy(np.array(jb))
    p = repro_torch.plan(A, method=name.split("-")[0], atol=1e-6, maxiter=1000,
                         devices=CPU4, **kw)
    res = p.solve(b)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    assert float(np.linalg.norm(res.x.numpy() - np.asarray(ref.x))) < 1e-3
    assert float(torch.linalg.norm(b - spmv(A, res.x))) < 1e-3
    assert reductions_per_iteration(p.last_stats) == pytest.approx(reductions)
    d = p.describe()
    assert d["shards"] == 4 and d["pipeline_depth"] == (2 if name == "pl2" else
                                                        3 if name == "pl3" else 1)
    if name == "h3-weighted":
        assert d["shard_bounds"] == tuple(int(v) for v in decompose(A, 4, np.array([2, 1, 1, 1])))


def test_refusals(monkeypatch):
    A = _pair(jsp.poisson27(6))
    with pytest.raises(ValueError, match="equal shards"):
        repro_torch.plan(A, method="h1", shards=2, weights=[2, 1], devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="fused_iter"):
        repro_torch.plan(A, method="h3", shards=2, engine="fused_iter", devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="coordinate loop"):
        repro_torch.plan(A, method="pl2", shards=2, engine="cuda", devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="2-D"):
        repro_torch.plan(A, method="h4", shards=2, devices=("cpu", "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_solver_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.plan(A, method="h3", shards=2)


def test_rendezvous_failures_timeouts_and_stress():
    A = _pair(jsp.poisson27(6))
    bounds = balanced_rows(A.n, 3)
    mesh = make_solver_mesh(3, devices=("cpu",) * 3)
    run = build_distributed_solver(shard_dia(A, bounds, mesh.devices), mesh=mesh,
                                   method="h3", maxiter=100, timeout=5.0)
    b = spmv(A, torch.ones(A.n))
    inv = list(shard_vector(jacobi(A).inv_diag, bounds))
    inv[1] = inv[1][:-1]  # shard 1's core raises on a shape mismatch
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="size"):
        run(shard_vector(b, bounds), inv, 1e-6, 0.0)
    assert time.perf_counter() - t0 < 5.0
    # a rank that stalls before a collective: its peers give up after the
    # rendezvous timeout, and the caller gets the TimeoutError
    def stalling_spmv(shard, x, comm, **kw):
        if comm.rank == 2:
            time.sleep(3.0)
        return spmv_halo(shard, x, comm, **kw)

    register_dist_spmv("_test_stall", stalling_spmv, overwrite=True)
    slow = build_distributed_solver(shard_dia(A, bounds, mesh.devices), mesh=mesh, method="h3",
                                    spmv="_test_stall", maxiter=100, timeout=0.5)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="waited"):
        slow(shard_vector(b, bounds), shard_vector(jacobi(A).inv_diag, bounds), 1e-6, 0.0)
    assert time.perf_counter() - t0 < 2.5
    # more ranks than cores, the interpreter switching threads as often as
    # it can: every rank gets the same bits, the rank-order sum's, of every
    # all-reduce, and every shift its neighbour's tensor
    many = SolverMesh(("cpu",) * 16)
    parts = torch.randn(16, 50, 3, generator=torch.Generator().manual_seed(2))

    def hammer(comm):
        got = []
        for i in range(50):
            h = comm.allreduce(parts[comm.rank, i])
            right = comm.shift(parts[comm.rank, i], +1).wait()
            assert right is None if comm.rank == 15 else torch.equal(right, parts[comm.rank + 1, i])
            got.append(h.wait())
        return torch.stack(got)

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results, comm = many.run(hammer, timeout=20.0)
    finally:
        sys.setswitchinterval(old_interval)
    want = parts[0]
    for r in range(1, 16):
        want = want + parts[r]
    assert all(torch.equal(res, want) for res in results)
    assert comm.counts["allreduce"] == 50 and comm.counts["shift"] == 50
    # the solver still runs once the fault is gone
    x = unshard_vector(run(shard_vector(b, bounds), shard_vector(jacobi(A).inv_diag, bounds),
                           1e-6, 0.0).x)
    assert float(torch.linalg.norm(spmv(A, x) - b)) < 1e-3 * float(torch.linalg.norm(b))
