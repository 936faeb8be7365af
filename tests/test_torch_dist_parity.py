"""The port's h3 (performance-model weights), h4 and pl2 against the JAX
package's own 4-device runs, and the port's mesh-level solve_batched
lane by lane against its single solves.

One module-scoped fixture runs one JAX subprocess on 4 virtual CPU
devices (``conftest.run_multidevice``), which writes each method's
iterations, history and x to an npz; the port runs the same methods on a
host-only mesh of 4 shards in process.
"""
import os

import numpy as np
import pytest
import torch

from conftest import run_multidevice

import repro.sparse as jsp
import repro_torch
from repro_torch import convert

N, NNZ, SEED, BW = 1200, 7.0, 5, 12
TOL = dict(atol=0.0, rtol=1e-5, maxiter=1000)
CPU4 = ("cpu",) * 4
CASES = {
    "h3-weighted": ("h3", dict(shards=4, weights=[2.0, 1.0, 1.0, 1.0])),
    "h4": ("h4", dict(shards=4, sub=2)),
    "pl2": ("pl2", dict(shards=4)),
}

_JAX_RUN = """
import numpy as np, jax, jax.numpy as jnp
import repro
from repro.sparse import synthetic_spd_dia
assert jax.device_count() == 4, jax.device_count()
A = synthetic_spd_dia({N}, {NNZ}, seed={SEED}, bandwidth={BW})
b = jnp.asarray(np.random.default_rng(0).standard_normal(A.n).astype(np.float32))
out = {{"b": np.asarray(b)}}
for name, (method, kw) in {CASES!r}.items():
    p = repro.plan(A, method=method, M="jacobi", **{TOL!r}, **kw)
    r = p.solve(b)
    out[name + ".iterations"] = np.asarray(r.iterations)
    out[name + ".history"] = np.asarray(r.history)
    out[name + ".x"] = np.asarray(r.x)
    out[name + ".bounds"] = np.asarray(p.describe()["shard_bounds"])
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    path = os.path.join(tmp_path_factory.mktemp("dist_parity"), "jax_runs.npz")
    out = run_multidevice(_JAX_RUN.format(N=N, NNZ=NNZ, SEED=SEED, BW=BW, CASES=CASES, TOL=TOL,
                                          path=path), n_devices=4, timeout=300)
    assert "OK" in out
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def operator():
    J = jsp.synthetic_spd_dia(N, NNZ, seed=SEED, bandwidth=BW)
    return convert.dia_from_arrays(np.asarray(J.data), J.offsets, J.n, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_method_matches_jax_on_4_devices(name, jax_runs, operator):
    method, kw = CASES[name]
    b = torch.from_numpy(jax_runs["b"])
    p = repro_torch.plan(operator, method=method, M="jacobi", devices=CPU4, **TOL, **kw)
    assert p.describe()["shard_bounds"] == tuple(int(v) for v in jax_runs[name + ".bounds"])
    res = p.solve(b)
    it, jit = int(res.iterations), int(jax_runs[name + ".iterations"])
    assert bool(res.converged)
    assert abs(it - jit) <= 1, (it, jit)
    h, jh = res.history.numpy(), jax_runs[name + ".history"]
    both = ~np.isnan(h) & ~np.isnan(jh)
    assert both.sum() >= min(it, jit) + 1
    # the parity bound of tests/torch_parity.py: the f32 sums add in another
    # order, which moves the tail (~1e-5 of ||u0||) by ~1e-3 of itself
    np.testing.assert_allclose(h[both], jh[both], rtol=1e-4, atol=1e-6 * jh[0])
    np.testing.assert_allclose(res.x.numpy(), jax_runs[name + ".x"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("method,kw", [("h3", dict(shards=4, weights=[2.0, 1.0, 1.0, 1.0])),
                                       ("pl3", dict(shards=3))])
def test_solve_batched_lanes_equal_single_solves(method, kw, operator):
    g = torch.Generator().manual_seed(1)
    B = torch.stack([torch.randn(operator.n, generator=g) * s for s in (1.0, 1e-3, 30.0)])
    p = repro_torch.plan(operator, method=method, M="jacobi", devices=("cpu",) * kw["shards"],
                         **TOL, **kw)
    batch = p.solve_batched(B)
    assert p.trace_count == 2
    for lane in range(3):
        one = p.solve(B[lane])
        assert int(batch.iterations[lane]) == int(one.iterations)
        assert torch.equal(batch.x[lane], one.x)
        np.testing.assert_array_equal(batch.history[lane].numpy(), one.history.numpy())
