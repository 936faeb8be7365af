"""The yardstick: byte counts against hand counts, the trace reduction, and
the traffic generator's draws."""
import numpy as np
import pytest
import torch

from bench import loadgen, roofline
from bench.harness import Request
from bench.trace import reduce_events

TINY_DIA = {"operator": "stencil", "dim": 3, "grid": 4, "radius": 1, "sigma": 1.0, "form": "dia"}


def test_step_bytes_by_hand():
    n, diags = 64, 27
    # the band once, the inverse diagonal once; nine vectors read and written a lane
    assert roofline.step_bytes(TINY_DIA) == (diags * n * 4 + n * 4, 18 * n * 4)


def test_solve_and_bucket_bytes_by_hand():
    shared, lane = roofline.step_bytes(TINY_DIA)
    assert roofline.solve_bytes(TINY_DIA, [3, 5]) == 8 * (shared + lane)
    # a bucket's step is live while any lane is: max 5 steps read the band
    assert roofline.bucket_bytes(TINY_DIA, [[5, 3, 0], [2]]) == (5 + 2) * shared + (8 + 2) * lane
    assert roofline.share(0, 1.0) is None
    assert roofline.share(int(roofline.HBM_BYTES_PER_S), 2.0) == pytest.approx(50.0)


def test_poisson125_128_step_is_the_fused_iter_bound():
    cfg = {"operator": "stencil", "dim": 3, "grid": 128, "radius": 2, "sigma": 1.0, "form": "dia"}
    shared, lane = roofline.step_bytes(cfg)
    # PERF.md's fused_iter bound at poisson125(128): 0.3606 ms a step
    assert (shared + lane) / roofline.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.3606, abs=1e-4)


def test_group_buckets():
    reqs = [Request(i=i, due=0, iterations=i, bucket=(0.1 * (i % 2), 4)) for i in range(4)]
    assert sorted(map(sorted, roofline.group_buckets(reqs))) == [[0, 2], [1, 3]]


def _ev(name, ts, dur, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"stream": stream}}


def test_reduce_events_between_markers():
    events = [
        _ev("void k_before(int)", 0, 10),
        _ev("void at::cuda::spin_kernel(long)", 20, 1),        # start marker: ends at 21
        _ev("void step_kernel<1>(float*)", 21, 50),            # solver stream
        _ev("void step_kernel<1>(float*)", 80, 50),            # gap 71 -> 80
        _ev("void at::native::randn(float*)", 90, 5, stream=9),  # another stream, overlapping
        _ev("Memcpy DtoH", 140, 10, cat="gpu_memcpy"),
        _ev("void at::cuda::spin_kernel(long)", 160, 1),       # end marker at 160
        _ev("void k_after(int)", 170, 10),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30, "dur": 5},
    ]
    s = reduce_events(events)
    assert s.marked == 2
    assert s.window_s == pytest.approx(139e-6)
    assert s.busy_s == pytest.approx((50 + 50 + 10) * 1e-6)
    assert s.solver_kernel_s == pytest.approx(100e-6)
    assert s.solver_kernels == 2
    assert s.kernels == 3
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert sum(gaps.values()) == pytest.approx((9 + 10) * 1e-6)  # between busy spans
    assert s.device_ops[0][0].startswith("step_kernel<1>")


@pytest.mark.parametrize("rate,seconds", [(200.0, 50.0), (2.0, 2000.0)])
def test_arrivals_are_a_poisson_process_drawn_from_the_seed(rate, seconds):
    seed = 2**31 + 5
    a = loadgen.arrival_offsets(rate, seconds, seed)
    np.testing.assert_array_equal(a, loadgen.arrival_offsets(rate, seconds, seed))
    assert not np.array_equal(a[:100], loadgen.arrival_offsets(rate, seconds, seed + 1)[:100])
    assert 0.0 <= a[0] and np.all(np.diff(a) >= 0) and a[-1] < seconds
    n = rate * seconds
    assert abs(len(a) - n) < 4 * n**0.5  # a Poisson count
    gaps = np.diff(np.r_[0.0, a])
    assert np.mean(gaps) * rate == pytest.approx(1.0, abs=0.05)
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(1.0, abs=0.05)  # exponential
    # the counts per second spread as a Poisson's do: variance near the mean,
    # and some seconds run well above the rate
    per_s = np.bincount(a.astype(int), minlength=int(seconds))
    assert 0.6 < per_s.var() / per_s.mean() < 1.5
    assert per_s.max() > rate + 2 * rate**0.5


def test_derive_seed_and_rhs_draws():
    big = 2**31 + 12345
    assert loadgen.derive_seed(big, "rhs", 3) == loadgen.derive_seed(big, "rhs", 3)
    assert len({loadgen.derive_seed(big, k, 3) for k in ("rhs", "scale", "warmup")}) == 3
    assert 0 <= loadgen.derive_seed(-7, "rhs", 2**40) < 2**63
    src = loadgen.RhsSource(1000, big, {"scale_lo": 0.1, "scale_hi": 10.0}, "cpu")
    b1, b2 = src.make(4), src.make(5)
    assert torch.equal(b1, src.make(4)) and not torch.equal(b1, b2)
    s = [src.scale(i) * 1000**0.5 for i in range(200)]
    assert 0.1 <= min(s) and max(s) <= 10.0


def test_reservoir_keeps_at_most_k_drawn_from_the_seed():
    def run(seed):
        r = loadgen.Reservoir(4, seed)
        kept = [None] * 4
        for i in range(100):
            slot = r.slot()
            if slot is not None:
                kept[slot] = i
        return kept

    assert run(3) == run(3)
    assert len(set(run(3))) == 4
    assert run(3) != run(4)
