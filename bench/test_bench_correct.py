"""``correct`` on the CPU at tiny sizes: sound runs of every cell pass; the
control (the configuration's lower precision in the program's place)
fails. The faults are in test_bench_faults.py."""
import pytest

from bench import _tiny

CELLS = ["poisson125.solve", "poisson125.serve"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 77, 3])
def test_sound_run_is_correct(workload, seed):
    ok, out = _tiny.run(workload, seed=seed)
    assert ok, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 77, 3])
def test_control_is_not_correct(workload, seed):
    ok, out = _tiny.run(workload, seed=seed, control=True)
    assert not ok, out["checks"]
