"""On the card: the tiny cells through the program's kernels come out
correct, and the controls do not (``-m cuda``; skipped without a GPU)."""
import pytest
import torch

from bench import _tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("workload", ["poisson125.solve", "poisson125.serve"])
def test_tiny_cell_on_the_card(card, workload):
    ok, out = _tiny.run(workload, device=card)
    assert ok, out["checks"]


@pytest.mark.parametrize("workload", ["poisson125.solve", "poisson125.serve"])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_on_the_card(card, workload, seed):
    ok, out = _tiny.run(workload, seed=seed, device=card, control=True)
    assert not ok, out["checks"]
