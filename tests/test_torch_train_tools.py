"""The port's training tools on the CPU: crash recovery before the first
checkpoint, and the peak-lr sweep at the reduced config. Runs of the same
seed are held to each other bit for bit."""
import json

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticConfig, batch_for_step
from repro_torch.launch import lr_sweep
from repro_torch.models import build_model, make_generator
from repro_torch.runtime import CheckpointManager, run_with_recovery
from repro_torch.train import (
    AdamWConfig,
    TrainConfig,
    batch_to_device,
    init_train_state,
    make_train_step,
)


def _setup():
    cfg = reduced(get_config("internlm2-1.8b"))
    api = build_model(cfg)
    step = make_train_step(api, TrainConfig(optimizer=AdamWConfig(lr=1e-3)))
    dc = SyntheticConfig(batch=2, seq_len=16, vocab_size=cfg.vocab_size, seed=3)
    return api, step, dc


def test_recovery_without_checkpoint_needs_reinit(tmp_path):
    """Before the first checkpoint a failure re-raises unless ``reinit``
    rebuilds the state; with it, the run replays from the start and ends
    equal to the crash-free run."""
    api, step, dc = _setup()
    seen = []

    def fn(state, s):
        seen.append(s)
        if s == 2 and seen.count(2) == 1:
            raise RuntimeError("injected node failure")
        return step(state, batch_to_device(batch_for_step(dc, s), "cpu"))[0]

    def init():
        return init_train_state(api, make_generator(0, "cpu"))

    mgr = CheckpointManager(str(tmp_path / "a"), save_every=0, async_save=False)
    with pytest.raises(RuntimeError, match="injected"):
        run_with_recovery(fn, init(), 4, mgr)
    seen.clear()
    mgr = CheckpointManager(str(tmp_path / "b"), save_every=0, async_save=False)
    final, end = run_with_recovery(fn, init(), 4, mgr, reinit=init)
    assert end == 4 and seen == [0, 1, 2, 0, 1, 2, 3]
    ref = init()
    for s in range(4):
        ref = step(ref, batch_to_device(batch_for_step(dc, s), "cpu"))[0]
    for (k, a), (_, b) in zip(ref.params.named_parameters(), final.params.named_parameters()):
        assert torch.equal(a, b), k


def test_lr_sweep_on_cpu(capsys):
    lr_sweep.main(["--reduced", "--device", "cpu", "--steps", "5", "--warmup", "2",
                   "--batch", "2", "--seq", "16", "--lrs", "3e-3,1e-3"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3 and len(lines[0]["loss_at_init_by_batch"]) == 10
    init = lines[0]["loss_at_init_by_batch"]
    for row, lr in zip(lines[1:], (3e-3, 1e-3)):
        assert row["lr"] == lr and len(row["losses"]) == 5 and len(row["held_out_after"]) == 5
        # step 0 runs at lr 0, so steps 0 and 1 see the initial model
        assert row["losses"][:2] == init[:2] and row["held_out_at_init"] == init[5:]
