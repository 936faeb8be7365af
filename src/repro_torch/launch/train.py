"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The JAX launcher's flags, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path). Without ``--full`` it trains the reduced
config (same family and topology, tiny widths); ``--full`` trains the
full config on one card (there is no mesh). Wires together: config ->
model -> train step -> synthetic data -> CheckpointManager (async,
crash-safe) -> supervised recovery loop, which always saves at its end.
Losses are read from the device only on the lines it prints (every 10
steps) and at the end.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import torch

from ..configs import get_config, list_configs, reduced
from ..data import SyntheticConfig, batch_for_step
from ..kernels.common import resolve_device
from ..models import build_model, make_generator
from ..runtime import CheckpointManager, run_with_recovery
from ..train import (
    AdamWConfig,
    TrainConfig,
    batch_to_device,
    init_train_state,
    make_train_step,
    warmup_cosine,
)

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_configs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--pipelined-clip", action="store_true")
    ap.add_argument("--fused-optimizer", action="store_true")
    ap.add_argument("--full", action="store_true", help="the full config, on one card")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced(get_config(args.arch))
    api = build_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} params={api.n_params():,} full={args.full} "
          f"device={dev}")

    tc = TrainConfig(
        optimizer=AdamWConfig(
            lr=args.lr, clip_norm=1.0,
            pipelined_clip=args.pipelined_clip,
            apply_fused=args.fused_optimizer,
        ),
        remat=args.remat,
        microbatches=args.microbatches,
    )
    train_step = make_train_step(api, tc, lr_schedule=warmup_cosine(args.lr, 20, args.steps))

    def init_state():
        return init_train_state(api, make_generator(0, dev))

    state = init_state()
    dc = SyntheticConfig(batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size, seed=0)
    mgr = CheckpointManager(os.fspath(args.ckpt_dir), save_every=args.save_every, keep=3)
    restored, s0 = mgr.restore_latest(state)
    start = 0
    if restored is not None:
        state, start = restored, s0
        print(f"resumed from step {start}")

    t0 = time.time()
    last = {}

    def one_step(state, step):
        batch = batch_to_device(batch_for_step(dc, step, cfg), dev, api.dtype)
        state, metrics = train_step(state, batch)
        if step % 10 == 0:
            print(
                f"step {step:4d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} ({time.time()-t0:.1f}s)"
            )
        last["metrics"] = metrics
        return state

    state, end = run_with_recovery(one_step, state, args.steps, mgr, start_step=start,
                                   reinit=init_state)
    loss = float(last["metrics"]["loss"]) if last else float("nan")
    print(f"finished at step {end}: loss={loss:.4f} in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
