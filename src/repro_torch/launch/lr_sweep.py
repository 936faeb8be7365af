"""Peak-lr sweep of the full-size trainer on one card:

    python -m repro_torch.launch.lr_sweep --lrs 1.5e-3,6e-4,3e-4 [--steps 20]

For each peak lr, the full internlm2-1.8b (``--reduced`` for its reduced
config, as on the CPU with ``--device cpu``) trains
``--steps`` steps from the seed-0 init through the fused optimizer (clip
1.0, ``warmup_cosine`` with ``--warmup`` steps) on ``batch_for_step`` of
the seed-0 stream, with no checkpoint, as ``chip_smoke.py`` phase 5b
does. Before the first lr it reads the initial model's loss on batches 0
to ``steps + 4``: the last five are never trained on (held out). Each lr
prints one JSON line: the step losses, the means of the first and last
five, and the held-out losses after training. The initial losses come
first, on a line of their own.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics

import torch

from ..configs import get_config, reduced
from ..data import SyntheticConfig, batch_for_step
from ..kernels.common import resolve_device
from ..models import build_model, make_generator
from ..train import (
    AdamWConfig,
    TrainConfig,
    batch_to_device,
    init_train_state,
    make_train_step,
    next_token_loss,
    warmup_cosine,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="1.5e-3,6e-4,3e-4")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--reduced", action="store_true", help="the reduced config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("internlm2-1.8b")
    api = build_model(reduced(cfg) if args.reduced else cfg)
    dc = SyntheticConfig(batch=args.batch, seq_len=args.seq, vocab_size=api.cfg.vocab_size, seed=0)
    held_out = range(args.steps, args.steps + 5)

    def losses_on(params, steps):
        with torch.no_grad():
            out = []
            for s in steps:
                b = batch_to_device(batch_for_step(dc, s), dev)
                out.append(next_token_loss(api.forward(params, b), b["tokens"]))
            return torch.stack(out).tolist()

    state = init_train_state(api, make_generator(0, dev))
    at_init = losses_on(state.params, range(args.steps + 5))
    print(json.dumps({"arch": api.cfg.name, "batch": args.batch, "seq": args.seq,
                      "loss_at_init_by_batch": at_init}), flush=True)
    for lr in (float(x) for x in args.lrs.split(",")):
        if state is None:
            state = init_train_state(api, make_generator(0, dev))
        step_fn = make_train_step(api, TrainConfig(
            optimizer=AdamWConfig(lr=lr, clip_norm=1.0, apply_fused=True)),
            lr_schedule=warmup_cosine(lr, args.warmup, args.steps))
        losses = []
        for s in range(args.steps):
            state, metrics = step_fn(state, batch_to_device(batch_for_step(dc, s), dev))
            losses.append(metrics["loss"])
        losses = torch.stack(losses).tolist()
        print(json.dumps({
            "lr": lr, "warmup": args.warmup, "losses": losses,
            "first5_mean": statistics.mean(losses[:5]), "last5_mean": statistics.mean(losses[-5:]),
            "held_out_at_init": at_init[-5:], "held_out_after": losses_on(state.params, held_out),
        }), flush=True)
        state = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
