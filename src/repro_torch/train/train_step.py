"""The train step: loss -> grads -> (clipped) AdamW, as the JAX package's
``train/train_step.py``.

* ONE packed metrics vector (loss, nll, aux, grad norm, tokens), left on
  the device: the caller reads it only where it prints;
* optional pipelined clip (the clip consumes the previous step's norm);
* optional microbatching (gradients accumulated in f32, as JAX's scan
  does) and remat (``torch.utils.checkpoint`` per layer or block: True,
  or "save_collectives", which keeps the attention and MLP outputs).

The step updates the parameters and the optimizer state in place and
returns a new ``TrainState`` that holds them; no scalar leaves the
device. ``abstract_train_state`` is the same state on the ``meta`` device
(the dry-run's; no storage).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.common import ParamTree
from ..models.zoo import ModelApi
from .loss import next_token_loss
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "TrainConfig", "make_train_step", "init_train_state",
           "abstract_train_state", "batch_to_device"]


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    remat: bool | str = False  # False, True or "save_collectives", as JAX's
    microbatches: int = 1  # gradient accumulation factor
    z_loss: float = 0.0
    aux_weight: float = 0.01  # MoE load-balance loss weight (0 aux in the dense family)


class TrainState(NamedTuple):
    params: ParamTree
    opt: AdamWState
    step: torch.Tensor  # int32, 0-d, on the parameters' device


def init_train_state(api: ModelApi, generator: torch.Generator) -> TrainState:
    """Parameters drawn from ``generator`` (on its device), zero moments."""
    params = api.init_params(generator)
    return TrainState(params=params, opt=adamw_init(dict(params.named_parameters())),
                      step=torch.zeros((), dtype=torch.int32, device=generator.device))


def abstract_train_state(api: ModelApi) -> TrainState:
    """``init_train_state``'s state on the ``meta`` device: the parameters
    in the model's dtype, the AdamW moments m and v in f32, as the
    optimizer keeps them, and the 0-d step counters; no allocation."""
    params = api.abstract_params()
    return TrainState(params=params, opt=adamw_init(dict(params.named_parameters())),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def batch_to_device(batch: dict, device, dtype: torch.dtype | None = None) -> dict:
    """A host batch of numpy arrays as tensors on ``device``; to a CUDA
    device through pinned memory without waiting for the device. ``dtype``
    (the model's) casts the floating inputs, the encdec ``frames`` and vlm
    ``img_feats`` that ``batch_for_step`` draws in f32, on the device."""
    device = torch.device(device)

    def place(v):
        t = torch.from_numpy(np.asarray(v))
        if device.type != "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return {k: place(v) for k, v in batch.items()}


def make_train_step(api: ModelApi, tc: TrainConfig = TrainConfig(),
                    lr_schedule: Optional[Callable] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics); ``batch`` holds
    tensors on the parameters' device."""

    def loss_fn(params, batch):
        out = api.forward(params, batch, remat=tc.remat)
        if isinstance(out, tuple):  # the MoE family: (logits, aux)
            logits, aux = out
        else:
            logits = out
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        nll = next_token_loss(logits, batch["tokens"], z_loss=tc.z_loss)
        return nll + tc.aux_weight * aux, nll, aux

    def grads_of(params, named, batch):
        loss, nll, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), nll.detach(), aux.detach(), dict(zip(named, grads))

    def compute_grads(params, batch):
        named = dict(params.named_parameters())
        if tc.microbatches <= 1:
            return grads_of(params, named, batch)
        b = batch["tokens"].shape[0]
        if b % tc.microbatches:
            raise ValueError(f"batch {b} is not a multiple of microbatches={tc.microbatches}")
        size = b // tc.microbatches
        dev = batch["tokens"].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        nll, aux = loss.clone(), loss.clone()
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in named.items()}
        for i in range(tc.microbatches):
            mbatch = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            l_i, n_i, a_i, g = grads_of(params, named, mbatch)
            loss, nll, aux = loss + l_i, nll + n_i, aux + a_i
            for k in acc:
                acc[k] += g[k].to(torch.float32)
        inv = 1.0 / tc.microbatches
        grads = {k: (a * inv).to(torch.float32) for k, a in acc.items()}
        return loss * inv, nll * inv, aux * inv, grads

    def train_step(state: TrainState, batch: dict):
        loss, nll, aux, grads = compute_grads(state.params, batch)
        lr = lr_schedule(state.step) if lr_schedule is not None else None
        _, new_opt, om = adamw_update(dict(state.params.named_parameters()), grads, state.opt,
                                      tc.optimizer, lr=lr)
        tokens = torch.full((), float(batch["tokens"].numel()), dtype=torch.float32,
                            device=loss.device)
        metrics_vec = torch.stack([loss, nll, aux, om["grad_norm"], tokens])
        metrics = {
            "loss": metrics_vec[0],
            "nll": metrics_vec[1],
            "aux": metrics_vec[2],
            "grad_norm": metrics_vec[3],
            "tokens": metrics_vec[4],
            "lr": om["lr"],
        }
        return TrainState(params=state.params, opt=new_opt, step=state.step + 1), metrics

    return train_step
