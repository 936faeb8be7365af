"""AdamW with a single-pass (fused) update and pipelined gradient clipping,
as the JAX package's ``train/optimizer.py``.

Fusion: ``apply_fused=True`` routes each parameter tensor through the
CUDA fused AdamW kernel (``kernels/fused_adam``): one pass over p, g, m
and v instead of about eight. On the card that is one launch per
parameter tensor (219 per step for internlm2-1.8b; JAX's stacked layout
has 12 leaves).

Pipelined clip: with ``pipelined_clip=True`` the clip scale uses the
PREVIOUS step's global norm (kept in the state), so this step's reduction
is consumed one step late, the PIPECG one-iteration slack.

Both updates work IN PLACE on the parameters and on m and v (JAX returns
new trees): the state of a full-size model is 22.7 GB, and a second copy
is what the in-place update saves. Every scalar (the step, lr, the clip
scale, the previous norm) is a 0-d device tensor, so an update never
waits for the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch

from ..kernels.fused_adam import adamw_hyper, fused_adamw

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 0.0       # 0 = off
    pipelined_clip: bool = False  # use previous step's global norm
    apply_fused: bool = False     # CUDA fused kernel (plain version on CPU tensors)


class AdamWState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor       # int32, 0-d, on the parameters' device
    prev_norm: torch.Tensor  # float32, 0-d: the previous step's grad norm


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero f32 moments for a dict of parameters (``dict(model.named_parameters())``)."""
    dev = next(iter(params.values())).device
    return AdamWState(
        m={k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev),
        prev_norm=torch.ones((), dtype=torch.float32, device=dev),
    )


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in tree.values()))


def _tree_update(params, grads, m, v, cfg: AdamWConfig, step, lr):
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    for k, p in params.items():
        gf = grads[k].to(torch.float32)
        m_n = b1 * m[k] + (1 - b1) * gf
        v_n = b2 * v[k] + (1 - b2) * gf * gf
        mhat = m_n / bc1
        vhat = v_n / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        m[k].copy_(m_n)
        v[k].copy_(v_n)


def _fused_update(params, grads, m, v, cfg: AdamWConfig, step, lr):
    hyper = adamw_hyper(lr, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay, step)
    for k, p in params.items():
        fused_adamw(p.view(-1), grads[k].reshape(-1), m[k].view(-1), v[k].view(-1), hyper)


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                 state: AdamWState, cfg: AdamWConfig, lr=None):
    """One AdamW step. Updates ``params`` and the state's m and v in place
    (and, under clipping, ``grads``). Returns (params, new_state, metrics)
    with the JAX signature; ``lr`` is None (``cfg.lr``), a float or a 0-d
    tensor."""
    step = state.step + 1
    dev = state.step.device
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), cfg.lr if lr is None else lr, dtype=torch.float32, device=dev)
    lr = lr.to(torch.float32)
    gnorm = global_norm(grads)

    if cfg.clip_norm > 0.0:
        ref = state.prev_norm if cfg.pipelined_clip else gnorm
        scale = torch.clamp(cfg.clip_norm / torch.clamp(ref, min=1e-9), max=1.0)
        for g in grads.values():
            g.copy_((g.to(torch.float32) * scale).to(g.dtype))

    impl = _fused_update if cfg.apply_fused else _tree_update
    impl(params, grads, state.m, state.v, cfg, step, lr)
    new_state = AdamWState(m=state.m, v=state.v, step=step, prev_norm=gnorm)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
