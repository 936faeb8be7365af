"""Cross-entropy loss, as the JAX package's ``train/loss.py``."""
from __future__ import annotations

import torch

__all__ = ["ce_loss", "next_token_loss"]


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over all positions, in f32: logsumexp minus the label's
    logit, plus ``z_loss * mean(lse**2)``. logits (B,T,V) any float;
    labels (B,T). The label logit is a gather where JAX selects with an
    iota (its layout reason, a sharded vocab axis, has no one-card
    counterpart); both pick one exact value."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = (lse - label_logit).mean()
    if z_loss > 0.0:
        loss = loss + z_loss * torch.mean(lse**2)
    return loss


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                    z_loss: float = 0.0) -> torch.Tensor:
    """Shifted LM objective: predict tokens[t+1] from logits[t]."""
    return ce_loss(logits[:, :-1], tokens[:, 1:], z_loss=z_loss)
