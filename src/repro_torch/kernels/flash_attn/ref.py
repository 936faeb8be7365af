"""Plain PyTorch version of flash attention: softmax attention, as the JAX
package's ``flash_attention_ref``. q (B, Tq, H, hd); k/v (B, Tk, KV, hd);
GQA via n_rep = H // KV. Scores and softmax in f32, probabilities cast to
q's dtype before the product with v."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, causal: bool = True):
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Tq, KV, H // KV, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg.to(torch.float32), k.to(torch.float32))
    s = s / math.sqrt(hd)
    if causal:
        pos = torch.arange(max(Tq, Tk), device=q.device)
        mask = pos[None, :Tk] <= pos[:Tq, None]
        s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgh->bqgrh", p.to(q.dtype), v)
    return o.reshape(B, Tq, H, hd)
