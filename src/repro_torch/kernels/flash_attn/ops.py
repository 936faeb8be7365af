"""Public wrapper for the flash attention kernel."""
from __future__ import annotations

import torch

from ..common import count_launch, stream_ptr
from . import kernel
from .ref import flash_attention_ref

__all__ = ["flash_attention", "DEFAULT_Q_TILE", "DEFAULT_KV_TILE"]

DEFAULT_Q_TILE = 128
DEFAULT_KV_TILE = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    q_tile: int | None = None, kv_tile: int | None = None) -> torch.Tensor:
    """Single-pass softmax attention. q (B,Tq,H,hd); k/v (B,Tk,KV,hd); H a
    multiple of KV (query head h reads kv-head h // (H // KV)); output in
    q's shape and dtype.

    Keeps the JAX wrapper's contract: Tq and Tk must be divisible by the
    tiles (default 128, shrunk to the sequence length for short inputs),
    else ValueError. The CUDA kernel tiles by 128 queries and 64 keys on
    its own and masks ragged edges, so the tiles only shape that check. f32
    or bf16 (on the tensor cores), any hd <= 128 on the card. On CPU
    tensors this runs the plain version; on CUDA tensors it launches the
    kernel or raises.
    ``flash_attention.launches`` counts kernel launches.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,Tq,H,hd) and k, v (B,Tk,KV,hd): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    qt = min(q_tile or DEFAULT_Q_TILE, Tq)
    kt = min(kv_tile or DEFAULT_KV_TILE, Tk)
    if Tq % qt or Tk % kt:
        raise ValueError(f"Tq={Tq} % {qt} or Tk={Tk} % {kt} != 0")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype, got {q.dtype} and {name} {t.dtype}")
    if not kernel.supported(q.dtype):
        raise TypeError(f"flash_attention kernel takes f32 or bf16, got {q.dtype}")
    if hd > kernel.MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {kernel.MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    o = torch.empty_like(q)
    if B and Tq:
        kernel.launch(q, k, v, o, causal, 1.0 / hd**0.5, stream_ptr(dev))
        count_launch(flash_attention)
    return o


flash_attention.launches = 0
