"""xLSTM LM (xlstm-1.3b): mLSTM blocks with periodic sLSTM blocks, as the
JAX package's ``models/xlstm.py``.

mLSTM, the matrix-memory LSTM, is exponential-gated linear attention with
a normalizer, on the chunked GLA engine (``gla.py``). sLSTM, the
scalar-memory LSTM with recurrent gate connections, is sequential: a
Python loop over time (JAX's ``lax.scan``), with the same stabilised
gating (``minimum(i, 10)``, log-sigmoid forget gate, ``max(|n|, 1)``).
The JAX package's simplifications are kept: no short conv in the mLSTM
q/k path; sigmoid / log-sigmoid gates. Groups of ``slstm_every - 1``
mLSTM blocks and one sLSTM block.

Decode updates the state in place (JAX returns a new one); at full width
the mLSTM matrix memory is 5.64 GB at batch 8, so it is never copied.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from .common import ParamSpec, apply_norm, make_norm_params
from .gla import GLAState, gla_chunked, gla_step
from .transformer import check_remat, embed_params, embed_tokens, remat_call, unembed

__all__ = [
    "XLSTMState",
    "xlstm_layout",
    "xlstm_forward",
    "xlstm_decode",
    "xlstm_init_state",
]


class XLSTMState(NamedTuple):
    mlstm: GLAState          # stacked (n_mlstm, B, H, dk, dv), f32
    slstm_c: torch.Tensor    # (n_slstm, B, NH, dh), f32
    slstm_n: torch.Tensor
    slstm_h: torch.Tensor


def _mlstm_params(cfg: ArchConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    nh = cfg.ssm_heads_
    return {
        "norm": make_norm_params(d, cfg.norm),
        "w_in": ParamSpec((d, 2 * din), ("embed", "mlp")),  # [x_m | z gate]
        "wq": ParamSpec((din, din), ("mlp", "heads_flat")),
        "wk": ParamSpec((din, din), ("mlp", "heads_flat")),
        "wv": ParamSpec((din, din), ("mlp", "heads_flat")),
        "w_ig": ParamSpec((din, nh), ("mlp", None), init="zeros"),
        "b_ig": ParamSpec((nh,), (None,), init="zeros"),
        "w_fg": ParamSpec((din, nh), ("mlp", None), init="zeros"),
        "b_fg": ParamSpec((nh,), (None,), init="ones", scale=4.0),  # decay ~ 1 at init
        "w_out": ParamSpec((din, d), ("mlp", "embed")),
    }


def _slstm_params(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    nh = cfg.ssm_heads_
    dh = d // nh
    return {
        "norm": make_norm_params(d, cfg.norm),
        "w_gates": ParamSpec((d, 4 * d), ("embed", "mlp")),  # z i f o inputs
        "r_gates": ParamSpec((nh, dh, 4 * dh), (None, None, None), scale=0.5),
        "b_gates": ParamSpec((4 * d,), ("mlp",), init="zeros"),
        "w_out": ParamSpec((d, d), ("embed", "embed")),
    }


def _split_layers(cfg: ArchConfig) -> tuple[int, int]:
    """(groups, mLSTM blocks per group): (slstm_every - 1) mLSTM, then 1 sLSTM."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def xlstm_layout(cfg: ArchConfig) -> dict:
    n_s = cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0
    n_m = cfg.n_layers - n_s
    return {
        **embed_params(cfg),
        "mlstm": [_mlstm_params(cfg) for _ in range(n_m)],
        "slstm": [_slstm_params(cfg) for _ in range(max(n_s, 1))],
    }


def _mlstm_apply(lp, x: torch.Tensor, cfg: ArchConfig, state: GLAState | None, step: bool):
    """x (B, T, d) chunked, or (B, 1, d) recurrent when ``step``, which
    updates ``state`` in place. Returns (x + block(x), state)."""
    B, T, d = x.shape
    nh = cfg.ssm_heads_
    din = cfg.d_inner
    dk = din // nh
    h = apply_norm(x, lp["norm"], cfg.norm)
    hm, z = torch.chunk(h @ lp["w_in"], 2, dim=-1)
    # JAX divides by sqrt(dk), taken in f32 and cast to x's dtype
    root = torch.tensor(math.sqrt(dk), dtype=torch.float32).to(x.dtype).item()
    q = (hm @ lp["wq"]).reshape(B, T, nh, dk)
    k = (hm @ lp["wk"]).reshape(B, T, nh, dk) / root
    v = (hm @ lp["wv"]).reshape(B, T, nh, dk)
    # gate pre-activations summed in the parameters' dtype, then f32
    b_in = torch.sigmoid((hm @ lp["w_ig"] + lp["b_ig"]).to(torch.float32))   # (B, T, NH)
    log_a = F.logsigmoid((hm @ lp["w_fg"] + lp["b_fg"]).to(torch.float32))
    if step:
        y, new_state = gla_step(q[:, 0], k[:, 0], v[:, 0], log_a[:, 0], b_in[:, 0], state,
                                normalize=True)
        y = y[:, None]  # (B, 1, NH, dk)
    else:
        y, new_state = gla_chunked(q, k, v, log_a, b_in, cfg.chunk, state=state, normalize=True)
    y = y.reshape(B, T, din) * F.silu(z)
    return x + y @ lp["w_out"], new_state


def _slstm_cell(r_gates: torch.Tensor, state, g_t: torch.Tensor):
    """One sLSTM step. state = (c, n, h_prev), each (B, NH, dh) f32;
    g_t (B, NH, 4 dh) the input gates. Returns the new (c, n, h)."""
    c, n, h_prev = state
    f32 = torch.float32
    g = g_t.to(f32) + torch.einsum("bhd,hdg->bhg", h_prev, r_gates.to(f32))
    zr, ir, fr, orr = torch.chunk(g, 4, dim=-1)
    i = torch.exp(torch.clamp(ir, max=10.0))
    f = torch.exp(F.logsigmoid(fr))
    c_new = f * c + i * torch.tanh(zr)
    n_new = f * n + i
    h_new = torch.sigmoid(orr) * c_new / torch.clamp(n_new.abs(), min=1.0)
    return c_new, n_new, h_new


def _slstm_apply(lp, x: torch.Tensor, cfg: ArchConfig, state, step: bool):
    """Sequential scalar-memory LSTM over x (B, T, d); state = (c, n,
    h_prev), each (B, NH, dh) f32, or None for zeros. Returns (x +
    block(x), the new (c, n, h)); ``state`` is not written."""
    B, T, d = x.shape
    nh = cfg.ssm_heads_
    dh = d // nh
    xin = apply_norm(x, lp["norm"], cfg.norm)
    gates_in = (xin @ lp["w_gates"] + lp["b_gates"]).reshape(B, T, nh, 4 * dh)
    if state is None:
        zero = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
        state = (zero, zero, zero)
    if step:
        state = _slstm_cell(lp["r_gates"], state, gates_in[:, 0])
        y = state[2][:, None]
    else:
        # cast once, not at every step: autograd would keep each step's copy
        r_gates = lp["r_gates"].to(torch.float32)
        hs = []
        for t in range(T):
            state = _slstm_cell(r_gates, state, gates_in[:, t])
            hs.append(state[2])
        y = torch.stack(hs, dim=1)  # (B, T, NH, dh)
    y = y.reshape(B, T, d).to(x.dtype)
    return x + y @ lp["w_out"], state


def xlstm_init_state(cfg: ArchConfig, batch: int, device=None) -> XLSTMState:
    """A zero state on ``device`` (``None``: CUDA); O(1) in context length."""
    dev = resolve_device(device)
    nh = cfg.ssm_heads_
    dk = cfg.d_inner // nh
    dh = cfg.d_model // nh
    n_groups, m_per = _split_layers(cfg)
    f32 = torch.float32

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    return XLSTMState(
        mlstm=GLAState(S=zeros(n_groups * m_per, batch, nh, dk, dk),
                       n=zeros(n_groups * m_per, batch, nh, dk)),
        slstm_c=zeros(n_groups, batch, nh, dh),
        slstm_n=zeros(n_groups, batch, nh, dh),
        slstm_h=zeros(n_groups, batch, nh, dh),
    )


def xlstm_forward(params, tokens: torch.Tensor, cfg: ArchConfig, *, remat=False,
                  return_state: bool = False):
    """Logits (B, T, V); ``return_state=True`` also returns the XLSTMState
    after the T tokens, each layer's written into one stacked state.
    ``remat`` wraps each mLSTM block, not the sLSTM time loop, as JAX does;
    no block tags a value, so "save_collectives" recomputes each whole."""
    check_remat(remat, return_state)
    x = embed_tokens(params, tokens, cfg)
    n_groups, m_per = _split_layers(cfg)
    if return_state:
        state = xlstm_init_state(cfg, tokens.shape[0], x.device)
    for g in range(n_groups):
        for j in range(m_per):
            li = g * m_per + j
            if remat:
                x = remat_call(lambda h, lp=params["mlstm"][li]: _mlstm_apply(
                    lp, h, cfg, None, step=False)[0], remat, x)
            else:
                x, st = _mlstm_apply(params["mlstm"][li], x, cfg, None, step=False)
                if return_state:
                    state.mlstm.S[li], state.mlstm.n[li] = st.S, st.n
                del st
        x, (c, n, h) = _slstm_apply(params["slstm"][g], x, cfg, None, step=False)
        if return_state:
            state.slstm_c[g], state.slstm_n[g], state.slstm_h[g] = c, n, h
    logits = unembed(params, x, cfg)
    return (logits, state) if return_state else logits


def xlstm_decode(params, token: torch.Tensor, state: XLSTMState, pos: int, cfg: ArchConfig):
    """One token (B, 1): (logits (B, 1, V), ``state`` updated in place).
    O(1) in context length: ``pos`` is not read."""
    del pos
    x = embed_tokens(params, token, cfg)
    n_groups, m_per = _split_layers(cfg)
    for g in range(n_groups):
        for j in range(m_per):
            li = g * m_per + j
            st = GLAState(S=state.mlstm.S[li], n=state.mlstm.n[li])
            x, _ = _mlstm_apply(params["mlstm"][li], x, cfg, st, step=True)
        s_state = (state.slstm_c[g], state.slstm_n[g], state.slstm_h[g])
        x, (c, n, h) = _slstm_apply(params["slstm"][g], x, cfg, s_state, step=True)
        state.slstm_c[g], state.slstm_n[g], state.slstm_h[g] = c, n, h
    return unembed(params, x, cfg), state
