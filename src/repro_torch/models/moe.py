"""Mixture-of-Experts FFN: top-k routing with capacity-bounded dispatch,
as the JAX package's ``models/moe.py``.

* ``moe_ffn``: GShard-style "dropping" dispatch. Each token's top-k
  assignments are ranked within their expert (earlier tokens first) and
  written into an (E, C, d) buffer; an assignment ranked C or later is
  dropped. The SwiGLU experts are batched matrix products over the
  buffer, and the combine weights each kept assignment's output by its
  gate.
* ``moe_ffn_sharded``: the same layer as an explicit ``shard_map`` over a
  (data, model) mesh (``launch/mesh.shard_map``). Activations are
  replicated over the model axis, so every shard holds its data shard's
  tokens and its E/M experts: it routes its tokens, keeps only the
  assignments to its own experts, runs them, and ONE ``psum`` over
  "model" adds the expert shards' partial outputs. The capacity is per
  (data shard x expert). Under autograd the forward keeps each shard's
  graph and the backward is a second ``shard_map`` region, the transpose
  of the first, on those graphs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import ParamSpec, current_mesh, shard_hint

__all__ = ["moe_params", "moe_ffn", "moe_ffn_sharded", "moe_capacity", "top_k_stable"]


def moe_params(d: int, f: int, n_experts: int) -> dict:
    return {
        "router": ParamSpec((d, n_experts), ("embed", None)),
        "w_gate": ParamSpec((n_experts, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": ParamSpec((n_experts, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": ParamSpec((n_experts, f, d), ("experts", "expert_mlp", "embed")),
    }


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    c = int(capacity_factor * n_tokens * top_k / n_experts)
    return max(8, ((c + 7) // 8) * 8)


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, in descending order, the
    lower index first among equal values (``jax.lax.top_k``'s order;
    ``torch.topk`` gives no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int, capacity_factor: float,
           norm_topk: bool):
    """Top-k routing of x (T, d) over E experts, and each assignment's rank
    within its expert (stable: earlier tokens first). Returns (probs (T, E)
    f32, gates (T, k), experts (T, k), pos (T*k,), the capacity C)."""
    T, E = x.shape[0], router.shape[-1]
    logits = (x @ router).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_stable(probs, top_k)  # (T, k)
    if norm_topk:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    A, dev = T * top_k, x.device
    flat_e = expert_idx.reshape(A)  # assignment -> expert
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev), side="left")  # (E,)
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(A, device=dev) - first[sorted_e]
    return probs, gate_vals, expert_idx, pos, moe_capacity(T, top_k, E, capacity_factor)


def _experts(x, wg, wu, wd, local_e, pos, kept, gate_vals, C: int) -> torch.Tensor:
    """Dispatch the kept assignments of x (T, d) to the experts of wg, wu,
    wd (local_e: each assignment's index among them), run them, and combine
    each kept output weighted by its gate: y (T, d)."""
    T, d = x.shape
    top_k = gate_vals.shape[-1]
    A, n_exp = T * top_k, wg.shape[0]
    tok_of = torch.arange(A, device=x.device) // top_k  # assignment -> token
    # an (n_exp, C + 1, d) buffer whose last slot takes every assignment not
    # kept (JAX drops the write out of bounds; index_put would raise)
    slot = local_e * (C + 1) + torch.where(kept, pos, C)
    buf = x.new_zeros((n_exp * (C + 1), d))
    buf[slot] = x[tok_of]
    buf = shard_hint(buf.view(n_exp, C + 1, d)[:, :C], ("experts", None, None))

    # the experts: (E, C, d) x (E, d, f) batched products
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_e = shard_hint(torch.bmm(h, wd), ("experts", None, None))  # (E, C, d)

    # combine: gather each kept assignment's output, weight by its gate
    y_a = out_e[local_e, torch.clamp(pos, max=C - 1)]  # (A, d)
    wts = gate_vals.reshape(A).to(x.dtype) * kept.to(x.dtype)
    return (y_a * wts[:, None]).reshape(T, top_k, d).sum(dim=1)


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss E * sum_e f_e * P_e (one_hot as a
    comparison: F.one_hot reads the indices' range on the host)."""
    E = probs.shape[-1]
    first_choice = expert_idx[:, :1] == torch.arange(E, device=probs.device)
    return E * torch.sum(first_choice.to(torch.float32).mean(dim=0) * probs.mean(dim=0))


def moe_ffn(p, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
            norm_topk: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d), aux_loss scalar f32).

    aux_loss is the Switch load-balancing loss: E times the sum over
    experts of (share of tokens whose first choice it is) x (mean router
    probability). The capacity C is computed per call from T, so a prefill
    and a decode step of one prompt may drop different assignments, as in
    JAX.
    """
    probs, gate_vals, expert_idx, pos, C = _route(x, p["router"], top_k, capacity_factor,
                                                  norm_topk)
    y = _experts(x, p["w_gate"], p["w_up"], p["w_down"], expert_idx.reshape(-1), pos, pos < C,
                 gate_vals, C)
    return y, _aux_loss(probs, expert_idx)


class _ShardedDispatch:
    """The per-shard bodies of ``moe_ffn_sharded`` over one mesh, and its
    two ``shard_map`` regions: the forward, which keeps each shard's graph
    when a backward will follow, and the backward, which takes each
    shard's vector-Jacobian product on that graph and applies the
    transposes of the forward's collectives (see ``moe_ffn_sharded``)."""

    def __init__(self, mesh, n_experts: int, top_k: int, capacity_factor: float,
                 norm_topk: bool):
        from ..launch.mesh import shard_map
        from ..launch.sharding import P

        self.shard_map = shard_map
        M = mesh.shape["model"]
        if n_experts % M:
            raise ValueError(f"{n_experts} experts do not split over a model axis of {M}")
        self.mesh, self.M, self.E_loc = mesh, M, n_experts // M
        self.top_k, self.capacity_factor, self.norm_topk = top_k, capacity_factor, norm_topk
        self.batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
        self.n_data = math.prod(mesh.shape[a] for a in self.batch_axes)
        b = self.batch_axes
        self.spec_x = P(b if len(b) > 1 else (b or (None,))[0], None, None)
        self.spec_w = (P(None, None), P("model", None, None), P("model", None, None),
                       P("model", None, None))
        self.spec_aux = P()

    def local(self, comm, xb, router, wg, wu, wd):
        """MY shard's part: route MY tokens, keep only the assignments to
        MY expert shard and run them. Returns (y_part (B_loc, T, d), the
        expert shard's share of y before the psum over "model"; aux_loc,
        MY data shard's aux before the mean over the data shards)."""
        B_loc, T, d = xb.shape
        xf = xb.reshape(B_loc * T, d)
        probs, gate_vals, expert_idx, pos, C = _route(xf, router, self.top_k,
                                                      self.capacity_factor, self.norm_topk)
        flat_e = expert_idx.reshape(-1)
        e0 = comm.axis_index("model") * self.E_loc
        mine = (flat_e >= e0) & (flat_e < e0 + self.E_loc)
        local_e = torch.clamp(flat_e - e0, 0, self.E_loc - 1)
        y = _experts(xf, wg, wu, wd, local_e, pos, (pos < C) & mine, gate_vals, C)
        return y.reshape(B_loc, T, d), _aux_loss(probs, expert_idx)

    def forward(self, x3, router, wg, wu, wd, graphs=None):
        """The forward region. With ``graphs`` (a dict), each shard runs
        its body with grad on, on leaves of its own blocks, and leaves
        ``graphs[rank] = (leaves, y_part, aux_loc)`` for :meth:`backward`."""

        def body(comm, *blocks):
            if graphs is None:
                y, aux = self.local(comm, *blocks)
            else:
                leaves = [t.detach().requires_grad_() for t in blocks]
                with torch.enable_grad():
                    y, aux = self.local(comm, *leaves)
                graphs[comm.rank] = (leaves, y, aux)
                y, aux = y.detach(), aux.detach()
            y = comm.allreduce(y, axes="model", tag="model").wait()  # the ONLY traffic of y
            # aux is the same on every model shard (same tokens, same router):
            # reduce over the batch axes only (the mean over data shards)
            aux = comm.allreduce(aux, axes=self.batch_axes, tag="aux").wait()
            return y, aux / self.n_data

        fn = self.shard_map(body, self.mesh, in_specs=(self.spec_x, *self.spec_w),
                            out_specs=(self.spec_x, self.spec_aux))
        return fn(x3, router, wg, wu, wd)

    def backward(self, graphs, dy, daux):
        """The backward region: each shard's VJP on the graph its forward
        kept (no forward op runs again), then the collectives' transposes.
        The VJPs free the graphs: a second backward finds none and raises."""
        if len(graphs) != self.mesh.size:
            raise RuntimeError(
                "moe_ffn_sharded keeps each shard's graph for one backward, and a backward "
                "through this output has already run (retain_graph=True, or a second "
                "autograd.grad): run its forward again for another backward")
        everything = self.mesh.axis_names

        def body(comm, dyb, da):
            leaves, y, aux = graphs.pop(comm.rank)
            # this thread drives its own VJP: on a card the autograd engine's
            # device thread would run it, and that thread is the one waiting
            # in _ShardedMoE.backward for us
            with torch.autograd.set_multithreading_enabled(False):
                # y = psum_model(y_part): its transpose hands dy to every
                # model shard. aux = psum_data(aux_loc) / n_data, and aux_loc
                # is replicated over "model": each model shard takes 1/M of
                # its cotangent, which the sums over "model" below add back
                gx, gr, gg, gu, gd = torch.autograd.grad(
                    (y, aux), leaves, (dyb, da / (self.n_data * self.M)))
            # the transposes of the in_specs: x is replicated over "model",
            # the router over every axis, the experts over the batch axes
            gx = comm.allreduce(gx, axes="model", tag="grad_x").wait()
            gr = comm.allreduce(gr, axes=everything, tag="grad_router").wait()
            gg, gu, gd = (comm.allreduce(t, axes=self.batch_axes, tag="grad_experts").wait()
                          for t in (gg, gu, gd))
            return gx, gr, gg, gu, gd

        fn = self.shard_map(body, self.mesh, in_specs=(self.spec_x, self.spec_aux),
                            out_specs=(self.spec_x, *self.spec_w))
        return fn(dy, daux)


class _ShardedMoE(torch.autograd.Function):
    """``moe_ffn_sharded`` under autograd. The forward region keeps each
    shard's graph, held by the storage of a token tensor that the node
    saves; the backward region takes the VJPs on those graphs, as JAX's
    transpose of a ``shard_map`` reads the residuals its forward saved.
    Under ``torch.utils.checkpoint`` the token is dropped with every other
    saved tensor (and the graphs with it), and the recompute's token, with
    the recompute's graphs, takes its place."""

    @staticmethod
    def forward(ctx, dispatch: _ShardedDispatch, keep: bool, x3, router, wg, wu, wd):
        ctx.dispatch = dispatch
        if not keep:
            return dispatch.forward(x3, router, wg, wu, wd)
        graphs: dict = {}
        out = dispatch.forward(x3, router, wg, wu, wd, graphs)
        token = x3.new_empty(0)
        token.untyped_storage()._moe_graphs = graphs
        ctx.save_for_backward(token)
        return out

    @staticmethod
    def backward(ctx, dy, daux):
        (token,) = ctx.saved_tensors
        graphs = token.untyped_storage()._moe_graphs
        return (None, None, *ctx.dispatch.backward(graphs, dy, daux))


def moe_ffn_sharded(p, x3: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
                    norm_topk: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``shard_map`` MoE over ``current_mesh()`` (see the module
    docstring). x3 is (B, T, d); returns (y (B, T, d), aux).

    Per (data, model) shard: route MY tokens, keep only the assignments to
    MY expert shard, compute them, then ONE psum over "model" combines the
    per-expert-shard partial outputs. aux is computed from each shard's
    tokens and averaged over the data shards (a psum over the batch axes
    divided by their size). The shards run on threads of their own,
    which start outside ``use_sharding_rules``: their hints are silent, as
    JAX's shard_map body has none.

    Under autograd the forward keeps each shard's graph, and the backward
    is a second region on the same mesh, the transpose JAX's ``shard_map``
    derives for these specs: each shard takes the vector-Jacobian product
    of its (y part, aux part) on that graph with ``torch.autograd.grad``
    (the forward's ops do not run again), then sums x's
    gradient over "model" (``grad_x``), the router's over every axis
    (``grad_router``) and each expert weight's over the batch axes
    (``grad_experts``, three a layer). Top-k indices carry no gradient: it
    flows through the gates and the router's probabilities, as in JAX.
    The kept graphs serve one backward: a second backward through the same
    output (``retain_graph=True``, a gradient penalty) raises; run the
    forward again for it.
    """
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("moe_ffn_sharded needs use_sharding_rules(..., mesh=...)")
    dispatch = _ShardedDispatch(mesh, p["router"].shape[-1], top_k, capacity_factor, norm_topk)
    args = (x3, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    return _ShardedMoE.apply(dispatch, keep, *args)
