"""Batched serving engines.

LM serving: ``generate`` prefills a batch of prompts once, then decodes
token by token (greedy, or sampled with a temperature) through the
model's cache: a KV cache, a recurrent state (ssm), or both (hybrid);
encdec and vlm carry ``enc_out`` or ``img_feats`` beside their KV caches.
JAX runs the decode loop as one ``lax.while_loop``; here
it is a Python loop over ``api.decode`` that reads the device only to
stop early once every row has emitted ``eos_id``.

Solver serving: ``SolverEngine`` wraps one ``repro_torch.plan`` —
operator, preconditioner and pinned core are built at construction — and
serves many right-hand sides: single solves run the plan's single-rhs
runner, batches its lane-batched one, and ``max_batch`` coalesces
arbitrary request batches into fixed-size zero-padded buckets, so
steady-state traffic builds exactly two runners (single + bucket)
whatever the arrival pattern.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.attention import KVCache
from ..models.zoo import ModelApi
from ..obs import metrics as _metrics
from ..obs.trace import enabled as _obs_enabled, span as _span

__all__ = [
    "ServeConfig",
    "SolverEngine",
    "bucket_waste",
    "generate",
    "make_decode_step",
    "prefill_cache",
    "record_bucket",
]


@dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1          # -1 => never stop early


def make_decode_step(api: ModelApi):
    """decode_step(params, token, cache, pos): one step of the model's decode."""

    def decode_step(params, token, cache, pos):
        return api.decode(params, token, cache, pos)

    return decode_step


def _sample(lg: torch.Tensor, temperature: float, generator: torch.Generator) -> torch.Tensor:
    """Greedy at temperature 0, else one draw from softmax(lg / temperature)
    by Gumbel-max, as ``jax.random.categorical`` draws."""
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(lg / temperature + gumbel, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(api: ModelApi, params, batch: dict, sc: ServeConfig = ServeConfig(),
             generator: Optional[torch.Generator] = None, poll_every: int = 8) -> torch.Tensor:
    """Prefill on batch["tokens"] (B, T) and the family's extras, then
    generate sc.max_new_tokens more on the parameters' device (the batch is
    moved there). Returns
    (B, T + max_new_tokens) int32: the prompt, the prefill's argmax, then
    the decoded tokens but the last.

    A row that has emitted ``eos_id`` repeats its last token; once every
    row has, the loop stops and the rest stays 0, as JAX's ``while_loop``
    leaves it. Every step writes 0 where all rows were done before it, so
    the host's check of ``done`` every ``poll_every`` steps only ends the
    loop early and never changes the result. ``generator`` (on the
    parameters' device; seed 0 if None) draws the samples where JAX takes
    ``key``.
    """
    dev = next(params.parameters()).device
    batch = {k: v.to(dev) for k, v in batch.items()}  # the prompt and the family's extras
    tokens = batch["tokens"]
    B, T = tokens.shape
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)

    logits, cache = prefill_cache(api, params, batch, T + sc.max_new_tokens)
    last = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    del logits

    out = torch.zeros((B, sc.max_new_tokens), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok = last
    for i in range(sc.max_new_tokens):
        if sc.eos_id >= 0 and i and i % poll_every == 0 and bool(done.all()):
            break
        live = ~done.all()  # JAX's loop condition for this step
        lg, cache = api.decode(params, tok[:, None], cache, T + i)
        nxt = _sample(lg[:, 0].to(torch.float32), sc.temperature, generator)
        nxt = torch.where(done, tok, nxt)
        done = done | (nxt == sc.eos_id)
        out[:, i] = torch.where(live, nxt, 0)
        tok = nxt
    return torch.cat([tokens.to(torch.int32), last[:, None], out[:, :-1]], dim=1)


@torch.no_grad()
def prefill_cache(api: ModelApi, params, batch: dict, max_seq: int):
    """``api.prefill`` over batch["tokens"] (B, T), its k/v spliced into the
    first T positions of a zero cache of ``max_seq`` on the logits' device:
    (logits (B, T, V), the cache ``api.decode`` steps from position T). The
    SSM family's state has no positions: the prefill's is the cache. The
    hybrid family's recurrent states are the prefill's, and only its
    shared block's KV caches are allocated at ``max_seq``; so are only the
    self-attention caches of the encdec family (beside the prefill's
    ``enc_out``) and of the vlm family (beside the batch's ``img_feats``).
    No zero state is allocated only to be dropped."""
    B, T = batch["tokens"].shape
    logits, pf_cache = api.prefill(params, batch)
    fam = api.cfg.family
    if fam == "ssm":
        return logits, pf_cache
    field = {"hybrid": "attn_kv", "encdec": "self_kv", "vlm": "self_kv"}.get(fam)
    pf_kv = pf_cache if field is None else getattr(pf_cache, field)
    L, _, _, KV, hd = pf_kv.k.shape
    kv = KVCache(*(t.new_zeros((L, B, max_seq, KV, hd)) for t in pf_kv))
    kv.k[:, :, :T] = pf_kv.k
    kv.v[:, :, :T] = pf_kv.v
    return logits, kv if field is None else pf_cache._replace(**{field: kv})


def record_bucket(valid: int, size: int) -> None:
    """Per-bucket occupancy accounting, shared by every batching path.

    One call per bucket execution: ``valid`` live rhs out of ``size``
    lanes. Feeds the ``serve.buckets`` / ``serve.padded_lanes`` counters
    and the ``serve.batch_occupancy`` histogram, the numbers the async
    tier's batcher and ``SolverEngine`` both report.
    """
    _metrics.counter("serve.buckets").inc()
    _metrics.counter("serve.padded_lanes").inc(size - valid)
    _metrics.histogram("serve.batch_occupancy").record(valid / size)


def bucket_waste(iters, step: int) -> int:
    """Lane-iterations wasted by each bucket's shared worst-case stop.

    ``iters`` are per-rhs iteration counts in submission order; lanes ride
    until the slowest rhs of their own ``step``-sized bucket stops, so the
    per-bucket ``max - it`` sum is pure occupancy waste.
    """
    iters = np.asarray(iters).ravel()
    step = max(int(step), 1)
    return sum(
        int((grp.max() - grp).sum())
        for lo in range(0, len(iters), step)
        if len(grp := iters[lo : lo + step])
    )


def _concat(results):
    """One SolveResult from bucket results, lanes in order (steps add up:
    the host ran the buckets one after another)."""
    first = results[0]
    return dataclasses.replace(
        first,
        **{f: torch.cat([getattr(r, f) for r in results])
           for f in ("x", "iterations", "residual_norm", "converged", "history")},
        steps=sum(r.steps for r in results),
    )


class SolverEngine:
    """Serve many right-hand sides against one pinned ``SolverPlan``.

        eng = SolverEngine(A, method="pipecg", atol=1e-6)
        res  = eng.solve(b)            # one rhs, the single runner
        many = eng.solve_batch(B)      # (k, n): one lane-batched loop

    ``max_batch`` turns on request coalescing: incoming batches are split
    into buckets of exactly ``max_batch`` rhs (the final partial bucket is
    zero-padded to size; a zero lane converges at once and is dropped from
    the result), so any traffic pattern runs the same two runners.
    ``serve.server.SolverServer`` puts an admission queue, a batching
    policy and a plan-pool router in front of the same bucket economics.
    """

    def __init__(self, A, M="jacobi", method: str = "pipecg", engine: str = "auto",
                 atol: float = 1e-5, rtol: float = 0.0, maxiter: int = 10000,
                 max_batch: Optional[int] = None, **method_kwargs):
        from ..plan import plan

        if max_batch is not None and max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.plan = plan(A, method=method, engine=engine, M=M, atol=atol, rtol=rtol,
                         maxiter=maxiter, **method_kwargs)
        self.max_batch = max_batch

    @property
    def A(self):
        return self.plan.A

    def describe(self) -> dict:
        d = self.plan.describe()
        d["max_batch"] = self.max_batch
        return d

    def solve(self, b: torch.Tensor):
        """Solve for a single rhs ``b`` of shape (n,)."""
        _metrics.counter("serve.requests").inc()
        with _span("serve.solve", n=b.shape[0]):
            return self.plan.solve(b)

    def solve_batch(self, bs: torch.Tensor):
        """Solve a batch of rhs, shape (k, n) -> SolveResult with leading k.

        A bucket runs to its slowest rhs, but the returned ``iterations``
        are honest per-rhs counts, from the first NaN of each ``history``
        row. The ``serve.*`` occupancy and waste metrics price mixing rhs
        of different difficulty in one bucket.
        """
        k = bs.shape[0]
        _metrics.counter("serve.requests").inc(k)
        with _span("serve.solve_batch", k=k):
            out = self._solve_batch_impl(bs)
        return self._with_per_rhs_iterations(out)

    def _solve_batch_impl(self, bs: torch.Tensor):
        if self.max_batch is None or bs.shape[0] == 0:
            # one un-split bucket of size k: still a bucket execution, so it
            # still reports occupancy (full, no pads)
            if bs.shape[0]:
                record_bucket(bs.shape[0], bs.shape[0])
            return self.plan.solve_batched(bs)
        k = bs.shape[0]
        chunks = []
        for lo in range(0, k, self.max_batch):
            chunk = bs[lo : lo + self.max_batch]
            valid = chunk.shape[0]
            pad = self.max_batch - valid
            if pad:  # coalesce the remainder into the same bucket runner
                chunk = torch.cat([chunk, chunk.new_zeros(pad, bs.shape[1])])
            record_bucket(valid, self.max_batch)
            res = self.plan.solve_batched(chunk)
            chunks.append(dataclasses.replace(
                res, **{f: getattr(res, f)[:valid] for f in
                        ("x", "iterations", "residual_norm", "converged", "history")}))
        return _concat(chunks)

    def _with_per_rhs_iterations(self, out):
        """Replace ``iterations`` with per-rhs counts from the NaN tails
        (computed on the device, no host sync). With observability on, also
        records the per-rhs spread and the lane-iterations wasted by each
        bucket's shared worst-case stop."""
        hist = out.history
        if hist.dim() < 2 or hist.shape[0] == 0:
            return out
        per_rhs = ((~hist.isnan()).sum(dim=-1) - 1).clamp_min(0).to(torch.int32)
        out = dataclasses.replace(out, iterations=per_rhs)
        if _obs_enabled():
            iters = per_rhs.cpu().numpy()
            for it in iters:
                _metrics.histogram("serve.rhs_iterations").record(int(it))
            step = len(iters) if self.max_batch is None else self.max_batch
            _metrics.counter("serve.wasted_lane_iterations").inc(bucket_waste(iters, step))
        return out
