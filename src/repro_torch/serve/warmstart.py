"""Cross-process warm start: JSON plan manifests ("hot in seconds").

A serving replica's real cold-start cost is not process boot — it is the
first request against every (operator, config) pair paying for the
operator, the plan's set-up (preconditioner, pinned core, padded band)
and the first runner of each entry point. This module serializes a
running pool's recipes so a fresh process rebuilds all its plans at
startup instead of on first traffic:

    save_manifest("plans.json", server.plans())          # on any replica
    srv = SolverServer.from_manifest("plans.json")       # on a new one
    srv.submit(A, b)            # first request: no new runner

A manifest entry is ``(operator spec, plan.config(), plan.describe(),
operator fingerprint)``, the JAX package's format. Operator specs go
through a builder registry — the stencil/synthetic generators are
registered (tiny specs, data regenerated deterministically, bit for bit
the JAX package's), and any ``DIAMatrix`` falls back to inline band
storage. A builder is called as ``fn(**params, device=device)``. The
round-trip contract: a rebuilt plan's ``describe()`` matches the saved
one (sans trace counts) and its content fingerprint and pool routing key
are identical. A manifest the JAX package wrote loads too: its engine
names "jnp" and "pallas" read as the port's "torch" and "cuda".
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..obs import metrics as _metrics

__all__ = [
    "MANIFEST_VERSION",
    "build_operator",
    "load_manifest",
    "operator_spec",
    "register_operator_builder",
    "save_manifest",
    "warm_plan",
]

MANIFEST_VERSION = 1

_BUILDERS: Dict[str, Callable] = {}

# the JAX package's engine names -> the port's
_PORT_ENGINES = {"jnp": "torch", "pallas": "cuda"}


def register_operator_builder(name: str, fn: Callable, *, overwrite: bool = False) -> None:
    """Register ``fn(**params, device=...) -> operator`` for manifest specs."""
    if name in _BUILDERS and not overwrite:
        raise ValueError(
            f"operator builder {name!r} already registered; pass overwrite=True"
        )
    _BUILDERS[name] = fn


def _dia_inline(offsets, n, data, dtype="float32", *, device=None):
    from ..sparse import DIAMatrix
    from ..kernels.common import resolve_device

    t = torch.tensor(data, dtype=getattr(torch, dtype), device=resolve_device(device))
    return DIAMatrix(t, tuple(int(o) for o in offsets), int(n))


def _register_defaults() -> None:
    from ..sparse import (
        poisson7,
        poisson27,
        poisson125,
        poisson_dia,
        synthetic_spd_dia,
        table1_matrix,
    )

    for name, fn in [
        ("dia", _dia_inline),
        ("poisson7", poisson7),
        ("poisson27", poisson27),
        ("poisson125", poisson125),
        ("poisson_dia", poisson_dia),
        ("synthetic", synthetic_spd_dia),
        ("table1", table1_matrix),
    ]:
        if name not in _BUILDERS:
            _BUILDERS[name] = fn


def operator_spec(A, builder: Optional[str] = None, **params) -> dict:
    """The JSON spec a manifest stores for ``A``.

    With ``builder``/``params`` given, records that recipe verbatim (the
    cheap form — e.g. ``operator_spec(A, "poisson27", n=12)``; data is
    regenerated, not shipped). Otherwise a ``DIAMatrix`` is inlined —
    offsets + band data as lists — which round-trips exactly but scales
    with nnz; prefer a builder recipe for big operators.
    """
    from ..sparse import DIAMatrix

    if builder is not None:
        _register_defaults()
        if builder not in _BUILDERS:
            raise KeyError(f"unknown operator builder {builder!r}; "
                           f"have {sorted(_BUILDERS)}")
        return {"builder": builder, "params": params}
    if isinstance(A, DIAMatrix):
        return {
            "builder": "dia",
            "params": {
                "offsets": [int(o) for o in A.offsets],
                "n": int(A.n),
                "dtype": str(A.dtype).removeprefix("torch."),
                "data": A.data.cpu().tolist(),
            },
        }
    raise TypeError(
        f"cannot derive a manifest spec for {type(A).__name__}; pass "
        "builder=/params (register_operator_builder) for non-DIA operators"
    )


def build_operator(spec: dict, *, device=None):
    """Rebuild the operator a spec describes on ``device`` (None: CUDA)."""
    _register_defaults()
    name = spec["builder"]
    if name not in _BUILDERS:
        raise KeyError(f"unknown operator builder {name!r}; have {sorted(_BUILDERS)}")
    return _BUILDERS[name](**spec.get("params", {}), device=device)


def _describe_stable(plan) -> dict:
    """describe() minus process-local churn, JSON-normalized.

    Dropping ``trace_count`` and round-tripping through JSON (tuples ->
    lists) makes the dict directly comparable against a deserialized
    manifest entry.
    """
    d = dict(plan.describe())
    d.pop("trace_count", None)
    return json.loads(json.dumps(d, sort_keys=True, default=str))


def _port_names(d: dict, keys) -> dict:
    """``d`` with the JAX package's engine names read as the port's."""
    return {k: _PORT_ENGINES.get(v, v) if k in keys and isinstance(v, str) else v
            for k, v in d.items()}


def warm_plan(plan, max_batch: Optional[int]) -> None:
    """Build the runners a server will use: one single solve and, for a
    bucket size above 1, one batched solve, both of zero right-hand sides
    (a zero rhs converges at once, so this costs the set-up SPMVs)."""
    zeros = torch.zeros(plan.n, dtype=plan.A.dtype, device=plan.A.device)
    plan.solve(zeros)
    if max_batch and max_batch > 1:
        plan.solve_batched(zeros.expand(int(max_batch), plan.n).contiguous())


def save_manifest(path: str, plans: Iterable, *,
                  operator_specs: Optional[Dict[str, dict]] = None,
                  serve: Optional[dict] = None) -> dict:
    """Write the warm-start manifest for ``plans``; returns the dict.

    ``operator_specs`` maps operator fingerprints to builder recipes
    (``operator_spec(A, "poisson27", n=12)``) — plans whose fingerprint
    has no override fall back to inline DIA. ``serve`` carries serving
    configuration (e.g. ``max_batch``) so a replica warms the exact
    bucket runner it will use.
    """
    from ..plan import operator_fingerprint

    operator_specs = operator_specs or {}
    entries: List[dict] = []
    fps: Dict[int, str] = {}  # plans sharing an operator hash it once
    for p in plans:
        fp = fps.get(id(p.A)) or fps.setdefault(id(p.A), operator_fingerprint(p.A))
        if fp.startswith("id:"):
            raise ValueError(
                f"operator of plan {p.method!r} has no content fingerprint "
                "(matrix-free?); it cannot warm-start across processes"
            )
        spec = operator_specs.get(fp) or operator_spec(p.A)
        entries.append({
            "fingerprint": fp,
            "operator": spec,
            "config": p.config(),
            "describe": _describe_stable(p),
        })
    manifest = {"version": MANIFEST_VERSION, "serve": serve or {}, "plans": entries}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    _metrics.counter("serve.warmstart.saved_plans").inc(len(entries))
    return manifest


def load_manifest(path: str, *, warm: bool = True, max_batch: Optional[int] = None,
                  strict: bool = True, device=None) -> Tuple[list, dict]:
    """Rebuild every manifest plan on ``device`` (None: CUDA); returns
    ``([(plan, entry_dict)], serve_cfg)``.

    ``warm=True`` builds each plan's serving runners right here (see
    :func:`warm_plan`; the bucket size comes from ``max_batch`` or the
    manifest's serve config), so the first real request builds nothing.
    ``strict`` verifies the round-trip contract: the rebuilt fingerprint
    must match the saved one, and so must every key of the saved
    ``describe()`` (a JAX-written one lacks the port's ``device`` and
    ``spmv``).
    """
    import time as _time

    from ..plan import operator_fingerprint, plan as _plan

    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("version") != MANIFEST_VERSION:
        raise ValueError(
            f"manifest version {manifest.get('version')!r} != {MANIFEST_VERSION}"
        )
    serve_cfg = dict(manifest.get("serve", {}))
    if max_batch is None:
        max_batch = serve_cfg.get("max_batch")

    out = []
    ops: Dict[str, object] = {}  # fingerprint -> rebuilt operator (shared)
    for entry in manifest["plans"]:
        t0 = _time.perf_counter()
        fp = entry["fingerprint"]
        A = ops.get(fp)
        if A is None:
            A = ops[fp] = build_operator(entry["operator"], device=device)
            if strict and operator_fingerprint(A) != fp:
                raise ValueError(
                    f"rebuilt operator fingerprint {operator_fingerprint(A)!r} "
                    f"!= manifest {fp!r}; the spec does not reproduce the operator"
                )
        p = _plan(A, **_port_names(entry["config"], ("engine", "spmv_engine")))
        if strict:
            saved = _port_names(entry["describe"], ("engine", "core", "spmv_engine"))
            got = _describe_stable(p)
            diff = {k: (v, got.get(k)) for k, v in saved.items() if got.get(k) != v}
            if diff:
                raise ValueError(f"rebuilt plan describe() drifted: {diff}")
        if warm:
            warm_plan(p, max_batch)
        _metrics.histogram("serve.warmstart.plan_s").record(_time.perf_counter() - t0)
        _metrics.counter("serve.warmstart.loaded_plans").inc()
        out.append((p, entry))
    return out, serve_cfg
