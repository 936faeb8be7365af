"""repro_torch.serve — LM serving, and batched + async solver serving over
the plan cache.

* ``engine``    — ``generate`` (prefill, then a greedy or sampled decode
  loop over the model's KV cache or recurrent state), ``prefill_cache``
  and ``make_decode_step``;
  ``SolverEngine``: synchronous bucket coalescing over one pinned plan.
* ``queue``     — bounded admission queue + bucket-closing batch policy
  (full OR timeout), explicit backpressure (``QueueFull``), deadlines.
* ``router``    — pool of warm ``SolverPlan``s keyed by (operator
  fingerprint, method, engine, tolerance bucket); async misses, LRU
  eviction with in-flight pinning.
* ``warmstart`` — JSON plan manifests: a fresh replica rebuilds every plan
  and its runners at startup ("hot in seconds").
* ``server``    — ``SolverServer``: the façade wiring them together.
"""
from .engine import (
    ServeConfig,
    SolverEngine,
    bucket_waste,
    generate,
    make_decode_step,
    prefill_cache,
    record_bucket,
)
from .queue import DeadlineExceeded, QueueFull, RequestQueue, ServerClosed, SolveRequest
from .router import PlanEntry, PlanPool, pool_key, tolerance_bucket
from .server import ServeResult, SolverServer
from .warmstart import (
    build_operator,
    load_manifest,
    operator_spec,
    register_operator_builder,
    save_manifest,
)

__all__ = [
    "DeadlineExceeded",
    "PlanEntry",
    "PlanPool",
    "QueueFull",
    "RequestQueue",
    "ServeConfig",
    "ServeResult",
    "ServerClosed",
    "SolveRequest",
    "SolverEngine",
    "SolverServer",
    "bucket_waste",
    "build_operator",
    "generate",
    "load_manifest",
    "make_decode_step",
    "operator_spec",
    "pool_key",
    "prefill_cache",
    "record_bucket",
    "register_operator_builder",
    "save_manifest",
    "tolerance_bucket",
]
