"""Serving tier of the port: the plan/run API (``serve.plan``), the
schema-batched query engine and the LM decode engine (``serve.engine``)
and the async micro-batching server (``serve.queue``); counterpart of
``repro.serve``.

The plan names are imported eagerly (``infer_exact`` needs them);
the engines load lazily, as ``serve.engine`` imports the exact
inference engine, which imports ``serve.plan``.
"""

from repro_torch.serve.plan import CompiledPlan, PlanCache, PlanKey

__all__ = ["AsyncPGMServer", "CompiledPlan", "DecodeEngine", "PlanCache",
           "PlanKey", "PGMQuery", "PGMQueryEngine", "Request", "ServeTicket",
           "SwapHandle"]


def __getattr__(name):
    if name in ("DecodeEngine", "PGMQuery", "PGMQueryEngine", "Request"):
        from repro_torch.serve import engine

        return getattr(engine, name)
    if name in ("AsyncPGMServer", "ServeTicket", "SwapHandle"):
        from repro_torch.serve import queue

        return getattr(queue, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
