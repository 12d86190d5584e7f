"""repro_torch.obs — unified telemetry for the reconciliation stack.

One typed metrics registry (``Recorder`` + ``SCHEMA``, DESIGN.md §14)
absorbing every layer's ad-hoc stats ledger behind derived snapshots, and
one zero-dep span tracer (``Tracer``/``NULL_TRACER``) exporting JSONL and
Chrome-trace timelines of the whole serving stack.
"""
from .metrics import SCHEMA, MetricSpec, MetricsError, Recorder
from .trace import NULL_TRACER, NullTracer, Tracer, load_events

__all__ = [
    "SCHEMA",
    "MetricSpec",
    "MetricsError",
    "Recorder",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "load_events",
]
