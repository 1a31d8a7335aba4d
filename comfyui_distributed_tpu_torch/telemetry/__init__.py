"""Observability on the standard library: metrics registry, span tracing,
export (the port's copy of the JAX package's ``telemetry/``).

- ``registry``: process-global, thread- and asyncio-safe Counter / Gauge
  / Histogram with frozen label tuples and a per-metric cardinality cap;
- ``spans``: nesting span context managers over a ``contextvars``
  context, stitched across HTTP by the ``X-CDT-Trace`` header;
- ``export``: Prometheus text exposition and structured JSON, both
  rendered from one ``snapshot()``.

``metrics`` declares the port's families; instrumentation sites import
those objects and guard every record with ``enabled()``:
``CDT_TELEMETRY=0`` turns the whole subsystem into one boolean read per
site. Served by ``GET /distributed/metrics`` (Prometheus),
``GET /distributed/metrics.json`` and ``GET /distributed/trace/{job_id}``
(the assembled span tree).
"""

from .registry import (BYTES_BUCKETS, COMPILE_BUCKETS, DURATION_BUCKETS,
                       Counter, Gauge, Histogram, MetricRegistry, REGISTRY,
                       enabled, set_enabled)
from .spans import (STORE as SPAN_STORE, TRACE_HEADER, current_span_id,
                    current_trace_id, parse_trace_header, span, span_tree,
                    trace_headers, use_trace)
from . import metrics  # noqa: F401  — declares the standard families

__all__ = [
    "BYTES_BUCKETS", "COMPILE_BUCKETS", "DURATION_BUCKETS",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "REGISTRY",
    "SPAN_STORE", "TRACE_HEADER", "current_span_id", "current_trace_id",
    "enabled", "metrics", "parse_trace_header", "set_enabled", "span",
    "span_tree", "trace_headers", "use_trace",
]
