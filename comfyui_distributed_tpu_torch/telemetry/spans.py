"""Span tracing: nested wall-clock spans with cross-HTTP trace stitching
(the port's copy of the JAX package's ``telemetry/spans.py``).

``span("denoise_step", job_id=...)`` opens a timed span; spans nest via a
``contextvars.ContextVar`` so asyncio handlers and plain call stacks both
get correct parent linkage without threading anything through signatures.
Every finished span is recorded into the process-global ``STORE`` (bounded
ring of traces) and its duration lands in the ``cdt_span_seconds{name=…}``
histogram.

Cross-host stitching: an active span context serializes into the
``X-CDT-Trace`` header (``trace_id:span_id``) via ``trace_headers()``; the
receiving side parses it (``parse_trace_header``) and enters the same
trace with ``use_trace(trace_id, parent_span_id)`` — so a master's
dispatch span and the worker's execution span share one trace ID and a
real parent/child edge, and ``/distributed/trace/{job_id}`` can assemble
both sides into one timeline.

The orchestration layer's existing ``exec_…`` trace IDs are adopted
verbatim (``span(..., trace_id=…)``), so log lines and span trees
correlate on the same key.
"""

from __future__ import annotations

import contextvars
import secrets
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Optional

from .registry import REGISTRY, enabled

TRACE_HEADER = "X-CDT-Trace"

# (trace_id, span_id) of the innermost active span; span_id may be "" when
# only a remote parent context was adopted (use_trace without a local span)
_CTX: "contextvars.ContextVar[Optional[tuple[str, str]]]" = \
    contextvars.ContextVar("cdt_trace", default=None)

_SPAN_SECONDS = REGISTRY.histogram(
    "cdt_span_seconds",
    "Wall-clock duration of telemetry spans, by span name.",
    ("name",))

# span attributes that double as lookup keys for /distributed/trace/{id}
_INDEX_ATTRS = ("job_id", "prompt_id")


def new_trace_id() -> str:
    return f"trace_{int(time.time() * 1000)}_{secrets.token_hex(3)}"


class SpanStore:
    """Bounded in-memory ring of finished spans, grouped by trace.

    Oldest traces are evicted first; a single trace is capped so a runaway
    loop cannot grow one entry without bound. ``resolve`` maps a job or
    prompt id (seen as a span attribute) back to its trace."""

    def __init__(self, max_traces: int = 256, max_spans: int = 512):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, list[dict]]" = OrderedDict()
        self._by_key: dict[str, str] = {}

    def record(self, span: dict) -> None:
        tid = span["trace_id"]
        with self._lock:
            spans = self._traces.get(tid)
            if spans is None:
                spans = self._traces[tid] = []
                while len(self._traces) > self.max_traces:
                    old_tid, _ = self._traces.popitem(last=False)
                    for k in [k for k, v in self._by_key.items()
                              if v == old_tid]:
                        del self._by_key[k]
            if len(spans) < self.max_spans:
                spans.append(span)
            for attr in _INDEX_ATTRS:
                v = span.get("attrs", {}).get(attr)
                if v:
                    self._by_key[str(v)] = tid

    def resolve(self, key: str) -> Optional[str]:
        """Trace id for a trace id, job id, or prompt id."""
        with self._lock:
            if key in self._traces:
                return key
            return self._by_key.get(key)

    def spans(self, trace_id: str) -> list[dict]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def tree(self, trace_id: str) -> list[dict]:
        """Nested span forest (roots may be plural: master and worker both
        contribute top-level spans to one trace)."""
        return span_tree(self.spans(trace_id))

    def reset(self) -> None:
        with self._lock:
            self._traces.clear()
            self._by_key.clear()


def span_tree(spans: list[dict]) -> list[dict]:
    """Nest spans by ``parent_id``, each level in start order; a span whose
    parent is not in the list is a root."""
    spans = sorted(spans, key=lambda s: s["start"])
    nodes = {s["span_id"]: {**s, "children": []} for s in spans}
    roots: list[dict] = []
    for s in spans:
        parent = nodes.get(s.get("parent_id") or "")
        target = parent["children"] if parent is not None else roots
        target.append(nodes[s["span_id"]])
    return roots


STORE = SpanStore()


@contextmanager
def span(name: str, trace_id: Optional[str] = None,
         parent_id: Optional[str] = None, **attrs):
    """Timed span context manager. No-op (yields ``None``) when telemetry
    is disabled — the guard is the first thing that runs, so the disabled
    hot path costs one boolean read.

    ``trace_id`` adopts an existing trace (e.g. the orchestrator's
    ``exec_…`` id); omitted, the span joins the ambient trace or starts a
    fresh one. ``parent_id`` overrides parent linkage for cross-process
    stitching (the worker's execution span parents onto the master's
    dispatch span id carried by ``X-CDT-Trace``)."""
    if not enabled():
        yield None
        return
    cur = _CTX.get()
    if trace_id is None:
        trace_id = cur[0] if cur else new_trace_id()
    if parent_id is None and cur and cur[0] == trace_id:
        parent_id = cur[1] or None
    span_id = secrets.token_hex(4)
    token = _CTX.set((trace_id, span_id))
    start = time.time()
    t0 = time.perf_counter()
    error = None
    try:
        yield (trace_id, span_id)
    except BaseException as e:
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        duration = time.perf_counter() - t0
        _CTX.reset(token)
        rec = {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "start": start,
            "duration_s": duration,
            "attrs": {k: str(v) for k, v in attrs.items()},
        }
        if error is not None:
            rec["error"] = error
        STORE.record(rec)
        _SPAN_SECONDS.labels(name=name).observe(duration)


@contextmanager
def use_trace(trace_id: str, parent_span_id: Optional[str] = None):
    """Adopt a remote trace context (parsed from ``X-CDT-Trace``) for the
    duration of the block: spans opened inside join ``trace_id`` with
    ``parent_span_id`` as their parent."""
    token = _CTX.set((trace_id, parent_span_id or ""))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_trace_id() -> Optional[str]:
    cur = _CTX.get()
    return cur[0] if cur else None


def current_span_id() -> Optional[str]:
    cur = _CTX.get()
    return (cur[1] or None) if cur else None


def trace_headers() -> dict:
    """``{"X-CDT-Trace": "trace_id:span_id"}`` for the active context, or
    ``{}`` — safe to splat into any outbound request's headers."""
    if not enabled():
        return {}
    cur = _CTX.get()
    if not cur:
        return {}
    tid, sid = cur
    return {TRACE_HEADER: f"{tid}:{sid}" if sid else tid}


def parse_trace_header(value) -> Optional[tuple[str, Optional[str]]]:
    """``"trace_id[:span_id]"`` → ``(trace_id, span_id | None)``; None on
    anything malformed (headers are peer-controlled input)."""
    if not isinstance(value, str) or not value or len(value) > 200:
        return None
    tid, _, sid = value.partition(":")
    tid = tid.strip()
    if not tid:
        return None
    return tid, (sid.strip() or None)
