"""Process-global metrics registry: Counter / Gauge / Histogram (the
port's copy of the JAX package's ``telemetry/registry.py``).

Standard library only: the telemetry core must be importable from
anything, including the standalone worker monitor, which may run from a
bare file path.

Thread/async safety: child creation and every mutation happen under the
owning metric's lock (asyncio handlers and the graph-executor thread both
record into the same families). The hot-path guard is ``enabled()`` — one
module-global boolean read — so a disabled deployment (``CDT_TELEMETRY=0``)
pays a single attribute load per instrumentation site and nothing else:
no clock reads, no label lookups, no lock traffic.

Label sets are frozen at declaration (``labelnames``); per-series children
are keyed by the tuple of label *values* in declaration order. Cardinality
is capped per metric (``MAX_SERIES``): past the cap, new label sets
collapse into one ``~overflow~`` series and the drop is counted — a
runaway label (e.g. a per-request id) can degrade resolution but can
never leak memory without bound.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence

from ..utils.constants import telemetry

_enabled = telemetry()


def enabled() -> bool:
    """The cheap hot-path guard: instrumentation sites check this before
    doing any work (clock reads, serialization, label lookups)."""
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


# Fixed log-scale buckets (1-2.5-5 per decade) — chosen once so histograms
# from different hosts always merge bucket-for-bucket.
DURATION_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 150.0)
# compiles regularly take minutes on big models
COMPILE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0,
                   150.0, 300.0, 600.0, 1800.0)
BYTES_BUCKETS = (256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
                 1048576.0, 4194304.0, 16777216.0, 67108864.0, 268435456.0)

MAX_SERIES = 256
_OVERFLOW = "~overflow~"


class _CounterValue:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount

    def snap(self) -> dict:
        return {"value": self.value}


class _GaugeValue:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def snap(self) -> dict:
        return {"value": self.value}


class _HistogramValue:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, bounds: Sequence[float]):
        self._lock = lock
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not _enabled:
            return
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def snap(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum
        cum = 0
        buckets = []
        for le, c in zip(self.bounds, counts):
            cum += c
            buckets.append([le, cum])
        return {"buckets": buckets, "sum": s, "count": total}


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        self._dropped = 0
        if not self.labelnames:
            self._children[()] = self._make_value()

    def _make_value(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= MAX_SERIES:
                    self._dropped += 1
                    key = (_OVERFLOW,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is None:
                        child = self._children[key] = self._make_value()
                    return child
                child = self._children[key] = self._make_value()
            return child

    # --- label-less convenience (mirrors prometheus_client) ----------------

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; "
                "use .labels(...)")
        return self._children[()]

    def series(self) -> list[tuple[dict, dict]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.labelnames, key)), child.snap())
                for key, child in items]

    def _reset(self) -> None:
        with self._lock:
            self._children = {}
            self._dropped = 0
            if not self.labelnames:
                self._children[()] = self._make_value()


class Counter(_Metric):
    kind = "counter"

    def _make_value(self):
        return _CounterValue(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _make_value(self):
        return _GaugeValue(self._lock)

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Optional[Sequence[float]] = None):
        self.buckets = tuple(sorted(buckets or DURATION_BUCKETS))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        super().__init__(name, help, labelnames)

    def _make_value(self):
        return _HistogramValue(self._lock, self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)


class MetricRegistry:
    """Name-keyed metric collection; get-or-create is idempotent so every
    instrumentation site can declare the family it needs without import-
    order coupling (a re-declaration with a different type or label set is
    a programming error and raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        f"type/labels (have {type(m).__name__}"
                        f"{m.labelnames})")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def snapshot(self) -> dict:
        """Structured export form — the single source both renderers
        (Prometheus text and JSON) consume."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        dropped = 0
        for m in metrics:
            dropped += m._dropped
            out[m.name] = {
                "type": m.kind,
                "help": m.help,
                "labelnames": list(m.labelnames),
                "series": [{"labels": labels, **snap}
                           for labels, snap in m.series()],
            }
        out["cdt_telemetry_series_dropped_total"] = {
            "type": "counter",
            "help": "Label sets collapsed into the overflow series by the "
                    "per-metric cardinality cap.",
            "labelnames": [],
            "series": [{"labels": {}, "value": float(dropped)}],
        }
        return out

    def reset(self) -> None:
        """Zero every series in place (test isolation). Metric OBJECTS are
        kept — module-level references held by instrumentation sites stay
        valid."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()


REGISTRY = MetricRegistry()
