"""Exporters: Prometheus text exposition + structured JSON (the port's
copy of the JAX package's ``telemetry/export.py``).

Both render the one ``MetricRegistry.snapshot()`` form, so the two views
can never disagree about what was measured.
"""

from __future__ import annotations

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    v = float(value)
    if v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labelstr(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition format 0.0.4 of a registry snapshot."""
    lines: list[str] = []
    for name in sorted(snapshot):
        m = snapshot[name]
        lines.append(f"# HELP {name} {_escape_help(m.get('help', ''))}")
        lines.append(f"# TYPE {name} {m['type']}")
        for s in m["series"]:
            labels = s.get("labels", {})
            if m["type"] == "histogram":
                for le, cum in s["buckets"]:
                    lines.append(
                        f"{name}_bucket"
                        f"{_labelstr(labels, {'le': _fmt(le)})} {cum}")
                lines.append(
                    f"{name}_bucket{_labelstr(labels, {'le': '+Inf'})} "
                    f"{s['count']}")
                lines.append(f"{name}_sum{_labelstr(labels)} "
                             f"{_fmt(s['sum'])}")
                lines.append(f"{name}_count{_labelstr(labels)} "
                             f"{s['count']}")
            else:
                lines.append(f"{name}{_labelstr(labels)} "
                             f"{_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


def render_json(snapshot: dict) -> dict:
    """Structured JSON form (the dashboard's feed): the snapshot verbatim
    under a ``metrics`` key, with a schema marker for forward-compat."""
    return {"format": "cdt.metrics.v1", "metrics": snapshot}
