"""Shared filesystem-name hygiene (the port's copy of the JAX package's
``utils/names.py``).

One sanitizer for every place a client- or job-derived string becomes a
path component (profiler trace names, tile-journal keys, shipped-workflow
lookups) — duplicated security-sensitive logic drifts.
"""

from __future__ import annotations

from .exceptions import ValidationError

_ALLOWED = set("-_.")


def sanitize_name(name: str, max_len: int = 120, fallback: str = "item") -> str:
    """Coerce to a safe single path component: non [alnum-_.] chars become
    '_', length capped; never empty, never a dot-only name."""
    out = "".join(c if (c.isalnum() or c in _ALLOWED) else "_"
                  for c in str(name))[:max_len]
    if not out or set(out) <= {"."}:
        return fallback
    return out


def validate_name(name: str, max_len: int = 120) -> str:
    """Strict variant: reject instead of coerce (for lookups where a
    coerced name would silently resolve to a different resource)."""
    if (not name or len(name) > max_len or ".." in name
            or not all(c.isalnum() or c in _ALLOWED for c in name)
            or set(name) <= {"."}):
        raise ValidationError(f"invalid name {name!r}")
    return name
