"""Field validation of ``POST /distributed/queue`` (the JAX package's
``api/schemas.py``, the validators the queue route uses)."""

from __future__ import annotations

from typing import Any

from ..utils import constants
from ..utils.exceptions import ValidationError

MAX_TENANT_LEN = 64


def validate_tenant(value: Any) -> str:
    """Tenant id: a non-empty string, bounded."""
    if (not isinstance(value, str) or not value
            or len(value) > MAX_TENANT_LEN):
        raise ValidationError(
            f"'tenant' must be a non-empty string of at most "
            f"{MAX_TENANT_LEN} characters", field="tenant")
    return value


def validate_priority(value: Any) -> str:
    if value not in constants.PRIORITY_CLASSES:
        raise ValidationError(
            f"'priority' must be one of {list(constants.PRIORITY_CLASSES)}, "
            f"got {value!r}", field="priority")
    return value


def validate_cache_mode(value: Any) -> str:
    if value not in constants.CACHE_MODES:
        raise ValidationError(
            f"'cache' must be one of {list(constants.CACHE_MODES)}, got {value!r}",
            field="cache")
    return value


def validate_deadline_ms(value: Any) -> int:
    if isinstance(value, bool) or not isinstance(value, int) or value <= 0:
        raise ValidationError(
            "'deadline_ms' must be a positive integer (milliseconds)",
            field="deadline_ms")
    return value
