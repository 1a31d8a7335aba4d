"""Field validation of the routes (the JAX package's ``api/schemas.py``,
the validators the port's routes use)."""

from __future__ import annotations

from typing import Any

from ..utils import constants
from ..utils.exceptions import ValidationError

MAX_TENANT_LEN = 64
MAX_WORKER_ID_LEN = 128


def require_fields(payload: Any, *fields: str) -> None:
    if not isinstance(payload, dict):
        raise ValidationError("payload must be a JSON object")
    for f in fields:
        if f not in payload or payload[f] in (None, ""):
            raise ValidationError(f"missing required field {f!r}", field=f)


def validate_worker_id(value: Any) -> str:
    if not isinstance(value, str) or not value or len(value) > MAX_WORKER_ID_LEN:
        raise ValidationError(f"invalid worker id {value!r}", field="worker_id")
    return value


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


# --- step-granular preemption (cluster/preemption.py) -------------------------

MAX_CHECKPOINT_ID_LEN = 128


def validate_checkpoint_id(value: Any) -> str:
    """A resume request's checkpoint id: a bounded string with no path
    separators (it names a store key and a file of the persisted tier)."""
    if (not isinstance(value, str) or not value
            or len(value) > MAX_CHECKPOINT_ID_LEN
            or any(c in value for c in "/\\\0") or ".." in value):
        raise ValidationError(
            "'checkpoint_id' must be a non-empty string of at most "
            f"{MAX_CHECKPOINT_ID_LEN} characters with no path "
            "separators", field="checkpoint_id")
    return value


def validate_checkpoint_payload(value: Any) -> dict:
    """An inline checkpoint's wire form: its shape checked here, its
    checksum when it is imported. The sha256 is required."""
    if (not isinstance(value, dict)
            or not isinstance(value.get("data"), str)
            or not isinstance(value.get("sha256"), str)
            or not value["sha256"]):
        raise ValidationError(
            "'checkpoint' must be an object with base64 'data' and "
            "'sha256' fields", field="checkpoint")
    return value
