"""``POST /distributed/queue`` payload parsing, with the JAX package's
fields, defaults and errors (``api/queue_request.py``): ``workers`` is
accepted as a legacy alias of ``enabled_worker_ids``.

``tenant``, ``priority``, ``deadline_ms`` and ``cache`` are validated as
there, and the serving front door acts on them (``cluster/frontdoor``):
admission by tenant and priority, ``expired`` history past the deadline,
the result tier used or bypassed (``near`` reads as ``use`` until the
near tier, which comes with the fleet cache, A.6a). With
``CDT_FRONTDOOR=0`` they are validated and not acted on, as on the JAX
package's path without the front door. ``checkpoint_id`` (a checkpoint
parked on this controller) or ``checkpoint`` (its wire form inline)
resumes a preempted run (``cluster/preemption.resolve_resume``, on both
paths); a bad one is rejected, never run from scratch in silence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..utils import constants
from ..utils.exceptions import ValidationError
from .schemas import (validate_cache_mode, validate_checkpoint_id,
                      validate_checkpoint_payload, validate_deadline_ms,
                      validate_priority, validate_tenant)


@dataclasses.dataclass(frozen=True)
class QueueRequestPayload:
    prompt: dict
    client_id: str = ""
    enabled_worker_ids: Optional[tuple[str, ...]] = None
    delegate_master: Optional[bool] = None
    load_balance: bool = False
    trace_id: Optional[str] = None
    tenant: str = constants.DEFAULT_TENANT
    priority: str = constants.DEFAULT_PRIORITY
    deadline_ms: Optional[int] = None
    cache: str = "use"
    # step-granular preemption: a checkpoint parked here, or one inline
    checkpoint_id: Optional[str] = None
    checkpoint: Optional[dict] = None


def parse_queue_request_payload(payload: Any) -> QueueRequestPayload:
    if not isinstance(payload, dict):
        raise ValidationError("payload must be a JSON object")
    prompt = payload.get("prompt")
    if not isinstance(prompt, dict) or not prompt:
        raise ValidationError("'prompt' must be a non-empty object", field="prompt")

    ids = payload.get("enabled_worker_ids")
    if ids is None:
        ids = payload.get("workers")       # legacy alias
    if ids is not None:
        if not isinstance(ids, (list, tuple)) or not all(
            isinstance(i, str) for i in ids
        ):
            raise ValidationError(
                "'enabled_worker_ids' must be a list of strings",
                field="enabled_worker_ids",
            )
        ids = tuple(ids)

    delegate = payload.get("delegate_master")
    if delegate is not None and not isinstance(delegate, bool):
        raise ValidationError("'delegate_master' must be a boolean",
                              field="delegate_master")

    client_id = payload.get("client_id", "")
    if not isinstance(client_id, str):
        raise ValidationError("'client_id' must be a string", field="client_id")

    tenant = validate_tenant(payload.get("tenant", constants.DEFAULT_TENANT))
    priority = validate_priority(
        payload.get("priority", constants.DEFAULT_PRIORITY))
    deadline_ms = payload.get("deadline_ms")
    if deadline_ms is not None:
        deadline_ms = validate_deadline_ms(deadline_ms)
    cache = validate_cache_mode(payload.get("cache", "use"))

    checkpoint_id = payload.get("checkpoint_id")
    if checkpoint_id is not None:
        checkpoint_id = validate_checkpoint_id(checkpoint_id)
    checkpoint = payload.get("checkpoint")
    if checkpoint is not None:
        checkpoint = validate_checkpoint_payload(checkpoint)

    return QueueRequestPayload(
        prompt=prompt,
        client_id=client_id,
        enabled_worker_ids=ids,
        delegate_master=delegate,
        load_balance=bool(payload.get("load_balance", False)),
        trace_id=payload.get("trace_id") or None,
        tenant=tenant,
        priority=priority,
        deadline_ms=deadline_ms,
        cache=cache,
        checkpoint_id=checkpoint_id,
        checkpoint=checkpoint,
    )
