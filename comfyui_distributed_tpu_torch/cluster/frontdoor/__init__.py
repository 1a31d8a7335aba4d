"""The serving front door (the port's ``cluster/frontdoor``, after the
JAX package's): the layer between ``POST /distributed/queue`` and the
orchestrator.

- :mod:`admission` gates the door: priority classes, per-tenant token
  buckets, depth backpressure and explicit overload shedding (HTTP 429
  + ``Retry-After``), scaled by the circuit breakers' health.
- :mod:`classifier` decides whether a request can be microbatched (one
  ``TPUTxt2Img`` over a statically known geometry) and under which
  :class:`~.classifier.GroupKey` same-shape requests coalesce.
- A byte-identical twin of a request in flight rides that execution
  (``cluster/cache/coalesce.py``).
- :mod:`batcher` holds batchable requests in a short per-key window and
  flushes same-shape groups to the prompt queue as one batch job,
  highest priority first.
- :mod:`microbatch` executes a flushed group: per-member prefixes, one
  ``generate_microbatch`` call, per-member suffixes, the result tier.

Requests that cannot be batched go through the orchestrator as before,
carrying their tenant, priority and deadline into the queue.
``CDT_FRONTDOOR=0`` removes the subsystem. With stage-split serving
(``cluster/stages``) a flushed group runs through the stage pools, whose
backlog joins admission's depth. A resume request (``checkpoint_id`` or
an inline ``checkpoint``, ``cluster/preemption.resolve_resume``) is a
solo trajectory by definition: it skips classification and batching and
rides the orchestration path with its checkpoint id.
"""

from __future__ import annotations

import asyncio
import dataclasses
import secrets
import time
from typing import Optional

from ... import telemetry
from ...telemetry import metrics as _tm
from ...utils import constants
from ...utils.logging import log
from ..runtime import PromptJob, PromptQueue
from .admission import AdmissionController, Decision
from .batcher import CoalescingBatcher
from .classifier import Classification, classify
from .classifier import fingerprint as classifier_fingerprint


def frontdoor_enabled() -> bool:
    return constants.frontdoor()


@dataclasses.dataclass
class FrontDoorResult:
    """What ``POST /distributed/queue`` answers with.

    ``outcome``: ``admitted`` | ``queued`` | ``shed``. A shed result
    carries ``retry_after_s`` and never a prompt id; an admitted one the
    member's or the orchestration's prompt id (or ``node_errors``)."""

    outcome: str
    prompt_id: str = ""
    node_errors: list = dataclasses.field(default_factory=list)
    worker_count: int = 0
    trace_id: str = ""
    batched: bool = False
    reason: str = ""
    retry_after_s: float = 0.0
    # the request joined a byte-identical execution in flight and never
    # entered the queue
    coalesced: bool = False


class FrontDoor:
    """Admission → classification → coalescing, one per controller,
    started on the controller's event loop."""

    def __init__(self, queue: PromptQueue, orchestrator, cache=None,
                 stages=None):
        self.queue = queue
        self.orchestrator = orchestrator
        # stage-split serving frees queue slots at denoise-done: its
        # backlog must count, or overload piles up in the decode pool
        self.stages = stages
        # in-flight coalescing happens here, before the batcher: a twin of
        # a queued request never takes a second queue slot
        self.cache = cache
        self.admission = AdmissionController(depth_provider=self.depth)
        inflight = constants.fd_inflight()
        # the capacity gate is continuous batching: while this many batch
        # jobs sit in the queue, ready groups keep absorbing arrivals
        self.batcher = CoalescingBatcher(
            self._enqueue_group,
            capacity=lambda: queue.queue_remaining < inflight)
        self._task: Optional[asyncio.Task] = None
        self._classified: dict[str, int] = {}   # reason -> count

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self.batcher.run())
        # a finished job frees a queue slot: the next ready group flushes
        # at once, and waiters whose leader is done settle
        self.queue.add_job_done_callback(self._on_job_done)

    def _on_job_done(self) -> None:
        self.batcher.wake()
        if self.cache is not None:
            self.cache.coalescer.resolve(self.queue.history,
                                         redispatch=self._redispatch)

    def _redispatch(self, member, group_key, sampler_node_id) -> None:
        """A waiter whose leader expired runs afresh: it leads its
        fingerprint and goes back through the batcher."""
        if member.fingerprint is not None:
            self.cache.coalescer.lead(member.fingerprint, member.prompt_id)
        self.batcher.submit(group_key, member,
                            sampler_node_id=sampler_node_id)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    # --- signals ------------------------------------------------------------

    def depth(self) -> int:
        """What admission sheds on: queued or executing prompts, the
        requests coalescing here and the stage pools' host-side
        backlog."""
        depth = self.queue.queue_remaining + self.batcher.pending_count
        if self.stages is not None:
            depth += self.stages.depth()
        return depth

    def denoise_depth(self) -> int:
        """The denoise-facing depth: queued or executing prompts and the
        requests coalescing here. The autoscaler sizes the card fleet on
        it; the stage pools' backlog wants host threads, not cards."""
        return self.queue.queue_remaining + self.batcher.pending_count

    # --- the door -----------------------------------------------------------

    async def submit(self, payload) -> FrontDoorResult:
        """Admit, classify and route one queue request (an
        ``api.queue_request.QueueRequestPayload``)."""
        decision: Decision = self.admission.admit(payload.tenant,
                                                  payload.priority)
        if decision.outcome == "shed":
            return FrontDoorResult(outcome="shed", reason=decision.reason,
                                   retry_after_s=decision.retry_after_s)

        deadline_at = (time.monotonic() + payload.deadline_ms / 1000.0
                       if payload.deadline_ms else None)
        from ..preemption import resolve_resume

        checkpoint_id = resolve_resume(self.queue.preemption,
                                       payload.checkpoint_id,
                                       payload.checkpoint)
        if checkpoint_id is not None:
            cls = Classification(batchable=False, reason="resume")
        else:
            cls = classify(payload.prompt)
        self._classified[cls.reason] = self._classified.get(cls.reason, 0) + 1

        if not cls.batchable:
            meta = {"tenant": payload.tenant, "priority": payload.priority,
                    "deadline_at": deadline_at}
            if checkpoint_id is not None:
                meta["checkpoint_id"] = checkpoint_id
            result = await self.orchestrator.orchestrate(
                payload.prompt,
                client_id=payload.client_id,
                enabled_ids=payload.enabled_worker_ids,
                delegate_master=payload.delegate_master,
                load_balance=payload.load_balance,
                trace_id=payload.trace_id,
                queue_meta=meta,
            )
            return FrontDoorResult(
                outcome=decision.outcome, prompt_id=result.prompt_id,
                node_errors=result.node_errors,
                worker_count=result.worker_count,
                trace_id=result.trace_id, reason=cls.reason)

        # batchable: validate now (the orchestration path rejects an
        # invalid prompt at once; coalescing must not defer that into a
        # history-only error), then coalesce
        from ...graph.executor import strip_meta, validate_prompt
        from ...utils.logging import new_trace_id

        prompt = strip_meta(payload.prompt)
        errors = validate_prompt(prompt)
        if errors:
            return FrontDoorResult(outcome=decision.outcome,
                                   node_errors=[e.as_dict() for e in errors],
                                   reason=cls.reason)
        trace_id = payload.trace_id or new_trace_id()
        fingerprint = classifier_fingerprint(prompt)
        member = PromptJob(
            prompt_id=f"p_{int(time.time()*1000)}_{secrets.token_hex(3)}",
            prompt=prompt, client_id=payload.client_id,
            trace_id=trace_id,
            tenant=payload.tenant, priority=payload.priority,
            deadline_at=deadline_at,
            fingerprint=fingerprint, cache_mode=payload.cache,
        )
        if self.cache is not None and payload.cache != "bypass":
            if self.cache.coalescer.join(fingerprint, member,
                                         group_key=cls.group_key,
                                         sampler_node_id=cls.sampler_node_id):
                # a twin is in flight: this request rides it, and its own
                # history entry lands with the leader's
                return FrontDoorResult(outcome=decision.outcome,
                                       prompt_id=member.prompt_id,
                                       trace_id=trace_id, batched=True,
                                       coalesced=True, reason=cls.reason)
            self.cache.coalescer.lead(fingerprint, member.prompt_id)
        self.batcher.submit(cls.group_key, member,
                            sampler_node_id=cls.sampler_node_id)
        if telemetry.enabled():
            _tm.FD_QUEUE_DEPTH.labels(
                stage="coalescing", priority=payload.priority).set(
                    self.batcher.pending_by_priority().get(
                        payload.priority, 0))
        return FrontDoorResult(outcome=decision.outcome,
                               prompt_id=member.prompt_id,
                               trace_id=trace_id,
                               batched=True, reason=cls.reason)

    # --- plumbing -----------------------------------------------------------

    def _enqueue_group(self, members: list, sampler_node_ids: dict) -> None:
        self.queue.enqueue_batch(members, sampler_node_ids)
        if telemetry.enabled():
            for prio, n in self.batcher.pending_by_priority().items():
                _tm.FD_QUEUE_DEPTH.labels(stage="coalescing",
                                          priority=prio).set(n)

    def stats(self) -> dict:
        """The ``GET /distributed/frontdoor`` payload."""
        return {
            "enabled": True,
            "depth": self.depth(),
            "queue_remaining": self.queue.queue_remaining,
            "coalescing": self.batcher.pending_count,
            "pending_by_priority": self.batcher.pending_by_priority(),
            "groups": self.batcher.group_summary(),
            "admission": self.admission.summary(),
            "classified": dict(self._classified),
            "window_ms": self.batcher.window_ms,
            "max_batch": self.batcher.max_batch,
            "cache": (None if self.cache is None
                      else {"hit_rate": round(self.cache.hit_rate(), 4),
                            **self.cache.coalescer.stats()}),
            "stages": (None if self.stages is None
                       else self.stages.depths()),
        }


def build_frontdoor(queue: PromptQueue, orchestrator, cache=None,
                    stages=None) -> Optional[FrontDoor]:
    """The controller's front door, or None under ``CDT_FRONTDOOR=0``."""
    if not frontdoor_enabled():
        log("front door disabled (CDT_FRONTDOOR=0) — legacy queue path")
        return None
    return FrontDoor(queue, orchestrator, cache=cache, stages=stages)
