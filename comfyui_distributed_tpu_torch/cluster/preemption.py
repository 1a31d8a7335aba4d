"""Step-granular preemption (the port's copy of the JAX package's
``cluster/preemption.py``): an interactive request does not wait behind
a whole batch job.

The queue's solo lane runs ``TPUTxt2Img`` in resumable K-step segments
(``diffusion/pipeline.generate_preemptible``). Between segments the
running job asks its :class:`PreemptionToken` whether to yield; this
controller answers:

- **priority**: a strictly higher priority class waits in the prompt
  queue (re-evaluated on every enqueue and every start);
- **drain** or **manual**: :meth:`PreemptionController.preempt_executing`
  (an operator, or a leaving worker; drain outranks priority).

A preempted job parks its ``LatentCheckpoint`` in the
``CheckpointStore`` and is requeued at its original position (it keeps
its ``seq``): an intentional departure, no error. It resumes at its next
dequeue here, or on another controller of the port through the
checkpoint routes or an inline ``checkpoint`` on ``POST
/distributed/queue``, bitwise an uninterrupted run. Failed restores are
bounded (``CDT_PREEMPT_RESUME_RETRIES``); then the checkpoint is
dead-lettered and the job runs from scratch, flagged in its history.

Starvation guard: a job preempted ``CDT_PREEMPT_MAX`` times stops
yielding to priority (a drain still preempts it). Batch jobs of the
front door are one group call and not preemptible, as in the JAX
package.
"""

from __future__ import annotations

import threading
from typing import Optional

from .. import telemetry
from ..diffusion.checkpoint import (CheckpointStore, LatentCheckpoint,
                                    require_torch_backend)
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.logging import log


def preempt_enabled() -> bool:
    return constants.preempt()


def _priority_rank(priority: str) -> int:
    # the queue's rank: ordering and preemption never disagree on what
    # "higher priority" means
    from .runtime import _priority_rank as rank

    return rank(priority)


class PreemptionToken:
    """What the sampler node reads from its context (hidden input
    ``preemption``): the segment length, the checkpoint to resume (or
    None), and ``should_preempt()``, asked between segments from the
    graph thread."""

    def __init__(self, controller: "PreemptionController", job,
                 resume: Optional[LatentCheckpoint], preemptible: bool):
        self._controller = controller
        self._job = job
        self.resume = resume
        self.preemptible = preemptible
        self.segment_steps = constants.preempt_segment_steps()
        # set by the sampler node when it feeds ``resume`` to the segmented
        # path: a graph that ignores the token did not resume
        self.resume_consumed = False

    def should_preempt(self) -> Optional[str]:
        reason = self._controller.requested_reason(self._job.prompt_id)
        if reason is None:
            return None
        if not self.preemptible and reason != "drain":
            # the starvation guard; a drain must free the slot regardless
            return None
        return reason


class PreemptionController:
    """One per controller, bound to its prompt queue
    (``queue.preemption``)."""

    def __init__(self, queue, store: Optional[CheckpointStore] = None):
        self.queue = queue
        self.store = store if store is not None else CheckpointStore()
        self._lock = threading.RLock()
        self._requests: dict[str, str] = {}      # prompt id → reason
        self._parked: set[str] = set()
        self.counts = {"preempted": 0, "resumed": 0, "restore_failed": 0,
                       "dead_lettered": 0, "preempt_requests": 0}

    # --- a job's run (the prompt queue calls these) --------------------------

    def begin(self, job) -> Optional[PreemptionToken]:
        """A token for a starting solo job; None for a batch job (one
        group call) or with preemption off."""
        if not preempt_enabled() or job.group is not None:
            return None
        resume = None
        if job.checkpoint_id:
            resume = self.store.get(job.checkpoint_id)
            if resume is None:
                # evicted or corrupt since it was queued: said loudly, and
                # flagged in the job's history by the queue
                log(f"preemption: checkpoint {job.checkpoint_id} for "
                    f"{job.prompt_id} is gone — restarting from scratch")
                job.resume_lost = job.checkpoint_id
                job.checkpoint_id = None
            else:
                self.store.pin(job.checkpoint_id)
        preemptible = job.preempt_count < constants.preempt_max()
        return PreemptionToken(self, job, resume, preemptible)

    def end(self, job) -> None:
        with self._lock:
            self._requests.pop(job.prompt_id, None)
        if getattr(job, "checkpoint_id", None):
            self.store.unpin(job.checkpoint_id)

    def resolve_success(self, job) -> None:
        """A terminal success: the parked state, if any, is spent."""
        if job.checkpoint_id:
            self.store.mark_restored(job.checkpoint_id)
            if self.store.drop(job.checkpoint_id):
                with self._lock:
                    self.counts["resumed"] += 1
            job.checkpoint_id = None
        self._unpark(job.prompt_id)

    def discard(self, job) -> None:
        """A parked job left the queue without resuming (interrupt,
        deadline, error): its checkpoint and its gauge slot go."""
        if getattr(job, "checkpoint_id", None):
            self.store.drop(job.checkpoint_id)
            job.checkpoint_id = None
        self._unpark(job.prompt_id)

    # --- verdicts -------------------------------------------------------------

    def requested_reason(self, prompt_id: str) -> Optional[str]:
        with self._lock:
            return self._requests.get(prompt_id)

    def reevaluate(self) -> None:
        """The priority rule, on every enqueue and start: preempt the
        running solo job when a strictly higher class waits."""
        job = getattr(self.queue, "executing_job", None)
        if job is None or job.group is not None:
            return
        best = self.queue.pending_best_rank()
        if best is None or best >= _priority_rank(job.priority):
            return
        self._request(job.prompt_id, "priority")

    def preempt_executing(self, reason: str = "manual") -> Optional[str]:
        """Ask the running solo job to yield regardless of priority;
        returns its prompt id, or None."""
        job = getattr(self.queue, "executing_job", None)
        if job is None or job.group is not None:
            return None
        self._request(job.prompt_id, reason)
        return job.prompt_id

    def _request(self, prompt_id: str, reason: str) -> None:
        with self._lock:
            current = self._requests.get(prompt_id)
            # drain outranks priority and manual
            if current == reason or current == "drain":
                return
            self._requests[prompt_id] = reason
            self.counts["preempt_requests"] += 1

    # --- parking and resuming -------------------------------------------------

    def park(self, job, ckpt: LatentCheckpoint, reason: str) -> str:
        """A job yielded at a boundary: park its state, count it, mark the
        job to resume."""
        ckpt.meta.setdefault("prompt_id", job.prompt_id)
        if job.checkpoint_id:
            # preempted again after a resume: the consumed state goes
            self.store.drop(job.checkpoint_id)
        cid = self.store.park(ckpt)
        job.checkpoint_id = cid
        job.preempt_count += 1
        with self._lock:
            self._requests.pop(job.prompt_id, None)
            self._parked.add(job.prompt_id)
            self.counts["preempted"] += 1
        if telemetry.enabled():
            _tm.PREEMPTIONS_TOTAL.labels(reason=reason).inc()
        self._export_gauge()
        log(f"preempted {job.prompt_id} at step {ckpt.step}/"
            f"{ckpt.total_steps} ({reason}) -> checkpoint {cid}")
        return cid

    def restore_failed(self, job, error: str) -> str:
        """A resume failed: ``"retry"`` (requeue with the checkpoint) or
        ``"scratch"`` (dead-lettered: requeue without it)."""
        job.resume_attempts += 1
        with self._lock:
            self.counts["restore_failed"] += 1
        if job.checkpoint_id:
            self.store.unpin(job.checkpoint_id)
        attempts = self.store.record_restore_failure(
            job.checkpoint_id or "?", error)
        if job.checkpoint_id is None or attempts >= self.store.resume_retries:
            with self._lock:
                self.counts["dead_lettered"] += 1
            job.checkpoint_id = None
            job.resume_attempts = 0
            self._unpark(job.prompt_id)
            return "scratch"
        return "retry"

    def _unpark(self, prompt_id: str) -> None:
        with self._lock:
            self._parked.discard(prompt_id)
        self._export_gauge()

    def _export_gauge(self) -> None:
        if telemetry.enabled():
            with self._lock:
                n = len(self._parked)
            _tm.JOBS_PREEMPTED.set(n)

    def stats(self) -> dict:
        """The ``GET /distributed/preemption`` payload."""
        with self._lock:
            counts = dict(self.counts)
            requests = dict(self._requests)
            parked = sorted(self._parked)
        return {"enabled": preempt_enabled(),
                "segment_steps": constants.preempt_segment_steps(),
                "parked_jobs": parked, "requests": requests,
                "store": self.store.stats(), **counts}


def import_checkpoint(preemption: "PreemptionController",
                      payload: dict) -> tuple[str, LatentCheckpoint]:
    """Park a wire-form checkpoint (its checksum verified, another
    backend's refused); returns its local id and the checkpoint. Raises
    ``CheckpointError``."""
    ckpt = LatentCheckpoint.from_payload(payload)
    require_torch_backend(ckpt)
    return preemption.store.park(ckpt), ckpt


def resolve_resume(preemption: Optional[PreemptionController],
                   checkpoint_id: Optional[str],
                   checkpoint_payload: Optional[dict]) -> Optional[str]:
    """The one resume policy of both queue entrances (the front door and
    the path without it): the checkpoint id to resume, an inline
    wire-form checkpoint imported first. A resume request against a
    controller without preemption, a corrupt or foreign payload, or an
    id this controller does not hold, is refused (``ValidationError``),
    never run from scratch in silence."""
    if checkpoint_id is None and checkpoint_payload is None:
        return None
    from ..diffusion.checkpoint import CheckpointError
    from ..utils.exceptions import ValidationError

    if preemption is None:
        raise ValidationError(
            "this worker has preemption disabled (CDT_PREEMPT=0); it "
            "cannot resume checkpoints", field="checkpoint_id")
    if checkpoint_payload is not None:
        try:
            return import_checkpoint(preemption, checkpoint_payload)[0]
        except CheckpointError as e:
            raise ValidationError(str(e), field="checkpoint") from None
    if checkpoint_id not in preemption.store:
        raise ValidationError(
            f"checkpoint {checkpoint_id!r} is not parked here: post it to "
            "/distributed/checkpoint first, or send it inline as "
            "'checkpoint'", field="checkpoint_id")
    return checkpoint_id


def build_preemption(queue) -> Optional[PreemptionController]:
    """The controller's preemption, or None under ``CDT_PREEMPT=0``."""
    if not preempt_enabled():
        log("preemption disabled (CDT_PREEMPT=0) — uninterrupted sampler "
            "runs")
        return None
    return PreemptionController(queue)
