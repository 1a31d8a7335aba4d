"""The controller's prompt queue: validate, enqueue, execute one job at a
time in one execution thread (the JAX package's ``cluster/runtime.py``).

Two job shapes ride the queue: solo prompts, and batch jobs from the
serving front door (``cluster/frontdoor``): N coalesced member prompts
run as one unit through the group executor, each member with its own
history entry (``batch_size``, and ``cache`` when the result tier served
it). The next job is the pending one of the highest priority class
(a batch job at its best member's), a parked resume before fresh work of
its class, then arrival order (``seq``, kept by a preempted job). A job
or member whose ``deadline_at`` passes is recorded ``expired``: when its
turn comes, and within ``CDT_PREEMPT_SWEEP_S`` while it waits (the
sweep). With stage-split serving attached (``queue.stages``,
``cluster/stages``) a batch job goes through the encode, denoise and
decode pools instead: the queue waits only for its denoise stage (span
``prompt.execute_batch_staged``), and each member's entry lands when its
decode is done, shaped as the fused path's (and ``decode_batch``).

Step-granular preemption (``queue.preemption``, ``cluster/preemption.py``)
is re-evaluated on every enqueue and start. A solo job that yields at a
segment boundary (``PreemptedError``) parks its checkpoint, is requeued
at its place and gets a non-terminal ``preempted`` history entry
(``preempted_at_step``, ``total_steps``, ``checkpoint_id``, ``reason``);
its final entry counts ``preemptions``. A failed restore
(``CheckpointRestoreError``) is retried up to
``CDT_PREEMPT_RESUME_RETRIES``, then the checkpoint is dead-lettered and
the job runs from scratch (history ``resume_retry`` / ``resume_scratch``
between, ``resume_ignored`` on the final entry). A parked job that is
interrupted, expires or fails releases its checkpoint.

The graph runs in the queue's one-thread pool, never on the event loop:
a node that talks to the control plane (the collector) hops back onto
the loop with ``run_in_loop`` while the loop goes on serving.

Each prompt runs under a ``prompt.execute`` span in its job's trace (the
orchestration's ``exec_…`` id; on a worker, the master's, under the
master's dispatch span from ``X-CDT-Trace``), a batch job under
``prompt.execute_batch``. ``run_in_executor`` does not carry
``contextvars`` into the pool thread, so the job's context is copied in:
the spans its nodes open (``pipeline_call``) join the trace. Terminal
statuses, durations, queue waits and depths go to ``cdt_prompts_total``,
``cdt_prompt_duration_seconds``, ``cdt_queue_wait_seconds``,
``cdt_prompt_queue_depth`` and ``cdt_fd_queue_depth``. Callbacks added
with ``add_job_done_callback`` run on the loop after every job (and
after an interrupt or the sweep drops pending ones): the front door
flushes its next group and settles coalesced waiters there.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import itertools
import secrets
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from .. import telemetry
from ..graph.executor import GraphExecutor, strip_meta, validate_prompt
from ..telemetry import metrics as _tm
from ..graph.node import NODE_REGISTRY, is_link
from ..utils import constants
from ..utils.logging import log, trace_info


@dataclasses.dataclass
class PromptJob:
    prompt_id: str
    prompt: dict
    client_id: str = ""
    trace_id: str | None = None
    # the master's dispatch span (X-CDT-Trace): the execution span's parent
    parent_span_id: str | None = None
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    # --- the serving front door (cluster/frontdoor) ---
    tenant: str = constants.DEFAULT_TENANT
    priority: str = constants.DEFAULT_PRIORITY
    # monotonic deadline: a job not started by then is recorded "expired"
    deadline_at: float | None = None
    # a batch job: its coalesced members (each with its own prompt id and
    # deadline) and each member's sampler node id; ``prompt`` is unused
    group: "list[PromptJob] | None" = None
    sampler_node_ids: dict | None = None
    # --- the content cache (cluster/cache) ---
    # the request's fingerprint (set by the front door for the
    # deterministic batchable class); "bypass" skips serving this member
    # from the result tier (it still fills it)
    fingerprint: str | None = None
    cache_mode: str = "use"
    # --- step-granular preemption (cluster/preemption.py) ---
    # the parked checkpoint to resume (set when this job was preempted, or
    # by a resume request); preempt_count bounds yielding
    # (CDT_PREEMPT_MAX), resume_attempts the restore retries
    checkpoint_id: str | None = None
    preempt_count: int = 0
    resume_attempts: int = 0
    # a checkpoint gone between enqueue and start (the job ran from scratch)
    resume_lost: str | None = None
    # arrival order within a class, given by _put; kept on a requeue
    seq: int = 0

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now >= self.deadline_at


class PromptQueue:
    """A priority-ordered prompt queue with a single execution thread:
    one job on the card at a time (a batch job raises the work per job,
    not the number of jobs at once)."""

    def __init__(self, context_factory: Callable[[], dict] | None = None):
        # jobs wait in _pending and are chosen at dequeue (_pop_next);
        # _wake gets one token a _put, and may hold more tokens than jobs
        # after an interrupt or a sweep: the consumer checks again
        self._pending: list[PromptJob] = []
        self._wake: asyncio.Queue[None] = asyncio.Queue()
        self._seq = itertools.count(1)
        self._context_factory = context_factory or (lambda: {})
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="graph-exec")
        self._task: Optional[asyncio.Task] = None
        self._sweep_task: Optional[asyncio.Task] = None
        self._executing: Optional[str] = None
        self.executing_job: Optional[PromptJob] = None
        self._interrupt = threading.Event()
        self.history: dict[str, dict] = {}
        self._job_done_callbacks: list[Callable[[], None]] = []
        self._pending_by_priority: dict[str, int] = {}
        # step-granular preemption (cluster/preemption.py), attached by the
        # controller; None: every solo job runs uninterrupted
        self.preemption = None
        # stage-split serving (cluster/stages), attached by the
        # controller; None: batch jobs take the fused group path
        self.stages = None

    # --- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())
        sweep_s = constants.preempt_sweep_s()
        if sweep_s > 0 and (self._sweep_task is None
                            or self._sweep_task.done()):
            self._sweep_task = asyncio.ensure_future(self._sweep_loop(sweep_s))

    async def stop(self) -> None:
        for task in (self._task, self._sweep_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._task = self._sweep_task = None
        # a prompt already running finishes in its thread; nothing new starts
        self._interrupt.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def add_job_done_callback(self, cb: Callable[[], None]) -> None:
        """Called on the event loop after every job finishes, and after
        an interrupt or the sweep drops pending jobs."""
        if cb not in self._job_done_callbacks:
            self._job_done_callbacks.append(cb)

    def _job_done(self) -> None:
        for cb in self._job_done_callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 — observer isolation
                pass

    # --- producer ----------------------------------------------------------

    def enqueue(self, prompt: dict, client_id: str = "",
                trace_id: str | None = None,
                parent_span_id: str | None = None,
                tenant: str = constants.DEFAULT_TENANT,
                priority: str = constants.DEFAULT_PRIORITY,
                deadline_at: float | None = None,
                checkpoint_id: str | None = None) -> tuple[str, list]:
        """Validate and enqueue; returns (prompt_id, node_errors). An
        invalid prompt never reaches the queue. ``checkpoint_id`` resumes
        a parked checkpoint: the sampler picks up mid-ladder."""
        prompt = strip_meta(prompt)
        errors = validate_prompt(prompt)
        if errors:
            return "", [e.as_dict() for e in errors]
        prompt_id = f"p_{int(time.time()*1000)}_{secrets.token_hex(3)}"
        self._put(PromptJob(prompt_id, prompt, client_id, trace_id,
                            parent_span_id, tenant=tenant,
                            priority=priority, deadline_at=deadline_at,
                            checkpoint_id=checkpoint_id))
        return prompt_id, []

    def enqueue_batch(self, members: "list[PromptJob]",
                      sampler_node_ids: dict) -> list[str]:
        """Enqueue one batch job of members the front door validated.
        Returns the member ids."""
        if not members:
            return []
        self._put(PromptJob(
            prompt_id=f"b_{int(time.time()*1000)}_{secrets.token_hex(3)}",
            prompt={}, group=list(members),
            sampler_node_ids=dict(sampler_node_ids),
            trace_id=members[0].trace_id,
            priority=min((m.priority for m in members),
                         key=_priority_rank)))
        return [m.prompt_id for m in members]

    def _put(self, job: PromptJob) -> None:
        if job.seq == 0:
            job.seq = next(self._seq)
        self._pending.append(job)
        self._wake.put_nowait(None)
        self._count_pending(job, +1)
        if telemetry.enabled():
            _tm.PROMPT_QUEUE_DEPTH.set(self.queue_remaining)
        if self.preemption is not None:
            # a higher class arriving behind a running job is the trigger
            self.preemption.reevaluate()
        self.start()

    def _pop_next(self) -> Optional[PromptJob]:
        if not self._pending:
            return None
        job = min(self._pending, key=_dequeue_key)
        self._pending.remove(job)
        return job

    def pending_best_rank(self) -> Optional[int]:
        """The best (lowest) priority rank waiting, a batch job at its
        best member's: the preemption trigger."""
        ranks = [min(_priority_rank(m.priority) for m in (job.group or [job]))
                 for job in self._pending]
        return min(ranks) if ranks else None

    def _count_pending(self, job: PromptJob, sign: int) -> None:
        for m in (job.group or [job]):
            n = self._pending_by_priority.get(m.priority, 0) + sign
            self._pending_by_priority[m.priority] = max(0, n)
        if telemetry.enabled():
            for prio, n in self._pending_by_priority.items():
                _tm.FD_QUEUE_DEPTH.labels(stage="queued", priority=prio).set(n)

    def _discard_parked(self, job: PromptJob) -> None:
        """A job dropped from the queue (interrupt, deadline, error)
        releases its parked checkpoint: no store bytes or gauge slot
        leak."""
        if self.preemption is None:
            return
        for m in (job.group or [job]):
            if m.checkpoint_id:
                self.preemption.discard(m)

    def expire_stale(self, now: float | None = None) -> int:
        """Record ``expired`` every queued job whose deadline passed (a
        batch job once all its members' have; execution expires the rest
        one by one). A parked job, whose history is non-terminal, expires
        as a fresh one does and releases its checkpoint. Returns the
        members expired."""
        if now is None:
            now = time.monotonic()
        expired = 0
        for job in list(self._pending):
            members = job.group or [job]
            stale = [m for m in members if m.expired(now)
                     and self.history.get(m.prompt_id, {}).get("status")
                     not in TERMINAL_STATUSES]
            if not stale or len(stale) < len(members):
                continue
            self._pending.remove(job)
            for m in members:
                self.history[m.prompt_id] = {
                    "status": "expired", "duration": 0.0,
                    "error": "deadline_ms elapsed while queued"}
                expired += 1
                log(f"prompt {m.prompt_id} expired in queue (sweep)")
            self._discard_parked(job)
            self._count_pending(job, -1)
            if telemetry.enabled():
                _tm.PROMPTS_TOTAL.labels(status="expired").inc(len(members))
                _tm.PROMPT_QUEUE_DEPTH.set(self.queue_remaining)
        if expired:
            self._job_done()
        return expired

    async def _sweep_loop(self, interval_s: float) -> None:
        while True:
            await asyncio.sleep(interval_s)
            self.expire_stale()

    def interrupt(self) -> int:
        """Drop the pending jobs into history as ``interrupted`` (each
        batch member counts) and flag the running one, which stops before
        its next node (a node already running finishes). Returns the
        number dropped."""
        dropped = 0
        for job in list(self._pending):
            self._pending.remove(job)
            for m in (job.group or [job]):
                self.history[m.prompt_id] = {"status": "interrupted",
                                             "duration": 0.0}
                dropped += 1
            self._discard_parked(job)
            self._count_pending(job, -1)
        if self._executing:
            self._interrupt.set()
        if dropped:
            # the dropped jobs reached history without the consumer loop:
            # a coalesced waiter on one of them must still settle
            self._job_done()
        return dropped

    @property
    def queue_remaining(self) -> int:
        return len(self._pending) + (1 if self._executing else 0)

    @property
    def executing(self) -> Optional[str]:
        return self._executing

    # --- consumer ----------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._wake.get()
            job = self._pop_next()
            if job is None:
                continue        # an interrupt or the sweep took it
            self._executing = job.prompt_id
            self.executing_job = job
            self._interrupt.clear()
            started = time.monotonic()
            statuses: list[str] = []   # stays empty when the queue is stopped
            try:
                if telemetry.enabled():
                    for m in (job.group or [job]):
                        _tm.QUEUE_WAIT_SECONDS.labels(
                            priority=m.priority).observe(
                                started - m.enqueued_at)
                if self.preemption is not None:
                    # a higher class may already wait as a lower job starts
                    self.preemption.reevaluate()
                if job.group is not None:
                    statuses = await self._run_group(loop, job, started)
                else:
                    statuses = [await self._run_solo(loop, job, started)]
            finally:
                self._executing = None
                self.executing_job = None
                if self.preemption is not None:
                    self.preemption.end(job)
                self._count_pending(job, -1)
                if telemetry.enabled():
                    # terminal statuses only: a staged member counts when
                    # its decode is done (_record_staged_member), a
                    # preempted job when it finally ends
                    terminal = [s for s in statuses
                                if s in TERMINAL_STATUSES]
                    for status in terminal:
                        _tm.PROMPTS_TOTAL.labels(status=status).inc()
                    if terminal and len(terminal) == len(statuses):
                        _tm.PROMPT_SECONDS.observe(time.monotonic() - started)
                    _tm.PROMPT_QUEUE_DEPTH.set(self.queue_remaining)
                self._job_done()

    def _requeue(self, job: PromptJob, record: dict) -> None:
        """A non-terminal history entry and the job back in the queue at
        its place (its ``seq`` kept), its wait clock restarted."""
        self.history[job.prompt_id] = record
        job.enqueued_at = time.monotonic()
        # before _put: its reevaluate must not see the job as running
        self.executing_job = None
        self._put(job)

    async def _run_solo(self, loop, job: PromptJob, started: float) -> str:
        if job.expired(started):
            self.history[job.prompt_id] = {
                "status": "expired", "duration": 0.0,
                "error": "deadline_ms elapsed before execution",
            }
            log(f"prompt {job.prompt_id} expired in queue")
            self._discard_parked(job)
            return "expired"
        from ..diffusion.checkpoint import (CheckpointRestoreError,
                                            PreemptedError)

        token = None
        try:
            context = dict(self._context_factory())
            context["interrupt_event"] = self._interrupt
            context["prompt_id"] = job.prompt_id
            if self.preemption is not None:
                token = self.preemption.begin(job)
                if token is not None:
                    context["preemption"] = token
            with telemetry.span("prompt.execute", trace_id=job.trace_id,
                                parent_id=job.parent_span_id,
                                prompt_id=job.prompt_id):
                ctx = contextvars.copy_context()
                outputs = await loop.run_in_executor(
                    self._pool, ctx.run, GraphExecutor(context).execute,
                    job.prompt)
            entry = {
                "status": "success",
                "duration": time.monotonic() - started,
                "outputs": {nid: out for nid, out in outputs.items()
                            if _is_terminal(job.prompt, nid)},
            }
            if job.preempt_count:
                entry["preemptions"] = job.preempt_count
            if job.resume_lost:
                entry["resume_lost"] = job.resume_lost
            self.history[job.prompt_id] = entry
            if self.preemption is not None:
                if (job.checkpoint_id and token is not None
                        and token.resume is not None
                        and not token.resume_consumed):
                    # no preemptible sampler took the checkpoint (img2img,
                    # a ControlNet graph): a success, but not a resume
                    log(f"prompt {job.prompt_id} IGNORED its resume "
                        f"checkpoint {job.checkpoint_id} (the graph has no "
                        "preemptible sampler) — ran from scratch")
                    entry["resume_ignored"] = True
                    self.preemption.discard(job)
                else:
                    self.preemption.resolve_success(job)
            trace_info(job.trace_id,
                       f"prompt {job.prompt_id} done in "
                       f"{entry['duration']:.2f}s")
            return "success"
        except PreemptedError as e:
            # an intentional departure: park, requeue at the job's place,
            # a non-terminal entry (pollers keep waiting, as for a queued
            # job); nothing is lost
            cid = self.preemption.park(job, e.checkpoint, e.reason)
            self._requeue(job, {
                "status": "preempted",
                "preempted_at_step": e.checkpoint.step,
                "total_steps": e.checkpoint.total_steps,
                "checkpoint_id": cid, "reason": e.reason,
                "duration": time.monotonic() - started})
            return "preempted"
        except CheckpointRestoreError as e:
            verdict = self.preemption.restore_failed(job, str(e))
            log(f"prompt {job.prompt_id} checkpoint restore failed ({e}) "
                f"-> {verdict}")
            if verdict == "scratch":
                job.resume_lost = job.resume_lost or "dead-lettered"
            self._requeue(job, {
                "status": ("resume_retry" if verdict == "retry"
                           else "resume_scratch"),
                "error": str(e), "duration": time.monotonic() - started})
            return "resume_failed"
        except InterruptedError:
            self.history[job.prompt_id] = {
                "status": "interrupted",
                "duration": time.monotonic() - started,
            }
            log(f"prompt {job.prompt_id} interrupted")
            self._discard_parked(job)
            return "interrupted"
        except Exception as e:  # noqa: BLE001 — one prompt's failure is its own
            self.history[job.prompt_id] = {
                "status": "error", "error": str(e),
                "duration": time.monotonic() - started,
            }
            log(f"prompt {job.prompt_id} failed: {e!r}\n"
                f"{traceback.format_exc()}")
            self._discard_parked(job)
            return "error"

    async def _run_group(self, loop, job: PromptJob,
                         started: float) -> list[str]:
        """A front-door batch job: expire the stale members, run the rest
        through the group executor, record each member's history. Every
        member id ends with a history entry."""
        from .frontdoor.microbatch import execute_group

        live: list[PromptJob] = []
        statuses: list[str] = []
        for m in job.group:
            if m.expired(started):
                self.history[m.prompt_id] = {
                    "status": "expired", "duration": 0.0,
                    "error": "deadline_ms elapsed before execution",
                }
                statuses.append("expired")
            else:
                live.append(m)
        if not live:
            return statuses
        if self.stages is not None and self.stages.eligible(job):
            staged = await self._run_group_staged(loop, job, live, started)
            if staged is not None:
                return statuses + staged
        try:
            # the context is built inside the barrier: its failure errors
            # the members instead of stopping the consumer loop
            context = dict(self._context_factory())
            context["interrupt_event"] = self._interrupt
            with telemetry.span("prompt.execute_batch",
                                trace_id=job.trace_id,
                                prompt_id=job.prompt_id, batch=len(live)):
                ctx = contextvars.copy_context()
                results = await loop.run_in_executor(
                    self._pool, ctx.run, execute_group,
                    live, job.sampler_node_ids, context)
        except Exception as e:  # noqa: BLE001 — group isolation
            log(f"batch {job.prompt_id} failed: {e}")
            results = {m.prompt_id: {"status": "error", "error": str(e)}
                       for m in live}
        duration = time.monotonic() - started
        for m in live:
            entry = results.get(m.prompt_id, {"status": "interrupted"})
            status = entry.get("status", "error")
            record = {"status": status, "duration": duration,
                      "batch_size": entry.get("batch_size")}
            if entry.get("cache"):
                # served by the result tier (cluster/cache)
                record["cache"] = entry["cache"]
            if entry.get("error"):
                record["error"] = entry["error"]
            if status == "success":
                record["outputs"] = {
                    nid: out
                    for nid, out in (entry.get("outputs") or {}).items()
                    if _is_terminal(m.prompt, nid)}
            self.history[m.prompt_id] = record
            statuses.append(status)
        trace_info(job.trace_id,
                   f"batch {job.prompt_id} ({len(live)} member(s)) done "
                   f"in {duration:.2f}s")
        return statuses

    async def _run_group_staged(self, loop, job: PromptJob,
                                live: "list[PromptJob]",
                                started: float) -> "list[str] | None":
        """A batch job through the stage pools: encode → denoise →
        decode. The queue waits only for the denoise stage, so its slot
        frees when the card does and the next job's sampler overlaps
        this one's decode. Each member's history lands from the stages
        (``_record_staged_member``). Returns non-terminal ``"staged"``
        markers, or None when the submission itself failed (the fused
        path then runs the group)."""
        try:
            context = dict(self._context_factory())
            context["interrupt_event"] = self._interrupt
            denoise_done = loop.create_future()

            def record(member, entry, last) -> None:
                self._record_staged_member(member, entry, last, started)

            self.stages.submit_group(
                job, live,
                {m.prompt_id: job.sampler_node_ids[m.prompt_id]
                 for m in live},
                context, loop, denoise_done, record)
        except Exception as e:  # noqa: BLE001 — the fused path still serves
            log(f"stages: submit of batch {job.prompt_id} failed "
                f"({e!r}); falling back to fused execution")
            return None
        with telemetry.span("prompt.execute_batch_staged",
                            trace_id=job.trace_id,
                            prompt_id=job.prompt_id, batch=len(live)):
            await denoise_done
        trace_info(job.trace_id,
                   f"batch {job.prompt_id} ({len(live)} member(s)) "
                   f"denoise done in {time.monotonic() - started:.2f}s "
                   "(decode in flight)")
        return ["staged"] * len(live)

    def _record_staged_member(self, member: PromptJob, entry: dict,
                              last: bool, started: float) -> None:
        """One staged member's terminal history (on the loop, marshalled
        from a stage thread), shaped as the fused ``_run_group``'s, so
        pollers, the coalescer and the job-done callbacks cannot tell the
        paths apart."""
        status = entry.get("status", "error")
        record = {"status": status,
                  "duration": time.monotonic() - started,
                  "batch_size": entry.get("batch_size")}
        if entry.get("decode_batch"):
            record["decode_batch"] = entry["decode_batch"]
        if entry.get("cache"):
            record["cache"] = entry["cache"]
        if entry.get("error"):
            record["error"] = entry["error"]
        if status == "success":
            record["outputs"] = {
                nid: out
                for nid, out in (entry.get("outputs") or {}).items()
                if _is_terminal(member.prompt, nid)}
        self.history[member.prompt_id] = record
        if telemetry.enabled():
            if status in TERMINAL_STATUSES:
                _tm.PROMPTS_TOTAL.labels(status=status).inc()
            if last:
                # the group's end to end, decode included: the quantity
                # the fused path observes once a group
                _tm.PROMPT_SECONDS.observe(record["duration"])
        self._job_done()


# one terminal-status vocabulary for every history observer
TERMINAL_STATUSES = frozenset({"success", "error", "interrupted",
                               "expired"})


def _priority_rank(priority: str) -> int:
    try:
        return constants.PRIORITY_CLASSES.index(priority)
    except ValueError:
        return len(constants.PRIORITY_CLASSES)


def _dequeue_key(job: PromptJob) -> tuple:
    """Dequeue order: priority class (a batch job at its best member's),
    a parked resume before fresh work of its class, then arrival."""
    rank = min(_priority_rank(m.priority) for m in (job.group or [job]))
    return (rank, 0 if job.checkpoint_id else 1, job.seq)


def _is_terminal(prompt: dict, nid: str) -> bool:
    """An output node, or a node nothing in the prompt consumes."""
    cls = NODE_REGISTRY.get(prompt.get(nid, {}).get("class_type", ""))
    if cls is None:
        return False
    consumed = {
        v[0] for node in prompt.values()
        for v in node.get("inputs", {}).values()
        if is_link(v)
    }
    return cls.OUTPUT_NODE or nid not in consumed
