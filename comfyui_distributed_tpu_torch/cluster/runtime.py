"""The controller's prompt queue: validate, enqueue, execute one job at a
time in one execution thread (the JAX package's ``cluster/runtime.py``
without stages, preemption, the priority-ordered dequeue and the
deadline sweep, which are A.3c and A.4).

Two job shapes ride the queue, first in first out: solo prompts, and
batch jobs from the serving front door (``cluster/frontdoor``): N
coalesced member prompts run as one unit through the group executor,
each member with its own history entry (``batch_size``, and ``cache``
when the result tier served it). A job or member whose ``deadline_at``
passed before it started is recorded ``expired`` instead of run.

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
after an interrupt drops pending ones): the front door flushes its next
group and settles coalesced waiters there.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
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

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now >= self.deadline_at


class PromptQueue:
    """FIFO prompt queue with a single execution thread: one job on the
    card at a time (a batch job raises the work per job, not the number
    of jobs at once)."""

    def __init__(self, context_factory: Callable[[], dict] | None = None):
        self._pending: asyncio.Queue[PromptJob] = asyncio.Queue()
        self._context_factory = context_factory or (lambda: {})
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="graph-exec")
        self._task: Optional[asyncio.Task] = None
        self._executing: Optional[str] = None
        self._interrupt = threading.Event()
        self.history: dict[str, dict] = {}
        self._job_done_callbacks: list[Callable[[], None]] = []
        self._pending_by_priority: dict[str, int] = {}

    # --- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # a prompt already running finishes in its thread; nothing new starts
        self._interrupt.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def add_job_done_callback(self, cb: Callable[[], None]) -> None:
        """Called on the event loop after every job finishes, and after
        an interrupt drops pending jobs."""
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
                deadline_at: float | None = None) -> tuple[str, list]:
        """Validate and enqueue; returns (prompt_id, node_errors). An
        invalid prompt never reaches the queue."""
        prompt = strip_meta(prompt)
        errors = validate_prompt(prompt)
        if errors:
            return "", [e.as_dict() for e in errors]
        prompt_id = f"p_{int(time.time()*1000)}_{secrets.token_hex(3)}"
        self._put(PromptJob(prompt_id, prompt, client_id, trace_id,
                            parent_span_id, tenant=tenant,
                            priority=priority, deadline_at=deadline_at))
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
        self._pending.put_nowait(job)
        self._count_pending(job, +1)
        self.start()
        if telemetry.enabled():
            _tm.PROMPT_QUEUE_DEPTH.set(self.queue_remaining)

    def _count_pending(self, job: PromptJob, sign: int) -> None:
        for m in (job.group or [job]):
            n = self._pending_by_priority.get(m.priority, 0) + sign
            self._pending_by_priority[m.priority] = max(0, n)
        if telemetry.enabled():
            for prio, n in self._pending_by_priority.items():
                _tm.FD_QUEUE_DEPTH.labels(stage="queued", priority=prio).set(n)

    def interrupt(self) -> int:
        """Drop the pending jobs into history as ``interrupted`` (each
        batch member counts) and flag the running one, which stops before
        its next node (a node already running finishes). Returns the
        number dropped."""
        dropped = 0
        while True:
            try:
                job = self._pending.get_nowait()
            except asyncio.QueueEmpty:
                break
            for m in (job.group or [job]):
                self.history[m.prompt_id] = {"status": "interrupted",
                                             "duration": 0.0}
                dropped += 1
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
        return self._pending.qsize() + (1 if self._executing else 0)

    @property
    def executing(self) -> Optional[str]:
        return self._executing

    # --- consumer ----------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            job = await self._pending.get()
            self._executing = job.prompt_id
            self._interrupt.clear()
            started = time.monotonic()
            statuses: list[str] = []   # stays empty when the queue is stopped
            try:
                if telemetry.enabled():
                    for m in (job.group or [job]):
                        _tm.QUEUE_WAIT_SECONDS.labels(
                            priority=m.priority).observe(
                                started - m.enqueued_at)
                if job.group is not None:
                    statuses = await self._run_group(loop, job, started)
                else:
                    statuses = [await self._run_solo(loop, job, started)]
            finally:
                self._executing = None
                self._count_pending(job, -1)
                if telemetry.enabled():
                    for status in statuses:
                        _tm.PROMPTS_TOTAL.labels(status=status).inc()
                    if statuses:
                        _tm.PROMPT_SECONDS.observe(time.monotonic() - started)
                    _tm.PROMPT_QUEUE_DEPTH.set(self.queue_remaining)
                self._job_done()

    async def _run_solo(self, loop, job: PromptJob, started: float) -> str:
        if job.expired(started):
            self.history[job.prompt_id] = {
                "status": "expired", "duration": 0.0,
                "error": "deadline_ms elapsed before execution",
            }
            log(f"prompt {job.prompt_id} expired in queue")
            return "expired"
        try:
            context = dict(self._context_factory())
            context["interrupt_event"] = self._interrupt
            context["prompt_id"] = job.prompt_id
            with telemetry.span("prompt.execute", trace_id=job.trace_id,
                                parent_id=job.parent_span_id,
                                prompt_id=job.prompt_id):
                ctx = contextvars.copy_context()
                outputs = await loop.run_in_executor(
                    self._pool, ctx.run, GraphExecutor(context).execute,
                    job.prompt)
            self.history[job.prompt_id] = {
                "status": "success",
                "duration": time.monotonic() - started,
                "outputs": {nid: out for nid, out in outputs.items()
                            if _is_terminal(job.prompt, nid)},
            }
            trace_info(job.trace_id,
                       f"prompt {job.prompt_id} done in "
                       f"{self.history[job.prompt_id]['duration']:.2f}s")
            return "success"
        except InterruptedError:
            self.history[job.prompt_id] = {
                "status": "interrupted",
                "duration": time.monotonic() - started,
            }
            log(f"prompt {job.prompt_id} interrupted")
            return "interrupted"
        except Exception as e:  # noqa: BLE001 — one prompt's failure is its own
            self.history[job.prompt_id] = {
                "status": "error", "error": str(e),
                "duration": time.monotonic() - started,
            }
            log(f"prompt {job.prompt_id} failed: {e!r}\n"
                f"{traceback.format_exc()}")
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


def _priority_rank(priority: str) -> int:
    try:
        return constants.PRIORITY_CLASSES.index(priority)
    except ValueError:
        return len(constants.PRIORITY_CLASSES)


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
