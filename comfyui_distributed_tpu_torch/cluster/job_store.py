"""The controller's job registry (the JAX package's ``JobStore``):
collector jobs, one result queue per distributed job id created before
any compute is dispatched, and the pull-based tile jobs of the tile
farm, with the elastic fleet's cross-job steal pull
(``request_any_work``) and drain handback (``handback_worker_tasks``).
Every mutation happens under the store's lock.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional, Sequence

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.exceptions import JobQueueError
from ..utils.logging import log
from .job_models import CollectorJob, TileJob, TileTask


class JobStore:
    # finished tile-job summaries kept for status queries (dead-letter
    # forensics after the job completed); bounded FIFO
    MAX_FINISHED = 64

    def __init__(self):
        self.lock = asyncio.Lock()
        self.collector_jobs: dict[str, CollectorJob] = {}
        self.tile_jobs: dict[str, TileJob] = {}
        self.finished: dict[str, dict] = {}
        self._job_seq = 0

    def _record_tiles(self, event: str | None = None, n: int = 1) -> None:
        """``n`` tile lifecycle ``event``s, and the pending depth across
        live jobs (call under ``self.lock``)."""
        if not telemetry.enabled():
            return
        if event is not None and n > 0:
            _tm.TILE_EVENTS.labels(event=event).inc(n)
        _tm.TILE_QUEUE_DEPTH.set(
            sum(len(j.pending) for j in self.tile_jobs.values()))

    async def prepare_collector_job(
        self, job_id: str, expected_workers: tuple[str, ...] = ()
    ) -> CollectorJob:
        """Create the result queue before any compute is dispatched, so a
        fast worker's result always finds it; a second call with workers
        replaces the expected set."""
        async with self.lock:
            job = self.collector_jobs.get(job_id)
            if job is None:
                job = CollectorJob(job_id, tuple(expected_workers))
                self.collector_jobs[job_id] = job
            elif expected_workers:
                job.expected_workers = tuple(expected_workers)
            return job

    async def set_expected_workers(self, job_id: str,
                                   workers: tuple[str, ...]) -> None:
        """Replace the expected set, down to none (after failed
        dispatches: the collector must not wait on a host that never got
        the job)."""
        async with self.lock:
            job = self.collector_jobs.setdefault(job_id, CollectorJob(job_id))
            job.expected_workers = tuple(workers)

    async def put_collector_result(
        self, job_id: str, envelope: dict[str, Any],
        grace: float | None = None,
    ) -> None:
        """Enqueue a worker envelope; waits up to ``grace`` seconds for a
        job that is not created yet."""
        grace = constants.job_init_grace() if grace is None else grace
        deadline = time.monotonic() + grace
        while True:
            async with self.lock:
                job = self.collector_jobs.get(job_id)
            if job is not None:
                await job.results.put(envelope)
                if envelope.get("is_last"):
                    job.completed_workers[envelope.get("worker_id", "")] = True
                return
            if time.monotonic() >= deadline:
                raise JobQueueError(f"collector job {job_id!r} never initialized",
                                    job_id=job_id)
            await asyncio.sleep(0.1)

    async def get_collector_job(self, job_id: str) -> Optional[CollectorJob]:
        async with self.lock:
            return self.collector_jobs.get(job_id)

    # --- tile jobs -------------------------------------------------------------

    async def init_tile_job(self, job_id: str, total_tasks: int,
                            mode: str = "static", chunk: int = 1) -> TileJob:
        """Seed the pending queue with [start, end) tasks of ``chunk``
        tiles each."""
        async with self.lock:
            if job_id in self.tile_jobs:
                raise JobQueueError(f"tile job {job_id!r} already initialized",
                                    job_id=job_id)
            tasks = [TileTask(tid, start, min(start + chunk, total_tasks))
                     for tid, start in enumerate(range(0, total_tasks, chunk))]
            self._job_seq += 1
            job = TileJob(job_id, total_tasks=len(tasks), mode=mode,
                          seq=self._job_seq,
                          tasks={t.task_id: t for t in tasks},
                          pending=list(tasks))
            self.tile_jobs[job_id] = job
            self._record_tiles("seeded", len(tasks))
            return job

    async def request_work(self, job_id: str, worker_id: str) -> Optional[dict]:
        """Pull-based assignment: pop a pending task, record the
        assignment and a heartbeat; None when the queue is drained."""
        async with self.lock:
            job = self.tile_jobs.get(job_id)
            if job is None:
                return None
            job.heartbeat(worker_id)
            return self._grant_locked(job, worker_id)

    def _grant_locked(self, job: TileJob, worker_id: str) -> Optional[dict]:
        """Pop and assign one pending task (call under ``self.lock``)."""
        if not job.pending:
            return None
        task = job.pending.pop(0)
        job.assigned[task.task_id] = worker_id
        self._record_tiles("assigned")
        return {**task.as_dict(), "job_id": job.job_id,
                "estimated_remaining": len(job.pending)}

    async def request_any_work(self, worker_id: str, policy=None,
                               exclude: Sequence[str] = ()) -> Optional[dict]:
        """The cross-job pull (``job_id="*"``): a task of whichever open
        tile job the steal policy ranks first, so a worker whose own job
        drained, or one that just arrived, serves the rest of the load.
        The grant carries its ``job_id``, and the result goes home.

        ``exclude`` lists the jobs the puller cannot serve (it lacks their
        weights or graph): without it a top-ranked job it cannot serve
        would bounce its grant (grant, handback, grant again) and starve
        every job ranked below it."""
        from .elastic.scheduler import JobView, StealPolicy

        policy = policy or StealPolicy()
        excluded = set(exclude)
        async with self.lock:
            views = []
            for jid, job in self.tile_jobs.items():
                if jid in excluded:
                    continue
                owners = {w for w in job.assigned.values() if w != "master"}
                views.append(JobView(job_id=jid, seq=job.seq,
                                     pending=len(job.pending),
                                     active_workers=len(owners)))
            choice = policy.pick(views, worker_id)
            if choice is None:
                return None
            job = self.tile_jobs[choice.job_id]
            job.heartbeat(worker_id)
            return self._grant_locked(job, worker_id)

    async def submit_result(self, job_id: str, worker_id: str, task_id: int,
                            payload: Any) -> bool:
        """Record a completed task. A duplicate submission (a worker that
        timed out and came back) is ignored: False."""
        async with self.lock:
            job = self.tile_jobs.get(job_id)
            if job is None:
                raise JobQueueError(f"unknown tile job {job_id!r}", job_id=job_id)
            if task_id not in job.tasks:
                raise JobQueueError(
                    f"tile job {job_id!r} has no task {task_id}", job_id=job_id)
            job.heartbeat(worker_id)
            if task_id in job.completed:
                return False
            # a presumed-poison task that finished after all: a real
            # result always wins
            job.dead_letter.pop(task_id, None)
            job.completed[task_id] = payload
            job.completed_by[task_id] = worker_id
            job.assigned.pop(task_id, None)
            self._record_tiles("completed")
        await job.results.put((task_id, payload))
        return True

    async def restore_completed(self, job_id: str, task_id: int,
                                payload: Any) -> bool:
        """Mark a task complete from a journal (crash resume): unlike
        ``submit_result`` it also leaves the pending queue, and skips the
        results queue."""
        async with self.lock:
            job = self.tile_jobs.get(job_id)
            if job is None:
                raise JobQueueError(f"unknown tile job {job_id!r}", job_id=job_id)
            if task_id not in job.tasks or task_id in job.completed:
                return False
            job.completed[task_id] = payload
            job.completed_by[task_id] = "journal"
            job.pending = [t for t in job.pending if t.task_id != task_id]
            job.assigned.pop(task_id, None)
            self._record_tiles("restored")
            return True

    async def heartbeat(self, job_id: str, worker_id: str) -> bool:
        async with self.lock:
            job = self.tile_jobs.get(job_id)
            if job is None:
                return False
            job.heartbeat(worker_id)
            return True

    async def job_status(self, job_id: str) -> dict:
        """The job-ready poll of workers and the status routes."""
        async with self.lock:
            tile = self.tile_jobs.get(job_id)
            if tile is not None:
                return {"exists": True, "kind": "tile", "mode": tile.mode,
                        "pending": len(tile.pending),
                        "completed": len(tile.completed),
                        "total": tile.total_tasks,
                        "dead_letter": sorted(tile.dead_letter.values(),
                                              key=lambda d: d["task_id"])}
            if job_id in self.collector_jobs:
                return {"exists": True, "kind": "collector"}
            done = self.finished.get(job_id)
            if done is not None:
                # cleaned up already; dead-letter forensics survive, and
                # ``exists`` stays False so a worker's ready-poll never
                # takes a finished job for a live queue
                return {"exists": False, "finished": True, **done}
            return {"exists": False}

    def _dead_letter_locked(self, job: TileJob, task_id: int, worker_id: str,
                            reason: str) -> None:
        """Move a task to the job's dead-letter list (under the lock):
        terminal for completion accounting."""
        job.dead_letter[task_id] = {
            "task_id": task_id, "worker_id": worker_id, "reason": reason,
            "requeues": job.requeue_counts.get(task_id, 0),
        }
        job.assigned.pop(task_id, None)
        job.pending = [t for t in job.pending if t.task_id != task_id]
        self._record_tiles("dead_letter")

    async def requeue_worker_tasks(self, job_id: str, worker_id: str,
                                   max_requeues: int | None = None,
                                   count_requeue: bool = True) -> list[int]:
        """Requeue the incomplete tasks of a (presumed dead) worker, at the
        front of the queue, and forget its heartbeat.

        Requeues are bounded: a task requeued more than ``max_requeues``
        times (default ``CDT_MAX_TILE_REQUEUES``) dead-letters instead, so
        a tile that kills its host does not cycle through the fleet.
        ``count_requeue=False`` is a planned departure (a drain's
        handback, a draining worker gone silent, a grant given back): the
        task goes back to the queue, the hop counts nothing toward that
        bound, and the tile event is ``handed_back``. A tile is suspect
        only when its host failed, not when its host was told to leave."""
        if max_requeues is None:
            max_requeues = constants.max_tile_requeues()
        async with self.lock:
            job = self.tile_jobs.get(job_id)
            if job is None:
                return []
            requeued, poisoned = [], []
            for task_id, owner in list(job.assigned.items()):
                if owner != worker_id or task_id in job.completed:
                    continue
                del job.assigned[task_id]
                if count_requeue:
                    count = job.requeue_counts.get(task_id, 0) + 1
                    job.requeue_counts[task_id] = count
                    if count > max_requeues:
                        poisoned.append(task_id)
                        self._dead_letter_locked(
                            job, task_id, worker_id,
                            f"exceeded max_requeues={max_requeues} "
                            f"(last owner {worker_id})")
                        continue
                requeued.append(task_id)
            job.pending[:0] = [job.tasks[tid] for tid in requeued]
            self._record_tiles("requeued" if count_requeue else "handed_back",
                               len(requeued))
            if poisoned:
                log(f"tile job {job_id}: dead-lettered poison tasks "
                    f"{poisoned} from {worker_id}")
            job.worker_status.pop(worker_id, None)
            return requeued

    async def worker_held_tasks(self, worker_id: str) -> dict[str, list[int]]:
        """{job_id: [task ids]} the worker is assigned and has not
        completed, across every open tile job (a drain's bookkeeping)."""
        async with self.lock:
            held: dict[str, list[int]] = {}
            for jid, job in self.tile_jobs.items():
                tids = sorted(tid for tid, owner in job.assigned.items()
                              if owner == worker_id and tid not in job.completed)
                if tids:
                    held[jid] = tids
            return held

    async def handback_worker_tasks(self, worker_id: str
                                    ) -> dict[str, list[int]]:
        """A drain's handback: every task the leaving worker still holds,
        across every open job, goes to the front of its job's queue, with
        no poison-bound count and no breaker evidence. Heartbeat eviction
        clears ``assigned`` under the same lock, so a tile is handed back
        by one of the two paths at most."""
        held = await self.worker_held_tasks(worker_id)
        out: dict[str, list[int]] = {}
        total = 0
        for jid in held:
            requeued = await self.requeue_worker_tasks(jid, worker_id,
                                                       count_requeue=False)
            if requeued:
                out[jid] = requeued
                total += len(requeued)
        if total and telemetry.enabled():
            _tm.DRAIN_HANDBACKS.inc(total)
        return out

    async def record_task_failure(self, job_id: str, worker_id: str,
                                  task_id: int, reason: str,
                                  max_requeues: int | None = None) -> bool:
        """A processing attempt raised: requeue the task, or dead-letter it
        past the bound. True while the task is still live."""
        if max_requeues is None:
            max_requeues = constants.max_tile_requeues()
        async with self.lock:
            job = self.tile_jobs.get(job_id)
            if job is None or task_id in job.completed or task_id in job.dead_letter:
                return False
            count = job.requeue_counts.get(task_id, 0) + 1
            job.requeue_counts[task_id] = count
            job.assigned.pop(task_id, None)
            if count > max_requeues:
                self._dead_letter_locked(job, task_id, worker_id, reason)
                return False
            if all(t.task_id != task_id for t in job.pending):
                job.pending.append(job.tasks[task_id])
            self._record_tiles("requeued")
            return True

    # --- lifecycle ---------------------------------------------------------------

    async def cleanup_job(self, job_id: str) -> None:
        async with self.lock:
            self.collector_jobs.pop(job_id, None)
            tile = self.tile_jobs.pop(job_id, None)
            if tile is not None:
                self.finished[job_id] = {
                    "kind": "tile", "completed": len(tile.completed),
                    "total": tile.total_tasks,
                    # task id → the host that submitted it ("master", a
                    # worker id, or "journal" for a resumed task)
                    "completed_by": {str(t): w for t, w in
                                     sorted(tile.completed_by.items())},
                    # task id → times it went back to the queue through the
                    # failure path (a handback counts nothing)
                    "requeue_counts": {str(t): n for t, n in
                                       sorted(tile.requeue_counts.items())},
                    "dead_letter": sorted(tile.dead_letter.values(),
                                          key=lambda d: d["task_id"]),
                }
                while len(self.finished) > self.MAX_FINISHED:
                    self.finished.pop(next(iter(self.finished)))
                self._record_tiles()

    async def prune_stale(self, max_age: float = 3600.0) -> list[str]:
        """Drop jobs older than ``max_age`` seconds (abandoned jobs)."""
        now = time.monotonic()
        dropped = []
        async with self.lock:
            for jobs in (self.collector_jobs, self.tile_jobs):
                for jid in [j for j, job in jobs.items()
                            if now - job.created_at > max_age]:
                    del jobs[jid]
                    dropped.append(jid)
        return dropped
