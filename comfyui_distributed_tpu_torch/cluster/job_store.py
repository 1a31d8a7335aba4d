"""Collector jobs: one result queue per distributed job id, created
before any compute is dispatched (the collector half of the JAX
package's ``JobStore``; tile jobs are not ported). Every mutation
happens under the store's lock."""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

from ..utils import constants
from ..utils.exceptions import JobQueueError
from .job_models import CollectorJob


class JobStore:
    def __init__(self):
        self.lock = asyncio.Lock()
        self.collector_jobs: dict[str, CollectorJob] = {}

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

    async def cleanup_job(self, job_id: str) -> None:
        async with self.lock:
            self.collector_jobs.pop(job_id, None)

    async def prune_stale(self, max_age: float = 3600.0) -> list[str]:
        """Drop jobs older than ``max_age`` seconds (abandoned jobs)."""
        now = time.monotonic()
        async with self.lock:
            dropped = [j for j, job in self.collector_jobs.items()
                       if now - job.created_at > max_age]
            for jid in dropped:
                del self.collector_jobs[jid]
        return dropped
