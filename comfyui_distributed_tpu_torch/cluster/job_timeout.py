"""Heartbeat-timeout detection and work requeue (the port's copy of the
JAX package's ``cluster/job_timeout.py``), in three phases:

1. snapshot the suspect workers **under** the store lock;
2. probe the suspects **outside** the lock (a probe can take seconds,
   and holding the lock would stall result ingest);
3. re-acquire it to apply: spare a worker whose probe shows a busy
   queue (refresh its heartbeat), requeue everything else and trip the
   evicted worker's circuit breaker.

The JAX package's branch for workers of the elastic fleet that are
draining is not ported.
"""

from __future__ import annotations

import time
from typing import Awaitable, Callable, Optional

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.logging import log
from .job_store import JobStore
from .resilience import BREAKERS

ProbeFn = Callable[[str], Awaitable[Optional[dict]]]


async def check_and_requeue_timed_out_workers(
    store: JobStore,
    job_id: str,
    timeout: float | None = None,
    probe_fn: ProbeFn | None = None,
    now: float | None = None,
    max_requeues: int | None = None,
) -> dict[str, list[int]]:
    """Returns {worker_id: [requeued task ids]} for evicted workers.

    ``probe_fn(worker_id)`` returns a health dict or None; a worker whose
    health reports ``queue_remaining > 0`` is spared and its heartbeat
    refreshed. Requeues are bounded by ``max_requeues`` (default
    ``CDT_MAX_TILE_REQUEUES``); an eviction trips the worker's breaker
    (``resilience.BREAKERS``).
    """
    timeout = constants.heartbeat_timeout() if timeout is None else timeout
    now = time.monotonic() if now is None else now

    # phase 1: snapshot under the lock
    async with store.lock:
        job = store.tile_jobs.get(job_id)
        if job is None:
            return {}
        suspects = [
            w for w, last in job.worker_status.items()
            if now - last > timeout and any(
                owner == w and tid not in job.completed
                for tid, owner in job.assigned.items())
        ]
    if not suspects:
        return {}

    # phase 2: probe outside the lock
    spared: set[str] = set()
    if probe_fn is not None:
        for w in suspects:
            health = await probe_fn(w)
            if health and int(health.get("queue_remaining", 0)) > 0:
                spared.add(w)

    # phase 3: apply
    evicted: dict[str, list[int]] = {}
    for w in suspects:
        if w in spared:
            await store.heartbeat(job_id, w)
            log(f"worker {w} silent but busy: heartbeat refreshed (grace)")
            if telemetry.enabled():
                _tm.TILE_WORKER_EVICTIONS.labels(outcome="spared").inc()
            continue
        requeued = await store.requeue_worker_tasks(
            job_id, w, max_requeues=max_requeues)
        if requeued:
            log(f"worker {w} timed out; requeued tasks {requeued}")
        evicted[w] = requeued
        if telemetry.enabled():
            _tm.TILE_WORKER_EVICTIONS.labels(outcome="evicted").inc()
            if requeued:
                _tm.TILE_EVENTS.labels(event="timed_out").inc(len(requeued))
        if w != "master":
            # eviction-grade evidence: open the breaker at once
            BREAKERS.trip(w)
    return evicted
