"""Typed job state: the collector job and the tile job with its tasks
(the JAX package's ``cluster/job_models.py``)."""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Optional


@dataclasses.dataclass
class CollectorJob:
    """One collector gather: workers push result envelopes, master drains."""

    job_id: str
    expected_workers: tuple[str, ...] = ()
    results: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    # worker_id → done flag (worker sent its is_last envelope)
    completed_workers: dict[str, bool] = dataclasses.field(default_factory=dict)
    created_at: float = dataclasses.field(default_factory=time.monotonic)

    def all_done(self) -> bool:
        return all(self.completed_workers.get(w) for w in self.expected_workers)


@dataclasses.dataclass
class TileTask:
    """A unit of tile work at host granularity: one contiguous range of
    the global tile indices (one chunk of the tile engine)."""

    task_id: int
    start: int                  # global tile index range [start, end)
    end: int

    def as_dict(self) -> dict:
        return {"task_id": self.task_id, "start": self.start, "end": self.end}


@dataclasses.dataclass
class TileJob:
    """A pull-based tile job: hosts pull pending tasks, submit results,
    and a silent host's tasks go back to the queue."""

    job_id: str
    total_tasks: int
    mode: str = "static"                       # "static" | "dynamic"
    # creation order, unique in the process (given by the store): the steal
    # scheduler's tie-break key (cluster/elastic/scheduler.py)
    seq: int = 0
    # task_id → task, for the whole job lifetime (requeue needs ranges back)
    tasks: dict[int, TileTask] = dataclasses.field(default_factory=dict)
    pending: list[TileTask] = dataclasses.field(default_factory=list)
    # task_id → worker_id currently assigned
    assigned: dict[int, str] = dataclasses.field(default_factory=dict)
    # task_id → result payload, and the host that submitted it
    completed: dict[int, Any] = dataclasses.field(default_factory=dict)
    completed_by: dict[int, str] = dataclasses.field(default_factory=dict)
    # worker_id → last heartbeat (monotonic)
    worker_status: dict[str, float] = dataclasses.field(default_factory=dict)
    results: asyncio.Queue = dataclasses.field(default_factory=asyncio.Queue)
    created_at: float = dataclasses.field(default_factory=time.monotonic)
    # task_id → times this task was requeued (eviction or processing
    # failure); past CDT_MAX_TILE_REQUEUES the task dead-letters instead
    requeue_counts: dict[int, int] = dataclasses.field(default_factory=dict)
    # poison tasks: task_id → {task_id, worker_id, reason, requeues}
    dead_letter: dict[int, dict] = dataclasses.field(default_factory=dict)

    def remaining(self) -> int:
        return self.total_tasks - len(self.completed) - len(self.dead_letter)

    def is_complete(self) -> bool:
        """Every task reached a terminal state, completed or dead-lettered:
        a poison tile never hangs the job."""
        return self.remaining() <= 0

    def heartbeat(self, worker_id: str, now: Optional[float] = None) -> None:
        self.worker_status[worker_id] = time.monotonic() if now is None else now
