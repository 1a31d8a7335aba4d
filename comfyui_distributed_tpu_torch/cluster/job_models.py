"""Typed job state: the collector job (the JAX package's
``cluster/job_models.py``; tile jobs are not ported)."""

from __future__ import annotations

import asyncio
import dataclasses
import time


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
