"""Cross-job work stealing: one scheduler over every open tile job (the
port's copy of the JAX package's ``cluster/elastic/scheduler.py``).

A worker may ask for work from any open job (``job_id="*"`` on ``POST
/distributed/request_image``), and :class:`StealPolicy` picks the job.
The grant carries its ``job_id``, so the result goes back to that job's
queue. Task ranges are global tile indices and each tile's noise follows
its global index (``cluster/tile_farm.py``), so who runs a range changes
no pixel.

The policy is a pure function of the open jobs' state, the worker id and
a seed: open jobs rank most starved first (fewest distinct workers
assigned, then most pending tasks), and exact ties fall to a seeded
SHA-256 of (seed, job seq, worker id). The same seed and the same events
give the same schedule.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

from ...utils import constants


def _stable_tiebreak(seed: int, job_seq: int, worker_id: str) -> int:
    """The same across processes and Python's hash randomisation."""
    digest = hashlib.sha256(
        f"{seed}:{job_seq}:{worker_id}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


@dataclasses.dataclass(frozen=True)
class JobView:
    """What the policy ranks of a tile job (read under the store's lock;
    the policy never touches the store)."""

    job_id: str
    seq: int                    # creation order, unique in the process
    pending: int                # unassigned tasks
    active_workers: int         # distinct workers assigned, the master aside


class StealPolicy:
    """Ranks open jobs for a pulling worker, deterministically under a
    seed (``CDT_STEAL_SEED`` by default)."""

    def __init__(self, seed: Optional[int] = None):
        if seed is None:
            seed = constants.steal_seed()
        self.seed = seed

    def rank(self, jobs: Sequence[JobView],
             worker_id: str) -> list[JobView]:
        candidates = [j for j in jobs if j.pending > 0]
        return sorted(
            candidates,
            key=lambda j: (j.active_workers, -j.pending,
                           _stable_tiebreak(self.seed, j.seq, worker_id)))

    def pick(self, jobs: Sequence[JobView],
             worker_id: str) -> Optional[JobView]:
        ranked = self.rank(jobs, worker_id)
        return ranked[0] if ranked else None
