"""Per-group-key coalescing: hold batchable requests briefly, flush
same-shape groups as one batch job (the port's copy of the JAX package's
``cluster/frontdoor/batcher.py``).

The window (``CDT_FD_WINDOW_MS``, 25 ms by default: noise against a
request of seconds) trades a bounded wait for group occupancy. Groups
drain only while the prompt queue has room (``CDT_FD_INFLIGHT`` batch
jobs), so under load a waiting group keeps absorbing same-shape
arrivals up to ``CDT_FD_MAX_BATCH`` instead of splitting into solo
jobs. A valve (``CDT_FD_MAX_WAIT_MS``, by default 20 windows) force-
flushes a group whose oldest member has waited too long.

Flush order is strict priority (the rank of the group's most urgent
member in ``constants.PRIORITY_CLASSES``), then the group's age.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Optional

from ...utils import constants
from ...utils.logging import debug_log
from .classifier import GroupKey


def _max_wait_ms() -> float:
    env = constants.fd_max_wait_ms()
    if env is not None:
        return env
    return constants.fd_window_ms() * 20.0


@dataclasses.dataclass
class _Group:
    key: GroupKey
    members: list = dataclasses.field(default_factory=list)
    sampler_node_ids: dict = dataclasses.field(default_factory=dict)
    opened_at: float = 0.0

    def priority_rank(self) -> int:
        ranks = [
            constants.PRIORITY_CLASSES.index(m.priority)
            if m.priority in constants.PRIORITY_CLASSES
            else len(constants.PRIORITY_CLASSES)
            for m in self.members
        ]
        return min(ranks) if ranks else len(constants.PRIORITY_CLASSES)


class CoalescingBatcher:
    """Holds admitted batchable members per :class:`GroupKey` and flushes
    ready groups through ``enqueue`` (one call per group)."""

    def __init__(
        self,
        enqueue: Callable[[list, dict], None],
        *,
        window_ms: Optional[float] = None,
        max_batch: Optional[int] = None,
        capacity: Optional[Callable[[], bool]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.enqueue = enqueue
        self.window_ms = (constants.fd_window_ms() if window_ms is None
                          else window_ms)
        self.max_batch = max(1, constants.fd_max_batch() if max_batch is None
                             else max_batch)
        self.capacity = capacity or (lambda: True)
        self._clock = clock
        self._groups: dict[GroupKey, _Group] = {}
        self._wake = asyncio.Event()
        self.flushed_groups = 0
        self.flushed_members = 0

    # --- producer side ------------------------------------------------------

    def submit(self, key: GroupKey, member, sampler_node_id: str) -> None:
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(key=key,
                                               opened_at=self._clock())
        group.members.append(member)
        group.sampler_node_ids[member.prompt_id] = sampler_node_id
        self.wake()

    def wake(self) -> None:
        self._wake.set()

    # --- introspection ------------------------------------------------------

    @property
    def pending_count(self) -> int:
        return sum(len(g.members) for g in self._groups.values())

    def pending_by_priority(self) -> dict[str, int]:
        out = {p: 0 for p in constants.PRIORITY_CLASSES}
        for g in self._groups.values():
            for m in g.members:
                out[m.priority] = out.get(m.priority, 0) + 1
        return out

    def group_summary(self) -> list[dict]:
        now = self._clock()
        return [{"key": g.key.label(), "size": len(g.members),
                 "age_ms": round((now - g.opened_at) * 1000.0, 1)}
                for g in sorted(self._groups.values(),
                                key=lambda g: g.opened_at)]

    # --- scheduler ----------------------------------------------------------

    def _ready(self, group: _Group, now: float) -> bool:
        return (len(group.members) >= self.max_batch
                or (now - group.opened_at) * 1000.0 >= self.window_ms)

    def _overdue(self, group: _Group, now: float) -> bool:
        return (now - group.opened_at) * 1000.0 >= _max_wait_ms()

    def _next_deadline(self) -> Optional[float]:
        """The next moment a timer could change ``flush_ready``'s answer:
        a pending group's window, or a ready group's overdue valve (a
        ready group waiting for room wakes on the job-done callback)."""
        if not self._groups:
            return None
        now = self._clock()
        deadlines = []
        for g in self._groups.values():
            if self._ready(g, now):
                deadlines.append(g.opened_at + _max_wait_ms() / 1000.0)
            else:
                deadlines.append(g.opened_at + self.window_ms / 1000.0)
        return min(deadlines)

    def flush_ready(self) -> int:
        """Flush every ready group the queue has room for (overdue groups
        flush regardless). Returns the members flushed."""
        flushed = 0
        while True:
            now = self._clock()
            ready = [g for g in self._groups.values() if self._ready(g, now)]
            if not ready:
                return flushed
            ready.sort(key=lambda g: (g.priority_rank(), g.opened_at))
            if self.capacity():
                group = ready[0]
            else:
                overdue = [g for g in ready if self._overdue(g, now)]
                if not overdue:
                    return flushed
                group = overdue[0]
            take = group.members[:self.max_batch]
            rest = group.members[self.max_batch:]
            ids = {m.prompt_id: group.sampler_node_ids[m.prompt_id]
                   for m in take}
            if rest:
                group.members = rest
                group.sampler_node_ids = {
                    m.prompt_id: group.sampler_node_ids[m.prompt_id]
                    for m in rest}
                # the leftovers keep the window they already served
                group.opened_at = min(m.enqueued_at for m in rest)
            else:
                del self._groups[group.key]
            debug_log(f"front door: flushing {len(take)} member(s) "
                      f"for {group.key.label()}")
            self.enqueue(take, ids)
            self.flushed_groups += 1
            self.flushed_members += len(take)
            flushed += len(take)

    async def run(self) -> None:
        """The coalescing loop: sleep until the earliest window ends or
        something wakes it (a new member, a finished job), then flush."""
        while True:
            deadline = self._next_deadline()
            timeout = (None if deadline is None
                       else max(0.001, deadline - self._clock()))
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            self.flush_ready()
