"""Duplicate-request coalescing: one execution, N waiters (the port's
copy of the JAX package's ``cluster/cache/coalesce.py``).

Byte-identical submissions arrive concurrently: re-rolls submitted
twice, pages that ask for the same workflow again, retrying balancers.
The first submission of a fingerprint becomes the **leader** and runs;
every twin that arrives while it is in flight becomes a **waiter**:
admitted, given its own prompt id, never enqueued. When the leader
reaches a terminal history entry, each waiter gets a copy of it, marked
with the leader it rode (``coalesced_with``).

This is sound because the classifier fingerprints only the
deterministic batchable class, whose execution is bitwise the same for
the same request: the leader's bytes are the waiter's bytes.

Everything runs on the controller's event loop (the front door's submit
and the queue's job-done callback), so nothing is locked. The width of
each resolved flight goes to ``cdt_coalesce_width``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class _Waiter:
    member: object            # PromptJob
    group_key: object         # classifier.GroupKey (for a re-dispatch)
    sampler_node_id: str


@dataclasses.dataclass
class _Flight:
    leader_id: str
    waiters: "list[_Waiter]" = dataclasses.field(default_factory=list)


class InflightCoalescer:
    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._flights: dict[str, _Flight] = {}
        self.resolved_flights = 0
        self.coalesced_waiters = 0

    # --- producer side (the front door's submit) ----------------------------

    def lead(self, fingerprint: str, prompt_id: str) -> None:
        """Register the leader of a fingerprint; the first one wins."""
        if fingerprint not in self._flights:
            self._flights[fingerprint] = _Flight(leader_id=prompt_id)

    def join(self, fingerprint: str, member, group_key=None,
             sampler_node_id: str = "") -> bool:
        """Attach ``member`` (a PromptJob) as a waiter on an in-flight
        leader. False: nothing in flight, the caller executes. The group
        key and sampler node let a waiter whose leader expired go back
        through the batcher."""
        flight = self._flights.get(fingerprint)
        if flight is None:
            return False
        flight.waiters.append(_Waiter(member, group_key, sampler_node_id))
        return True

    # --- consumer side (the job-done callback) ------------------------------

    def resolve(self, history: dict,
                redispatch: Optional[Callable] = None) -> int:
        """Settle every flight whose leader has a history entry. Per
        waiter, in this order:

        - its own deadline passed → ``expired``;
        - the leader expired → the waiter did not ask for that deadline:
          ``redispatch(member, group_key, sampler_node_id)`` runs it
          afresh (without a hook it errors rather than inherit the
          verdict);
        - otherwise (success, error, interrupted: what a solo twin would
          have got) → a copy of the leader's row with ``coalesced_with``.

        Returns the waiters settled (re-dispatched ones settle later)."""
        settled = 0
        now = self._clock()
        for fp in list(self._flights):
            flight = self._flights[fp]
            entry = history.get(flight.leader_id)
            if entry is None:
                continue
            del self._flights[fp]
            width = 1 + len(flight.waiters)
            for waiter in flight.waiters:
                member = waiter.member
                if getattr(member, "expired", lambda _n: False)(now):
                    history[member.prompt_id] = {
                        "status": "expired", "duration": 0.0,
                        "error": "deadline_ms elapsed before execution",
                        "coalesced_with": flight.leader_id,
                    }
                elif entry.get("status") == "expired":
                    if redispatch is not None:
                        redispatch(member, waiter.group_key,
                                   waiter.sampler_node_id)
                        continue
                    history[member.prompt_id] = {
                        "status": "error", "duration": 0.0,
                        "error": "coalesced leader expired and no "
                                 "redispatch hook is installed",
                    }
                else:
                    row = dict(entry)
                    row["coalesced_with"] = flight.leader_id
                    history[member.prompt_id] = row
                settled += 1
            self.resolved_flights += 1
            self.coalesced_waiters += len(flight.waiters)
            self._observe_width(width)
        return settled

    def _observe_width(self, width: int) -> None:
        from ... import telemetry
        from ...telemetry import metrics as _tm

        if telemetry.enabled():
            _tm.COALESCE_WIDTH.observe(width)

    # --- introspection ------------------------------------------------------

    @property
    def inflight(self) -> int:
        return len(self._flights)

    @property
    def pending_waiters(self) -> int:
        return sum(len(f.waiters) for f in self._flights.values())

    def stats(self) -> dict:
        return {
            "inflight": self.inflight,
            "pending_waiters": self.pending_waiters,
            "resolved_flights": self.resolved_flights,
            "coalesced_waiters": self.coalesced_waiters,
        }
