"""Worker lifecycle states of the elastic fleet: leaving is not broken
(the port's copy of the JAX package's ``cluster/elastic/states.py``).

The circuit breakers (``cluster/resilience.py``) answer "is this worker
failing?"; this registry answers "is this worker meant to be here?". A
worker that leaves on purpose (an autoscaler scale-down, a rolling
restart, an operator's drain) must read as such wherever failure
evidence is gathered, or each planned departure poisons the fleet's
health:

- ``select_active_hosts`` would probe it, time out and feed the failure
  to its breaker;
- the tile farm would go on granting it work it is trying to give up;
- heartbeat eviction would trip its breaker and count its requeues
  toward the poison-tile bound;
- admission's healthy fraction would shed load for a fleet that is only
  smaller, not sicker.

The registry is process-global (as ``BREAKERS`` is) and thread-safe: the
route handlers, the autoscaler loop and the graph thread all read it.
States move forward only (active → draining → decommissioned), except
for an explicit ``reactivate``: a worker that rejoins (undrain, or a
scale-up that reuses the id) starts clean. Exported as the
``cdt_worker_drain_state`` gauge (0 active, 1 draining, 2
decommissioned).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ... import telemetry
from ...telemetry import metrics as _tm
from ...utils.logging import log

ACTIVE, DRAINING, DECOMMISSIONED = "active", "draining", "decommissioned"
_STATE_VALUE = {ACTIVE: 0, DRAINING: 1, DECOMMISSIONED: 2}


class DrainRegistry:
    """worker id → lifecycle state, and the drain's deadline. A worker it
    does not know is ``active``: the registry tracks departures only."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._states: dict[str, str] = {}
        # worker id → monotonic time by which held work must be finished
        # or handed back (None: no deadline)
        self._deadlines: dict[str, Optional[float]] = {}
        self._clock = clock
        # fn(worker_id, state), called outside the lock after every
        # transition
        self._listeners: list[Callable[[str, str], None]] = []

    # --- queries ----------------------------------------------------------------

    def state(self, worker_id: str) -> str:
        with self._lock:
            return self._states.get(str(worker_id), ACTIVE)

    def is_active(self, worker_id: str) -> bool:
        return self.state(worker_id) == ACTIVE

    def is_draining(self, worker_id: str) -> bool:
        return self.state(worker_id) == DRAINING

    def is_leaving(self, worker_id: str) -> bool:
        """Draining or decommissioned: what every site that must treat a
        departure as intentional checks."""
        return self.state(worker_id) != ACTIVE

    def deadline(self, worker_id: str) -> Optional[float]:
        with self._lock:
            return self._deadlines.get(str(worker_id))

    def states(self) -> dict[str, str]:
        with self._lock:
            return dict(self._states)

    # --- listeners --------------------------------------------------------------

    def subscribe(self, fn: Callable[[str, str], None]) -> None:
        """``fn(worker_id, new_state)`` after every transition, outside the
        lock (it may query the registry). A listener's exception is
        swallowed: an observer never blocks the lifecycle."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def unsubscribe(self, fn: Callable[[str, str], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, worker_id: str) -> None:
        with self._lock:
            listeners = list(self._listeners)
        state = self.state(worker_id)
        for fn in listeners:
            try:
                fn(worker_id, state)
            except Exception:  # noqa: BLE001 — observers never block lifecycle
                pass

    # --- transitions ------------------------------------------------------------

    def mark_draining(self, worker_id: str,
                      deadline_s: Optional[float] = None) -> bool:
        """Begin a planned departure. False when the worker is draining or
        decommissioned already: a second drain must not reset the
        deadline."""
        wid = str(worker_id)
        with self._lock:
            if self._states.get(wid, ACTIVE) != ACTIVE:
                return False
            self._states[wid] = DRAINING
            self._deadlines[wid] = (
                self._clock() + deadline_s if deadline_s else None)
        log(f"drain[{wid}] active -> draining"
            + (f" (deadline {deadline_s:.0f}s)" if deadline_s else ""))
        self._export(wid)
        self._notify(wid)
        return True

    def mark_decommissioned(self, worker_id: str) -> None:
        wid = str(worker_id)
        with self._lock:
            before = self._states.get(wid, ACTIVE)
            self._states[wid] = DECOMMISSIONED
            self._deadlines.pop(wid, None)
        if before != DECOMMISSIONED:
            log(f"drain[{wid}] {before} -> decommissioned")
        self._export(wid)
        self._notify(wid)

    def reactivate(self, worker_id: str) -> bool:
        """Undrain or rejoin: the worker is part of the fleet again. True
        when a state other than active was cleared."""
        wid = str(worker_id)
        with self._lock:
            before = self._states.pop(wid, ACTIVE)
            self._deadlines.pop(wid, None)
        if before != ACTIVE:
            log(f"drain[{wid}] {before} -> active (reactivated)")
        self._export(wid)
        self._notify(wid)
        return before != ACTIVE

    def reset(self) -> None:
        with self._lock:
            wids = list(self._states)
            self._states.clear()
            self._deadlines.clear()
        for wid in wids:
            self._export(wid)

    def _export(self, worker_id: str) -> None:
        if telemetry.enabled():
            _tm.WORKER_DRAIN_STATE.labels(worker=worker_id).set(
                _STATE_VALUE[self.state(worker_id)])


DRAIN = DrainRegistry()
