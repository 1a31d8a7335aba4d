"""Graceful drain and decommission: the planned way out of the fleet
(the port's copy of the JAX package's ``cluster/elastic/drain.py``).

``POST /distributed/worker/{id}/drain`` lands here. In order:

1. **mark draining** (:mod:`.states`): from then on
   ``select_active_hosts`` skips the host without a probe, the tile
   farm grants it nothing (``/distributed/request_image`` answers
   ``draining: true``) and admission's healthy fraction leaves it out;
2. **preempt**: the running denoise loop is asked to checkpoint at its
   next segment boundary (``PreemptionController.preempt_executing
   ("drain")``), so a scale-down frees the slot in a segment, not a job;
3. **let held work finish**: the job store is polled until the worker
   holds no assignment; finished tiles come back through the normal
   submit, so a clean drain loses and requeues nothing;
4. **hand back at the deadline**: what is still held goes to the front
   of its job's queue through ``JobStore.handback_worker_tasks``, with no
   poison-bound count and no breaker evidence. Heartbeat eviction does
   the same for a draining worker that goes silent early; both clear
   assignments under the store's lock, so a tile is handed back once;
5. **stop the process** (a managed one) and mark ``decommissioned``.
   ``undrain`` before that reactivates the worker.

Each step is seen in ``cdt_worker_drain_state``,
``cdt_drain_handbacks_total`` and the drain's report in ``GET
/distributed/elastic``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional

from ...utils import constants
from ...utils.logging import log
from .states import DRAIN, DrainRegistry


class DrainCoordinator:
    """Runs each drain as a task on the controller's loop; one live drain
    a worker id (a second request reports the running one)."""

    def __init__(self, store, *, registry: DrainRegistry = DRAIN,
                 process_stopper: Optional[Callable[[str], bool]] = None,
                 poll_interval: float = 0.25,
                 preempter: Optional[Callable[[], object]] = None):
        self.store = store
        self.registry = registry
        # stops the managed process after the handback (None for a worker
        # this controller did not start)
        self.process_stopper = process_stopper
        self.poll_interval = poll_interval
        self.preempter = preempter
        self._tasks: dict[str, asyncio.Task] = {}
        # worker id → its last drain's report, kept after it ends
        self.reports: dict[str, dict] = {}

    def begin(self, worker_id: str, deadline_s: Optional[float] = None,
              stop_process: bool = True) -> dict:
        """Start a drain, or report the one running; returns a copy of
        the report."""
        wid = str(worker_id)
        if deadline_s is None:
            deadline_s = constants.drain_deadline_s()
        live = self._tasks.get(wid)
        if live is not None and not live.done():
            return dict(self.reports.get(wid, {"worker_id": wid,
                                               "phase": "draining"}))
        if not self.registry.mark_draining(wid, deadline_s=deadline_s):
            # draining or decommissioned already with no live task here
            return dict(self.reports.get(
                wid, {"worker_id": wid, "phase": self.registry.state(wid)}))
        self.reports[wid] = {
            "worker_id": wid, "phase": "draining",
            "deadline_s": deadline_s, "handed_back": {}, "held_at_start": {},
        }
        self._tasks[wid] = asyncio.ensure_future(
            self._drain(wid, deadline_s, stop_process))
        return dict(self.reports[wid])

    def undrain(self, worker_id: str) -> bool:
        """Cancel a drain in progress and reactivate the worker."""
        wid = str(worker_id)
        task = self._tasks.pop(wid, None)
        if task is not None and not task.done():
            task.cancel()
        cleared = self.registry.reactivate(wid)
        if cleared:
            self.reports.setdefault(wid, {"worker_id": wid})
            self.reports[wid]["phase"] = "reactivated"
        return cleared

    async def wait(self, worker_id: str) -> Optional[dict]:
        """Await a live drain; its report."""
        task = self._tasks.get(str(worker_id))
        if task is not None:
            try:
                await task
            except asyncio.CancelledError:
                pass
        return self.reports.get(str(worker_id))

    def status(self) -> dict:
        return {
            "states": self.registry.states(),
            "reports": {w: dict(r) for w, r in self.reports.items()},
        }

    async def close(self) -> None:
        """Cancel the drains in flight (controller shutdown). The registry
        keeps its states; no task outlives the loop."""
        for task in list(self._tasks.values()):
            if not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._tasks.clear()

    async def _drain(self, wid: str, deadline_s: float,
                     stop_process: bool) -> None:
        report = self.reports[wid]
        if self.preempter is not None:
            try:
                preempted = self.preempter()
                if preempted:
                    report["preempted_prompt"] = preempted
            except Exception as e:  # noqa: BLE001 — the deadline path still
                # runs; preemption only makes the drain faster
                report["preempt_error"] = str(e)
        report["held_at_start"] = await self.store.worker_held_tasks(wid)
        # the registry's deadline is the one the status shows: act on it
        deadline = self.registry.deadline(wid)
        if deadline is None:
            deadline = time.monotonic() + deadline_s
        try:
            while time.monotonic() < deadline:
                if self.registry.state(wid) != "draining":
                    return              # undrained meanwhile
                if not await self.store.worker_held_tasks(wid):
                    break
                await asyncio.sleep(self.poll_interval)
            # the deadline, or a clean finish (then nothing is held)
            handed = await self.store.handback_worker_tasks(wid)
            report["handed_back"] = handed
            if handed:
                log(f"drain[{wid}] deadline handback: "
                    f"{ {j: len(t) for j, t in handed.items()} }")
            if stop_process and self.process_stopper is not None:
                try:
                    report["process_stopped"] = bool(
                        await asyncio.to_thread(self.process_stopper, wid))
                except Exception as e:  # noqa: BLE001 — decommission never
                    # hangs on the process manager: the registry's state is
                    # what the fleet acts on
                    report["process_stop_error"] = str(e)
            self.registry.mark_decommissioned(wid)
            report["phase"] = "decommissioned"
        except asyncio.CancelledError:
            # undrain() sets "reactivated" right after the cancel, and this
            # handler runs on a later tick: keep its verdict
            if report.get("phase") == "draining":
                report["phase"] = "cancelled"
            raise
