"""The autoscaler: size the fleet to the offered work (the port's copy of
the JAX package's ``cluster/elastic/autoscaler.py``).

A policy loop over signals the controller has already: the front door's
denoise-facing depth, the tile backlog across open jobs, the content
cache's hit rate and the sampler's step time. Its decisions:

- **pressure** = cache-discounted work / capacity (active workers + the
  master, which always serves);
- **hysteresis**: pressure must stay at or above ``scale_up_depth`` (at
  or below ``scale_down_depth``) for N evaluations in a row first;
- **cooldowns**: separate refractory windows up and down (adding
  capacity is quick, removing it reluctant);
- **envelope**: ``[min_workers, max_workers]``, never left.

A :class:`ScaleProvider` carries them out. :class:`LocalProcessProvider`
launches and drains the managed local processes of
``workers/process_manager.py``; other capacity plugs in through
``CDT_SCALE_PROVIDER`` (``module:factory``). A scale-down is never a
kill: it begins a drain (:mod:`.drain`). Every verdict, holds too, is
counted in ``cdt_autoscale_decisions_total{direction,reason}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Optional, Protocol

from ... import telemetry
from ...telemetry import metrics as _tm
from ...utils import constants
from ...utils.logging import debug_log, log
from .states import DRAIN, DrainRegistry


@dataclasses.dataclass(frozen=True)
class FleetSignals:
    """One evaluation's inputs, each read at that instant.

    ``queue_depth`` is the denoise-facing depth (queued or executing
    prompts and the front door's window: work that needs the card);
    ``encode_depth``/``decode_depth`` are the host-side stage pools'
    backlogs, reported but never part of the pressure (a decode pile-up
    wants decode threads, not another card)."""

    queue_depth: int
    tile_depth: int             # pending tile tasks across open jobs
    step_time_p50: Optional[float] = None   # reported only
    active_workers: int = 0
    draining_workers: int = 0
    decommissioned_workers: int = 0
    # recent share of queued fingerprinted requests the result cache
    # answered without a sampler run
    cache_hit_rate: float = 0.0
    encode_depth: int = 0
    decode_depth: int = 0

    @property
    def work(self) -> int:
        return self.queue_depth + self.tile_depth

    @property
    def effective_work(self) -> float:
        """Queued work less the share the cache answers (such a request
        holds a queue slot for microseconds, not a sampler run); tiles do
        not ride the cache and count whole."""
        rate = min(max(self.cache_hit_rate, 0.0), 1.0)
        return self.queue_depth * (1.0 - rate) + self.tile_depth


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    min_workers: int = 0
    max_workers: int = 4
    scale_up_depth: float = 4.0     # work a capacity unit → add a worker
    scale_down_depth: float = 0.5   # work a capacity unit → drain one
    up_streak: int = 2              # evaluations in a row before acting
    down_streak: int = 4
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 120.0

    @classmethod
    def from_env(cls) -> "AutoscalePolicy":
        return cls(
            min_workers=constants.autoscale_min(),
            max_workers=constants.autoscale_max(),
            scale_up_depth=constants.autoscale_up_depth(),
            scale_down_depth=constants.autoscale_down_depth(),
            up_streak=constants.autoscale_up_streak(),
            down_streak=constants.autoscale_down_streak(),
            up_cooldown_s=constants.autoscale_up_cooldown_s(),
            down_cooldown_s=constants.autoscale_down_cooldown_s(),
        )


@dataclasses.dataclass(frozen=True)
class Decision:
    direction: str              # up | down | hold
    reason: str
    worker_id: Optional[str] = None
    pressure: float = 0.0


class ScaleProvider(Protocol):
    """What the policy loop needs of a capacity backend."""

    def list_workers(self) -> dict[str, dict]:
        """worker id → {"state": lifecycle state, "running": bool}."""
        ...

    def scale_up(self) -> Optional[str]:
        """Bring one worker up; its id (None: no capacity)."""
        ...

    def scale_down(self, worker_id: str) -> None:
        """Begin a graceful departure (a drain, never a kill)."""
        ...


class LocalProcessProvider:
    """The managed local worker processes as the capacity pool.

    A scale-up launches the first enabled ``local`` host of the config
    that is not running; a scale-down hands the worker to the drain
    coordinator. ``get_manager()`` returns the ``WorkerProcessManager``
    (a controller builds its manager at first use)."""

    def __init__(self, config_loader, get_manager, coordinator,
                 registry: DrainRegistry = DRAIN):
        self.load_config = config_loader
        self.get_manager = get_manager
        self.coordinator = coordinator
        self.registry = registry

    def _local_hosts(self) -> list[dict]:
        return [h for h in self.load_config().get("hosts", [])
                if h.get("type") == "local" and h.get("enabled", True)
                and h.get("id")]

    def list_workers(self) -> dict[str, dict]:
        managed = self.get_manager().get_managed_workers()
        out: dict[str, dict] = {}
        for h in self._local_hosts():
            wid = str(h["id"])
            out[wid] = {"state": self.registry.state(wid),
                        "running": wid in managed}
        for wid in managed:
            out.setdefault(wid, {"state": self.registry.state(wid),
                                 "running": True})
        return out

    def scale_up(self) -> Optional[str]:
        manager = self.get_manager()
        managed = manager.get_managed_workers()
        for h in self._local_hosts():
            wid = str(h["id"])
            if wid in managed:
                continue
            # a drained id coming back is a fresh worker
            self.registry.reactivate(wid)
            try:
                manager.launch_worker(wid)
            except Exception as e:  # noqa: BLE001 — one host that cannot
                # start must not end the sweep over the rest
                debug_log(f"autoscale: launch {wid} failed: {e}")
                continue
            return wid
        return None

    def scale_down(self, worker_id: str) -> None:
        self.coordinator.begin(worker_id)


class Autoscaler:
    """The policy loop: ``evaluate()`` is one tick on an injected clock,
    ``run()`` the controller's background task around it."""

    def __init__(self, signals: Callable[[], FleetSignals],
                 provider: ScaleProvider,
                 policy: Optional[AutoscalePolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.signals = signals
        self.provider = provider
        self.policy = policy or AutoscalePolicy.from_env()
        self._clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._last_up = float("-inf")
        self._last_down = float("-inf")
        self.decisions: list[Decision] = []      # the last 50

    def evaluate(self) -> Decision:
        pol = self.policy
        sig = self.signals()
        now = self._clock()
        # the master always serves: capacity is never zero, so a fleet of
        # no workers with a deep queue still reads as pressed
        capacity = max(1, sig.active_workers + 1)
        pressure = sig.effective_work / capacity
        if pressure >= pol.scale_up_depth:
            self._up_streak += 1
            self._down_streak = 0
        elif pressure <= pol.scale_down_depth:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        decision = self._decide(sig, now, pressure)
        self._record(decision, sig)
        return decision

    def _decide(self, sig: FleetSignals, now: float,
                pressure: float) -> Decision:
        pol = self.policy
        if self._up_streak >= pol.up_streak:
            if sig.active_workers >= pol.max_workers:
                return Decision("hold", "envelope_max", pressure=pressure)
            if now - self._last_up < pol.up_cooldown_s:
                return Decision("hold", "cooldown", pressure=pressure)
            wid = self.provider.scale_up()
            if wid is None:
                return Decision("hold", "no_capacity", pressure=pressure)
            self._last_up = now
            self._up_streak = 0
            log(f"autoscale: scale UP -> {wid} "
                f"(pressure {pressure:.2f}, work {sig.work})")
            return Decision("up", "queue_pressure", worker_id=wid,
                            pressure=pressure)
        if self._down_streak >= pol.down_streak:
            if sig.active_workers <= pol.min_workers:
                return Decision("hold", "envelope_min", pressure=pressure)
            if now - self._last_down < pol.down_cooldown_s:
                return Decision("hold", "cooldown", pressure=pressure)
            wid = self._pick_scale_down()
            if wid is None:
                return Decision("hold", "no_candidate", pressure=pressure)
            self.provider.scale_down(wid)
            self._last_down = now
            self._down_streak = 0
            log(f"autoscale: scale DOWN (drain) -> {wid} "
                f"(pressure {pressure:.2f})")
            return Decision("down", "idle_fleet", worker_id=wid,
                            pressure=pressure)
        return Decision("hold", "steady", pressure=pressure)

    def _pick_scale_down(self) -> Optional[str]:
        """The lexicographically last running, active worker: stable under
        replay, and away from the long-lived first hosts of a config."""
        workers = self.provider.list_workers()
        candidates = sorted(
            wid for wid, info in workers.items()
            if info.get("running") and info.get("state") == "active")
        return candidates[-1] if candidates else None

    def _record(self, decision: Decision, sig: FleetSignals) -> None:
        self.decisions.append(decision)
        del self.decisions[:-50]
        if telemetry.enabled():
            _tm.AUTOSCALE_DECISIONS.labels(direction=decision.direction,
                                           reason=decision.reason).inc()
            # from this tick's signals: no second list_workers()
            _tm.FLEET_SIZE.labels(state="active").set(sig.active_workers)
            _tm.FLEET_SIZE.labels(state="draining").set(
                sig.draining_workers)
            _tm.FLEET_SIZE.labels(state="decommissioned").set(
                sig.decommissioned_workers)

    async def run(self, interval_s: Optional[float] = None) -> None:
        interval_s = (constants.autoscale_interval_s()
                      if interval_s is None else interval_s)
        while True:
            try:
                self.evaluate()
            except Exception as e:  # noqa: BLE001 — the loop outlives a
                # transient signal or provider error; the next tick reads
                # everything again
                debug_log(f"autoscale tick failed: {e!r}")
            await asyncio.sleep(interval_s)

    def status(self) -> dict:
        sig = self.signals()
        return {
            "policy": dataclasses.asdict(self.policy),
            "signals": dataclasses.asdict(sig),
            "pressure": round(
                sig.effective_work / max(1, sig.active_workers + 1), 3),
            "streaks": {"up": self._up_streak, "down": self._down_streak},
            "recent_decisions": [dataclasses.asdict(d)
                                 for d in self.decisions[-10:]],
            "workers": self.provider.list_workers(),
        }
