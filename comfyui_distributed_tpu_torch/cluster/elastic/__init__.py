"""The elastic fleet (the port's copy of the JAX package's
``cluster/elastic``): workers that arrive and leave on purpose, where the
resilience layer (``cluster/resilience.py``) handles workers that die.

- :mod:`states`: the lifecycle registry (active → draining →
  decommissioned) that every site gathering failure evidence consults,
  so a planned departure never reads as a fault;
- :mod:`drain`: graceful drain and decommission: no new work, held work
  finishes or is handed back at a deadline, then the process stops;
- :mod:`autoscaler`: the policy loop that sizes the fleet to the offered
  work, with hysteresis, cooldowns, a min/max envelope and a capacity
  provider (local processes, or ``CDT_SCALE_PROVIDER``);
- :mod:`scheduler`: the deterministic cross-job steal policy behind
  ``JobStore.request_any_work``.

:class:`ElasticManager` binds them to one controller; ``GET
/distributed/elastic`` and the drain routes talk to it.
"""

from __future__ import annotations

import asyncio
import importlib
from typing import Optional

from ...utils import constants
from ...utils.logging import log
from .autoscaler import (AutoscalePolicy, Autoscaler, Decision, FleetSignals,
                         LocalProcessProvider, ScaleProvider)
from .drain import DrainCoordinator
from .scheduler import JobView, StealPolicy
from .states import ACTIVE, DECOMMISSIONED, DRAIN, DRAINING, DrainRegistry

__all__ = [
    "ACTIVE", "DRAINING", "DECOMMISSIONED", "DRAIN", "DrainRegistry",
    "DrainCoordinator", "Autoscaler", "AutoscalePolicy", "Decision",
    "FleetSignals", "ScaleProvider", "LocalProcessProvider", "StealPolicy",
    "JobView", "ElasticManager", "build_elastic", "autoscale_enabled",
]


def autoscale_enabled() -> bool:
    return constants.autoscale()


def _step_time_p50() -> Optional[float]:
    """The median sampler step from the ``cdt_sampler_step_seconds``
    histogram, every pipeline merged: the latency the autoscaler reports
    beside its pressure. None before the first sampled run, or with
    telemetry off."""
    from ... import telemetry

    if not telemetry.enabled():
        return None
    fam = telemetry.REGISTRY.snapshot().get("cdt_sampler_step_seconds")
    series = (fam or {}).get("series") or []
    total = sum(s.get("count", 0) for s in series)
    if not total:
        return None
    # the pipelines share their bounds: merge the cumulative buckets
    merged: dict[float, int] = {}
    for s in series:
        for le, cum in s.get("buckets", []):
            merged[le] = merged.get(le, 0) + cum
    target = total / 2
    for le in sorted(merged):
        if merged[le] >= target:
            return le
    return None


def _load_provider_factory():
    """``CDT_SCALE_PROVIDER="pkg.mod:factory"`` → a callable(controller)
    that builds a :class:`ScaleProvider`. A spec that does not load is
    logged and the local provider is used, as in the JAX package: a typo
    in the variable does not take autoscaling down."""
    spec = constants.scale_provider()
    if not spec:
        return None
    try:
        mod_name, _, attr = spec.partition(":")
        mod = importlib.import_module(mod_name)
        return getattr(mod, attr or "build_provider")
    except Exception as e:  # noqa: BLE001 — fall back, loudly
        log(f"elastic: bad CDT_SCALE_PROVIDER={spec!r} ({e}); "
            "using the local process provider")
        return None


class ElasticManager:
    """One controller's elastic surface: drains always, the autoscaler
    loop under ``CDT_AUTOSCALE=1``. Built on the controller's loop at
    startup (a drain is a task of that loop)."""

    def __init__(self, controller):
        self.controller = controller
        self.registry = DRAIN

        def manager():
            # built at first use by the controller (it persists the PIDs
            # into the config)
            return controller.worker_manager

        def preempt_for_drain():
            pre = getattr(controller, "preemption", None)
            return (pre.preempt_executing("drain")
                    if pre is not None else None)

        self.coordinator = DrainCoordinator(
            controller.store,
            process_stopper=lambda wid: manager().stop_worker(wid),
            preempter=preempt_for_drain)
        factory = _load_provider_factory()
        if factory is not None:
            self.provider: ScaleProvider = factory(controller)
        else:
            self.provider = LocalProcessProvider(
                controller.load_config, manager, self.coordinator)
        self.autoscaler = Autoscaler(self._signals, self.provider)
        self._task: Optional[asyncio.Task] = None

    def _signals(self) -> FleetSignals:
        c = self.controller
        fd = getattr(c, "frontdoor", None)
        # the denoise-facing depth: the stage pools' host backlog is
        # reported apart and never sizes the card fleet
        queue_depth = (fd.denoise_depth() if fd is not None
                       else c.queue.queue_remaining)
        stages = getattr(c, "stages", None)
        stage_depths = stages.depths() if stages is not None else {}
        # an unlocked read of list lengths: a gauge-grade signal, and the
        # hysteresis absorbs one stale tick
        tile_depth = sum(len(j.pending) for j in c.store.tile_jobs.values())
        workers = self.provider.list_workers()
        active = sum(1 for w in workers.values()
                     if w.get("running") and w.get("state") == ACTIVE)
        draining = sum(1 for w in workers.values()
                       if w.get("state") == DRAINING)
        decommissioned = sum(1 for w in workers.values()
                             if w.get("state") == DECOMMISSIONED)
        cache = getattr(c, "cache", None)
        hit_rate = cache.hit_rate() if cache is not None else 0.0
        return FleetSignals(queue_depth=queue_depth, tile_depth=tile_depth,
                            step_time_p50=_step_time_p50(),
                            active_workers=active,
                            draining_workers=draining,
                            decommissioned_workers=decommissioned,
                            cache_hit_rate=hit_rate,
                            encode_depth=stage_depths.get("encode", 0),
                            decode_depth=stage_depths.get("decode", 0))

    def start(self) -> None:
        """Start the autoscaler's loop under ``CDT_AUTOSCALE=1``, on a
        master only. A worker has no fleet to size, and one its master
        launched inherits the master's environment and config: its own
        loop would take the master's managed processes for its fleet
        and could drain itself."""
        if self.controller.is_worker:
            return
        if autoscale_enabled() and (self._task is None or self._task.done()):
            log("elastic: autoscaler loop up (CDT_AUTOSCALE=1)")
            self._task = asyncio.ensure_future(self.autoscaler.run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.coordinator.close()

    def status(self) -> dict:
        return {
            "autoscale_enabled": autoscale_enabled(),
            "autoscaler_running": self._task is not None and not self._task.done(),
            "autoscaler": self.autoscaler.status(),
            "drain": self.coordinator.status(),
        }


def build_elastic(controller) -> ElasticManager:
    return ElasticManager(controller)
