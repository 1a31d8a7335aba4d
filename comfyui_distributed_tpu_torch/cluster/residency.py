"""Card-memory residency planner: several model bundles under one budget
(the port's ``cluster/residency.py``, after the JAX package's).

One controller keeps several bundles (SDXL, FLUX, WAN) on its card under
``CDT_HBM_BUDGET_GB`` of memory and swaps them deterministically instead
of accumulating them until the card runs out:

- :class:`ResidencyPlanner` is the policy: entries with (bytes,
  priority, last use); eviction order is lowest priority first, then
  least recently used; a pinned entry is never evicted. It is pure, so
  the same trace of acquires gives the same evictions in either package.
- :class:`BundleResidency` binds it to a ``ModelRegistry``: acquiring a
  bundle measures its parameters on the card, evicts victims (dropped
  from the registry, their memory given back with
  ``ModelBundle.release_device``) and touches the LRU clock.
  :meth:`BundleResidency.request` pins the base bundle for a request and
  patches a LoRA into a copy-on-write clone that the planner never sees.
- :func:`pinned_bundle` wraps each call that computes on a bundle (the
  sampler nodes, ``CLIPTextEncode``, the group executor, the stage
  pools), and :func:`registry_bundle` the decode route's, so no
  concurrent acquire evicts a bundle mid-call.

Bytes are the sizes of a bundle's parameters on the card; activations
and workspace are the caller's headroom. The planner is off at 0 (the
default). Weight sharding over several cards (``tp_shard_bytes``) waits
for ROADMAP A.6, releasing offload stores (``release_store``) for A.5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import torch

from ..utils.constants import hbm_budget_gb
from ..utils.exceptions import DistributedError
from ..utils.logging import log


class ResidencyError(DistributedError):
    """A bundle cannot be made resident under the configured budget."""


def hbm_budget_bytes() -> int:
    """The planner's budget in bytes: 0 = unlimited (planner off)."""
    return int(hbm_budget_gb() * (1 << 30))


@dataclasses.dataclass
class _Entry:
    name: str
    nbytes: int
    priority: int = 0
    last_use: int = 0
    pins: int = 0


class ResidencyPlanner:
    """Deterministic LRU/priority residency policy over named entries.

    ``on_evict(name)`` does the release (drop the registry's bundle, give
    its memory back); the planner only decides. Thread-safe: the graph
    thread and the stage pools share it."""

    def __init__(self, budget_bytes: int,
                 on_evict: Optional[Callable[[str], None]] = None):
        self.budget = int(budget_bytes)
        self.on_evict = on_evict
        self._entries: dict[str, _Entry] = {}
        self._clock = 0
        self._lock = threading.RLock()

    # --- introspection ------------------------------------------------------

    def resident(self) -> list[str]:
        """Names in eviction order (first = next victim)."""
        with self._lock:
            return [e.name for e in self._victim_order()]

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def is_resident(self, name: str) -> bool:
        return name in self._entries

    # --- policy -------------------------------------------------------------

    def _victim_order(self) -> list[_Entry]:
        return sorted(self._entries.values(),
                      key=lambda e: (e.priority, e.last_use))

    def plan(self, name: str, nbytes: int) -> list[str]:
        """The victims that would be evicted to fit ``name``, applying
        nothing. Raises :class:`ResidencyError` when nothing fits."""
        with self._lock:
            return self._plan_locked(name, int(nbytes))

    def _plan_locked(self, name: str, nbytes: int) -> list[str]:
        have = self._entries.get(name)
        used = (sum(e.nbytes for e in self._entries.values())
                - (have.nbytes if have else 0))
        if self.budget <= 0 or used + nbytes <= self.budget:
            return []
        victims = []
        for e in self._victim_order():
            if e.name == name or e.pins > 0:
                continue
            victims.append(e.name)
            used -= e.nbytes
            if used + nbytes <= self.budget:
                return victims
        if nbytes > self.budget:
            raise ResidencyError(
                f"model {name!r} needs {nbytes / 1e9:.2f} GB but the HBM "
                f"budget is {self.budget / 1e9:.2f} GB "
                "(CDT_HBM_BUDGET_GB) — it can never be resident")
        pinned = [e.name for e in self._entries.values() if e.pins > 0]
        raise ResidencyError(
            f"cannot fit {name!r} ({nbytes / 1e9:.2f} GB): "
            f"{used / 1e9:.2f} GB held by pinned bundles {pinned} under a "
            f"{self.budget / 1e9:.2f} GB budget")

    def acquire(self, name: str, nbytes: int, priority: int = 0
                ) -> list[str]:
        """Make ``name`` resident: evict the planned victims (``on_evict``
        for each), then register or touch the entry. Returns the evicted
        names in order."""
        with self._lock:
            victims = self._plan_locked(name, int(nbytes))
            for v in victims:
                self._evict_locked(v, reason="budget")
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Entry(name, int(nbytes),
                                                 int(priority))
            else:
                e.nbytes = int(nbytes)
                e.priority = int(priority)
            self._clock += 1
            e.last_use = self._clock
            self._export_gauges()
            return victims

    def touch(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is not None:
                self._clock += 1
                e.last_use = self._clock

    def release(self, name: str) -> bool:
        """Evict ``name`` by hand."""
        with self._lock:
            if name not in self._entries:
                return False
            if self._entries[name].pins > 0:
                raise ResidencyError(
                    f"cannot release {name!r}: pinned by an in-flight "
                    "request")
            self._evict_locked(name, reason="manual")
            self._export_gauges()
            return True

    def _evict_locked(self, name: str, reason: str) -> None:
        self._entries.pop(name, None)
        log(f"residency: evicting {name!r} ({reason})")
        from .. import telemetry
        from ..telemetry import metrics as _tm

        if telemetry.enabled():
            _tm.RESIDENCY_EVICTIONS.labels(reason=reason).inc()
        if self.on_evict is not None:
            self.on_evict(name)

    # --- pinning ------------------------------------------------------------

    def pin(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                raise ResidencyError(f"cannot pin non-resident {name!r}")
            e.pins += 1

    def unpin(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is not None and e.pins > 0:
                e.pins -= 1

    @contextlib.contextmanager
    def pinned(self, name: str):
        self.pin(name)
        try:
            yield
        finally:
            self.unpin(name)

    def _export_gauges(self) -> None:
        from .. import telemetry
        from ..telemetry import metrics as _tm

        if telemetry.enabled():
            _tm.RESIDENT_MODELS.set(len(self._entries))
            _tm.RESIDENT_BYTES.set(
                sum(e.nbytes for e in self._entries.values()))


def _on(t, device) -> bool:
    """``t`` lies on ``device`` (``cuda`` without an index means any
    card: a tensor always carries its card's index)."""
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def _param_bytes(modules, device) -> int:
    """Bytes of the distinct parameters of ``modules`` that lie on
    ``device`` (a parameter shared by two modules counts once)."""
    device = torch.device(device)
    seen: set[int] = set()
    total = 0
    for module in modules:
        for p in module.parameters():
            if not _on(p, device) or id(p) in seen:
                continue
            seen.add(id(p))
            total += p.numel() * p.element_size()
    return total


def tp_shard_bytes(modules, device, tp: int = 1) -> int:
    """Per-card bytes of ``modules`` under tensor-parallel sharding. The
    port shards no weights until multi-GPU serving (ROADMAP A.6), so
    every parameter counts whole: one shard, whatever ``tp``."""
    return _param_bytes(modules, device)


def _tp_rules_for(bundle):
    """The placement rules this bundle's core would shard by: none until
    ROADMAP A.6 (the JAX package's Megatron tables)."""
    return None


def bundle_bytes(bundle, tp_shards: int = 1) -> int:
    """Bytes of a loaded ``ModelBundle``'s parameters on its card: the
    core (and the low-noise expert of a dual-expert bundle), both VAE
    halves and the active text stack (``ModelBundle.device_modules``)."""
    return tp_shard_bytes(bundle.device_modules(), bundle.device, tp_shards)


class BundleResidency:
    """The planner bound to a ``ModelRegistry`` (built by the registry
    when ``CDT_HBM_BUDGET_GB`` is set)."""

    def __init__(self, registry, budget_bytes: int,
                 estimator: Callable = bundle_bytes,
                 tp_shards: Optional[int] = None):
        self._registry = registry
        self._estimator = estimator
        self._tp_shards = tp_shards
        self.planner = ResidencyPlanner(budget_bytes,
                                        on_evict=self._evict_bundle)

    def _evict_bundle(self, name: str) -> None:
        bundle = self._registry._cache.pop(name, None)
        if bundle is not None:
            bundle.release_device()

    def measure(self, bundle) -> int:
        """The planner's bytes for one bundle."""
        tp = max(1, int(self._tp_shards or 1))
        if tp > 1:
            try:
                return self._estimator(bundle, tp_shards=tp)
            except TypeError:
                pass
        return self._estimator(bundle)

    def note_use(self, name: str, bundle, priority: int = 0) -> list[str]:
        """Account a registry hit: the first sight measures and acquires
        (evicting victims), a repeat touches the LRU clock. Sizing
        follows the build, so a build may overlap a victim for a while."""
        if self.planner.is_resident(name):
            self.planner.touch(name)
            return []
        return self.planner.acquire(name, self.measure(bundle),
                                    priority=priority)

    @contextlib.contextmanager
    def request(self, name: str, lora_sd=None, **lora_kw):
        """Serve one request against ``name``, optionally with a LoRA: the
        base bundle is pinned for the duration (an acquire of another
        model may evict any other bundle, never this one) and the LoRA
        patches a copy-on-write clone the planner never registers."""
        # get → pin is not atomic against an acquire evicting the bundle
        # in between: retry until a pin lands on the registration of the
        # bundle in hand (an eviction and a rebuild in between would pin
        # the new one while this one is released)
        for _ in range(8):
            bundle = self._registry.get(name)
            try:
                self.planner.pin(name)
            except ResidencyError:
                continue
            if not getattr(bundle, "released", False):
                break
            self.planner.unpin(name)
        else:
            raise ResidencyError(
                f"could not pin {name!r}: concurrent acquires keep "
                "evicting it (budget thrash — raise CDT_HBM_BUDGET_GB)")
        try:
            if lora_sd is None:
                yield bundle
            else:
                from ..models.lora import apply_lora

                patched, _ = apply_lora(bundle, lora_sd, **lora_kw)
                yield patched
        finally:
            self.planner.unpin(name)


@contextlib.contextmanager
def pinned_bundle(bundle):
    """Pin a registry bundle for one call on it (nothing without a
    planner), so that no concurrent acquire releases it mid-call.

    Raises :class:`ResidencyError` when the bundle was evicted before the
    pin landed: its parameters are gone (``ModelBundle.release_device``),
    so the call could not compute. The JAX package proceeds there, on
    arrays an eviction leaves alive."""
    res = getattr(bundle, "_residency", None)
    name = getattr(getattr(bundle, "preset", None), "name", None)
    if res is None or name is None:
        yield
        return
    try:
        res.planner.pin(name)
    except ResidencyError:
        raise _evicted(name) from None
    if getattr(bundle, "released", False):
        # the pin landed on a rebuilt registration, not on this bundle
        res.planner.unpin(name)
        raise _evicted(name)
    try:
        yield
    finally:
        res.planner.unpin(name)


def _evicted(name: str) -> ResidencyError:
    return ResidencyError(
        f"model {name!r} was evicted before its call could pin it — a "
        "concurrent request's model took its memory (raise "
        "CDT_HBM_BUDGET_GB)")


@contextlib.contextmanager
def registry_bundle(registry, name: str):
    """The registry's bundle ``name``, pinned for the caller's block when
    the registry has a planner (``BundleResidency.request``)."""
    res = getattr(registry, "residency", None)
    if res is None:
        yield registry.get(name)
        return
    with res.request(name) as bundle:
        yield bundle
