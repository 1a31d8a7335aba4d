"""The fleet tier of the content cache: one keyspace over the configured
hosts (the port's ``cluster/cache/fleet.py``, after the JAX package's).

The per-host cache (memory LRU and a checksummed local disk) answers
only what its own host computed, so a duplicate request that lands on
another host runs again. This tier spreads the result keyspace over the
fleet:

- **Consistent-hash ring** (:class:`HashRing`): each member places
  ``CDT_FLEET_CACHE_VNODES`` virtual nodes at SHA-256 positions of
  (seed, member, index). Placement is a pure function, so every
  controller that shares ``CDT_FLEET_CACHE_SEED`` computes the same
  owners from the same members, the JAX package's too. Membership comes
  from the configured hosts, less those the elastic fleet's
  ``DRAIN`` registry marks as leaving; a join claims only its own arcs.
- **Remote serves and fills** over ``GET/PUT
  /distributed/cache/entry/{key}``, in the checksummed array wire form
  of ``cluster/stages/latents`` (byte for byte JAX's). The ladder is
  local memory → local disk → ring owner → recompute. A dead, slow or
  disagreeing owner is a miss, never an error, and never a failure on
  the owner's circuit breaker: a cache probe must not shed serving
  capacity to save a recompute.
- **Asynchronous fills**: after a local fill the serve path calls
  :meth:`FleetCache.fill` and goes on; the PUT runs on the controller's
  loop.
- **Drain handback**: a controller marked draining moves the memory
  entries of its shard to their owners on the ring without it, each key
  once.
- **Near tier** (:class:`NearTier`, opt in with ``cache: "near"``): a
  request equal to an earlier one but for its seed starts from that
  donor's mid-trajectory latent and runs only the rest of the ladder
  under its own seed. Its image is approximate by design and never
  fills the exact result tier.

The tiers hold CPU torch tensors; the wire and the transport hook carry
numpy arrays (fp32 bits kept). ``CDT_FLEET_CACHE=0`` (or ``CDT_CACHE=0``)
builds nothing, and every call site keeps the per-host path.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from ... import telemetry
from ...telemetry import metrics as _tm
from ...utils import constants
from ...utils.logging import debug_log, log
from ...utils.network import http_request_async
from ..elastic.states import DRAIN, DRAINING
from ..resilience import BREAKERS, RetryPolicy
from . import keys as _keys


def _count_remote(op: str, outcome: str) -> None:
    if telemetry.enabled():
        _tm.FLEET_CACHE_REMOTE.labels(op=op, outcome=outcome).inc()


def _host_arrays(arrays: dict) -> dict:
    """name → host numpy array (a CPU tensor's own bytes, a card tensor
    copied to the host): what the wire and the transport carry."""
    out = {}
    for n, a in arrays.items():
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu").numpy()
        out[str(n)] = np.asarray(a)
    return out


def _tensors(arrays: dict) -> dict:
    """name → CPU tensor, what the tiers hold."""
    return {n: (a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.array(a, copy=True)))
            for n, a in arrays.items()}


def decode_entry(body: bytes) -> Optional[dict]:
    """A ``GET /distributed/cache/entry/{key}`` answer → name → numpy
    array, or None when it carries no arrays. A payload that does not
    verify raises ``LatentWireError``."""
    from ..stages.latents import decode_array_payload

    payloads = json.loads(body).get("arrays")
    if not isinstance(payloads, dict) or not payloads:
        return None
    return {str(n): decode_array_payload(p) for n, p in payloads.items()}


def encode_entry(key: str, arrays: dict) -> dict:
    """The body of a ``PUT /distributed/cache/entry/{key}`` and of the
    GET's answer: each array checksummed."""
    from ..stages.latents import encode_array_payload

    return {"key": key, "arrays": {n: encode_array_payload(a)
                                   for n, a in _host_arrays(arrays).items()}}


class HashRing:
    """Deterministic consistent-hash ring over member ids: each vnode at
    ``digest("ring", seed, member, i)``, each key at
    ``digest("ring-key", key)``, the owner the next vnode clockwise."""

    def __init__(self, members, vnodes: Optional[int] = None,
                 seed: Optional[str] = None):
        self.vnodes = (constants.fleet_cache_vnodes() if vnodes is None
                       else int(vnodes))
        self.seed = (constants.fleet_cache_seed() if seed is None
                     else str(seed))
        points: list[tuple[int, str]] = []
        for member in sorted(set(str(m) for m in members)):
            for i in range(max(1, self.vnodes)):
                pos = int(_keys.digest("ring", self.seed, member,
                                       str(i))[:16], 16)
                points.append((pos, member))
        points.sort()
        self._points = points
        self._positions = [p for p, _ in points]

    def members(self) -> list:
        return sorted(set(m for _, m in self._points))

    def __len__(self) -> int:
        return len(self.members())

    def owner(self, key: str) -> Optional[str]:
        """The member owning ``key`` (wrapping around), None on an empty
        ring."""
        if not self._points:
            return None
        pos = int(_keys.digest("ring-key", str(key))[:16], 16)
        idx = bisect.bisect_right(self._positions, pos) % len(self._points)
        return self._points[idx][1]


class NearTier:
    """Seedless near key → a donor's mid-trajectory checkpoint, in a
    memory-only ``CheckpointStore``. A lookup validates the donor's
    identity (everything but the seed); a mismatch drops the donor and
    counts, and the caller computes from scratch."""

    def __init__(self, max_entries: Optional[int] = None):
        from ...diffusion.checkpoint import CheckpointStore

        self.store = CheckpointStore(directory="")
        self.max_entries = (constants.fleet_cache_near_max()
                            if max_entries is None else int(max_entries))
        self._map: "OrderedDict[str, str]" = OrderedDict()
        self._lock = threading.Lock()
        self.counts = {"donor": 0, "reuse": 0, "steps_saved": 0,
                       "mismatch": 0}

    def offer(self, near_k: str, ckpt) -> Optional[str]:
        """Park a donor under its near key: the latest donor wins, the
        least recently used key goes past ``CDT_FLEET_CACHE_NEAR_MAX``.
        Returns the checkpoint id."""
        if self.max_entries <= 0:
            return None
        cid = self.store.park(ckpt)
        dropped: list[str] = []
        with self._lock:
            old = self._map.pop(near_k, None)
            self._map[near_k] = cid
            if old is not None and old != cid:
                dropped.append(old)
            while len(self._map) > self.max_entries:
                _, evicted = self._map.popitem(last=False)
                if evicted != cid:
                    dropped.append(evicted)
            self.counts["donor"] += 1
        for c in dropped:
            self.store.drop(c)
        return cid

    def lookup(self, near_k: str, expect_meta: dict):
        """The donor under ``near_k`` whose identity matches
        ``expect_meta`` (which holds no ``seed``), or None."""
        with self._lock:
            cid = self._map.get(near_k)
        if cid is None:
            return None
        ckpt = self.store.get(cid)
        if ckpt is None:
            with self._lock:
                if self._map.get(near_k) == cid:
                    del self._map[near_k]
            return None
        try:
            ckpt.validate_meta(expect_meta)
        except Exception as e:  # noqa: BLE001 — a mismatch is a miss
            debug_log(f"fleet.near: donor {cid} rejected: {e}")
            with self._lock:
                self.counts["mismatch"] += 1
                if self._map.get(near_k) == cid:
                    del self._map[near_k]
            self.store.drop(cid)
            return None
        with self._lock:
            if near_k in self._map:
                self._map.move_to_end(near_k)
        return ckpt

    def record_reuse(self, steps_saved: int) -> None:
        with self._lock:
            self.counts["reuse"] += 1
            self.counts["steps_saved"] += int(steps_saved)
        if telemetry.enabled():
            _tm.FLEET_NEAR_REUSE.inc()
            _tm.FLEET_NEAR_STEPS_SAVED.inc(int(steps_saved))

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._map),
                    "max_entries": self.max_entries, **self.counts}


class FleetCache:
    """Ring ownership, remote serve and fill, and the drain handback.

    ``membership`` returns ``{member id: base URL or None}`` for the
    configured fleet (the controller's host config); members the
    ``DRAIN`` registry marks as leaving are left out here. ``transport``
    lets tests stand in an async ``(op, owner, url, key, arrays)`` for
    HTTP: a ``get`` returns name → array or None, a ``put`` stores."""

    def __init__(self, manager, self_id: str,
                 membership: Callable[[], dict],
                 transport: Optional[Callable] = None):
        self.manager = manager
        self.self_id = str(self_id) or "master"
        self._membership = membership
        self._transport = transport
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._lock = threading.Lock()
        self._ring_cache: Optional[tuple] = None
        # strong references to the fills and handbacks in flight (a bare
        # run_coroutine_threadsafe future can be collected mid-flight)
        self._pending: set = set()
        self._handed: set = set()
        self.counts = {"remote_hit": 0, "remote_miss": 0,
                       "remote_error": 0, "remote_skipped": 0,
                       "fill": 0, "fill_error": 0, "handback": 0}
        self.near = NearTier()
        # the ladder's next rung is a recompute: retrying hard buys little
        self._retry = RetryPolicy(max_attempts=2, base=0.1, cap=0.5)
        DRAIN.subscribe(self._on_lifecycle)

    # --- lifecycle ----------------------------------------------------------

    def attach_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        """The controller's serving loop; until then probes and fills are
        skipped (the ladder stays local)."""
        self.loop = loop

    def close(self) -> None:
        """Off the drain feed; the fills still in flight are cancelled
        (the loop that runs them is stopping)."""
        DRAIN.unsubscribe(self._on_lifecycle)
        for fut in list(self._pending):
            fut.cancel()

    def _on_lifecycle(self, worker_id: str, state: str) -> None:
        with self._lock:
            self._ring_cache = None       # any transition can change it
        if worker_id == self.self_id and state == DRAINING:
            loop = self.loop
            if loop is not None and loop.is_running():
                self._track(asyncio.run_coroutine_threadsafe(
                    self.handback(), loop))

    def _track(self, fut) -> None:
        self._pending.add(fut)
        fut.add_done_callback(self._pending.discard)

    # --- the ring -----------------------------------------------------------

    def _raw_members(self) -> dict:
        try:
            members = dict(self._membership() or {})
        except Exception as e:  # noqa: BLE001 — membership never throws
            debug_log(f"fleet: membership failed: {e}")
            members = {}
        members.setdefault(self.self_id, None)
        return {str(k): v for k, v in members.items()}

    def _active_members(self) -> dict:
        return {wid: url for wid, url in self._raw_members().items()
                if not DRAIN.is_leaving(wid)}

    def ring(self) -> tuple:
        """(HashRing, {member: url}) over the active members, rebuilt
        only when the sorted member set changes."""
        members = self._active_members()
        signature = tuple(sorted(members))
        with self._lock:
            cached = self._ring_cache
            if cached is not None and cached[0] == signature:
                return cached[1], members
        ring = HashRing(signature)
        with self._lock:
            self._ring_cache = (signature, ring)
        if telemetry.enabled():
            _tm.FLEET_RING_SIZE.set(len(ring))
        return ring, members

    def owner_of(self, key: str) -> tuple:
        ring, members = self.ring()
        owner = ring.owner(key)
        return owner, members.get(owner)

    # --- remote serve (the ladder's third rung) -------------------------------

    def _skip(self) -> None:
        self._count("remote_skipped")
        _count_remote("get", "skipped")

    def probe(self, key: str) -> Optional[dict]:
        """Ask ``key``'s ring owner for the entry, from a pool or graph
        thread once both local tiers missed: name → CPU tensor, or None.
        Never raises and never waits past ``CDT_FLEET_CACHE_TIMEOUT_S``;
        on the loop's own thread, with no loop, with the owner's breaker
        open, on a timeout or a payload that does not verify, a miss."""
        try:
            owner, url = self.owner_of(key)
        except Exception:  # noqa: BLE001 — ring trouble is a miss
            return None
        if owner is None or owner == self.self_id or not url:
            return None
        if not BREAKERS.allow(owner):
            self._skip()
            return None
        loop = self.loop
        if loop is None or not loop.is_running():
            self._skip()
            return None
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            # blocking the loop on itself would deadlock
            self._skip()
            return None
        fut = asyncio.run_coroutine_threadsafe(
            self._get_remote(owner, url, key), loop)
        try:
            arrays = fut.result(constants.fleet_cache_timeout_s())
        except Exception as e:  # noqa: BLE001 — degrade to a miss
            fut.cancel()              # a late answer is not waited for
            debug_log(f"fleet: probe of {owner} for {key[:12]}… "
                      f"failed: {e!r}")
            self._count("remote_error")
            _count_remote("get", "error")
            return None
        if arrays is None:
            self._count("remote_miss")
            _count_remote("get", "miss")
            return None
        self._count("remote_hit")
        _count_remote("get", "hit")
        return _tensors(arrays)

    async def _get_remote(self, owner: str, url: str,
                          key: str) -> Optional[dict]:
        if self._transport is not None:
            result = await self._transport("get", owner, url, key, None)
            BREAKERS.record(owner, ok=True)
            return result
        timeout = constants.fleet_cache_timeout_s()

        async def once():
            status, body = await http_request_async(
                f"{url}/distributed/cache/entry/{key}", timeout=timeout)
            if status == 404:
                return None
            if status != 200:
                raise OSError(f"{owner} answered {status}")
            # base64, npz and SHA-256 of an image off the loop
            return await asyncio.get_running_loop().run_in_executor(
                None, decode_entry, body)

        result = await self._retry.run(once, op="fleet.get")
        # a success feeds the breaker; a failure deliberately does not
        BREAKERS.record(owner, ok=True)
        return result

    # --- asynchronous fill ----------------------------------------------------

    def fill(self, key: str, arrays: dict) -> None:
        """Send a freshly computed entry to its ring owner and return at
        once. Nothing happens when this host owns the key, the owner's
        breaker is open, or no loop is attached."""
        try:
            owner, url = self.owner_of(key)
        except Exception:  # noqa: BLE001
            return
        if owner is None or owner == self.self_id or not url:
            return
        if not BREAKERS.allow(owner):
            _count_remote("put", "skipped")
            return
        loop = self.loop
        if loop is None or not loop.is_running():
            return
        self._track(asyncio.run_coroutine_threadsafe(
            self._put_remote(owner, url, key, _host_arrays(arrays)), loop))

    async def _put_remote(self, owner: str, url: str, key: str,
                          arrays: dict, op: str = "put") -> bool:
        try:
            if self._transport is not None:
                await self._transport("put", owner, url, key, arrays)
            else:
                await self._put_http(url, key, arrays)
        except Exception as e:  # noqa: BLE001 — a lost fill is a lost hit
            debug_log(f"fleet: {op} to {owner} for {key[:12]}… "
                      f"failed: {e!r}")
            self._count("fill_error")
            _count_remote(op, "error")
            return False
        BREAKERS.record(owner, ok=True)
        self._count("fill" if op == "put" else "handback")
        _count_remote(op, "hit")
        return True

    async def _put_http(self, url: str, key: str, arrays: dict) -> None:
        timeout = constants.fleet_cache_timeout_s()
        loop = asyncio.get_running_loop()
        body = await loop.run_in_executor(
            None, lambda: json.dumps(encode_entry(key, arrays)).encode())

        async def once():
            status, answer = await http_request_async(
                f"{url}/distributed/cache/entry/{key}", body,
                {"Content-Type": "application/json"}, timeout=timeout,
                method="PUT")
            if status != 200:
                raise OSError(f"PUT answered {status}: {answer[:200]!r}")

        await self._retry.run(once, op="fleet.put")

    # --- drain handback -------------------------------------------------------

    async def handback(self) -> list:
        """Move this draining host's shard to its owners on the ring
        without it: each key once, memory entries only (the persisted
        ones are durable and content-addressed), each dropped from this
        host's memory tier once moved. Returns the moved keys."""
        raw = self._raw_members()
        pre = HashRing(tuple(sorted(
            wid for wid in raw
            if wid == self.self_id or not DRAIN.is_leaving(wid))))
        post_members = {wid: u for wid, u in raw.items()
                        if wid != self.self_id
                        and not DRAIN.is_leaving(wid) and u}
        if not post_members:
            return []
        post = HashRing(tuple(sorted(post_members)))
        tier = self.manager.results
        moved = []
        for key in tier.keys():
            if pre.owner(key) != self.self_id:
                continue
            with self._lock:
                if key in self._handed:
                    continue
            new_owner = post.owner(key)
            url = post_members.get(new_owner)
            arrays = tier.peek(key)
            if not url or arrays is None:
                continue
            if await self._put_remote(new_owner, url, key,
                                      _host_arrays(arrays), op="handback"):
                with self._lock:
                    self._handed.add(key)
                # the entry now lives in exactly one memory tier
                tier.drop_memory(key)
                moved.append(key)
        if moved:
            log(f"fleet: drain handback moved {len(moved)} cache entries "
                f"off {self.self_id}")
        return moved

    # --- bookkeeping ----------------------------------------------------------

    def _count(self, outcome: str) -> None:
        with self._lock:
            self.counts[outcome] = self.counts.get(outcome, 0) + 1

    def stats(self) -> dict:
        ring, _ = self.ring()
        with self._lock:
            counts = dict(self.counts)
        return {"self": self.self_id, "ring_size": len(ring),
                "members": ring.members(), "vnodes": ring.vnodes,
                **counts, "near": self.near.stats()}


def build_fleet_cache(manager, self_id: str,
                      membership: Callable[[], dict],
                      transport: Optional[Callable] = None
                      ) -> Optional[FleetCache]:
    """The fleet tier, or None when the per-host cache is off or under
    ``CDT_FLEET_CACHE=0``."""
    if manager is None or not constants.fleet_cache():
        return None
    return FleetCache(manager, self_id, membership, transport=transport)
