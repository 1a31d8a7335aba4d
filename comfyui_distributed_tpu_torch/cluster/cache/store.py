"""Size-capped LRU cache tier with checksummed persistence (the port's
``cluster/cache/store.py``; the JAX package's holds numpy arrays, this
one CPU torch tensors, and has no pinning: nothing of the port pins an
entry yet).

One :class:`CacheTier` per tier (conditioning, result): least recently
used out under a byte budget.

Persistence follows the ``utils/jsonio`` contract, with a binary sidecar
per entry:

- the **index** (``<tier>_index.json``) is read, merged and atomically
  written under an advisory file lock, so concurrent writers union;
- each **entry** is one ``.npz`` sidecar written tmp + ``os.replace``,
  its SHA-256 recorded in the index. A load recomputes the checksum; a
  mismatch is rejected loudly (log + ``cdt_cache_corrupt_total``), the
  entry is deleted and the caller recomputes: a flipped bit on disk
  never becomes a served byte.

Entries with a dtype numpy does not hold bit for bit (bfloat16) stay in
memory only, as the JAX package keeps its non-standard dtypes.
"""

from __future__ import annotations

import contextlib
import io
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ...utils.jsonio import atomic_write_json, read_json
from ...utils.logging import debug_log, log
from . import keys as _keys

# dtypes whose .npz round trip is bit-exact
_PERSISTABLE = frozenset({
    torch.float16, torch.float32, torch.float64, torch.uint8, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.bool})


def _tier_metrics():
    """(enabled, metrics module); telemetry is never load-bearing."""
    try:
        from ... import telemetry
        from ...telemetry import metrics as _tm

        return telemetry.enabled(), _tm
    except Exception:  # noqa: BLE001
        return False, None


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor that owns its bytes (a device tensor is copied to the
    host; a host one is copied too, so the caller's later writes never
    reach the cache)."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.array(a, copy=True))
    return torch.as_tensor(a).detach().to("cpu", copy=True).contiguous()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _persistable(arrays: dict) -> bool:
    return all(t.dtype in _PERSISTABLE for t in arrays.values())


class _Entry:
    __slots__ = ("arrays", "nbytes")

    def __init__(self, arrays: dict, nbytes: int):
        self.arrays = arrays
        self.nbytes = nbytes


class CacheTier:
    """Thread-safe LRU tier over ``key -> {name: tensor}`` bundles.

    ``max_bytes`` caps the memory tier (0 disables it);
    ``directory``/``disk_max_bytes`` turn on the persisted tier shared
    across processes and restarts (None/0: memory only). ``get`` hands
    back the cached CPU tensors themselves: callers copy before they
    write."""

    def __init__(self, tier: str, max_bytes: int,
                 directory: "Path | str | None" = None,
                 disk_max_bytes: int = 0):
        self.tier = tier
        self.max_bytes = int(max_bytes)
        self.dir = Path(directory) if directory else None
        self.disk_max_bytes = int(disk_max_bytes)
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._lock = threading.RLock()
        self._index_cache = None
        self.counts = {"hit": 0, "miss": 0, "disk_hit": 0, "put": 0,
                       "evicted": 0, "corrupt": 0, "persisted": 0}

    # --- introspection ------------------------------------------------------

    @property
    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": sum(e.nbytes for e in self._entries.values()),
                "max_bytes": self.max_bytes,
                "persist_dir": str(self.dir) if self.dir else None,
                **self.counts,
            }

    def keys(self) -> list:
        """In-memory keys, least recently used first."""
        with self._lock:
            return list(self._entries)

    def peek(self, key: str) -> Optional[dict]:
        """Tensors for ``key`` from memory only: no disk read, no LRU
        touch, no hit or miss counted (the fleet tier's handback reads
        with it, so a move does not distort this host's recency order or
        its counts)."""
        with self._lock:
            e = self._entries.get(key)
            return dict(e.arrays) if e is not None else None

    def drop_memory(self, key: str) -> None:
        """Drop one entry from memory only (after a drain handback moved
        it: the persisted sidecar stays valid)."""
        with self._lock:
            self._entries.pop(key, None)
        self._export_gauges()

    # --- the cache ----------------------------------------------------------

    def get(self, key: str) -> Optional[dict]:
        """Tensors for ``key``, or None. Memory first; on a memory miss
        the persisted tier is consulted (checksum-verified) and a hit is
        promoted into memory."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self._count("hit")
                return dict(e.arrays)
        arrays = self._disk_get(key)
        if arrays is not None:
            self._count("disk_hit")
            self._insert(key, arrays, persist=False)
            return dict(arrays)
        self._count("miss")
        return None

    def put(self, key: str, arrays: dict, persist: bool = True) -> None:
        """Insert (or refresh) ``key``. ``persist=False`` keeps the entry
        in memory even with a directory (degraded tokenization)."""
        arrays = {n: _host_tensor(a) for n, a in arrays.items()}
        self._insert(key, arrays, persist=persist)
        self._count("put")

    def _insert(self, key: str, arrays: dict, persist: bool) -> None:
        nbytes = sum(_nbytes(t) for t in arrays.values())
        with self._lock:
            self._entries.pop(key, None)
            if self.max_bytes > 0:
                self._entries[key] = _Entry(arrays, nbytes)
                self._evict_over_budget_locked()
        if persist and self.dir is not None and _persistable(arrays):
            self._disk_put(key, arrays)
        self._export_gauges()

    def _evict_over_budget_locked(self) -> None:
        used = sum(e.nbytes for e in self._entries.values())
        for key in list(self._entries):
            if used <= self.max_bytes:
                return
            used -= self._entries.pop(key).nbytes
            self._count("evicted")

    # --- persistence --------------------------------------------------------

    def _index_path(self) -> Path:
        return self.dir / f"{self.tier}_index.json"

    def _entry_path(self, key: str) -> Path:
        return self.dir / self.tier / f"{key}.npz"

    @contextlib.contextmanager
    def _index_flock(self):
        """Advisory lock across processes around the index's
        read-merge-write; lockless where the filesystem has no flock (at
        worst an index row is lost, never a wrong byte served)."""
        try:
            import fcntl
        except ImportError:
            yield
            return
        try:
            fd = os.open(self.dir / f"{self.tier}_index.lock",
                         os.O_CREAT | os.O_RDWR)
        except OSError:
            yield
            return
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
            except OSError:
                pass
            yield
        finally:
            os.close(fd)

    def _read_index(self) -> dict:
        """Index rows, cached against the file's (mtime_ns, size)."""
        path = self._index_path()
        try:
            st = path.stat()
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            stamp = None
        with self._lock:
            if self._index_cache is not None and self._index_cache[0] == stamp:
                return self._index_cache[1]
        entries = self._read_index_uncached()
        with self._lock:
            self._index_cache = (stamp, entries)
        return entries

    def _read_index_uncached(self) -> dict:
        data = read_json(self._index_path())
        entries = (data or {}).get("entries")
        return entries if isinstance(entries, dict) else {}

    def _write_index(self, mutate) -> None:
        """Read-merge-write under the thread and process locks."""
        with self._lock, self._index_flock():
            entries = self._read_index_uncached()
            mutate(entries)
            atomic_write_json(self._index_path(),
                              {"version": 1, "tier": self.tier,
                               "entries": entries})
            try:
                st = self._index_path().stat()
                self._index_cache = ((st.st_mtime_ns, st.st_size), entries)
            except OSError:
                self._index_cache = (None, entries)

    def _disk_put(self, key: str, arrays: dict) -> None:
        try:
            buf = io.BytesIO()
            np.savez(buf, **{n: t.numpy() for n, t in arrays.items()})
            payload = buf.getvalue()
            path = self._entry_path(key)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(payload)
            os.replace(tmp, path)
            row = {"file": path.name, "sha256": _keys.checksum(payload),
                   "bytes": len(payload), "saved_at": time.time()}
            self._write_index(lambda e: e.__setitem__(key, row))
            with self._lock:
                self.counts["persisted"] += 1
            self._disk_evict_over_budget()
        except OSError as e:
            debug_log(f"cache[{self.tier}]: persist of {key[:12]} "
                      f"failed: {e}")

    def _disk_get(self, key: str) -> Optional[dict]:
        if self.dir is None:
            return None
        row = self._read_index().get(key)
        if not isinstance(row, dict):
            return None
        try:
            payload = self._entry_path(key).read_bytes()
        except OSError:
            return None
        if _keys.checksum(payload) != row.get("sha256"):
            log(f"cache[{self.tier}]: CHECKSUM MISMATCH for entry "
                f"{key[:16]}… — rejecting and deleting (recompute follows)")
            self._count("corrupt")
            self.invalidate(key)
            return None
        try:
            with np.load(io.BytesIO(payload)) as z:
                return {n: torch.from_numpy(np.array(z[n])) for n in z.files}
        except (OSError, ValueError) as e:
            log(f"cache[{self.tier}]: unreadable entry {key[:16]}… "
                f"({e}) — deleting")
            self._count("corrupt")
            self.invalidate(key)
            return None

    def _disk_evict_over_budget(self) -> None:
        if self.disk_max_bytes <= 0:
            return
        entries = self._read_index()
        used = sum(int(r.get("bytes", 0)) for r in entries.values())
        if used <= self.disk_max_bytes:
            return
        victims = []
        for key, row in sorted(entries.items(),
                               key=lambda kv: kv[1].get("saved_at", 0.0)):
            if used <= self.disk_max_bytes:
                break
            victims.append(key)
            used -= int(row.get("bytes", 0))

        def drop_all(e):
            for key in victims:
                e.pop(key, None)

        self._write_index(drop_all)
        for key in victims:
            try:
                self._entry_path(key).unlink()
            except OSError:
                pass
            self._count("evicted")
        self._export_gauges()

    def clear_memory(self) -> int:
        """Drop every in-memory entry (the operator's route); persisted
        entries stay valid. Returns the number dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
        self._export_gauges()
        return n

    def invalidate(self, key: str, memory: bool = True) -> None:
        """Drop one entry from memory and disk."""
        if memory:
            with self._lock:
                self._entries.pop(key, None)
        if self.dir is not None:
            self._write_index(lambda e: e.pop(key, None))
            try:
                self._entry_path(key).unlink()
            except OSError:
                pass
        self._export_gauges()

    # --- telemetry ----------------------------------------------------------

    def _count(self, outcome: str) -> None:
        with self._lock:
            self.counts[outcome] = self.counts.get(outcome, 0) + 1
        enabled, _tm = _tier_metrics()
        if not enabled:
            return
        if outcome in ("hit", "disk_hit"):
            _tm.CACHE_HITS.labels(tier=self.tier).inc()
        elif outcome == "miss":
            _tm.CACHE_MISSES.labels(tier=self.tier).inc()
        elif outcome == "evicted":
            _tm.CACHE_EVICTIONS.labels(tier=self.tier).inc()
        elif outcome == "corrupt":
            _tm.CACHE_CORRUPT.labels(tier=self.tier).inc()

    def _export_gauges(self) -> None:
        enabled, _tm = _tier_metrics()
        if not enabled:
            return
        with self._lock:
            _tm.CACHE_BYTES.labels(tier=self.tier).set(
                sum(e.nbytes for e in self._entries.values()))
            _tm.CACHE_ENTRIES.labels(tier=self.tier).set(len(self._entries))
