"""Latent checkpoints: the exact state of a denoise run between segments
(the port's copy of the JAX package's ``diffusion/checkpoint.py``).

A :class:`LatentCheckpoint` holds a sampler's whole state at a segment
boundary (``diffusion/samplers.run_segment``): the latent, every history
slot a multistep solver keeps, its host scalars (step sizes, flags,
counters), the next ladder index and the run's identity (sampler, spec
geometry, seed, the conditioning's digest, ``backend: "torch"``). The
samplers draw their noise by global step index and the state round-trips
through host numpy bit for bit, so a resumed run, on this controller or
another one of the port, is bitwise an uninterrupted one.

Wire form: one ``.npz`` (a JSON header and the state's leaves), the JAX
package's layout with the same header and the same SHA-256 checksum, so
each package parses the other's bytes. A JAX checkpoint never resumes
here: its meta names no ``backend: "torch"``, which ``validate_meta``
(and the import routes, through :func:`require_torch_backend`) refuse.

:class:`CheckpointStore` parks them: an in-memory LRU capped at
``CDT_CKPT_MEM_BYTES`` (the entry being resumed is pinned), an optional
persisted tier under ``CDT_CKPT_DIR`` (checksummed sidecars, an index
under ``flock``), and a dead-letter list: past
``CDT_PREEMPT_RESUME_RETRIES`` failed restores an entry is dropped, its
forensics kept, and its job restarts from scratch.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import re
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.jsonio import atomic_write_json, read_json
from ..utils.logging import debug_log, log

CHECKPOINT_VERSION = 1
BACKEND = "torch"


class CheckpointError(Exception):
    """A checkpoint payload cannot be used at all: a bad version, a
    checksum mismatch, a garbled npz, another backend's state."""


class CheckpointRestoreError(Exception):
    """A checkpoint exists but cannot resume this run (another identity,
    state shapes or step). Counted against the resume-retry bound."""


class PreemptedError(Exception):
    """Raised out of a sampler node whose run yielded at a segment
    boundary; carries the parked state."""

    def __init__(self, checkpoint: "LatentCheckpoint", reason: str):
        super().__init__(f"preempted@{checkpoint.step}/"
                         f"{checkpoint.total_steps} ({reason})")
        self.checkpoint = checkpoint
        self.reason = reason


def checksum(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")


def valid_checkpoint_id(cid) -> bool:
    """Ids name store keys and files of the persisted tier: anything
    outside a conservative charset (no separators, no control bytes) is
    refused, so a payload can never steer a path out of ``CDT_CKPT_DIR``."""
    return isinstance(cid, str) and bool(_ID_RE.match(cid))


def state_to_leaves(state: tuple) -> tuple:
    """A sampler state as host numpy leaves: a tensor's exact bytes, a
    host scalar as a 0-d array of its Python type (float64, int64,
    bool), so that each comes back bit for bit."""
    leaves = []
    for v in state:
        if isinstance(v, torch.Tensor):
            leaves.append(v.detach().cpu().numpy())
        elif isinstance(v, bool):
            leaves.append(np.asarray(v, np.bool_))
        elif isinstance(v, int):
            leaves.append(np.asarray(v, np.int64))
        elif isinstance(v, float):
            leaves.append(np.asarray(v, np.float64))
        else:
            raise TypeError(f"sampler state leaf of type {type(v).__name__}")
    return tuple(leaves)


def leaves_to_state(leaves: tuple, device) -> tuple:
    """The inverse of :func:`state_to_leaves`: arrays of one dimension or
    more become tensors on ``device``, 0-d ones Python scalars."""
    state = []
    for a in leaves:
        a = np.asarray(a)
        if a.ndim:
            state.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
        elif a.dtype == np.bool_:
            state.append(bool(a))
        elif np.issubdtype(a.dtype, np.integer):
            state.append(int(a))
        else:
            state.append(float(a))
    return tuple(state)


@dataclasses.dataclass
class LatentCheckpoint:
    """One parked denoise run. ``step`` is the next global ladder index
    (``step`` steps are in ``carry``); ``meta`` is the identity the
    resuming run validates."""

    sampler: str
    step: int
    total_steps: int
    carry: tuple
    meta: dict = dataclasses.field(default_factory=dict)
    checkpoint_id: str = ""
    version: int = CHECKPOINT_VERSION

    @property
    def nbytes(self) -> int:
        return int(sum(np.asarray(a).nbytes for a in self.carry))

    def to_bytes(self) -> bytes:
        header = {
            "version": self.version,
            "sampler": self.sampler,
            "step": int(self.step),
            "total_steps": int(self.total_steps),
            "meta": self.meta,
            "n_leaves": len(self.carry),
        }
        arrays = {f"carry_{i}": np.asarray(a)
                  for i, a in enumerate(self.carry)}
        arrays["header"] = np.frombuffer(
            json.dumps(header, sort_keys=True).encode(), np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, payload: bytes,
                   checkpoint_id: str = "") -> "LatentCheckpoint":
        try:
            with np.load(io.BytesIO(payload)) as z:
                header = json.loads(bytes(z["header"].tobytes()).decode())
                if not isinstance(header, dict):
                    raise ValueError("the header is not an object")
                carry = tuple(z[f"carry_{i}"]
                              for i in range(int(header["n_leaves"])))
        except (KeyError, ValueError, OSError, EOFError,
                json.JSONDecodeError) as e:
            raise CheckpointError(f"unreadable checkpoint payload: {e}")
        if header.get("version") != CHECKPOINT_VERSION:
            raise CheckpointError(
                f"checkpoint version {header.get('version')!r} != "
                f"{CHECKPOINT_VERSION} (refusing a cross-version restore)")
        try:
            return cls(sampler=str(header["sampler"]),
                       step=int(header["step"]),
                       total_steps=int(header["total_steps"]), carry=carry,
                       meta=dict(header.get("meta") or {}),
                       checkpoint_id=checkpoint_id)
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointError(f"checkpoint header incomplete: {e}")

    def to_payload(self) -> dict:
        """The JSON-safe wire form; its sha256 travels with the bytes."""
        payload = self.to_bytes()
        return {"version": CHECKPOINT_VERSION,
                "checkpoint_id": self.checkpoint_id,
                "sha256": checksum(payload),
                "data": base64.b64encode(payload).decode("ascii")}

    @classmethod
    def from_payload(cls, obj: dict) -> "LatentCheckpoint":
        if not isinstance(obj, dict) or "data" not in obj:
            raise CheckpointError("checkpoint payload must be an object "
                                  "with a base64 'data' field")
        try:
            payload = base64.b64decode(obj["data"], validate=True)
        except Exception as e:  # noqa: BLE001 — any base64 failure is final
            raise CheckpointError(f"bad base64 checkpoint data: {e}")
        want = obj.get("sha256")
        if not want:
            raise CheckpointError(
                "checkpoint payload carries no sha256 — refusing an "
                "unverifiable restore")
        if checksum(payload) != want:
            raise CheckpointError(
                "checkpoint CHECKSUM MISMATCH on the wire — rejecting "
                "(a flipped bit must never resume a job)")
        cid = obj.get("checkpoint_id") or ""
        if cid and not valid_checkpoint_id(cid):
            cid = ""       # a fresh content-derived id is given at park
        return cls.from_bytes(payload, checkpoint_id=cid)

    def validate_meta(self, expect: dict) -> None:
        """Raise :class:`CheckpointRestoreError` unless every key of
        ``expect`` matches this checkpoint's meta (``sampler``: its
        field)."""
        for k, want in expect.items():
            have = self.sampler if k == "sampler" else self.meta.get(k)
            if have != want:
                raise CheckpointRestoreError(
                    f"checkpoint {self.checkpoint_id or '?'} does not "
                    f"match this run: {k}={have!r}, expected {want!r}")


def require_torch_backend(ckpt: LatentCheckpoint) -> None:
    """Refuse, at import, a checkpoint parked by another backend (the JAX
    package's carry is another program's state)."""
    backend = ckpt.meta.get("backend")
    if backend != BACKEND:
        raise CheckpointError(
            f"checkpoint backend {backend!r} is not {BACKEND!r}: only "
            "state parked by this package resumes here")


class _Parked:
    __slots__ = ("payload", "sha256", "step", "total_steps", "sampler",
                 "nbytes", "restore_attempts")

    def __init__(self, payload: bytes, ckpt: LatentCheckpoint):
        self.payload = payload
        self.sha256 = checksum(payload)
        self.step = ckpt.step
        self.total_steps = ckpt.total_steps
        self.sampler = ckpt.sampler
        self.nbytes = len(payload)
        self.restore_attempts = 0


class CheckpointStore:
    """A byte-capped LRU of serialised checkpoints, an optional
    checksummed persisted tier and bounded-restore dead-lettering."""

    def __init__(self, max_bytes: Optional[int] = None,
                 directory: "Path | str | None" = None,
                 resume_retries: Optional[int] = None):
        self.max_bytes = (constants.ckpt_mem_bytes() if max_bytes is None
                          else int(max_bytes))
        if directory is None:
            directory = constants.ckpt_dir()
        self.dir = Path(directory) if directory else None
        self.resume_retries = (constants.preempt_resume_retries()
                               if resume_retries is None
                               else int(resume_retries))
        self._entries: "OrderedDict[str, _Parked]" = OrderedDict()
        self.dead: dict[str, dict] = {}
        # restore attempts outlive the memory entry: an entry evicted to
        # (or imported straight onto) the persisted tier keeps its budget
        self._attempts: dict[str, int] = {}
        self._pinned: set[str] = set()
        self._lock = threading.RLock()
        self.counts = {"parked": 0, "restored": 0, "dropped": 0,
                       "evicted": 0, "corrupt": 0, "dead_lettered": 0}

    # --- parking ------------------------------------------------------------

    def park(self, ckpt: LatentCheckpoint) -> str:
        """Serialise and store; returns the id (the step cursor and a
        content hash unless the checkpoint carries a valid one)."""
        payload = ckpt.to_bytes()
        cid = ckpt.checkpoint_id
        if not valid_checkpoint_id(cid):
            cid = f"ck_{ckpt.step:04d}_{checksum(payload)[:16]}"
        entry = _Parked(payload, ckpt)
        with self._lock:
            existing = self._entries.get(cid)
            if existing is not None and existing.sha256 != entry.sha256:
                # a caller's id naming other parked state must not clobber it
                fresh = f"ck_{ckpt.step:04d}_{entry.sha256[:16]}"
                log(f"checkpoint id collision: {cid} holds different "
                    f"state — parking the new payload as {fresh}")
                cid = fresh
            self._entries.pop(cid, None)
            self._entries[cid] = entry
            self.counts["parked"] += 1
            self._evict_over_budget_locked(keep=cid)
        ckpt.checkpoint_id = cid
        if self.dir is not None:
            self._disk_put(cid, entry)
        self._export_gauges()
        return cid

    def _evict_over_budget_locked(self, keep: str) -> None:
        if self.max_bytes <= 0:
            return
        used = sum(e.nbytes for e in self._entries.values())
        for cid in list(self._entries):
            if used <= self.max_bytes:
                return
            if cid == keep or cid in self._pinned:
                continue
            used -= self._entries.pop(cid).nbytes
            self.counts["evicted"] += 1

    def pin(self, checkpoint_id: str) -> None:
        """Keep an entry in memory while its job resumes from it."""
        with self._lock:
            self._pinned.add(str(checkpoint_id))

    def unpin(self, checkpoint_id: str) -> None:
        with self._lock:
            self._pinned.discard(str(checkpoint_id))

    # --- retrieval ----------------------------------------------------------

    def _payload(self, cid: str) -> "tuple[bytes, str] | tuple[None, None]":
        with self._lock:
            entry = self._entries.get(cid)
            if entry is not None:
                self._entries.move_to_end(cid)
                return entry.payload, entry.sha256
        if self.dir is not None:
            loaded = self._disk_get(cid)
            if loaded is not None:
                return loaded
        return None, None

    def get(self, checkpoint_id: str) -> Optional[LatentCheckpoint]:
        """A parked checkpoint (memory first, then the persisted tier).
        A corrupt one is dropped loudly and reads as None."""
        cid = str(checkpoint_id)
        payload, want = self._payload(cid)
        if payload is None:
            return None
        if checksum(payload) != want:
            log(f"checkpoint {cid}: CHECKSUM MISMATCH — rejecting and "
                "dropping (the job restarts from scratch)")
            self._count_corrupt()
            self.drop(cid)
            return None
        try:
            return LatentCheckpoint.from_bytes(payload, checkpoint_id=cid)
        except CheckpointError as e:
            log(f"checkpoint {cid}: unreadable ({e}) — dropping")
            self._count_corrupt()
            self.drop(cid)
            return None

    def __contains__(self, checkpoint_id: str) -> bool:
        return self._payload(str(checkpoint_id))[0] is not None

    def export_payload(self, checkpoint_id: str) -> Optional[dict]:
        """The wire form, straight from the stored bytes (their recorded
        sha256 is the wire checksum)."""
        cid = str(checkpoint_id)
        payload, want = self._payload(cid)
        if payload is None:
            return None
        return {"version": CHECKPOINT_VERSION, "checkpoint_id": cid,
                "sha256": want,
                "data": base64.b64encode(payload).decode("ascii")}

    # --- lifecycle ----------------------------------------------------------

    def drop(self, checkpoint_id: str) -> bool:
        cid = str(checkpoint_id)
        with self._lock:
            existed = self._entries.pop(cid, None) is not None
            self._attempts.pop(cid, None)
            self._pinned.discard(cid)
            if existed:
                self.counts["dropped"] += 1
        if self.dir is not None:
            self._disk_drop(cid)
        self._export_gauges()
        return existed

    def record_restore_failure(self, checkpoint_id: str,
                               reason: str) -> int:
        """One failed restore; returns the attempts so far. At
        ``resume_retries`` the entry is dead-lettered."""
        cid = str(checkpoint_id)
        with self._lock:
            attempts = self._attempts.get(cid, 0) + 1
            self._attempts[cid] = attempts
            entry = self._entries.get(cid)
            if entry is not None:
                entry.restore_attempts = attempts
        if attempts >= self.resume_retries:
            self.dead_letter(cid, reason)
        return attempts

    def dead_letter(self, checkpoint_id: str, reason: str) -> None:
        cid = str(checkpoint_id)
        with self._lock:
            entry = self._entries.pop(cid, None)
            attempts = self._attempts.pop(cid, None)
            self._pinned.discard(cid)
            self.counts["dead_lettered"] += 1
            self.dead[cid] = {
                "checkpoint_id": cid, "reason": reason,
                "step": getattr(entry, "step", None),
                "sampler": getattr(entry, "sampler", None),
                "attempts": attempts if attempts is not None
                else getattr(entry, "restore_attempts", None),
            }
        if self.dir is not None:
            self._disk_drop(cid)
        log(f"checkpoint {cid} DEAD-LETTERED ({reason}) — the job "
            "restarts from scratch instead of looping on restore")
        if telemetry.enabled():
            _tm.CHECKPOINT_DEAD_LETTERS.inc()
        self._export_gauges()

    def mark_restored(self, checkpoint_id: str) -> None:
        with self._lock:
            self.counts["restored"] += 1

    # --- the persisted tier ---------------------------------------------------

    def _index_path(self) -> Path:
        return self.dir / "checkpoint_index.json"

    def _entry_path(self, cid: str) -> Path:
        return self.dir / f"{cid}.ckpt"

    @contextlib.contextmanager
    def _index_flock(self):
        """Advisory lock across processes around the index's
        read-merge-write (two workers may share ``CDT_CKPT_DIR``);
        lockless where the filesystem has no flock (at worst an index row
        is lost, never a wrong byte: entries are checksummed)."""
        try:
            import fcntl
        except ImportError:
            yield
            return
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            fd = os.open(self.dir / "checkpoint_index.lock",
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

    def _rows(self) -> dict:
        rows = (read_json(self._index_path()) or {}).get("entries")
        return rows if isinstance(rows, dict) else {}

    def _write_index(self, mutate) -> None:
        with self._lock, self._index_flock():
            rows = self._rows()
            mutate(rows)
            atomic_write_json(self._index_path(),
                              {"version": 1, "entries": rows})

    def _disk_put(self, cid: str, entry: _Parked) -> None:
        try:
            path = self._entry_path(cid)
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(entry.payload)
            os.replace(tmp, path)
            row = {"file": path.name, "sha256": entry.sha256,
                   "bytes": entry.nbytes, "step": entry.step,
                   "sampler": entry.sampler}
            self._write_index(lambda rows: rows.__setitem__(cid, row))
        except OSError as e:
            debug_log(f"checkpoint: persist of {cid} failed: {e}")

    def _disk_get(self, cid: str) -> "Optional[tuple[bytes, str]]":
        row = self._rows().get(cid)
        if not isinstance(row, dict):
            return None
        try:
            payload = self._entry_path(cid).read_bytes()
        except OSError:
            return None
        want = row.get("sha256", "")
        if checksum(payload) != want:
            log(f"checkpoint {cid}: persisted CHECKSUM MISMATCH — "
                "rejecting and deleting")
            self._count_corrupt()
            self._disk_drop(cid)
            return None
        return payload, want

    def _disk_drop(self, cid: str) -> None:
        self._write_index(lambda rows: rows.pop(cid, None))
        try:
            self._entry_path(cid).unlink()
        except OSError:
            pass

    # --- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": sum(e.nbytes for e in self._entries.values()),
                "max_bytes": self.max_bytes,
                "persist_dir": str(self.dir) if self.dir else None,
                "pinned": sorted(self._pinned),
                "parked": [
                    {"checkpoint_id": cid, "step": e.step,
                     "total_steps": e.total_steps, "sampler": e.sampler,
                     "bytes": e.nbytes, "attempts": e.restore_attempts}
                    for cid, e in self._entries.items()],
                "dead_letter": list(self.dead.values()),
                **self.counts,
            }

    def _count_corrupt(self) -> None:
        with self._lock:
            self.counts["corrupt"] += 1
        if telemetry.enabled():
            _tm.CACHE_CORRUPT.labels(tier="checkpoint").inc()

    def _export_gauges(self) -> None:
        if not telemetry.enabled():
            return
        with self._lock:
            mem = sum(e.nbytes for e in self._entries.values())
        _tm.CHECKPOINT_BYTES.labels(tier="memory").set(mem)
        if self.dir is not None:
            _tm.CHECKPOINT_BYTES.labels(tier="persisted").set(
                sum(int(r.get("bytes", 0)) for r in self._rows().values()
                    if isinstance(r, dict)))
