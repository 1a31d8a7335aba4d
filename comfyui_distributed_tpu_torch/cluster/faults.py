"""Deterministic fault injection for the control plane (the port's copy of
the JAX package's ``cluster/faults.py``).

A seeded :class:`FaultPlan` injects faults at chosen **call indices** per
operation into the control plane's outbound calls: same seed, same spec,
same failures, every run, and the same ones the JAX package's plan fires
for that spec and seed. The JAX package wraps its aiohttp session; the
port's outbound calls all go through ``utils/network.py``
(``http_request`` and ``ws_connect``), which consult the active plan.

Fault kinds:

- ``drop``     — the connection never opens: a ``URLError`` over
  ``ConnectionRefusedError``, which ``network.never_sent`` counts as
  never delivered
- ``latency``  — delay the call by ``value`` seconds, then proceed
- ``http500``  — synthetic 5xx answer (``value`` overrides the status)
- ``corrupt``  — flip one byte of the outbound body (of the largest part
  of a multipart body: the CDTF frame, not the metadata)
- ``truncate`` — send only the first half of the outbound body (part)
- ``silence``  — swallow the call, answer a fake 200

A WebSocket connect takes ``drop`` and ``latency``; its other kinds
consume the call index and change nothing, as in the JAX package.

Spec grammar (``CDT_FAULTS`` or a test)::

    spec    := clause (";" clause)*
    clause  := "seed=" int
             | op "@" sel ":" kind ["=" value]
    op      := probe | dispatch | request_work | submit | heartbeat
             | collect | job_status | media | http | *  (http = unmatched)
    sel     := "*" | int ("," int)* | int "-" int | "%" float

Operations are classified by URL path (``op_for_url``). Inactive unless a
plan is active (one ``is None`` check per call). Each injected fault
counts in ``cdt_faults_injected_total{op, kind}``.
"""

from __future__ import annotations

import asyncio
import random
import re
import threading
from typing import Optional

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils.logging import log

FAULTS_ENV = "CDT_FAULTS"

_KINDS = ("drop", "latency", "http500", "corrupt", "truncate", "silence")

# URL path suffix → operation name, first match wins (more specific
# suffixes first)
_OP_ROUTES: tuple[tuple[str, str], ...] = (
    ("/distributed/health", "probe"),
    ("/distributed/worker_ws", "dispatch"),
    ("/prompt", "dispatch"),
    ("/distributed/request_image", "request_work"),
    ("/distributed/submit_tiles", "submit"),
    ("/distributed/submit_image", "submit"),
    ("/distributed/heartbeat", "heartbeat"),
    ("/distributed/job_complete_frames", "collect"),
    ("/distributed/job_complete", "collect"),
    ("/distributed/job_status", "job_status"),
    ("/distributed/check_file", "media"),
    ("/upload/image", "media"),
)


def op_for_url(url: str) -> str:
    path = str(url).split("?", 1)[0]
    for suffix, op in _OP_ROUTES:
        if path.endswith(suffix):
            return op
    return "http"


class FaultSpecError(ValueError):
    """Malformed CDT_FAULTS spec."""


class Fault:
    """One injection rule: operation, selector, kind, optional value."""

    __slots__ = ("op", "kind", "indices", "prob", "value")

    def __init__(self, op: str, kind: str,
                 indices: Optional[frozenset[int]] = None,
                 prob: Optional[float] = None, value: float = 0.0):
        if kind not in _KINDS:
            raise FaultSpecError(f"unknown fault kind {kind!r} "
                                 f"(one of {', '.join(_KINDS)})")
        self.op = op
        self.kind = kind
        self.indices = indices        # None and prob None: every call
        self.prob = prob
        self.value = value

    def matches(self, op: str, index: int, rng: random.Random) -> bool:
        if self.op not in ("*", op):
            return False
        if self.prob is not None:
            return rng.random() < self.prob
        if self.indices is None:
            return True
        return index in self.indices


def _parse_selector(sel: str) -> tuple[Optional[frozenset[int]],
                                       Optional[float]]:
    sel = sel.strip()
    if sel == "*":
        return None, None
    if sel.startswith("%"):
        try:
            p = float(sel[1:])
        except ValueError:
            raise FaultSpecError(f"bad probability selector {sel!r}") from None
        if not 0.0 <= p <= 1.0:
            raise FaultSpecError(f"probability out of [0,1]: {sel!r}")
        return None, p
    indices: set[int] = set()
    for part in sel.split(","):
        part = part.strip()
        m = re.fullmatch(r"(\d+)-(\d+)", part)
        if m:
            lo, hi = int(m.group(1)), int(m.group(2))
            if hi < lo:
                raise FaultSpecError(f"empty index range {part!r}")
            indices.update(range(lo, hi + 1))
        elif part.isdigit():
            indices.add(int(part))
        else:
            raise FaultSpecError(f"bad index selector {part!r}")
    return frozenset(indices), None


class FaultPlan:
    """A seeded, ordered set of faults plus per-operation call counters.

    ``next_fault(op)`` consumes one call index for ``op`` and returns the
    matching fault (or None). All randomness (probability selectors, the
    corrupted byte) flows from the plan's seed, so a run replays exactly
    with the same spec.
    """

    def __init__(self, faults: list[Fault], seed: int = 0):
        self.faults = list(faults)
        self.seed = seed
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls: dict[str, int] = {}
        self.injected: list[tuple[str, int, str]] = []   # (op, index, kind)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults: list[Fault] = []
        seed = 0
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                try:
                    seed = int(clause[5:])
                except ValueError:
                    raise FaultSpecError(f"bad seed clause {clause!r}") from None
                continue
            m = re.fullmatch(
                r"([\w.*]+)@([^:]+):([a-z0-9]+)(?:=([\d.]+))?", clause)
            if not m:
                raise FaultSpecError(
                    f"bad fault clause {clause!r} (want op@sel:kind[=value])")
            op, sel, kind, value = m.groups()
            indices, prob = _parse_selector(sel)
            faults.append(Fault(op, kind, indices, prob,
                                float(value) if value else 0.0))
        return cls(faults, seed=seed)

    def next_fault(self, op: str) -> Optional[Fault]:
        with self._lock:
            index = self.calls.get(op, 0)
            self.calls[op] = index + 1
            for f in self.faults:
                if f.matches(op, index, self.rng):
                    self.injected.append((op, index, f.kind))
                    if telemetry.enabled():
                        _tm.FAULTS_INJECTED.labels(op=op, kind=f.kind).inc()
                    return f
        return None

    # -- payload mutation (seeded) ------------------------------------------

    def corrupt_bytes(self, data: bytes) -> bytes:
        if not data:
            return data
        with self._lock:
            i = self.rng.randrange(len(data))
        return data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]

    @staticmethod
    def truncate_bytes(data: bytes) -> bytes:
        return data[: max(1, len(data) // 2)] if data else data

    def mutate_body(self, fault: Fault, body: bytes, content_type: str) -> bytes:
        """Corrupt or truncate an outbound body; in a multipart body only
        its largest part, so the metadata stays readable and the crc of
        the CDTF frame catches the damage."""
        mutate = (self.corrupt_bytes if fault.kind == "corrupt"
                  else self.truncate_bytes)
        if not content_type.lower().startswith("multipart/"):
            return mutate(body)
        from ..utils.exceptions import ValidationError
        from ..utils.multipart import parse_multipart

        try:
            parts = parse_multipart(body, content_type)
        except ValidationError:
            return mutate(body)
        if not parts:
            return body
        data = max((p.data for p in parts), key=len)
        at = body.find(data)
        return body[:at] + mutate(data) + body[at + len(data):]


# ---------------------------------------------------------------------------
# activation (environment or test)
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None
_env_checked = False


def activate(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or clear, with None) the process-wide plan; returns it."""
    global _active, _env_checked
    _active = plan
    _env_checked = True     # explicit activation overrides the environment
    if plan is not None:
        log(f"faults: plan active (seed={plan.seed}, {len(plan.faults)} rules)")
    return plan


def deactivate() -> None:
    global _active, _env_checked
    _active = None
    _env_checked = False    # re-read CDT_FAULTS on next use


def active_plan() -> Optional[FaultPlan]:
    global _active, _env_checked
    if not _env_checked:
        _env_checked = True
        from ..utils.constants import faults

        spec = faults()
        if spec:
            _active = FaultPlan.parse(spec)
            log(f"faults: {FAULTS_ENV} plan active (seed={_active.seed}, "
                f"{len(_active.faults)} rules)")
    return _active


# ---------------------------------------------------------------------------
# job-store wrapper (in-process fault tests without HTTP)
# ---------------------------------------------------------------------------


class FaultyJobStore:
    """JobStore proxy for in-process fault tests: ``request_work`` /
    ``submit_result`` / ``heartbeat`` consult the plan (ops are prefixed
    ``store.``); everything else passes through."""

    def __init__(self, store, plan: FaultPlan):
        self._store = store
        self._plan = plan

    async def request_work(self, job_id, worker_id):
        fault = self._plan.next_fault("store.request_work")
        if fault is not None:
            if fault.kind == "drop":
                return None
            if fault.kind == "latency":
                await asyncio.sleep(fault.value or 0.05)
            elif fault.kind == "http500":
                from ..utils.exceptions import JobQueueError

                raise JobQueueError("injected store failure", job_id=job_id)
        return await self._store.request_work(job_id, worker_id)

    async def submit_result(self, job_id, worker_id, task_id, payload):
        fault = self._plan.next_fault("store.submit")
        if fault is not None:
            if fault.kind in ("drop", "silence"):
                return False
            if fault.kind == "latency":
                await asyncio.sleep(fault.value or 0.05)
            elif fault.kind == "http500":
                from ..utils.exceptions import JobQueueError

                raise JobQueueError("injected store failure", job_id=job_id)
        return await self._store.submit_result(job_id, worker_id, task_id,
                                               payload)

    async def heartbeat(self, job_id, worker_id):
        fault = self._plan.next_fault("store.heartbeat")
        if fault is not None and fault.kind in ("drop", "silence"):
            return False
        return await self._store.heartbeat(job_id, worker_id)

    def __getattr__(self, name):
        return getattr(self._store, name)
