"""Retry policy and per-worker circuit breakers (the port's copy of the
JAX package's ``cluster/resilience.py``).

- :class:`RetryPolicy` — exponential backoff with **full jitter**
  (delay ~ U(0, min(cap, base·2^attempt))), bounded by attempts and/or
  a wall-clock budget, and **idempotency-aware**: an exception carrying
  ``retry_safe=False`` is never retried (a prompt that may already sit
  in a worker's queue must not be sent twice).
- :class:`CircuitBreaker` / :class:`BreakerRegistry` — per-worker
  closed→open→half-open state. Probe and dispatch outcomes feed it and
  an open breaker keeps a host out of selection (``cluster/dispatch.py``);
  a heartbeat eviction of the tile farm trips it
  (``cluster/job_timeout.py``); after ``recovery_s`` one half-open trial
  decides re-admission.

Breaker states, transitions and retries go to
``cdt_worker_breaker_state``, ``cdt_worker_breaker_transitions_total``
and ``cdt_retry_attempts_total``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import random
import threading
import time
from typing import Any, Awaitable, Callable, Iterable, Optional

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.logging import log

# Module-level RNG for jitter; tests pass their own seeded Random for
# deterministic backoff schedules.
_rng = random.Random()


def is_retryable(exc: BaseException) -> bool:
    """Default retry predicate.

    The explicit ``retry_safe`` attribute always wins (idempotency
    marker set at raise sites); otherwise the transient transport errors
    retry: timeouts and OS-level socket errors (``urllib``'s
    ``URLError`` is an ``OSError``).
    """
    flag = getattr(exc, "retry_safe", None)
    if flag is not None:
        return bool(flag)
    return isinstance(exc, (asyncio.TimeoutError, TimeoutError, OSError))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + full jitter, bounded by attempts and/or a
    wall-clock budget.

    ``max_attempts=None`` means "until the budget expires" (the
    404-tolerant work-request loop); ``budget_s=None`` means "attempts
    only" (the classic send loop). At least one bound must be set.
    """

    max_attempts: Optional[int] = 5
    base: float = 0.5               # first backoff upper bound (seconds)
    cap: float = 5.0                # per-sleep upper bound (seconds)
    budget_s: Optional[float] = None
    jitter: bool = True

    def __post_init__(self):
        if self.max_attempts is None and self.budget_s is None:
            raise ValueError("RetryPolicy needs max_attempts or budget_s")

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Backoff before retry ``attempt+1`` (attempt is 0-based)."""
        upper = min(self.cap, self.base * (2 ** attempt))
        if not self.jitter:
            return upper
        return (rng or _rng).uniform(0.0, upper)

    def _attempts(self) -> Iterable[int]:
        if self.max_attempts is None:
            return itertools.count()
        return range(self.max_attempts)

    async def run(
        self,
        fn: Callable[[], Awaitable[Any]],
        *,
        op: str = "call",
        retryable: Callable[[BaseException], bool] = is_retryable,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], Awaitable[None]] = asyncio.sleep,
    ) -> Any:
        """Run ``fn`` until it returns, raises a non-retryable error, or
        the policy's bounds are exhausted (the last exception re-raises —
        call sites wrap it in their domain error if they want to).
        """
        start = time.monotonic()
        last: Optional[BaseException] = None
        for attempt in self._attempts():
            try:
                return await fn()
            except asyncio.CancelledError:
                raise                      # cancellation is never retried
            except BaseException as e:     # noqa: BLE001 — predicate decides
                if not retryable(e):
                    raise
                last = e
            d = self.delay(attempt, rng)
            elapsed = time.monotonic() - start
            if self.budget_s is not None and elapsed + d >= self.budget_s:
                break
            if self.max_attempts is not None and \
                    attempt >= self.max_attempts - 1:
                break
            if telemetry.enabled():
                _tm.RETRY_ATTEMPTS.labels(op=op).inc()
            log(f"retry[{op}] attempt {attempt + 1} failed "
                f"({last}); backing off {d:.2f}s")
            await sleep(d)
        assert last is not None
        raise last


def send_policy() -> RetryPolicy:
    """The bounded send loop: ``CDT_SEND_MAX_RETRIES`` attempts."""
    return RetryPolicy(max_attempts=constants.send_max_retries(),
                       base=constants.send_backoff_base(),
                       cap=constants.retry_cap_s())


def work_request_policy() -> RetryPolicy:
    """The 404-tolerant work-request loop: unbounded attempts inside a
    ``CDT_WORK_REQUEST_BUDGET`` wall-clock window, jittered so a worker
    fleet hammering a restarting master spreads out instead of
    busy-spinning."""
    return RetryPolicy(max_attempts=None,
                       base=constants.send_backoff_base(),
                       cap=constants.retry_cap_s(),
                       budget_s=constants.work_request_budget())


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}      # the gauge's values


class CircuitBreaker:
    """Per-worker closed→open→half-open breaker.

    - ``closed``: all calls pass; ``failure_threshold`` consecutive
      failures trip it open.
    - ``open``: calls are refused (``allow()`` False) until
      ``recovery_s`` elapses, then ONE half-open trial is admitted.
    - ``half_open``: the trial's outcome decides — success closes,
      failure re-opens (and re-arms the recovery clock).

    ``trip()`` forces open immediately: a heartbeat-timeout eviction is
    a high-confidence failure that shouldn't wait for a threshold.
    Thread-safe (asyncio handlers + the executor thread both record).
    """

    def __init__(self, failure_threshold: Optional[int] = None,
                 recovery_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = (constants.breaker_fail_threshold()
                                  if failure_threshold is None
                                  else failure_threshold)
        self.recovery_s = (constants.breaker_recovery_s()
                           if recovery_s is None else recovery_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._trial_inflight = False

    # -- observation (no state consumption) ---------------------------------

    @property
    def state(self) -> str:
        """Current state; reports ``half_open`` once the recovery window
        has elapsed (without consuming the trial slot)."""
        with self._lock:
            if self._state == OPEN and \
                    self._clock() - self._opened_at >= self.recovery_s:
                return HALF_OPEN
            return self._state

    @property
    def failures(self) -> int:
        return self._failures

    # -- gating --------------------------------------------------------------

    def allow(self) -> bool:
        """May a call proceed? Consumes the single half-open trial slot."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.recovery_s:
                    return False
                self._state = HALF_OPEN
                self._trial_inflight = True
                return True
            # half-open: one probe in flight at a time
            if self._trial_inflight:
                return False
            self._trial_inflight = True
            return True

    # -- outcome recording ---------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._trial_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._reopen_locked()
                return
            self._failures += 1
            if self._state == CLOSED and \
                    self._failures >= self.failure_threshold:
                self._reopen_locked()

    def trip(self) -> None:
        """Force open (eviction-grade evidence)."""
        with self._lock:
            self._reopen_locked()

    def _reopen_locked(self) -> None:
        self._state = OPEN
        self._opened_at = self._clock()
        self._trial_inflight = False
        self._failures = max(self._failures, self.failure_threshold)


class BreakerRegistry:
    """worker_id → breaker, logging every transition.

    One process-global instance (``BREAKERS``) takes the eviction path of
    ``job_timeout.py``; tests reset it between cases.
    """

    def __init__(self, **breaker_kw):
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breaker_kw = breaker_kw

    def get(self, worker_id: str) -> CircuitBreaker:
        wid = str(worker_id)
        with self._lock:
            b = self._breakers.get(wid)
            if b is None:
                b = self._breakers[wid] = CircuitBreaker(**self._breaker_kw)
                self._export(wid, b)
            return b

    @staticmethod
    def _export(worker_id: str, breaker: CircuitBreaker) -> None:
        if telemetry.enabled():
            _tm.BREAKER_STATE.labels(worker=worker_id).set(
                _STATE_VALUE[breaker.state])

    def allow(self, worker_id: str) -> bool:
        b = self.get(worker_id)
        ok = b.allow()
        self._export(worker_id, b)
        return ok

    def record(self, worker_id: str, ok: bool) -> None:
        b = self.get(worker_id)
        before = b.state
        if ok:
            b.record_success()
        else:
            b.record_failure()
        self._transitioned(worker_id, b, before)

    def trip(self, worker_id: str) -> None:
        b = self.get(worker_id)
        before = b.state
        b.trip()
        self._transitioned(worker_id, b, before)

    def _transitioned(self, worker_id: str, b: CircuitBreaker,
                      before: str) -> None:
        after = b.state
        self._export(worker_id, b)
        if after != before:
            log(f"breaker[{worker_id}] {before} -> {after}")
            if telemetry.enabled():
                _tm.BREAKER_TRANSITIONS.labels(to=after).inc()

    def state(self, worker_id: str) -> str:
        return self.get(worker_id).state

    def states(self) -> dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {wid: b.state for wid, b in items}

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()


BREAKERS = BreakerRegistry()
