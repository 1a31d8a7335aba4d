"""Admission control: who gets in, who waits, who is told to come back
(the port's copy of the JAX package's ``cluster/frontdoor/admission.py``).

Three gates, in order, all deterministic under an injected clock:

1. **Priority-aware depth shedding**: the controller's depth (queued +
   executing + coalescing) against ``CDT_FD_SHED_DEPTH``; the lowest
   priority class sheds at half of it, so background load drains out
   of an overloaded host first. Checked before the token bucket, so an
   overload shed never burns a tenant's rate budget.
2. **Per-tenant token bucket**: a tenant past ``CDT_FD_TENANT_RATE``
   requests a second (burst ``CDT_FD_TENANT_BURST``) is shed with a
   ``Retry-After`` sized to the refill, however idle the host is.
3. **Breaker-scaled capacity**: with workers' circuit breakers open or
   half open (``cluster/resilience.py``), the shed threshold scales by
   the healthy fraction, never below a quarter.

Outcomes go to ``cdt_admission_total{outcome=admitted|queued|shed}``:
``queued`` is accepted past the soft watermark (``CDT_FD_SOFT_DEPTH``).
The port has no elastic fleet yet (A.6), so no worker counts as leaving.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Callable, Optional

from ... import telemetry
from ...telemetry import metrics as _tm
from ...utils import constants


@dataclasses.dataclass(frozen=True)
class Decision:
    outcome: str                 # admitted | queued | shed
    reason: str = ""             # ok | busy | overload | tenant_rate
    retry_after_s: float = 0.0
    depth: int = 0


class TokenBucket:
    """A token bucket with an injected clock."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = max(rate, 1e-9)
        self.burst = burst
        self._level = burst
        self._clock = clock
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._level = min(self.burst,
                          self._level + (now - self._last) * self.rate)
        self._last = now

    def take(self) -> bool:
        self._refill()
        if self._level >= 1.0:
            self._level -= 1.0
            return True
        return False

    def seconds_until_token(self) -> float:
        self._refill()
        if self._level >= 1.0:
            return 0.0
        return (1.0 - self._level) / self.rate


def breaker_healthy_fraction() -> float:
    """Closed breakers over tracked ones (half open counts half); 1.0
    when nothing is tracked (one host, or a fresh start)."""
    from ..resilience import BREAKERS

    states = BREAKERS.states()
    if not states:
        return 1.0
    score = {"closed": 1.0, "half_open": 0.5, "open": 0.0}
    return sum(score.get(s, 0.0) for s in states.values()) / len(states)


class AdmissionController:
    def __init__(
        self,
        depth_provider: Callable[[], int],
        *,
        soft_depth: Optional[int] = None,
        shed_depth: Optional[int] = None,
        tenant_rate: Optional[float] = None,
        tenant_burst: Optional[float] = None,
        healthy_fraction: Callable[[], float] = breaker_healthy_fraction,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.depth_provider = depth_provider
        self.soft_depth = (constants.fd_soft_depth() if soft_depth is None
                           else soft_depth)
        self.shed_depth = (constants.fd_shed_depth() if shed_depth is None
                           else shed_depth)
        self.tenant_rate = (constants.fd_tenant_rate() if tenant_rate is None
                            else tenant_rate)
        self.tenant_burst = (constants.fd_tenant_burst()
                             if tenant_burst is None else tenant_burst)
        self.max_tenants = constants.fd_max_tenants()
        self.retry_after_s = constants.fd_retry_after_s()
        self.healthy_fraction = healthy_fraction
        self._clock = clock
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._counts: dict[str, int] = {}

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= self.max_tenants:
                # least recently seen out: a returning tenant gets a fresh
                # (full) bucket; bounded memory beats perfect memory
                self._buckets.popitem(last=False)
            b = TokenBucket(self.tenant_rate, self.tenant_burst,
                            clock=self._clock)
            self._buckets[tenant] = b
        else:
            self._buckets.move_to_end(tenant)
        return b

    def shed_threshold(self, priority: str) -> int:
        """This priority class's shed depth now: scaled by the breakers'
        health (never below a quarter), halved for the lowest class."""
        frac = max(0.25, self.healthy_fraction())
        threshold = max(1, int(self.shed_depth * frac))
        if priority == constants.PRIORITY_CLASSES[-1]:
            threshold = max(1, threshold // 2)
        return threshold

    def admit(self, tenant: str, priority: str) -> Decision:
        depth = int(self.depth_provider())
        threshold = self.shed_threshold(priority)
        if depth >= threshold:
            ratio = depth / max(1, threshold)
            retry = min(30.0, math.ceil(self.retry_after_s * ratio))
            decision = Decision("shed", "overload", retry_after_s=retry,
                                depth=depth)
        elif not self._bucket(tenant).take():
            wait = self._bucket(tenant).seconds_until_token()
            decision = Decision("shed", "tenant_rate",
                                retry_after_s=max(1.0, math.ceil(wait)),
                                depth=depth)
        elif depth >= min(self.soft_depth, threshold):
            decision = Decision("queued", "busy", depth=depth)
        else:
            decision = Decision("admitted", "ok", depth=depth)

        self._counts[decision.outcome] = \
            self._counts.get(decision.outcome, 0) + 1
        if telemetry.enabled():
            _tm.ADMISSION_TOTAL.labels(outcome=decision.outcome,
                                       priority=priority).inc()
        return decision

    def summary(self) -> dict:
        return {
            "outcomes": dict(self._counts),
            "tenants_tracked": len(self._buckets),
            "soft_depth": self.soft_depth,
            "shed_depth": self.shed_depth,
            "healthy_fraction": round(self.healthy_fraction(), 3),
        }
