"""Content-addressed caching and duplicate-request coalescing (the
port's ``cluster/cache``, after the JAX package's).

The request stream repeats itself (identical prompts, a shared negative
prompt, re-rolls), and without this package each admitted request pays
a full text encode and each byte-identical submission a full denoise.
Three tiers stop a controller computing what it already knows:

- **conditioning** (:mod:`conditioning`): ``encode()`` memoised on
  (encoder identity, token ids, tokenization mode);
- **in-flight coalescing** (:mod:`coalesce`): byte-identical requests
  submitted while their twin executes wait on that one execution, each
  with its own history entry;
- **result** (:mod:`store`, filled and served by the front door's
  microbatch executor): the sampler node's output keyed on the request
  fingerprint × execution signature × conditioning mode × weights
  identity. Sound because the classifier admits only deterministic
  requests, each run bitwise its solo run.

Persistence follows ``utils/jsonio`` with checksummed sidecars
(:mod:`store`): corruption is rejected and recomputed, never served.
``CDT_CACHE=0`` removes the subsystem; a request's ``cache: "bypass"``
skips serving (it still fills). The fleet tier (A.6) and the near tier
(A.4) are not ported.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Optional

from ...utils import constants
from ...utils.logging import log
from .coalesce import InflightCoalescer
from .conditioning import cached_encode
from .keys import (conditioning_key, execution_signature,
                   request_fingerprint, result_key)
from .store import CacheTier

__all__ = [
    "CacheManager", "CacheTier", "InflightCoalescer", "build_cache_manager",
    "cache_enabled", "cached_encode", "conditioning_key",
    "execution_signature", "request_fingerprint", "result_key",
]


def cache_enabled() -> bool:
    return constants.cache()


def cache_dir() -> Optional[Path]:
    """The persisted tier's directory: ``<CDT_CACHE_DIR>/torch``, by
    default ``<CDT_OUTPUT_DIR>/content_cache_torch``; an empty
    ``CDT_CACHE_DIR`` keeps the tiers in memory. Never the JAX package's
    directory, even under one ``CDT_CACHE_DIR``."""
    env = constants.cache_dir()
    if env is not None:
        return Path(env) / "torch" if env else None
    return Path(constants.output_dir()) / "content_cache_torch"


class _HitRateWindow:
    """Sliding window over recent queued requests' result-tier outcomes
    (served or executed). Coalesced joins do not count: a waiter never
    takes a queue slot."""

    def __init__(self, size: int = 256):
        self._events: deque = deque(maxlen=size)

    def record(self, hit: bool) -> None:
        self._events.append(1 if hit else 0)

    def rate(self) -> float:
        if not self._events:
            return 0.0
        return sum(self._events) / len(self._events)


class CacheManager:
    """One controller's cache: both tiers, the coalescer and the
    request-level hit-rate window."""

    def __init__(self, directory: "Path | None" = None):
        self.dir = directory
        disk = constants.cache_disk_max_bytes()
        self.conditioning = CacheTier(
            "conditioning", constants.cache_cond_max_bytes(),
            directory=directory, disk_max_bytes=disk)
        self.results = CacheTier(
            "result", constants.cache_result_max_bytes(),
            directory=directory, disk_max_bytes=disk)
        self.coalescer = InflightCoalescer()
        self._window = _HitRateWindow()

    def record_request(self, hit: bool) -> None:
        self._window.record(hit)

    def hit_rate(self) -> float:
        """Share of recent queued fingerprinted requests the result tier
        answered without running the sampler."""
        return self._window.rate()

    def stats(self) -> dict:
        return {
            "enabled": True,
            "dir": str(self.dir) if self.dir else None,
            "hit_rate": round(self.hit_rate(), 4),
            "conditioning": self.conditioning.stats(),
            "result": self.results.stats(),
            "coalescer": self.coalescer.stats(),
        }


def build_cache_manager() -> Optional[CacheManager]:
    """The controller's cache manager, or None under ``CDT_CACHE=0``."""
    if not cache_enabled():
        log("content cache disabled (CDT_CACHE=0)")
        return None
    d = cache_dir()
    if d is not None:
        try:
            d.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            log(f"content cache: persisted tier OFF ({d}: {e}) — "
                "memory-only")
            d = None
    return CacheManager(directory=d)
