"""Deadline-guarded device queries for the control plane (the port's
copy of the JAX package's ``utils/deadline.py``).

A device query that stalls (a wedged driver, a card that stopped
answering) must not freeze the event loop, and with it
``/distributed/health``, the route peers use to decide this host is
dead. ``deadline_call`` runs the query on a dedicated daemon thread with
a deadline and returns ``fallback`` when it passes.

Leak discipline: a stalled call can never be cancelled, so each timeout
leaves its thread parked. Queries run on their own daemon threads (never
the loop's default executor, where worker launch, the tunnel and media
hashing run) behind a 2-permit semaphore: at most two threads can be
stuck, further calls fall back at once, and interpreter shutdown is
never blocked. After a stall a cooldown gate short-circuits further
attempts.

Exceptions are not stalls: a query that fails fast propagates to the
caller (the route answers the real error) and does not close the gate.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Any, Callable

from .logging import log

_blocked_until = 0.0
_inflight = threading.Semaphore(2)


def gate_open() -> bool:
    return time.monotonic() >= _blocked_until


def _note_stall(cooldown_s: float) -> None:
    global _blocked_until
    _blocked_until = time.monotonic() + cooldown_s


def reset_gate() -> None:
    """Test hook / manual recovery."""
    global _blocked_until
    _blocked_until = 0.0
    # NOTE: permits held by genuinely-stuck threads are unrecoverable by
    # design (the thread itself must finish to release)


async def deadline_call(fn: Callable[[], Any], timeout_s: float = 5.0,
                        cooldown_s: float = 120.0,
                        fallback: Any = None) -> Any:
    """Run a (possibly-hanging) device-backend query off the event loop
    with a deadline.

    - timeout → log, close the gate for ``cooldown_s``, return
      ``fallback`` (the thread stays parked until the RPC dies);
    - gate closed or both leak permits consumed → ``fallback``
      immediately;
    - ``fn`` raises → the exception PROPAGATES (fast failures carry
      real diagnostics; only stalls degrade)."""
    if not gate_open():
        return fallback
    if not _inflight.acquire(blocking=False):
        return fallback
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()

    def deliver(cb):
        try:
            loop.call_soon_threadsafe(cb)
        except RuntimeError:
            pass      # loop already closed — a freed stale thread's
                      # result has nowhere to go, and that's fine

    def runner():
        try:
            result = fn()
        except BaseException as e:  # noqa: BLE001 — delivered, not dropped
            # bind NOW: CPython clears the except-variable at block
            # exit, racing the scheduled callback (a bare closure over
            # `e` intermittently dies with NameError and the failure
            # would misclassify as a stall)
            deliver(lambda exc=e: fut.set_exception(exc)
                    if not fut.done() else None)
        else:
            deliver(lambda: fut.set_result(result)
                    if not fut.done() else None)
        finally:
            _inflight.release()

    threading.Thread(target=runner, daemon=True,
                     name="cdt-device-query").start()
    try:
        return await asyncio.wait_for(fut, timeout=timeout_s)
    except asyncio.TimeoutError:
        _note_stall(cooldown_s)
        log(f"device backend unresponsive (> {timeout_s:.0f}s) — "
            f"degrading device queries for {cooldown_s:.0f}s")
        return fallback
