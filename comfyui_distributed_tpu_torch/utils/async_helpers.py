"""Sync → async bridging for node execution.

Graph execution is synchronous (a prompt runs in the queue's execution
thread); the control plane is an asyncio loop. Nodes that talk to the
control plane (the collector's send and collect) hop onto the loop with
``run_in_loop``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from typing import Any, Coroutine, Optional


def run_in_loop(
    coro: Coroutine,
    loop: asyncio.AbstractEventLoop,
    timeout: Optional[float] = None,
) -> Any:
    """Run ``coro`` on ``loop`` from a thread other than the loop's and
    wait for it. From the loop's own thread it would deadlock, so it
    raises there."""
    if loop.is_closed():
        coro.close()
        raise RuntimeError("event loop is closed")
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is loop:
        coro.close()
        raise RuntimeError(
            "run_in_loop called from the loop's own thread; await instead")
    fut = asyncio.run_coroutine_threadsafe(coro, loop)
    try:
        return fut.result(timeout)
    except concurrent.futures.TimeoutError:
        fut.cancel()
        raise TimeoutError(f"coroutine did not finish within {timeout}s") from None
