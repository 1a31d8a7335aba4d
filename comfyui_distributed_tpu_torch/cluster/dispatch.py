"""Host probing, selection, and prompt dispatch (the JAX package's
``cluster/dispatch.py`` without the WebSocket channel, circuit breakers
and drain states).

- ``select_active_hosts``: probe every candidate concurrently, at most
  ``probe_concurrency`` at a time → (online, offline);
- ``select_least_busy_host``: round-robin among idle hosts, else the
  smallest queue;
- ``dispatch_prompt``: POST the prompt to the host's ``/prompt``. Only a
  refused connection is retried: a timeout or an error after the
  request went out may mean the worker holds the prompt already, and a
  second send would run the job twice.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import random
from typing import Any, Awaitable, Callable, Optional, Sequence

from ..utils import constants
from ..utils.exceptions import WorkerError
from ..utils.logging import trace_info
from ..utils.network import (build_host_url, http_request_async, never_sent,
                             probe_host)

# round-robin cursor for idle-host selection
_rr_counter = itertools.count()


async def run_with_retries(attempt: Callable[[], Awaitable[Any]],
                           attempts: int,
                           retryable: Callable[[BaseException], bool]) -> Any:
    """Call ``attempt`` until it returns, raises what ``retryable``
    rejects, or ``attempts`` calls failed (the last error re-raises).
    Between calls it sleeps a full-jitter exponential backoff:
    uniform(0, min(cap, base·2^n))."""
    base, cap = constants.send_backoff_base(), constants.retry_cap_s()
    for n in range(attempts):
        try:
            return await attempt()
        except Exception as e:  # noqa: BLE001 — the predicate decides
            if n == attempts - 1 or not retryable(e):
                raise
        await asyncio.sleep(random.uniform(0.0, min(cap, base * 2 ** n)))
    raise ValueError("attempts must be at least 1")


async def select_active_hosts(
    hosts: Sequence[dict[str, Any]],
    probe_concurrency: int | None = None,
    trace_id: str | None = None,
) -> tuple[list[dict], list[dict]]:
    """Probe all candidate hosts concurrently (bounded) → (online,
    offline). Each online host dict gains ``_probe``, its health
    payload."""
    sem = asyncio.Semaphore(probe_concurrency or constants.WORKER_PROBE_CONCURRENCY)

    async def probe_one(host: dict) -> Optional[dict]:
        async with sem:
            return await probe_host(host)

    healths = await asyncio.gather(*(probe_one(h) for h in hosts))
    online = [{**h, "_probe": health} for h, health in zip(hosts, healths)
              if health is not None]
    offline = [h for h, health in zip(hosts, healths) if health is None]
    trace_info(trace_id, f"probe: {len(online)} online, {len(offline)} offline")
    return online, offline


def queue_depth(host: dict) -> int:
    return int((host.get("_probe") or {}).get("queue_remaining", 0))


def select_least_busy_host(online_hosts: Sequence[dict]) -> Optional[dict]:
    """Round-robin among idle hosts; else the smallest queue."""
    if not online_hosts:
        return None
    idle = [h for h in online_hosts if queue_depth(h) == 0]
    if idle:
        return idle[next(_rr_counter) % len(idle)]
    return min(online_hosts, key=queue_depth)


async def dispatch_prompt(
    host: dict[str, Any],
    prompt: dict,
    client_id: str = "",
    extra: dict | None = None,
    trace_id: str | None = None,
) -> dict:
    """POST the prompt to a host's ``/prompt``; returns its answer.

    Raises ``WorkerError``: with the remote validation errors on 4xx,
    and when the host cannot be reached."""
    wid = host.get("id")
    url = build_host_url(host, "/prompt")
    body = json.dumps({"prompt": prompt, "client_id": client_id,
                       **(extra or {})}).encode()

    async def attempt() -> dict:
        try:
            status, raw = await http_request_async(
                url, body, {"Content-Type": "application/json"},
                timeout=constants.dispatch_timeout())
        except OSError as e:          # URLError, refused, reset, timeout
            err = WorkerError(f"dispatch to {wid} unreachable: {e}",
                              worker_id=wid)
            err.retry_safe = never_sent(e)
            raise err from e
        try:
            answer = json.loads(raw)
        except ValueError:
            answer = {"body": raw[:200].decode("utf-8", "replace")}
        if status >= 400:
            raise WorkerError(f"dispatch to {wid} failed ({status}): {answer}",
                              worker_id=wid)
        trace_info(trace_id, f"dispatched to {wid}")
        return answer

    return await run_with_retries(
        attempt, constants.dispatch_max_retries(),
        retryable=lambda e: getattr(e, "retry_safe", False) is True)
