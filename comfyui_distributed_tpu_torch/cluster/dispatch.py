"""Host probing, selection, and prompt dispatch (the JAX package's
``cluster/dispatch.py`` without drain states and warmup preference).

- ``select_active_hosts``: probe every candidate concurrently, at most
  ``probe_concurrency`` at a time → (online, offline). A host whose
  circuit breaker is open is quarantined without a probe; after the
  recovery window one half-open trial probe decides re-admission.
  Probe outcomes feed the breakers (``cluster/resilience.py``).
- ``select_least_busy_host``: round-robin among idle hosts, else the
  smallest queue;
- ``dispatch_prompt``: POST the prompt to the host's ``/prompt``, or
  with ``via_ws`` first over its ``/distributed/worker_ws`` WebSocket.
  Only a connection that never opened is retried (HTTP) or falls back
  to HTTP (WebSocket): after the request went out the worker may hold
  the prompt already, and a second send would run the job twice. The
  outcome feeds the host's breaker; a validation rejection (4xx, nack)
  counts as the host answering, for it. Each dispatch runs under a
  ``dispatch`` (or ``dispatch.ws``) span whose id rides the
  ``X-CDT-Trace`` header, so the worker's execution span parents onto
  it; its payload bytes and each attempt's latency are recorded.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time
from typing import Any, Optional, Sequence

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.exceptions import WorkerError
from ..utils.logging import log, trace_info
from ..utils.network import (build_host_url, http_request_async, never_sent,
                             probe_host, ws_connect)
from ..utils.websocket import WebSocketError
from .resilience import BREAKERS, CLOSED, RetryPolicy

# round-robin cursor for idle-host selection
_rr_counter = itertools.count()


async def select_active_hosts(
    hosts: Sequence[dict[str, Any]],
    probe_concurrency: int | None = None,
    trace_id: str | None = None,
) -> tuple[list[dict], list[dict]]:
    """Probe all candidate hosts concurrently (bounded) → (online,
    offline). Each online host dict gains ``_probe``, its health
    payload; a quarantined one gains ``_breaker: "open"``."""
    sem = asyncio.Semaphore(probe_concurrency or constants.worker_probe_concurrency())

    async def probe_one(host: dict) -> tuple[dict, Optional[dict], bool]:
        wid = str(host.get("id"))
        if not BREAKERS.allow(wid):
            return host, None, True             # quarantined, not probed
        health = None
        try:
            async with sem:
                health = await probe_host(host)
        except asyncio.CancelledError:
            # release a consumed half-open trial slot; an aborted
            # orchestration is no evidence against a closed breaker
            if BREAKERS.state(wid) != CLOSED:
                BREAKERS.record(wid, False)
            raise
        except Exception as e:  # noqa: BLE001 — one bad host counts as offline
            log(f"probe {wid} raised unexpectedly: {e!r}")
        BREAKERS.record(wid, health is not None)
        return host, health, False

    results = await asyncio.gather(*(probe_one(h) for h in hosts))
    online, offline = [], []
    for host, health, quarantined in results:
        if quarantined:
            offline.append({**host, "_breaker": "open"})
        elif health is None:
            offline.append(host)
        else:
            online.append({**host, "_probe": health})
    quarantined = sum(1 for _, _, q in results if q)
    if telemetry.enabled() and results:
        _tm.WORKER_PROBES.labels(outcome="online").inc(len(online))
        _tm.WORKER_PROBES.labels(outcome="offline").inc(
            len(offline) - quarantined)
        if quarantined:
            _tm.WORKER_PROBES.labels(outcome="quarantined").inc(quarantined)
    trace_info(trace_id, f"probe: {len(online)} online, "
                         f"{len(offline) - quarantined} offline, "
                         f"{quarantined} quarantined (breaker open)")
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


async def dispatch_prompt_ws(
    host: dict[str, Any],
    prompt: dict,
    client_id: str = "",
    extra: dict | None = None,
    trace_id: str | None = None,
) -> dict:
    """Dispatch over the WebSocket channel: connect to the host's
    ``/distributed/worker_ws``, send ``dispatch_prompt``, await the
    ``dispatch_ack``. A connection that never opened raises
    ``WorkerError`` with ``ws_undelivered``; a lost ack raises without
    it (the prompt may be queued); a nack with ``client_rejected``."""
    with telemetry.span("dispatch.ws", trace_id=trace_id,
                        host=str(host.get("id"))):
        t0 = time.perf_counter()
        outcome = "error"
        try:
            ack = await _dispatch_ws(host, prompt, client_id, extra, trace_id)
            outcome = "ok"
            return ack
        finally:
            if telemetry.enabled():
                _tm.DISPATCH_SECONDS.labels(transport="ws", outcome=outcome
                                            ).observe(time.perf_counter() - t0)


async def _dispatch_ws(host: dict[str, Any], prompt: dict, client_id: str,
                       extra: dict | None, trace_id: str | None) -> dict:
    wid = host.get("id")
    url = build_host_url(host, "/distributed/worker_ws")
    try:
        ws = await ws_connect(url, telemetry.trace_headers())
    except (OSError, asyncio.TimeoutError, WebSocketError) as e:
        err = WorkerError(f"ws dispatch to {wid} unreachable: {e}",
                          worker_id=wid)
        err.ws_undelivered = True
        raise err from e
    try:
        payload = json.dumps({"type": "dispatch_prompt", "prompt": prompt,
                              "client_id": client_id, **(extra or {})})
        if telemetry.enabled():
            _tm.DISPATCH_PAYLOAD_BYTES.labels(transport="ws").observe(
                len(payload.encode()))
        await ws.send_str(payload)
        msg = await ws.receive(timeout=constants.dispatch_timeout())
        if msg.kind != "text":
            raise WorkerError(f"ws dispatch to {wid}: connection closed "
                              f"before ack ({msg.kind})", worker_id=wid)
        try:
            ack = json.loads(msg.data)
        except ValueError:
            raise WorkerError(f"ws dispatch to {wid}: ack is not JSON",
                              worker_id=wid) from None
        if ack.get("type") != "dispatch_ack" or not ack.get("ok", False):
            err = WorkerError(
                f"ws dispatch to {wid} rejected: "
                f"{ack.get('node_errors') or ack.get('error')}", worker_id=wid)
            err.client_rejected = True
            raise err
        trace_info(trace_id, f"dispatched to {wid} (ws)")
        return ack
    except (OSError, asyncio.TimeoutError) as e:
        raise WorkerError(f"ws dispatch to {wid} failed after connect: {e!r}",
                          worker_id=wid) from e
    finally:
        await ws.close()


async def dispatch_prompt(
    host: dict[str, Any],
    prompt: dict,
    client_id: str = "",
    extra: dict | None = None,
    trace_id: str | None = None,
    via_ws: bool = False,
) -> dict:
    """Send the prompt to a host; returns its answer (``settings.
    websocket_orchestration`` sets ``via_ws``).

    Raises ``WorkerError``: with the remote validation errors on 4xx or
    a nack, and when the host cannot be reached. The final outcome
    feeds the host's breaker."""
    wid = str(host.get("id"))
    try:
        result = await _dispatch_prompt_once(host, prompt, client_id, extra,
                                             trace_id, via_ws)
    except WorkerError as e:
        # a validation rejection is the worker healthily answering a bad
        # prompt: evidence for the host, not against it
        BREAKERS.record(wid, getattr(e, "client_rejected", False))
        raise
    BREAKERS.record(wid, True)
    return result


async def _dispatch_prompt_once(host: dict[str, Any], prompt: dict,
                                client_id: str, extra: dict | None,
                                trace_id: str | None, via_ws: bool) -> dict:
    wid = host.get("id")
    if via_ws:
        try:
            return await dispatch_prompt_ws(host, prompt, client_id, extra,
                                            trace_id)
        except WorkerError as e:
            if not getattr(e, "ws_undelivered", False):
                raise        # the prompt may sit in the worker's queue
            log(f"ws connect to {wid} failed ({e}); falling back to HTTP")

    with telemetry.span("dispatch", trace_id=trace_id, host=str(wid)):
        return await _dispatch_http(host, prompt, client_id, extra, trace_id)


async def _dispatch_http(host: dict[str, Any], prompt: dict, client_id: str,
                         extra: dict | None, trace_id: str | None) -> dict:
    wid = host.get("id")
    url = build_host_url(host, "/prompt")
    body = json.dumps({"prompt": prompt, "client_id": client_id,
                       **(extra or {})}).encode()
    if telemetry.enabled():
        _tm.DISPATCH_PAYLOAD_BYTES.labels(transport="http").observe(len(body))
    # read here: the call runs in the loop's executor, out of this context
    headers = {"Content-Type": "application/json", **telemetry.trace_headers()}

    async def attempt() -> dict:
        t0 = time.perf_counter()
        outcome = "error"
        try:
            try:
                status, raw = await http_request_async(
                    url, body, headers, timeout=constants.dispatch_timeout())
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
                err = WorkerError(
                    f"dispatch to {wid} failed ({status}): {answer}",
                    worker_id=wid)
                # 4xx: the host is up and refuses the prompt; 5xx: it fails
                err.client_rejected = status < 500
                raise err
            trace_info(trace_id, f"dispatched to {wid}")
            outcome = "ok"
            return answer
        finally:
            if telemetry.enabled():
                _tm.DISPATCH_SECONDS.labels(transport="http", outcome=outcome
                                            ).observe(time.perf_counter() - t0)

    policy = RetryPolicy(max_attempts=constants.dispatch_max_retries(),
                         base=constants.send_backoff_base(),
                         cap=constants.retry_cap_s())
    return await policy.run(
        attempt, op="dispatch",
        retryable=lambda e: getattr(e, "retry_safe", False) is True)
