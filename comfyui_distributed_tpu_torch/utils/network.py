"""HTTP client on the standard library: URL helpers, one blocking call
and its asyncio form, the WebSocket connect, host probing.

Every call goes through an opener without proxy handling (a cluster's
peers are addressed directly) and carries a timeout. ``urllib`` blocks,
so coroutines run it in the loop's default executor. Every outbound peer
call carries the cluster token when one is configured (``utils/auth.py``),
and consults the active fault plan (``cluster/faults.py``) when there is
one.
"""

from __future__ import annotations

import asyncio
import functools
import json
import time
import urllib.error
import urllib.request
from typing import Any, Optional

from ..cluster.faults import active_plan, op_for_url
from . import constants, websocket
from .auth import AUTH_HEADER, resolve_token

# Domains that imply TLS whatever scheme is given
_HTTPS_DOMAINS = ("trycloudflare.com", "ngrok.io", "ngrok-free.app", "proxy.runpod.net")

_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))

# Config the outbound token is read from. A Controller built with an
# explicit config path registers it, so inbound checks and outbound
# credentials read the same config.
_auth_config_path = None


def set_auth_config_path(path) -> None:
    global _auth_config_path
    _auth_config_path = path


def _with_token(headers: dict[str, str] | None) -> dict[str, str]:
    headers = dict(headers or {})
    token = resolve_token(_auth_config_path)
    if token:
        headers.setdefault(AUTH_HEADER, token)
    return headers


def normalize_host_url(address: str) -> str:
    """'host:port' or bare host → full URL; cloud domains force https."""
    addr = address.strip().rstrip("/")
    if not addr:
        return ""
    if "://" not in addr:
        scheme = "https" if any(d in addr for d in _HTTPS_DOMAINS) else "http"
        addr = f"{scheme}://{addr}"
    if addr.startswith("http://") and any(d in addr for d in _HTTPS_DOMAINS):
        addr = "https://" + addr[len("http://"):]
    return addr


def build_host_url(host: dict[str, Any], path: str = "") -> str:
    base = normalize_host_url(host.get("address", ""))
    return f"{base}{path}"


def build_master_callback_url(master_cfg: dict[str, Any], for_local: bool = False) -> str:
    """URL a worker host uses to reach the master; local workers use
    loopback."""
    port = master_cfg.get("port", 8288)
    if for_local or not master_cfg.get("host"):
        return f"http://127.0.0.1:{port}"
    base = normalize_host_url(str(master_cfg["host"]))
    if base.rsplit(":", 1)[-1].isdigit() or base.startswith("https://"):
        return base
    return f"{base}:{port}"


def http_request(url: str, data: bytes | None = None,
                 headers: dict[str, str] | None = None,
                 timeout: float | None = None,
                 method: str | None = None) -> tuple[int, bytes]:
    """One blocking call (POST when ``data`` is given, else GET, unless
    ``method`` names another) → (status, body). A 4xx/5xx answer is
    returned, not raised; a transport failure raises ``URLError`` or
    ``OSError``."""
    headers = _with_token(headers)
    plan = active_plan()
    fault = plan.next_fault(op_for_url(url)) if plan is not None else None
    if fault is not None:
        if fault.kind == "drop":
            raise urllib.error.URLError(
                ConnectionRefusedError(f"injected drop ({url})"))
        if fault.kind == "silence":
            return 200, b'{"status": "ok"}'
        if fault.kind == "http500":
            return int(fault.value) or 500, b'{"error": "injected fault"}'
        if fault.kind == "latency":
            time.sleep(fault.value or 0.05)
        elif data is not None:                  # corrupt, truncate
            data = plan.mutate_body(fault, data,
                                    headers.get("Content-Type", ""))
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method=method)
    try:
        with _OPENER.open(req, timeout=timeout or constants.dispatch_timeout()) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


async def http_request_async(url: str, data: bytes | None = None,
                             headers: dict[str, str] | None = None,
                             timeout: float | None = None,
                             method: str | None = None) -> tuple[int, bytes]:
    """``http_request`` in the running loop's default executor."""
    return await asyncio.get_running_loop().run_in_executor(
        None, functools.partial(http_request, url, data, headers, timeout,
                                method))


async def ws_connect(url: str, headers: dict[str, str] | None = None
                     ) -> "websocket.WebSocket":
    """Open a WebSocket to a peer (``utils/websocket.connect``) with the
    cluster token and ``headers``; a fault plan may drop or delay the
    connect."""
    plan = active_plan()
    fault = plan.next_fault(op_for_url(url)) if plan is not None else None
    if fault is not None:
        if fault.kind == "drop":
            raise ConnectionRefusedError(f"injected ws drop ({url})")
        if fault.kind == "latency":
            await asyncio.sleep(fault.value or 0.05)
    return await websocket.connect(url, _with_token(headers),
                                   constants.dispatch_timeout())


def never_sent(e: BaseException) -> bool:
    """True only when the connection was refused: the request provably
    never reached the peer, so sending it again cannot run it twice."""
    if isinstance(e, ConnectionRefusedError):
        return True
    return (isinstance(e, urllib.error.URLError)
            and isinstance(e.reason, ConnectionRefusedError))


async def _get_json(url: str, timeout: float) -> Optional[dict]:
    try:
        status, body = await http_request_async(url, timeout=timeout)
        return json.loads(body) if status == 200 else None
    except (OSError, ValueError):       # URLError is an OSError
        return None


async def probe_host(address_or_host: Any, timeout: float | None = None
                     ) -> Optional[dict]:
    """GET /distributed/health → status dict, or None if unreachable."""
    url = (
        build_host_url(address_or_host, "/distributed/health")
        if isinstance(address_or_host, dict)
        else normalize_host_url(str(address_or_host)) + "/distributed/health"
    )
    return await _get_json(url, timeout or constants.probe_timeout())


async def fetch_system_info(host: dict[str, Any], timeout: float = 10.0
                            ) -> Optional[dict]:
    """GET a host's ``/distributed/system_info`` → dict, or None when
    unreachable."""
    return await _get_json(build_host_url(host, "/distributed/system_info"),
                           timeout)
