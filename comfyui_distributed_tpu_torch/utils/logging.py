"""Logger of the port: one prefixed line on stderr per message, a rolling
buffer of recent lines (served by ``/distributed/local_log`` when the
process has no ``CDT_LOG_FILE``), a config-gated ``debug_log``, and the
JAX package's execution-trace ids.

A launched worker's stderr goes to its log file (``workers/lifecycle.py``
sets ``CDT_LOG_FILE`` to it), so its ``/distributed/local_log`` tails the
file.
"""

from __future__ import annotations

import collections
import secrets
import sys
import time
from typing import Callable

_PREFIX = "[Distributed-Torch]"

_BUFFER_LINES = 400
_log_buffer: collections.deque[str] = collections.deque(maxlen=_BUFFER_LINES)

# TTL cache of the debug gate, so a hot loop does not read the config on
# every call
_DEBUG_TTL = 5.0
_debug_cache: tuple[float, bool] | None = None
_debug_source: Callable[[], bool] | None = None


def get_log_buffer() -> list[str]:
    return list(_log_buffer)


def set_debug_source(fn: Callable[[], bool] | None) -> None:
    """Install the callable that reports whether debug logging is on
    (normally the config's ``settings.debug``); ``None`` leaves only
    ``CDT_DEBUG``."""
    global _debug_source, _debug_cache
    _debug_source = fn
    _debug_cache = None


def _debug_enabled() -> bool:
    global _debug_cache
    now = time.monotonic()
    if _debug_cache is not None and now - _debug_cache[0] < _DEBUG_TTL:
        return _debug_cache[1]
    from .constants import debug

    enabled = debug()
    if not enabled and _debug_source is not None:
        try:
            enabled = bool(_debug_source())
        except Exception:  # noqa: BLE001 — a broken source reads as off
            enabled = False
    _debug_cache = (now, enabled)
    return enabled


def log(msg: str) -> None:
    line = f"{_PREFIX} {msg}"
    _log_buffer.append(f"{time.strftime('%H:%M:%S')} {line}")
    print(line, file=sys.stderr, flush=True)


def debug_log(msg: str) -> None:
    if _debug_enabled():
        log(f"[DEBUG] {msg}")


def new_trace_id() -> str:
    """``exec_<ms>_<6hex>``, the id one ``/distributed/queue`` request
    carries through orchestration, dispatch and collection."""
    return f"exec_{int(time.time() * 1000)}_{secrets.token_hex(3)}"


def trace_info(trace_id: str | None, msg: str) -> None:
    log(f"[exec:{trace_id or '-'}] {msg}")
