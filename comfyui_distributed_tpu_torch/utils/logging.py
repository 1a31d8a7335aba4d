"""Minimal logger of the port: one prefixed line on stderr per message,
and the JAX package's execution-trace ids."""

from __future__ import annotations

import secrets
import sys
import time

_PREFIX = "[Distributed-Torch]"


def log(msg: str) -> None:
    print(f"{_PREFIX} {msg}", file=sys.stderr, flush=True)


def new_trace_id() -> str:
    """``exec_<ms>_<6hex>``, the id one ``/distributed/queue`` request
    carries through orchestration, dispatch and collection."""
    return f"exec_{int(time.time() * 1000)}_{secrets.token_hex(3)}"


def trace_info(trace_id: str | None, msg: str) -> None:
    log(f"[exec:{trace_id or '-'}] {msg}")
