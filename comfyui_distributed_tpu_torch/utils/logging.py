"""Minimal logger of the port: one prefixed line on stderr per message."""

from __future__ import annotations

import sys

_PREFIX = "[Distributed-Torch]"


def log(msg: str) -> None:
    print(f"{_PREFIX} {msg}", file=sys.stderr, flush=True)
