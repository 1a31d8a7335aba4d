"""Machine identity and local/remote classification of a host.

A host is local when it reports this machine's identity over
``/distributed/system_info``; loopback addresses need no call.
"""

from __future__ import annotations

import platform
import uuid
from typing import Optional

from ..utils.network import fetch_system_info


def get_machine_id() -> str:
    """Stable machine identity: hostname and MAC."""
    return f"{platform.node()}-{uuid.getnode():012x}"


async def fetch_remote_machine_id(host: dict) -> Optional[str]:
    """The host's ``/distributed/system_info`` → machine_id, or None
    when unreachable."""
    info = await fetch_system_info(host)
    return info.get("machine_id") if info else None


async def is_local_host(host: dict) -> bool:
    address = str(host.get("address", ""))
    if any(lb in address for lb in ("127.0.0.1", "localhost", "[::1]")):
        return True
    remote = await fetch_remote_machine_id(host)
    return remote is not None and remote == get_machine_id()


async def classify_host(host: dict) -> str:
    """'local' | 'remote': a type pinned in the config wins, else the
    machine-id comparison decides."""
    declared = host.get("type")
    if declared in ("local", "remote"):
        return declared
    return "local" if await is_local_host(host) else "remote"
