"""Machine identity, local/remote classification of a host, and the
first-launch host list.

A host is local when it reports this machine's identity over
``/distributed/system_info``; loopback addresses need no call.
``auto_populate_hosts`` follows the reference's rule for cards (one
worker per CUDA device other than the master's, at ports from 8189);
the JAX package reads the TPU slice's hosts instead.
"""

from __future__ import annotations

import platform
import uuid
from typing import Optional, Sequence

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


FIRST_WORKER_PORT = 8189


def _cuda_census() -> tuple[list[int], int]:
    """(indices of the visible CUDA devices, the master's index)."""
    import torch

    if not torch.cuda.is_available():
        return [], 0
    return list(range(torch.cuda.device_count())), torch.cuda.current_device()


def auto_populate_hosts(config: dict, base_port: Optional[int] = None,
                        force: bool = False,
                        devices: Optional[Sequence[int]] = None,
                        master_device: Optional[int] = None) -> bool:
    """First-launch host list: one enabled ``local`` worker per CUDA device
    other than the master's (``devices`` and ``master_device`` default to
    this process's census), at ports ``base_port`` (8189) and up, each
    pinned to its card by ``cuda_device``. Guarded by
    ``settings.has_auto_populated_workers``; ``force`` (the dashboard's
    button) runs it again. Hosts already at an address are kept. Returns
    True when the config changed (the guard flag counts)."""
    settings = config.setdefault("settings", {})
    if settings.get("has_auto_populated_workers") and not force:
        return False
    settings["has_auto_populated_workers"] = True
    if devices is None or master_device is None:
        found, current = _cuda_census()
        devices = found if devices is None else devices
        master_device = current if master_device is None else master_device
    port = FIRST_WORKER_PORT if base_port is None else base_port
    hosts = config.setdefault("hosts", [])
    existing_addrs = {h.get("address") for h in hosts}
    existing_ids = {h.get("id") for h in hosts}
    for index in devices:
        if index == master_device:
            continue
        address = f"http://127.0.0.1:{port}"
        port += 1
        if address in existing_addrs:
            continue
        hid = f"gpu{index}"
        while hid in existing_ids:
            hid += "_auto"
        existing_ids.add(hid)
        hosts.append({
            "id": hid,
            "name": f"CUDA device {index}",
            "address": address,
            "enabled": True,
            "type": "local",
            "cuda_device": index,
        })
    return True
