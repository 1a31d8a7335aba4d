"""Machine identity, the host's environment, local/remote classification
of a host, and the first-launch host list.

``detect_environment`` is the ``environment`` of
``/distributed/system_info`` (the JAX package's, with the CUDA variables
where it has the TPU's): docker (``/.dockerenv`` or process 1's cgroup),
kubernetes and the visible-device variables, all read without a driver
call. The device census adds the card's name and ``driver_version``.

A host is local when it reports this machine's identity over
``/distributed/system_info``; loopback addresses need no call.
``auto_populate_hosts`` follows the reference's rule for cards (one
worker per CUDA device other than the master's, at ports from 8189);
the JAX package reads the TPU slice's hosts instead.
"""

from __future__ import annotations

import os
import platform
import shutil
import subprocess
import threading
import uuid
from pathlib import Path
from typing import Any, Optional, Sequence

from ..utils.network import fetch_system_info


def get_machine_id() -> str:
    """Stable machine identity: hostname and MAC."""
    return f"{platform.node()}-{uuid.getnode():012x}"


def is_docker() -> bool:
    """``/.dockerenv``, or a docker cgroup of process 1."""
    if Path("/.dockerenv").exists():
        return True
    try:
        return "docker" in Path("/proc/1/cgroup").read_text()
    except OSError:
        return False


def is_kubernetes() -> bool:
    return bool(os.environ.get("KUBERNETES_SERVICE_HOST"))


def cuda_environment() -> dict[str, Any]:
    """The visible-device variables that are set. Reads the environment
    only: the degraded ``/distributed/system_info`` serves it while the
    driver does not answer, so nothing here may call into the driver."""
    return {var.lower(): os.environ[var]
            for var in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")
            if os.environ.get(var)}


# nvidia-smi's answer, once start_driver_probe's thread has it
_smi_answer: list[str] = []
_smi_started = threading.Event()


def driver_version() -> Optional[str]:
    """The NVIDIA driver's version: ``/proc/driver/nvidia/version``, else
    what ``start_driver_probe`` learnt from ``nvidia-smi``; None while
    neither has it. Waits on nothing, so it fits under a deadline."""
    try:
        text = Path("/proc/driver/nvidia/version").read_text()
    except OSError:
        text = ""
    for word in text.split():
        parts = word.split(".")
        if len(parts) >= 2 and all(p.isdigit() for p in parts):
            return word
    return _smi_answer[0] if _smi_answer else None


def start_driver_probe() -> None:
    """Ask ``nvidia-smi`` for the driver's version once a process, on a
    daemon thread, so that no request waits on the tool (hosts whose
    ``/proc`` does not carry the driver, such as gVisor sandboxes)."""
    if _smi_started.is_set():
        return
    _smi_started.set()
    threading.Thread(target=_ask_smi, name="cdt-driver-version",
                     daemon=True).start()


def _ask_smi() -> None:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return
    try:
        out = subprocess.run(
            [smi, "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return
    lines = out.stdout.strip().splitlines()
    if out.returncode == 0 and lines:
        _smi_answer.append(lines[0].strip())


def detect_environment() -> dict[str, Any]:
    return {
        "machine_id": get_machine_id(),
        "platform": platform.system().lower(),
        "docker": is_docker(),
        "kubernetes": is_kubernetes(),
        "cuda": cuda_environment(),
    }


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
