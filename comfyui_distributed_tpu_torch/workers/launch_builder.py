"""Build the argv and env of a managed worker controller (the port's copy
of the JAX package's ``workers/launch_builder.py``).

The worker is ``python -m comfyui_distributed_tpu_torch serve --port P
--device D``, ``D`` the master's device: a master on the card launches
workers on the card, a master on the CPU (the tests) workers on the CPU.
``extra_args`` is split with ``shlex`` after a shell-metacharacter
denylist. A host entry with ``cuda_device`` (written by
``detection.auto_populate_hosts``) pins its worker to that card with
``CUDA_VISIBLE_DEVICES``, as the reference pins one process per GPU; a
host entry's ``mesh_devices`` (> 0) becomes ``CDT_MESH_DEVICES``, the
worker's mesh of that many devices over ``dp`` (``cluster/controller``).
"""

from __future__ import annotations

import datetime
import os
import shlex
import sys
from pathlib import Path

from ..utils.constants import log_dir as default_log_dir
from ..utils.exceptions import ProcessError

_SHELL_META = set(";&|<>`$(){}[]!*?~#\n")
PACKAGE = "comfyui_distributed_tpu_torch"


def split_extra_args(extra: str) -> list[str]:
    if not extra:
        return []
    bad = _SHELL_META & set(extra)
    if bad:
        raise ProcessError(
            f"extra_args contains shell metacharacters {sorted(bad)}")
    return shlex.split(extra)


def build_launch_command(
    worker: dict,
    master_port: int,
    config_path: str | None = None,
    device: str = "cuda",
) -> tuple[list[str], dict[str, str]]:
    """Returns (argv, env_overrides) for the controller subprocess."""
    port = worker.get("port") or _port_from_address(worker.get("address", ""))
    if not port:
        raise ProcessError(f"worker {worker.get('id')!r} has no port")
    argv = [
        sys.executable, "-m", PACKAGE,
        "serve", "--port", str(port), "--device", device,
    ]
    argv += split_extra_args(worker.get("extra_args", ""))

    env = {
        "CDT_IS_WORKER": "1",
        "CDT_WORKER_ID": str(worker.get("id", "")),
        "CDT_MASTER_PID": str(os.getpid()),
        "CDT_MASTER_PORT": str(master_port),
    }
    if config_path:
        env["CDT_CONFIG_PATH"] = str(config_path)
    cuda_device = worker.get("cuda_device")
    if isinstance(cuda_device, int) and cuda_device >= 0:
        env["CUDA_VISIBLE_DEVICES"] = str(cuda_device)
    mesh_devices = worker.get("mesh_devices", -1)
    if isinstance(mesh_devices, int) and mesh_devices > 0:
        env["CDT_MESH_DEVICES"] = str(mesh_devices)
    return argv, env


def _port_from_address(address: str) -> int | None:
    tail = address.rsplit(":", 1)
    if len(tail) == 2 and tail[1].split("/")[0].isdigit():
        return int(tail[1].split("/")[0])
    return None


def log_file_for(worker_id: str, log_dir: Path | None = None) -> Path:
    """Per-worker dated log file under ``CDT_LOG_DIR``."""
    base = log_dir or Path(default_log_dir())
    base.mkdir(parents=True, exist_ok=True)
    stamp = datetime.date.today().isoformat()
    return base / f"worker_{worker_id}_{stamp}.log"
