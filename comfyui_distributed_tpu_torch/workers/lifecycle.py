"""Process spawn, stop and liveness of managed worker controllers (the
port's copy of the JAX package's ``workers/lifecycle.py``).

The worker starts in a session of its own (its own process group),
wrapped in the watchdog ``worker_monitor.py`` when the config's
``stop_workers_on_master_exit`` is on; its stdout and stderr go to a
dated log file whose path it gets as ``CDT_LOG_FILE``.
``kill_process_tree`` sends SIGTERM to the process group and SIGKILL
after a grace period.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

from ..utils.exceptions import ProcessError
from ..utils.logging import log
from ..utils.process import is_process_alive, terminate_process
from .launch_builder import build_launch_command, log_file_for


class ManagedProcess:
    def __init__(self, worker_id: str, popen: Optional[subprocess.Popen] = None,
                 pid: Optional[int] = None, log_path: Optional[Path] = None):
        self.worker_id = worker_id
        self.popen = popen
        self.pid = pid if pid is not None else (popen.pid if popen else None)
        self.log_path = log_path
        self.started_at = time.time()

    def is_alive(self) -> bool:
        if self.popen is not None:
            return self.popen.poll() is None
        return self.pid is not None and is_process_alive(self.pid)


def launch_worker_process(
    worker: dict,
    master_port: int,
    config_path: str | None = None,
    use_watchdog: bool = True,
    log_dir: Path | None = None,
    device: str = "cuda",
) -> ManagedProcess:
    worker_id = str(worker.get("id", ""))
    if not worker_id:
        raise ProcessError("worker entry has no id")
    argv, env_overrides = build_launch_command(worker, master_port,
                                               config_path, device)
    if use_watchdog:
        monitor = Path(__file__).parent / "worker_monitor.py"
        argv = [sys.executable, str(monitor)] + argv
    env = {**os.environ, **env_overrides}
    log_path = log_file_for(worker_id, log_dir)
    env["CDT_LOG_FILE"] = str(log_path)

    with open(log_path, "a", encoding="utf-8") as lf:
        lf.write(
            f"\n===== launch {worker_id} at {time.strftime('%F %T')} "
            f"argv={argv} =====\n")
        lf.flush()
        kwargs: dict = {
            "stdout": lf, "stderr": subprocess.STDOUT, "env": env,
        }
        if os.name == "posix":
            kwargs["start_new_session"] = True     # own process group
        else:  # pragma: no cover - windows
            kwargs["creationflags"] = 0x08000000   # CREATE_NO_WINDOW
        try:
            popen = subprocess.Popen(argv, **kwargs)
        except OSError as e:
            raise ProcessError(f"failed to launch worker {worker_id}: {e}") from e
    log(f"launched worker {worker_id} pid={popen.pid} log={log_path}")
    return ManagedProcess(worker_id, popen, log_path=log_path)


def kill_process_tree(pid: int, grace: float = 5.0) -> bool:
    """SIGTERM the process group, escalate to SIGKILL after ``grace``
    seconds; True when the process is gone."""
    try:
        pgid = os.getpgid(pid)
    except (ProcessLookupError, PermissionError):
        return not is_process_alive(pid)
    try:
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        pass
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if not is_process_alive(pid):
            return True
        time.sleep(0.1)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        terminate_process(pid, force=True)
    time.sleep(0.2)
    return not is_process_alive(pid)
