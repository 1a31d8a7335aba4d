"""Cross-platform process primitives (the port's copy of the JAX
package's ``utils/process.py``)."""

from __future__ import annotations

import os
import signal
import subprocess


def is_process_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    if os.name == "posix":
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
        # signal-0 succeeds on zombies; consult /proc state where available
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                stat = f.read()
            state = stat.rsplit(b") ", 1)[-1][:1]
            return state != b"Z"
        except OSError:
            return True
    out = subprocess.run(  # pragma: no cover - windows
        ["tasklist", "/FI", f"PID eq {pid}"], capture_output=True, text=True)
    return str(pid) in out.stdout


def terminate_process(pid: int, force: bool = False) -> None:
    try:
        if os.name == "posix":
            os.kill(pid, signal.SIGKILL if force else signal.SIGTERM)
        else:  # pragma: no cover - windows
            subprocess.run(["taskkill", "/PID", str(pid)] +
                           (["/F"] if force else []), capture_output=True)
    except (ProcessLookupError, PermissionError):
        pass
