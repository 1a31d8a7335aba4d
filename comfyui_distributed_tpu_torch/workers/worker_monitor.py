"""Out-of-process watchdog (the port's copy of the JAX package's
``workers/worker_monitor.py``).

    python worker_monitor.py <worker argv...>

Runs as its own process wrapping the real worker: spawns it, writes
``monitor_pid,worker_pid`` to ``CDT_PID_FILE`` when that is set, polls
the master PID (``CDT_MASTER_PID``) every ``CDT_MONITOR_POLL`` seconds,
and stops the worker when the master dies or on SIGTERM/SIGINT, so an
orphaned worker never outlives a crashed master (and its card memory
with it). Exits with the worker's status.

Standalone: it imports nothing of the port but its optional telemetry,
because it may run from a bare file path; its liveness helpers are
inlined.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

POLL_INTERVAL = float(os.environ.get("CDT_MONITOR_POLL", "2.0"))

# Telemetry is OPTIONAL here: the monitor must keep working when run from
# a bare file path with no package on sys.path (its standalone contract).
# The telemetry core is stdlib-only, so when the package IS importable
# this costs nothing extra.
try:
    from comfyui_distributed_tpu_torch.telemetry import (
        enabled as _tm_enabled, metrics as _tm)
except Exception:  # noqa: BLE001 — bare-file execution
    _tm = None


def _count(outcome: str) -> None:
    if _tm is not None and _tm_enabled():
        _tm.WORKER_MONITOR_CHECKS.labels(outcome=outcome).inc()


def _alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _kill_worker(proc: subprocess.Popen) -> None:
    if proc.poll() is not None:
        return
    try:
        pgid = os.getpgid(proc.pid)
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError, OSError):
        proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            proc.kill()


def monitor_and_run(argv: list[str]) -> int:
    master_pid = int(os.environ.get("CDT_MASTER_PID", "0") or 0)
    kwargs: dict = {}
    if os.name == "posix":
        kwargs["start_new_session"] = True
    proc = subprocess.Popen(argv, **kwargs)

    pid_file = os.environ.get("CDT_PID_FILE", "")
    if pid_file:
        try:
            with open(pid_file, "w", encoding="utf-8") as f:
                f.write(f"{os.getpid()},{proc.pid}")
        except OSError:
            pass

    def on_signal(signum, frame):
        _count("signal")
        _kill_worker(proc)
        sys.exit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)

    while True:
        code = proc.poll()
        if code is not None:
            _count("worker_exit")
            return code
        if master_pid and not _alive(master_pid):
            _count("master_died")
            print(f"[worker_monitor] master {master_pid} died; stopping worker",
                  file=sys.stderr)
            _kill_worker(proc)
            return 0
        time.sleep(POLL_INTERVAL)


if __name__ == "__main__":
    sys.exit(monitor_and_run(sys.argv[1:]))
