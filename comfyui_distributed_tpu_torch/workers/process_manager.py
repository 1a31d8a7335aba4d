"""Worker process manager and its persistence (the port's copy of the
JAX package's ``workers/process_manager.py``).

PIDs persist in the config's ``managed_processes`` and are restored,
when still alive, by the next manager on the same config. A launched
worker is ``launching`` until it reports ready
(``POST /distributed/worker/clear_launching``, sent by its controller at
startup) or for at most ``LAUNCHING_FLAG_TTL`` seconds. ``reap_dead``
drops a worker whose process exited (a card worker that finds no card
exits 2 and is reaped; it never falls back to the CPU).
"""

from __future__ import annotations

import asyncio
import time
from pathlib import Path
from typing import Optional

from ..utils.config import load_config, update_config
from ..utils.constants import config_path as config_path_override
from ..utils.exceptions import ProcessError
from ..utils.logging import log
from ..utils.process import is_process_alive
from .lifecycle import ManagedProcess, kill_process_tree, launch_worker_process


# A worker that never self-reports ready (crash during boot) must not pin
# the launching flag forever; the dashboard falls back to the probe result.
LAUNCHING_FLAG_TTL = 180.0


class WorkerProcessManager:
    """``device`` is the master's (``cuda`` or ``cpu``): its workers run
    there."""

    def __init__(self, config_path: Optional[Path] = None,
                 device: str = "cuda"):
        self.config_path = config_path
        self.device = device
        self._managed: dict[str, ManagedProcess] = {}
        # launching state: set at launch, cleared by the worker's ready
        # report (POST /distributed/worker/clear_launching)
        self._launching: dict[str, float] = {}
        self._restore_persisted()

    # --- persistence ----------------------------------------------------------

    def _restore_persisted(self) -> None:
        cfg = load_config(self.config_path)
        for wid, info in (cfg.get("managed_processes") or {}).items():
            pid = int(info.get("pid", 0) or 0)
            if pid and is_process_alive(pid):
                self._managed[wid] = ManagedProcess(
                    wid, pid=pid,
                    log_path=Path(info["log"]) if info.get("log") else None)
                log(f"restored managed worker {wid} pid={pid}")
        self._persist()

    def _persist(self) -> None:
        snapshot = {
            wid: {"pid": mp.pid, "log": str(mp.log_path) if mp.log_path else ""}
            for wid, mp in self._managed.items()
        }
        update_config(lambda c: c.update(managed_processes=snapshot),
                      self.config_path)

    # --- lifecycle ----------------------------------------------------------

    def launch_worker(self, worker_id: str) -> ManagedProcess:
        self.reap_dead()
        if worker_id in self._managed:
            raise ProcessError(f"worker {worker_id!r} already running "
                               f"(pid {self._managed[worker_id].pid})")
        cfg = load_config(self.config_path)
        worker = next(
            (h for h in cfg.get("hosts", []) if h.get("id") == worker_id), None)
        if worker is None:
            raise ProcessError(f"no configured host {worker_id!r}")
        stop_on_exit = cfg.get("settings", {}).get(
            "stop_workers_on_master_exit", True)
        mp = launch_worker_process(
            worker,
            master_port=cfg.get("master", {}).get("port", 8288),
            config_path=(str(self.config_path) if self.config_path
                         else config_path_override()),
            use_watchdog=stop_on_exit,
            device=self.device,
        )
        self._managed[worker_id] = mp
        self._launching[worker_id] = time.monotonic()
        self._persist()
        return mp

    def stop_worker(self, worker_id: str) -> bool:
        mp = self._managed.pop(worker_id, None)
        self._launching.pop(worker_id, None)
        if mp is None:
            return False
        ok = kill_process_tree(mp.pid) if mp.pid else True
        self._persist()
        log(f"stopped worker {worker_id} (pid {mp.pid}, clean={ok})")
        return True

    def clear_launching(self, worker_id: str) -> bool:
        """Worker self-reported ready; returns whether the flag was set."""
        return self._launching.pop(worker_id, None) is not None

    def is_launching(self, worker_id: str) -> bool:
        ts = self._launching.get(worker_id)
        if ts is None:
            return False
        if time.monotonic() - ts > LAUNCHING_FLAG_TTL:
            del self._launching[worker_id]
            return False
        return True

    def get_managed_workers(self) -> dict[str, dict]:
        self.reap_dead()
        return {
            wid: {"pid": mp.pid, "alive": True,
                  "log": str(mp.log_path) if mp.log_path else "",
                  "launching": self.is_launching(wid),
                  "started_at": mp.started_at}
            for wid, mp in self._managed.items()
        }

    def reap_dead(self) -> list[str]:
        """Drop the entries whose process exited."""
        dead = [wid for wid, mp in self._managed.items() if not mp.is_alive()]
        for wid in dead:
            del self._managed[wid]
            self._launching.pop(wid, None)
        if dead:
            self._persist()
        return dead

    def cleanup_all(self) -> None:
        for wid in list(self._managed):
            self.stop_worker(wid)


async def delayed_auto_launch(manager: WorkerProcessManager, delay: float = 2.0
                              ) -> list[str]:
    """Launch the enabled ``local`` hosts after a settle delay, when the
    config's ``settings.auto_launch_workers`` is on."""
    await asyncio.sleep(delay)
    cfg = load_config(manager.config_path)
    if not cfg.get("settings", {}).get("auto_launch_workers"):
        return []
    launched = []
    for host in cfg.get("hosts", []):
        if host.get("enabled") and host.get("type") == "local":
            try:
                manager.launch_worker(host["id"])
                launched.append(host["id"])
            except ProcessError as e:
                log(f"auto-launch {host.get('id')} failed: {e}")
    return launched
