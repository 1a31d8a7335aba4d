"""The host controller: one per process, owning that process's card.

Its role comes from ``CDT_IS_WORKER``: a master orchestrates and
collects, a worker executes dispatched prompts and sends its results
back. Both run the same code and the same HTTP app (``api/app.py``).
Besides the collector bridge it owns the tile farm of the upscale
workflow (``cluster/tile_farm.py``), both bound to the server's loop at
startup, the sampling-progress tracker (``cluster/progress.py``) and, on
a master, the manager of the worker processes it launches
(``workers/process_manager.py``). A launched worker reports ready to its
master's ``CDT_MASTER_PORT`` once its control plane is up.
It builds the content cache (``cluster/cache``, None under
``CDT_CACHE=0``), which its execution context carries to
``CLIPTextEncode`` and the group executor, with its fleet tier
(``cluster/cache/fleet.py``, None under ``CDT_FLEET_CACHE=0``: a ring
over this host and the configured ones, bound to the loop at startup
and unsubscribed from the drain feed at shutdown), the stage pools
(``cluster/stages``, None under ``CDT_STAGES=0``), attached to the
prompt queue and the front door and stopped at shutdown, the serving
front door (``cluster/frontdoor``, None under ``CDT_FRONTDOOR=0``),
started on its loop, step-granular preemption (``cluster/preemption.py``,
None under ``CDT_PREEMPT=0``), attached to the prompt queue, and the
warm-pass state machine (``diffusion/warmup.py``): with ``CDT_WARMUP=1``
a pass over the shape catalog runs at startup in a thread off the loop,
and ``health()`` reports its state. At startup it builds the elastic
fleet's manager on its loop (``cluster/elastic``: drains always, the
autoscaler's loop under ``CDT_AUTOSCALE=1``), stopped at shutdown.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import platform
import threading
from pathlib import Path
from typing import Any, Optional

import torch

from ..diffusion.warmup import WarmupManager
from ..utils import constants
from ..utils.config import ensure_config_exists, load_config, peek_setting
from ..utils.device import DeviceLike, resolve_device, use_full_fp32
from ..utils.logging import log, set_debug_source
from ..utils.network import http_request_async, set_auth_config_path
from ..workers.detection import (detect_environment, driver_version,
                                 get_machine_id, is_docker,
                                 start_driver_probe)
from .cache import build_cache_manager
from .collector_bridge import CollectorBridge
from .frontdoor import build_frontdoor
from .job_store import JobStore
from .orchestration import Orchestrator
from .preemption import build_preemption
from .progress import ProgressTracker
from .runtime import PromptQueue
from .stages import build_stages
from .tile_farm import TileFarm


class Controller:
    """``device`` is where the models run (``cuda`` unless the caller asks
    for the CPU; without a card this raises). ``model_registry`` is built
    on first use as ``ModelRegistry(device, seed=0)`` unless one is
    given. On the card the controller sets the process's fp32 precision
    (``use_full_fp32``), so every controller computes the same bits."""

    def __init__(self, config_path: Optional[Path] = None,
                 device: DeviceLike = None, model_registry=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_fp32()
            start_driver_probe()
        ensure_config_exists(config_path)
        self.config_path = config_path
        if config_path is not None:
            # outbound peer calls carry the token of this config
            set_auth_config_path(config_path)
        self.is_worker = constants.is_worker()
        self.worker_id = constants.worker_id()
        self.worker_index = constants.worker_index()
        self.output_dir = constants.output_dir()
        self.input_dir = constants.input_dir()
        self.store = JobStore()
        self.progress = ProgressTracker()
        self.queue = PromptQueue(context_factory=self._execution_context)
        self.orchestrator = Orchestrator(self.store, self.queue,
                                         config_loader=self.load_config,
                                         input_dir=Path(self.input_dir))
        self.cache = build_cache_manager()
        if self.cache is not None:
            from .cache.fleet import build_fleet_cache

            self.cache.fleet = build_fleet_cache(
                self.cache, self.worker_id or "master",
                self._fleet_membership)
        # stage-split serving: encode, denoise and decode pools for the
        # front door's batch jobs; None under CDT_STAGES=0 (fused path)
        self.stages = build_stages()
        self.queue.stages = self.stages
        self.frontdoor = build_frontdoor(self.queue, self.orchestrator,
                                         cache=self.cache,
                                         stages=self.stages)
        # resumable segments on the queue's solo lane; None under
        # CDT_PREEMPT=0 (uninterrupted runs)
        self.preemption = build_preemption(self.queue)
        self.queue.preemption = self.preemption
        self.warmup = WarmupManager(lambda: self.model_registry)
        self._warmup_task: Optional[asyncio.Future] = None
        # the elastic fleet (cluster/elastic): built at startup, since a
        # drain is a task of the serving loop
        self.elastic = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.bridge: Optional[CollectorBridge] = None
        self.tile_farm: Optional[TileFarm] = None
        self._registry = model_registry
        # the warm pass's thread, the graph thread and the warmup route
        # may all ask for the registry first: one of them builds it
        self._registry_lock = threading.Lock()
        self._worker_manager = None
        self._ready_task: Optional[asyncio.Future] = None
        # the config's settings.debug turns debug_log on (CDT_DEBUG too)
        set_debug_source(lambda: bool(peek_setting("debug", False,
                                                   config_path)))

    def load_config(self) -> dict:
        return load_config(self.config_path)

    def _fleet_membership(self) -> dict:
        """The fleet cache's members: this host (URL None: it never asks
        itself) and every configured host id → its URL. A worker's config
        lists hosts, not its master, so a worker's ring lacks the master,
        as in the JAX package. The fleet tier leaves out leaving hosts."""
        from ..utils.network import build_host_url

        members: dict = {(self.worker_id or "master"): None}
        try:
            for h in self.load_config().get("hosts", []):
                hid = str(h.get("id") or "")
                if hid and hid not in members:
                    members[hid] = build_host_url(h) or None
        except Exception:  # noqa: BLE001 — a bad config is an empty fleet
            pass
        return members

    def host_by_id(self, host_id: str) -> Optional[dict]:
        """Config host entry for a worker id (the busy-probe resolver)."""
        for h in self.load_config().get("hosts", []):
            if str(h.get("id")) == str(host_id):
                return h
        return None

    @property
    def worker_manager(self):
        """The manager of the worker processes this controller launches,
        on its device (made at first use: it restores the live PIDs the
        config persists)."""
        if self._worker_manager is None:
            from ..workers.process_manager import WorkerProcessManager

            self._worker_manager = WorkerProcessManager(self.config_path,
                                                        self.device.type)
        return self._worker_manager

    @property
    def model_registry(self):
        with self._registry_lock:
            if self._registry is None:
                from ..models.registry import ModelRegistry

                self._registry = ModelRegistry(self.device, seed=0)
            return self._registry

    def _execution_context(self) -> dict[str, Any]:
        ctx: dict[str, Any] = {
            "model_registry": self.model_registry,
            "output_dir": self.output_dir,
            "input_dir": self.input_dir,
            "is_worker": self.is_worker,
            "worker_id": self.worker_id,
            "worker_index": self.worker_index,
            "progress_tracker": self.progress,
            "content_cache": self.cache,
        }
        if self.bridge is not None:
            ctx["collector_bridge"] = self.bridge
        if self.tile_farm is not None:
            ctx["tile_farm"] = self.tile_farm
        return ctx

    # --- lifecycle ----------------------------------------------------------

    async def startup(self) -> None:
        self.loop = asyncio.get_running_loop()
        self.bridge = CollectorBridge(self.store, self.loop,
                                      host_resolver=self.host_by_id)
        self.tile_farm = TileFarm(self.store, self.loop)
        if self.cache is not None and self.cache.fleet is not None:
            # probes and fills cross from worker threads onto this loop
            self.cache.fleet.attach_loop(self.loop)
        self.queue.start()
        if self.frontdoor is not None:
            self.frontdoor.start()
        from .elastic import build_elastic

        self.elastic = build_elastic(self)
        self.elastic.start()
        role = "worker" if self.is_worker else "master"
        log(f"controller up as {role} on {self.device} "
            f"(machine {get_machine_id()})")
        if self.is_worker and self.worker_id:
            self._ready_task = asyncio.ensure_future(self._report_ready())
        if constants.warmup():
            self.start_warmup()

    def start_warmup(self, models=None) -> None:
        """A warm pass in a thread of its own (not the graph thread: a
        dispatched prompt must not wait behind the catalog); the health
        probe says ``warming`` until it ends."""
        self._warmup_task = asyncio.get_running_loop().run_in_executor(
            None, lambda: self.warmup.run(models=models))

    async def _report_ready(self) -> None:
        """Tell the master that launched this worker that it is up: the
        master clears the worker's ``launching`` flag. A worker started by
        hand (no ``CDT_MASTER_PORT``) reports nothing."""
        port = constants.master_port()
        if not port:
            return
        url = f"http://127.0.0.1:{port}/distributed/worker/clear_launching"
        try:
            await http_request_async(
                url, json.dumps({"worker_id": self.worker_id}).encode(),
                {"Content-Type": "application/json"},
                timeout=constants.probe_timeout())
        except OSError:
            pass                      # the master is gone

    async def shutdown(self) -> None:
        if self.elastic is not None:
            await self.elastic.stop()
        if self.frontdoor is not None:
            await self.frontdoor.stop()
        if self.stages is not None:
            # before the queue: leftover items record their members
            # interrupted through the queue's callbacks; the joins block,
            # so they run off the loop
            await asyncio.get_running_loop().run_in_executor(
                None, self.stages.stop)
        await self.queue.stop()
        if self.cache is not None and self.cache.fleet is not None:
            self.cache.fleet.close()   # off the drain feed
        self.progress.close()       # release the process-wide progress sink
        # the queue's context factory, the orchestrator and the bridge hold
        # bound methods of this controller, so it lives until the cycle
        # collector runs: let go of the card's bundles now
        self._drop_models()

    # --- health and info ----------------------------------------------------

    def health(self) -> dict:
        return {
            "status": "ok",
            "role": "worker" if self.is_worker else "master",
            "queue_remaining": self.queue.queue_remaining,
            "executing": self.queue.executing,
            "machine_id": get_machine_id(),
            "device": str(self.device),
            # cold | warming | ready | error: dispatch prefers a host that
            # is not warming (cluster/dispatch.py)
            "warmup": self.warmup.state,
            # what admission sheds on: queued depth and the coalescing
            # window's members
            "frontdoor": (None if self.frontdoor is None
                          else {"depth": self.frontdoor.depth(),
                                "coalescing":
                                    self.frontdoor.batcher.pending_count}),
            # the result tier's recent hit rate and the fleet ring's size
            "cache": (None if self.cache is None
                      else {"hit_rate": round(self.cache.hit_rate(), 4),
                            "fleet_ring": (len(self.cache.fleet.ring()[0])
                                           if self.cache.fleet is not None
                                           else 0)}),
            # each stage pool's backlog (cluster/stages)
            "stages": (None if self.stages is None
                       else self.stages.depths()),
        }

    def system_info_no_devices(self) -> dict:
        """Host facts that never touch a device: the degraded payload of
        ``/distributed/system_info`` when the driver does not answer
        (``utils/deadline.py``)."""
        return {
            "machine_id": get_machine_id(),
            "platform": platform.system().lower(),
            "path_separator": os.sep,
            "python": platform.python_version(),
            "is_docker": is_docker(),
            "environment": detect_environment(),
            "torch": torch.__version__,
            "device": str(self.device),
        }

    def system_info(self) -> dict:
        """Host facts and a census of the CUDA devices, which adds the
        first card's name and the driver's version to ``environment``."""
        info = self.system_info_no_devices()
        info["devices"] = []
        if torch.cuda.is_available():
            info["cuda"] = torch.version.cuda
            info["environment"]["cuda"].update(
                device_name=torch.cuda.get_device_name(0),
                driver_version=driver_version())
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                name = torch.cuda.get_device_name(i)
                info["devices"].append({
                    "index": i, "name": name, "kind": name,
                    "total_memory": props.total_memory,
                    "memory_allocated": torch.cuda.memory_allocated(i),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(i),
                    "memory_reserved": torch.cuda.memory_reserved(i),
                })
        return info

    def _drop_models(self) -> None:
        """Let go of the registry and of the ``LoraLoader`` merges, which
        pin their base bundles (a class-level cache, shared by every
        controller of the process)."""
        from ..graph.nodes_builtin import LoraLoader

        self._registry = None
        LoraLoader._cache.clear()

    def clear_memory(self) -> dict:
        """Drop the model registry (its bundles go with it) and the
        LoRA merges, and return the card's cached blocks to CUDA. The
        next prompt builds its bundles again."""
        self._drop_models()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"status": "cleared"}
