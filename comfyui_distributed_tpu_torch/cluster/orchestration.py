"""The orchestration behind ``POST /distributed/queue`` (the JAX
package's ``cluster/orchestration.py``): resolve the candidate hosts →
probe them (bounded) → optionally keep the least busy one → job-id map →
create the collector queues → prepare and dispatch each worker's prompt
(bounded) → queue the master's own prompt.

Before a ``remote`` host's dispatch, the media files its prompt reads
are synced to it (``cluster/media_sync.py``): a failed upload fails that
host's dispatch, a file missing here is left to the host. Dispatch goes
over each worker's WebSocket when ``settings.websocket_orchestration``
is on (``cluster/dispatch.py``). A
delegate-only master computes after all when no worker is online, or
when every dispatch failed. A worker whose dispatch failed is dropped
from the collector's expected set, so the master never waits on it.
"""

from __future__ import annotations

import asyncio
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from .. import telemetry
from ..graph.executor import strip_meta
from ..graph.transform import (
    apply_participant_overrides,
    generate_job_id_map,
    prepare_delegate_master_prompt,
    prune_prompt_for_worker,
)
from ..utils import constants
from ..utils.config import load_config
from ..utils.exceptions import WorkerError
from ..utils.logging import new_trace_id, trace_info
from ..utils.network import build_master_callback_url
from .dispatch import dispatch_prompt, select_active_hosts, select_least_busy_host
from .job_store import JobStore
from .media_sync import sync_host_media
from .runtime import PromptQueue


@dataclasses.dataclass
class OrchestrationResult:
    prompt_id: str
    node_errors: list
    worker_count: int
    dispatched_to: list[str]
    trace_id: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Orchestrator:
    """``input_dir`` is where the media a prompt names are read from for
    the sync to remote hosts (the controller's ``CDT_INPUT_DIR``)."""

    def __init__(self, store: JobStore, queue: PromptQueue,
                 config_loader=load_config,
                 input_dir: Optional[Path] = None):
        self.store = store
        self.queue = queue
        self.load_config = config_loader
        self.input_dir = input_dir

    @staticmethod
    def _normalized_hosts(config: dict) -> list[dict]:
        """The full config host list, each with a unique ``id``
        (``host{position}`` where none is given, skipping names an
        explicit id already claims)."""
        hosts = config.get("hosts", [])
        taken = {h.get("id") for h in hosts if h.get("id")}
        out = []
        for i, h in enumerate(hosts):
            if h.get("id"):
                out.append(h)
                continue
            name = f"host{i}"
            while name in taken:
                name += "_"
            taken.add(name)
            out.append({**h, "id": name})
        return out

    @staticmethod
    def _resolve_enabled_hosts(
        all_hosts: list[dict], enabled_ids: Optional[Sequence[str]]
    ) -> list[dict]:
        """Explicit ids win; else the hosts the config enables."""
        if enabled_ids is not None:
            by_id = {h["id"]: h for h in all_hosts}
            return [by_id[i] for i in enabled_ids if i in by_id]
        return [h for h in all_hosts if h.get("enabled")]

    async def orchestrate(
        self,
        prompt: dict,
        client_id: str = "",
        enabled_ids: Optional[Sequence[str]] = None,
        delegate_master: Optional[bool] = None,
        load_balance: bool = False,
        trace_id: str | None = None,
        queue_meta: Optional[dict] = None,
    ) -> OrchestrationResult:
        """``queue_meta`` (the front door's tenant, priority and
        ``deadline_at``) rides into the master's queue job."""
        prompt = strip_meta(prompt)
        trace_id = trace_id or new_trace_id()
        # the orchestration id is the trace id: probe and dispatch spans
        # open under this one, and the workers join it by X-CDT-Trace
        with telemetry.span("orchestrate", trace_id=trace_id, job_id=trace_id):
            return await self._orchestrate(prompt, client_id, enabled_ids,
                                           delegate_master, load_balance,
                                           trace_id, queue_meta or {})

    async def _orchestrate(self, prompt: dict, client_id: str,
                           enabled_ids: Optional[Sequence[str]],
                           delegate_master: Optional[bool],
                           load_balance: bool,
                           trace_id: str,
                           queue_meta: dict) -> OrchestrationResult:
        config = self.load_config()
        settings = config.get("settings", {})
        all_hosts = self._normalized_hosts(config)
        candidates = self._resolve_enabled_hosts(all_hosts, enabled_ids)
        if delegate_master is None:
            delegate_master = bool(settings.get("master_delegate_only"))
        trace_info(trace_id, f"orchestrating over {len(candidates)} candidate hosts "
                             f"(delegate={delegate_master})")

        online, _ = await select_active_hosts(
            candidates,
            probe_concurrency=settings.get("worker_probe_concurrency",
                                           constants.worker_probe_concurrency()),
            trace_id=trace_id,
        )
        if load_balance and online:
            chosen = select_least_busy_host(online)
            online = [chosen] if chosen else []
        if not online and delegate_master:
            trace_info(trace_id, "no online workers; delegate mode disabled")
            delegate_master = False

        job_ids = generate_job_id_map(prompt, trace_id)
        # worker_index is the host's position in the FULL config host list:
        # seed offsets and per-worker values stay with the same host
        # across outages, load-balance picks and enabled subsets
        stable_index = {h["id"]: i for i, h in enumerate(all_hosts)}
        worker_ids = tuple(h["id"] for h in online)
        for jid in job_ids.values():
            await self.store.prepare_collector_job(jid, worker_ids)

        sem = asyncio.Semaphore(settings.get("worker_prep_concurrency",
                                             constants.worker_prep_concurrency()))

        async def prep_and_dispatch(host: dict) -> tuple[str, Optional[str]]:
            async with sem:
                wid = host["id"]
                host_type = host.get("type")
                if host_type not in ("local", "remote"):
                    from ..workers.detection import classify_host
                    host_type = await classify_host(host)
                callback = build_master_callback_url(
                    config.get("master", {}), for_local=host_type == "local")
                wprompt = prune_prompt_for_worker(prompt)
                if not wprompt:
                    return wid, "nothing to dispatch (no distributed nodes)"
                wprompt = apply_participant_overrides(
                    wprompt, wid, job_ids, master_url=callback,
                    enabled_worker_ids=worker_ids,
                    worker_index=stable_index[wid],
                )
                if host_type == "remote":
                    # the host does not share this filesystem
                    wprompt, report = await sync_host_media(
                        host, wprompt, input_dir=self.input_dir,
                        concurrency=settings.get(
                            "media_sync_concurrency",
                            constants.media_sync_concurrency()),
                        timeout=settings.get(
                            "media_sync_timeout_seconds",
                            constants.media_sync_timeout()),
                        trace_id=trace_id)
                    if report.failed:
                        # without its inputs the host would fail, and the
                        # collector would wait on it for nothing
                        return wid, f"media sync failed for {report.failed}"
                try:
                    await dispatch_prompt(
                        host, wprompt, client_id,
                        extra={"trace_id": trace_id}, trace_id=trace_id,
                        via_ws=bool(settings.get("websocket_orchestration")))
                    return wid, None
                except WorkerError as e:
                    return wid, str(e)

        results = await asyncio.gather(*(prep_and_dispatch(h) for h in online))
        dispatched = tuple(wid for wid, err in results if err is None)
        failures = {wid: err for wid, err in results if err}
        if failures:
            trace_info(trace_id, f"dispatch failures: {failures}")
            for jid in job_ids.values():
                await self.store.set_expected_workers(jid, dispatched)
        if delegate_master and not dispatched:
            # the delegate prompt would run nothing: the master computes
            trace_info(trace_id, "all dispatches failed; delegate mode "
                                 "disabled — master computes locally")
            delegate_master = False

        # the master's collector waits for the workers that got the job,
        # so its prompt is written after dispatch
        master_prompt = (prepare_delegate_master_prompt(prompt)
                         if delegate_master else prompt)
        master_prompt = apply_participant_overrides(
            master_prompt, "master", job_ids,
            enabled_worker_ids=dispatched, delegate_only=delegate_master,
        )
        prompt_id, node_errors = self.queue.enqueue(master_prompt, client_id,
                                                    trace_id, **queue_meta)
        return OrchestrationResult(
            prompt_id=prompt_id,
            node_errors=node_errors,
            worker_count=len(dispatched),
            dispatched_to=list(dispatched),
            trace_id=trace_id,
        )
