"""Cross-host tile farm: a pull queue of tile work between a master and
its workers over the HTTP control plane (the port's copy of the JAX
package's ``cluster/tile_farm.py``).

- master (``master_run``): seeds the pull queue, processes tasks itself
  while draining worker results, runs the heartbeat-timeout requeue
  every ``CDT_HEARTBEAT_INTERVAL`` and takes over whatever comes back
  from a dead worker, so a job completes as long as the master lives;
- worker (``worker_run``): polls until the job exists, pulls task
  ranges, runs them through its own copy of the plan, heartbeats after
  each task and submits results in size-capped multipart batches of
  CDTF frames (float32, crc-checked: no precision is lost), with
  retries. A ``draining: true`` answer (the master drains this worker,
  ``cluster/elastic``) ends the pulls at once; what it holds is flushed;
- steal worker (``worker_steal_run``): the elastic fleet's arrival. It
  pulls with ``job_id="*"`` from whichever open job the master's steal
  scheduler picks, resolves each grant's job to a process function,
  hands back a grant it cannot serve, sends each result to its grant's
  job and heartbeats every job it still holds work of.

Task ranges are global tile indices and each tile's noise follows its
global index (``tiles/engine.py``), so any host can process any range
and a requeue, a handback or a steal changes no pixel. HTTP goes
through ``urllib`` in the loop's executor (``utils/network.py``).
"""

from __future__ import annotations

import asyncio
import json
import shutil
import time
import urllib.parse
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .. import telemetry
from ..utils import constants
from ..utils.async_helpers import run_in_loop
from ..utils.exceptions import TileCollectionError, WorkerError
from ..utils.frames import pack_frame, unpack_frame
from ..utils.logging import debug_log, log
from ..utils.multipart import Part, build_multipart
from ..utils.network import http_request_async, normalize_host_url
from .job_store import JobStore
from .job_timeout import check_and_requeue_timed_out_workers
from .resilience import send_policy, work_request_policy

ProcessFn = Callable[[int, int], np.ndarray]      # (start, end) -> [n, ...]
READY_POLL_INTERVAL_S = 1.0

_SAFE = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.")


def _sanitize_name(name: str, max_len: int = 120, fallback: str = "job") -> str:
    """One safe path component: characters outside [alnum-_.] become '_',
    the length is capped, and an empty or dot-only name is ``fallback``."""
    out = "".join(c if c in _SAFE else "_" for c in str(name))[:max_len]
    return fallback if not out or set(out) <= {"."} else out


class TileJournal:
    """Disk journal of completed tile tasks, for crash resume: one CDTF
    frame file per task, written atomically (tmp + rename). A restarted
    master preloads them and computes only the rest.

    The key must be stable across restarts (a content hash of the job's
    inputs: a re-submitted workflow gets a new job id). Sibling journals
    older than ``TTL_S`` are pruned on open."""

    TTL_S = 7 * 24 * 3600.0

    def __init__(self, root, key: str):
        root = Path(root)
        self.dir = root / _sanitize_name(key)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.disabled = False
        horizon = time.time() - self.TTL_S
        for sib in root.iterdir():
            try:
                if sib.is_dir() and sib != self.dir and sib.stat().st_mtime < horizon:
                    shutil.rmtree(sib, ignore_errors=True)
            except OSError:
                pass

    def write(self, task_id: int, arr: np.ndarray) -> None:
        """Best effort: on a write failure the journal disables itself and
        the job runs on unjournaled."""
        if self.disabled:
            return
        out = self.dir / f"task_{task_id}.cdtf"
        if out.exists():
            return
        try:
            tmp = self.dir / f".task_{task_id}.tmp"
            tmp.write_bytes(pack_frame(np.asarray(arr, np.float32), level=1))
            tmp.rename(out)
        except OSError as e:
            log(f"journal: write failed ({e}); disabling journal for this run")
            self.disabled = True

    def load(self) -> dict[int, np.ndarray]:
        out: dict[int, np.ndarray] = {}
        for f in sorted(self.dir.glob("task_*.cdtf")):
            try:
                out[int(f.stem.split("_", 1)[1])] = unpack_frame(f.read_bytes())
            except (ValueError, OSError) as e:
                log(f"journal: skipping corrupt entry {f.name} ({e})")
        return out

    def clear(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class TileFarm:
    """Bound to a controller's store and event loop; graph nodes call the
    blocking wrappers from the execution thread, which wait on a
    coroutine of the loop (as ``CollectorBridge`` does)."""

    def __init__(self, store: JobStore, loop: asyncio.AbstractEventLoop):
        self.store = store
        self.loop = loop

    # --- blocking wrappers (node-facing) ----------------------------------------

    def master_run(self, job_id: str, total: int, process_fn: ProcessFn,
                   chunk: int = 1, **kw) -> dict[int, np.ndarray]:
        return run_in_loop(
            self.master_run_async(job_id, total, process_fn, chunk, **kw),
            self.loop, timeout=None)

    def worker_run(self, job_id: str, worker_id: str, master_url: str,
                   process_fn: ProcessFn, **kw) -> int:
        return run_in_loop(
            self.worker_run_async(job_id, worker_id, master_url, process_fn,
                                  **kw),
            self.loop, timeout=None)

    def worker_steal_run(self, worker_id: str, master_url: str,
                         resolve_fn: Callable[[str], Optional[ProcessFn]],
                         **kw) -> dict[str, int]:
        return run_in_loop(
            self.worker_steal_run_async(worker_id, master_url, resolve_fn,
                                        **kw),
            self.loop, timeout=None)

    # --- master role -----------------------------------------------------------

    async def master_run_async(self, job_id: str, total: int,
                               process_fn: ProcessFn, chunk: int = 1,
                               **kw) -> dict[int, np.ndarray]:
        """``_master_run`` under a ``tile_job.master`` span, so
        ``/distributed/trace/{job_id}`` shows where the job's time went."""
        with telemetry.span("tile_job.master", job_id=job_id, tiles=total,
                            chunk=chunk):
            return await self._master_run(job_id, total, process_fn, chunk,
                                          **kw)

    async def _master_run(
        self, job_id: str, total: int, process_fn: ProcessFn, chunk: int = 1,
        heartbeat_interval: float | None = None,
        worker_timeout: float | None = None,
        journal_dir=None,
        journal_key: str | None = None,
    ) -> dict[int, np.ndarray]:
        """Drive a tile job to completion; returns {task_id: array} of the
        completed tasks (dead-lettered ones are absent).

        The master pulls from the same queue as its workers, so it takes
        over everything requeued from a dead worker. The master's own
        tasks run in a thread of the loop's executor, so the loop goes on
        serving the workers meanwhile."""
        heartbeat_interval = (constants.heartbeat_interval()
                              if heartbeat_interval is None else heartbeat_interval)
        job = await self.store.init_tile_job(job_id, total, chunk=chunk)
        journal = None
        if journal_dir:
            journal = await asyncio.to_thread(TileJournal, journal_dir,
                                              journal_key or job_id)
            restored = 0
            for tid, arr in (await asyncio.to_thread(journal.load)).items():
                if await self.store.restore_completed(job_id, tid,
                                                      {"image": arr}):
                    restored += 1
            if restored:
                log(f"tile-farm[{job_id}] resumed {restored} tasks from journal")
        last_check = time.monotonic()
        log(f"tile-farm[{job_id}] master: {job.total_tasks} tasks "
            f"(chunk {chunk}, {total} tiles)")
        # CDT_TILE_MASTER_HOLDBACK_S: until a worker's first pull, or the
        # window's end, the master only drains results
        holdback_s = constants.tile_master_holdback_s()
        holdback_until = time.monotonic() + holdback_s if holdback_s else 0.0

        while True:
            async with self.store.lock:
                done = job.is_complete()
                if holdback_until and any(w != "master" for w in job.worker_status):
                    holdback_until = 0.0       # a worker pulled: master joins
            if done:
                break

            if holdback_until and time.monotonic() < holdback_until:
                task = None
            else:
                task = await self.store.request_work(job_id, "master")
            if task is not None:
                try:
                    arr = await asyncio.to_thread(process_fn, task["start"],
                                                  task["end"])
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — bounded requeue decides
                    live = await self.store.record_task_failure(
                        job_id, "master", task["task_id"], repr(e))
                    log(f"tile-farm[{job_id}] task {task['task_id']} failed "
                        f"on master ({e!r}); "
                        f"{'requeued' if live else 'dead-lettered'}")
                    continue
                await self.store.submit_result(job_id, "master",
                                               task["task_id"], {"image": arr})
                if journal:
                    await asyncio.to_thread(journal.write, task["task_id"], arr)
            else:
                # queue momentarily empty: wait for worker results
                try:
                    tid, payload = await asyncio.wait_for(
                        job.results.get(),
                        timeout=min(constants.collect_poll_timeout(),
                                    heartbeat_interval))
                    if journal:
                        await asyncio.to_thread(journal.write, tid,
                                                payload["image"])
                except asyncio.TimeoutError:
                    pass

            if time.monotonic() - last_check >= heartbeat_interval:
                evicted = await check_and_requeue_timed_out_workers(
                    self.store, job_id, timeout=worker_timeout)
                for w, tasks in evicted.items():
                    log(f"tile-farm[{job_id}] requeued {len(tasks)} tasks "
                        f"from silent worker {w}")
                last_check = time.monotonic()

        async with self.store.lock:
            results = {tid: payload["image"]
                       for tid, payload in job.completed.items()}
            dead = sorted(job.dead_letter)
            owners = sorted(job.completed_by.items())
        if dead:
            log(f"tile-farm[{job_id}] finished with dead-lettered tasks {dead}")
        await self.store.cleanup_job(job_id)
        if journal:
            journal.clear()
        log(f"tile-farm[{job_id}] complete ({len(results)} tasks; "
            f"task → host {owners})")
        return results

    # --- worker role -----------------------------------------------------------

    async def worker_run_async(self, job_id: str, worker_id: str,
                               master_url: str, process_fn: ProcessFn) -> int:
        with telemetry.span("tile_job.worker", job_id=job_id,
                            worker_id=worker_id):
            return await self._worker_run(job_id, worker_id, master_url,
                                          process_fn)

    async def _worker_run(self, job_id: str, worker_id: str,
                          master_url: str, process_fn: ProcessFn) -> int:
        """Pull, process, submit until the queue is drained; returns the
        number of tasks this worker completed. ``CDT_TILE_READY_POLLS``
        polls (one a second) cover a master that reaches the tile node
        after its own model builds; results go back ``CDT_MAX_BATCH``
        tasks a flush."""
        max_batch = constants.max_batch()
        base = normalize_host_url(master_url)
        if not await self._poll_job_ready(base, job_id):
            log(f"tile-farm[{job_id}] worker {worker_id}: job never appeared")
            return 0
        pending: list[tuple[int, dict, np.ndarray]] = []
        completed = 0
        while True:
            task, draining = await self._request_work(base, job_id, worker_id)
            if task is None:
                if draining:
                    log(f"tile-farm[{job_id}] worker {worker_id} is draining: "
                        "flushing and leaving")
                break
            arr = await asyncio.to_thread(process_fn, task["start"], task["end"])
            meta = {"task_id": task["task_id"], "start": task["start"],
                    "end": task["end"]}
            pending.append((task["task_id"], meta, arr))
            completed += 1
            await self._heartbeat(base, job_id, worker_id)
            if len(pending) >= max_batch:
                await self._flush(base, job_id, worker_id, pending)
                pending = []
        if pending:
            await self._flush(base, job_id, worker_id, pending)
        log(f"tile-farm[{job_id}] worker {worker_id}: {completed} tasks done")
        return completed

    # --- steal worker role (cluster/elastic/scheduler.py) ----------------------

    async def worker_steal_run_async(
        self, worker_id: str, master_url: str,
        resolve_fn: Callable[[str], Optional[ProcessFn]],
        max_batch: int | None = None, idle_polls: int = 3,
        idle_interval: float = 0.5,
    ) -> dict[str, int]:
        """Pull from any open job (``job_id="*"``), run each grant with
        ``resolve_fn(job_id)`` (None: a job this worker cannot serve; the
        grant goes straight back) and send its results to its own job;
        returns {job_id: tasks completed}. This is what a worker that just
        arrived runs: it serves whichever open job is most starved, not
        the next dispatch. The loop ends after ``idle_polls`` empty pulls
        in a row, or at once when the master marks it draining."""
        with telemetry.span("tile_job.steal_worker", worker_id=worker_id):
            return await self._worker_steal(
                worker_id, master_url, resolve_fn,
                constants.max_batch() if max_batch is None else max_batch,
                idle_polls, idle_interval)

    async def _worker_steal(
        self, worker_id: str, master_url: str,
        resolve_fn: Callable[[str], Optional[ProcessFn]], max_batch: int,
        idle_polls: int, idle_interval: float,
    ) -> dict[str, int]:
        base = normalize_host_url(master_url)
        completed: dict[str, int] = {}
        # a flush buffer a job: results go to their own job
        pending: dict[str, list[tuple[int, dict, np.ndarray]]] = {}
        unservable: set[str] = set()

        async def flush_all() -> None:
            for jid, batch in pending.items():
                if batch:
                    await self._flush(base, jid, worker_id, batch)
                    pending[jid] = []

        idle = 0
        while idle < idle_polls:
            task, draining = await self._request_work(
                base, "*", worker_id,
                extra={"exclude_jobs": sorted(unservable)}
                if unservable else None)
            if draining:
                # asked to leave: stop pulling now; what is buffered is
                # flushed below, so a clean drain loses nothing
                log(f"steal[{worker_id}] is draining: flushing and leaving")
                break
            if task is None:
                idle += 1
                # a buffered result is still assigned on the master and
                # would be handed back if this worker drained while idle
                await flush_all()
                await asyncio.sleep(idle_interval)
                continue
            jid = task.get("job_id", "")
            fn = resolve_fn(jid)
            if fn is None:
                # a job this worker cannot serve: give the grant back. A
                # grant of a job known to be unservable counts as an idle
                # poll, so the loop winds down when only such jobs are open
                debug_log(f"steal[{worker_id}] cannot serve job {jid}; "
                          "handing the task back")
                await self._handback_task(base, jid, worker_id)
                if jid in unservable:
                    idle += 1
                    await asyncio.sleep(idle_interval)
                else:
                    unservable.add(jid)
                continue
            idle = 0
            arr = await asyncio.to_thread(fn, task["start"], task["end"])
            meta = {"task_id": task["task_id"], "start": task["start"],
                    "end": task["end"]}
            pending.setdefault(jid, []).append((task["task_id"], meta, arr))
            completed[jid] = completed.get(jid, 0) + 1
            # heartbeat every job it holds unflushed work of: a job whose
            # monitor stopped hearing from it would evict it through the
            # failure path (breaker trip, counted requeue)
            for held in sorted({jid, *(j for j, b in pending.items() if b)}):
                await self._heartbeat(base, held, worker_id)
            if len(pending[jid]) >= max_batch:
                await self._flush(base, jid, worker_id, pending[jid])
                pending[jid] = []
        await flush_all()
        log(f"steal[{worker_id}] done: {completed}")
        return completed

    async def _handback_task(self, base: str, job_id: str,
                             worker_id: str) -> None:
        """Give back a grant it cannot serve (a planned departure's
        accounting: no failure evidence)."""
        try:
            await self._post_json(f"{base}/distributed/handback",
                                  {"job_id": job_id, "worker_id": worker_id})
        except OSError:
            pass   # the heartbeat monitor requeues it in the end

    # --- wire helpers ----------------------------------------------------------

    @staticmethod
    async def _post_json(url: str, payload: dict) -> tuple[int, bytes]:
        return await http_request_async(url, json.dumps(payload).encode(),
                                        {"Content-Type": "application/json"})

    async def _poll_job_ready(self, base: str, job_id: str) -> bool:
        """True once the master holds the TILE job: orchestration creates a
        collector job under the same id before the master's node seeds
        the tile queue, and a worker that pulled then would read the
        empty answer as a drained queue and leave. False at once when the
        job has finished already (the master ran every task)."""
        url = (f"{base}/distributed/job_status?"
               + urllib.parse.urlencode({"job_id": job_id}))
        for _ in range(constants.tile_ready_polls()):
            try:
                status, body = await http_request_async(url)
                if status < 400:
                    answer = json.loads(body)
                    if answer.get("exists") and answer.get("kind") != "collector":
                        return True
                    if answer.get("finished"):
                        return False
            except (OSError, ValueError):
                pass
            await asyncio.sleep(READY_POLL_INTERVAL_S)
        return False

    async def _request_work(self, base: str, job_id: str, worker_id: str,
                            extra: Optional[dict] = None
                            ) -> tuple[Optional[dict], bool]:
        """A ``CDT_WORK_REQUEST_BUDGET``-bounded pull that tolerates 4xx
        and 5xx answers (a master mid-restart, a job not seeded yet).
        Returns ``(task, draining)``: ``(None, False)`` once the queue is
        drained or the budget is spent; ``draining`` means this worker was
        asked to leave (a refusal, not an empty queue, and it spends no
        retry). ``job_id`` ``"*"`` asks the steal scheduler; ``extra``
        joins the body (the steal loop's ``exclude_jobs``)."""
        async def attempt() -> tuple[Optional[dict], bool]:
            status, body = await self._post_json(
                f"{base}/distributed/request_image",
                {"job_id": job_id, "worker_id": worker_id, **(extra or {})})
            if status >= 400:
                err = WorkerError(f"work request {status}", worker_id=worker_id)
                err.retry_safe = True
                raise err
            answer = json.loads(body)
            return answer.get("task"), bool(answer.get("draining"))

        try:
            return await work_request_policy().run(attempt, op="request_work")
        except (OSError, asyncio.TimeoutError, WorkerError, ValueError) as e:
            log(f"tile-farm[{job_id}] work request budget exhausted ({e}); "
                "treating the queue as drained")
            return None, False

    async def _heartbeat(self, base: str, job_id: str, worker_id: str) -> None:
        try:
            await self._post_json(f"{base}/distributed/heartbeat",
                                  {"job_id": job_id, "worker_id": worker_id})
        except OSError:
            pass   # a lost heartbeat is what the timeout monitor detects

    async def _flush(self, base: str, job_id: str, worker_id: str,
                     batch: list[tuple[int, dict, np.ndarray]]) -> None:
        """Submit results in POSTs of at most the payload cap (less 1 MB
        for the multipart framing), at least one frame each. A frame
        larger than the cap (dynamic mode ships whole images) is split
        into byte ranges over several POSTs; the master joins them."""
        cap = max(constants.max_payload_size() - (1 << 20),
                  constants.max_payload_size() // 2, 1)
        loop = asyncio.get_running_loop()
        group: list[tuple[int, dict, bytes]] = []
        size = 0
        for task_id, meta, arr in batch:
            frame = await loop.run_in_executor(
                None, lambda a=arr: pack_frame(np.asarray(a, np.float32), level=1))
            if len(frame) > cap:
                if group:
                    await self._post_tiles(base, job_id, worker_id, group)
                    group, size = [], 0
                n = -(-len(frame) // cap)
                for j in range(n):
                    await self._post_tiles(
                        base, job_id, worker_id,
                        [(task_id, {"task_id": task_id},
                          frame[j * cap:(j + 1) * cap])],
                        frame_parts={"task_id": task_id, "part_index": j,
                                     "part_count": n})
                continue
            if group and size + len(frame) > cap:
                await self._post_tiles(base, job_id, worker_id, group)
                group, size = [], 0
            group.append((task_id, meta, frame))
            size += len(frame)
        if group:
            await self._post_tiles(base, job_id, worker_id, group)

    async def _post_tiles(self, base: str, job_id: str, worker_id: str,
                          group: list[tuple[int, dict, bytes]],
                          frame_parts: dict | None = None) -> None:
        url = f"{base}/distributed/submit_tiles"
        doc = {"job_id": job_id, "worker_id": worker_id,
               "tiles": [{**meta, "part": f"tile_{tid}"}
                         for tid, meta, _ in group]}
        if frame_parts:
            doc["frame_parts"] = frame_parts
        parts = [Part("tiles_metadata", json.dumps(doc).encode(),
                      content_type="application/json")]
        parts += [Part(f"tile_{tid}", frame, f"tile_{tid}.cdtf",
                       "application/x-cdt-frame") for tid, _, frame in group]
        body, ctype = build_multipart(parts)

        async def attempt() -> None:
            status, answer = await http_request_async(
                url, body, {"Content-Type": ctype, "X-CDT-Client": "1"})
            if status >= 400:
                # the master's submit is idempotent: a re-send cannot
                # record a tile twice
                err = WorkerError(f"{status}: {answer[:200]!r}",
                                  worker_id=worker_id)
                err.retry_safe = True
                raise err

        try:
            await send_policy().run(attempt, op="submit")
        except (OSError, asyncio.TimeoutError, WorkerError) as e:
            raise WorkerError(
                f"tile submit to {url} failed after retries: {e}") from e


def assemble_tiles(results: dict[int, np.ndarray], total: int, chunk: int, *,
                   fallback_fn: Optional[ProcessFn] = None) -> np.ndarray:
    """{task_id: [n, ch, cw, C]} → ordered [total, ch, cw, C].

    ``master_run`` returns only completed tasks. With ``fallback_fn(start,
    end)`` the dead-lettered ranges are filled from a degraded source
    (the plain-resized crops, no diffusion), so one poison tile costs one
    unrefined region instead of the job; without it they raise a
    ``TileCollectionError`` naming them."""
    n_tasks = -(-total // chunk)
    filled = dict(results)
    missing = [tid for tid in range(n_tasks) if tid not in filled]
    if missing and fallback_fn is not None:
        for tid in missing:
            filled[tid] = fallback_fn(tid * chunk, min((tid + 1) * chunk, total))
        log(f"assemble: filled {len(missing)} dead-lettered task(s) "
            f"{missing} from the degraded fallback")
    elif missing:
        raise TileCollectionError(
            f"tile tasks {missing} missing from results (dead-lettered? "
            "see the job's dead_letter list in /distributed/job_status)")
    parts = [np.asarray(filled[tid], np.float32) for tid in sorted(filled)]
    out = np.concatenate(parts, axis=0)
    if out.shape[0] < total:
        raise TileCollectionError(f"assembled {out.shape[0]} tiles, expected {total}")
    return out[:total]
