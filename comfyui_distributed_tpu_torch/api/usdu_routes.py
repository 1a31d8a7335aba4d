"""The tile farm's routes (the JAX package's ``api/usdu_routes.py``) on the
port's router: heartbeats, pull-based work assignment, tile and image
result ingest, status.

- ``POST /distributed/heartbeat``, ``POST /distributed/request_image``,
  ``POST /distributed/handback``: JSON ``{"job_id", "worker_id"}``.
  ``request_image`` with ``job_id`` ``"*"`` is the elastic fleet's
  cross-job steal pull (``exclude_jobs``: at most 256 job ids the puller
  cannot serve); a worker that is leaving is answered ``{"task": null,
  "draining": true}``;
- ``POST /distributed/submit_tiles``: multipart, a ``tiles_metadata``
  JSON part and ``tile_<i>`` parts, CDTF frames
  (``application/x-cdt-frame``) or PNG; a frame larger than one POST
  arrives in byte ranges (``frame_parts``) and is joined here;
- ``POST /distributed/submit_image``: JSON with a base64 PNG (dynamic
  mode);
- ``GET /distributed/job_status?job_id=…`` (a tile job, or a prompt of
  the queue: its status, ``preempted@k/n`` while it is parked), ``GET
  /distributed/queue_status/{job_id}``.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any

import numpy as np

from .. import telemetry
from ..cluster.elastic.states import DRAIN
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.exceptions import ValidationError
from ..utils.frames import unpack_frame
from ..utils.image import decode_image_b64, decode_png
from ..utils.logging import debug_log
from ..utils.multipart import parse_multipart
from .schemas import require_fields, validate_worker_id

MAX_FRAME_PARTS = 64
MAX_EXCLUDE_JOBS = 256


def parse_index(value: Any, field: str) -> int:
    """A non-negative integer field."""
    try:
        out = int(value)
    except (TypeError, ValueError):
        raise ValidationError(f"{field} must be an integer", field=field) from None
    if out < 0:
        raise ValidationError(f"{field} must be non-negative", field=field)
    return out


def register(app, controller) -> None:
    from .app import Response

    store = controller.store
    # byte ranges of oversized frames: (job_id, worker_id, task_id) →
    # {part_index: bytes}; entries older than 4× the heartbeat timeout
    # are dropped on every submit
    partial_frames: dict[tuple, dict[int, bytes]] = {}
    partial_seen: dict[tuple, float] = {}

    def prune_partials() -> None:
        horizon = time.monotonic() - constants.heartbeat_timeout() * 4
        for key in [k for k, ts in partial_seen.items() if ts < horizon]:
            partial_frames.pop(key, None)
            partial_seen.pop(key, None)

    async def off_loop(fn, *args):
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    async def heartbeat(request):
        body = request.json()
        require_fields(body, "job_id", "worker_id")
        ok = await store.heartbeat(body["job_id"],
                                   validate_worker_id(body["worker_id"]))
        return Response(200, {"status": "ok" if ok else "unknown_job"})

    async def request_image(request):
        """A pull of one task: of the named job, or of any open job
        (``job_id="*"``, the steal scheduler's pick; the grant carries its
        ``job_id``). A leaving worker is refused without touching a queue:
        it must stop pulling and flush, and the refusal is not an empty
        queue."""
        body = request.json()
        require_fields(body, "job_id", "worker_id")
        worker_id = validate_worker_id(body["worker_id"])
        if DRAIN.is_leaving(worker_id):
            debug_log(f"tile-farm: refusing work to draining worker {worker_id}")
            return Response(200, {"task": None, "draining": True})
        stolen = body["job_id"] == "*"
        if stolen:
            exclude = body.get("exclude_jobs") or []
            if (not isinstance(exclude, list)
                    or len(exclude) > MAX_EXCLUDE_JOBS
                    or not all(isinstance(j, str) for j in exclude)):
                raise ValidationError(
                    f"'exclude_jobs' must be a list of at most "
                    f"{MAX_EXCLUDE_JOBS} job id strings", field="exclude_jobs")
            task = await store.request_any_work(worker_id, exclude=exclude)
        else:
            task = await store.request_work(body["job_id"], worker_id)
        if task is not None and telemetry.enabled():
            _tm.STEAL_ASSIGNMENTS.labels(
                kind="stolen" if stolen else "own_job").inc()
        return Response(200, {"task": task})

    async def submit_tiles(request):
        parts = parse_multipart(request.body,
                                request.headers.get("content-type", ""))
        metadata = None
        raw_parts: dict[str, tuple[bytes, str]] = {}
        for part in parts:
            if part.name == "tiles_metadata":
                try:
                    metadata = json.loads(part.data)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    raise ValidationError("tiles_metadata must be valid JSON") from None
            elif part.name.startswith("tile_"):
                raw_parts[part.name] = (part.data, part.content_type)
        if metadata is None:
            raise ValidationError("missing tiles_metadata part")
        require_fields(metadata, "job_id", "worker_id")
        job_id = metadata["job_id"]
        worker_id = validate_worker_id(metadata["worker_id"])

        fp = metadata.get("frame_parts")
        if fp:
            if not isinstance(fp, dict):
                raise ValidationError("frame_parts must be an object")
            task_id = parse_index(fp.get("task_id"), "task_id")
            idx = parse_index(fp.get("part_index"), "part_index")
            count = parse_index(fp.get("part_count"), "part_count")
            if count < 1 or count > MAX_FRAME_PARTS or idx >= count:
                raise ValidationError(f"invalid frame_parts {idx}/{count} "
                                      f"(max {MAX_FRAME_PARTS})")
            if len(raw_parts) != 1:
                raise ValidationError(
                    "a frame_parts submit carries exactly one body part")
            prune_partials()
            key = (job_id, worker_id, task_id)
            buf = partial_frames.setdefault(key, {})
            buf[idx] = next(iter(raw_parts.values()))[0]
            partial_seen[key] = time.monotonic()
            if len(buf) < count:
                return Response(200, {"status": "ok", "buffered": idx})
            data = b"".join(buf[i] for i in range(count))
            partial_frames.pop(key, None)
            partial_seen.pop(key, None)
            try:
                arr = await off_loop(unpack_frame, data)
            except ValueError as e:
                raise ValidationError(f"reassembled frame: {e}") from None
            ok = await store.submit_result(job_id, worker_id, task_id,
                                           {"image": arr})
            return Response(200, {"status": "ok", "accepted": int(ok)})

        tiles: dict[str, np.ndarray] = {}
        for name, (raw, ctype) in raw_parts.items():
            try:
                tiles[name] = await off_loop(
                    unpack_frame if ctype == "application/x-cdt-frame"
                    else decode_png, raw)
            except ValueError as e:
                raise ValidationError(f"{name}: {e}") from None
        entries = metadata.get("tiles", [])
        if not isinstance(entries, list):
            raise ValidationError("tiles must be a list")
        accepted = 0
        for entry in entries:
            if not isinstance(entry, dict):
                raise ValidationError("each tiles entry must be an object")
            task_id = parse_index(entry.get("task_id"), "task_id")
            key = entry.get("part", f"tile_{task_id}")
            if key not in tiles:
                raise ValidationError(f"missing tile part {key!r}")
            payload = {"image": tiles[key],
                       **{k: v for k, v in entry.items() if k != "part"}}
            if await store.submit_result(job_id, worker_id, task_id, payload):
                accepted += 1
        return Response(200, {"status": "ok", "accepted": accepted})

    async def submit_image(request):
        body = request.json()
        require_fields(body, "job_id", "worker_id")
        task_id = parse_index(body.get("task_id"), "task_id")
        image = await off_loop(decode_image_b64, body.get("image", ""))
        ok = await store.submit_result(
            body["job_id"], validate_worker_id(body["worker_id"]), task_id,
            {"image": image[None]})
        return Response(200, {"status": "ok", "accepted": int(ok)})

    async def handback(request):
        """A worker returns work it cannot or may no longer serve (a steal
        grant of a job it lacks, a drain's flush): requeued as a planned
        departure, with no poison-bound count and no breaker evidence."""
        body = request.json()
        require_fields(body, "job_id", "worker_id")
        requeued = await store.requeue_worker_tasks(
            body["job_id"], validate_worker_id(body["worker_id"]),
            count_requeue=False)
        return Response(200, {"status": "ok", "requeued": requeued})

    async def job_status(request):
        job_id = request.query.get("job_id", "")
        if not job_id:
            raise ValidationError("missing job_id query param", field="job_id")
        status = await store.job_status(job_id)
        if not status.get("exists") and not status.get("finished"):
            # maybe a prompt of the queue: a preempted one reports where
            # it is parked, e.g. "preempted@8/30"
            entry = controller.queue.history.get(job_id)
            if entry is not None:
                status = {"exists": True, "kind": "prompt",
                          "status": entry.get("status")}
                if entry.get("status") == "preempted":
                    status["preempted"] = (
                        f"preempted@{entry.get('preempted_at_step')}"
                        f"/{entry.get('total_steps')}")
                    status["checkpoint_id"] = entry.get("checkpoint_id")
                    status["reason"] = entry.get("reason")
                elif entry.get("preemptions"):
                    status["preemptions"] = entry["preemptions"]
        return Response(200, status)

    async def queue_status(request):
        return Response(200, await store.job_status(request.match["job_id"]))

    app.add("POST", "/distributed/heartbeat", heartbeat)
    app.add("POST", "/distributed/request_image", request_image)
    app.add("POST", "/distributed/submit_tiles", submit_tiles)
    app.add("POST", "/distributed/submit_image", submit_image)
    app.add("POST", "/distributed/handback", handback)
    app.add("GET", "/distributed/job_status", job_status)
    app.add("GET", "/distributed/queue_status/{job_id}", queue_status)
