"""Worker-process routes on the port's router (the JAX package's
``api/worker_routes.py``, its process-management part):

- ``POST /distributed/launch_worker`` ``{"worker_id"}``: start a
  configured host as a worker controller on the master's device (404 for
  an unknown host, 409 when it runs already or cannot start);
- ``POST /distributed/stop_worker`` ``{"worker_id"}``: stop its process
  tree (404 when it is not managed);
- ``GET /distributed/managed_workers``: pid, log, ``launching``;
- ``GET /distributed/worker_log/{worker_id}``: the tail of its log file;
- ``POST /distributed/worker/clear_launching`` ``{"worker_id"}``: the
  worker's ready report;
- ``GET /distributed/local-worker-status``: each managed or ``local``
  host's process, launch state, breaker, drain state and probe;
- ``POST /distributed/worker/{worker_id}/drain`` ``{"deadline_s"?,
  "stop_process"?}``: a graceful drain (``cluster/elastic/drain.py``):
  no new work at once, held work finished or handed back by the
  deadline, then the process stopped (``stop_process``, default true)
  and the worker decommissioned; ``POST
  /distributed/worker/{worker_id}/undrain``: cancel it or reactivate the
  id; ``GET /distributed/elastic``: the autoscaler's signals and
  decisions and the drains' states and reports;
- ``GET /distributed/remote_worker_log/{worker_id}``: a host's own
  ``/distributed/local_log``, fetched by the master;
- ``POST /distributed/warmup`` ``{"models"?: [...], "wait"?: bool}``: a
  warm pass over the shape catalog (``diffusion/warmup.py``), answered at
  once (``wait``: when it ends, with its report);
- ``GET /distributed/warmup``: the pass's state, outcomes, seconds,
  report and the registry's bundle builds.
"""

from __future__ import annotations

import asyncio
import json
from pathlib import Path

from ..cluster.elastic.states import DRAIN
from ..cluster.resilience import BREAKERS
from ..utils import constants
from ..utils.exceptions import ProcessError, ValidationError
from ..utils.logging import debug_log
from ..utils.network import build_host_url, http_request_async, probe_host
from .info_routes import tail_file
from .schemas import require_fields, validate_worker_id


def register(app, controller) -> None:
    from .app import Response, json_error

    c = controller

    async def launch_worker(request):
        body = request.json()
        require_fields(body, "worker_id")
        wid = validate_worker_id(body["worker_id"])
        try:
            mp = await asyncio.get_running_loop().run_in_executor(
                None, c.worker_manager.launch_worker, wid)
        except ProcessError as e:
            status = 404 if "no configured host" in str(e) else 409
            return json_error(str(e), status)
        return Response(200, {"status": "launched", "pid": mp.pid,
                              "log": str(mp.log_path)})

    async def stop_worker(request):
        body = request.json()
        require_fields(body, "worker_id")
        wid = validate_worker_id(body["worker_id"])
        stopped = await asyncio.get_running_loop().run_in_executor(
            None, c.worker_manager.stop_worker, wid)
        if not stopped:
            return json_error(f"no managed worker {wid!r}", 404)
        return Response(200, {"status": "stopped"})

    async def managed_workers(request):
        return Response(200,
                        {"workers": c.worker_manager.get_managed_workers()})

    async def worker_log(request):
        wid = request.match["worker_id"]
        info = c.worker_manager.get_managed_workers().get(wid)
        if info is None or not info.get("log"):
            return json_error(f"no log for worker {wid!r}", 404)
        path = Path(info["log"])
        if not path.is_file():
            return Response(200, {"log": "", "available": False})
        text = await asyncio.get_running_loop().run_in_executor(
            None, tail_file, path)
        return Response(200, {"log": text, "available": True})

    async def clear_launching(request):
        body = request.json()
        require_fields(body, "worker_id")
        wid = validate_worker_id(body["worker_id"])
        cleared = c.worker_manager.clear_launching(wid)
        debug_log(f"worker {wid} reported ready (flag was "
                  f"{'set' if cleared else 'not set'})")
        return Response(200, {"status": "ok", "cleared": cleared})

    async def local_worker_status(request):
        managed = c.worker_manager.get_managed_workers()
        hosts = {str(h.get("id")): h for h in c.load_config().get("hosts", [])}
        ids = sorted(set(managed) | {i for i, h in hosts.items()
                                     if h.get("type") == "local"})
        sem = asyncio.Semaphore(constants.worker_probe_concurrency())

        async def status_one(wid: str) -> tuple[str, dict]:
            entry: dict = {
                "managed": wid in managed,
                "launching": bool(managed.get(wid, {}).get("launching")),
                "pid": managed.get(wid, {}).get("pid"),
                "online": False,
                "queue_remaining": None,
                "breaker": BREAKERS.state(wid),
                # active | draining | decommissioned (cluster/elastic)
                "drain": DRAIN.state(wid),
                # the host's warm state (diffusion/warmup.py), from its probe
                "warmup": None,
            }
            host = hosts.get(wid)
            if host:
                async with sem:
                    health = await probe_host(host)
                if health is not None:
                    entry["online"] = True
                    entry["queue_remaining"] = health.get("queue_remaining")
                    entry["warmup"] = health.get("warmup")
            return wid, entry

        results = await asyncio.gather(*(status_one(w) for w in ids))
        return Response(200, {"workers": dict(results)})

    async def remote_worker_log(request):
        wid = request.match["worker_id"]
        host = c.host_by_id(wid)
        if host is None:
            return json_error(f"no configured host {wid!r}", 404)
        url = build_host_url(host, "/distributed/local_log")
        try:
            status, raw = await http_request_async(
                url, timeout=constants.probe_timeout() * 2)
            return Response(status, json.loads(raw))
        except (OSError, ValueError) as e:
            return json_error(f"host {wid!r} unreachable: {e}", 502)

    async def warmup_start(request):
        body = request.json() if request.body else {}
        if not isinstance(body, dict):
            raise ValidationError("payload must be a JSON object")
        models = body.get("models")
        if models is not None and (
                not isinstance(models, list)
                or not all(isinstance(m, str) for m in models)):
            raise ValidationError("'models' must be a list of strings",
                                  field="models")
        if body.get("wait"):
            status = await asyncio.get_running_loop().run_in_executor(
                None, lambda: c.warmup.run(models=models))
            return Response(200, status)
        c.start_warmup(models)
        return Response(200, {"state": c.warmup.state, "started": True})

    async def warmup_status(request):
        return Response(200, c.warmup.status())

    def elastic():
        if c.elastic is None:
            raise ValidationError("elastic manager not started")
        return c.elastic

    async def drain_worker(request):
        """A planned departure, never breaker evidence."""
        wid = validate_worker_id(request.match["worker_id"])
        body = request.json() if request.body else {}
        if not isinstance(body, dict):
            raise ValidationError("payload must be a JSON object")
        deadline_s = body.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                raise ValidationError("'deadline_s' must be a number",
                                      field="deadline_s") from None
            if deadline_s <= 0:
                raise ValidationError("'deadline_s' must be positive",
                                      field="deadline_s")
        report = elastic().coordinator.begin(
            wid, deadline_s=deadline_s,
            stop_process=bool(body.get("stop_process", True)))
        return Response(200, {"status": "draining", **report})

    async def undrain_worker(request):
        wid = validate_worker_id(request.match["worker_id"])
        cleared = elastic().coordinator.undrain(wid)
        return Response(200, {"status": "active", "cleared": cleared})

    async def elastic_status(request):
        return Response(200, elastic().status())

    app.add("POST", "/distributed/warmup", warmup_start)
    app.add("GET", "/distributed/warmup", warmup_status)
    app.add("POST", "/distributed/launch_worker", launch_worker)
    app.add("POST", "/distributed/stop_worker", stop_worker)
    app.add("GET", "/distributed/managed_workers", managed_workers)
    app.add("GET", "/distributed/worker_log/{worker_id}", worker_log)
    app.add("POST", "/distributed/worker/clear_launching", clear_launching)
    app.add("POST", "/distributed/worker/{worker_id}/drain", drain_worker)
    app.add("POST", "/distributed/worker/{worker_id}/undrain", undrain_worker)
    app.add("GET", "/distributed/elastic", elastic_status)
    app.add("GET", "/distributed/local-worker-status", local_worker_status)
    app.add("GET", "/distributed/remote_worker_log/{worker_id}",
            remote_worker_log)
