"""Information, observability and log routes on the port's router (the
JAX package's ``api/info_routes.py``, its routes that ``api/app.py``
does not serve already):

- ``GET /distributed/object_info`` (the node interface specs the
  dashboard's forms are built from), ``GET /distributed/workflows`` and
  ``GET /distributed/workflows/{name}`` (the shipped workflows);
- ``GET /distributed/network_info``, ``GET /distributed/local_log``;
- ``POST /distributed/profile/start`` and ``/profile/stop``: a
  ``torch.profiler`` trace (CPU and, on a card, CUDA activity) exported
  as a Chrome trace ``trace.json`` in ``CDT_PROFILE_DIR/<name>``; the
  JAX package runs ``jax.profiler`` there;
- ``GET /distributed/memory_stats``: each card's allocator statistics
  (``torch.cuda.memory_stats``) and free and total bytes
  (``torch.cuda.mem_get_info``);
- ``GET /distributed/metrics`` (Prometheus text), ``/metrics.json``,
  ``/trace/{job_id}`` (the span tree) and ``/step_times``.

On a master, ``/distributed/trace/{job_id}`` also asks each configured
host for the spans it recorded under the same trace (``?local=1`` asks
one host for its own only), so one tree holds the master's orchestration
and the workers' execution: in the JAX package a trace holds the spans
of one process.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import time
import urllib.parse
from pathlib import Path

from ..telemetry import REGISTRY, SPAN_STORE, span_tree
from ..telemetry.export import (PROMETHEUS_CONTENT_TYPE, render_json,
                                render_prometheus)
from ..utils import constants
from ..utils.deadline import deadline_call
from ..utils.exceptions import ValidationError
from ..utils.names import sanitize_name, validate_name
from ..utils.network import build_host_url, http_request_async

_DEGRADED = [{"error": "device backend unresponsive"}]
TRACE_FILE = "trace.json"


def _list_interfaces() -> list[dict]:
    """Best-effort NIC enumeration, to recommend a private IP."""
    interfaces = []
    try:
        hostname = socket.gethostname()
        for info in socket.getaddrinfo(hostname, None, socket.AF_INET):
            ip = info[4][0]
            if ip not in (i["ip"] for i in interfaces):
                interfaces.append({"name": hostname, "ip": ip})
    except OSError:
        pass
    # the outbound interface: a UDP connect sends nothing
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        ip = s.getsockname()[0]
        s.close()
        if ip not in (i["ip"] for i in interfaces):
            interfaces.append({"name": "outbound", "ip": ip})
    except OSError:
        pass
    if not any(i["ip"] == "127.0.0.1" for i in interfaces):
        interfaces.append({"name": "lo", "ip": "127.0.0.1"})
    return interfaces


def _recommend_ip(interfaces: list[dict]) -> str:
    for i in interfaces:
        ip = i["ip"]
        if ip.startswith(("10.", "192.168.", "172.")):
            return ip
    return interfaces[0]["ip"] if interfaces else "127.0.0.1"


def tail_file(path: Path, max_bytes: int = 64 * 1024) -> str:
    """The last ``max_bytes`` of a file, from its first whole line."""
    size = path.stat().st_size
    with open(path, "rb") as f:
        if size > max_bytes:
            f.seek(size - max_bytes)
        data = f.read()
    text = data.decode("utf-8", errors="replace")
    if size > max_bytes and "\n" in text:
        text = text.split("\n", 1)[1]     # drop the partial first line
    return text


def memory_census() -> list[dict]:
    """Each visible card's allocator and driver memory figures."""
    import torch

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "kind": torch.cuda.get_device_name(i),
                    "stats": {
                        "allocated_bytes": stats.get(
                            "allocated_bytes.all.current", 0),
                        "peak_allocated_bytes": stats.get(
                            "allocated_bytes.all.peak", 0),
                        "reserved_bytes": stats.get(
                            "reserved_bytes.all.current", 0),
                        "free_bytes": free,
                        "total_bytes": total,
                        "num_alloc_retries": stats.get("num_alloc_retries", 0),
                        "num_ooms": stats.get("num_ooms", 0),
                    }})
    return out


class Profiler:
    """One ``torch.profiler`` trace at a time. Start and stop run on the
    server's loop thread; CUDA activity is recorded process-wide, so the
    kernels the prompt thread launches land in the trace."""

    def __init__(self, device):
        self.device = device
        self.out: str | None = None
        self._prof = None

    def start(self, out: str) -> None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            if (torch.profiler.ProfilerActivity.CUDA
                    not in torch.profiler.supported_activities()):
                raise RuntimeError("this torch build cannot trace CUDA "
                                   "activity (no CUPTI)")
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self._prof, self.out = prof, out

    def stop(self):
        """Stop the trace; returns the profile to export."""
        prof, self._prof, self.out = self._prof, None, None
        prof.stop()
        return prof


def register(app, controller) -> None:
    from .app import Response, json_error

    c = controller
    profiler = Profiler(c.device)

    async def network_info(request):
        interfaces = _list_interfaces()
        devices = await deadline_call(lambda: c.system_info()["devices"],
                                      fallback=_DEGRADED)
        return Response(200, {"interfaces": interfaces,
                              "recommended_ip": _recommend_ip(interfaces),
                              "devices": devices})

    async def local_log(request):
        """This controller's log: the launcher-assigned file
        (``CDT_LOG_FILE``) when there is one, else the in-memory buffer."""
        from ..utils.logging import get_log_buffer

        log_file = constants.log_file()
        if log_file and Path(log_file).is_file():
            text = await asyncio.get_running_loop().run_in_executor(
                None, tail_file, Path(log_file))
            return Response(200, {"log": text, "available": True})
        lines = get_log_buffer()
        return Response(200, {"log": "\n".join(lines),
                              "available": bool(lines)})

    async def profile_start(request):
        if profiler.out:
            return json_error(f"trace already running → {profiler.out}", 409)
        body = {}
        if request.body:
            try:
                body = request.json()
            except ValidationError:
                body = {}
        if not isinstance(body, dict):
            raise ValidationError("body must be a JSON object")
        if "out" in body and not isinstance(body["out"], str):
            raise ValidationError("'out' must be a string", field="out")
        # "out" is a NAME under the profile root, never a client path
        name = sanitize_name(
            os.path.basename(str(body.get("out") or time.strftime("%Y%m%d-%H%M%S"))),
            max_len=80, fallback="trace")
        out = os.path.join(constants.profile_dir(), name)
        try:
            profiler.start(out)
        except RuntimeError as e:
            return json_error(f"profiler did not start: {e}", 503)
        return Response(200, {"status": "tracing", "out": out})

    async def profile_stop(request):
        if not profiler.out:
            return json_error("no trace running", 409)
        out = profiler.out
        prof = profiler.stop()
        path = os.path.join(out, TRACE_FILE)

        def export():
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(path)

        await asyncio.get_running_loop().run_in_executor(None, export)
        return Response(200, {"status": "stopped", "out": out, "trace": path})

    async def memory_stats(request):
        devices = await deadline_call(memory_census, fallback=_DEGRADED)
        return Response(200, {"devices": devices})

    async def metrics_prometheus(request):
        return Response(200, render_prometheus(REGISTRY.snapshot()).encode(),
                        content_type=PROMETHEUS_CONTENT_TYPE)

    async def metrics_json(request):
        return Response(200, render_json(REGISTRY.snapshot()))

    async def peer_spans(trace_id: str) -> list[dict]:
        """The spans each configured host recorded under ``trace_id``;
        a host that does not answer adds none."""
        path = f"/distributed/trace/{urllib.parse.quote(trace_id)}?local=1"

        async def one(host: dict) -> list[dict]:
            try:
                status, body = await http_request_async(
                    build_host_url(host, path),
                    timeout=constants.probe_timeout())
                return json.loads(body).get("spans", []) if status == 200 else []
            except (OSError, ValueError, AttributeError):
                return []

        hosts = c.load_config().get("hosts", [])
        found = await asyncio.gather(*(one(h) for h in hosts
                                       if h.get("address")))
        return [s for spans in found for s in spans if isinstance(s, dict)
                and {"span_id", "start"} <= set(s)]

    async def trace_tree(request):
        job_id = request.match["job_id"]
        trace_id = SPAN_STORE.resolve(job_id)
        if trace_id is None:
            return json_error(f"no trace recorded for {job_id!r}", 404)
        spans = SPAN_STORE.spans(trace_id)
        if not c.is_worker and request.query.get("local") != "1":
            seen = {s["span_id"] for s in spans}
            for s in await peer_spans(trace_id):
                if s["span_id"] not in seen:
                    seen.add(s["span_id"])
                    spans.append(s)
        return Response(200, {"job_id": job_id, "trace_id": trace_id,
                              "spans": spans, "tree": span_tree(spans)})

    async def step_times(request):
        recent = list(c.queue.history.items())[-50:]
        return Response(200, {"prompts": [
            {"prompt_id": pid, "status": h.get("status"),
             "duration_s": round(h.get("duration", 0.0), 3)}
            for pid, h in recent]})

    def workflows_dir() -> Path:
        env = constants.workflows_dir()
        if env:
            return Path(env)
        return Path(__file__).resolve().parents[2] / "workflows"

    async def list_workflows(request):
        d = workflows_dir()
        names = sorted(p.stem for p in d.glob("*.json")) if d.is_dir() else []
        return Response(200, {"workflows": names})

    async def get_workflow(request):
        name = validate_name(request.match["name"], max_len=80)
        path = workflows_dir() / f"{name}.json"
        if not path.is_file():
            return json_error(f"no workflow {name!r}", 404)
        try:
            return Response(200, json.loads(path.read_text()))
        except json.JSONDecodeError as e:
            return json_error(f"workflow {name!r} is invalid JSON: {e}", 500)

    async def object_info(request):
        from ..graph.node import NODE_REGISTRY

        out = {}
        for name, cls in sorted(NODE_REGISTRY.items()):
            out[name] = {
                "required": dict(cls.INPUTS),
                "optional": dict(cls.OPTIONAL),
                "returns": list(cls.RETURNS),
                "output_node": bool(cls.OUTPUT_NODE),
                "category": getattr(cls, "CATEGORY", "distributed"),
            }
        return Response(200, {"nodes": out})

    app.add("GET", "/distributed/object_info", object_info)
    app.add("GET", "/distributed/workflows", list_workflows)
    app.add("GET", "/distributed/workflows/{name}", get_workflow)
    app.add("GET", "/distributed/network_info", network_info)
    app.add("GET", "/distributed/local_log", local_log)
    app.add("POST", "/distributed/profile/start", profile_start)
    app.add("POST", "/distributed/profile/stop", profile_stop)
    app.add("GET", "/distributed/memory_stats", memory_stats)
    app.add("GET", "/distributed/metrics", metrics_prometheus)
    app.add("GET", "/distributed/metrics.json", metrics_json)
    app.add("GET", "/distributed/trace/{job_id}", trace_tree)
    app.add("GET", "/distributed/step_times", step_times)
