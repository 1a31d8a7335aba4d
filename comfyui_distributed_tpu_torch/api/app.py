"""The HTTP control plane on the standard library: ``asyncio.start_server``
and a small HTTP/1.1 handler (request line, headers, a ``Content-Length``
body; no chunked bodies; one request per connection; JSON answers, a PNG
for the preview), with an RFC 6455 upgrade for the dispatch WebSocket
(``utils/websocket.py``).

Routes (the JAX package's ``api/app.py``, less stages, preemption and
the fleet cache):

- ``GET /distributed/health``, ``GET /distributed/system_info``
- ``GET /prompt`` (queue depth), ``POST /prompt`` (validate and enqueue)
- ``GET /distributed/history/{prompt_id}`` (tensors summarised as shapes)
- ``POST /distributed/queue`` (through the serving front door: admitted,
  classified, coalesced or orchestrated over the configured hosts; a
  shed request answers 429 with ``Retry-After``; with
  ``CDT_FRONTDOOR=0`` straight to the orchestrator)
- ``GET /distributed/frontdoor``, ``GET /distributed/cache``,
  ``POST /distributed/cache/clear`` (the front door's and the content
  cache's state; the clear drops both memory tiers)
- ``POST /distributed/interrupt`` (drop pending prompts, stop the
  running one before its next node)
- ``GET /distributed/progress/{prompt_id}``,
  ``GET /distributed/preview/{prompt_id}?shard=`` (sampling progress and
  the latest latent preview; 404 until the first step)
- ``GET /distributed/worker_ws`` (WebSocket: ``dispatch_prompt`` in,
  ``dispatch_ack`` out)
- ``POST /distributed/job_complete`` (base64-PNG envelope),
  ``POST /distributed/job_complete_frames`` (multipart CDTF frames), each
  with the worker's AUDIO envelope on its last result,
  ``POST /distributed/prepare_job``
- ``POST /distributed/clear_memory``
- media sync: ``POST /distributed/check_file`` (exists, md5, matches),
  ``POST /distributed/load_image`` (a base64 data URL and its md5),
  ``POST /upload/image`` (multipart, field ``image``), all within the
  controller's input directory
- the tile farm's routes (``api/usdu_routes.py``): ``heartbeat``,
  ``request_image``, ``submit_tiles``, ``submit_image``, ``handback``,
  ``job_status`` and ``queue_status/{job_id}`` under ``/distributed/``
- information, profiling and telemetry (``api/info_routes.py``), the
  config (``api/config_routes.py``), the tunnel
  (``api/tunnel_routes.py``) and the worker processes
  (``api/worker_routes.py``)
- the dashboard: ``GET /`` and ``GET /web/{file}`` (the package's
  ``web/``)

Each request passes the JAX package's middleware in its order: an
``OPTIONS`` preflight answers 200; a POST that is neither JSON nor a
peer's multipart (``X-CDT-Client``) answers 415; with a cluster token
configured (``utils/auth.py``) a mutating or gated route answers 401
without it. Only the read-only probe routes carry CORS headers, unless
``settings.permissive_cors`` is set. Errors are JSON ``{"error": ...,
"status": ...}``: 400 for a validation error or a malformed request, 404
unknown path, 405 wrong method, 413 body over ``CDT_MAX_PAYLOAD_SIZE``,
500 anything else. With telemetry on, a request's ``X-CDT-Trace`` header
is adopted for its handler (a dispatched prompt joins the master's
trace) and every request counts in ``cdt_http_requests_total`` under its
route template.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import hashlib
import http
import json
import re
import threading
import traceback
import urllib.parse
from pathlib import Path
from typing import Any, Awaitable, Callable

from .. import telemetry
from ..cluster.controller import Controller
from ..telemetry import metrics as _tm
from ..utils import auth, constants
from ..utils.config import peek_setting
from ..utils.deadline import deadline_call
from ..utils.exceptions import DistributedError, ValidationError
from ..utils.frames import unpack_frame
from ..utils.logging import log
from ..utils.multipart import parse_multipart
from ..utils.websocket import WebSocket, WebSocketError, server_handshake
from . import (config_routes, info_routes, tunnel_routes, usdu_routes,
               worker_routes)
from .queue_request import parse_queue_request_payload

# header cluster peers send on multipart POSTs (a browser form cannot
# attach it without a preflight)
CLIENT_HEADER = "x-cdt-client"

# The read-only probe surface a dashboard reads on other hosts (the JAX
# package's, less the stages route, not ported). Mutating routes carry no
# CORS header: with a public tunnel up, a permissive `*` there would let
# any web page drive the cluster.
_CORS_SAFE_PATHS = frozenset({
    "/distributed/health",
    "/distributed/system_info",
    "/distributed/network_info",
    "/distributed/metrics",
    "/distributed/metrics.json",
    "/distributed/frontdoor",
    "/distributed/cache",
    "/prompt",
})
WEB_DIR = Path(__file__).resolve().parent.parent / "web"
_STATIC_TYPES = {".js": "text/javascript; charset=utf-8",
                 ".css": "text/css; charset=utf-8",
                 ".html": "text/html; charset=utf-8",
                 ".json": "application/json"}
_CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type, " + auth.AUTH_HEADER,
}
MAX_HEADERS = 100
READ_TIMEOUT_S = 120.0
THREAD_TIMEOUT_S = 60.0      # ServerThread: start, stop, join


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclasses.dataclass
class Request:
    method: str
    path: str
    headers: dict[str, str]          # names in lower case
    body: bytes = b""
    match: dict[str, str] = dataclasses.field(default_factory=dict)
    query: dict[str, str] = dataclasses.field(default_factory=dict)
    route: str | None = None                 # the matched template
    trace: tuple[str, str | None] | None = None   # parsed X-CDT-Trace

    def json(self) -> Any:
        try:
            return json.loads(self.body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise ValidationError("body must be valid JSON") from None


@dataclasses.dataclass
class Response:
    """``payload``: JSON, or ``bytes`` sent as they are under
    ``content_type``."""
    status: int
    payload: Any
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    content_type: str = "application/json"


@dataclasses.dataclass
class Upgrade(Response):
    """A 101 answer: the connection becomes a WebSocket that ``session``
    serves until it closes."""
    session: Callable[[WebSocket], Awaitable[None]] | None = None


def json_error(message: str, status: int = 400) -> Response:
    return Response(status, {"error": message, "status": status})


Handler = Callable[[Request], Awaitable[Response]]


def _post_content_type_ok(request: Request) -> bool:
    ctype = request.headers.get("content-type", "").lower()
    if ctype.startswith("application/json"):
        return True
    if ctype.startswith("multipart/form-data"):
        return CLIENT_HEADER in request.headers
    return False


def _summarize(v):
    """History outputs: tensors and arrays as their shape and dtype, AUDIO
    as its waveform's shape and its rate."""
    if getattr(v, "shape", None) is not None and not isinstance(v, (int, float, bool)):
        return {"shape": list(v.shape), "dtype": str(getattr(v, "dtype", ""))}
    if isinstance(v, dict) and "waveform" in v:
        shape = getattr(v["waveform"], "shape", None)
        return {"audio": {"shape": list(shape) if shape is not None else [],
                          "sample_rate": int(v.get("sample_rate", 0))}}
    if isinstance(v, (dict, list, tuple)):
        return str(type(v).__name__)
    return v if isinstance(v, (int, float, str, bool, type(None))) else str(v)


class App:
    """Route table and handlers over one controller."""

    def __init__(self, controller: Controller):
        self.controller = controller
        self._routes: list[tuple[str, re.Pattern, str, Handler]] = []
        c = controller

        async def health(request):
            return Response(200, c.health())

        async def system_info(request):
            # the census makes torch.cuda calls, which a wedged driver can
            # hold forever: off the loop, under a deadline
            info = await deadline_call(c.system_info, fallback=None)
            if info is None:
                info = c.system_info_no_devices()
                info["devices"] = [{"error": "device backend unresponsive"}]
            return Response(200, info)

        async def prompt_get(request):
            return Response(200, {"exec_info": {
                "queue_remaining": c.queue.queue_remaining}})

        async def prompt_post(request):
            body = request.json()
            prompt = body.get("prompt") if isinstance(body, dict) else None
            if not isinstance(prompt, dict) or not prompt:
                raise ValidationError("'prompt' must be a non-empty object")
            # the X-CDT-Trace header wins over the body's trace_id: the
            # execution span then joins the dispatching master's trace,
            # under its dispatch span
            hdr = request.trace
            prompt_id, errors = c.queue.enqueue(
                prompt, body.get("client_id", ""),
                hdr[0] if hdr else body.get("trace_id"),
                parent_span_id=hdr[1] if hdr else None)
            if errors:
                return Response(400, {"error": "validation failed",
                                      "node_errors": errors})
            return Response(200, {"prompt_id": prompt_id, "node_errors": {}})

        async def history(request):
            pid = request.match["prompt_id"]
            entry = c.queue.history.get(pid)
            if entry is None:
                return json_error(f"no finished prompt {pid!r}", 404)
            extra = {k: entry[k] for k in ("batch_size", "cache",
                                           "coalesced_with") if k in entry}
            return Response(200, {
                "prompt_id": pid,
                "status": entry.get("status"),
                "error": entry.get("error"),
                "duration": entry.get("duration"),
                **extra,
                "outputs": {
                    node: [_summarize(v) for v in (
                        outs if isinstance(outs, (list, tuple)) else [outs])]
                    for node, outs in (entry.get("outputs") or {}).items()
                },
            })

        async def distributed_queue(request):
            payload = parse_queue_request_payload(request.json())
            if c.frontdoor is None:
                # CDT_FRONTDOOR=0: the path without the front door
                result = await c.orchestrator.orchestrate(
                    payload.prompt,
                    client_id=payload.client_id,
                    enabled_ids=payload.enabled_worker_ids,
                    delegate_master=payload.delegate_master,
                    load_balance=payload.load_balance,
                    trace_id=payload.trace_id,
                )
                return Response(200, {
                    "prompt_id": result.prompt_id,
                    "number": 0,
                    "node_errors": result.node_errors,
                    "worker_count": result.worker_count,
                    "trace_id": result.trace_id,
                })
            res = await c.frontdoor.submit(payload)
            if res.outcome == "shed":
                # explicit overload shedding: the client backs off
                return Response(
                    429, {"error": "overloaded", "outcome": "shed",
                          "reason": res.reason,
                          "retry_after_s": res.retry_after_s, "status": 429},
                    headers={"Retry-After": str(int(res.retry_after_s) or 1)})
            return Response(200, {
                "prompt_id": res.prompt_id,
                "number": 0,
                "node_errors": res.node_errors,
                "worker_count": res.worker_count,
                "trace_id": res.trace_id,
                "outcome": res.outcome,
                "batched": res.batched,
                "coalesced": res.coalesced,
            })

        async def frontdoor_stats(request):
            if c.frontdoor is None:
                return Response(200, {"enabled": False})
            return Response(200, c.frontdoor.stats())

        async def cache_stats(request):
            if c.cache is None:
                return Response(200, {"enabled": False})
            return Response(200, c.cache.stats())

        async def cache_clear(request):
            """Drop both memory tiers; persisted entries are content-
            addressed and stay valid (delete the cache directory to drop
            them)."""
            if c.cache is None:
                return Response(200, {"enabled": False})
            dropped = (c.cache.conditioning.clear_memory()
                       + c.cache.results.clear_memory())
            return Response(200, {"status": "cleared", "dropped": dropped})

        def require_ids(meta: Any) -> None:
            if not isinstance(meta, dict):
                raise ValidationError("payload must be a JSON object")
            for field in ("job_id", "worker_id"):
                if not isinstance(meta.get(field), str) or not meta[field]:
                    raise ValidationError(f"missing or invalid {field!r}",
                                          field=field)

        async def job_complete(request):
            body = request.json()
            require_ids(body)
            if "is_last" not in body:
                raise ValidationError("missing 'is_last'", field="is_last")
            await c.store.put_collector_result(body["job_id"], body)
            return Response(200, {"status": "received"})

        async def job_complete_frames(request):
            parts = parse_multipart(request.body,
                                    request.headers.get("content-type", ""))
            meta, blobs = None, {}
            for part in parts:
                if part.name == "metadata":
                    try:
                        meta = json.loads(part.data)
                    except (json.JSONDecodeError, UnicodeDecodeError):
                        raise ValidationError("metadata must be valid JSON") from None
                elif part.name.startswith("frame_"):
                    try:
                        blobs[int(part.name[len("frame_"):])] = part.data
                    except ValueError:
                        raise ValidationError(
                            f"bad frame part name {part.name!r}") from None
            if meta is None:
                raise ValidationError("missing metadata part")
            require_ids(meta)
            try:
                count = int(meta.get("count", len(blobs)))
            except (TypeError, ValueError):
                raise ValidationError("'count' must be an integer") from None
            if count and sorted(blobs) != list(range(count)):
                raise ValidationError(
                    f"expected frames 0..{count - 1}, got {sorted(blobs)}")

            def unpack_all():
                # inflate and crc of multi-MB frames: off the event loop
                out = {}
                for i, blob in blobs.items():
                    try:
                        out[i] = unpack_frame(blob)
                    except ValueError as e:
                        raise ValidationError(f"frame {i}: {e}") from None
                return out

            frames = await asyncio.get_running_loop().run_in_executor(
                None, unpack_all)
            # the worker's AUDIO envelope rides on its last result
            audio = {"audio": meta["audio"]} if meta.get("audio") else {}
            for i in range(count):
                await c.store.put_collector_result(meta["job_id"], {
                    "job_id": meta["job_id"], "worker_id": meta["worker_id"],
                    "batch_idx": i, "image_arr": frames[i],
                    "is_last": i == count - 1,
                    **(audio if i == count - 1 else {}),
                })
            if count == 0:
                await c.store.put_collector_result(meta["job_id"], {
                    "job_id": meta["job_id"], "worker_id": meta["worker_id"],
                    "batch_idx": -1, "is_last": True, **audio,
                })
            return Response(200, {"status": "received", "frames": count})

        async def prepare_job(request):
            body = request.json()
            job_id = body.get("job_id") if isinstance(body, dict) else None
            if not isinstance(job_id, str) or not job_id:
                raise ValidationError("missing 'job_id'", field="job_id")
            await c.store.prepare_collector_job(
                job_id, tuple(body.get("expected_workers", ())))
            return Response(200, {"status": "prepared"})

        async def clear_memory(request):
            return Response(200, c.clear_memory())

        async def interrupt(request):
            dropped = c.queue.interrupt()
            return Response(200, {"status": "interrupted", "dropped": dropped})

        async def sampling_progress(request):
            snap = c.progress.snapshot(request.match["prompt_id"])
            if snap is None:
                return json_error("unknown prompt", 404)
            return Response(200, snap)

        async def sampling_preview(request):
            try:
                shard = int(request.query.get("shard", "0"))
            except ValueError:
                shard = 0
            png = c.progress.preview_png(request.match["prompt_id"], shard)
            if png is None:
                return json_error("no preview yet", 404)
            return Response(200, png, content_type="image/png")

        async def worker_ws(request):
            try:
                headers = server_handshake(request.headers)
            except WebSocketError as e:
                raise ValidationError(str(e)) from None
            hdr = request.trace           # the connect's X-CDT-Trace

            async def session(ws: WebSocket) -> None:
                """``dispatch_prompt`` in: queue it here and answer
                ``dispatch_ack`` with the prompt id and the validation
                errors."""
                async for msg in ws:
                    if msg.kind != "text":
                        continue
                    try:
                        data = json.loads(msg.data)
                    except json.JSONDecodeError:
                        await ws.send_str(json.dumps(
                            {"type": "error", "error": "invalid JSON"}))
                        continue
                    kind = data.get("type") if isinstance(data, dict) else None
                    if kind != "dispatch_prompt":
                        await ws.send_str(json.dumps(
                            {"type": "error", "error": f"unknown type {kind!r}"}))
                        continue
                    prompt_id, node_errors = c.queue.enqueue(
                        data.get("prompt") or {}, data.get("client_id", ""),
                        hdr[0] if hdr else data.get("trace_id"),
                        parent_span_id=hdr[1] if hdr else None)
                    await ws.send_str(json.dumps({
                        "type": "dispatch_ack",
                        "request_id": data.get("request_id"),
                        "prompt_id": prompt_id,
                        "node_errors": node_errors,
                        "ok": not node_errors,
                    }))

            return Upgrade(101, None, headers, session=session)

        def safe_media_path(rel: Any) -> Path:
            """``rel`` inside the controller's input directory. Departure
            from the JAX package, whose string-prefix test lets
            ``../<sibling whose name starts with the directory's>/x``
            through: containment is tested on the resolved paths."""
            if not isinstance(rel, str) or not rel:
                raise ValidationError("missing 'path'", field="path")
            base = Path(c.input_dir).resolve()
            p = (base / rel).resolve()
            if not p.is_relative_to(base):
                raise ValidationError("path escapes input directory",
                                      field="path")
            return p

        def json_object(request: Request) -> dict:
            body = request.json()
            if not isinstance(body, dict):
                raise ValidationError("body must be a JSON object")
            return body

        async def check_file(request):
            body = json_object(request)
            p = safe_media_path(body.get("path"))
            if not p.is_file():
                return Response(200, {"exists": False})
            # media are megabytes: read and hash off the event loop
            md5 = await asyncio.get_running_loop().run_in_executor(
                None, lambda: hashlib.md5(p.read_bytes()).hexdigest())
            matches = body.get("md5") is None or body["md5"] == md5
            return Response(200, {"exists": True, "md5": md5,
                                  "matches": matches})

        async def load_image(request):
            body = json_object(request)
            rel = body.get("path")
            p = safe_media_path(rel)
            if not p.is_file():
                return json_error(f"file not found: {rel}", 404)

            def read_encode_hash():
                raw = p.read_bytes()
                return (base64.b64encode(raw).decode(),
                        hashlib.md5(raw).hexdigest())

            b64, md5 = await asyncio.get_running_loop().run_in_executor(
                None, read_encode_hash)
            return Response(200, {"image": "data:image/png;base64," + b64,
                                  "md5": md5})

        async def upload_image(request):
            parts = parse_multipart(request.body,
                                    request.headers.get("content-type", ""))
            loop = asyncio.get_running_loop()
            saved = []
            for part in parts:
                if part.name != "image":
                    continue
                rel = part.filename or "upload.png"
                p = safe_media_path(rel)

                def write(p=p, data=part.data):
                    p.parent.mkdir(parents=True, exist_ok=True)
                    p.write_bytes(data)

                await loop.run_in_executor(None, write)
                saved.append(rel)
            return Response(200, {"saved": saved})

        self.add("GET", "/distributed/health", health)
        self.add("GET", "/distributed/system_info", system_info)
        self.add("GET", "/prompt", prompt_get)
        self.add("POST", "/prompt", prompt_post)
        self.add("GET", "/distributed/history/{prompt_id}", history)
        self.add("POST", "/distributed/queue", distributed_queue)
        self.add("GET", "/distributed/frontdoor", frontdoor_stats)
        self.add("GET", "/distributed/cache", cache_stats)
        self.add("POST", "/distributed/cache/clear", cache_clear)
        self.add("POST", "/distributed/job_complete", job_complete)
        self.add("POST", "/distributed/job_complete_frames", job_complete_frames)
        self.add("POST", "/distributed/prepare_job", prepare_job)
        self.add("POST", "/distributed/clear_memory", clear_memory)
        self.add("POST", "/distributed/interrupt", interrupt)
        self.add("GET", "/distributed/progress/{prompt_id}", sampling_progress)
        self.add("GET", "/distributed/preview/{prompt_id}", sampling_preview)
        self.add("GET", "/distributed/worker_ws", worker_ws)
        self.add("POST", "/distributed/check_file", check_file)
        self.add("POST", "/distributed/load_image", load_image)
        async def index(request):
            return Response(200, (WEB_DIR / "index.html").read_bytes(),
                            content_type=_STATIC_TYPES[".html"])

        async def web_file(request):
            """A file of the dashboard; the resolved path must stay in
            ``web/``."""
            base = WEB_DIR.resolve()
            p = (base / request.match["file"]).resolve()
            if not p.is_relative_to(base) or not p.is_file():
                return json_error(f"no file {request.match['file']!r}", 404)
            return Response(200, p.read_bytes(), content_type=_STATIC_TYPES.get(
                p.suffix, "application/octet-stream"))

        self.add("POST", "/upload/image", upload_image)
        self.add("GET", "/", index)
        self.add("GET", "/web/{file}", web_file)
        usdu_routes.register(self, controller)
        info_routes.register(self, controller)
        config_routes.register(self, controller)
        tunnel_routes.register(self, controller)
        worker_routes.register(self, controller)

    def add(self, method: str, template: str, handler: Handler) -> None:
        pattern = re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^/]+)", re.escape(template))
        self._routes.append((method, re.compile(pattern), template, handler))

    async def dispatch(self, request: Request) -> Response:
        if telemetry.enabled():
            response = await self._traced(request)
        else:
            response = await self._respond(request)
        permissive = bool(peek_setting("permissive_cors", False,
                                       self.controller.config_path))
        safe = (request.method in ("GET", "OPTIONS")
                and (request.path in _CORS_SAFE_PATHS
                     or request.path.startswith("/distributed/queue_status")))
        if permissive or safe:
            response.headers.update(_CORS_HEADERS)
        return response

    async def _traced(self, request: Request) -> Response:
        """Adopt the request's ``X-CDT-Trace`` for its handler and count
        it under its route template (raw paths are peer-controlled and
        would blow the label cardinality)."""
        request.trace = telemetry.parse_trace_header(
            request.headers.get(telemetry.TRACE_HEADER.lower(), ""))
        if request.trace is not None:
            with telemetry.use_trace(*request.trace):
                response = await self._respond(request)
        else:
            response = await self._respond(request)
        _tm.HTTP_REQUESTS.labels(method=request.method,
                                 path=request.route or "<unmatched>",
                                 status=str(response.status)).inc()
        return response

    async def _respond(self, request: Request) -> Response:
        if request.method == "OPTIONS":
            return Response(200, b"", content_type="text/plain")
        if request.method == "POST" and not _post_content_type_ok(request):
            return json_error("unsupported media type", 415)
        if auth.requires_auth(request.method, request.path):
            token = auth.resolve_token(self.controller.config_path)
            if token and not auth.token_matches(request.headers, token):
                return json_error("missing or invalid auth token", 401)
        handler, path_known = None, False
        for method, pattern, template, fn in self._routes:
            m = pattern.fullmatch(request.path)
            if m is None:
                continue
            path_known = True
            if method == request.method:
                handler, request.match = fn, m.groupdict()
                request.route = template
                break
        if handler is None:
            return (json_error(f"method {request.method} not allowed", 405)
                    if path_known else json_error(f"no route {request.path}", 404))
        try:
            return await handler(request)
        except ValidationError as e:
            return json_error(str(e), 400)
        except DistributedError as e:
            return json_error(str(e), 500)
        except Exception as e:  # noqa: BLE001 — the server outlives a handler
            log(f"{request.method} {request.path} failed: {e!r}\n"
                f"{traceback.format_exc()}")
            return json_error(f"internal error: {e}", 500)


async def read_request(reader: asyncio.StreamReader) -> Request:
    """One HTTP/1.1 request; raises ``HTTPError`` for what it refuses."""
    try:
        line = (await reader.readline()).decode("latin-1").rstrip("\r\n")
        parts = line.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise HTTPError(400, f"malformed request line {line[:100]!r}")
        method, target, _ = parts
        headers: dict[str, str] = {}
        while True:
            raw = (await reader.readline()).decode("latin-1").rstrip("\r\n")
            if not raw:
                break
            if len(headers) >= MAX_HEADERS or ":" not in raw:
                raise HTTPError(400, "malformed or too many headers")
            name, _, value = raw.partition(":")
            headers[name.strip().lower()] = value.strip()
    except (ValueError, asyncio.LimitOverrunError):
        raise HTTPError(400, "request line or header too long") from None
    if "transfer-encoding" in headers:
        raise HTTPError(400, "chunked bodies are not supported; "
                             "send Content-Length")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise HTTPError(400, "bad Content-Length") from None
    if length < 0:
        raise HTTPError(400, "bad Content-Length")
    if length > constants.max_payload_size():
        raise HTTPError(413, f"payload too large ({length} bytes, limit "
                             f"{constants.max_payload_size()})")
    body = await reader.readexactly(length) if length else b""
    parts = urllib.parse.urlsplit(target)
    query = dict(urllib.parse.parse_qsl(parts.query))
    return Request(method.upper(), urllib.parse.unquote(parts.path), headers,
                   body, query=query)


def _encode_response(response: Response) -> bytes:
    reason = http.HTTPStatus(response.status).phrase
    extra = "".join(f"{k}: {v}\r\n" for k, v in response.headers.items())
    if isinstance(response, Upgrade):
        return f"HTTP/1.1 101 {reason}\r\n{extra}\r\n".encode("latin-1")
    body = (response.payload if isinstance(response.payload, bytes)
            else json.dumps(response.payload, default=str).encode())
    head = (f"HTTP/1.1 {response.status} {reason}\r\n"
            f"Content-Type: {response.content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extra}Connection: close\r\n\r\n")
    return head.encode("latin-1") + body


class Server:
    """The control plane of one controller on one listening socket."""

    def __init__(self, controller: Controller, host: str, port: int):
        self.controller = controller
        self.app = App(controller)
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        await self.controller.startup()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log(f"control plane listening on {self.host}:{self.port}")

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.controller.shutdown()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                request = await asyncio.wait_for(read_request(reader),
                                                 READ_TIMEOUT_S)
                response = await self.app.dispatch(request)
            except HTTPError as e:
                response = json_error(str(e), e.status)
            writer.write(_encode_response(response))
            await writer.drain()
            if isinstance(response, Upgrade):
                ws = WebSocket(reader, writer, client=False,
                               heartbeat=constants.heartbeat_interval())
                try:
                    await response.session(ws)
                finally:
                    await ws.close()
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass                  # the peer went away or stalled: drop it
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass


async def run_app(controller: Controller, host: str = "0.0.0.0",
                  port: int | None = None) -> Server:
    """Start the control plane; ``port`` defaults to the config's
    ``master.port``."""
    if port is None:
        port = controller.load_config().get("master", {}).get("port", 8288)
    server = Server(controller, host, port)
    await server.start()
    return server


class ServerThread:
    """A controller's control plane on an event loop of its own thread,
    for a process that does other work on its main thread (an embedding
    program, a test)."""

    def __init__(self, controller: Controller, host: str = "127.0.0.1",
                 port: int = 0):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        name="control-plane", daemon=True)
        self._thread.start()
        try:
            self.server = asyncio.run_coroutine_threadsafe(
                run_app(controller, host, port), self.loop).result(THREAD_TIMEOUT_S)
        except BaseException:
            self._close_loop()
            raise
        self.port = self.server.port

    def stop(self) -> None:
        try:
            asyncio.run_coroutine_threadsafe(
                self.server.stop(), self.loop).result(THREAD_TIMEOUT_S)
        finally:
            self._close_loop()

    def _close_loop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(THREAD_TIMEOUT_S)
        if not self._thread.is_alive():
            self.loop.close()
