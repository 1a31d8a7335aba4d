"""Control plane II of the port: the config routes against the JAX
package's handlers (the same request leaves the same config file), the
dashboard (every route its API client calls is answered; the static
files stay inside ``web/``), the CORS scope and the token, the tunnel
against a fake ``cloudflared``, the information and telemetry routes,
and one real boot: a ``serve --device cpu`` worker launched through
``launch_worker``, ready, serving one prompt whose trace the master
assembles across both processes, then stopped."""

import asyncio
import json
import os
import re
import socket
import stat
import sys
import textwrap
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from comfyui_distributed_tpu.api import config_routes as jax_config_routes
from comfyui_distributed_tpu.utils import config as jconfig
from comfyui_distributed_tpu.utils import tunnel as jtunnel
from comfyui_distributed_tpu_torch import telemetry
from comfyui_distributed_tpu_torch.api.app import App, Request, ServerThread
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.utils import config as pconfig
from comfyui_distributed_tpu_torch.utils import tunnel as ptunnel
from comfyui_distributed_tpu_torch.utils.exceptions import TunnelError
from comfyui_distributed_tpu_torch.utils.image import encode_png

ROOT = Path(__file__).resolve().parents[1]
PORT_WEB = ROOT / "comfyui_distributed_tpu_torch" / "web"
JAX_WEB = ROOT / "comfyui_distributed_tpu" / "web"
START = {"master": {"port": 8288, "host": ""},
         "hosts": [{"id": "w0", "address": "http://127.0.0.1:8189",
                    "enabled": True, "type": "local"},
                   {"id": "r0", "address": "10.0.0.9:8189", "type": "remote"}],
         "settings": {"debug": False}, "custom": {"kept": 1}}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.delenv("CDT_AUTH_TOKEN", raising=False)
    monkeypatch.delenv("CLOUDFLARED_PATH", raising=False)
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
    monkeypatch.setenv("CDT_CLOUDFLARED_AUTO_DOWNLOAD", "0")
    monkeypatch.setenv("CDT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("CDT_PROFILE_DIR", str(tmp_path / "profiles"))
    monkeypatch.setattr(ptunnel, "_local_bin_path",
                        lambda: tmp_path / "bin" / "cloudflared")
    monkeypatch.setattr(ptunnel.shutil, "which", lambda _: None)
    monkeypatch.setattr(ptunnel, "_manager", None)


def make_app(tmp_path, cfg=None) -> App:
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg if cfg is not None else START))
    return App(Controller(path, device="cpu"))


def call(app: App, method: str, path: str, payload=None, headers=None,
         query=None):
    hdrs = {"content-type": "application/json"} if method == "POST" else {}
    hdrs.update({k.lower(): v for k, v in (headers or {}).items()})
    body = json.dumps(payload).encode() if payload is not None else b""
    resp = asyncio.run(app.dispatch(Request(method, path, hdrs, body,
                                            query=query or {})))
    return resp


# --- config routes: the same file as the JAX handlers ---------------------------


class _Router:
    def __init__(self):
        self.handlers = {}

    def add_get(self, path, fn):
        self.handlers[("GET", path)] = fn

    def add_post(self, path, fn):
        self.handlers[("POST", path)] = fn


class _JaxRequest:
    def __init__(self, body):
        self._body = body

    async def json(self):
        return self._body


def jax_config_call(path: Path, route: str, body) -> int:
    """Run the JAX package's handler for ``route`` on ``path``; the
    status, 400 when it raises its ValidationError."""
    from comfyui_distributed_tpu.utils.exceptions import ValidationError

    class Ctl:
        config_path = path

        def load_config(self):
            return jconfig.load_config(path)

    router = _Router()
    jax_config_routes.register(router, Ctl())
    try:
        resp = asyncio.run(router.handlers[("POST", route)](_JaxRequest(body)))
    except ValidationError:
        return 400
    return resp.status


CONFIG_CASES = [
    ("update_worker", {"id": "w5", "address": "http://h:1", "enabled": True,
                       "type": "local"}, 200),
    ("update_worker", {"id": "w0", "enabled": False, "name": "renamed",
                       "extra_args": "--x 1"}, 200),
    ("update_worker", {"id": "w0", "type": "tpu"}, 400),
    ("update_worker", {"id": "w0", "port": 1}, 400),
    ("update_worker", {"address": "x"}, 400),
    ("delete_worker", {"id": "r0"}, 200),
    ("delete_worker", {"id": "nope"}, 404),
    ("update_setting", {"key": "debug", "value": True}, 200),
    ("update_setting", {"key": "worker_timeout_seconds", "value": 30.5}, 200),
    ("update_setting", {"key": "worker_probe_concurrency", "value": True}, 400),
    ("update_setting", {"key": "auth_token", "value": 5}, 400),
    ("update_setting", {"key": "nope", "value": 1}, 400),
    ("update_master", {"port": 9000, "host": "10.0.0.1"}, 200),
    ("update_master", {"color": "red"}, 400),
    ("auto_populate", {}, 200),
]


@pytest.mark.parametrize("route,body,status", CONFIG_CASES,
                         ids=[f"{r}-{i}" for i, (r, _, _) in enumerate(CONFIG_CASES)])
def test_config_route_leaves_the_jax_config_file(route, body, status, tmp_path):
    app = make_app(tmp_path)
    jpath = tmp_path / "jax.json"
    jpath.write_text(json.dumps(START))
    jconfig.invalidate_cache()
    assert jax_config_call(jpath, f"/distributed/config/{route}", body) == status
    resp = call(app, "POST", f"/distributed/config/{route}", body)
    assert resp.status == status, resp.payload
    got = json.loads((tmp_path / "cfg.json").read_text())
    assert got == json.loads(jpath.read_text())
    if status == 400:                       # refused before the transaction
        assert got == START
    if route == "auto_populate":
        assert resp.payload == {"status": "ok", "added": [], "total_hosts": 2}


def test_get_config_and_update_mesh(tmp_path):
    app = make_app(tmp_path)
    resp = call(app, "GET", "/distributed/config")
    assert resp.status == 200 and resp.payload["custom"] == {"kept": 1}
    assert resp.payload == jconfig._deep_merge(jconfig.DEFAULT_CONFIG, {
        **START, "hosts": [jconfig.normalize_host(h) for h in START["hosts"]]})
    # a device mesh is ported (ROADMAP A.6b i): a good shape is written
    # to mesh.shape, a bad one answers 400 as in the JAX package
    resp = call(app, "POST", "/distributed/config/update_mesh",
                {"shape": {"dp": 2}})
    assert resp.status == 200 and resp.payload == {"status": "ok"}
    assert call(app, "GET", "/distributed/config").payload["mesh"][
        "shape"] == {"dp": 2}
    for bad in ({"dp": 0}, {"dp": -1, "sp": -1}, {}, "dp"):
        resp = call(app, "POST", "/distributed/config/update_mesh",
                    {"shape": bad})
        assert resp.status == 400, bad


# --- the dashboard ------------------------------------------------------------------


def api_client_calls(source: str) -> list[tuple[str, str]]:
    """(method, path) of each entry of the client's ``api`` object (an
    entry may span lines), ids filled in as ``w0``."""
    body = source[source.index("export const api = {"):]
    body = body[:body.index("\n};")]
    calls = []
    for entry in re.split(r"\n(?=  \w+:)", body)[1:]:
        m = re.search(r"""["`](/(?:distributed|upload)/[^"`?]*)""", entry)
        if m:
            method = "POST" if 'method: "POST"' in entry else "GET"
            calls.append((method, re.sub(r"\$\{[^}]*\}", "w0", m.group(1))))
    return calls


def test_the_dashboard_is_the_jax_one_with_the_ports_title():
    names = sorted(p.name for p in JAX_WEB.iterdir() if p.is_file()
                   and p.name != "package.json")
    assert sorted(p.name for p in PORT_WEB.iterdir()) == names
    for name in names:
        if name not in ("index.html", "main.js"):
            assert (PORT_WEB / name).read_bytes() == (JAX_WEB / name).read_bytes()
    assert "CUDA Distributed" in (PORT_WEB / "index.html").read_text()


def test_every_api_client_route_is_answered(tmp_path):
    calls = api_client_calls((PORT_WEB / "apiClient.js").read_text())
    assert len(calls) == 34, calls
    app = make_app(tmp_path)
    for method, path in calls:
        resp = call(app, method, path, {} if method == "POST" else None)
        assert resp.status != 405, (method, path, resp.payload)
        error = str(resp.payload.get("error") or "") if isinstance(
            resp.payload, dict) else ""
        assert not error.startswith("no route"), (method, path)
        if path.startswith("/distributed/tunnel/start"):
            assert resp.status == 503 and "cloudflared" in error
    # the profiler the loop above started is stopped by its own route
    assert call(app, "POST", "/distributed/profile/stop", {}).status == 409


def test_index_and_static_files_stay_in_web(tmp_path):
    app = make_app(tmp_path)
    resp = call(app, "GET", "/")
    assert resp.status == 200 and b"CUDA Distributed" in resp.payload
    assert resp.content_type.startswith("text/html")
    for name, ctype in (("main.js", "text/javascript"),
                        ("style.css", "text/css")):
        resp = call(app, "GET", f"/web/{name}")
        assert resp.status == 200 and resp.content_type.startswith(ctype)
        assert resp.payload == (PORT_WEB / name).read_bytes()
    for bad in ("/web/..", "/web/../api/app.py", "/web/.", "/web/nope.js",
                "/web/%2e%2e"):
        resp = call(app, "GET", bad)
        assert resp.status == 404, bad


def test_a_raw_request_cannot_leave_web(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(START))
    server = ServerThread(Controller(path, device="cpu"), port=0)
    try:
        for target in ("/web/..%2Fapi%2Fapp.py", "/web/%2E%2E",
                       "/web/..%2F..%2FREADME.md"):
            with socket.create_connection(("127.0.0.1", server.port), 10) as s:
                s.sendall(f"GET {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
                head = s.recv(200).split(b"\r\n", 1)[0]
            assert head == b"HTTP/1.1 404 Not Found", (target, head)
    finally:
        server.stop()


def test_cors_scope(tmp_path):
    app = make_app(tmp_path)
    for path in ("/distributed/health", "/distributed/metrics",
                 "/distributed/metrics.json", "/distributed/network_info",
                 "/prompt"):
        assert call(app, "GET", path).headers.get(
            "Access-Control-Allow-Origin") == "*", path
    for method, path in (("OPTIONS", "/distributed/config"),
                         ("POST", "/distributed/launch_worker"),
                         ("GET", "/distributed/managed_workers"),
                         ("GET", "/distributed/config")):
        resp = call(app, method, path, {} if method == "POST" else None)
        assert "Access-Control-Allow-Origin" not in resp.headers, path
    pconfig.update_config(lambda c: c["settings"].update(permissive_cors=True),
                          tmp_path / "cfg.json")
    assert call(app, "OPTIONS", "/distributed/config").headers[
        "Access-Control-Allow-Origin"] == "*"


def test_the_token_gates_reads_and_the_new_mutating_routes(tmp_path):
    cfg = json.loads(json.dumps(START))
    cfg["settings"]["auth_token"] = "s3cret"
    app = make_app(tmp_path, cfg)
    ok = {"X-CDT-Auth": "s3cret"}
    gated = [("GET", "/distributed/config"), ("GET", "/distributed/local_log"),
             ("GET", "/distributed/worker_log/w0"),
             ("GET", "/distributed/remote_worker_log/w0"),
             ("POST", "/distributed/launch_worker"),
             ("POST", "/distributed/stop_worker"),
             ("POST", "/distributed/worker/clear_launching"),
             ("POST", "/distributed/config/update_setting"),
             ("POST", "/distributed/config/auto_populate"),
             ("POST", "/distributed/profile/start"),
             ("POST", "/distributed/tunnel/start"),
             ("POST", "/distributed/tunnel/stop")]
    for method, path in gated:
        resp = call(app, method, path, {} if method == "POST" else None)
        assert resp.status == 401, path
    for method, path in (("GET", "/distributed/metrics"),
                         ("GET", "/distributed/managed_workers"),
                         ("GET", "/distributed/memory_stats")):
        assert call(app, method, path).status == 200, path
    assert call(app, "GET", "/distributed/config", headers=ok).status == 200
    resp = call(app, "POST", "/distributed/config/update_setting",
                {"key": "debug", "value": True}, headers=ok)
    assert resp.status == 200


# --- the tunnel ------------------------------------------------------------------------


@pytest.fixture
def fake_cloudflared(tmp_path, monkeypatch):
    script = tmp_path / "cloudflared"
    script.write_text(textwrap.dedent("""\
        #!/bin/sh
        echo "INF Thank you for trying Cloudflare Tunnel."
        echo "INF |  https://random-words-here.trycloudflare.com  |"
        sleep 30
    """))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CLOUDFLARED_PATH", str(script))
    return script


def test_tunnel_routes_against_a_fake_binary(tmp_path, fake_cloudflared):
    app = make_app(tmp_path)
    resp = call(app, "POST", "/distributed/tunnel/start", {})
    assert resp.payload == {"status": "started",
                            "url": "https://random-words-here.trycloudflare.com"}
    cfg = pconfig.load_config(tmp_path / "cfg.json")
    token = cfg["settings"]["auth_token"]            # armed before the URL
    assert cfg["master"]["host"] == resp.payload["url"]
    status = call(app, "GET", "/distributed/tunnel/status").payload
    assert status["running"] and status["binary"] == str(fake_cloudflared)
    assert call(app, "POST", "/distributed/tunnel/stop", {}).status == 401
    resp = call(app, "POST", "/distributed/tunnel/stop", {},
                headers={"X-CDT-Auth": token})
    assert resp.payload == {"status": "stopped"}
    assert pconfig.load_config(tmp_path / "cfg.json")["master"]["host"] == ""


def test_tunnel_start_without_binary_or_download_answers_503_at_once(tmp_path):
    app = make_app(tmp_path)
    t0 = time.monotonic()
    resp = call(app, "POST", "/distributed/tunnel/start", {})
    assert time.monotonic() - t0 < 1.0
    assert resp.status == 503
    assert "cloudflared binary not found" in resp.payload["error"]


def test_tunnel_download_with_a_fake_fetcher(tmp_path, monkeypatch):
    monkeypatch.setenv("CDT_CLOUDFLARED_AUTO_DOWNLOAD", "1")
    assert ptunnel._platform_asset() == jtunnel._platform_asset()
    urls = []

    def fetch(url):
        urls.append(url)
        return b"#!/bin/sh\necho fake\n"

    path = ptunnel.ensure_cloudflared(fetcher=fetch)
    assert Path(path) == tmp_path / "bin" / "cloudflared"
    assert os.access(path, os.X_OK)
    assert urls == [ptunnel.RELEASE_URL.format(
        version=jtunnel.PINNED_VERSION, asset=jtunnel._platform_asset())]
    # found now: no second fetch
    assert ptunnel.ensure_cloudflared(fetcher=lambda u: 1 / 0) == path
    monkeypatch.setenv("CDT_CLOUDFLARED_SHA256", "0" * 64)
    with pytest.raises(TunnelError, match="checksum mismatch"):
        ptunnel.download_cloudflared(fetcher=lambda u: b"payload")


# --- information and telemetry routes ----------------------------------------------


def test_information_routes(tmp_path, monkeypatch):
    from comfyui_distributed_tpu_torch.graph.node import NODE_REGISTRY

    app = make_app(tmp_path)
    nodes = call(app, "GET", "/distributed/object_info").payload["nodes"]
    assert set(nodes) == set(NODE_REGISTRY)
    assert nodes["SaveImage"]["output_node"] is True
    names = call(app, "GET", "/distributed/workflows").payload["workflows"]
    assert names == sorted(p.stem for p in (ROOT / "workflows").glob("*.json"))
    wf = call(app, "GET", "/distributed/workflows/distributed-txt2img").payload
    assert wf == json.loads((ROOT / "workflows" / "distributed-txt2img.json").read_text())
    assert call(app, "GET", "/distributed/workflows/..").status == 400
    assert call(app, "GET", "/distributed/workflows/nope").status == 404
    net = call(app, "GET", "/distributed/network_info").payload
    assert net["recommended_ip"] and net["devices"] == []
    assert call(app, "GET", "/distributed/memory_stats").payload == {"devices": []}
    log_file = tmp_path / "ctl.log"
    log_file.write_text("line one\nline two\n")
    monkeypatch.setenv("CDT_LOG_FILE", str(log_file))
    assert call(app, "GET", "/distributed/local_log").payload == {
        "log": "line one\nline two\n", "available": True}
    assert call(app, "GET", "/distributed/step_times").payload == {"prompts": []}
    assert call(app, "GET", "/distributed/trace/nope").status == 404


def test_metrics_routes_parse_and_count_requests(tmp_path):
    telemetry.REGISTRY.reset()
    app = make_app(tmp_path)
    call(app, "GET", "/distributed/health")
    call(app, "GET", "/distributed/nope")
    resp = call(app, "GET", "/distributed/metrics")
    assert resp.content_type.startswith("text/plain; version=0.0.4")
    samples = {}
    for line in resp.payload.decode().splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    assert samples['cdt_http_requests_total{method="GET",'
                   'path="/distributed/health",status="200"}'] == 1
    assert samples['cdt_http_requests_total{method="GET",'
                   'path="<unmatched>",status="404"}'] == 1
    doc = call(app, "GET", "/distributed/metrics.json").payload
    assert doc["format"] == "cdt.metrics.v1"
    assert "cdt_prompts_total" in doc["metrics"]


def test_profile_routes_on_the_cpu(tmp_path):
    app = make_app(tmp_path)
    assert call(app, "POST", "/distributed/profile/stop", {}).status == 409
    resp = call(app, "POST", "/distributed/profile/start",
                {"out": "../../evil name"})
    assert resp.payload == {"status": "tracing",
                            "out": str(tmp_path / "profiles" / "evil_name")}
    again = call(app, "POST", "/distributed/profile/start", {})
    assert again.status == 409 and "already running" in again.payload["error"]
    resp = call(app, "POST", "/distributed/profile/stop", {})
    assert resp.status == 200
    trace = json.loads(Path(resp.payload["trace"]).read_text())
    assert "traceEvents" in trace
    assert call(app, "POST", "/distributed/profile/start",
                {"out": 3}).status == 400


# --- one real boot ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, path, payload=None, timeout=30):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


def _json(port, path, payload=None):
    status, body = _http(port, path, payload)
    return status, json.loads(body)


def test_launch_ready_serve_trace_and_stop_a_real_worker(tmp_path, monkeypatch):
    import numpy as np

    from comfyui_distributed_tpu_torch.utils.process import is_process_alive

    master_port, worker_port = _free_port(), _free_port()
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "master": {"host": "127.0.0.1", "port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "local", "enabled": True}],
        "settings": {"stop_workers_on_master_exit": True}}))
    inputs = tmp_path / "in"
    inputs.mkdir()
    (inputs / "input.png").write_bytes(encode_png(
        np.random.default_rng(0).random((1, 12, 10, 3), np.float32)))
    monkeypatch.setenv("CDT_INPUT_DIR", str(inputs))
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("CDT_MONITOR_POLL", "0.2")
    telemetry.SPAN_STORE.reset()
    master = Controller(cfg_path, device="cpu")
    server = ServerThread(master, port=master_port)
    try:
        status, launched = _json(master_port, "/distributed/launch_worker",
                                 {"worker_id": "w0"})
        assert status == 200, launched
        status, again = _json(master_port, "/distributed/launch_worker",
                              {"worker_id": "w0"})
        assert status == 409 and "already running" in again["error"]
        deadline = time.monotonic() + 90
        while True:
            workers = _json(master_port, "/distributed/managed_workers")[1]["workers"]
            assert "w0" in workers, "the worker died while booting"
            if not workers["w0"]["launching"]:
                break
            assert time.monotonic() < deadline, "no ready report"
            time.sleep(0.1)
        assert _json(worker_port, "/distributed/health")[1]["role"] == "worker"
        prompt = {"1": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
                  "2": {"class_type": "DistributedCollector",
                        "inputs": {"images": ["1", 0]}},
                  "3": {"class_type": "SaveImage",
                        "inputs": {"images": ["2", 0], "filename_prefix": "m"}}}
        status, answer = _json(master_port, "/distributed/queue", {"prompt": prompt})
        assert status == 200 and answer["worker_count"] == 1, answer
        while True:
            status, entry = _json(master_port,
                                  f"/distributed/history/{answer['prompt_id']}")
            if status == 200:
                break
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert entry["status"] == "success", entry
        assert len(list((tmp_path / "out").glob("m_*.png"))) == 2
        # the master's trace holds its orchestration and the worker's
        # execution, fetched from the worker, under the dispatch span
        status, trace = _json(master_port,
                              f"/distributed/trace/{answer['prompt_id']}")
        assert status == 200 and trace["trace_id"] == answer["trace_id"]
        by_id = {s["span_id"]: s for s in trace["spans"]}
        names = [s["name"] for s in trace["spans"]]
        assert "orchestrate" in names and names.count("prompt.execute") == 2
        worker_exec = [s for s in trace["spans"] if s["name"] == "prompt.execute"
                       and s["attrs"]["prompt_id"] != answer["prompt_id"]]
        assert len(worker_exec) == 1
        assert by_id[worker_exec[0]["parent_id"]]["name"] == "dispatch"
        assert trace["tree"][0]["name"] == "orchestrate"
        status, wtrace = _json(worker_port,
                               f"/distributed/trace/{answer['trace_id']}?local=1")
        assert {s["span_id"] for s in wtrace["spans"]} == {worker_exec[0]["span_id"]}
        status, metrics = _http(worker_port, "/distributed/metrics")
        assert b'cdt_prompts_total{status="success"} 1' in metrics
        log = _json(master_port, "/distributed/worker_log/w0")[1]
        assert log["available"] and "controller up as worker on cpu" in log["log"]
        monitor_pid = launched["pid"]
        status, stopped = _json(master_port, "/distributed/stop_worker",
                                {"worker_id": "w0"})
        assert (status, stopped) == (200, {"status": "stopped"})
        assert _json(master_port, "/distributed/managed_workers")[1] == {"workers": {}}
        assert not is_process_alive(monitor_pid)
        with pytest.raises(OSError):
            _http(worker_port, "/distributed/health", timeout=2)
    finally:
        master.worker_manager.cleanup_all()
        server.stop()
