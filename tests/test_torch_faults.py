"""The port's fault plans against the JAX package's ``FaultPlan``: the
same specs parse to the same rules and, with the same seed, fire the
same faults on the same call indices. Then the port's injection point,
the urllib transport of ``utils/network.py``, over a real loopback
server: drop, latency, 5xx, silence, corrupt and truncate; the
job-store wrapper; and dispatch under a plan (a dropped connect is
re-sent, a 5xx is not)."""

import asyncio
import http.server
import json
import threading
import time
import urllib.error

import pytest

# The JAX half needs what the card's machine is not promised.
pytest.importorskip("aiohttp")

from comfyui_distributed_tpu.cluster import faults as jfaults  # noqa: E402
from comfyui_distributed_tpu_torch.cluster import dispatch, faults, resilience  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.job_store import JobStore  # noqa: E402
from comfyui_distributed_tpu_torch.utils import network  # noqa: E402
from comfyui_distributed_tpu_torch.utils.exceptions import WorkerError  # noqa: E402
from comfyui_distributed_tpu_torch.utils.multipart import (  # noqa: E402
    Part, build_multipart, parse_multipart)

SPECS = [
    "seed=7;probe@0-1:drop;submit@3:corrupt;heartbeat@*:silence;"
    "request_work@%0.25:http500=503;dispatch@0,2:latency=0.01",
    "seed=42;submit@%0.5:drop",
    "*@0:drop",
    "seed=3;collect@%0.3:truncate;dispatch@%0.7:http500;probe@1:latency",
    " ; probe@0:drop ;; ",
    "seed=11;store.request_work@0:drop;store.submit@0:silence;"
    "store.heartbeat@*:drop",
]
OPS = ["probe", "dispatch", "submit", "heartbeat", "request_work", "collect",
       "job_status", "http", "store.submit"]


@pytest.fixture(autouse=True)
def _fresh_resilience():
    resilience.BREAKERS.reset()
    faults.deactivate()
    yield
    resilience.BREAKERS.reset()
    faults.deactivate()


def rules(plan) -> list:
    return [(f.op, f.kind, f.indices, f.prob, f.value) for f in plan.faults]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_to_the_same_rules(spec):
    ours, theirs = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert ours.seed == theirs.seed and rules(ours) == rules(theirs)


@pytest.mark.parametrize("spec", SPECS)
def test_same_seed_fires_the_same_faults_on_the_same_calls(spec):
    """A seeded sequence of 400 calls over every operation, with a
    corrupted payload whenever a corrupt fires."""
    order = [OPS[(i * 7 + i // 3) % len(OPS)] for i in range(400)]
    ours, theirs = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    payload = bytes(range(256)) * 3
    for op in order:
        a, b = ours.next_fault(op), theirs.next_fault(op)
        assert (a is None) == (b is None)
        if a is not None and a.kind == "corrupt":
            assert ours.corrupt_bytes(payload) == theirs.corrupt_bytes(payload)
    assert ours.injected == theirs.injected and ours.calls == theirs.calls


@pytest.mark.parametrize("bad", [
    "probe@0", "probe@0:explode", "probe@x:drop", "probe@5-2:drop",
    "probe@%1.5:drop", "seed=abc"])
def test_malformed_specs_raise_in_both(bad):
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(faults.FaultSpecError):
        faults.FaultPlan.parse(bad)


@pytest.mark.parametrize("path", [
    "/distributed/health", "/prompt", "/distributed/worker_ws",
    "/distributed/request_image", "/distributed/submit_tiles",
    "/distributed/submit_image", "/distributed/heartbeat",
    "/distributed/job_complete_frames", "/distributed/job_complete",
    "/distributed/job_status?job_id=j", "/distributed/check_file",
    "/upload/image", "/whatever", "/distributed/queue"])
def test_operations_by_url_match(path):
    url = "http://h:1" + path
    assert faults.op_for_url(url) == jfaults.op_for_url(url)


def test_corrupt_flips_one_byte_and_truncate_halves():
    plan = faults.FaultPlan([], seed=3)
    data = bytes(range(64))
    bad = plan.corrupt_bytes(data)
    assert len(bad) == len(data) and sum(a != b for a, b in zip(data, bad)) == 1
    assert faults.FaultPlan.truncate_bytes(data) == data[:32]
    assert bad == jfaults.FaultPlan([], seed=3).corrupt_bytes(data)


def test_environment_activates_and_explicit_plans_override(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV, "seed=5;probe@0:drop")
    faults.deactivate()
    plan = faults.active_plan()
    assert plan is not None and plan.seed == 5 and plan is faults.active_plan()
    mine = faults.activate(faults.FaultPlan.parse("submit@0:drop"))
    assert faults.active_plan() is mine
    faults.deactivate()
    monkeypatch.delenv(faults.FAULTS_ENV)
    assert faults.active_plan() is None


# --- the urllib transport over a loopback server ---------------------------------


class Recorder(http.server.BaseHTTPRequestHandler):
    calls: list = []

    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        type(self).calls.append((self.path, dict(self.headers), body))
        out = json.dumps({"ok": True, "n": len(type(self).calls)}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    do_GET = do_POST = _answer

    def log_message(self, *args):
        pass


@pytest.fixture
def peer():
    Recorder.calls = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Recorder)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", Recorder.calls
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_drop_500_silence_never_reach_the_peer(peer):
    base, calls = peer
    plan = faults.activate(faults.FaultPlan.parse(
        "heartbeat@0:drop;heartbeat@1:http500=502;heartbeat@2:silence"))
    url = base + "/distributed/heartbeat"
    with pytest.raises(urllib.error.URLError) as info:
        network.http_request(url, b"{}")
    assert network.never_sent(info.value)
    assert network.http_request(url, b"{}")[0] == 502
    status, body = network.http_request(url, b"{}")
    assert status == 200 and json.loads(body)["status"] == "ok"
    assert calls == []
    status, body = network.http_request(url, b"{}")   # no fault left
    assert status == 200 and json.loads(body)["ok"] is True and len(calls) == 1
    assert [k for _, _, k in plan.injected] == ["drop", "http500", "silence"]


def test_latency_defers_but_delivers(peer):
    base, calls = peer
    faults.activate(faults.FaultPlan.parse("probe@0:latency=0.2"))
    t0 = time.monotonic()
    assert network.http_request(base + "/distributed/health")[0] == 200
    assert time.monotonic() - t0 >= 0.2 and len(calls) == 1


def test_corrupt_and_truncate_hit_the_frame_not_the_metadata(peer):
    base, calls = peer
    faults.activate(faults.FaultPlan.parse(
        "seed=9;submit@0:corrupt;submit@1:truncate;collect@0:truncate"))
    frame = bytes(range(256)) * 4
    meta = json.dumps({"job_id": "j"}).encode()
    url = base + "/distributed/submit_tiles"
    for _ in range(3):
        body, ctype = build_multipart([
            Part("tiles_metadata", meta, content_type="application/json"),
            Part("tile_0", frame, "tile_0.cdtf", "application/x-cdt-frame")])
        network.http_request(url, body, {"Content-Type": ctype,
                                         "X-CDT-Client": "1"})
    got = [parse_multipart(b, h["Content-Type"]) for _, h, b in calls]
    assert [p[0].data for p in got] == [meta] * 3       # metadata intact
    corrupted, truncated, intact = (p[1].data for p in got)
    assert len(corrupted) == len(frame)
    assert sum(a != b for a, b in zip(corrupted, frame)) == 1
    assert truncated == frame[:len(frame) // 2] and intact == frame
    network.http_request(base + "/distributed/job_complete", b'{"a": 1}',
                         {"Content-Type": "application/json"})
    assert calls[-1][2] == b'{"a": 1}'[:4]             # a raw body: halved


def test_the_faulty_job_store_consults_the_plan():
    async def body():
        plan = faults.FaultPlan.parse("store.request_work@0:drop;"
                                      "store.submit@0:silence;store.heartbeat@*:drop")
        store = faults.FaultyJobStore(JobStore(), plan)
        await store.init_tile_job("j", 2)
        assert await store.request_work("j", "w0") is None
        task = await store.request_work("j", "w0")
        assert task is not None
        assert not await store.submit_result("j", "w0", task["task_id"], {"x": 1})
        assert await store.submit_result("j", "w0", task["task_id"], {"x": 1})
        assert not await store.heartbeat("j", "w0")
    asyncio.run(body())


def test_dispatch_under_a_plan(peer, monkeypatch):
    """A dropped connect is provably unsent and is sent again; a 5xx after
    the send is not, and both outcomes feed the host's breaker."""
    monkeypatch.setenv("CDT_SEND_BACKOFF_BASE", "0.001")
    base, calls = peer
    host = {"id": "wf", "address": base}
    faults.activate(faults.FaultPlan.parse("dispatch@0:drop;dispatch@2:http500"))
    assert asyncio.run(dispatch.dispatch_prompt(host, {"1": {}}))["ok"] is True
    assert [p for p, _, _ in calls] == ["/prompt"]
    assert resilience.BREAKERS.get("wf").failures == 0
    with pytest.raises(WorkerError, match="500"):
        asyncio.run(dispatch.dispatch_prompt(host, {"1": {}}))
    assert len(calls) == 1 and resilience.BREAKERS.get("wf").failures == 1
