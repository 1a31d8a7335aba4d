"""The port's WebSocket dispatch channel on the CPU: the RFC 6455 module
against the RFC's own frame and handshake vectors, the worker's
``/distributed/worker_ws`` route, ``dispatch_prompt_ws`` and its HTTP
fallback (only when the connection never opened), and the served FLUX
workflow (``flux-tiny``) over the WebSocket with the auth token and a
fault plan that blocks the HTTP dispatch, as ``chip_smoke.py`` serves it
on the card."""

import asyncio
import json
import socket
import struct
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster import dispatch, faults, resilience
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.graph.executor import strip_meta
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.utils import websocket as ws
from comfyui_distributed_tpu_torch.utils.exceptions import WorkerError
from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0
EMPTY = {"1": {"class_type": "DistributedEmptyImage",
               "inputs": {"height": 8, "width": 8}}}


@pytest.fixture(autouse=True)
def _fresh_resilience():
    resilience.BREAKERS.reset()
    faults.deactivate()
    yield
    resilience.BREAKERS.reset()
    faults.deactivate()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def read(wire: bytes, expect_masked: bool) -> ws.Frame:
    """One frame read off a stream that holds ``wire``."""
    async def body():
        r = asyncio.StreamReader()
        r.feed_data(wire)
        r.feed_eof()
        return await ws.read_frame(r, expect_masked)
    return asyncio.run(body())


# --- RFC 6455 vectors -----------------------------------------------------------

HELLO = b"Hello"
MASK = bytes.fromhex("37fa213d")


def test_accept_key_of_the_rfc_example():
    # RFC 6455 §1.3
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("opcode,payload,mask,fin,wire", [
    # RFC 6455 §5.7
    (ws.OP_TEXT, HELLO, None, True, bytes.fromhex("810548656c6c6f")),
    (ws.OP_TEXT, HELLO, MASK, True, bytes.fromhex("818537fa213d7f9f4d5158")),
    (ws.OP_TEXT, b"Hel", None, False, bytes.fromhex("010348656c")),
    (ws.OP_CONT, b"lo", None, True, bytes.fromhex("80026c6f")),
    (ws.OP_PING, HELLO, None, True, bytes.fromhex("890548656c6c6f")),
    (ws.OP_PONG, HELLO, MASK, True, bytes.fromhex("8a8537fa213d7f9f4d5158")),
    (ws.OP_BINARY, bytes(256), None, True, bytes.fromhex("827e0100") + bytes(256)),
    (ws.OP_BINARY, bytes(65536), None, True,
     bytes.fromhex("827f0000000000010000") + bytes(65536)),
], ids=["text", "masked-text", "first-fragment", "last-fragment", "ping",
        "masked-pong", "16-bit-length", "64-bit-length"])
def test_frames_match_the_rfc_vectors(opcode, payload, mask, fin, wire):
    assert ws.encode_frame(opcode, payload, mask, fin) == wire
    frame = read(wire, mask is not None)
    assert frame == ws.Frame(fin, opcode, payload)


@pytest.mark.parametrize("n", [125, 126, 65535, 65536, 70001])
def test_length_forms_round_trip_masked(n):
    payload = bytes(range(256)) * (n // 256) + bytes(n % 256)
    wire = ws.encode_frame(ws.OP_BINARY, payload, MASK)
    frame = read(wire, True)
    assert frame.payload == payload


@pytest.mark.parametrize("wire,expect_masked,match", [
    (bytes.fromhex("810548656c6c6f"), True, "mask"),        # client unmasked
    (bytes.fromhex("818537fa213d7f9f4d5158"), False, "mask"),
    (bytes.fromhex("c10548656c6c6f"), False, "reserved"),
    (bytes.fromhex("097e007e") + bytes(126), False, "control"),
    (bytes.fromhex("0900"), False, "control"),              # fragmented ping
    (bytes.fromhex("830548656c6c6f"), False, "opcode"),
], ids=["unmasked-from-client", "masked-from-server", "rsv", "long-ping",
        "fragmented-ping", "opcode"])
def test_frames_the_rfc_forbids_are_refused(wire, expect_masked, match):
    with pytest.raises(ws.WebSocketError, match=match):
        read(wire, expect_masked)


def test_server_handshake_checks_the_upgrade():
    good = {"upgrade": "websocket", "connection": "keep-alive, Upgrade",
            "sec-websocket-version": "13",
            "sec-websocket-key": "dGhlIHNhbXBsZSBub25jZQ=="}
    assert ws.server_handshake(good)["Sec-WebSocket-Accept"] == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    for field, value in (("upgrade", "h2c"), ("connection", "close"),
                         ("sec-websocket-version", "8"),
                         ("sec-websocket-key", "short")):
        with pytest.raises(ws.WebSocketError):
            ws.server_handshake({**good, field: value})


# --- a connection between two ends ------------------------------------------------


async def _pair(heartbeat=None):
    """A server and a client WebSocket over a loopback socket pair."""
    server_done = asyncio.get_running_loop().create_future()

    async def accept(reader, writer):
        server_done.set_result(ws.WebSocket(reader, writer, client=False,
                                            heartbeat=heartbeat))

    srv = await asyncio.start_server(accept, "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    client = ws.WebSocket(reader, writer, client=True)
    server = await server_done
    return srv, server, client


def test_messages_pings_fragments_and_close():
    async def body():
        srv, server, client = await _pair()
        try:
            await client.send_str("dispatch ✓")
            assert await server.receive(timeout=5) == ws.Message("text", "dispatch ✓")
            # a fragmented message with a ping between its fragments
            client._writer.write(
                ws.encode_frame(ws.OP_TEXT, b"ab", MASK, fin=False)
                + ws.encode_frame(ws.OP_PING, b"hb", MASK)
                + ws.encode_frame(ws.OP_CONT, b"cd", MASK))
            assert await server.receive(timeout=5) == ws.Message("text", "abcd")
            await server.ping(b"p")
            await client.send_str("after ping")
            # the client answered the ping on its way to the message
            assert await server.receive(timeout=5) == ws.Message("text", "after ping")
            assert server._pong.is_set() is False       # the ping was ours
            await client.close()
            msg = await server.receive(timeout=5)
            assert msg == ws.Message("close", ws.CLOSE_NORMAL)
            assert client.closed and server.closed
        finally:
            srv.close()
            await srv.wait_closed()
    asyncio.run(body())


def test_heartbeat_drops_a_silent_peer_and_keeps_a_live_one():
    async def body():
        srv, server, client = await _pair(heartbeat=1.0)
        try:
            live = asyncio.ensure_future(client.receive())   # answers pings
            serving = asyncio.ensure_future(server.receive())
            await asyncio.sleep(2.5)                         # two pings
            assert not server.closed
            live.cancel()
            for _ in range(60):                              # no pongs now
                if server.closed:
                    break
                await asyncio.sleep(0.1)
            assert server.closed
            assert (await asyncio.wait_for(serving, 5)).kind == "close"
        finally:
            client._drop()
            srv.close()
            await srv.wait_closed()
    asyncio.run(body())


# --- dispatch over the worker's route ------------------------------------------------


@pytest.fixture
def worker(tmp_path, monkeypatch):
    """A CPU worker controller on a loopback port."""
    (tmp_path / "worker.json").write_text("{}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "w0")
        controller = Controller(tmp_path / "worker.json", device="cpu")
    server = ServerThread(controller)
    try:
        yield controller, {"id": "w0",
                           "address": f"http://127.0.0.1:{server.port}"}
    finally:
        server.stop()


def wait_history(controller, prompt_id: str) -> dict:
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        entry = controller.queue.history.get(prompt_id)
        if entry is not None:
            return entry
        time.sleep(0.02)
    raise TimeoutError(prompt_id)


def test_dispatch_over_the_websocket_queues_on_the_worker(worker):
    controller, host = worker
    ack = asyncio.run(dispatch.dispatch_prompt_ws(host, EMPTY, "c1",
                                                  {"trace_id": "t1"}))
    assert ack["type"] == "dispatch_ack" and ack["ok"] is True
    assert ack["node_errors"] == [] and ack["prompt_id"]
    assert wait_history(controller, ack["prompt_id"])["status"] == "success"


def test_a_nack_raises_and_counts_for_the_host(worker):
    _, host = worker
    bad = {"1": {"class_type": "NoSuchNode", "inputs": {}}}
    with pytest.raises(WorkerError, match="rejected") as info:
        asyncio.run(dispatch.dispatch_prompt_ws(host, bad))
    assert info.value.client_rejected is True
    assert not getattr(info.value, "ws_undelivered", False)
    for _ in range(resilience.BREAKERS.get("w0").failure_threshold + 1):
        with pytest.raises(WorkerError):
            asyncio.run(dispatch.dispatch_prompt(host, bad, via_ws=True))
    assert resilience.BREAKERS.state("w0") == resilience.CLOSED


def test_the_route_refuses_a_plain_get_and_unknown_messages(worker):
    _, host = worker
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(host["address"] + "/distributed/worker_ws",
                               timeout=WAIT_S)
    assert info.value.code == 400
    info.value.close()

    async def body():
        conn = await ws.connect(host["address"] + "/distributed/worker_ws")
        try:
            await conn.send_str("{not json")
            assert json.loads((await conn.receive(5)).data)["error"] == "invalid JSON"
            await conn.send_str(json.dumps({"type": "hello"}))
            assert "unknown type" in json.loads((await conn.receive(5)).data)["error"]
            await conn.send_str(json.dumps({"type": "dispatch_prompt"}))
            ack = json.loads((await conn.receive(5)).data)
            assert ack["type"] == "dispatch_ack" and ack["ok"] is False
            assert ack["prompt_id"] == "" and ack["node_errors"]
        finally:
            await conn.close()
    asyncio.run(body())


def test_an_unopened_connection_falls_back_to_http(worker, monkeypatch):
    controller, host = worker
    # the peer lacks the route: the handshake is refused, nothing delivered
    monkeypatch.setattr(dispatch, "build_host_url",
                        lambda h, path: h["address"] + path.replace(
                            "worker_ws", "no_such_ws"))
    answer = asyncio.run(dispatch.dispatch_prompt(host, EMPTY, via_ws=True))
    assert wait_history(controller, answer["prompt_id"])["status"] == "success"
    monkeypatch.undo()
    # a dropped connect (the fault plan's first dispatch call) likewise
    plan = faults.activate(faults.FaultPlan.parse("dispatch@0:drop"))
    answer = asyncio.run(dispatch.dispatch_prompt(host, EMPTY, via_ws=True))
    assert plan.calls == {"dispatch": 2} and plan.injected == [("dispatch", 0, "drop")]
    assert wait_history(controller, answer["prompt_id"])["status"] == "success"


def test_a_lost_ack_fails_hard_without_http():
    """The worker took the message and closed without an ack: the prompt
    may be queued there, so no HTTP send follows."""
    seen = []

    async def body():
        async def peer(reader, writer):
            request = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
            seen.append(request.split(" ")[1])
            if "worker_ws" not in request:
                writer.close()
                return
            key = next(line.split(":", 1)[1].strip()
                       for line in request.split("\r\n")
                       if line.lower().startswith("sec-websocket-key"))
            writer.write(("HTTP/1.1 101 Switching Protocols\r\n"
                          "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                          f"Sec-WebSocket-Accept: {ws.accept_key(key)}\r\n\r\n")
                         .encode())
            await ws.read_frame(reader, True)                # the prompt
            writer.write(ws.encode_frame(ws.OP_CLOSE, struct.pack(">H", 1011)))
            await writer.drain()
            writer.close()

        srv = await asyncio.start_server(peer, "127.0.0.1", 0)
        host = {"id": "wl", "address":
                f"http://127.0.0.1:{srv.sockets[0].getsockname()[1]}"}
        try:
            with pytest.raises(WorkerError, match="closed before ack") as info:
                await dispatch.dispatch_prompt(host, EMPTY, via_ws=True)
            assert not getattr(info.value, "ws_undelivered", False)
        finally:
            srv.close()
            await srv.wait_closed()
    asyncio.run(body())
    assert seen == ["/distributed/worker_ws"]
    assert resilience.BREAKERS.get("wl").failures == 1


# --- FLUX served over the WebSocket, as chip_smoke.py serves it ---------------------

FLUX_STEPS = 3
TOKEN = "ws-test-token"


def flux_prompt(seed: int, prefix: str = "flux") -> dict:
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "flux-txt2img.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "flux-tiny"
    prompt["3"]["inputs"]["seed"] = seed
    prompt["4"]["inputs"].update(width=16, height=16, steps=FLUX_STEPS)
    prompt["6"]["inputs"]["filename_prefix"] = prefix
    return prompt


def call(port: int, path: str, payload=None, token: str | None = None):
    data = json.dumps(payload).encode() if payload is not None else None
    headers = {"Content-Type": "application/json"}
    if token:
        headers["X-CDT-Auth"] = token
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


def test_flux_served_over_the_websocket_with_token_and_faults(tmp_path,
                                                               monkeypatch):
    registry = ModelRegistry("cpu", seed=0)
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(tmp_path / "direct")})
    direct = {s: to_uint8(executor.execute(flux_prompt(s))["4"][0])[0]
              for s in (1234, 1235)}
    master_port, worker_port = free_port(), free_port()
    (tmp_path / "worker.json").write_text("{}")
    (tmp_path / "master.json").write_text(json.dumps({
        "master": {"port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "local", "enabled": True}],
        "settings": {"websocket_orchestration": True}}))
    monkeypatch.setenv("CDT_AUTH_TOKEN", TOKEN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "w0")
        worker = Controller(tmp_path / "worker.json", device="cpu",
                            model_registry=registry)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
        master = Controller(tmp_path / "master.json", device="cpu",
                            model_registry=registry)
    servers = []
    try:
        servers.append(ServerThread(worker, port=worker_port))
        servers.append(ServerThread(master, port=master_port))
        status, _ = call(master_port, "/distributed/queue",
                         {"prompt": flux_prompt(1234)})
        assert status == 401
        plan = faults.activate(faults.FaultPlan.parse("dispatch@1-9:http500"))
        status, body = call(master_port, "/distributed/queue",
                            {"prompt": flux_prompt(1234)}, TOKEN)
        answer = json.loads(body)
        assert status == 200 and answer["worker_count"] == 1, answer
        pid = answer["prompt_id"]
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            status, body = call(master_port, f"/distributed/history/{pid}")
            if status == 200 and json.loads(body)["status"] != "pending":
                break
            time.sleep(0.05)
        assert json.loads(body)["status"] == "success", body
        assert plan.calls["dispatch"] == 1 and plan.injected == []
        status, body = call(master_port, f"/distributed/progress/{pid}")
        snap = json.loads(body)
        assert status == 200 and snap["step"] == snap["total"] == FLUX_STEPS
        assert snap["done"] and not snap["failed"]
        status, png = call(master_port, f"/distributed/preview/{pid}")
        ds = registry.get("flux-tiny").pipeline.vae.config.downscale
        assert status == 200 and decode_png(png).shape == (16 // ds, 16 // ds, 3)
        pngs = sorted((tmp_path / "out").glob("flux_*.png"))
        assert len(pngs) == 2
        got = [to_uint8(decode_png(p.read_bytes()))[0] for p in pngs]
        np.testing.assert_array_equal(got[0], direct[1234])
        np.testing.assert_array_equal(got[1], direct[1235])
    finally:
        faults.deactivate()
        for server in reversed(servers):
            server.stop()
