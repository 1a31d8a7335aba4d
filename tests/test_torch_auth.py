"""The auth token and the CORS rules on the port's control plane: the gate
table of ``tests/test_auth.py`` (policy, env over config, header and
bearer, a non-ASCII credential), run on both packages' ``utils/auth.py``
and on the port's ``App`` over loopback; outbound peer calls carry the
token; the CORS scope of ``tests/test_web.py``."""

import json
import socket
import urllib.error
import urllib.request

import pytest

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster import dispatch, resilience
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.utils import auth as tauth
from comfyui_distributed_tpu_torch.utils import network, websocket
from comfyui_distributed_tpu_torch.utils.config import update_config
from comfyui_distributed_tpu_torch.utils.exceptions import WorkerError

EMPTY = {"1": {"class_type": "DistributedEmptyImage",
               "inputs": {"height": 8, "width": 8}}}


def packages():
    """The port's auth module and, where it imports, the JAX package's."""
    mods = [pytest.param(tauth, id="port")]
    try:
        from comfyui_distributed_tpu.utils import auth as jauth
        mods.append(pytest.param(jauth, id="jax"))
    except ImportError:
        pass
    return mods


@pytest.fixture(autouse=True)
def _no_token(monkeypatch):
    monkeypatch.delenv(tauth.AUTH_ENV, raising=False)
    resilience.BREAKERS.reset()
    yield
    resilience.BREAKERS.reset()


# --- the policy, in both packages ----------------------------------------------


@pytest.mark.parametrize("auth", packages())
def test_gets_open_posts_gated(auth):
    assert not auth.requires_auth("GET", "/distributed/health")
    assert not auth.requires_auth("GET", "/distributed/progress/p1")
    assert not auth.requires_auth("GET", "/distributed/preview/p1")
    assert not auth.requires_auth("OPTIONS", "/distributed/queue")
    assert auth.requires_auth("POST", "/distributed/queue")
    assert auth.requires_auth("POST", "/distributed/interrupt")
    assert auth.requires_auth("POST", "/distributed/launch_worker")
    assert auth.requires_auth("POST", "/upload/image")
    assert auth.requires_auth("GET", "/distributed/config")
    assert auth.requires_auth("GET", "/distributed/local_log")
    assert auth.requires_auth("GET", "/distributed/worker_log/w0")
    assert auth.requires_auth("GET", "/distributed/remote_worker_log/w0")


def test_the_dispatch_websocket_is_gated_in_the_port_only():
    """A departure: the route enqueues prompts, and the JAX package leaves
    it open because its opening request is a GET."""
    assert tauth.requires_auth("GET", "/distributed/worker_ws")


@pytest.mark.parametrize("auth", packages())
@pytest.mark.parametrize("headers,ok", [
    ({"X-CDT-Auth": "t1"}, True),
    ({"Authorization": "Bearer t1"}, True),
    ({"X-CDT-Auth": "nope"}, False),
    ({}, False),
    ({"Authorization": "Basic t1"}, False),
    ({"X-CDT-Auth": "tokén"}, False),      # non-ASCII: 401, not 500
], ids=["header", "bearer", "wrong", "none", "basic", "non-ascii"])
def test_token_matches(auth, headers, ok):
    assert auth.token_matches(headers, "t1") is ok


def test_the_port_matches_lower_case_header_names():
    assert tauth.token_matches({"x-cdt-auth": "t1"}, "t1")
    assert tauth.token_matches({"authorization": "Bearer t1"}, "t1")


def test_resolve_token_reads_env_then_config(tmp_path, monkeypatch):
    path = tmp_path / "config.json"
    assert tauth.resolve_token(path) is None
    path.write_text(json.dumps({"settings": {"auth_token": "cfg-tok"}}))
    assert tauth.resolve_token(path) == "cfg-tok"
    monkeypatch.setenv(tauth.AUTH_ENV, "env-tok")
    assert tauth.resolve_token(path) == "env-tok"


# --- the gate on the port's App ----------------------------------------------------


@pytest.fixture
def served(tmp_path):
    """A CPU controller on a loopback port; yields (port, config path)."""
    path = tmp_path / "config.json"
    path.write_text("{}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
        controller = Controller(path, device="cpu")
    server = ServerThread(controller)
    try:
        yield server.port, path
    finally:
        server.stop()


def call(port, path, payload=None, headers=None, method=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, dict(e.headers)


def enable(path, token="secret-token"):
    update_config(lambda cfg: cfg.setdefault("settings", {})
                  .__setitem__("auth_token", token), path)


def test_mutating_401_without_token(served):
    port, path = served
    enable(path)
    assert call(port, "/prompt", {"prompt": EMPTY})[0] == 401
    assert call(port, "/distributed/queue", {"prompt": {"1": {}}})[0] == 401
    assert call(port, "/distributed/interrupt", {})[0] == 401
    assert call(port, "/distributed/config")[0] == 401       # a gated read
    # the 415 of a wrong content type comes first, as in the JAX package
    assert call(port, "/prompt", {}, {"Content-Type": "text/plain"})[0] == 415


def test_mutating_200_with_header_or_bearer(served):
    port, path = served
    enable(path)
    assert call(port, "/prompt", {"prompt": EMPTY},
                {"X-CDT-Auth": "secret-token"})[0] == 200
    assert call(port, "/distributed/clear_memory", {},
                {"Authorization": "Bearer secret-token"})[0] == 200
    # past the gate, the gated read answers
    assert call(port, "/distributed/config", None,
                {"Authorization": "Bearer secret-token"})[0] == 200


def test_probes_and_reads_stay_open(served):
    port, path = served
    enable(path)
    for route in ("/distributed/health", "/prompt", "/distributed/system_info"):
        assert call(port, route)[0] == 200, route
    assert call(port, "/distributed/progress/none")[0] == 404


def test_no_token_configured_everything_open(served):
    port, _ = served
    assert call(port, "/prompt", {"prompt": EMPTY})[0] == 200


def test_env_token_gates_without_config(served, monkeypatch):
    port, _ = served
    monkeypatch.setenv(tauth.AUTH_ENV, "env-tok")
    assert call(port, "/distributed/clear_memory", {})[0] == 401
    assert call(port, "/distributed/clear_memory", {},
                {"X-CDT-Auth": "env-tok"})[0] == 200


def test_the_dispatch_websocket_needs_the_token(served):
    import asyncio

    port, path = served
    enable(path)
    url = f"http://127.0.0.1:{port}/distributed/worker_ws"
    with pytest.raises(websocket.WebSocketError, match="401"):
        asyncio.run(websocket.connect(url))

    async def with_token():
        conn = await websocket.connect(url, {tauth.AUTH_HEADER: "secret-token"})
        await conn.close()
    asyncio.run(with_token())


# --- outbound calls carry the token -------------------------------------------------


def test_outbound_calls_carry_the_token_and_follow_rotation(served, monkeypatch):
    """Master → worker dispatch under one cluster token: the port's
    transport attaches it to every outbound call, read at each call."""
    port, path = served
    monkeypatch.setenv(tauth.AUTH_ENV, "cluster-tok")
    host = {"id": "w0", "address": f"http://127.0.0.1:{port}"}
    import asyncio

    answer = asyncio.run(dispatch.dispatch_prompt(host, EMPTY))
    assert answer["prompt_id"]
    answer = asyncio.run(dispatch.dispatch_prompt(host, EMPTY, via_ws=True))
    assert answer["ok"] is True
    # the worker rotates to a token the caller does not have: refused, and
    # a 4xx counts for the host, not against it
    enable(path, "rotated")
    monkeypatch.delenv(tauth.AUTH_ENV)
    network.set_auth_config_path(path.parent / "elsewhere.json")
    try:
        with pytest.raises(WorkerError, match="401"):
            asyncio.run(dispatch.dispatch_prompt(host, EMPTY))
        assert resilience.BREAKERS.state("w0") == resilience.CLOSED
        network.set_auth_config_path(path)            # the same config again
        assert asyncio.run(dispatch.dispatch_prompt(host, EMPTY))["prompt_id"]
    finally:
        network.set_auth_config_path(None)


def test_no_token_no_header(monkeypatch):
    assert tauth.AUTH_HEADER not in network._with_token({"a": "b"})
    monkeypatch.setenv(tauth.AUTH_ENV, "t")
    assert network._with_token(None) == {tauth.AUTH_HEADER: "t"}


# --- CORS ------------------------------------------------------------------------------


def test_cors_scoped_to_readonly_probe_routes(served):
    port, _ = served
    for route in ("/distributed/health", "/prompt", "/distributed/system_info"):
        assert call(port, route)[1].get("Access-Control-Allow-Origin") == "*"
    status, headers = call(port, "/distributed/clear_memory", method="OPTIONS")
    assert status == 200 and "Access-Control-Allow-Origin" not in headers
    status, headers = call(port, "/distributed/interrupt", {})
    assert status == 200 and "Access-Control-Allow-Origin" not in headers
    assert "Access-Control-Allow-Origin" not in \
        call(port, "/distributed/progress/p")[1]


def test_cors_permissive_setting_restores_wildcard(served):
    port, path = served
    update_config(lambda cfg: cfg.setdefault("settings", {})
                  .__setitem__("permissive_cors", True), path)
    status, headers = call(port, "/distributed/interrupt", {})
    assert status == 200 and headers["Access-Control-Allow-Origin"] == "*"
    assert "X-CDT-Auth" in headers["Access-Control-Allow-Headers"]


def test_options_preflight_is_open_when_a_token_is_set(served):
    port, path = served
    enable(path)
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(b"OPTIONS /distributed/queue HTTP/1.1\r\nHost: x\r\n\r\n")
        head = s.recv(4096)
    assert head.startswith(b"HTTP/1.1 200")
