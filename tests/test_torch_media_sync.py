"""Media sync to remote hosts (``cluster/media_sync.py``), its three
routes (``/distributed/check_file``, ``/distributed/load_image``,
``/upload/image``) and the orchestration around it: the path helpers
against the JAX package's, ``sync_host_media`` against a live port
worker on localhost (upload on a miss, skip on an md5 match, a file
missing here, a failed upload, bounded concurrency), the token gate and
the containment test, and a prompt served to a ``remote`` worker with
an input directory of its own."""

import asyncio
import base64
import hashlib
import json
import socket
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster import faults, media_sync, resilience
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.utils.image import decode_png, encode_png
from comfyui_distributed_tpu_torch.utils.multipart import Part, build_multipart

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_resilience(monkeypatch):
    monkeypatch.setenv("CDT_SEND_BACKOFF_BASE", "0.001")
    resilience.BREAKERS.reset()
    faults.deactivate()
    yield
    resilience.BREAKERS.reset()
    faults.deactivate()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(port: int, path: str, payload=None, headers=None, body=None):
    data = body if body is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


# --- the path helpers against the JAX package ----------------------------------


PROMPTS = [
    {"1": {"class_type": "LoadImage", "inputs": {"image": "cat.png"}},
     "2": {"class_type": "CLIPTextEncode",
           "inputs": {"text": "a photo like foo.png", "clip": ["1", 0]}},
     "3": {"class_type": "LoadVideo", "inputs": {"video": "sub\\clip.MP4"}},
     "4": {"class_type": "X", "inputs": {"file": "a/b/c.npz",
                                         "filename": "two\nlines.png",
                                         "audio": 3}},
     "5": "not a node"},
    {"1": {"class_type": "LoadImage", "inputs": {"image": "in/dir\\x.webp"}}},
]


def _workflows():
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    return [strip_meta(json.loads(p.read_text()))
            for p in sorted((ROOT / "workflows").glob("*.json"))]


def test_find_media_refs_matches_jax():
    jms = pytest.importorskip("comfyui_distributed_tpu.cluster.media_sync")
    for prompt in PROMPTS + _workflows():
        ref = [tuple(vars(r).values()) if hasattr(r, "__dict__") else
               (r.node_id, r.input_key, r.value) for r in jms.find_media_refs(prompt)]
        out = [(r.node_id, r.input_key, r.value)
               for r in media_sync.find_media_refs(prompt)]
        assert out == [tuple(r) for r in ref]
    assert [r.value for r in media_sync.find_media_refs(PROMPTS[0])] == [
        "cat.png", "sub\\clip.MP4", "a/b/c.npz"]


@pytest.mark.parametrize("sep", ["/", "\\", ":"])
def test_convert_paths_for_platform_matches_jax(sep):
    jms = pytest.importorskip("comfyui_distributed_tpu.cluster.media_sync")
    for prompt in PROMPTS:
        before = json.dumps(prompt, sort_keys=True)
        out = media_sync.convert_paths_for_platform(prompt, sep)
        assert out == jms.convert_paths_for_platform(prompt, sep)
        assert json.dumps(prompt, sort_keys=True) == before      # not mutated
    if sep == "\\":
        out = media_sync.convert_paths_for_platform(PROMPTS[1], sep)
        assert out["1"]["inputs"]["image"] == "in\\dir\\x.webp"


# --- a live worker on localhost -------------------------------------------------


@pytest.fixture
def worker(tmp_path, monkeypatch):
    """A worker controller with its own input directory, and the master's
    input directory beside it."""
    port = free_port()
    (tmp_path / "w.json").write_text("{}")
    inbox, local = tmp_path / "worker_in", tmp_path / "master_in"
    inbox.mkdir()
    local.mkdir()
    with monkeypatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "r0")
        mp.setenv("CDT_INPUT_DIR", str(inbox))
        ctl = Controller(tmp_path / "w.json", device="cpu")
    server = ServerThread(ctl, port=port)
    try:
        yield {"port": port, "host": {"id": "r0",
                                      "address": f"http://127.0.0.1:{port}"},
               "inbox": inbox, "local": local, "root": tmp_path}
    finally:
        server.stop()


def _sync(worker, prompt, **kw):
    return asyncio.run(media_sync.sync_host_media(
        worker["host"], prompt, input_dir=worker["local"], **kw))


def _load(*names):
    return {str(i): {"class_type": "LoadImage", "inputs": {"image": n}}
            for i, n in enumerate(names, 1)}


def test_sync_uploads_on_a_miss_then_skips(worker):
    data = encode_png(np.random.default_rng(0).random((9, 7, 3)).astype(np.float32))
    (worker["local"] / "sub").mkdir()
    (worker["local"] / "sub" / "a.png").write_bytes(data)
    (worker["local"] / "b.png").write_bytes(b"other bytes")
    prompt = _load("sub/a.png", "b.png")
    out, report = _sync(worker, prompt, trace_id="t1")
    assert (report.checked, report.uploaded, report.skipped, report.missing,
            report.failed) == (2, 2, 0, 0, [])
    assert (worker["inbox"] / "sub" / "a.png").read_bytes() == data
    assert (worker["inbox"] / "b.png").read_bytes() == b"other bytes"
    assert out == prompt             # same separator on both sides
    _, again = _sync(worker, prompt)
    assert (again.uploaded, again.skipped) == (0, 2)
    # a changed file is a mismatch: uploaded again
    (worker["local"] / "b.png").write_bytes(b"changed")
    _, third = _sync(worker, prompt)
    assert (third.uploaded, third.skipped) == (1, 1)
    assert (worker["inbox"] / "b.png").read_bytes() == b"changed"


def test_sync_counts_a_missing_local_file(worker):
    _, report = _sync(worker, _load("absent.png"))
    assert (report.checked, report.missing, report.uploaded, report.failed) == (
        1, 1, 0, [])
    _, report = _sync(worker, {"1": {"class_type": "CLIPTextEncode",
                                     "inputs": {"text": "x.png"}}})
    assert report.checked == 0


def test_sync_reports_a_failed_upload(worker):
    (worker["local"] / "a.png").write_bytes(b"bytes")
    plan = faults.activate(faults.FaultPlan.parse("media@1-99:http500"))
    _, report = _sync(worker, _load("a.png"))
    assert report.failed == ["a.png"] and report.uploaded == 0
    # one check, then three upload attempts (the policy's bound)
    assert plan.calls.get("media") == 4
    assert not (worker["inbox"] / "a.png").exists()


def test_sync_against_an_unreachable_host_fails(worker):
    (worker["local"] / "a.png").write_bytes(b"bytes")
    host = {"id": "gone", "address": f"http://127.0.0.1:{free_port()}"}
    _, report = asyncio.run(media_sync.sync_host_media(
        host, _load("a.png"), input_dir=worker["local"], timeout=2.0))
    assert report.failed == ["a.png"]


def test_sync_concurrency_is_bounded(worker, monkeypatch):
    names = [f"f{i}.png" for i in range(7)]
    for n in names:
        (worker["local"] / n).write_bytes(n.encode())
    live, peak = [0], [0]

    async def check(host, rel, md5, timeout):
        live[0] += 1
        peak[0] = max(peak[0], live[0])
        await asyncio.sleep(0.05)
        live[0] -= 1
        return True

    monkeypatch.setattr(media_sync, "_check_remote_file", check)
    _, report = _sync(worker, _load(*names), concurrency=3)
    assert report.skipped == 7 and peak[0] == 3
    monkeypatch.setenv("CDT_MEDIA_SYNC_CONCURRENCY", "2")
    peak[0] = 0
    _sync(worker, _load(*names))
    assert peak[0] == 2


def test_path_separator_from_system_info(worker):
    sep = asyncio.run(media_sync.fetch_host_path_separator(worker["host"]))
    assert sep == "/"
    gone = {"id": "gone", "address": f"http://127.0.0.1:{free_port()}"}
    assert asyncio.run(media_sync.fetch_host_path_separator(gone, 2.0)) == "/"


# --- the routes -----------------------------------------------------------------


def test_check_file_and_load_image(worker):
    port = worker["port"]
    (worker["inbox"] / "d").mkdir()
    (worker["inbox"] / "d" / "x.png").write_bytes(b"pixels")
    md5 = hashlib.md5(b"pixels").hexdigest()
    assert call(port, "/distributed/check_file", {"path": "d/x.png"}) == (
        200, {"exists": True, "md5": md5, "matches": True})
    assert call(port, "/distributed/check_file",
                {"path": "d/x.png", "md5": "0" * 32})[1]["matches"] is False
    assert call(port, "/distributed/check_file", {"path": "nope.png"}) == (
        200, {"exists": False})
    status, body = call(port, "/distributed/load_image", {"path": "d/x.png"})
    assert status == 200 and body["md5"] == md5
    assert base64.b64decode(body["image"].split(",", 1)[1]) == b"pixels"
    assert body["image"].startswith("data:image/png;base64,")
    assert call(port, "/distributed/load_image", {"path": "nope.png"})[0] == 404
    for route in ("/distributed/check_file", "/distributed/load_image"):
        assert call(port, route, {})[0] == 400
        assert call(port, route, [1])[0] == 400


def _upload(port, name, data, headers=None, field="image"):
    body, ctype = build_multipart([Part(field, data, filename=name),
                                   Part("overwrite", b"true")])
    return call(port, "/upload/image", body=body,
                headers={"Content-Type": ctype, "X-CDT-Client": "1",
                         **(headers or {})})


def test_upload_image(worker):
    port = worker["port"]
    assert _upload(port, "new/dir/u.png", b"abc") == (200, {"saved": ["new/dir/u.png"]})
    assert (worker["inbox"] / "new" / "dir" / "u.png").read_bytes() == b"abc"
    assert _upload(port, "u.png", b"abc", field="other") == (200, {"saved": []})
    # a multipart POST without the peer header is refused (415)
    body, ctype = build_multipart([Part("image", b"x", filename="v.png")])
    assert call(port, "/upload/image", body=body,
                headers={"Content-Type": ctype})[0] == 415


def test_a_path_with_the_input_dirs_prefix_does_not_escape(worker):
    """``../<sibling whose name starts with the input directory's>/x`` is
    outside it: the JAX package's string-prefix test lets it through,
    the port's containment test answers 400."""
    port, inbox = worker["port"], worker["inbox"]
    sibling = inbox.parent / (inbox.name + "2")
    sibling.mkdir()
    (sibling / "x.png").write_bytes(b"secret")
    rel = f"../{sibling.name}/x.png"
    assert str((inbox / rel).resolve()).startswith(str(inbox.resolve()))
    for route in ("/distributed/check_file", "/distributed/load_image"):
        status, body = call(port, route, {"path": rel})
        assert status == 400 and "escapes" in body["error"]
        assert call(port, route, {"path": "../../etc/passwd"})[0] == 400
    status, body = _upload(port, rel, b"overwritten")
    assert status == 400 and (sibling / "x.png").read_bytes() == b"secret"
    assert _upload(port, "/abs.png", b"x")[0] == 400


def test_media_routes_need_the_token(worker, monkeypatch):
    port = worker["port"]
    (worker["inbox"] / "x.png").write_bytes(b"x")
    monkeypatch.setenv("CDT_AUTH_TOKEN", "s3cret")
    assert call(port, "/distributed/check_file", {"path": "x.png"})[0] == 401
    assert call(port, "/distributed/load_image", {"path": "x.png"})[0] == 401
    assert _upload(port, "y.png", b"y")[0] == 401
    ok = {"X-CDT-Auth": "s3cret"}
    assert call(port, "/distributed/check_file", {"path": "x.png"},
                headers=ok)[1]["exists"] is True
    assert _upload(port, "y.png", b"y", headers=ok)[0] == 200
    # the client attaches the token itself
    (worker["local"] / "z.png").write_bytes(b"z")
    _, report = _sync(worker, _load("z.png"))
    assert report.uploaded == 1


def test_an_upload_past_the_payload_limit_fails(worker, monkeypatch):
    monkeypatch.setenv("CDT_MAX_PAYLOAD_SIZE", "1000")
    (worker["local"] / "big.png").write_bytes(b"\0" * 5000)
    _, report = _sync(worker, _load("big.png"))
    assert report.failed == ["big.png"]


# --- served to a remote worker ---------------------------------------------------


def test_a_remote_worker_gets_the_prompts_media(tmp_path, monkeypatch):
    """``LoadImage`` → ``DistributedCollector`` → ``SaveImage`` through
    ``POST /distributed/queue`` with the worker declared ``remote`` and
    an empty input directory: the file is uploaded before the dispatch,
    both images come back, and the next request skips the upload."""
    master_port, worker_port = free_port(), free_port()
    master_in, worker_in = tmp_path / "m_in", tmp_path / "w_in"
    master_in.mkdir()
    worker_in.mkdir()
    img = np.random.default_rng(1).random((12, 10, 3)).astype(np.float32)
    (master_in / "input.png").write_bytes(encode_png(img))
    (tmp_path / "w.json").write_text("{}")
    (tmp_path / "m.json").write_text(json.dumps({
        "master": {"port": master_port},
        "hosts": [{"id": "r0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "remote", "enabled": True}]}))
    with monkeypatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "r0")
        mp.setenv("CDT_INPUT_DIR", str(worker_in))
        worker = Controller(tmp_path / "w.json", device="cpu")
    with monkeypatch.context() as mp:
        mp.setenv("CDT_INPUT_DIR", str(master_in))
        mp.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
        master = Controller(tmp_path / "m.json", device="cpu")
    reports = []
    sync = media_sync.sync_host_media

    async def recording(*a, **kw):
        out = await sync(*a, **kw)
        reports.append(out[1])
        return out

    from comfyui_distributed_tpu_torch.cluster import orchestration

    monkeypatch.setattr(orchestration, "sync_host_media", recording)
    prompt = {"1": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
              "2": {"class_type": "DistributedCollector",
                    "inputs": {"images": ["1", 0]}},
              "3": {"class_type": "SaveImage",
                    "inputs": {"images": ["2", 0], "filename_prefix": "m"}}}
    servers = [ServerThread(worker, port=worker_port),
               ServerThread(master, port=master_port)]
    try:
        for i in range(2):
            status, answer = call(master_port, "/distributed/queue",
                                  {"prompt": prompt})
            assert status == 200 and answer["worker_count"] == 1, answer
            deadline = time.monotonic() + WAIT_S
            while time.monotonic() < deadline:
                status, entry = call(master_port,
                                     f"/distributed/history/{answer['prompt_id']}")
                if status == 200 and entry["status"] in ("success", "error"):
                    break
                time.sleep(0.05)
            assert entry["status"] == "success", entry
            assert (worker_in / "input.png").read_bytes() == \
                (master_in / "input.png").read_bytes()
            pngs = sorted((tmp_path / "out").glob("m_*.png"))
            assert len(pngs) == 2
            for p in pngs:
                np.testing.assert_array_equal(
                    decode_png(p.read_bytes()), decode_png(pngs[0].read_bytes()))
    finally:
        for server in reversed(servers):
            server.stop()
    assert [(r.uploaded, r.skipped, r.missing, r.failed) for r in reports] == [
        (1, 0, 0, []), (0, 1, 0, [])]
