"""The port's served path on the CPU: a master and a worker controller on
loopback ports (``device="cpu"``, the ``tiny`` preset: the shipped SDXL
workflow at 64², 2 steps). ``POST /distributed/queue`` must give PNGs
bitwise equal to direct ``GraphExecutor`` runs of the same workflow at
the master's seed and at the worker's (seed + worker index + 1)."""

import gc
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster import controller as controller_mod
from comfyui_distributed_tpu_torch.cluster.collector_bridge import CollectorBridge
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.graph.executor import strip_meta
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

ROOT = Path(__file__).resolve().parents[1]
SEED = 7
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_resilience():
    """The port's breakers and fault plan are process-global: a worker id
    another test failed must not start quarantined here."""
    from comfyui_distributed_tpu_torch.cluster import faults, resilience

    resilience.BREAKERS.reset()
    faults.deactivate()
    yield
    resilience.BREAKERS.reset()
    faults.deactivate()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tiny_prompt(seed: int = SEED, prefix: str = "txt2img") -> dict:
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "distributed-txt2img.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "tiny"
    prompt["4"]["inputs"]["seed"] = seed
    prompt["5"]["inputs"].update(width=64, height=64, steps=2)
    prompt["7"]["inputs"]["filename_prefix"] = prefix
    return prompt


def call(port: int, path: str, payload=None, raw: bytes | None = None,
         headers: dict | None = None) -> tuple[int, dict]:
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def wait_final(port: int, prompt_id: str) -> dict:
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        status, entry = call(port, f"/distributed/history/{prompt_id}")
        if status == 200 and entry["status"] in ("success", "error", "interrupted"):
            return entry
        time.sleep(0.1)
    raise TimeoutError(f"prompt {prompt_id} not final after {WAIT_S} s")


@pytest.fixture(scope="module")
def direct(tmp_path_factory):
    """uint8 images of direct runs at the master's and the worker's seed."""
    registry = ModelRegistry("cpu", seed=0)
    out = tmp_path_factory.mktemp("direct")
    executor = GraphExecutor({"model_registry": registry, "output_dir": str(out)})
    return {s: to_uint8(executor.execute(tiny_prompt(s))["5"][0])
            for s in (SEED, SEED + 1)}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A worker (w0) and a master whose config also holds a disabled host
    (w1) whose port nothing listens on."""
    tmp = tmp_path_factory.mktemp("cluster")
    master_port, worker_port, dead_port = free_port(), free_port(), free_port()
    (tmp / "worker.json").write_text("{}")
    (tmp / "master.json").write_text(json.dumps({
        "master": {"port": master_port},
        "hosts": [
            {"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
             "type": "local", "enabled": True},
            {"id": "w1", "address": f"http://127.0.0.1:{dead_port}",
             "type": "local", "enabled": False},
        ]}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "w0")
        worker = Controller(tmp / "worker.json", device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_OUTPUT_DIR", str(tmp / "out"))
        master = Controller(tmp / "master.json", device="cpu")
    servers = []
    try:
        servers.append(ServerThread(worker, port=worker_port))
        servers.append(ServerThread(master, port=master_port))
        yield {"port": master_port, "worker_port": worker_port,
               "out": tmp / "out"}
    finally:
        for server in reversed(servers):
            server.stop()


def served(cluster, prefix: str, **fields) -> tuple[dict, dict, list]:
    status, answer = call(cluster["port"], "/distributed/queue",
                          {"prompt": tiny_prompt(prefix=prefix), **fields})
    assert status == 200 and answer["node_errors"] == [], answer
    entry = wait_final(cluster["port"], answer["prompt_id"])
    pngs = sorted(cluster["out"].glob(f"{prefix}_*.png"))
    return answer, entry, [to_uint8(decode_png(p.read_bytes()))[0] for p in pngs]


def test_worker_backed_queue_gives_both_seeds(cluster, direct):
    answer, entry, images = served(cluster, "both")
    assert answer["worker_count"] == 1 and answer["node_errors"] == []
    assert answer["trace_id"].startswith("exec_")
    assert entry["status"] == "success", entry
    assert len(images) == 2
    np.testing.assert_array_equal(images[0], direct[SEED][0])
    np.testing.assert_array_equal(images[1], direct[SEED + 1][0])


def test_worker_offline_master_alone(cluster, direct):
    answer, entry, images = served(cluster, "alone", enabled_worker_ids=["w1"])
    assert answer["worker_count"] == 0 and entry["status"] == "success"
    assert len(images) == 1
    np.testing.assert_array_equal(images[0], direct[SEED][0])


def test_delegate_master_gives_the_worker_image(cluster, direct):
    answer, entry, images = served(cluster, "delegate", delegate_master=True)
    assert answer["worker_count"] == 1 and entry["status"] == "success"
    assert len(images) == 1
    np.testing.assert_array_equal(images[0], direct[SEED + 1][0])


def test_envelope_fallback_when_frames_are_refused(cluster, direct, monkeypatch):
    async def refuse(*args, **kwargs):
        return False

    monkeypatch.setattr(CollectorBridge, "_send_frames", refuse)
    answer, entry, images = served(cluster, "envelope")
    assert answer["worker_count"] == 1 and entry["status"] == "success"
    assert len(images) == 2
    np.testing.assert_array_equal(images[0], direct[SEED][0])
    np.testing.assert_array_equal(images[1], direct[SEED + 1][0])


def test_invalid_prompt_is_rejected(cluster):
    bad = {"1": {"class_type": "NoSuchNode", "inputs": {}}}
    status, answer = call(cluster["port"], "/prompt", {"prompt": bad})
    assert status == 400 and answer["error"] == "validation failed"
    assert answer["node_errors"][0]["node_id"] == "1"
    # the queue route answers as the JAX package's path without the front
    # door: 200, no prompt id, the master's node errors
    status, answer = call(cluster["port"], "/distributed/queue", {"prompt": bad})
    assert status == 200 and answer["prompt_id"] == ""
    assert "NoSuchNode" in answer["node_errors"][0]["message"]


def test_probe_and_history_shapes(cluster):
    port = cluster["port"]
    status, health = call(port, "/distributed/health")
    assert status == 200
    assert {"status", "role", "queue_remaining", "executing",
            "machine_id"} <= set(health)
    assert health["status"] == "ok" and health["role"] == "master"
    status, worker = call(cluster["worker_port"], "/distributed/health")
    assert status == 200 and worker["role"] == "worker"
    status, body = call(port, "/prompt")
    assert status == 200 and isinstance(body["exec_info"]["queue_remaining"], int)
    status, body = call(port, "/distributed/history/p_missing")
    assert status == 404 and body["status"] == 404
    status, answer = call(port, "/prompt", {"prompt": tiny_prompt(prefix="hist")})
    assert status == 200 and answer["node_errors"] == {}
    entry = wait_final(port, answer["prompt_id"])
    assert entry["prompt_id"] == answer["prompt_id"] and entry["error"] is None
    assert entry["status"] == "success" and entry["outputs"] == {"7": []}
    status, info = call(port, "/distributed/system_info")
    assert status == 200 and info["device"] == "cpu"
    assert isinstance(info["devices"], list)


def test_failing_prompt_ends_in_error(cluster):
    prompt = tiny_prompt(prefix="fails")
    prompt["1"]["inputs"]["ckpt_name"] = "no-such-model"
    status, answer = call(cluster["port"], "/prompt", {"prompt": prompt})
    assert status == 200
    entry = wait_final(cluster["port"], answer["prompt_id"])
    assert entry["status"] == "error" and "no-such-model" in entry["error"]
    assert entry["outputs"] == {}


def test_error_answers(cluster, monkeypatch):
    monkeypatch.setenv("CDT_JOB_INIT_GRACE", "0.2")
    port = cluster["port"]
    assert call(port, "/nowhere")[0] == 404
    assert call(port, "/distributed/health", {"x": 1})[0] == 405
    status, body = call(port, "/distributed/queue", raw=b"{not json")
    assert status == 400 and "JSON" in body["error"]
    status, body = call(port, "/distributed/queue", raw=b"{}",
                        headers={"Content-Type": "text/plain"})
    assert status == 415
    # a resume of a checkpoint this controller does not hold is refused
    # (preemption, on by default, holds none), never run from scratch
    status, body = call(port, "/distributed/queue",
                        {"prompt": tiny_prompt(), "checkpoint_id": "c1"})
    assert status == 400 and "not parked" in body["error"]
    status, body = call(port, "/distributed/job_complete",
                        {"job_id": "j", "worker_id": "w", "is_last": True,
                         "image": ""})
    assert status == 500 and "never initialized" in body["error"]
    # a body over the limit is refused from its header alone
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
        s.sendall(b"POST /distributed/queue HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: 999999999999\r\n\r\n")
        head = s.recv(4096)
    assert head.startswith(b"HTTP/1.1 413")
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
        s.sendall(b"POST /prompt HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n")
        head = s.recv(4096)
    assert head.startswith(b"HTTP/1.1 400")


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_a_card_controller_sets_full_fp32(device, tmp_path, monkeypatch):
    """A controller on the card turns TF32 off for its process, so a worker
    started by the CLI computes the bits a direct run computes; one on the
    CPU leaves the flags alone. The card is stood in for by its device."""
    monkeypatch.setattr(controller_mod, "resolve_device", torch.device)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    Controller(tmp_path / "config.json", device=device)
    tf32 = device == "cpu"
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


def test_shutdown_frees_the_bundles_without_the_cycle_collector(tmp_path):
    """The controller and its queue refer to each other; its shutdown
    still lets go of the registry at once, so an embedding process gets
    the card's memory back without waiting for the cycle collector."""
    (tmp_path / "config.json").write_text("{}")
    registry = ModelRegistry("cpu", seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
        controller = Controller(tmp_path / "config.json", device="cpu",
                                model_registry=registry)
    server = ServerThread(controller)
    status, answer = call(server.port, "/distributed/queue",
                          {"prompt": tiny_prompt(prefix="freed")})
    assert status == 200 and answer["worker_count"] == 0, answer
    assert wait_final(server.port, answer["prompt_id"])["status"] == "success"
    refs = [weakref.ref(registry), weakref.ref(registry.get("tiny"))]
    del registry
    gc.disable()
    try:
        server.stop()
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_cli_serve_on_the_cpu_answers_health(tmp_path):
    port = free_port()
    env = {**os.environ, "CDT_CONFIG_PATH": str(tmp_path / "cfg.json"),
           "CDT_OUTPUT_DIR": str(tmp_path / "out")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "comfyui_distributed_tpu_torch", "serve",
         "--host", "127.0.0.1", "--port", str(port), "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + WAIT_S
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, health = call(port, "/distributed/health")
                break
            except OSError:
                time.sleep(0.2)
        assert health is not None, proc.stderr.read().decode()
        assert status == 200 and health["role"] == "master"
    finally:
        proc.terminate()
        proc.wait(timeout=WAIT_S)
    assert proc.returncode == 0
    proc.stderr.close()
