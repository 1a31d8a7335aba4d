"""A controller with a ``{"dp": 2}`` mesh over ``CDT_VIRTUAL_DEVICES=2``
CPU ranks serving over HTTP: the tiny txt2img graph through
``POST /distributed/queue`` comes back as two images (participant 0
bitwise the one-rank run): classified batchable, as on one rank, it
runs as a group of one, solo; ``update_mesh`` answers 400 on
a bad shape and 200 on a good one, and the next request runs on the new
shape; a follower that fails mid-call fails its request naming its rank
within the group's timeout, and the next request succeeds."""

import json
import socket
import time
import urllib.error
import urllib.request

import pytest

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.parallel.bootstrap import GROUP_TIMEOUT_S

from torch_cpu_share import cpu_share  # noqa: F401  (autouse)

HW = 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port: int, path: str, payload=None) -> tuple[int, dict]:
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def graph(seed: int, name: str = "tiny", prefix: str = "mesh") -> dict:
    """A batchable tiny txt2img graph (literal inputs, no collector)."""
    return {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": name}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a red bicycle", "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": 2, "cfg": 5.0, "width": HW, "height": HW,
            "sampler_name": "euler", "scheduler": "karras"}},
        "5": {"class_type": "SaveImage",
              "inputs": {"images": ["4", 0], "filename_prefix": prefix}},
    }


def wait(port: int, prompt_id: str) -> dict:
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        _, entry = _call(port, f"/distributed/history/{prompt_id}")
        if entry.get("status") in ("success", "error", "interrupted"):
            return entry
        time.sleep(0.05)
    raise AssertionError(f"{prompt_id} did not finish")


@pytest.fixture
def served(tmp_path, monkeypatch):
    port = _free_port()
    out = tmp_path / "out"
    cfg = tmp_path / "master.json"
    cfg.write_text(json.dumps({"master": {"port": port},
                               "mesh": {"shape": {"dp": 2}}}))
    monkeypatch.setenv("CDT_VIRTUAL_DEVICES", "2")
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(out))
    monkeypatch.setenv("CDT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("CDT_CACHE", "0")
    registry = treg.ModelRegistry("cpu", seed=0)
    master = Controller(cfg, device="cpu", model_registry=registry)
    server = ServerThread(master, port=port)
    try:
        yield master, port, out, registry
    finally:
        server.stop()
    assert master._mesh is None            # the shutdown stopped the mesh


def post(port: int, prompt: dict) -> dict:
    status, answer = _call(port, "/distributed/queue", {"prompt": prompt})
    assert status == 200, answer
    return answer


def test_dp_mesh_serves_two_images(served, tmp_path):
    master, port, out, registry = served
    answer = post(port, graph(31))
    # classified on a mesh as on one rank (the solo lane's "mesh" reason
    # went with ROADMAP A.6b ii); a group of one runs solo
    assert answer.get("batched") is True
    entry = wait(port, answer["prompt_id"])
    assert entry["status"] == "success", entry
    pngs = sorted(out.glob("mesh_*.png"))
    assert [p.name for p in pngs] == ["mesh_00000.png", "mesh_00001.png"]
    mesh = master.mesh
    assert mesh.shape == {"dp": 2}
    call = mesh.runtime.last_call
    assert call["program"] == "txt2img_dp" and call["backend"] == "gloo"
    assert len(call["ranks"]) == 2
    assert master.frontdoor._classified == {"batchable": 1}
    # participant 0 is the one-rank run's image, byte for byte
    GraphExecutor({"model_registry": registry,
                   "output_dir": str(tmp_path / "direct")}).execute(
        graph(31))
    assert pngs[0].read_bytes() == \
        (tmp_path / "direct" / "mesh_00000.png").read_bytes()
    assert pngs[1].read_bytes() != pngs[0].read_bytes()
    status, info = _call(port, "/distributed/system_info")
    assert info["mesh"]["axes"] == {"dp": 2}
    assert info["mesh"]["last_call"]["program"] == "txt2img_dp"

    # update_mesh: 400 on a bad shape, 200 on a good one; the followers
    # stop and the next request runs on the new shape
    status, err = _call(port, "/distributed/config/update_mesh",
                        {"shape": {"dp": 0}})
    assert status == 400 and "dp" in err["error"]
    runtime = mesh.runtime
    status, ok = _call(port, "/distributed/config/update_mesh",
                       {"shape": {"dp": 1}})
    assert status == 200 and ok == {"status": "ok"}
    assert not runtime.procs and master.mesh.shape == {"dp": 1}
    answer = post(port, graph(31, prefix="one"))
    assert wait(port, answer["prompt_id"])["status"] == "success"
    assert [p.name for p in out.glob("one_*.png")] == ["one_00000.png"]
    assert (out / "one_00000.png").read_bytes() == pngs[0].read_bytes()


def test_a_failing_follower_fails_its_request_and_the_next_succeeds(
        served, monkeypatch):
    """Rank 0 knows a preset its follower does not (a process of its own):
    the follower raises resolving it and exits; the request fails naming
    rank 1 inside the group's timeout; the next request restarts the
    follower and succeeds."""
    master, port, out, _ = served
    monkeypatch.setitem(treg.PRESETS, "tiny-rank0",
                        treg.dataclasses.replace(treg.PRESETS["tiny"],
                                                 name="tiny-rank0"))
    t0 = time.monotonic()
    answer = post(port, graph(5, name="tiny-rank0", prefix="bad"))
    entry = wait(port, answer["prompt_id"])
    assert entry["status"] == "error", entry
    assert "rank 1" in json.dumps(entry) and "tiny-rank0" in json.dumps(entry)
    assert time.monotonic() - t0 < GROUP_TIMEOUT_S
    assert not list(out.glob("bad_*.png"))
    answer = post(port, graph(5, prefix="good"))
    assert wait(port, answer["prompt_id"])["status"] == "success"
    assert len(list(out.glob("good_*.png"))) == 2
