"""``workflows/distributed-upscale.json`` end to end on the CPU with the
tiny presets (``tiny`` bundle, ``tiny-x2`` upscaler, 16² tiles): run
directly through ``GraphExecutor``, and served through ``POST
/distributed/queue`` to a master and a worker controller on loopback
ports, the tiles pulled over HTTP from the master's queue. The served
image must be bitwise equal to the direct one, with the worker having
run some tiles; so must a farm run whose worker dies holding tasks, and
the per-image (dynamic) farm mode."""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.tile_farm import assemble_tiles
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.graph.executor import strip_meta
from comfyui_distributed_tpu_torch.graph.node import get_node
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.tiles.engine import TileUpscaler, UpscaleSpec
from comfyui_distributed_tpu_torch.utils.image import decode_png, encode_png
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 120.0
SPEC = UpscaleSpec(scale=1.0, tile_w=16, tile_h=16, padding=4, steps=4,
                   denoise=0.35, guidance_scale=6.0)


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


def tiny_workflow(prefix: str = "upscaled") -> dict:
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "distributed-upscale.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "tiny"
    prompt["8"]["inputs"]["model_name"] = "tiny-x2"
    prompt["9"]["inputs"].update(tile=16, tile_padding=4)
    prompt["5"]["inputs"].update(tile_width=16, tile_height=16,
                                 tile_padding=4, steps=4)
    prompt["7"]["inputs"]["filename_prefix"] = prefix
    return prompt


def call(port: int, path: str, payload=None) -> tuple[int, dict]:
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("upscale")
    (tmp / "in").mkdir()
    img = np.random.default_rng(0).random((24, 20, 3)).astype(np.float32)
    (tmp / "in" / "input.png").write_bytes(encode_png(img))
    return tmp


@pytest.fixture(scope="module")
def direct(inputs):
    """The direct run: the image and its PNG's bytes."""
    registry = ModelRegistry("cpu", seed=0)
    out = inputs / "direct"
    executor = GraphExecutor({"model_registry": registry,
                              "input_dir": str(inputs / "in"),
                              "output_dir": str(out)})
    result = executor.execute(tiny_workflow())
    return {"image": result["5"][0], "png": (out / "upscaled_00000.png").read_bytes(),
            "registry": registry}


def test_direct_run_shapes_and_repeat(direct, inputs):
    img = direct["image"]
    assert tuple(img.shape) == (1, 48, 40, 3) and img.dtype == torch.float32
    assert bool(torch.isfinite(img).all())
    assert img.min().item() >= 0.0 and img.max().item() <= 1.0
    again = GraphExecutor({"model_registry": direct["registry"],
                           "input_dir": str(inputs / "in"),
                           "output_dir": str(inputs / "again")}).execute(
        tiny_workflow())["5"][0]
    assert torch.equal(again, img)
    timings = direct["registry"].get("tiny").pipeline.timings
    assert len(timings["tile_chunks"]) == 9          # 3 × 3 tiles, 1 a chunk
    assert direct["registry"].get_upscaler("tiny-x2").timings["tiles"] == 4


@pytest.fixture(scope="module")
def cluster(inputs):
    """A worker (w0) and a master sharing one input directory, as a
    ``local`` host does."""
    master_port, worker_port = free_port(), free_port()
    (inputs / "worker.json").write_text("{}")
    (inputs / "master.json").write_text(json.dumps({
        "master": {"port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "local", "enabled": True}]}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "w0")
        mp.setenv("CDT_INPUT_DIR", str(inputs / "in"))
        worker = Controller(inputs / "worker.json", device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_OUTPUT_DIR", str(inputs / "served"))
        mp.setenv("CDT_INPUT_DIR", str(inputs / "in"))
        master = Controller(inputs / "master.json", device="cpu")
    servers = []
    try:
        servers.append(ServerThread(worker, port=worker_port))
        servers.append(ServerThread(master, port=master_port))
        yield {"port": master_port, "master": master, "worker": worker,
               "out": inputs / "served", "servers": servers}
    finally:
        for server in reversed(servers):
            server.stop()


def test_served_workflow_equals_direct(cluster, direct, monkeypatch):
    # the master leaves the queue to the worker until its first pull
    monkeypatch.setenv("CDT_TILE_MASTER_HOLDBACK_S", "30")
    status, answer = call(cluster["port"], "/distributed/queue",
                          {"prompt": tiny_workflow()})
    assert status == 200 and answer["worker_count"] == 1, answer
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        status, entry = call(cluster["port"],
                             f"/distributed/history/{answer['prompt_id']}")
        if status == 200 and entry["status"] in ("success", "error"):
            break
        time.sleep(0.1)
    assert entry["status"] == "success", entry
    pngs = sorted(cluster["out"].glob("upscaled_*.png"))
    assert len(pngs) == 1         # the worker's collector passes through
    assert pngs[0].read_bytes() == direct["png"]
    np.testing.assert_array_equal(decode_png(pngs[0].read_bytes()).shape,
                                  (48, 40, 3))
    status, summary = call(cluster["port"],
                           f"/distributed/queue_status/{answer['trace_id']}_5")
    assert status == 200 and summary["finished"] and summary["total"] == 9
    assert "w0" in summary["completed_by"].values(), summary


def _engine(registry):
    bundle = registry.get("tiny")
    ctx, _ = bundle.text_encoder.encode(["tile prompt"])
    unc, _ = bundle.text_encoder.encode([""])
    return TileUpscaler(bundle.pipeline), ctx, unc


def test_farm_with_a_dead_worker_equals_direct(cluster, direct):
    """A worker pulls two tasks over HTTP and goes silent: the heartbeat
    monitor requeues them, the master runs them, and the composite is
    bitwise equal to the direct engine run."""
    master, server = cluster["master"], cluster["servers"][1]
    ups, ctx, unc = _engine(direct["registry"])
    img = torch.from_numpy(np.random.default_rng(3).random(
        (40, 32, 3)).astype(np.float32))
    want = ups.upscale(img[None], SPEC, 5, ctx, unc)[0]
    plan = ups.range_plan(img, SPEC, 5, ctx, unc)
    fut = asyncio.run_coroutine_threadsafe(master.tile_farm.master_run_async(
        "dead", plan.num_tiles, plan.run_range, chunk=plan.chunk,
        heartbeat_interval=0.2, worker_timeout=0.5), server.loop)
    pulled = 0
    deadline = time.monotonic() + WAIT_S
    while pulled < 2 and time.monotonic() < deadline:
        status, body = call(cluster["port"], "/distributed/request_image",
                            {"job_id": "dead", "worker_id": "wgone"})
        pulled += status == 200 and body.get("task") is not None
    assert pulled == 2
    results = fut.result(WAIT_S)
    tiles = assemble_tiles(results, plan.num_tiles, plan.chunk)
    assert torch.equal(ups.composite(tiles, plan), want)


def test_dynamic_mode_farms_images(cluster, direct):
    """A batch of ``dynamic_threshold`` images or more is farmed by
    image: the master's result equals each image upscaled on its own
    with seed + its index, and the worker returns a plain resize."""
    registry = direct["registry"]
    bundle = registry.get("tiny")
    ctx, pooled = bundle.text_encoder.encode(["tile prompt"])
    cond = {"context": ctx, "pooled": pooled}
    images = torch.from_numpy(np.random.default_rng(4).random(
        (3, 24, 16, 3)).astype(np.float32))
    node = get_node("UltimateSDUpscaleDistributed")()
    kw = dict(model=bundle, positive=cond, negative=cond, seed=9, steps=4,
              denoise=0.35, upscale_by=1.0, tile_width=16, tile_height=16,
              tile_padding=4, cfg=6.0, dynamic_threshold=2,
              multi_job_id="dyn")
    worker_out = {}

    def worker():
        worker_out["image"] = node.execute(
            images, **kw, is_worker=True, worker_id="w0",
            master_url=f"http://127.0.0.1:{cluster['port']}",
            tile_farm=cluster["worker"].tile_farm)[0]

    thread = threading.Thread(target=worker)
    thread.start()
    (out,) = node.execute(images, **kw, enabled_worker_ids=["w0"],
                          tile_farm=cluster["master"].tile_farm)
    thread.join(WAIT_S)
    ups, _, _ = _engine(registry)
    spec = UpscaleSpec(scale=1.0, tile_w=16, tile_h=16, padding=4, steps=4,
                       denoise=0.35, guidance_scale=6.0)
    adm = bundle.pipeline.unet.config.adm_in_channels
    y = torch.nn.functional.pad(pooled, (0, adm - pooled.shape[-1])) if adm else None
    for i in range(3):
        want = ups.upscale(images[i:i + 1], spec, 9 + i, ctx, ctx, y, y)
        assert torch.equal(out[i:i + 1], want)
    assert torch.equal(worker_out["image"], images)   # scale 1: the identity


def test_spatial_cond_is_refused(direct):
    """``spatial_cond`` is no longer refused: cropped per tile like the
    image (1 = denoise, 0 = keep the source), as the JAX package does. A
    map of ones is the run without one, bitwise; a map of zeros gives
    back the resized source, which matches ``jax.image.resize``; a half
    map keeps the source where its tiles see only zeros."""
    from comfyui_distributed_tpu_torch.ops.resize import upscale_image

    bundle = direct["registry"].get("tiny")
    ctx, pooled = bundle.text_encoder.encode([""])
    cond = {"context": ctx, "pooled": pooled}
    img = torch.from_numpy(np.random.default_rng(5).random(
        (1, 16, 16, 3)).astype(np.float32))
    node = get_node("UltimateSDUpscaleDistributed")()

    def run(spatial_cond=None):
        return node.execute(img, bundle, cond, cond, 1, 2, 0.3, 2.0,
                            tile_width=16, tile_height=16, tile_padding=4,
                            spatial_cond=spatial_cond)[0]

    plain = run()
    assert torch.equal(run(torch.ones(1, 16, 16)), plain)
    source = upscale_image(img, 2.0, "lanczos3")
    zeros = run(torch.zeros(1, 8, 8))          # input-size maps are resized
    torch.testing.assert_close(zeros, source, atol=1e-6, rtol=1e-6)
    half = torch.zeros(1, 32, 32)
    half[:, :16] = 1.0
    out = run(half)
    # tiles of rows 16..31 (padding 4) see only zeros below row 20
    torch.testing.assert_close(out[:, 24:], source[:, 24:], atol=1e-6, rtol=1e-6)
    assert (out[:, :8] - source[:, :8]).abs().max() > 1e-3
    jimage = pytest.importorskip("jax.image")
    ref = np.asarray(jimage.resize(img.numpy(), (1, 32, 32, 3), "lanczos3"))
    np.testing.assert_allclose(zeros.numpy(), np.clip(ref, 0.0, 1.0),
                               atol=2e-4, rtol=2e-4)
