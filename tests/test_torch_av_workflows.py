"""The audio and video nodes and workflows of the port on the CPU:

- the nodes against the JAX package's (``LoadAudio``, ``SaveAudio``,
  ``LoadVideo``, ``SaveVideo`` with its VHS aliases, the primitives,
  ``DistributedModelName``), and the loaders' input-directory check;
- ``workflows/distributed-audio.json`` and ``workflows/video-upscale.json``
  run directly (tiny presets: ``tiny``, ``tiny-x2``, 16² tiles);
- a worker's AUDIO reaching the master over the frames route, the
  envelope route and the count-0 envelope, joined master first;
- both workflows served to a master and a ``remote`` worker controller
  on loopback ports (media synced): the worker's clip joined after the
  master's, the history's AUDIO summary, and the served video's frames
  equal to the direct run's (by range below ``dynamic_threshold``
  frames, frame by frame at seed + index from it)."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster import orchestration
from comfyui_distributed_tpu_torch.cluster.collector_bridge import CollectorBridge
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.graph.executor import strip_meta
from comfyui_distributed_tpu_torch.graph.node import NODE_REGISTRY, get_node
from comfyui_distributed_tpu_torch.graph.nodes_builtin import _adm_from_cond
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.tiles.engine import TileUpscaler, UpscaleSpec
from comfyui_distributed_tpu_torch.utils.audio_payload import (encode_audio,
                                                               wav_bytes,
                                                               wav_decode)
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError
from comfyui_distributed_tpu_torch.utils.multipart import Part, build_multipart
from comfyui_distributed_tpu_torch.utils.video_io import load_video, save_video

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 120.0
RATE = 8000
FPS = 12.0
IN_HW = (8, 16)           # → tiny-x2 → 16×32: 2 tiles of 16²


@pytest.fixture(autouse=True)
def _fresh_resilience():
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


def wait_final(port: int, prompt_id: str) -> dict:
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        status, entry = call(port, f"/distributed/history/{prompt_id}")
        if status == 200 and entry["status"] in ("success", "error"):
            return entry
        time.sleep(0.05)
    raise TimeoutError(prompt_id)


def tone(samples: int, channels: int = 2, seed: int = 0) -> np.ndarray:
    t = np.arange(samples, dtype=np.float32) / RATE
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * (300 + 50 * seed) * t)[None]
            + 0.02 * rng.standard_normal((channels, samples))).astype(np.float32)


def video_frames(t: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, IN_HW[0], dtype=np.float32)[:, None, None]
    x = np.linspace(0, 1, IN_HW[1], dtype=np.float32)[None, :, None]
    return np.stack([np.clip(0.3 + 0.4 * y * x + 0.05 * i
                             + 0.03 * rng.standard_normal((*IN_HW, 3)), 0, 1)
                     for i in range(t)]).astype(np.float32)


def audio_workflow() -> dict:
    return strip_meta(json.loads(
        (ROOT / "workflows" / "distributed-audio.json").read_text()))


def video_workflow(video: str = "input.avi", cap: int = 0) -> dict:
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "video-upscale.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "tiny"
    prompt["4"]["inputs"]["video"] = video
    if cap:
        prompt["4"]["inputs"]["frame_load_cap"] = cap
    prompt["8"]["inputs"]["model_name"] = "tiny-x2"
    prompt["9"]["inputs"].update(tile=16, tile_padding=4)
    prompt["5"]["inputs"].update(tile_width=16, tile_height=16, tile_padding=4)
    return prompt


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("av")
    (tmp / "in").mkdir()
    (tmp / "in" / "clip.wav").write_bytes(wav_bytes(tone(2 * RATE + 1), RATE))
    track = {"waveform": tone(RATE, seed=1)[None], "sample_rate": RATE}
    save_video(tmp / "in" / "input.avi", video_frames(12), fps=FPS, audio=track)
    save_video(tmp / "in" / "short.avi", video_frames(3, seed=2), fps=FPS,
               audio=track)
    return tmp


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry("cpu", seed=0)


# --- the nodes against the JAX package's -----------------------------------------


def _jax_nodes():
    return pytest.importorskip("comfyui_distributed_tpu.graph.nodes_builtin")


def test_vhs_aliases_and_node_set():
    assert NODE_REGISTRY["VHS_LoadVideo"] is NODE_REGISTRY["LoadVideo"]
    assert NODE_REGISTRY["VHS_VideoCombine"] is NODE_REGISTRY["SaveVideo"]
    jnodes = _jax_nodes()
    for name in ("DistributedModelName", "ImageBatchDivider", "AudioBatchDivider",
                 "LoadAudio", "SaveAudio", "LoadVideo", "SaveVideo",
                 "PrimitiveInt", "PrimitiveFloat", "PrimitiveString",
                 "VHS_LoadVideo", "VHS_VideoCombine"):
        ours, theirs = NODE_REGISTRY[name], jnodes.NODE_REGISTRY[name]
        assert (ours.INPUTS, ours.OPTIONAL, ours.RETURNS, ours.OUTPUT_NODE) == (
            theirs.INPUTS, theirs.OPTIONAL, theirs.RETURNS, theirs.OUTPUT_NODE)


@pytest.mark.parametrize("name,value,want", [
    ("PrimitiveInt", "7", 7), ("PrimitiveInt", 7.9, 7),
    ("PrimitiveFloat", "2.5", 2.5), ("PrimitiveString", 3, "3"),
    ("DistributedModelName", "sd15", "sd15")])
def test_scalar_nodes_equal_jax(name, value, want):
    key = "model_name" if name == "DistributedModelName" else "value"
    theirs = _jax_nodes().NODE_REGISTRY[name]().execute(**{key: value})
    assert get_node(name)().execute(**{key: value}) == theirs == (want,)


def test_audio_nodes_equal_jax(inputs, tmp_path):
    jnodes = _jax_nodes()
    (ours,) = get_node("LoadAudio")().execute("clip.wav", input_dir=str(inputs / "in"))
    (theirs,) = jnodes.NODE_REGISTRY["LoadAudio"]().execute(
        "clip.wav", input_dir=str(inputs / "in"))
    np.testing.assert_array_equal(ours["waveform"].numpy(), theirs["waveform"])
    batch = {"waveform": torch.from_numpy(tone(99, seed=3)[None].repeat(2, 0)),
             "sample_rate": RATE}
    get_node("SaveAudio")().execute(batch, "a", output_dir=str(tmp_path / "ours"))
    jnodes.NODE_REGISTRY["SaveAudio"]().execute(
        {**batch, "waveform": batch["waveform"].numpy()}, "a",
        output_dir=str(tmp_path / "theirs"))
    for name in ("a_00000.wav", "a_00001.wav"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()


@pytest.mark.parametrize("knobs", [{}, {"frame_load_cap": 5},
                                   {"skip_first_frames": 2, "select_every_nth": 3}])
def test_load_video_equals_jax(inputs, knobs):
    ours = get_node("LoadVideo")().execute("input.avi", input_dir=str(inputs / "in"),
                                           model_registry=_CPU, **knobs)
    theirs = _jax_nodes().NODE_REGISTRY["LoadVideo"]().execute(
        "input.avi", input_dir=str(inputs / "in"), **knobs)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(ours[1]["waveform"].numpy(),
                                  np.asarray(theirs[1]["waveform"]))
    assert ours[1]["sample_rate"] == theirs[1]["sample_rate"]
    assert ours[2:] == theirs[2:]


class _CPU:
    device = torch.device("cpu")


def test_silent_video_gives_an_empty_clip(tmp_path):
    save_video(tmp_path / "silent.avi", video_frames(2), fps=4.0)
    frames, audio, fps, n = get_node("LoadVideo")().execute(
        "silent.avi", input_dir=str(tmp_path), model_registry=_CPU)
    assert tuple(frames.shape) == (2, *IN_HW, 3) and (fps, n) == (4.0, 2)
    assert tuple(audio["waveform"].shape) == (1, 1, 0)
    assert audio["sample_rate"] == 44100


def test_save_video_equals_jax_with_format_strings_and_sidecars(inputs, tmp_path):
    jnodes = _jax_nodes()
    frames = video_frames(3, seed=4)
    track = {"waveform": tone(RATE // 2, seed=5)[None], "sample_rate": RATE}
    for fmt in ("avi", "video/h264-mp4", "mp4", "webm"):
        for pkg, out in (("ours", tmp_path / "ours"), ("theirs", tmp_path / "theirs")):
            node = (get_node("SaveVideo") if pkg == "ours"
                    else jnodes.NODE_REGISTRY["SaveVideo"])
            node().execute(torch.from_numpy(frames) if pkg == "ours" else frames,
                           frame_rate=6.0, audio=track, format=fmt,
                           filename_prefix="v", output_dir=str(out))
    ours = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert ours == sorted(p.name for p in (tmp_path / "theirs").iterdir())
    # the webm skips index 0 and 1: their .wav names are taken by the mp4s
    assert ours == ["v_00000.avi", "v_00000.mp4", "v_00000.wav", "v_00001.mp4",
                    "v_00001.wav", "v_00002.wav", "v_00002.webm"]
    for name in ("v_00000.avi", "v_00000.wav", "v_00002.wav"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()
    with pytest.raises(ValidationError, match="unsupported video format"):
        get_node("SaveVideo")().execute(frames, 6.0, format="gif",
                                        output_dir=str(tmp_path))


@pytest.mark.parametrize("node,name", [("LoadAudio", "../clip.wav"),
                                       ("LoadVideo", "../input.avi"),
                                       ("LoadAudio", "absent.wav")])
def test_loaders_stay_in_the_input_directory(inputs, node, name):
    (inputs / "clip.wav").write_bytes(b"")
    (inputs / "input.avi").write_bytes(b"")
    with pytest.raises(ValidationError, match="leaves the input directory"
                       if ".." in name else "not found"):
        get_node(node)().execute(name, input_dir=str(inputs / "in"),
                                 model_registry=_CPU)


# --- the workflows, direct --------------------------------------------------------


def test_audio_workflow_direct_equals_jax(inputs, registry, tmp_path):
    jexec = pytest.importorskip("comfyui_distributed_tpu.graph.executor")
    out = GraphExecutor({"input_dir": str(inputs / "in"), "model_registry": registry,
                         "output_dir": str(tmp_path / "ours")}).execute(audio_workflow())
    jexec.GraphExecutor({"input_dir": str(inputs / "in"),
                         "output_dir": str(tmp_path / "theirs")}).execute(
        jexec.strip_meta(audio_workflow()))
    assert tuple(out["4"][0]["waveform"].shape) == (1, 2, RATE + 1)
    assert tuple(out["4"][1]["waveform"].shape) == (1, 2, RATE)
    for name in ("chunk_a_00000.wav", "chunk_b_00000.wav"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()
    clip = wav_decode((inputs / "in" / "clip.wav").read_bytes())["waveform"][0]
    assert (tmp_path / "ours" / "chunk_a_00000.wav").read_bytes() == \
        wav_bytes(clip[:, :RATE + 1], RATE)


def test_video_workflow_direct_on_mp4_as_shipped(inputs, registry, tmp_path):
    """The workflow as the JAX package's tests run it: ``input.mp4`` (cv2)
    with its sidecar track; the output an AVI with the track muxed."""
    pytest.importorskip("cv2")
    track = {"waveform": tone(RATE // 2, seed=6)[None], "sample_rate": RATE}
    save_video(tmp_path / "input.mp4", video_frames(2, seed=6), fps=10.0,
               audio=track)
    out = GraphExecutor({"model_registry": registry, "input_dir": str(tmp_path),
                         "output_dir": str(tmp_path / "out")}).execute(
        video_workflow("input.mp4"))
    path = Path(out["7"][0])
    assert path.name == "video_up_00000.avi" and not path.with_suffix(".wav").exists()
    clip = load_video(path)
    assert clip["frames"].shape == (2, 16, 32, 3) and clip["fps"] == 10.0
    pcm = (np.clip(wav_decode((tmp_path / "input.wav").read_bytes())["waveform"]
                   .numpy(), -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(clip["audio"]["waveform"].numpy(),
                                  pcm.astype(np.float32) / 32768.0)


@pytest.fixture(scope="module")
def direct_video(inputs, registry):
    """The AVI workflow direct on ``short.avi`` (3 frames)."""
    out_dir = inputs / "direct"
    out = GraphExecutor({"model_registry": registry, "input_dir": str(inputs / "in"),
                         "output_dir": str(out_dir)}).execute(video_workflow("short.avi"))
    return {"frames": out["5"][0], "avi": (out_dir / "video_up_00000.avi").read_bytes()}


def test_video_workflow_direct(direct_video, inputs):
    frames = direct_video["frames"]
    assert tuple(frames.shape) == (3, 16, 32, 3) and bool(torch.isfinite(frames).all())
    assert frames.min().item() >= 0.0 and frames.max().item() <= 1.0


# --- audio across controllers ------------------------------------------------------


@pytest.fixture(scope="module")
def cluster(inputs, registry):
    """A master and a ``remote`` worker (w0) with an empty input directory
    of its own; the master syncs what a prompt reads."""
    master_port, worker_port = free_port(), free_port()
    (inputs / "w_in").mkdir()
    (inputs / "worker.json").write_text("{}")
    (inputs / "master.json").write_text(json.dumps({
        "master": {"port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "remote", "enabled": True}]}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "w0")
        mp.setenv("CDT_INPUT_DIR", str(inputs / "w_in"))
        worker = Controller(inputs / "worker.json", device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_OUTPUT_DIR", str(inputs / "served"))
        mp.setenv("CDT_INPUT_DIR", str(inputs / "in"))
        master = Controller(inputs / "master.json", device="cpu",
                            model_registry=registry)
    servers = []
    try:
        servers.append(ServerThread(worker, port=worker_port))
        servers.append(ServerThread(master, port=master_port))
        yield {"port": master_port, "master": master, "worker": worker,
               "out": inputs / "served", "w_in": inputs / "w_in"}
    finally:
        for server in reversed(servers):
            server.stop()


def _exchange(cluster, job: str, worker_images, worker_audio, local_audio):
    """The worker's bridge sends, the master's collects; returns what the
    master joined."""
    master, worker = cluster["master"], cluster["worker"]
    url = f"http://127.0.0.1:{cluster['port']}"
    errors = []

    def send():
        try:
            worker.bridge.send(job, "w0", worker_images, worker_audio, url)
        except Exception as e:           # surfaced by the assertion below
            errors.append(e)

    thread = threading.Thread(target=send)
    thread.start()
    local = torch.zeros((1, 4, 4, 3))
    out = master.bridge.collect(job, local, local_audio, enabled_worker_ids=("w0",),
                                timeout=WAIT_S)
    thread.join(WAIT_S)
    assert errors == []
    return out


@pytest.mark.parametrize("route", ["frames", "envelopes", "count-0 envelope"])
def test_a_workers_audio_is_joined_after_the_masters(cluster, route, monkeypatch):
    if route == "envelopes":
        async def refuse(*args, **kwargs):
            return False

        monkeypatch.setattr(CollectorBridge, "_send_frames", refuse)
    n = 0 if route == "count-0 envelope" else 2
    images = torch.rand((n, 4, 4, 3))
    mine = {"waveform": torch.from_numpy(tone(50, seed=7)[None]), "sample_rate": RATE}
    theirs = {"waveform": torch.from_numpy(tone(30, channels=1, seed=8)[None]),
              "sample_rate": RATE}
    joined_images, audio = _exchange(cluster, f"job_{route}", images, theirs, mine)
    assert tuple(joined_images.shape) == (1 + n, 4, 4, 3)
    # master first, then the worker's; channels cut to the fewest
    want = torch.cat([mine["waveform"][:, :1], theirs["waveform"]], dim=-1)
    assert torch.equal(audio["waveform"], want) and audio["sample_rate"] == RATE


def test_count_0_frames_post_carries_audio(cluster):
    """The frames route's count-0 form (a worker with no image) puts the
    metadata's AUDIO on its completion envelope."""
    master = cluster["master"]
    clip = {"waveform": torch.from_numpy(tone(20, seed=9)[None]), "sample_rate": RATE}
    meta = {"job_id": "frames0", "worker_id": "w0", "count": 0,
            "audio": encode_audio(clip)}
    body, ctype = build_multipart([Part("metadata", json.dumps(meta).encode(),
                                        content_type="application/json")])

    def post():
        req = urllib.request.Request(
            f"http://127.0.0.1:{cluster['port']}/distributed/job_complete_frames",
            data=body, headers={"Content-Type": ctype, "X-CDT-Client": "1"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            assert json.loads(resp.read()) == {"status": "received", "frames": 0}

    thread = threading.Thread(target=post)
    thread.start()
    images, audio = master.bridge.collect("frames0", torch.zeros((0, 4, 4, 3)), None,
                                          enabled_worker_ids=("w0",), timeout=WAIT_S)
    thread.join(WAIT_S)
    assert images.shape[0] == 0 and torch.equal(audio["waveform"], clip["waveform"])


def _served(cluster, prompt, **fields):
    reports = []
    sync = orchestration.sync_host_media

    async def recording(*a, **kw):
        out = await sync(*a, **kw)
        reports.append(out[1])
        return out

    with mock.patch.object(orchestration, "sync_host_media", recording):
        status, answer = call(cluster["port"], "/distributed/queue",
                              {"prompt": prompt, **fields})
        assert status == 200 and answer["worker_count"] == 1, answer
        entry = wait_final(cluster["port"], answer["prompt_id"])
    assert entry["status"] == "success", entry
    return answer, entry, reports


def test_served_audio_workflow_joins_the_workers_clip(cluster, inputs):
    for wav in cluster["out"].glob("*.wav"):
        wav.unlink()
    _, _, reports = _served(cluster, audio_workflow())
    assert (reports[0].checked, reports[0].uploaded) == (1, 1)
    assert (cluster["w_in"] / "clip.wav").read_bytes() == \
        (inputs / "in" / "clip.wav").read_bytes()
    clip = wav_decode((inputs / "in" / "clip.wav").read_bytes())["waveform"][0]
    # the joined clip is the master's then the worker's: each half a whole clip
    for name in ("chunk_a_00000.wav", "chunk_b_00000.wav"):
        assert (cluster["out"] / name).read_bytes() == wav_bytes(clip, RATE)
    cut = {k: v for k, v in audio_workflow().items() if k in ("1", "2", "3")}
    _, entry, reports = _served(cluster, cut)
    assert (reports[0].checked, reports[0].skipped) == (1, 1)
    assert entry["outputs"]["3"][1] == {"audio": {"shape": [1, 2, 2 * (2 * RATE + 1)],
                                                  "sample_rate": RATE}}


def test_served_audio_with_a_delegate_master(cluster, inputs):
    """A delegate-only master has no clip of its own: the joined clip is
    the worker's (the JAX package joins the empty image as a clip and
    fails)."""
    for wav in cluster["out"].glob("*.wav"):
        wav.unlink()
    _served(cluster, audio_workflow(), delegate_master=True)
    clip = wav_decode((inputs / "in" / "clip.wav").read_bytes())["waveform"][0]
    half = clip.shape[-1] - clip.shape[-1] // 2
    assert (cluster["out"] / "chunk_a_00000.wav").read_bytes() == \
        wav_bytes(clip[:, :half], RATE)


def test_served_video_by_range_equals_direct(cluster, direct_video, monkeypatch):
    """3 frames (below ``dynamic_threshold``): each frame's tiles farmed by
    range; the master's AVI is byte for byte the direct run's."""
    monkeypatch.setenv("CDT_TILE_MASTER_HOLDBACK_S", "30")
    for avi in cluster["out"].glob("*.avi"):
        avi.unlink()
    answer, _, reports = _served(cluster, video_workflow("short.avi"))
    assert (reports[0].checked, reports[0].uploaded) == (1, 1)
    assert (cluster["out"] / "video_up_00000.avi").read_bytes() == direct_video["avi"]
    owners = [call(cluster["port"], f"/distributed/queue_status/"
                   f"{answer['trace_id']}_5_b{b}")[1]["completed_by"]
              for b in range(3)]
    assert any("w0" in o.values() for o in owners), owners


def test_served_video_by_frame_equals_each_frames_own_upscale(cluster, registry,
                                                              monkeypatch):
    """8 frames (``dynamic_threshold``): one task a frame, frame i upscaled
    alone at seed + i; the AVI holds the 8 frames with their span of
    the track."""
    monkeypatch.setenv("CDT_TILE_MASTER_HOLDBACK_S", "30")
    usdu = NODE_REGISTRY["UltimateSDUpscaleDistributed"]
    inner, seen = usdu.execute, {}

    def capturing(self, image, model, positive, negative, *a, **kw):
        out = inner(self, image, model, positive, negative, *a, **kw)
        if not kw.get("is_worker"):
            seen.update(image=image, positive=positive, negative=negative,
                        out=out[0])
        return out

    for avi in cluster["out"].glob("*.avi"):
        avi.unlink()
    with mock.patch.object(usdu, "execute", capturing):
        answer, _, _ = _served(cluster, video_workflow("input.avi", cap=8))
    status, summary = call(cluster["port"],
                           f"/distributed/queue_status/{answer['trace_id']}_5")
    assert status == 200 and summary["total"] == 8
    assert "w0" in summary["completed_by"].values(), summary
    spec = UpscaleSpec(scale=1.0, tile_w=16, tile_h=16, padding=4, steps=12,
                       denoise=0.25, sampler="res_2m", scheduler="beta",
                       guidance_scale=5.0)
    pipeline = registry.get("tiny").pipeline
    ups, adm = TileUpscaler(pipeline), pipeline.unet.config.adm_in_channels
    y, uy = (_adm_from_cond(c, adm, "cpu") for c in (seen["positive"],
                                                     seen["negative"]))
    for i in range(8):
        alone = ups.upscale(seen["image"][i:i + 1], spec, 7 + i,
                            seen["positive"]["context"],
                            seen["negative"]["context"], y, uy)
        assert torch.equal(seen["out"][i:i + 1], alone)
    clip = load_video(cluster["out"] / "video_up_00000.avi")
    assert clip["frames"].shape == (8, 16, 32, 3) and clip["fps"] == FPS
    assert clip["audio"]["waveform"].shape[-1] == round(8 / FPS * RATE)


@pytest.mark.parametrize("side", [22, 24])
def test_unet_takes_a_latent_side_that_is_not_a_multiple_of_8(side):
    """``video-upscale.json``'s 816² crops give a 102² latent (51 and 26
    below): each upsampling goes to the size of the skip it meets. At a
    multiple of 8 that is the plain 2× upsampling."""
    from comfyui_distributed_tpu_torch.models import layers
    from comfyui_distributed_tpu_torch.models.unet import UNet2D, UNetConfig

    cfg = UNetConfig(model_channels=32, channel_mult=(1, 2, 2, 2),
                     num_res_blocks=1, transformer_depth=(1, 1, 0, 0),
                     num_heads=2, context_dim=16, adm_in_channels=0,
                     dtype="float32")
    torch.manual_seed(0)
    unet = UNet2D(cfg).eval()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, side, side, 4, generator=gen)
    ctx = torch.randn(2, 5, 16, generator=gen)
    t = torch.tensor([500.0, 20.0])
    with torch.no_grad():
        out = unet(x, t, ctx)
        assert tuple(out.shape) == (2, side, side, 4)
        assert bool(torch.isfinite(out).all())
        if side % 8 == 0:
            plain = layers.Upsample.forward

            def doubling(self, h, size=None):
                return plain(self, h)

            with mock.patch.object(layers.Upsample, "forward", doubling):
                assert torch.equal(unet(x, t, ctx), out)
