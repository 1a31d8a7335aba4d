"""The WAN workflows and weights of the port on the CPU (tiny presets):

- ``workflows/wan-t2v.json`` (``wan-tiny``) and ``workflows/wan-i2v.json``
  (``wan-i2v-tiny``, a start frame in the input directory) through the
  port's ``GraphExecutor``: the node's frames equal the pipeline's video
  of the seed, the divider's halves written as mp4 and read back;
- both served by a master and a ``remote`` worker controller on loopback
  ports: one IMAGE batch of two videos, ``*_v0`` the master's (seed),
  ``*_v1`` the worker's (seed + 1), each equal to its direct video;
- the nodes' refusals (``tp``, i2v on a t2v architecture), ``sp`` on
  one rank, their ``offload`` runs and their defaults (shift, pooled
  vector);
- weights: WAN 2.2's ``.high``/``.low`` files through ``convert
  --checkpoint-low`` and restore, loaded directly by name, the
  incomplete pair refused; a UMT5 file and a WAN file cut in depth
  through a bundle's loaders, saved and restored."""

import dataclasses
import json
import os
import socket
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.__main__ import main as cli
from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.diffusion.pipeline_video import VideoSpec
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.graph.executor import strip_meta
from comfyui_distributed_tpu_torch.graph.nodes_builtin import (TPUImg2Video,
                                                               TPUTxt2Video)
from comfyui_distributed_tpu_torch.models import convert as tconvert
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models.registry import (PRESETS, ModelBundle,
                                                           ModelRegistry)
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError
from comfyui_distributed_tpu_torch.utils.image import encode_png, to_uint8
from comfyui_distributed_tpu_torch.utils.safetensors import save_file
from comfyui_distributed_tpu_torch.utils.video_io import load_video
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 120.0
FRAMES, HW, STEPS = 5, 16, 2


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


def t2v_workflow(**sampler) -> dict:
    prompt = strip_meta(json.loads((ROOT / "workflows" / "wan-t2v.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "wan-tiny"
    prompt["4"]["inputs"].update(frames=FRAMES, steps=STEPS, width=HW,
                                 height=HW, **sampler)
    return prompt


def i2v_workflow() -> dict:
    prompt = strip_meta(json.loads((ROOT / "workflows" / "wan-i2v.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "wan-i2v-tiny"
    prompt["5"]["inputs"].update(frames=FRAMES, steps=STEPS)
    return prompt


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wan")
    (tmp / "in").mkdir()
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 1, (HW, HW, 3)).astype(np.float32)
    (tmp / "in" / "start_frame.png").write_bytes(encode_png(to_uint8(frame[None])[0]))
    return tmp


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry("cpu", seed=0)


def _direct(registry, inputs, prompt, out_dir):
    return GraphExecutor({"model_registry": registry,
                          "input_dir": str(inputs / "in"),
                          "output_dir": str(out_dir)}).execute(prompt)


@pytest.fixture(scope="module")
def direct(registry, inputs):
    """Each workflow direct at its seed and at seed + 1 (the worker's)."""
    runs = {}
    for name, make, node, seed_node in (("t2v", t2v_workflow, "4", "3"),
                                        ("i2v", i2v_workflow, "5", "4")):
        for k in (0, 1):
            prompt = make()
            prompt[seed_node]["inputs"]["seed"] += k
            out = _direct(registry, inputs, prompt, inputs / f"direct_{name}_{k}")
            runs[name, k] = out[node][0]
    return runs


def test_t2v_workflow_direct(direct, registry, inputs):
    frames = direct["t2v", 0]
    assert tuple(frames.shape) == (FRAMES, HW, HW, 3)
    assert 0.0 <= frames.min() and frames.max() <= 1.0
    assert not torch.equal(frames, direct["t2v", 1])
    # the node's frames are the pipeline's video of the workflow's seed
    bundle = registry.get("wan-tiny")
    ctx, pooled = bundle.text_encoder.encode(
        [t2v_workflow()["2"]["inputs"]["text"]])
    spec = VideoSpec(frames=FRAMES, height=HW, width=HW, steps=STEPS,
                     shift=3.0, guidance_scale=5.0)
    assert torch.equal(bundle.pipeline.generate(spec, 99, ctx, pooled)[0], frames)
    # the divider's halves, 3 and 2 frames at 16 fps
    for prefix, count in (("wan_v0", 3), ("wan_v1", 2)):
        clip = load_video(inputs / "direct_t2v_0" / f"{prefix}_00000.mp4")
        assert clip["frame_count"] == count and clip["fps"] == 16.0


def test_i2v_workflow_direct(direct, inputs):
    frames = direct["i2v", 0]
    assert tuple(frames.shape) == (FRAMES, HW, HW, 3)
    assert not torch.equal(frames, direct["i2v", 1])
    for prefix, count in (("wan_i2v_v0", 3), ("wan_i2v_v1", 2)):
        clip = load_video(inputs / "direct_i2v_0" / f"{prefix}_00000.mp4")
        assert clip["frame_count"] == count


@pytest.fixture(scope="module")
def cluster(inputs, registry):
    """A master and a ``remote`` worker (w0) with an empty input directory
    of its own; the master syncs the start frame."""
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
        yield {"port": master_port, "out": inputs / "served"}
    finally:
        for server in reversed(servers):
            server.stop()


@pytest.mark.parametrize("name,make,prefix", [
    ("t2v", t2v_workflow, "wan"), ("i2v", i2v_workflow, "wan_i2v")])
def test_served_workflow_gives_one_video_per_host(cluster, direct, name, make,
                                                  prefix):
    status, answer = call(cluster["port"], "/distributed/queue",
                          {"prompt": make()})
    assert status == 200 and answer["worker_count"] == 1, answer
    entry = wait_final(cluster["port"], answer["prompt_id"])
    assert entry["status"] == "success", entry
    for k in (0, 1):
        clip = load_video(cluster["out"] / f"{prefix}_v{k}_00000.mp4")
        assert clip["frame_count"] == FRAMES
        # the mp4 holds what the direct run of that seed wrote
        mine = load_video(cluster["out"].parent / f"direct_{name}_{k}"
                          / f"{prefix}_v0_00000.mp4")
        assert np.array_equal(clip["frames"][:3], mine["frames"])


def test_served_frames_equal_direct(cluster, direct, registry, monkeypatch):
    """The collected IMAGE batch: the master's video, then the worker's
    (its frames travel as 8-bit samples, as ``SaveVideo`` writes them)."""
    from comfyui_distributed_tpu_torch.graph import nodes_builtin

    seen = []
    divide = nodes_builtin.ImageBatchDivider.execute

    def recording(self, images, *a, **kw):
        seen.append(images.clone())
        return divide(self, images, *a, **kw)

    monkeypatch.setattr(nodes_builtin.ImageBatchDivider, "execute", recording)
    status, answer = call(cluster["port"], "/distributed/queue",
                          {"prompt": t2v_workflow()})
    assert status == 200
    assert wait_final(cluster["port"], answer["prompt_id"])["status"] == "success"
    batch = next(s for s in seen if s.shape[0] == 2 * FRAMES)
    assert torch.equal(batch[:FRAMES], direct["t2v", 0])
    assert np.array_equal(to_uint8(batch[FRAMES:]), to_uint8(direct["t2v", 1]))


@pytest.mark.parametrize("node,mode,item", [
    (TPUTxt2Video, "tp", "video_tp"), (TPUImg2Video, "tp", "video_tp")])
def test_video_nodes_refuse_unported_modes(registry, node, mode, item):
    """``tp`` is no mode of the JAX nodes: refused, naming the program
    that runs it (``sp``, refused until ROADMAP A.6b iii, runs: below
    and ``tests/test_torch_mesh_video.py``)."""
    bundle = registry.get("wan-i2v-tiny")
    ctx, _ = bundle.text_encoder.encode(["a"])
    args = dict(seed=1, frames=FRAMES, steps=1, mode=mode)
    if node is TPUImg2Video:
        args["image"] = torch.zeros(1, HW, HW, 3)
    else:
        args.update(width=HW, height=HW)
    with pytest.raises(ValidationError, match=item):
        node().execute(bundle, {"context": ctx}, **args)


@pytest.mark.parametrize("node", [TPUTxt2Video, TPUImg2Video])
def test_video_nodes_run_sp_on_one_rank_as_dp(registry, node):
    """Without a mesh of more than one rank ``sp`` is the ``dp`` run (the
    JAX node's ``{"sp": 1}`` mesh), bitwise."""
    bundle = registry.get("wan-i2v-tiny" if node is TPUImg2Video
                          else "wan-tiny")
    ctx, _ = bundle.text_encoder.encode(["a"])
    args = dict(seed=1, frames=FRAMES, steps=1)
    if node is TPUImg2Video:
        args["image"] = torch.zeros(1, HW, HW, 3)
    else:
        args.update(width=HW, height=HW)
    sp = node().execute(bundle, {"context": ctx}, mode="sp", **args)[0]
    dp = node().execute(bundle, {"context": ctx}, mode="dp", **args)[0]
    assert sp.shape == (FRAMES, HW, HW, 3) and torch.equal(sp, dp)


@pytest.mark.parametrize("node", [TPUTxt2Video, TPUImg2Video])
def test_video_nodes_run_offloaded(registry, node):
    """``mode="offload"`` (refused until ROADMAP A.5) runs the node
    through the offload executor: ``native`` blocks give the ``dp``
    video."""
    name = "wan-i2v-tiny" if node is TPUImg2Video else "wan-tiny"
    bundle = registry.get(name)
    ctx, _ = bundle.text_encoder.encode(["a"])
    args = dict(seed=1, frames=FRAMES, steps=2, cfg=3.0)
    if node is TPUImg2Video:
        args["image"] = torch.full((1, HW, HW, 3), 0.4)
    else:
        args.update(width=HW, height=HW)
    (dp,) = node().execute(bundle, {"context": ctx}, **args)
    old = os.environ.get("CDT_OFFLOAD_STREAM_DTYPE")
    os.environ["CDT_OFFLOAD_STREAM_DTYPE"] = "native"
    try:
        (off,) = node().execute(bundle, {"context": ctx}, mode="offload",
                                **args)
    finally:
        if old is None:
            os.environ.pop("CDT_OFFLOAD_STREAM_DTYPE")
        else:
            os.environ["CDT_OFFLOAD_STREAM_DTYPE"] = old
    assert off.shape == dp.shape
    torch.testing.assert_close(off, dp, atol=2e-4, rtol=2e-4)


def test_i2v_node_refuses_a_t2v_architecture(registry):
    bundle = registry.get("wan-tiny")
    ctx, _ = bundle.text_encoder.encode(["a"])
    with pytest.raises(ValidationError, match="t2v architecture"):
        TPUImg2Video().execute(bundle, {"context": ctx},
                               image=torch.zeros(HW, HW, 3), seed=1,
                               frames=FRAMES, steps=1)


def test_video_node_defaults(registry):
    """``shift=None`` is WAN's 3.0; a conditioning without ``pooled``
    samples with zeros of the transformer's pooled width."""
    bundle = registry.get("wan-tiny-3d")
    ctx, pooled = bundle.text_encoder.encode(["a"])
    args = dict(seed=4, frames=FRAMES, steps=1, width=HW, height=HW)
    (a,) = TPUTxt2Video().execute(bundle, {"context": ctx}, **args)
    (b,) = TPUTxt2Video().execute(bundle, {"context": ctx, "pooled": pooled},
                                  shift=3.0, **args)
    assert torch.equal(a, b) and a.shape == (FRAMES, HW, HW, 3)


def _params(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_params_equal(module, ref: dict):
    got = module.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_two_expert_files_convert_and_load(tmp_path, capsys):
    name = "wan-2.2-tiny"
    src = ModelBundle(PRESETS[name], "cpu", seed=3)
    hi, lo = _params(src.core), _params(src.pipeline.dit_low)
    assert any(not torch.equal(hi[k], lo[k]) for k in hi)   # two experts
    files = tmp_path / "files"
    files.mkdir()
    save_file(tconvert.export_wan(src.core, tconvert.WAN_PREFIXED),
              files / f"{name}.high.safetensors")
    save_file(tconvert.export_wan(src.pipeline.dit_low),
              files / f"{name}.low.safetensors")
    # loaded by name from the checkpoint root
    bundle = ModelRegistry("cpu", checkpoint_root=files).get(name)
    _assert_params_equal(bundle.core, hi)
    _assert_params_equal(bundle.pipeline.dit_low, lo)
    # through convert --checkpoint-low, then restored
    out = tmp_path / "root" / name
    base = ["convert", "--preset", name, "--checkpoint",
            str(files / f"{name}.high.safetensors"), "--out", str(out),
            "--device", "cpu"]
    assert cli(base) == 2
    assert "--checkpoint-low" in capsys.readouterr().err and not out.exists()
    assert cli(base + ["--checkpoint-low",
                       str(files / f"{name}.low.safetensors")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "core_low" in line["entries"]
    manifest = json.loads((out / treg.MANIFEST).read_text())
    assert manifest["wan_layers"] == 2 and manifest["arch"] == {"kind": "video"}
    restored = ModelRegistry("cpu", checkpoint_root=out.parent).get(name)
    _assert_params_equal(restored.core, hi)
    _assert_params_equal(restored.pipeline.dit_low, lo)
    # one expert alone is refused
    (files / f"{name}.low.safetensors").unlink()
    with pytest.raises(ValidationError, match="incomplete"):
        ModelRegistry("cpu", checkpoint_root=files).get(name)


def test_umt5_and_cut_wan_files_through_a_bundle(tmp_path):
    """A tiny ``umt5`` preset: the UMT5 file (HF layout, tied embedding)
    and a WAN file of one block (the file's depth builds the core), saved
    with ``save_checkpoint`` and restored bitwise."""
    preset = dataclasses.replace(PRESETS["wan-tiny-3d"], name="wan-umt5-tiny",
                                 clip="umt5")
    src = ModelBundle(preset, "cpu", seed=5)
    stack = src.build_clip_stack()
    assert stack.tokenization_mode == "hash"
    assert stack.t5.config.per_layer_rel_bias and stack.t5.config.num_layers == 2
    sd = tconvert.export_wan(src.core)
    cut = {k: v for k, v in sd.items() if not k.startswith("blocks.1.")}
    save_file(cut, tmp_path / "wan.safetensors")
    save_file(tconvert.export_t5(stack.t5), tmp_path / "umt5.safetensors")
    fresh_preset = treg.preset_for_checkpoint(preset, tmp_path / "wan.safetensors")
    assert fresh_preset.video.num_layers == 1
    bundle = ModelBundle(fresh_preset, "cpu", empty_core=True)
    bundle.load_safetensors_checkpoint(tmp_path / "wan.safetensors")
    assert bundle.clip_stack is None
    bundle.load_text_encoder_files(t5=tmp_path / "umt5.safetensors")
    _assert_params_equal(bundle.clip_stack.t5, _params(stack.t5))
    with pytest.raises(ValidationError, match="flux stack only"):
        bundle.load_text_encoder_files(clip_l=tmp_path / "umt5.safetensors")
    ctx, pooled = bundle.text_encoder.encode(["a fox"])
    assert ctx.shape == (1, 16, 32) and not pooled.any()
    bundle.save_checkpoint(tmp_path / "saved")
    manifest = json.loads((tmp_path / "saved" / treg.MANIFEST).read_text())
    assert manifest["entries"] == ["core", "t5", "vae_dec", "vae_enc"]
    assert manifest["wan_layers"] == 1 and manifest["tiny_clip"] is True
    restored = ModelBundle(treg.preset_for_checkpoint(preset, tmp_path / "saved"),
                           "cpu", empty_core=True)
    restored.load_checkpoint(tmp_path / "saved")
    _assert_params_equal(restored.core, _params(bundle.core))
    _assert_params_equal(restored.clip_stack.t5, _params(stack.t5))
    with pytest.raises(tconvert.ConversionError, match="WAN 3D"):
        restored.load_vae_file(tmp_path / "umt5.safetensors")
