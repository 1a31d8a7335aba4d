"""The PyTorch port stands alone: importing any of its modules loads
neither JAX, flax nor the JAX package, nor a package the card's machine
is not promised (aiohttp, Pillow, websockets, safetensors, transformers,
regex, OpenCV: only the mp4/webm branch of ``utils/video_io.py`` imports
``cv2``, inside the call), and its entry points
refuse to run without a card unless the caller asks for the CPU."""

import json
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import comfyui_distributed_tpu_torch as port

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "comfyui_distributed_tpu", "aiohttp", "PIL",
             "websockets", "safetensors", "transformers", "regex",
             "tokenizers", "sentencepiece", "cv2")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(port.__path__,
                                                        port.__name__ + "."))


def test_importing_every_port_module_loads_no_jax():
    modules = _port_modules()
    assert {"comfyui_distributed_tpu_torch.graph.nodes_builtin",
            "comfyui_distributed_tpu_torch.models.dit",
            "comfyui_distributed_tpu_torch.diffusion.pipeline_flow",
            "comfyui_distributed_tpu_torch.api.app",
            "comfyui_distributed_tpu_torch.__main__",
            "comfyui_distributed_tpu_torch.cluster.faults",
            "comfyui_distributed_tpu_torch.cluster.progress",
            "comfyui_distributed_tpu_torch.diffusion.progress",
            "comfyui_distributed_tpu_torch.utils.auth",
            "comfyui_distributed_tpu_torch.utils.websocket",
            "comfyui_distributed_tpu_torch.models.controlnet",
            "comfyui_distributed_tpu_torch.cluster.media_sync",
            "comfyui_distributed_tpu_torch.tiles.engine",
            "comfyui_distributed_tpu_torch.utils.safetensors",
            "comfyui_distributed_tpu_torch.models.tokenizer",
            "comfyui_distributed_tpu_torch.models.clip",
            "comfyui_distributed_tpu_torch.models.convert",
            "comfyui_distributed_tpu_torch.models.lora",
            "comfyui_distributed_tpu_torch.utils.jpeg",
            "comfyui_distributed_tpu_torch.utils.video_io",
            "comfyui_distributed_tpu_torch.utils.audio_payload"} <= set(modules)
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert bad == []


# OpenCV is imported inside a call only: by the mp4/webm branch of the
# video I/O, and by chip_smoke.py to report whether the card's machine has it
LAZY_CV2 = {Path(port.__path__[0]) / "utils" / "video_io.py", ROOT / "chip_smoke.py"}


def test_port_sources_name_no_jax_package():
    for path in [*Path(port.__path__[0]).rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                if top == "cv2" and path in LAZY_CV2 and line.startswith(" "):
                    continue
                assert top not in FORBIDDEN, f"{path}: {line}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_card(no_card, tmp_path):
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry()
    from comfyui_distributed_tpu_torch.graph.node import get_node
    from comfyui_distributed_tpu_torch.models.controlnet import init_controlnet
    from comfyui_distributed_tpu_torch.models.unet import UNetConfig

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_controlnet(UNetConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_node("ControlNetLoader")().execute("tiny")
    for workflow in ("distributed-txt2img.json", "flux-txt2img.json"):
        prompt = strip_meta(json.loads((ROOT / "workflows" / workflow).read_text()))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphExecutor({"output_dir": str(tmp_path)}).execute(prompt)
    assert list(tmp_path.iterdir()) == []
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_serve_refuses_without_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "CDT_CONFIG_PATH": str(tmp_path / "cfg.json")}
    proc = subprocess.run(
        [sys.executable, "-m", "comfyui_distributed_tpu_torch", "serve",
         "--port", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert not (tmp_path / "cfg.json").exists()


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = _smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
