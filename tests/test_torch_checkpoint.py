"""Checkpoints end to end on the CPU against the JAX package: a tiny
SDXL-layout single file under ``CDT_CHECKPOINT_ROOT`` run through the
port's graph (``CheckpointLoader`` → two ``CLIPTextEncode`` →
``TPUTxt2Img``), the same graph with ``LoraLoader``, and the bundle
converted by ``python -m comfyui_distributed_tpu_torch convert`` and
restored; each image within 2e-4 of the JAX package's from the same file
with JAX's initial noise handed over. Also the refusals (an orbax
directory, an architecture mismatch, the unported ``convert`` flags),
the encoder identities, and the upscaler and ControlNet loader nodes on
files."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")
st_numpy = pytest.importorskip("safetensors.numpy")

from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.models import convert as jconvert  # noqa: E402
from comfyui_distributed_tpu.models import lora as jlora  # noqa: E402
from comfyui_distributed_tpu.models import registry as jreg  # noqa: E402
from comfyui_distributed_tpu.parallel.mesh import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.__main__ import main as cli  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe  # noqa: E402
from comfyui_distributed_tpu_torch.graph import GraphExecutor  # noqa: E402
from comfyui_distributed_tpu_torch.graph.node import get_node  # noqa: E402
from comfyui_distributed_tpu_torch.models import convert as tconvert  # noqa: E402
from comfyui_distributed_tpu_torch.models import lora as tlora  # noqa: E402
from comfyui_distributed_tpu_torch.models import registry as treg  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry  # noqa: E402
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError  # noqa: E402
from comfyui_distributed_tpu_torch.utils.safetensors import SafetensorsError  # noqa: E402
from torch_ckpt_fixtures import jax_bundle, port_from_jax, presets  # noqa: E402

TOL = 2e-4
NAME = "tiny-sdxl"
POS, NEG = "a lighthouse at dawn", "blurry"
SEED, STEPS, HW, CFG = 11, 3, 16, 5.0


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The file under a checkpoint root, a LoRA for it, and the JAX
    bundle converted from the file."""
    jp, tp = presets("sdxl", name=NAME)
    src = port_from_jax(tp, jax_bundle(jp, seed=21))
    root = tmp_path_factory.mktemp("root")
    path = root / f"{NAME}.safetensors"
    st_numpy.save_file({k: v.detach().numpy().copy() for k, v in
                        tconvert.export_checkpoint(src).items()}, str(path))
    jb = jreg.ModelBundle(jp)
    jb.build_clip_stack(tiny=True)
    jconvert.convert_checkpoint(path, jb)
    rng = np.random.default_rng(22)
    lora = {}
    for prefix, conv_prefix, recs in (
            ("lora_unet_", "model.diffusion_model.", tlora.unet_records(tp.unet)),
            ("lora_te1_text_model_", "text_model.",
             tlora.clip_hf_records(src.clip_stack.clip_l.config)),
            ("lora_te2_text_model_", "text_model.",
             tlora.clip_hf_records(src.clip_stack.clip_g.config))):
        tree = {"lora_unet_": src.core, "lora_te1_text_model_": src.clip_stack.clip_l,
                "lora_te2_text_model_": src.clip_stack.clip_g}[prefix]
        params = dict(tree.named_parameters())
        for key, dst, _ in recs:
            if not key.endswith(".weight") or not any(
                    s in key for s in ("to_q", "to_v", "ff.net.2", "q_proj",
                                       "fc1")):
                continue
            n_out, n_in = params[dst].shape[0], params[dst][0].numel()
            base = prefix + key[len(conv_prefix):-len(".weight")].replace(".", "_")
            lora[f"{base}.lora_down.weight"] = (
                rng.standard_normal((4, n_in)) / n_in ** 0.5).astype(np.float32)
            lora[f"{base}.lora_up.weight"] = (
                rng.standard_normal((n_out, 4)) * 0.2).astype(np.float32)
            lora[f"{base}.alpha"] = np.array(4.0, np.float32)
    (root / "loras").mkdir()
    st_numpy.save_file(lora, str(root / "loras" / "style.safetensors"))
    return dict(jp=jp, tp=tp, root=root, path=path, jb=jb, lora=lora)


@pytest.fixture
def env(ckpt, monkeypatch):
    monkeypatch.setitem(treg.PRESETS, NAME, ckpt["tp"])
    monkeypatch.setenv("CDT_CHECKPOINT_ROOT", str(ckpt["root"]))
    for var in ("CDT_LORA_DIR", "CDT_TOKENIZER_DIR", "CDT_UPSCALE_MODEL_DIR",
                "CDT_CONTROLNET_DIR"):
        monkeypatch.delenv(var, raising=False)
    # JAX's initial noise for the port's sampler (participant 0's key)
    k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(SEED), 0))
    noise = np.array(jax.random.normal(k_noise, (1, HW // 2, HW // 2, 4),
                                       jnp.float32))
    monkeypatch.setattr(tpipe.Txt2ImgPipeline, "initial_noise",
                        lambda self, spec, gen: torch.from_numpy(noise))
    get_node("LoraLoader")._cache.clear()
    yield ckpt
    get_node("LoraLoader")._cache.clear()


def _graph(lora=None):
    model, clip = (["9", 0], ["9", 1]) if lora else (["1", 0], ["1", 1])
    prompt = {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": NAME}},
        "2": {"class_type": "CLIPTextEncode", "inputs": {"text": POS, "clip": clip}},
        "3": {"class_type": "CLIPTextEncode", "inputs": {"text": NEG, "clip": clip}},
        "5": {"class_type": "TPUTxt2Img", "inputs": {
            "model": model, "positive": ["2", 0], "negative": ["3", 0],
            "seed": SEED, "steps": STEPS, "cfg": CFG, "width": HW, "height": HW,
            "sampler_name": "euler", "scheduler": "karras"}},
    }
    if lora:
        prompt["9"] = {"class_type": "LoraLoader", "inputs": {
            "model": ["1", 0], "clip": ["1", 1], "lora_name": "style",
            "strength_model": lora[0], "strength_clip": lora[1]}}
    return prompt


def _run(registry, lora=None):
    out = GraphExecutor({"model_registry": registry}).execute(_graph(lora))
    return out["5"][0].numpy(), out


def _jax_image(bundle, encoder):
    ctx, pooled = encoder.encode([POS])
    unc, upooled = encoder.encode([NEG])
    adm = bundle.preset.unet.adm_in_channels
    spec = jpipe.GenerationSpec(height=HW, width=HW, steps=STEPS, sampler="euler",
                                scheduler="karras", guidance_scale=CFG)
    return np.asarray(bundle.pipeline.generate(
        build_mesh({"dp": 1}), spec, SEED, ctx, unc,
        np.asarray(pooled)[:, :adm], np.asarray(upooled)[:, :adm]))


def test_single_file_under_checkpoint_root_matches_jax(env):
    registry = ModelRegistry("cpu")
    assert registry.checkpoint_root == env["root"]
    img, out = _run(registry)
    bundle = out["1"][0]
    assert out["1"][1] is bundle.text_encoder
    assert bundle.text_encoder.tokenization_mode == "hash"
    ref = _jax_image(env["jb"], env["jb"].text_encoder)
    assert img.shape == ref.shape == (1, HW, HW, 3)
    np.testing.assert_allclose(img, ref, atol=TOL, rtol=TOL)
    # provenance: the file's name, not a seed
    assert f"ckpt:{NAME}.safetensors" in bundle.text_encoder._cdt_encoder_id
    assert bundle.weights_identity().startswith(f"{NAME}/ckpt:")
    random = ModelRegistry("cpu", checkpoint_root=env["root"] / "none").get(NAME)
    assert "/text/seed0:torch" in random.text_encoder._cdt_encoder_id
    assert random.clip_stack is None


def test_lora_loader_graph_matches_jax(env, monkeypatch):
    registry = ModelRegistry("cpu")
    base, _ = _run(registry)
    img, out = _run(registry, lora=(0.8, 0.9))
    assert out["9"][0].lora_merged[2] == 0
    patched, cond = jlora.apply_lora(env["jb"], env["lora"], strength_model=0.8,
                                     strength_clip=0.9)
    ref = _jax_image(patched, cond)
    np.testing.assert_allclose(img, ref, atol=TOL, rtol=TOL)
    assert np.abs(img - base).max() > 1e-3
    zero, _ = _run(registry, lora=(0.0, 0.0))
    np.testing.assert_array_equal(zero, base)
    again, _ = _run(registry)
    np.testing.assert_array_equal(again, base)
    # CDT_LORA_DIR wins over <checkpoint root>/loras
    monkeypatch.setenv("CDT_LORA_DIR", str(env["root"] / "nowhere"))
    get_node("LoraLoader")._cache.clear()
    with pytest.raises(ValidationError, match="LoRA 'style' not found"):
        _run(registry, lora=(1.0, 1.0))


def test_convert_cli_then_restore_matches_jax(env, tmp_path, capsys):
    out_dir = tmp_path / "converted" / NAME
    assert cli(["convert", "--preset", NAME, "--checkpoint", str(env["path"]),
                "--out", str(out_dir), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["entries"] == ["clip_g", "clip_l", "core", "vae_dec", "vae_enc"]
    manifest = json.loads((out_dir / treg.MANIFEST).read_text())
    assert manifest["arch"] == {"kind": "unet"} and manifest["tiny_clip"] is True
    registry = ModelRegistry("cpu", checkpoint_root=out_dir.parent)
    img, out = _run(registry)
    assert out["1"][0].clip_stack is not None
    ref = _jax_image(env["jb"], env["jb"].text_encoder)
    np.testing.assert_allclose(img, ref, atol=TOL, rtol=TOL)
    # the converted directory wins over a single file beside it
    assert registry.checkpoint_for(NAME) == out_dir


@pytest.mark.parametrize("args,match", [
    # FLUX's text-encoder files are ported: on a preset whose single file
    # bundles its encoders they are refused (ids kept from when they
    # named item A.7b), and a missing file is refused before any work
    pytest.param(["--t5", "t5.safetensors"], "FLUX's text-encoder files",
                 id="args0-A.7b"),
    pytest.param(["--preset", "flux", "--clip-l", "l.safetensors"],
                 "no such file", id="args1-A.7b"),
    (["--checkpoint-low", "low.safetensors"], "item 15"),
    (["--preset", "tiny"], "no single-file checkpoint layout"),
])
def test_convert_cli_refusals(args, match, tmp_path, capsys):
    argv = ["convert", "--checkpoint", "x.safetensors", "--out",
            str(tmp_path / "o"), "--device", "cpu"] + args
    assert cli(argv) == 2
    assert match in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


def test_restore_refusals(env, tmp_path):
    root = tmp_path / "r"
    (root / NAME / "state").mkdir(parents=True)
    with pytest.raises(ValidationError, match="orbax"):
        ModelRegistry("cpu", checkpoint_root=root).get(NAME)
    bundle = ModelRegistry("cpu").get(NAME)
    bundle.save_checkpoint(root / "saved")
    manifest = json.loads((root / "saved" / treg.MANIFEST).read_text())
    manifest["arch"] = {"kind": "dit", "pos_embed": "rope"}
    (root / "saved" / treg.MANIFEST).write_text(json.dumps(manifest))
    fresh = treg.ModelBundle(env["tp"], "cpu", empty_core=True)
    with pytest.raises(ValidationError, match="re-convert"):
        fresh.load_checkpoint(root / "saved")
    with pytest.raises(ValidationError, match="not a converted checkpoint"):
        fresh.load_checkpoint(root / "missing")


def test_upscaler_and_controlnet_nodes_load_files(env, monkeypatch, tmp_path):
    from comfyui_distributed_tpu_torch.models.controlnet import init_controlnet
    from comfyui_distributed_tpu_torch.models.unet import UNetConfig
    from comfyui_distributed_tpu_torch.models.upscaler import (RRDBNet,
                                                               UpscalerConfig)

    gen = torch.Generator().manual_seed(3)
    up_src = treg._random(lambda: RRDBNet(UpscalerConfig.tiny(scale=2)),
                          torch.device("cpu"), gen)
    cn_src = init_controlnet(UNetConfig.sd15(), "cpu", seed=4).model
    root = env["root"]
    for sub, sd in (("upscalers", tconvert.export_upscaler(up_src, "old")),
                    ("controlnet", tconvert.export_controlnet(cn_src))):
        (root / sub).mkdir(exist_ok=True)
        st_numpy.save_file({k: v.detach().float().numpy() for k, v in sd.items()},
                           str(root / sub / "mine.safetensors"))
    registry = ModelRegistry("cpu")
    (up,) = get_node("UpscaleModelLoader")().execute("mine", model_registry=registry)
    assert up.name == "mine" and up.scale == 2
    for (k, p), q in zip(up.model.named_parameters(), up_src.parameters()):
        assert torch.equal(p, q), k
    img = torch.rand(1, 8, 8, 3, generator=gen)
    assert torch.equal(up.apply(img), up_src(img))
    (cn,) = get_node("ControlNetLoader")().execute("mine.safetensors",
                                                   model_registry=registry)
    assert cn.model.config == UNetConfig.sd15() and cn.name == "mine"
    assert all(torch.equal(p, q) for p, q in zip(cn.model.parameters(),
                                                 cn_src.parameters()))
    assert get_node("ControlNetLoader")().execute(
        "mine.safetensors", model_registry=registry)[0] is cn
    # a preset name without a file stays random-init; a directory knob
    # wins over the checkpoint root
    (tiny,) = get_node("UpscaleModelLoader")().execute("tiny-x2",
                                                       model_registry=registry)
    assert tiny.name == "tiny-x2"
    monkeypatch.setenv("CDT_UPSCALE_MODEL_DIR", str(tmp_path))
    with pytest.raises(ValidationError, match="unknown upscale model"):
        get_node("UpscaleModelLoader")().execute("mine", model_registry=registry)
    (tmp_path / "mine.safetensors").write_bytes(b"\0" * 8)
    with pytest.raises(SafetensorsError):
        get_node("UpscaleModelLoader")().execute("mine", model_registry=registry)
