"""FLUX's files through the port (``convert.convert_flux``,
``load_text_encoder_files``, ``load_vae_file``, the ``convert`` CLI, the
registry) against the JAX package, on tiny fp32 towers with seeded
weights:

- ``convert_flux`` on a BFL-layout dict (bare and under
  ``model.diffusion_model.``) written by the port's exporter against JAX
  ``convert_flux``: equal trees, every parameter back, the converted
  DiT's velocity within 2e-4 of JAX's; the schnell and diffusers files
  refused by both;
- ``flux-tiny`` through ``convert --preset flux-tiny`` (BF16 transformer,
  F32 ``ae.safetensors`` whose encoder is shape-checked and dropped),
  ``save_checkpoint`` and a registry restore: parameters bitwise, the
  workflow's image bitwise the source bundle's;
- a tiny preset with the T5 + CLIP-L stack (``clip="flux"``) through
  ``convert --t5 --clip-l`` with T5 in F8_E4M3 (the published
  ``t5xxl_fp8_e4m3fn`` dtype): the stack restored bitwise, its encoding
  bitwise the source's, the workflow run on it.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.models import convert as jconvert  # noqa: E402
from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu_torch.__main__ import main as cli  # noqa: E402
from comfyui_distributed_tpu_torch.graph import GraphExecutor  # noqa: E402
from comfyui_distributed_tpu_torch.graph.executor import strip_meta  # noqa: E402
from comfyui_distributed_tpu_torch.models import convert as tconvert  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import registry as treg  # noqa: E402
from comfyui_distributed_tpu_torch.models.convert import ConversionError  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.models.vae import AutoencoderKL  # noqa: E402
from comfyui_distributed_tpu_torch.utils.safetensors import save_file  # noqa: E402
from test_torch_dit import _dit_inputs, break_zero_init  # noqa: E402

TOL = 2e-4
ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _dit_pair(seed=0):
    jcfg = jdit.DiTConfig.tiny(dtype="float32", pos_embed="rope")
    model, params = jdit.init_dit(jcfg, jax.random.key(seed), sample_hw=(8, 8),
                                  context_len=16)
    params = break_zero_init(params, seed + 10)
    tcfg = tdit.DiTConfig.tiny(dtype="float32", pos_embed="rope")
    return jcfg, model, params, load_from_jax(tdit.DiT(tcfg), params).eval()


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("prefix", ["", tconvert.FLUX_PREFIXED],
                         ids=["bare", "prefixed"])
def test_convert_flux_matches_jax(prefix):
    jcfg, model, params, port = _dit_pair()
    sd = {k: v.detach().clone() for k, v in
          tconvert.export_flux(port, prefix).items()}
    assert tconvert.detect_layout(sd) == jconvert.detect_layout(sd) == "flux"
    assert tconvert.flux_prefix_of(sd) == prefix
    h = jcfg.hidden
    assert sd[f"{prefix}single_blocks.0.linear1.weight"].shape == (7 * h, h)
    assert sd[f"{prefix}final_layer.adaLN_modulation.1.weight"].shape == (2 * h, h)
    template = jdit.init_dit(jcfg, jax.random.key(0), sample_hw=(8, 8),
                             context_len=16, abstract=True)[1]
    jtree = jconvert.convert_flux({k: v.numpy() for k, v in sd.items()},
                                  template, jcfg, prefix)
    want = _leaves(params)
    # the final adaLN's gate third is not in the file: JAX puts zeros
    kernel = want["params/final_mod/mod/kernel"].copy()
    kernel[:, 2 * h:] = 0
    bias = want["params/final_mod/mod/bias"].copy()
    bias[2 * h:] = 0
    want["params/final_mod/mod/kernel"], want["params/final_mod/mod/bias"] = kernel, bias
    got = _leaves(jtree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fresh = tdit.DiT(port.config)
    tconvert.convert_flux(sd, fresh, prefix)
    for name, p in port.named_parameters():
        expect = p
        if name.startswith("final_mod.mod."):
            expect = p.clone()
            expect[2 * h:] = 0
        assert torch.equal(fresh.get_parameter(name), expect), name
    # the round trip: exporting the converted DiT gives the file back
    again = tconvert.export_flux(fresh, prefix)
    assert sorted(again) == sorted(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    args = _dit_inputs(7)
    ref = np.asarray(model.apply(jtree, *args))
    with torch.no_grad():
        out = fresh(*(torch.from_numpy(np.array(a)) for a in args))
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_schnell_and_diffusers_files_are_refused():
    jcfg, _, _, port = _dit_pair(1)
    sd = {k: v.detach().clone() for k, v in tconvert.export_flux(port).items()
          if not k.startswith("guidance_in.")}
    with pytest.raises(ConversionError, match="guidance_embed=True"):
        tconvert.convert_flux(sd, tdit.DiT(port.config))
    template = jdit.init_dit(jcfg, jax.random.key(0), sample_hw=(8, 8),
                             context_len=16, abstract=True)[1]
    with pytest.raises(jconvert.ConversionError, match="guidance_embed=True"):
        jconvert.convert_flux({k: v.numpy() for k, v in sd.items()}, template,
                              jcfg)
    # a schnell-style config (no guidance input) takes the file
    schnell = tdit.DiT(dataclasses.replace(port.config, guidance_embed=False))
    tconvert.convert_flux(sd, schnell)
    diffusers = {"single_transformer_blocks.0.attn.to_q.weight": 0,
                 "transformer_blocks.0.attn.to_q.weight": 0}
    for detect, err in ((tconvert.detect_layout, ConversionError),
                        (jconvert.detect_layout, jconvert.ConversionError)):
        with pytest.raises(err, match="diffusers-repacked FLUX"):
            detect(diffusers)


def _flux_workflow(name: str, seed: int = 5) -> dict:
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "flux-txt2img.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = name
    prompt["3"]["inputs"]["seed"] = seed
    prompt["4"]["inputs"].update(width=16, height=16, steps=2)
    return prompt


def _run(registry, name, tmp_path):
    out = GraphExecutor({"model_registry": registry,
                         "output_dir": str(tmp_path / "out")}).execute(
        _flux_workflow(name))
    return out["5"][0], out["1"][0]


def _write_ae(bundle, path, seed=3):
    """BFL's ``ae.safetensors`` (F32, no quant convs): the bundle's
    decoder with its post-quant conv the identity (a BFL VAE has none),
    and an encoder drawn from ``seed``."""
    vae = bundle.pipeline.vae
    z = vae.config.latent_channels
    with torch.no_grad():
        vae.decoder.post_quant_conv.weight.copy_(torch.eye(z)[:, :, None, None])
        vae.decoder.post_quant_conv.bias.zero_()
    full = treg._random(lambda: AutoencoderKL(vae.config, encoder=True),
                        torch.device("cpu"), torch.Generator().manual_seed(seed))
    full.decoder.load_state_dict(vae.decoder.state_dict())
    sd = tconvert.export_vae(full, quant_convs=False)
    assert not any("quant_conv" in k for k in sd)
    save_file(sd, path, dtype=torch.float32)
    return sd


def _as_published(bundle):
    """Round the DiT through BF16 (the published dtype; its fp32
    ``img_out`` and qk-norm scales too) and zero the final adaLN's gate
    third, which the BFL layout does not hold (the final layer never
    reads it)."""
    h = bundle.core.config.hidden
    with torch.no_grad():
        for p in bundle.core.parameters():
            p.copy_(p.to(torch.bfloat16))
        bundle.core.final_mod.mod.weight[2 * h:].zero_()
        bundle.core.final_mod.mod.bias[2 * h:].zero_()
    return bundle


def _params(bundle):
    return {f"{e}.{n}": p for e, m in bundle._state_entries().items()
            for n, p in m.named_parameters()}


def test_flux_tiny_convert_cli_and_restore(tmp_path, capsys):
    source = _as_published(treg.ModelRegistry("cpu", seed=0).get("flux-tiny"))
    save_file(tconvert.export_flux(source.core), tmp_path / "flux.safetensors",
              dtype=torch.bfloat16)
    ae = _write_ae(source, tmp_path / "ae.safetensors")
    src_registry = treg.ModelRegistry("cpu", seed=0)
    src_registry._cache["flux-tiny"] = source
    ref, _ = _run(src_registry, "flux-tiny", tmp_path)
    out_dir = tmp_path / "root" / "flux-tiny"
    assert cli(["convert", "--preset", "flux-tiny", "--checkpoint",
                str(tmp_path / "flux.safetensors"), "--vae",
                str(tmp_path / "ae.safetensors"), "--out", str(out_dir),
                "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["entries"] == ["core", "text", "vae_dec"]
    manifest = json.loads((out_dir / treg.MANIFEST).read_text())
    assert manifest["arch"] == {"kind": "dit", "pos_embed": "sincos",
                                "rope_theta": 10000.0, "rope_axes_dim": None}
    registry = treg.ModelRegistry("cpu", checkpoint_root=out_dir.parent)
    img, bundle = _run(registry, "flux-tiny", tmp_path)
    src = _params(source)
    assert sorted(_params(bundle)) == sorted(src)
    for k, p in _params(bundle).items():
        assert torch.equal(p, src[k]), k
    assert torch.equal(img, ref) and img.shape == (1, 16, 16, 3)
    # the file's encoder is checked: a wrong shape fails the load
    bad = dict(ae)
    bad["encoder.conv_in.weight"] = torch.zeros(1, 3, 3, 3)
    save_file(bad, tmp_path / "bad_ae.safetensors")
    with pytest.raises(ConversionError, match="encoder.conv_in"):
        bundle.load_vae_file(tmp_path / "bad_ae.safetensors")


@pytest.fixture
def flux_t5_preset(monkeypatch):
    """``flux-tiny`` with the tiny T5 + CLIP-L stack (pooled 32 wide)."""
    base = treg.PRESETS["flux-tiny"]
    preset = dataclasses.replace(
        base, name="flux-tiny-t5", clip="flux",
        dit=dataclasses.replace(base.dit, pooled_dim=32))
    monkeypatch.setitem(treg.PRESETS, preset.name, preset)
    monkeypatch.delenv("CDT_T5_TOKENIZER_DIR", raising=False)
    monkeypatch.delenv("CDT_TOKENIZER_DIR", raising=False)
    return preset


def test_flux_text_encoder_files_through_convert(flux_t5_preset, tmp_path,
                                                 capsys):
    name = flux_t5_preset.name
    source = _as_published(treg.ModelBundle(flux_t5_preset, "cpu", seed=4))
    stack = source.build_clip_stack()
    assert source.text_encoder is stack and stack.tokenization_mode == "hash"
    with torch.no_grad():                 # T5 held exactly by an e4m3 file
        for p in stack.t5.parameters():
            p.copy_(p.to(torch.float8_e4m3fn).float())
    save_file(tconvert.export_flux(source.core), tmp_path / "flux.safetensors",
              dtype=torch.bfloat16)
    save_file(tconvert.export_t5(stack.t5), tmp_path / "t5.safetensors",
              dtype=torch.float8_e4m3fn)
    save_file(tconvert.export_clip_hf(stack.clip_l),
              tmp_path / "clip_l.safetensors")
    _write_ae(source, tmp_path / "ae.safetensors")
    prompts = ["an isometric papercraft city at golden hour"]
    ctx, pooled = stack.encode(prompts)
    out_dir = tmp_path / "root" / name
    assert cli(["convert", "--preset", name, "--checkpoint",
                str(tmp_path / "flux.safetensors"), "--t5",
                str(tmp_path / "t5.safetensors"), "--clip-l",
                str(tmp_path / "clip_l.safetensors"), "--vae",
                str(tmp_path / "ae.safetensors"), "--out", str(out_dir),
                "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["entries"] == ["clip_l", "core", "t5", "vae_dec"]
    assert json.loads((out_dir / treg.MANIFEST).read_text())["tiny_clip"]
    registry = treg.ModelRegistry("cpu", checkpoint_root=out_dir.parent)
    img, bundle = _run(registry, name, tmp_path)
    assert bundle.text_encoder is bundle.clip_stack
    src = _params(source)
    for k, p in _params(bundle).items():
        assert torch.equal(p, src[k]), k
    assert sorted(_params(bundle)) == sorted(src)
    ctx2, pooled2 = bundle.text_encoder.encode(prompts)
    assert torch.equal(ctx2, ctx) and torch.equal(pooled2, pooled)
    assert ctx.shape == (1, 16, 32) and pooled.shape == (1, 32)
    assert torch.isfinite(img).all() and img.shape == (1, 16, 16, 3)


def test_text_encoder_files_need_the_flux_stack(tmp_path):
    bundle = treg.ModelBundle(treg.PRESETS["flux-tiny"], "cpu")
    with pytest.raises(treg.ValidationError, match="flux-stack feature"):
        bundle.load_text_encoder_files(t5=tmp_path / "t5.safetensors")


def test_depths_are_read_from_the_files(flux_t5_preset, tmp_path, capsys):
    """A FLUX file with fewer blocks and a T5 file with fewer layers (a
    lighter variant, or files cut in depth) build a core and a stack of
    their depths, widths from the preset; the manifest keeps the depths
    for the restore."""
    name = flux_t5_preset.name
    source = _as_published(treg.ModelBundle(flux_t5_preset, "cpu", seed=6))
    stack = source.build_clip_stack()
    cfg = source.core.config
    keep = lambda k: not (k.startswith("double_blocks.1.")      # noqa: E731
                          or k.startswith("single_blocks.1."))
    save_file({k: v for k, v in tconvert.export_flux(source.core).items()
               if keep(k)}, tmp_path / "flux.safetensors")
    save_file({k: v for k, v in tconvert.export_t5(stack.t5).items()
               if not k.startswith("encoder.block.1.")},
              tmp_path / "t5.safetensors")
    save_file(tconvert.export_clip_hf(stack.clip_l),
              tmp_path / "clip_l.safetensors")
    out_dir = tmp_path / "root" / name
    assert cli(["convert", "--preset", name, "--checkpoint",
                str(tmp_path / "flux.safetensors"), "--t5",
                str(tmp_path / "t5.safetensors"), "--clip-l",
                str(tmp_path / "clip_l.safetensors"), "--out", str(out_dir),
                "--device", "cpu"]) == 0
    manifest = json.loads((out_dir / treg.MANIFEST).read_text())
    assert manifest["depth"] == {"double": 1, "single": 1}
    assert manifest["t5_layers"] == 1
    bundle = treg.ModelRegistry("cpu", checkpoint_root=out_dir.parent).get(name)
    got = bundle.core.config
    assert (got.depth_double, got.depth_single) == (1, 1)
    assert (got.hidden, got.heads) == (cfg.hidden, cfg.heads)
    assert bundle.clip_stack.t5.config.num_layers == 1
    src = _params(source)
    for k, p in _params(bundle).items():
        if not k.startswith("vae_dec."):          # no --vae: random init
            assert torch.equal(p, src[k]), k
    assert bundle.text_encoder.encode(["a cat"])[0].shape == (1, 16, 32)
