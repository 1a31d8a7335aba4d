"""The port's SD3 family against the JAX package on the CPU (tiny presets,
fp32, 2e-4 at module and pipeline level, converted parameters bitwise):

- the ``sd3-tiny`` DiT forward with qk-norm off and on (learned position
  table centre-cropped to the patch grid), and the crop's error where the
  grid exceeds the table;
- ``SD3TextStack.encode``, its token signature and the tokenizer pair
  rule;
- ``convert_mmdit_sd3`` on a synthetic SAI file written by the port's
  exporter, bare and under ``model.diffusion_model.``: the parameters are
  JAX's bit for bit (the pre-only last context block, the final adaLN's
  zero gate third); both qk-norm mismatches, a non-pre-only last block,
  a leftover key and the diffusers repack are refused;
- the flow pipeline with true CFG (``cfg`` 4.5, a negative), JAX's noise
  handed over; a missing negative raises;
- ``ModelSamplingSD3``: the shift the flow and video nodes read when
  their own is not wired;
- the SD3 graph (``CheckpointLoader`` → 2× ``CLIPTextEncode`` →
  ``ModelSamplingSD3`` → ``TPUFlowTxt2Img`` → ``SaveImage``) through both
  packages' ``GraphExecutor``, and served by a master and a ``remote``
  worker controller;
- SD3's files through the registry, ``convert`` and a restore.

The flax DiT zero-initialises every adaLN ``mod`` and ``img_out`` kernel
(every block the identity, the velocity 0), so the JAX trees here are
perturbed first (``test_torch_dit.break_zero_init``)."""

import dataclasses
import functools
import json
import socket
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline_flow as jflow  # noqa: E402
from comfyui_distributed_tpu.graph import executor as jexec  # noqa: E402
from comfyui_distributed_tpu.models import convert as jconvert  # noqa: E402
from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu.models import registry as jreg  # noqa: E402
from comfyui_distributed_tpu.models import t5 as jt5  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.__main__ import main as cli  # noqa: E402
from comfyui_distributed_tpu_torch.api.app import ServerThread  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.controller import Controller  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_flow as tflow  # noqa: E402
from comfyui_distributed_tpu_torch.graph import GraphExecutor, get_node  # noqa: E402
from comfyui_distributed_tpu_torch.models import clip as tclip  # noqa: E402
from comfyui_distributed_tpu_torch.models import convert as tconvert  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import registry as treg  # noqa: E402
from comfyui_distributed_tpu_torch.models import t5 as tt5  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.convert import ConversionError  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError  # noqa: E402
from comfyui_distributed_tpu_torch.utils.safetensors import save_file  # noqa: E402

from test_torch_dit import break_zero_init  # noqa: E402
from torch_ckpt_fixtures import perturbed  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
PREFIX = "model.diffusion_model."
PROMPTS = ["a lighthouse at dawn, oil painting", "blurry", ""]
SEED, HW, STEPS, CFG, SHIFT = 5, 16, 3, 4.5, 2.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(**kw):
    """(JAX, port) ``sd3_tiny`` in fp32 without ``tiny()``'s guidance
    embedder, which both packages' ``sd3_tiny`` keep and an SAI file does
    not carry."""
    kw = {"guidance_embed": False, **kw}
    return (dataclasses.replace(jdit.DiTConfig.sd3_tiny(), dtype="float32", **kw),
            tdit.DiTConfig.sd3_tiny(dtype="float32", **kw))


@pytest.fixture(autouse=True)
def _no_vocabularies(monkeypatch):
    monkeypatch.delenv("CDT_TOKENIZER_DIR", raising=False)
    monkeypatch.delenv("CDT_T5_TOKENIZER_DIR", raising=False)


# --- configuration and presets -----------------------------------------------


def test_sd3_configs_and_presets_match_jax():
    for name in ("sd3_medium", "sd35_large", "sd3_tiny"):
        jcfg, tcfg = getattr(jdit.DiTConfig, name)(), getattr(tdit.DiTConfig, name)()
        jfields = dataclasses.asdict(jcfg)
        assert {k: jfields[k] for k in dataclasses.asdict(tcfg)} \
            == dataclasses.asdict(tcfg), name
        assert tcfg.head_dim == jcfg.head_dim
    for name in ("sd3-medium", "sd35-large", "sd3-tiny"):
        jp, tp = jreg.PRESETS[name], treg.PRESETS[name]
        assert tp.kind == "dit" and tp.clip == jp.clip == "sd3"
        for field in ("vae", "text", "dit"):
            port = dataclasses.asdict(getattr(tp, field))
            ref = dataclasses.asdict(getattr(jp, field))
            assert {k: ref[k] for k in port} == port, (name, field)
    medium, large = treg.PRESETS["sd3-medium"].dit, treg.PRESETS["sd35-large"].dit
    assert (medium.heads * medium.head_dim, large.heads * large.head_dim) == (1536, 2432)
    assert (medium.qk_norm, large.qk_norm) == (False, True)
    (latent,) = get_node("EmptyLatentImage")().execute(
        1024, 1024, ckpt_name="sd3-medium", model_registry=treg.ModelRegistry("cpu"))
    assert tuple(latent["samples"].shape) == (1, 128, 128, 16)


# --- the DiT -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_dit(qk_norm: bool, seed: int):
    """The JAX sd3_tiny DiT, its jitted forward and its tree, gates
    perturbed (a tree is never mutated, so one init serves every test)."""
    jcfg, _ = _configs(qk_norm=qk_norm)
    model, params = jdit.init_dit(jcfg, jax.random.key(seed), sample_hw=(8, 8),
                                  context_len=16)
    return model, jax.jit(model.apply), break_zero_init(_np(params), seed + 10)


def _dit_pair(qk_norm: bool, seed: int = 0):
    _, forward, params = _jax_dit(qk_norm, seed)
    port = load_from_jax(tdit.DiT(_configs(qk_norm=qk_norm)[1]), params)
    return forward, params, port.eval()


def _dit_inputs(seed, B=2, h=8, w=6, T=16):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return r(B, h, w, 4), np.array([0.93, 0.21], np.float32)[:B], r(B, T, 32), r(B, 16)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_sd3_tiny_dit_matches_jax(qk_norm):
    forward, params, port = _dit_pair(qk_norm)
    has_scales = any("q_scale" in k for k in dict(port.named_parameters()))
    assert has_scales is qk_norm and port.pos_emb.shape == (144, 64)
    args = _dit_inputs(7)
    ref = np.asarray(forward(params, *args))
    with torch.no_grad():
        out = port(*map(_t, args))
        # the table is read: another table moves the velocity
        port.pos_emb.mul_(3.0)
        moved = port(*map(_t, args))
    assert out.shape == (2, 8, 6, 4) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert (moved - out).abs().max() > 1e-3


def test_learned_table_refuses_a_grid_past_its_side():
    forward, params, port = _dit_pair(False)
    args = _dit_inputs(8, h=26, w=6)         # 13 patch rows, table 12
    with pytest.raises(ValueError, match="learned position") as jerr:
        forward(params, *args)
    with pytest.raises(ValueError, match="learned position") as terr:
        port(*map(_t, args))
    assert str(terr.value).split(":")[0] == str(jerr.value).split(" —")[0]


# --- the text stack ----------------------------------------------------------


def _stacks():
    jstack = jt5.SD3TextStack.init_random(jax.random.key(3), tiny=True)
    for tower, seed in (("clip_l", 4), ("clip_g", 5), ("t5", 6)):
        getattr(jstack, tower).params = perturbed(
            _np(getattr(jstack, tower).params), seed)
    cfg_l, cfg_g, cfg_t5 = tt5.SD3TextStack.configs(tiny=True)
    port = tt5.SD3TextStack(
        load_from_jax(tclip.CLIPTextTransformer(cfg_l), jstack.clip_l.params),
        load_from_jax(tclip.CLIPTextTransformer(cfg_g), jstack.clip_g.params),
        load_from_jax(tt5.T5Encoder(cfg_t5), jstack.t5.params)).eval()
    return jstack, port


def test_sd3_text_stack_matches_jax(sd3_pair):
    jstack, port = _stacks()
    assert port.tokenization_mode == jstack.tokenization_mode == "hash"
    jctx, jpooled = jstack.encode(PROMPTS)
    ctx, pooled = port.encode(PROMPTS)
    # 16 CLIP tokens (16 + 16 wide, padded to T5's 32) + 16 T5 tokens
    assert ctx.shape == (3, 32, 32) and pooled.shape == (3, 16)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=TOL,
                               rtol=TOL)
    jsig, jmode = jstack.token_signature(PROMPTS)
    sig, mode = port.token_signature(PROMPTS)
    assert sig == [np.asarray(s).tolist() for s in jsig] and mode == jmode
    tok = tclip.CLIPBPETokenizer({"<|startoftext|>": 126, "<|endoftext|>": 127}, [],
                                 max_len=16)
    for pair in (dict(tok_l=tok), dict(tok_g=tok)):
        with pytest.raises(ValueError, match="both tok_l and tok_g"):
            tt5.SD3TextStack(port.clip_l, port.clip_g, port.t5, **pair)
    # a bundle carries the three towers (``load_from_jax(t5=, clip_l=,
    # clip_g=)``) and encodes with them
    jb = sd3_pair["jb"]
    bundle = treg.ModelBundle(sd3_pair["tp"], "cpu").load_from_jax(
        jb.pipeline.dit_params, _np(jb.pipeline.vae.dec_params),
        t5=jstack.t5.params, clip_l=jstack.clip_l.params,
        clip_g=jstack.clip_g.params)
    assert bundle.text_encoder is bundle.clip_stack
    assert sorted(bundle._state_entries()) == ["clip_g", "clip_l", "core", "t5",
                                               "vae_dec"]
    for a, b in zip(bundle.text_encoder.encode(PROMPTS), (ctx, pooled)):
        assert torch.equal(a, b)


# --- the converter -----------------------------------------------------------


def as_published(dit) -> None:
    """What an SAI file holds of a DiT: the last context block pre-only
    (its gates, second shift/scale and text outputs zero) and the final
    adaLN without its gate third."""
    h, last = dit.config.hidden, dit.config.depth_double - 1
    blk = getattr(dit, f"double_{last}")
    with torch.no_grad():
        blk.txt_mod.mod.weight[2 * h:].zero_()
        blk.txt_mod.mod.bias[2 * h:].zero_()
        for m in (blk.txt_proj, blk.txt_mlp_up, blk.txt_mlp_down):
            m.weight.zero_()
            m.bias.zero_()
        dit.final_mod.mod.weight[2 * h:].zero_()
        dit.final_mod.mod.bias[2 * h:].zero_()


def _sai_file(qk_norm: bool, prefix: str = "", seed: int = 0):
    """(source port DiT as published, the SAI state dict as numpy)."""
    _, _, port = _dit_pair(qk_norm, seed)
    as_published(port)
    sd = {k: v.detach().numpy().copy()
          for k, v in tconvert.export_mmdit_sd3(port, prefix).items()}
    return port, sd


@pytest.mark.parametrize("prefix", ["", PREFIX])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_convert_mmdit_sd3_is_bitwise_jax(qk_norm, prefix):
    source, sd = _sai_file(qk_norm, prefix)
    h = source.config.hidden
    assert jconvert.detect_layout(sd) == tconvert.detect_layout(sd) == "sd3"
    assert sd[f"{prefix}x_embedder.proj.weight"].shape == (h, 4, 2, 2)
    assert sd[f"{prefix}pos_embed"].shape == (1, 144, h)
    assert sd[f"{prefix}joint_blocks.1.context_block.adaLN_modulation.1.weight"
              ].shape == (2 * h, h)
    assert f"{prefix}joint_blocks.1.context_block.attn.proj.weight" not in sd
    assert f"{prefix}final_layer.adaLN_modulation.1.weight" in sd
    jcfg, tcfg = _configs(qk_norm=qk_norm)
    jtree = jconvert.convert_mmdit_sd3(sd, _template(jcfg), jcfg, prefix)
    port = tdit.DiT(tcfg)
    tconvert.convert_mmdit_sd3({k: torch.from_numpy(v) for k, v in sd.items()},
                               port, prefix)
    from_jax = load_from_jax(tdit.DiT(tcfg), _np(jtree))
    for name, p in port.state_dict().items():
        assert torch.equal(p, from_jax.state_dict()[name]), name
        assert torch.equal(p, source.state_dict()[name]), name


def _template(cfg):
    return _jax_dit(cfg.qk_norm, 0)[2]


@pytest.mark.parametrize("file_qk,preset_qk,match", [
    (True, False, "qk_norm=False"), (False, True, "qk-norm")])
def test_qk_norm_mismatch_raises_as_jax(file_qk, preset_qk, match):
    _, sd = _sai_file(file_qk)
    jcfg, tcfg = _configs(qk_norm=preset_qk)
    with pytest.raises(jconvert.ConversionError, match=match) as jerr:
        jconvert.convert_mmdit_sd3(sd, _template(jcfg), jcfg)
    with pytest.raises(ConversionError, match=match) as terr:
        tconvert.convert_mmdit_sd3({k: torch.from_numpy(v) for k, v in sd.items()},
                                   tdit.DiT(tcfg))
    assert str(terr.value).split(":")[0] == str(jerr.value).split(" —")[0]


@pytest.mark.parametrize("fault,match", [("six_rows", "pre-only"),
                                         ("extra", "unconsumed")])
def test_sd3_file_faults_raise(fault, match):
    _, sd = _sai_file(False)
    jcfg, tcfg = _configs(qk_norm=False)
    h = jcfg.hidden
    if fault == "six_rows":
        key = "joint_blocks.1.context_block.adaLN_modulation.1"
        sd[f"{key}.weight"] = np.zeros((6 * h, h), np.float32)
        sd[f"{key}.bias"] = np.zeros(6 * h, np.float32)
    else:
        sd["joint_blocks.9.x_block.attn.qkv.weight"] = np.zeros(1, np.float32)
    with pytest.raises(jconvert.ConversionError, match=match):
        jconvert.convert_mmdit_sd3(sd, _template(jcfg), jcfg)
    with pytest.raises(ConversionError, match=match):
        tconvert.convert_mmdit_sd3({k: torch.from_numpy(v) for k, v in sd.items()},
                                   tdit.DiT(tcfg))


def test_diffusers_repack_and_unet_preset_are_refused(sd3_pair, tmp_path):
    """Both refusals come before a module is touched: a bundle of the
    UNet kind stands in for a UNet preset's."""
    path = tmp_path / "x.safetensors"
    save_file({"transformer_blocks.0.attn.to_q.weight": torch.zeros(2)}, path)
    with pytest.raises(ConversionError, match="diffusers-repacked SD3"):
        tconvert.convert_checkpoint(path, sd3_pair["tb"])
    _, sd = _sai_file(False)
    save_file({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    unet = types.SimpleNamespace(kind="unet", preset=treg.PRESETS["tiny"])
    with pytest.raises(ConversionError, match="needs a dit preset"):
        tconvert.convert_checkpoint(path, unet)


# --- the flow pipeline with true CFG ---------------------------------------


@pytest.fixture(scope="module")
def sd3_pair():
    """The fp32 sd3-tiny stack in both packages with the same weights, as
    registry presets (JAX's bundle perturbed, the port's carrying it). The
    JAX registry's DiT is the DiT tests' one (the same config): its init
    compiles once."""
    jp = dataclasses.replace(
        jreg.PRESETS["sd3-tiny"], dit=_configs()[0],
        vae=jvae.VAEConfig.tiny(dtype="float32"),
        text=dataclasses.replace(jtext.TextEncoderConfig.tiny(), dtype="float32"))
    tp = dataclasses.replace(
        treg.PRESETS["sd3-tiny"], dit=_configs()[1],
        vae=tvae.VAEConfig.tiny(dtype="float32"),
        text=treg.TextEncoderConfig.tiny(dtype="float32"))
    jr = jreg.ModelRegistry()
    model, _, params = _jax_dit(False, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jreg.PRESETS, "sd3-tiny", jp)
        mp.setattr(jdit, "init_dit", lambda *a, **kw: (model, params))
        jb = jr.get("sd3-tiny")
    jb.pipeline.dit_params = break_zero_init(_np(jb.pipeline.dit_params), 3)
    tb = treg.ModelBundle(tp, "cpu").load_from_jax(
        jb.pipeline.dit_params, _np(jb.pipeline.vae.dec_params),
        text=_np(jb.text_encoder.params))
    tr = treg.ModelRegistry("cpu")
    tr._cache["sd3-tiny"] = tb
    noise = np.array(jax.random.normal(jax.random.fold_in(jax.random.key(SEED), 0),
                                       (1, HW // 2, HW // 2, 4), jnp.float32))
    return dict(jr=jr, jb=jb, tr=tr, tb=tb, tp=tp, noise=noise)


def _conditioning(pair):
    jctx, jpooled = pair["jb"].text_encoder.encode(PROMPTS[:2])
    return [np.array(a) for a in (jctx[:1], jpooled[:1], jctx[1:], jpooled[1:])]


def test_flow_pipeline_cfg_matches_jax(sd3_pair):
    ctx, pooled, uctx, upooled = _conditioning(sd3_pair)
    spec = dict(height=HW, width=HW, steps=STEPS, shift=SHIFT, cfg=CFG)
    ref = np.asarray(sd3_pair["jb"].pipeline.generate(
        build_mesh({"dp": 1}), jflow.FlowSpec(**spec), SEED, ctx, pooled,
        uncond_context=uctx, uncond_pooled=upooled))
    tp = sd3_pair["tb"].pipeline
    out = tp.sample_and_decode(_t(sd3_pair["noise"]), tflow.FlowSpec(**spec),
                               _t(ctx), _t(pooled), uncond_context=_t(uctx),
                               uncond_pooled=_t(upooled))
    plain = tp.sample_and_decode(_t(sd3_pair["noise"]),
                                 tflow.FlowSpec(**{**spec, "cfg": 1.0}),
                                 _t(ctx), _t(pooled))
    assert out.shape == ref.shape == (1, HW, HW, 3)
    assert (out - plain).abs().max() > 1e-3        # the guidance counts
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="requires negative conditioning"):
        tp.generate(tflow.FlowSpec(**spec), SEED, _t(ctx), _t(pooled))
    with pytest.raises(ValueError, match="requires negative conditioning"):
        tp.sample_and_decode(_t(sd3_pair["noise"]), tflow.FlowSpec(**spec),
                             _t(ctx), _t(pooled))


def test_cfg_1_ignores_a_negative(sd3_pair):
    """``cfg`` 1 keeps the single-batch path: a negative changes nothing,
    bit for bit."""
    ctx, pooled, uctx, upooled = map(_t, _conditioning(sd3_pair))
    spec = tflow.FlowSpec(height=HW, width=HW, steps=2)
    tp = sd3_pair["tb"].pipeline
    a = tp.generate(spec, 1, ctx, pooled)
    b = tp.generate(spec, 1, ctx, pooled, uncond_context=uctx,
                    uncond_pooled=upooled)
    assert torch.equal(a, b)


# --- nodes and graphs --------------------------------------------------------


def sd3_graph(seed: int = SEED, shift=SHIFT) -> dict:
    """The SD3 txt2img graph (no workflow file ships it): the worker of a
    served run samples at ``seed + 1`` (``DistributedSeed``)."""
    sampler = {"model": ["4", 0], "positive": ["2", 0], "negative": ["3", 0],
               "seed": ["5", 0], "steps": STEPS, "width": HW, "height": HW,
               "cfg": CFG}
    return {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": "sd3-tiny"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": PROMPTS[0], "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": PROMPTS[1], "clip": ["1", 1]}},
        "4": {"class_type": "ModelSamplingSD3",
              "inputs": {"model": ["1", 0], "shift": shift}},
        "5": {"class_type": "DistributedSeed", "inputs": {"seed": seed}},
        "6": {"class_type": "TPUFlowTxt2Img", "inputs": sampler},
        "7": {"class_type": "DistributedCollector", "inputs": {"images": ["6", 0]}},
        "8": {"class_type": "SaveImage",
              "inputs": {"images": ["7", 0], "filename_prefix": "sd3"}},
    }


def test_sd3_graph_matches_jax_graph(sd3_pair, tmp_path):
    tb = sd3_pair["tb"]
    tb.pipeline.initial_noise = lambda spec, gen: _t(sd3_pair["noise"])
    try:
        out = GraphExecutor({"model_registry": sd3_pair["tr"],
                             "output_dir": str(tmp_path / "port")}).execute(sd3_graph())
    finally:
        del tb.pipeline.initial_noise
    ref = jexec.GraphExecutor({"model_registry": sd3_pair["jr"],
                               "mesh": build_mesh({"dp": 1}),
                               "output_dir": str(tmp_path / "jax")}).execute(sd3_graph())
    assert out["6"][0].shape == (1, HW, HW, 3)
    np.testing.assert_allclose(out["6"][0].numpy(), np.asarray(ref["6"][0]),
                               atol=TOL, rtol=TOL)
    assert (tmp_path / "port" / "sd3_00000.png").is_file()


def test_model_sampling_sd3_sets_the_nodes_shift(sd3_pair, monkeypatch):
    """``ModelSamplingSD3`` gives a MODEL whose shift the flow and video
    nodes read when theirs is not wired (a wired one wins; none at all is
    3.0), as the JAX nodes do; the proxy forwards everything else."""
    from comfyui_distributed_tpu.graph import nodes_builtin as jnodes

    seen = []

    def record(spec, *a, **kw):
        seen.append(spec.shift)
        return torch.zeros(1, 5, 8, 8, 3)

    base = treg.ModelRegistry("cpu").get("wan-tiny")
    tb = sd3_pair["tb"]
    monkeypatch.setattr(tb.pipeline, "generate", record)
    monkeypatch.setattr(base.pipeline, "generate", record)
    monkeypatch.setattr(base.pipeline, "generate_i2v", record)
    shifted = get_node("ModelSamplingSD3")().execute(tb, 1.25)[0]
    (jshifted,) = jnodes.ModelSamplingSD3().execute(object(), 1.25)
    assert shifted.sampling_shift == jshifted.sampling_shift == 1.25
    assert shifted.pipeline is tb.pipeline and shifted.preset is tb.preset
    ctx = {"context": torch.zeros(1, 32, 32)}
    flow = get_node("TPUFlowTxt2Img")()
    args = dict(seed=1, steps=1, width=HW, height=HW)
    flow.execute(shifted, ctx, **args)
    flow.execute(shifted, ctx, shift=2.5, **args)
    flow.execute(tb, ctx, **args)
    video_shifted = get_node("ModelSamplingSD3")().execute(base, 0.75)[0]
    vargs = dict(seed=1, frames=5, steps=1)
    for node, extra in (("TPUTxt2Video", dict(width=HW, height=HW)),
                        ("TPUImg2Video", dict(image=torch.zeros(1, HW, HW, 3)))):
        if node == "TPUImg2Video":
            video_shifted = get_node("ModelSamplingSD3")().execute(
                treg.ModelRegistry("cpu").get("wan-i2v-tiny"), 0.75)[0]
            monkeypatch.setattr(video_shifted._base.pipeline, "generate_i2v", record)
        get_node(node)().execute(video_shifted, ctx, **vargs, **extra)
    assert seen == [1.25, 2.5, 3.0, 0.75, 0.75]
    with pytest.raises(ValidationError, match="negative"):
        flow.execute(tb, ctx, cfg=CFG, **args)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, path: str, payload=None) -> dict:
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return json.loads(e.read())


def test_sd3_graph_served_equals_direct(tmp_path, monkeypatch):
    """One served request (a master and a ``remote`` worker controller on
    loopback): the master's PNG is the direct run's at the seed, the
    worker's the direct run's at seed + 1."""
    registry = treg.ModelRegistry("cpu", seed=0)
    for k in (0, 1):
        GraphExecutor({"model_registry": registry,
                       "output_dir": str(tmp_path / f"direct{k}")}).execute(
            sd3_graph(SEED + k))
    master_port, worker_port = _free_port(), _free_port()
    (tmp_path / "worker.json").write_text("{}")
    (tmp_path / "master.json").write_text(json.dumps({
        "master": {"port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "remote", "enabled": True}]}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CDT_IS_WORKER", "1")
        mp.setenv("CDT_WORKER_ID", "w0")
        mp.setenv("CDT_INPUT_DIR", str(tmp_path / "w_in"))
        worker = Controller(tmp_path / "worker.json", device="cpu")
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "served"))
    master = Controller(tmp_path / "master.json", device="cpu",
                        model_registry=registry)
    servers = [ServerThread(worker, port=worker_port),
               ServerThread(master, port=master_port)]
    try:
        answer = _post(master_port, "/distributed/queue", {"prompt": sd3_graph()})
        assert answer["worker_count"] == 1, answer
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            entry = _post(master_port, f"/distributed/history/{answer['prompt_id']}")
            if entry.get("status") in ("success", "error"):
                break
            time.sleep(0.05)
        assert entry["status"] == "success", entry
    finally:
        for server in reversed(servers):
            server.stop()
    for k in (0, 1):
        assert (tmp_path / "served" / f"sd3_0000{k}.png").read_bytes() == \
            (tmp_path / f"direct{k}" / "sd3_00000.png").read_bytes()


# --- SD3's files -------------------------------------------------------------


@pytest.fixture
def sd3_files_preset(monkeypatch):
    """``sd3-tiny`` without the guidance embedder, as an SAI file has it."""
    preset = treg.PRESETS["sd3-tiny"]
    monkeypatch.setitem(treg.PRESETS, "sd3-tiny", dataclasses.replace(
        preset, dit=dataclasses.replace(preset.dit, guidance_embed=False)))


def _source_bundle(depth: int = 2):
    """A random-init ``sd3-tiny`` bundle with its tiny text stack, as the
    files would hold it."""
    preset = treg.PRESETS["sd3-tiny"]
    preset = dataclasses.replace(preset, dit=dataclasses.replace(
        preset.dit, depth_double=depth))
    bundle = treg.ModelBundle(preset, "cpu", seed=9)
    bundle.build_clip_stack()
    as_published(bundle.core)
    return bundle


def _params(bundle, entries=("core", "clip_l", "clip_g", "t5")) -> dict:
    return {f"{entry}.{k}": v for entry, module in bundle._state_entries().items()
            if entry in entries for k, v in module.state_dict().items()}


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_sd3_files_convert_restore_and_load(sd3_files_preset, tmp_path, capsys):
    """``convert --preset sd3-tiny --t5 --clip-l`` → ``state.pt`` → a fresh
    registry restores it, CLIP-G through ``load_text_encoder_files`` (the
    CLI has none, as JAX's): every parameter is the source's and the
    stack encodes as the source's; a single file under the checkpoint root
    loads by name with its depth read from the keys."""
    source = _source_bundle()
    stack = source.clip_stack
    files = {"sd3": tmp_path / "sd3.safetensors", "t5": tmp_path / "t5.safetensors",
             "clip_l": tmp_path / "clip_l.safetensors",
             "clip_g": tmp_path / "clip_g.safetensors"}
    save_file(tconvert.export_mmdit_sd3(source.core, PREFIX), files["sd3"])
    save_file(tconvert.export_t5(stack.t5), files["t5"])
    for tower in ("clip_l", "clip_g"):
        save_file(tconvert.export_clip_hf(getattr(stack, tower)), files[tower])
    out = tmp_path / "root" / "sd3-tiny"
    rc = cli(["convert", "--preset", "sd3-tiny", "--checkpoint", str(files["sd3"]),
              "--t5", str(files["t5"]), "--clip-l", str(files["clip_l"]),
              "--out", str(out), "--device", "cpu"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["entries"] == ["clip_g", "clip_l", "core", "t5", "vae_dec"]
    restored = treg.ModelRegistry("cpu", checkpoint_root=out.parent).get("sd3-tiny")
    assert restored.text_encoder is restored.clip_stack
    entries = ("core", "clip_l", "t5")
    _assert_same(_params(restored, entries), _params(source, entries))
    restored.load_text_encoder_files(clip_g=files["clip_g"])
    _assert_same(_params(restored), _params(source))
    for a, b in zip(restored.text_encoder.encode(PROMPTS),
                    source.text_encoder.encode(PROMPTS)):
        assert torch.equal(a, b)
    deep = _source_bundle(depth=3)
    root = tmp_path / "by_name"
    root.mkdir()
    save_file(tconvert.export_mmdit_sd3(deep.core), root / "sd3-tiny.safetensors")
    bundle = treg.ModelRegistry("cpu", checkpoint_root=root).get("sd3-tiny")
    assert bundle.preset.dit.depth_double == 3
    _assert_same(_params(bundle, ("core",)), _params(deep, ("core",)))
    with pytest.raises(ValidationError, match="sd3 stack only"):
        treg.ModelBundle(dataclasses.replace(treg.PRESETS["flux-tiny"], clip="flux"),
                         "cpu").load_text_encoder_files(clip_g=files["clip_g"])
