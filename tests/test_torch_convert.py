"""The port's checkpoint converters (``models/convert.py``) against the
JAX package's.

Seeded numpy weights go into the JAX modules, are carried into the port
(``models/from_jax.py``), and written back out in the published layouts
by the port's exporter. The JAX converters then read that file: they
must give back exactly the weights they started from (so the port's
walks name and shape every key as JAX's do), and the port's converters
must give modules whose outputs match the JAX modules' within 2e-4 —
UNet (Linear and 1×1-conv ``proj_in``), VAE, CLIP in the HF and OpenCLIP
layouts, RRDBNet (both ESRGAN layouts) and ControlNet. At full SDXL and
SD 1.5 width the (source key, shape) sets of both walks are equal
(``meta`` modules, JAX shape trees). Missing, extra and mis-shaped keys
raise ``ConversionError``; so do a published SD 1.5 middle block and the
FLUX, SD3 and WAN layouts on a UNet preset."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")
st_numpy = pytest.importorskip("safetensors.numpy")

from comfyui_distributed_tpu.models import clip as jclip  # noqa: E402
from comfyui_distributed_tpu.models import controlnet as jcn  # noqa: E402
from comfyui_distributed_tpu.models import convert as jconvert  # noqa: E402
from comfyui_distributed_tpu.models import registry as jreg  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import upscaler as jup  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu_torch.models import clip as tclip  # noqa: E402
from comfyui_distributed_tpu_torch.models import controlnet as tcn  # noqa: E402
from comfyui_distributed_tpu_torch.models import convert as tconvert  # noqa: E402
from comfyui_distributed_tpu_torch.models import registry as treg  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import upscaler as tup  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.convert import ConversionError  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from torch_ckpt_fixtures import F32, jax_bundle, perturbed, port_from_jax, presets  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(a, b):
    la, lb = (jax.tree_util.tree_leaves_with_path(t) for t in (a, b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


def _to_numpy(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


@pytest.fixture(scope="module", params=["sdxl", "clip-l"])
def single_file(request, tmp_path_factory):
    """A tiny SDXL- or SD 1.5-layout single file written by the
    ``safetensors`` package from the port's export of JAX weights."""
    jp, tp = presets(request.param)
    jb = jax_bundle(jp, seed=3)
    tb = port_from_jax(tp, jb)
    sd = _to_numpy(tconvert.export_checkpoint(tb))
    path = tmp_path_factory.mktemp("ckpt") / f"{tp.name}.safetensors"
    st_numpy.save_file(sd, str(path))
    return dict(jp=jp, tp=tp, jb=jb, sd=sd, path=path)


def test_export_layout_is_the_published_one(single_file):
    sd, kind = single_file["sd"], single_file["jp"].clip
    assert jconvert.detect_layout(sd) == tconvert.detect_layout(sd) == (
        "sdxl" if kind == "sdxl" else "sd15")
    root = (tconvert.SDXL_CLIP_L_ROOT if kind == "sdxl"
            else tconvert.SD15_CLIP_ROOT)
    assert sd[root + "text_model.embeddings.position_ids"].dtype == np.int64
    assert all(k.startswith(("model.diffusion_model.", "first_stage_model.",
                             "conditioner.embedders.", "cond_stage_model."))
               for k in sd)


def test_jax_converters_read_back_the_jax_weights(single_file):
    """The JAX converters, fed the port's export, return the weights the
    JAX bundle started from, exactly."""
    jp, jb, sd = single_file["jp"], single_file["jb"], single_file["sd"]
    fresh = jreg.ModelBundle(jp, seed=9)
    fresh.build_clip_stack(tiny=True)
    jconvert.convert_checkpoint(single_file["path"], fresh)
    _assert_trees_equal(fresh.pipeline.unet_params, jb.pipeline.unet_params)
    _assert_trees_equal(fresh.pipeline.vae.enc_params, jb.pipeline.vae.enc_params)
    _assert_trees_equal(fresh.pipeline.vae.dec_params, jb.pipeline.vae.dec_params)
    if jp.clip == "sdxl":
        _assert_trees_equal(fresh.clip_stack.clip_l.params, jb.clip_stack.clip_l.params)
        _assert_trees_equal(fresh.clip_stack.clip_g.params, jb.clip_stack.clip_g.params)
    else:
        _assert_trees_equal(fresh.clip_stack.params, jb.clip_stack.params)
    assert sd                                  # the file held every key


def test_port_conversion_matches_jax_outputs(single_file):
    jp, tp, jb = single_file["jp"], single_file["tp"], single_file["jb"]
    tb = treg.ModelBundle(tp, "cpu", seed=7, empty_core=True)
    tb.load_safetensors_checkpoint(single_file["path"])
    cfg = jp.unet
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3.0, 811.0], np.float32)
    texts = ["a photo of a cat", ""]
    jctx, jpooled = jb.text_encoder.encode(texts)
    tctx, tpooled = tb.text_encoder.encode(texts)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tpooled.numpy(), np.asarray(jpooled), atol=TOL,
                               rtol=TOL)
    ctx = np.array(jctx)
    y = (np.array(jpooled)[:, :cfg.adm_in_channels] if cfg.adm_in_channels
         else None)
    ref = jb.pipeline.unet.apply(jb.pipeline.unet_params, x, t, ctx, y)
    with torch.no_grad():
        out = tb.core(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx),
                      None if y is None else torch.from_numpy(y))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    img = rng.random((1, 16, 16, 3)).astype(np.float32) * 2 - 1
    jv, tv = jb.pipeline.vae, tb.pipeline.vae
    with torch.no_grad():
        np.testing.assert_allclose(tv.encode(torch.from_numpy(img)).numpy(),
                                   np.asarray(jv.encode(img)), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(tv.decode(torch.from_numpy(x[:1])).numpy(),
                                   np.asarray(jv.decode(x[:1])), atol=TOL, rtol=TOL)


def test_text_stack_kind_must_match(single_file):
    """An SDXL file into a CLIP-L preset (or the other way) is refused
    before any weight is written."""
    other = "clip-l" if single_file["jp"].clip == "sdxl" else "sdxl"
    _, tp = presets(other)
    bundle = treg.ModelBundle(tp, "cpu", seed=1)
    before = {k: p.clone() for k, p in bundle.core.named_parameters()}
    with pytest.raises(ConversionError, match="text stack"):
        tconvert.convert_checkpoint(single_file["path"], bundle)
    assert all(torch.equal(p, before[k]) for k, p in bundle.core.named_parameters())


def test_conv_proj_unet_matches_jax():
    """SD 1.5's 1×1-conv ``proj_in``/``proj_out`` (context 768, no ADM):
    squeezed into the port's Linears, as JAX's converter squeezes them."""
    jcfg = dataclasses.replace(junet.UNetConfig.tiny(**F32), context_dim=768,
                               adm_in_channels=0)
    tcfg = dataclasses.replace(tunet.UNetConfig.tiny(**F32), context_dim=768,
                               adm_in_channels=0)
    assert not tconvert.linear_proj_of(tcfg)
    model, params = junet.init_unet(jcfg, jax.random.key(4), sample_shape=(8, 8, 4),
                                    context_len=16)
    params = perturbed(_np(params), 4)
    e = tconvert._Exporter(load_from_jax(tunet.UNet2D(tcfg), params),
                           tconvert.UNET_PREFIX)
    tconvert._unet_layout(e, tcfg, "", False)
    sd = _to_numpy(e.out)
    assert sd["model.diffusion_model.input_blocks.3.1.proj_in.weight"].ndim == 4
    _assert_trees_equal(jconvert.convert_unet(sd, params, jcfg), params)
    with torch.device("meta"):
        port = tunet.UNet2D(tcfg)
    port = port.to_empty(device="cpu")
    tconvert.convert_unet({k: torch.from_numpy(v) for k, v in sd.items()}, port)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    t = np.array([250.0], np.float32)
    ctx = rng.standard_normal((1, 16, 768)).astype(np.float32)
    ref = model.apply(params, x, t, ctx)
    with torch.no_grad():
        out = port(*map(torch.from_numpy, (x, t, ctx)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scale,arch", [(4, "new"), (2, "old"), (4, "old")])
def test_upscaler_file_matches_jax(scale, arch, tmp_path):
    jcfg = dataclasses.replace(jup.UpscalerConfig.tiny(scale=scale), **F32)
    jb = jup.init_upscaler(jcfg, jax.random.key(scale), sample_hw=(16, 16))
    params = perturbed(_np(jb.params), scale)
    port = load_from_jax(tup.RRDBNet(tup.UpscalerConfig.tiny(scale=scale, **F32)),
                         params).eval()
    sd = _to_numpy(tconvert.export_upscaler(port, arch))
    cfg, jparams = jconvert.convert_upscaler(sd)
    assert (cfg.scale, cfg.num_block, cfg.num_feat, cfg.grow_ch) == (scale, 2, 8, 4)
    _assert_trees_equal(jparams, params)
    path = tmp_path / "up.safetensors"
    st_numpy.save_file(sd, str(path))
    loaded = tconvert.load_upscaler_checkpoint(path, "cpu", dtype="float32")
    assert loaded.scale == scale and loaded.name == "up"
    img = np.random.default_rng(6).random((1, 12, 10, 3)).astype(np.float32)
    ref = jup.RRDBNet(dataclasses.replace(cfg, dtype="float32")).apply(params, img)
    with torch.no_grad():
        out = loaded.apply(torch.from_numpy(img))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("adm", [8, 0], ids=["sdxl-like", "sd15-like"])
def test_controlnet_file_matches_jax(adm, tmp_path):
    jcfg = dataclasses.replace(junet.UNetConfig.tiny(**F32), adm_in_channels=adm)
    tcfg = dataclasses.replace(tunet.UNetConfig.tiny(**F32), adm_in_channels=adm)
    jb = jcn.init_controlnet(jcfg, jax.random.key(7), sample_shape=(8, 8, 4),
                             context_len=16)
    params = perturbed(_np(jb.params), 7)
    port = load_from_jax(tcn.ControlNet(tcfg), params).eval()
    sd = _to_numpy(tconvert.export_controlnet(port))
    _assert_trees_equal(jconvert.convert_controlnet(sd, params, jcfg), params)
    path = tmp_path / "cn.safetensors"
    st_numpy.save_file(sd, str(path))
    loaded = tconvert.load_controlnet_checkpoint(path, "cpu", config=tcfg)
    assert loaded.name == "cn"
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([10.0, 700.0], np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    y = rng.standard_normal((2, adm)).astype(np.float32) if adm else None
    hint = rng.random((2, 64, 64, 3)).astype(np.float32)
    jdown, jmid = jcn.ControlNet(jcfg).apply(params, x, t, ctx, y, hint)
    with torch.no_grad():
        down, mid = loaded.model(*(None if a is None else torch.from_numpy(a)
                                   for a in (x, t, ctx, y, hint)))
    for d, jd in zip(down + [mid], list(jdown) + [jmid]):
        np.testing.assert_allclose(d.numpy(),
                                   np.asarray(jd).transpose(0, 3, 1, 2),
                                   atol=TOL, rtol=TOL)


def test_controlnet_base_architecture_is_read_from_the_file():
    assert tconvert.controlnet_config_of(
        {"control_model.label_emb.0.0.weight": 0}) == tunet.UNetConfig.sdxl()
    assert tconvert.controlnet_config_of({}) == tunet.UNetConfig.sd15()


# --- full-width key sets -----------------------------------------------------

def _src_shape(tx, shape):
    """A JAX transform's source (torch) shape from its flax leaf shape."""
    if tx is jconvert._lin:
        return tuple(reversed(shape))
    if tx is jconvert._conv:
        kh, kw, i, o = shape
        return (o, i, kh, kw)
    if tx is jconvert._conv1x1_to_dense:
        return (shape[1], shape[0], 1, 1)
    return tuple(shape)


class _ShapeFiller(jconvert._Recorder):
    """Stands in for the JAX ``_Filler`` (patched in by the tests): records
    each put with its template, each raw put's shape."""

    made: list = []

    def __init__(self, sd, template):
        super().__init__()
        self.template = template
        self.raw = []
        _ShapeFiller.made.append(self)

    def put_raw(self, value, dst_path):
        self.raw.append((dst_path, tuple(value.shape)))

    def finish(self, expect_prefix=""):
        return {}


class _Probe(dict):
    """A state dict that hands out zero views of the shapes it is told
    (OpenCLIP's ``in_proj`` entries) and remembers the keys read."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.read = shapes, set()

    def __getitem__(self, key):
        self.read.add(key)
        return np.broadcast_to(np.float32(0), self.shapes[key])


def _jax_set(fillers, prefix=""):
    out = set()
    for f in fillers:
        for src, dst, tx in f.records:
            leaf = jconvert._get_path(f.template, dst)
            out.add((prefix + src, _src_shape(tx, leaf.shape)))
    return out


def _port_set(rec, module, prefix=""):
    params = dict(module.named_parameters())
    out = {(prefix + src, tuple(tx.inv(params[dst]).shape))
           for src, dst, tx in rec.records}
    out |= {(prefix + src, (sum(params[d].shape[0] for d in dsts),
                            *params[dsts[0]].shape[1:]))
            for src, dsts in rec.fused_records}
    return out


def _port_rec(walk, *args):
    rec = tconvert._Recorder()
    walk(rec, *args)
    return rec


def _jax_tree(module, *args):
    return jax.eval_shape(module.init, jax.random.key(0), *args)["params"]


@pytest.mark.parametrize("name", ["sdxl", "sd15"])
def test_full_width_key_sets_match_jax(name, monkeypatch):
    monkeypatch.setattr(jconvert, "_Filler", _ShapeFiller)
    _ShapeFiller.made = []
    jcfg = getattr(junet.UNetConfig, name)()
    tcfg = getattr(tunet.UNetConfig, name)()
    lp = tconvert.linear_proj_of(tcfg)
    assert lp == (name == "sdxl")
    p = "model.diffusion_model."
    # UNet
    jrec = jconvert._Recorder()
    jconvert._unet_layout(jrec, jcfg, p, lp)
    jrec.template = junet.init_unet(jcfg, jax.random.key(0), sample_shape=(8, 8, 4),
                                    context_len=77, abstract=True)[1]["params"]
    with torch.device("meta"):
        unet = tunet.UNet2D(tcfg)
        vae = tvae.AutoencoderKL(tvae.VAEConfig.sdxl(), encoder=True)
        clip_l = tclip.CLIPTextTransformer(tclip.CLIPTextConfig.clip_l())
        clip_g = tclip.CLIPTextTransformer(tclip.CLIPTextConfig.clip_g())
    want = _jax_set([jrec])
    got = _port_set(_port_rec(tconvert._unet_layout, tcfg, p, lp), unet)
    assert got == want and len(got) == len(jrec.records)
    # VAE (the JAX walk is inline in convert_vae: run it on the shape filler)
    jv = jvae.AutoencoderKL(jvae.VAEConfig.sdxl())
    enc = _jax_tree(jv.encoder, jnp.zeros((1, 64, 64, 3)))
    dec = _jax_tree(jv.decoder, jnp.zeros((1, 8, 8, 4)))
    jconvert.convert_vae({}, {"params": enc}, {"params": dec},
                         jvae.VAEConfig.sdxl())
    want = _jax_set(_ShapeFiller.made[-2:])
    got = _port_set(_port_rec(tconvert._vae_layout, tvae.VAEConfig.sdxl(),
                              "first_stage_model."), vae)
    assert got == want
    # CLIP-L, HF layout
    jl = jclip.CLIPTextConfig.clip_l()
    jrec = jconvert._Recorder()
    jconvert._clip_hf_layout(jrec, jl, "text_model.")
    jrec.template = _jax_tree(jclip.CLIPTextTransformer(jl),
                              jnp.zeros((1, 77), jnp.int32))
    got = _port_set(_port_rec(tconvert._clip_hf_layout, clip_l.config,
                              "text_model."), clip_l)
    assert got == _jax_set([jrec])
    if name != "sdxl":
        return
    # CLIP-G, OpenCLIP layout (the fused in_proj is read from the dict)
    jg = jclip.CLIPTextConfig.clip_g()
    W = jg.width
    shapes = {}
    for i in range(jg.layers):
        b = f"model.transformer.resblocks.{i}.attn."
        shapes[b + "in_proj_weight"], shapes[b + "in_proj_bias"] = (3 * W, W), (3 * W,)
    probe = _Probe(shapes)
    template = _jax_tree(jclip.CLIPTextTransformer(jg), jnp.zeros((1, 77), jnp.int32))
    jconvert.convert_clip_openclip(probe, {"params": template}, jg)
    want = _jax_set(_ShapeFiller.made[-1:]) | {(k, shapes[k]) for k in probe.read}
    got = _port_set(_port_rec(tconvert._clip_openclip_layout, clip_g.config,
                              "model."), clip_g)
    assert got == want
    assert len(_ShapeFiller.made[-1].raw) == 6 * jg.layers


def test_full_width_controlnet_key_set_matches_jax():
    jcfg, tcfg = junet.UNetConfig.sdxl(), tunet.UNetConfig.sdxl()
    jrec = jconvert._Recorder()
    jconvert._controlnet_layout(jrec, jcfg, "control_model.", True)
    jrec.template = _jax_tree(
        jcn.ControlNet(jcfg), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 2048)), jnp.zeros((1, 2816)), jnp.zeros((1, 64, 64, 3)))
    with torch.device("meta"):
        cn = tcn.ControlNet(tcfg)
    got = _port_set(_port_rec(tconvert._controlnet_layout, tcfg,
                              "control_model.", True), cn)
    assert got == _jax_set([jrec])


# --- loud failures -----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_unet_sd():
    cfg = tunet.UNetConfig.tiny(**F32)
    model = treg._random(lambda: tunet.UNet2D(cfg), torch.device("cpu"),
                         torch.Generator().manual_seed(0))
    e = tconvert._Exporter(model, tconvert.UNET_PREFIX)
    tconvert._unet_layout(e, cfg, "", True)
    return cfg, {k: v.clone() for k, v in e.out.items()}


def _fresh_unet(cfg):
    with torch.device("meta"):
        m = tunet.UNet2D(cfg)
    return m.to_empty(device="cpu")


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing source key"),
    ("extra", "unconsumed source keys"),
    ("shape", "shape"),
])
def test_key_faults_raise(tiny_unet_sd, fault, match):
    cfg, sd = tiny_unet_sd
    sd = dict(sd)
    key = "model.diffusion_model.time_embed.0.weight"
    if fault == "missing":
        del sd[key]
    elif fault == "extra":
        sd["model.diffusion_model.bogus.weight"] = torch.zeros(1)
    else:
        sd[key] = torch.zeros(3, 3)
    with pytest.raises(ConversionError, match=match):
        tconvert.convert_unet(sd, _fresh_unet(cfg))
    np_sd = {k: v.numpy() for k, v in sd.items()}
    jcfg = junet.UNetConfig.tiny(**F32)
    template = junet.init_unet(jcfg, jax.random.key(0), sample_shape=(8, 8, 4),
                               context_len=16, abstract=True)[1]
    with pytest.raises(jconvert.ConversionError, match=match):
        jconvert.convert_unet(np_sd, template, jcfg)


def test_unfilled_parameter_raises(tiny_unet_sd):
    cfg, _ = tiny_unet_sd
    f = tconvert._Filler({}, _fresh_unet(cfg))
    with pytest.raises(ConversionError, match="unfilled parameters"):
        f.finish()


def _narrow_sd15(middle_depth=-1):
    """SD 1.5's shape (4 levels, the fourth conv-only, 8 heads, context
    768, 1×1-conv projections) at 32·[1,2,4,4] channels."""
    return dataclasses.replace(tunet.UNetConfig.sd15(), model_channels=32,
                               dtype="float32", middle_depth=middle_depth)


def test_published_sd15_middle_block_is_refused(tmp_path, monkeypatch):
    """A published SD 1.5 file has a middle transformer at
    ``middle_block.1`` and the second res block at ``middle_block.2``,
    which the ``sd15`` preset (both packages') lacks. The JAX converter
    still refuses such a file; the port (the test keeps its name from when
    it refused too) reads the middle depth from the file's keys, builds
    that core, converts every tensor, and its middle transformer matches
    the JAX ``SpatialTransformer`` whose weights the file carries. The
    converted bundle's manifest records the depth, so its restore builds
    the same core."""
    from comfyui_distributed_tpu.models import layers as jlayers

    cfg = _narrow_sd15()
    assert cfg.mid_depth == 0 and not hasattr(_fresh_unet(cfg), "mid_attn")
    src = treg._random(lambda: tunet.UNet2D(_narrow_sd15(1)),
                       torch.device("cpu"), torch.Generator().manual_seed(3))
    # the middle transformer (128 channels, 8 heads of 16) from JAX
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, 2, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 768)).astype(np.float32)
    jmid = jlayers.SpatialTransformer(num_heads=8, depth=1, dtype=jnp.float32)
    jparams = perturbed(jmid.init(jax.random.key(5), x, ctx), 6)
    load_from_jax(src.mid_attn, jparams)
    e = tconvert._Exporter(src, tconvert.UNET_PREFIX)
    tconvert._unet_layout(e, src.config, "", False)
    sd = {k: v.detach().clone() for k, v in e.out.items()}
    assert "model.diffusion_model.middle_block.2.in_layers.0.weight" in sd
    assert tconvert.middle_depth_of(sd) == 1
    # the JAX preset's converter refuses it
    jcfg = dataclasses.replace(junet.UNetConfig.sd15(), model_channels=32,
                               dtype="float32")
    template = junet.init_unet(jcfg, jax.random.key(0), sample_shape=(8, 8, 4),
                               context_len=77, abstract=True)[1]
    with pytest.raises(jconvert.ConversionError,
                       match=r"missing source key .*middle_block\.1\.in_layers"):
        jconvert.convert_unet({k: v.numpy() for k, v in sd.items()},
                              template, jcfg)
    # the port converts it through the registry, from the file
    preset = treg.ModelPreset("sd15-narrow", cfg, tvae.VAEConfig.tiny(**F32),
                              treg.TextEncoderConfig.tiny())
    monkeypatch.setitem(treg.PRESETS, preset.name, preset)
    st_numpy.save_file({k: v.numpy() for k, v in sd.items()},
                       str(tmp_path / "sd15-narrow.safetensors"))
    bundle = treg.ModelRegistry("cpu", checkpoint_root=tmp_path).get(preset.name)
    core = bundle.core
    assert core.config.mid_depth == 1 and bundle.preset.unet.middle_depth == 1
    for name, p in src.named_parameters():
        assert torch.equal(core.get_parameter(name), p), name
    with torch.no_grad():
        out = core.mid_attn(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(ctx))
    ref = np.asarray(jmid.apply(jparams, x, ctx))
    assert np.abs(ref - x).max() > 1e-2
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               atol=2e-5, rtol=2e-5)
    # saved and restored: the manifest carries the depth
    bundle.save_checkpoint(tmp_path / "root" / preset.name)
    manifest = json.loads((tmp_path / "root" / preset.name / treg.MANIFEST)
                          .read_text())
    assert manifest["arch"] == {"kind": "unet", "middle_depth": 1}
    restored = treg.ModelRegistry("cpu", checkpoint_root=tmp_path / "root"
                                  ).get(preset.name)
    assert restored.core.config.mid_depth == 1
    assert torch.equal(restored.core.mid_attn.proj_in.weight,
                       core.mid_attn.proj_in.weight)
    # a published sd15 ControlNet's middle, from its keys alone
    cn_cfg = dataclasses.replace(tunet.UNetConfig.sd15(), middle_depth=1)
    keys = {k: 0 for k, _, _ in tconvert.records(
        tconvert._controlnet_layout, cn_cfg, tconvert.CONTROLNET_PREFIX, False)}
    got = tconvert.with_middle_of(tconvert.controlnet_config_of(keys), keys,
                                  tconvert.CONTROLNET_PREFIX)
    assert got.mid_depth == 1 and got == cn_cfg


@pytest.mark.parametrize("key,item", [
    # FLUX is ported: a FLUX file on a UNet preset is refused for the
    # preset (the case keeps its id from when it named item A.7b)
    pytest.param("double_blocks.0.img_attn.qkv.weight", "needs a dit preset",
                 id="double_blocks.0.img_attn.qkv.weight-A.7b"),
    # SD3 is ported: an SD3 file on a UNet preset is refused for the preset
    # (the case keeps its id from when it named item 13;
    # tests/test_torch_sd3.py asserts the load)
    pytest.param("model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight",
                 "needs a dit preset",
                 id="model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight-item 13"),
    # WAN is ported: a WAN file on a UNet preset is refused for the preset
    # (the case keeps its id from when it named item 15)
    pytest.param("blocks.0.self_attn.norm_q.weight",
                 "needs a wan video preset",
                 id="blocks.0.self_attn.norm_q.weight-item 15"),
])
def test_unported_layouts_name_their_item(key, item, tmp_path):
    path = tmp_path / "x.safetensors"
    st_numpy.save_file({key: np.zeros(2, np.float32)}, str(path))
    layout = tconvert.detect_layout({key: 0})
    assert layout == jconvert.detect_layout({key: 0})
    bundle = treg.ModelBundle(treg.PRESETS["tiny"], "cpu")
    with pytest.raises(ConversionError, match=item):
        tconvert.convert_checkpoint(path, bundle)


@pytest.mark.parametrize("keys", [
    ["transformer_blocks.0.a", "single_transformer_blocks.0.b"],
    ["transformer_blocks.0.a"],
    ["bogus"],
])
def test_detect_layout_errors_match_jax(keys):
    sd = {k: 0 for k in keys}
    with pytest.raises(jconvert.ConversionError) as jerr:
        jconvert.detect_layout(sd)
    with pytest.raises(ConversionError) as terr:
        tconvert.detect_layout(sd)
    assert str(terr.value).split(":")[0] == str(jerr.value).split(" —")[0].split(":")[0]
