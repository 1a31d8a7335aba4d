"""The port's img2img, inpainting and the ControlNet and ``spatial_cond``
branches of Ultimate SD Upscale against the JAX package, on the tiny
preset in fp32 with the weights carried by ``from_jax`` and JAX's noise
handed over (its threefry draws: ``split(fold_in(key(seed), 0))`` for a
pipeline, ``fold_in(key(seed), tile)`` per tile). Also the image, mask
and latent nodes against their JAX nodes, and the latent mask against
``jax.image.resize``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.graph import nodes_builtin as jnodes  # noqa: E402
from comfyui_distributed_tpu.models import controlnet as jcn  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu.tiles.engine import TileUpscaler as JaxUpscaler  # noqa: E402
from comfyui_distributed_tpu.tiles.engine import UpscaleSpec as JaxSpec  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe  # noqa: E402
from comfyui_distributed_tpu_torch.graph.node import get_node  # noqa: E402
from comfyui_distributed_tpu_torch.models import controlnet as tcn  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry  # noqa: E402
from comfyui_distributed_tpu_torch.ops.resize import resize_to  # noqa: E402
from comfyui_distributed_tpu_torch.tiles import engine as tengine  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
CFG = dict(dtype="float32")
SPEC = dict(steps=6, denoise=0.5, guidance_scale=4.0)
UPSCALE = dict(scale=2.0, tile_w=16, tile_h=16, padding=4, steps=4,
               denoise=0.5, guidance_scale=3.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed=5, scale=0.05):
    """Flax's zero convs and ``mid_out`` drawn from seeded noise."""
    rng = np.random.default_rng(seed)

    def walk(tree, zero=False):
        out = {}
        for k, v in tree.items():
            z = zero or k.startswith("zero_") or k == "mid_out"
            if hasattr(v, "items"):
                out[k] = walk(v, z)
            else:
                out[k] = ((rng.standard_normal(v.shape) * scale).astype(np.float32)
                          if z else np.asarray(v))
        return out

    return walk(_np(params))


def jax_noise(seed: int, shape) -> torch.Tensor:
    """The JAX pipeline's initial noise for participant 0."""
    k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 0))
    return torch.from_numpy(np.array(jax.random.normal(k_noise, shape,
                                                       jnp.float32)))


def jax_tile_noise(seed: int, n: int, shape) -> torch.Tensor:
    key = jax.random.key(seed)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32)) for i in range(n)]))


@pytest.fixture(scope="module")
def s():
    cfg = junet.UNetConfig.tiny(**CFG)
    model, uparams = junet.init_unet(cfg, jax.random.key(0),
                                     sample_shape=(8, 8, 4), context_len=16)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(**CFG)).init(
        jax.random.key(1), image_hw=(16, 16))
    jb = jcn.init_controlnet(cfg, jax.random.key(2), sample_shape=(8, 8, 4),
                             context_len=16)
    jb.params = _perturbed(jb.params)
    jp = jpipe.Txt2ImgPipeline(model, uparams, vae)

    tcfg = tunet.UNetConfig.tiny(**CFG)
    unet = load_from_jax(tunet.UNet2D(tcfg), _np(uparams)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(**CFG), encoder=True).eval()
    load_from_jax(tv.decoder, _np(vae.dec_params))
    load_from_jax(tv.encoder, _np(vae.enc_params))
    tb = tcn.ControlNetBundle(load_from_jax(tcn.ControlNet(tcfg), jb.params).eval())
    tp = tpipe.Txt2ImgPipeline(unet, tv)

    rng = np.random.default_rng(0)
    f32 = np.float32
    ctx = rng.standard_normal((1, 16, 32)).astype(f32)
    unc = rng.standard_normal((1, 16, 32)).astype(f32)
    pooled = rng.standard_normal((1, 8)).astype(f32)
    upooled = rng.standard_normal((1, 8)).astype(f32)
    return dict(
        jp=jp, tp=tp, jb=jb, tb=tb, mesh=build_mesh({"dp": 1}),
        ctx=ctx, unc=unc, y=pooled, uy=upooled,
        jpos={"context": ctx, "pooled": pooled},
        jneg={"context": unc, "pooled": upooled},
        tpos={"context": torch.from_numpy(ctx), "pooled": torch.from_numpy(pooled)},
        tneg={"context": torch.from_numpy(unc), "pooled": torch.from_numpy(upooled)},
        images=rng.random((2, 16, 24, 3)).astype(f32),
        hint=rng.random((1, 40, 52, 3)).astype(f32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# --- the pipeline ---------------------------------------------------------------


def test_inpaint_denoiser_matches_jax():
    rng = np.random.default_rng(2)
    x, src, noise, mask = (rng.standard_normal((1, 4, 6, 4)).astype(np.float32)
                           for _ in range(4))
    mask = (mask > 0).astype(np.float32)

    def jbase(xx, sigma):
        return jnp.tanh(xx) * sigma

    def tbase(xx, sigma):
        return torch.tanh(xx) * sigma

    ref = jpipe.inpaint_denoiser(jbase, *map(jnp.asarray, (src, noise, mask)))(
        jnp.asarray(x), 1.7)
    out = tpipe.inpaint_denoiser(tbase, *_t(src, noise, mask))(
        torch.from_numpy(x), torch.tensor(1.7))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    keep = mask == 0
    np.testing.assert_array_equal(out.numpy()[keep], src[keep])


@pytest.mark.parametrize("hw,lat", [((16, 24), (8, 12)), ((1024, 1024), (128, 128)),
                                    ((40, 36), (5, 4))])
def test_latent_mask_matches_jax_resize(hw, lat):
    """The inpaint mask shrinks to the latent grid with jax.image.resize's
    antialiased bilinear weights; a plain interpolation does not agree."""
    m = np.random.default_rng(hw[0]).random((1, *hw, 1)).astype(np.float32)
    m[:, :, : hw[1] // 2 + 3] = 1.0
    ref = np.asarray(jax.image.resize(jnp.asarray(m), (1, *lat, 1), "bilinear"))
    out = resize_to(torch.from_numpy(m), *lat, "bilinear").numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    plain = F.interpolate(torch.from_numpy(m).permute(0, 3, 1, 2), size=lat,
                          mode="bilinear").permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - ref).max() > 1e-2


def _jax_img2img(s, spec, seed, hint=None, mask=None, control=None):
    jp = s["jp"] if control is None else s["jp"].with_control(s["jb"], control)
    return np.asarray(jp.img2img(
        s["mesh"], jpipe.GenerationSpec(**spec), seed, jnp.asarray(s["images"]),
        *map(jnp.asarray, (s["ctx"], s["unc"], s["y"], s["uy"])),
        hint=None if hint is None else jnp.asarray(hint),
        mask=None if mask is None else jnp.asarray(mask)))


def _port_img2img(s, spec, seed, hint=None, mask=None, control=None):
    tp = s["tp"] if control is None else s["tp"].with_control(s["tb"], control)
    B, H, W, _ = s["images"].shape
    return tp.img2img(tpipe.GenerationSpec(**spec), seed,
                      torch.from_numpy(s["images"]),
                      *_t(s["ctx"], s["unc"], s["y"], s["uy"]),
                      hint=None if hint is None else torch.from_numpy(hint),
                      mask=None if mask is None else torch.from_numpy(mask),
                      noise=jax_noise(seed, (B, H // 2, W // 2, 4)))


def test_img2img_matches_jax(s):
    spec = dict(SPEC, height=16, width=24, per_device_batch=2)
    ref = _jax_img2img(s, spec, 3)
    out = _port_img2img(s, spec, 3)
    assert tuple(out.shape) == (2, 16, 24, 3)
    assert np.abs(ref - s["images"]).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert s["tp"].timings["steps"] == 3 and s["tp"].timings["encode_s"] >= 0


def test_inpaint_matches_jax_and_keeps_the_source(s):
    spec = dict(SPEC, height=16, width=24, per_device_batch=2)
    mask = np.zeros((2, 16, 24, 1), np.float32)
    mask[:, :, :10] = 1.0
    mask[1, 4:8, 12:20] = 0.6
    ref = _jax_img2img(s, spec, 5, mask=mask)
    out = _port_img2img(s, spec, 5, mask=mask)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    keep = np.broadcast_to(mask == 0, out.shape)
    np.testing.assert_array_equal(out.numpy()[keep], s["images"][keep])
    assert np.abs(out.numpy() - s["images"])[:, :, :10].max() > 1e-2


def test_img2img_with_control_matches_jax(s):
    spec = dict(SPEC, height=16, width=24, per_device_batch=2)
    hint = np.random.default_rng(6).random((1, 64, 96, 3)).astype(np.float32)
    ref = _jax_img2img(s, spec, 7, hint=hint, control=0.8)
    out = _port_img2img(s, spec, 7, hint=hint, control=0.8)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert (out - _port_img2img(s, spec, 7)).abs().max() > 1e-4


def test_img2img_is_seeded(s):
    spec = tpipe.GenerationSpec(height=16, width=24, steps=4, denoise=0.5,
                                per_device_batch=2)
    args = _t(s["images"], s["ctx"], s["unc"])
    a, b, c = (s["tp"].img2img(spec, seed, *args) for seed in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --- the nodes ------------------------------------------------------------------


@pytest.fixture
def jax_noise_in_port(monkeypatch):
    """The port's img2img and tile plans draw JAX's noise."""
    img2img = tpipe.Txt2ImgPipeline.img2img
    range_plan = tengine.TileUpscaler.range_plan

    def i2i(self, spec, seed, images, *args, **kw):
        B, H, W, _ = images.shape
        kw["noise"] = jax_noise(seed, (B, H // 2, W // 2, 4))
        return img2img(self, spec, seed, images, *args, **kw)

    def plan(self, image, spec, seed, *args, **kw):
        grid = self.grid_for(image.shape[0], image.shape[1], spec)
        kw["noise"] = jax_tile_noise(seed, grid.num_tiles,
                                     (grid.crop_h // 2, grid.crop_w // 2, 4))
        return range_plan(self, image, spec, seed, *args, **kw)

    monkeypatch.setattr(tpipe.Txt2ImgPipeline, "img2img", i2i)
    monkeypatch.setattr(tengine.TileUpscaler, "range_plan", plan)


def _models(s):
    return (types.SimpleNamespace(pipeline=s["jp"]),
            types.SimpleNamespace(pipeline=s["tp"]))


def _with_control(s, strength=0.8):
    hint = s["hint"]
    (jpos,) = jnodes.ControlNetApply().execute(s["jpos"], s["jb"], hint,
                                               strength=strength)
    (tpos,) = get_node("ControlNetApply")().execute(
        s["tpos"], s["tb"], torch.from_numpy(hint), strength=strength)
    return jpos, tpos


@pytest.mark.parametrize("control", [False, True])
def test_img2img_node_matches_jax(s, jax_noise_in_port, control):
    jm, tm = _models(s)
    jpos, tpos = _with_control(s) if control else (s["jpos"], s["tpos"])
    args = (9, 6, 4.0, 0.5)
    (ref,) = jnodes.TPUImg2Img().execute(jm, s["images"], jpos, s["jneg"], *args,
                                         mesh=s["mesh"])
    (out,) = get_node("TPUImg2Img")().execute(tm, torch.from_numpy(s["images"]),
                                              tpos, s["tneg"], *args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["2d", "3d", "image", "resized", "clipped"])
def test_inpaint_node_matches_jax(s, jax_noise_in_port, kind):
    """Mask normalisation: [H,W], [B,H,W], an IMAGE (channel 0), another
    size (bilinear to the image), values outside [0, 1] (clipped)."""
    rng = np.random.default_rng(8)
    mask = {
        "2d": (rng.random((16, 24)) > 0.5).astype(np.float32),
        "3d": (rng.random((1, 16, 24)) > 0.5).astype(np.float32),
        "image": rng.random((1, 16, 24, 3)).astype(np.float32),
        "resized": rng.random((1, 10, 14)).astype(np.float32),
        "clipped": (rng.random((2, 16, 24)) * 3 - 1).astype(np.float32),
    }[kind]
    jm, tm = _models(s)
    args = (11, 6, 4.0, 0.6)
    (ref,) = jnodes.TPUInpaint().execute(jm, s["images"], mask, s["jpos"],
                                         s["jneg"], *args, mesh=s["mesh"])
    (out,) = get_node("TPUInpaint")().execute(
        tm, torch.from_numpy(s["images"]), torch.from_numpy(mask), s["tpos"],
        s["tneg"], *args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kw", [
    dict(width=40, height=20),
    dict(width=0, height=30, upscale_method="bicubic"),
    dict(width=20, height=0, upscale_method="nearest-exact"),
    dict(width=30, height=30, crop="center", method="bilinear"),
    dict(width=12, height=30, crop="center"),
])
def test_image_scale_matches_jax(s, kw):
    (ref,) = jnodes.ImageScale().execute(s["images"], **kw)
    (out,) = get_node("ImageScale")().execute(torch.from_numpy(s["images"]), **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("scale,method", [(2.0, "lanczos"), (0.5, "bilinear"),
                                          (1.5, "nearest-exact")])
def test_image_scale_by_matches_jax(s, scale, method):
    (ref,) = jnodes.ImageScaleBy().execute(s["images"][0], scale,
                                           upscale_method=method)
    (out,) = get_node("ImageScaleBy")().execute(torch.from_numpy(s["images"][0]),
                                                scale, upscale_method=method)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_image_scale_refusals_match_jax(s):
    from comfyui_distributed_tpu.utils.exceptions import ValidationError as JErr
    from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError as TErr

    img = s["images"]
    for node, kw in (("ImageScale", dict(width=0, height=0)),
                     ("ImageScale", dict(width=-1, height=4)),
                     ("ImageScale", dict(width=4, height=4, crop="edge")),
                     ("ImageScale", dict(width=4, height=4, method="bogus")),
                     ("ImageScaleBy", dict(scale_by=0.0))):
        with pytest.raises(JErr):
            getattr(jnodes, node)().execute(img, **kw)
        with pytest.raises(TErr):
            get_node(node)().execute(torch.from_numpy(img), **kw)


def test_solid_mask_matches_jax():
    (ref,) = jnodes.SolidMask().execute(0.25, 7, 5)
    (out,) = get_node("SolidMask")().execute(0.25, 7, 5)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("index,length", [(0, 1), (1, 5), (-3, 2), (9, 0)])
def test_image_from_batch_matches_jax(index, length):
    batch = np.arange(3 * 2 * 2 * 3, dtype=np.float32).reshape(3, 2, 2, 3)
    (ref,) = jnodes.ImageFromBatch().execute(batch, index, length)
    (out,) = get_node("ImageFromBatch")().execute(torch.from_numpy(batch),
                                                  index, length)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ckpt", ["", "tiny", "sdxl", "flux"])
def test_empty_latent_image_matches_jax(ckpt):
    (ref,) = jnodes.EmptyLatentImage().execute(64, 48, 2, ckpt_name=ckpt)
    (out,) = get_node("EmptyLatentImage")().execute(
        64, 48, 2, ckpt_name=ckpt, model_registry=ModelRegistry("cpu"))
    assert tuple(out["samples"].shape) == tuple(ref["samples"].shape)
    assert (out["height"], out["width"]) == (ref["height"], ref["width"])
    assert not out["samples"].any()


def test_vae_encode_decode_match_jax(s):
    img = s["images"]
    (jl,) = jnodes.VAEEncode().execute(img, s["jp"].vae)
    (tl,) = get_node("VAEEncode")().execute(torch.from_numpy(img), s["tp"].vae)
    np.testing.assert_allclose(tl["samples"].numpy(), np.asarray(jl["samples"]),
                               atol=TOL, rtol=TOL)
    (ji,) = jnodes.VAEDecode().execute(jl, s["jp"].vae)
    (ti,) = get_node("VAEDecode")().execute(tl, s["tp"].vae)
    assert tuple(ti.shape) == img.shape
    assert 0.0 <= float(ti.min()) and float(ti.max()) <= 1.0
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=TOL, rtol=TOL)


# --- Ultimate SD Upscale with ControlNet and spatial_cond ------------------------


def test_upscale_with_control_and_spatial_matches_jax(s):
    """The engine: a spatial map at the input's size and a hint of another
    size, both resized and cropped per tile; the hint in the stem's space
    (the tiny VAE shrinks 2×, so its grid is the image's × 4)."""
    img = s["images"][:1, :16, :20]
    smap = np.zeros((1, 16, 20, 1), np.float32)
    smap[:, :8] = 1.0
    smap[:, 8:, 10:] = 0.5
    jup = JaxUpscaler(s["jp"].with_control(s["jb"], 0.8))
    ref = np.asarray(jup.upscale(
        s["mesh"], jnp.asarray(img), JaxSpec(**UPSCALE), 13,
        *map(jnp.asarray, (s["ctx"], s["unc"], s["y"], s["uy"])),
        spatial_cond=jnp.asarray(smap), control_hint=jnp.asarray(s["hint"])))
    tup = tengine.TileUpscaler(s["tp"].with_control(s["tb"], 0.8))
    grid = tup.grid_for(16, 20, tengine.UpscaleSpec(**UPSCALE))
    assert tup.hint_grid(grid).image_w == 4 * grid.image_w
    noise = jax_tile_noise(13, grid.num_tiles, (grid.crop_h // 2, grid.crop_w // 2, 4))
    out = tup.upscale(torch.from_numpy(img), tengine.UpscaleSpec(**UPSCALE), 13,
                      *_t(s["ctx"], s["unc"], s["y"], s["uy"]), noise=noise,
                      spatial_cond=torch.from_numpy(smap),
                      control_hint=torch.from_numpy(s["hint"]))
    assert tuple(out.shape) == (1, 32, 40, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    plain = tengine.TileUpscaler(s["tp"]).upscale(
        torch.from_numpy(img), tengine.UpscaleSpec(**UPSCALE), 13,
        *_t(s["ctx"], s["unc"], s["y"], s["uy"]), noise=noise)
    assert (out - plain).abs().max() > 1e-3


class FakeFarm:
    """The farm's master role run locally: every task through
    ``process_fn`` in order."""

    def __init__(self):
        self.calls = []

    def master_run(self, job_id, total, process_fn, chunk=1, **_):
        self.calls.append((job_id, total, chunk))
        return {t: process_fn(t * chunk, min((t + 1) * chunk, total))
                for t in range(-(-total // chunk))}


@pytest.mark.parametrize("farm", [False, True])
def test_upscale_node_with_control_and_spatial_matches_jax(
        s, jax_noise_in_port, capfd, farm):
    """Hints and the spatial map on every tile, direct or farmed by range:
    every host runs the same graph and builds the same hint, so a farmed
    image is a direct one (the JAX package farms tiles without a hint;
    its direct run is the reference for both)."""
    jm, tm = _models(s)
    jpos, tpos = _with_control(s)
    img = s["images"][:1, :16, :20]
    smap = np.zeros((1, 16, 20), np.float32)
    smap[:, :, :12] = 1.0
    args = (13, 4, 0.5, 2.0)
    kw = dict(tile_width=16, tile_height=16, tile_padding=4, cfg=3.0)
    jfarm, tfarm = FakeFarm(), FakeFarm()
    farm_kw = (dict(multi_job_id="job", enabled_worker_ids=["w0"])
               if farm else {})
    (ref,) = jnodes.UltimateSDUpscaleDistributed().execute(
        img, jm, jpos, s["jneg"], *args, **kw, spatial_cond=smap,
        mesh=s["mesh"], tile_farm=jfarm)
    (out,) = get_node("UltimateSDUpscaleDistributed")().execute(
        torch.from_numpy(img), tm, tpos, s["tneg"], *args, **kw,
        spatial_cond=torch.from_numpy(smap), tile_farm=tfarm, **farm_kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    assert len(tfarm.calls) == (1 if farm else 0) and not jfarm.calls
    assert "ControlNet hints apply" not in capfd.readouterr().err
    if farm:
        # the farmed image is the direct one, bit for bit
        (direct,) = get_node("UltimateSDUpscaleDistributed")().execute(
            torch.from_numpy(img), tm, tpos, s["tneg"], *args, **kw,
            spatial_cond=torch.from_numpy(smap), tile_farm=FakeFarm())
        assert torch.equal(out, direct)
        # and the hint mattered: without the ControlNet it differs
        (plain,) = get_node("UltimateSDUpscaleDistributed")().execute(
            torch.from_numpy(img), tm, s["tpos"], s["tneg"], *args, **kw,
            spatial_cond=torch.from_numpy(smap), tile_farm=FakeFarm(),
            **farm_kw)
        assert (out - plain).abs().max() > 1e-3
