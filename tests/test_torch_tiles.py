"""The upscale workflow's building blocks against the JAX package's: the
tile grid, feather masks, extraction and composite (exact), the VAE
encoder, RRDBNet at ×4 and at ×2 with its pixel-unshuffle stem and the
tiled model upscale (fp32 at 2e-4); and the loader and upscale nodes on
the CPU. The resize has its own file (``test_torch_resize.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.models import upscaler as jup  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.ops import blend as jblend  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu.tiles import grid as jgrid  # noqa: E402
from comfyui_distributed_tpu.tiles.model_upscale import (  # noqa: E402
    tiled_model_upscale as jax_tiled)
from comfyui_distributed_tpu_torch.models import upscaler as tup  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.ops import blend as tblend  # noqa: E402
from comfyui_distributed_tpu_torch.tiles import grid as tgrid  # noqa: E402
from comfyui_distributed_tpu_torch.tiles.model_upscale import (  # noqa: E402
    tiled_model_upscale)
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed):
    """Every leaf plus numpy noise, so zero-initialised biases and unit
    norm scales are carried as real values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        tree)


def _image(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# --- grid, masks, extraction, composite -----------------------------------------

GRIDS = [(50, 40, 16, 16, 4), (64, 64, 32, 32, 8), (33, 17, 10, 7, 3),
         (12, 12, 32, 32, 4)]


@pytest.mark.parametrize("geom", GRIDS)
def test_grid_masks_extract_composite_match_jax(geom):
    W, H, tw, th, p = geom
    jg, tg = jgrid.compute_tile_grid(W, H, tw, th, p), tgrid.compute_tile_grid(W, H, tw, th, p)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    assert jgrid.pad_count_to(tg.num_tiles, 3) == tgrid.pad_count_to(tg.num_tiles, 3)
    for feather in (None, 2):
        np.testing.assert_array_equal(
            tblend.feather_mask(tg, feather).numpy(),
            np.asarray(jblend.feather_mask(jg, feather)))
    img = _image(3, H, W, 3)
    tiles = tblend.extract_tiles(torch.from_numpy(img), tg)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(jblend.extract_tiles(jnp.asarray(img), jg)))
    other = _image(4, *tiles.shape)
    masks = tblend.feather_mask(tg)
    np.testing.assert_array_equal(
        tblend.composite_tiles(torch.from_numpy(other), masks, tg).numpy(),
        np.asarray(jblend.composite_tiles(jnp.asarray(other),
                                          jnp.asarray(masks.numpy()), jg)))
    # unmodified tiles composite back to the image
    np.testing.assert_allclose(tblend.composite_tiles(tiles, masks, tg).numpy(),
                               img, atol=1e-6)


def test_grid_cores_tile_the_image():
    g = tgrid.compute_tile_grid(50, 40, 16, 16, 4)
    cover = np.zeros((40, 50), np.int32)
    for reg in g.regions:
        assert 0 <= reg.x0 <= 50 - g.crop_w and 0 <= reg.y0 <= 40 - g.crop_h
        y0, x0 = reg.y0 + reg.core_y0, reg.x0 + reg.core_x0
        cover[y0:y0 + reg.core_h, x0:x0 + reg.core_w] += 1
    assert (cover == 1).all()


# --- VAE encoder ------------------------------------------------------------------


def test_vae_encoder_matches_jax():
    cfg = jvae.VAEConfig.tiny(dtype="float32")
    ae = jvae.AutoencoderKL(cfg).init(jax.random.key(0), image_hw=(16, 16))
    enc = _perturbed(_np(ae.enc_params), 1)
    ae.enc_params = enc
    port = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"),
                              encoder=True).eval()
    load_from_jax(port.encoder, enc)
    x = _image(5, 2, 16, 12, 3) * 2 - 1
    ref = np.asarray(ae.encode(jnp.asarray(x)))
    with torch.no_grad():
        out = port.encode(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape == (2, 8, 6, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_vae_without_encoder_refuses_to_encode():
    port = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    with pytest.raises(RuntimeError, match="without an encoder"):
        port.encode(torch.zeros(1, 8, 8, 3))


# --- RRDBNet and the tiled upscale ------------------------------------------------


def _pair(scale):
    jcfg = dataclasses.replace(jup.UpscalerConfig.tiny(scale=scale), dtype="float32")
    bundle = jup.init_upscaler(jcfg, jax.random.key(scale), sample_hw=(8, 8))
    bundle.params = _perturbed(_np(bundle.params), scale)
    model = tup.RRDBNet(tup.UpscalerConfig.tiny(scale=scale, dtype="float32"))
    load_from_jax(model, bundle.params)
    return bundle, tup.UpscalerBundle(model.eval(), f"tiny-x{scale}")


def test_upscaler_presets_match_jax():
    assert dataclasses.asdict(tup.PRESETS["esrgan-x4"]) == dataclasses.asdict(
        jup.UpscalerConfig.esrgan_x4())
    assert dataclasses.asdict(tup.PRESETS["realesrgan-x2"]) == dataclasses.asdict(
        jup.UpscalerConfig.realesrgan_x2())
    assert dataclasses.asdict(tup.PRESETS["tiny-x4"]) == dataclasses.asdict(
        jup.UpscalerConfig.tiny(scale=4))


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_matches_jax(scale):
    jb, tb = _pair(scale)
    img = _image(6, 2, 12, 8, 3)
    ref = np.asarray(jb.apply(jnp.asarray(img)))
    out = tb.apply(torch.from_numpy(img))
    assert tuple(out.shape) == ref.shape == (2, 12 * scale, 8 * scale, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scale,shape,tile,padding", [
    (4, (1, 24, 20, 3), 8, 4),
    (2, (2, 13, 17, 3), 8, 4),          # odd sizes: edge-pad and crop
    (2, (1, 16, 16, 3), 32, 4),         # one tile
])
def test_tiled_model_upscale_matches_jax(scale, shape, tile, padding):
    jb, tb = _pair(scale)
    img = _image(7, *shape)
    ref = np.asarray(jax_tiled(build_mesh({"dp": 1}), jb, jnp.asarray(img),
                               tile=tile, padding=padding))
    out = tiled_model_upscale(tb, torch.from_numpy(img), tile=tile,
                              padding=padding)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_tiled_model_upscale_batch_invariant(monkeypatch):
    from comfyui_distributed_tpu_torch.tiles import model_upscale

    _, tb = _pair(4)
    img = torch.from_numpy(_image(8, 1, 24, 24, 3))
    monkeypatch.setattr(model_upscale, "TILE_BATCH", 1)
    a = tiled_model_upscale(tb, img, tile=8, padding=4)
    monkeypatch.setattr(model_upscale, "TILE_BATCH", 4)
    b = tiled_model_upscale(tb, img, tile=8, padding=4)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    whole = tb.apply(img)
    single = tiled_model_upscale(tb, img, tile=32, padding=4)
    np.testing.assert_allclose(single.numpy(), whole.numpy(), atol=1e-6)


# --- nodes --------------------------------------------------------------------------


def _registry():
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    return ModelRegistry("cpu", seed=0)


def test_upscale_loader_and_apply_nodes(monkeypatch, tmp_path):
    from comfyui_distributed_tpu_torch.graph.node import get_node

    monkeypatch.delenv("CDT_UPSCALE_MODEL_DIR", raising=False)
    reg = _registry()
    loader = get_node("UpscaleModelLoader")()
    (bundle,) = loader.execute("tiny-x2", model_registry=reg)
    assert bundle.scale == 2 and bundle.name == "tiny-x2"
    assert loader.execute("tiny-x2", model_registry=reg)[0] is bundle
    # the same seed on another registry draws the same weights
    (again,) = loader.execute("tiny-x2", model_registry=_registry())
    for p, q in zip(bundle.model.parameters(), again.model.parameters()):
        assert torch.equal(p, q)
    (out,) = get_node("ImageUpscaleWithModel")().execute(
        bundle, torch.from_numpy(_image(9, 1, 16, 16, 3)), tile=8, tile_padding=4)
    assert tuple(out.shape) == (1, 32, 32, 3)
    with pytest.raises(ValidationError, match="unknown upscale model"):
        loader.execute("nope-x9", model_registry=reg)
    # a checkpoint file is loaded (a broken one raises), not silently
    # replaced by random init
    from comfyui_distributed_tpu_torch.utils.safetensors import SafetensorsError

    monkeypatch.setenv("CDT_UPSCALE_MODEL_DIR", str(tmp_path))
    (tmp_path / "tiny-x2.safetensors").write_bytes(b"\0" * 8)
    with pytest.raises(SafetensorsError):
        loader.execute("tiny-x2", model_registry=reg)


def test_load_image_node(tmp_path):
    from comfyui_distributed_tpu_torch.graph.node import get_node
    from comfyui_distributed_tpu_torch.utils.image import encode_png

    img = _image(10, 6, 5, 3)
    (tmp_path / "in.png").write_bytes(encode_png(img))
    node = get_node("LoadImage")()
    (out,) = node.execute("in.png", input_dir=str(tmp_path),
                          model_registry=_registry())
    assert tuple(out.shape) == (1, 6, 5, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out[0].numpy(), img, atol=1 / 255)
    with pytest.raises(ValidationError, match="not found"):
        node.execute("missing.png", input_dir=str(tmp_path))
    with pytest.raises(ValidationError, match="leaves the input"):
        node.execute("../in.png", input_dir=str(tmp_path / "sub"))
