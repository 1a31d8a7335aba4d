"""The port's tile engine (``tiles/engine.py``) against the JAX package's
on the tiny stack in fp32, with weights carried by ``from_jax`` and
JAX's per-tile noise (threefry, the global tile index folded into the
seed's key) handed to the port: one chunk of a ``range_plan`` and the
whole ``TileUpscaler.upscale`` within 2e-4. Then the port against
itself: the same tiles through other chunk sizes and ranges agree
within 2e-4, and its own noise depends on the global tile index only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion.pipeline import (  # noqa: E402
    Txt2ImgPipeline as JaxPipeline)
from comfyui_distributed_tpu.models.text import TextEncoder, TextEncoderConfig  # noqa: E402
from comfyui_distributed_tpu.models.unet import UNetConfig, init_unet  # noqa: E402
from comfyui_distributed_tpu.models.vae import AutoencoderKL, VAEConfig  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu.tiles.engine import TileUpscaler as JaxUpscaler  # noqa: E402
from comfyui_distributed_tpu.tiles.engine import UpscaleSpec as JaxSpec  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion.pipeline import Txt2ImgPipeline  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.tiles.engine import TileUpscaler, UpscaleSpec  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
SEED = 11
SPEC = dict(scale=2.0, tile_w=16, tile_h=16, padding=4, steps=4, denoise=0.5,
            guidance_scale=3.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def stacks():
    """(JAX pipeline, port upscaler, context, uncond, image, JAX tiles of
    the whole plan, JAX composite, JAX noise per tile)."""
    model, params = init_unet(UNetConfig.tiny(dtype="float32"),
                              jax.random.key(0), sample_shape=(8, 8, 4),
                              context_len=16)
    vae = AutoencoderKL(VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(16, 16))
    jpipe = JaxPipeline(model, params, vae)
    enc = TextEncoder(TextEncoderConfig.tiny()).init(jax.random.key(2))
    ctx, _ = enc.encode(["tile prompt"])
    unc, _ = enc.encode([""])
    img = np.asarray(jax.random.uniform(jax.random.key(3), (16, 20, 3)))

    jups = JaxUpscaler(jpipe)
    plan = jups.range_plan(build_mesh({"dp": 1}), jnp.asarray(img),
                           JaxSpec(**SPEC), seed=SEED, context=ctx,
                           uncond_context=unc, tiles_per_device=2)
    tiles = np.asarray(plan.run_range(0, plan.num_tiles))
    composite = np.asarray(jups.composite(tiles, plan))

    unet = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         _np(params)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"),
                            encoder=True).eval()
    load_from_jax(tv.decoder, _np(vae.dec_params))
    load_from_jax(tv.encoder, _np(vae.enc_params))
    ups = TileUpscaler(Txt2ImgPipeline(unet, tv))
    key = jax.random.key(SEED)
    h, w = plan.grid.crop_h // 2, plan.grid.crop_w // 2
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (h, w, 4), jnp.float32))
        for i in range(plan.num_tiles)])
    return dict(ups=ups, ctx=torch.from_numpy(np.array(ctx)),
                unc=torch.from_numpy(np.array(unc)),
                img=torch.from_numpy(img.copy()), tiles=tiles,
                composite=composite, noise=torch.from_numpy(noise),
                num_tiles=plan.num_tiles)


def _plan(s, chunk=2, noise=True, first_index=0):
    return s["ups"].range_plan(s["img"], UpscaleSpec(**SPEC), SEED, s["ctx"],
                               s["unc"], tiles_per_device=chunk,
                               first_index=first_index,
                               noise=s["noise"] if noise else None)


def test_range_plan_chunk_matches_jax(stacks):
    plan = _plan(stacks)
    assert plan.num_tiles == stacks["num_tiles"] == 6 and plan.chunk == 2
    out = plan.run_range(2, 4)
    assert out.shape == stacks["tiles"][2:4].shape and out.dtype == np.float32
    np.testing.assert_allclose(out, stacks["tiles"][2:4], atol=TOL, rtol=TOL)


def test_upscale_matches_jax(stacks):
    s = stacks
    out = s["ups"].upscale(s["img"][None], UpscaleSpec(**SPEC), SEED, s["ctx"],
                           s["unc"], tiles_per_device=3, noise=s["noise"])
    assert tuple(out.shape) == (1, 32, 40, 3)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    np.testing.assert_allclose(out[0].numpy(), s["composite"], atol=TOL, rtol=TOL)
    timings = s["ups"].pipeline.timings
    assert timings["tile_chunks"] and timings["composite_s"] >= 0.0


@pytest.mark.parametrize("chunk,ranges", [
    (1, [(0, 6)]),
    (4, [(0, 4), (4, 6)]),          # a last chunk padded with 2 zero tiles
    (2, [(0, 3), (3, 6)]),          # ranges across chunk edges
    (6, [(0, 6)]),
])
def test_tiles_invariant_to_chunk_and_range(stacks, chunk, ranges):
    ref = _plan(stacks, chunk=2, noise=False).run_range(0, 6)
    plan = _plan(stacks, chunk=chunk, noise=False)
    out = np.concatenate([plan.run_range(a, b) for a, b in ranges])
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_port_noise_follows_the_global_tile_index(stacks):
    """Tile i of an image numbered from ``first_index`` f draws tile
    f + i's noise: the second image of a batch sees other noise, and a
    plan that starts at that index reproduces it."""
    s = stacks
    first = _plan(s, noise=False).run_range(0, 2)
    second = _plan(s, noise=False, first_index=6).run_range(0, 2)
    assert not np.allclose(first, second)
    batch = s["ups"].upscale(torch.stack([s["img"], s["img"]]),
                             UpscaleSpec(**SPEC), SEED, s["ctx"], s["unc"],
                             tiles_per_device=2)
    one = s["ups"].upscale(s["img"][None], UpscaleSpec(**SPEC), SEED,
                           s["ctx"], s["unc"], tiles_per_device=2)
    np.testing.assert_allclose(batch[0].numpy(), one[0].numpy(), atol=TOL)
    assert not np.allclose(batch[0].numpy(), batch[1].numpy())


def test_empty_range_and_source_range(stacks):
    plan = _plan(stacks)
    assert plan.run_range(3, 3).shape == (0,) + stacks["tiles"].shape[1:]
    src = plan.source_range(0, 6)
    assert src.shape == stacks["tiles"].shape
    assert src.min() >= 0.0 and src.max() <= 1.0


def test_chunk_defaults(stacks, monkeypatch):
    ups = stacks["ups"]
    monkeypatch.delenv("CDT_TILES_PER_DEVICE", raising=False)
    assert ups.tiles_per_device_default(1024, 1024) == 1      # the CPU
    monkeypatch.setenv("CDT_TILES_PER_DEVICE", "3")
    assert ups.tiles_per_device_default(1024, 1024) == 3
    monkeypatch.setenv("CDT_TILES_PER_DEVICE", "garbage")
    assert ups.tiles_per_device_default(1024, 1024) == 1
