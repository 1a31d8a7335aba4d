"""The port's WAN 3D causal VAE (``models/wan_vae.py``) against the JAX
package's on the tiny fp32 config, with the JAX weights carried by
``models/from_jax.py``: encode, decode (a video and a single frame), the
decoder's head/tail staging, and ``decode_tiled`` (forced by small
tiles, as ``tests/test_wan_vae.py`` forces it, with clamped last tiles)
within 2e-4; the tile starts, pair feathers and axis ramps exactly; the
causal encoder's first latent frame independent of later frames."""

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.models import wan_vae as jvae  # noqa: E402
from comfyui_distributed_tpu_torch.models import wan_vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from torch_ckpt_fixtures import perturbed  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4


@pytest.fixture(scope="module")
def vae_pair():
    jv = jvae.WanVAE3D(jvae.WanVAEConfig.tiny()).init(
        jax.random.key(0), frames=5, image_hw=(8, 8))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jv.enc_params = perturbed(np_tree(jv.enc_params), 1)
    jv.dec_params = perturbed(np_tree(jv.dec_params), 2)
    tv = tvae.WanVAE3D(tvae.WanVAEConfig.tiny())
    load_from_jax(tv.encoder, jv.enc_params)
    load_from_jax(tv.decoder, jv.dec_params)
    return jv, tv.eval()


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=tol, rtol=tol)


def _video(seed, frames=5, hw=(8, 12)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1, frames, *hw, 3)).astype(np.float32)


def _latents(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@torch.no_grad()
def test_encode_matches_jax(vae_pair):
    jv, tv = vae_pair
    vid = _video(3)
    out = tv.encode(torch.from_numpy(vid))
    assert out.shape == (1, 3, 4, 6, 4)
    _close(out, jv.encode(vid))
    # a rank-4 image is a one-frame video
    _close(tv.encode(torch.from_numpy(vid[:, 0])), jv.encode(vid[:, 0]))


@torch.no_grad()
def test_decode_and_staging_match_jax(vae_pair):
    jv, tv = vae_pair
    lat = _latents(4, (1, 3, 4, 6, 4))
    whole = tv.decode(torch.from_numpy(lat))
    assert whole.shape == (1, 5, 8, 12, 3)
    _close(whole, jv.decode(lat))
    _close(tv.decode(torch.from_numpy(lat[:, 0])), jv.decode(lat[:, 0]))
    head = tv.decoder(torch.from_numpy(lat), stage="head")
    jhead = jv._dec_fn(jv.dec_params, lat, stage="head")
    _close(head.permute(0, 2, 3, 4, 1), jhead)
    assert torch.equal(tv.decoder(head, stage="tail").permute(0, 2, 3, 4, 1),
                       whole)


@pytest.mark.parametrize("hw,tile,overlap", [
    ((12, 12), 8, 4), ((12, 12), 10, 6), ((10, 14), 8, 3), ((6, 13), 8, 2)])
@torch.no_grad()
def test_decode_tiled_matches_jax(vae_pair, hw, tile, overlap):
    """Tiles, feathers over the actual overlaps (the clamped last tile's
    too) and the weight normalisation: the seams are part of the
    output."""
    jv, tv = vae_pair
    lat = _latents(5, (1, 2, *hw, 4))
    out = tv.decode_tiled(torch.from_numpy(lat), tile=tile, overlap=overlap)
    ref = jv.decode_tiled(lat, tile=tile, overlap=overlap)
    _close(out, ref)
    whole = tv.decode(torch.from_numpy(lat))
    assert (out - whole).abs().max() > 1e-4        # the tiles were blended


def test_tile_geometry_matches_jax():
    for full, t, step in [(60, 32, 24), (104, 32, 24), (12, 8, 4), (13, 8, 6),
                          (8, 8, 4), (5, 8, 4)]:
        starts = tvae._tile_starts(full, t, step)
        assert starts == jvae._tile_starts(full, t, step)
        feathers = tvae._pair_feathers(starts, min(t, full))
        assert feathers == jvae._pair_feathers(starts, min(t, full))
        for lo, hi in zip(*feathers):
            np.testing.assert_array_equal(
                tvae._axis_ramp(min(t, full), lo, hi, scale=8),
                jvae._axis_ramp(min(t, full), lo, hi, scale=8))
    assert tvae._tile_starts(60, 32, 24) == [0, 24, 28]
    assert tvae._tile_starts(104, 32, 24) == [0, 24, 48, 72]


def test_tiled_decode_refuses_overlap_past_tile(vae_pair):
    _, tv = vae_pair
    with pytest.raises(ValueError, match="overlap"):
        tv.decode_tiled(torch.zeros(1, 2, 12, 12, 4), tile=8, overlap=8)


@torch.no_grad()
def test_first_latent_ignores_later_frames(vae_pair):
    _, tv = vae_pair
    vid = _video(6)
    other = vid.copy()
    other[:, 1:] = _video(7)[:, 1:]
    a = tv.encode(torch.from_numpy(vid))
    b = tv.encode(torch.from_numpy(other))
    assert torch.equal(a[:, 0], b[:, 0]) and not torch.equal(a[:, 1], b[:, 1])
    cfg = tvae.WanVAEConfig.wan()
    assert (cfg.latent_frames(33), cfg.pixel_frames(9)) == (9, 33)
    assert (cfg.downscale, cfg.temporal_downscale) == (8, 4)
