"""The port's video pipeline (``diffusion/pipeline_video.py``) against the
JAX package's ``VideoPipeline`` (its ``dp`` program on one device), on
tiny fp32 WAN stacks with the same weights (``models/from_jax.py``) and
JAX's initial noise handed to the port: t2v with CFG through the 3D
causal VAE with its tiled decode forced (small thresholds on both
sides), i2v (``i2v_condition``'s latents and first-frame mask, the
latent concat), and WAN 2.2's two experts (the split, each expert's
model calls), each within 2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline_video as jpv  # noqa: E402
from comfyui_distributed_tpu.models import vae as jimg  # noqa: E402
from comfyui_distributed_tpu.models import wan as jwan  # noqa: E402
from comfyui_distributed_tpu.models import wan_vae as jwv  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu.utils import constants as jconst  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_video as tpv  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as timg  # noqa: E402
from comfyui_distributed_tpu_torch.models import wan as twan  # noqa: E402
from comfyui_distributed_tpu_torch.models import wan_vae as twv  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from torch_ckpt_fixtures import perturbed  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _wan(seed: int, **kw):
    """(JAX model and params, the port's WanModel) of one tiny expert."""
    model, params = jwan.init_wan(jwan.WanConfig.tiny(**kw), jax.random.key(seed),
                                  sample_fhw=(3, 4, 4), context_len=6)
    params = perturbed(_np(params), seed + 10)
    port = load_from_jax(twan.WanModel(twan.WanConfig.tiny(**kw)), params).eval()
    return model, params, port


def _vae3d():
    jv = jwv.WanVAE3D(jwv.WanVAEConfig.tiny()).init(jax.random.key(5), frames=5,
                                                    image_hw=(8, 8))
    tv = twv.WanVAE3D(twv.WanVAEConfig.tiny())
    load_from_jax(tv.encoder, _np(jv.enc_params))
    load_from_jax(tv.decoder, _np(jv.dec_params))
    return jv, tv.eval()


def _conditioning(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 5, 32)).astype(np.float32),
            rng.standard_normal((1, 16)).astype(np.float32))


def _noise(seed: int, shape) -> np.ndarray:
    """JAX dp participant 0's initial noise."""
    key = jax.random.fold_in(jax.random.key(seed), 0)
    return np.array(jax.random.normal(key, shape, jnp.float32))


def _run_both(jp, tp, spec, seed, ctx, pooled, image=None):
    mesh = build_mesh({"dp": 1})
    if image is None:
        ref = jp.generate(mesh, jpv.VideoSpec(**spec), seed, ctx, pooled)
    else:
        ref = jp.generate_i2v(mesh, jpv.VideoSpec(**spec), seed, image, ctx,
                              pooled)
    tspec = tpv.VideoSpec(**spec)
    noise = torch.from_numpy(_noise(seed, tp.latent_shape(tspec)))
    cond = None
    if image is not None:
        cond = tp.i2v_condition(torch.from_numpy(image), tspec)
    out = tp.sample_and_decode(noise, tspec, torch.from_numpy(ctx),
                               torch.from_numpy(pooled), cond=cond)
    return out, np.asarray(ref), cond


def test_t2v_with_cfg_and_tiled_decode_matches_jax(monkeypatch):
    model, params, port = _wan(0)
    jv, tv = _vae3d()
    # a latent of 8×8 tiles past a threshold of 16, in tiles of 6
    monkeypatch.setattr(jconst, "VAE_TILE_THRESHOLD", 16)
    monkeypatch.setattr(jconst, "VAE_TILE", 6)
    monkeypatch.setattr(jconst, "VAE_TILE_OVERLAP", 2)
    for var, v in (("CDT_VAE_TILE_THRESHOLD", "16"), ("CDT_VAE_TILE", "6"),
                   ("CDT_VAE_TILE_OVERLAP", "2")):
        monkeypatch.setenv(var, v)
    jp = jpv.VideoPipeline(model, params, jv)
    tp = tpv.VideoPipeline(port, tv)
    spec = dict(frames=5, height=16, width=16, steps=3, shift=3.0,
                guidance_scale=5.0)
    ctx, pooled = _conditioning(1)
    out, ref, _ = _run_both(jp, tp, spec, 7, ctx, pooled)
    assert out.shape == ref.shape == (1, 5, 16, 16, 3)
    assert tp.timings["calls"] == {"high": 3} and tp.timings["steps"] == 3
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_i2v_matches_jax():
    model, params, port = _wan(1, in_channels=10)
    jv, tv = _vae3d()
    jp = jpv.VideoPipeline(model, params, jv)
    tp = tpv.VideoPipeline(port, tv)
    spec = dict(frames=5, height=8, width=8, steps=2, shift=3.0,
                guidance_scale=4.0)
    image = np.random.default_rng(3).uniform(0, 1, (1, 8, 8, 3)).astype(np.float32)
    ctx, pooled = _conditioning(2)
    out, ref, (y, mask) = _run_both(jp, tp, spec, 11, ctx, pooled, image)
    jy, jmask = jp.i2v_condition(jnp.asarray(image), jpv.VideoSpec(**spec))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.shape == (1, 3, 4, 4, 2) and mask[:, 0].eq(1).all()
    assert not mask[:, 1:].any()
    assert out.shape == ref.shape == (1, 5, 8, 8, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("steps,shift,split", [(4, 3.0, 2), (3, 1.0, 1)])
def test_two_experts_match_jax(steps, shift, split):
    """WAN 2.2's split at sigma 0.875 through the per-frame image VAE
    (``wan-2.2-tiny``'s): each expert takes its segment of the ladder."""
    hi_model, hi_params, hi = _wan(2)
    _, lo_params, lo = _wan(3)
    jv = jimg.AutoencoderKL(jimg.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(4), image_hw=(16, 16))
    tv = timg.AutoencoderKL(timg.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, _np(jv.dec_params))
    jp = jpv.VideoPipeline(hi_model, hi_params, jv, dit_params_low=lo_params,
                           expert_boundary=0.875)
    tp = tpv.VideoPipeline(hi, tv.eval(), lo, 0.875)
    sigmas = tpv.sigmas_flow(steps, shift)
    assert tp._expert_split(sigmas) == jp._expert_split(np.asarray(sigmas)) == split
    spec = dict(frames=5, height=16, width=16, steps=steps, shift=shift,
                guidance_scale=3.0)
    ctx, pooled = _conditioning(5)
    out, ref, _ = _run_both(jp, tp, spec, 3, ctx, pooled)
    assert tp.timings["calls"] == {"high": split, "low": steps - split}
    assert out.shape == ref.shape == (1, 5, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_generate_is_seeded():
    _, _, port = _wan(0)
    _, tv = _vae3d()
    tp = tpv.VideoPipeline(port, tv)
    spec = tpv.VideoSpec(frames=5, height=8, width=8, steps=2)
    ctx, pooled = (torch.from_numpy(a) for a in _conditioning(6))
    a, b, c = (tp.generate(spec, s, ctx, pooled) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jpv.VideoSpec(
        frames=5, height=8, width=8, steps=2))
    assert spec.padded_frames == 5 and tpv.VideoSpec(frames=6).padded_frames == 9
