"""The port's txt2img path against the JAX package: schedules and sigma
ladders, guidance, the euler sampler, the tiny pipeline end to end (the
port is handed JAX's own initial noise) and the shipped workflow through
the port's graph executor."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's models need flax. Where it is missing (the card's
# machine), only the card tests of tests/test_torch_cuda.py run.
pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.diffusion import schedules as jsched  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import guidance as tguid  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import samplers as tsamp  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import schedules as tsched  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
WORKFLOW = Path(__file__).resolve().parents[1] / "workflows" / "distributed-txt2img.json"
SCHEDULERS = ["karras", "normal", "exponential", "sgm_uniform", "beta",
              "linear_quadratic"]


def test_vp_schedule_and_timesteps_match_jax():
    js, ts = jsched.vp_schedule(), tsched.vp_schedule()
    # fp32 cumulative products over 1000 steps: a few ulp apart
    np.testing.assert_allclose(ts.sigmas.numpy(), np.asarray(js.sigmas),
                               rtol=1e-5)
    # inside the table, on its ends and beyond them (clipped)
    sigma = np.array([1e-4, 0.0292, 0.03, 0.5, 1.0, 3.7, 14.6146, 20.0, 500.0],
                     np.float32)
    ref = np.asarray(js.timestep_for_sigma(jnp.asarray(sigma)))
    out = ts.timestep_for_sigma(torch.from_numpy(sigma)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=1e-5)
    assert out[0] == 0.0 and out[-1] == 999.0


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("steps,denoise", [(10, 1.0), (7, 0.6), (1, 1.0)])
def test_sigma_ladders_match_jax(scheduler, steps, denoise):
    spec = dict(steps=steps, scheduler=scheduler, denoise=denoise)
    ref = np.asarray(jpipe.make_sigma_ladder(jpipe.GenerationSpec(**spec),
                                             jsched.vp_schedule()))
    out = tpipe.make_sigma_ladder(tpipe.GenerationSpec(**spec),
                                  tsched.vp_schedule()).numpy()
    assert out.shape == ref.shape and out[-1] == 0.0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_unknown_scheduler_and_sampler_raise():
    with pytest.raises(ValueError, match="scheduler"):
        tpipe.make_sigma_ladder(tpipe.GenerationSpec(scheduler="bogus"),
                                tsched.vp_schedule())
    # heun is ported now: it runs; an unknown name raises ValueError
    out = tsamp.sample("heun", lambda x, s: x * 0.5, torch.ones(1),
                       torch.tensor([2.0, 1.0, 0.0]))
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown sampler 'bogus'"):
        tsamp.sample("bogus", lambda x, s: x, torch.zeros(1), torch.ones(2))


def test_sdxl_adm_matches_jax():
    pooled = np.random.default_rng(0).standard_normal((2, 1280)).astype(np.float32)
    ref = np.asarray(jpipe.sdxl_adm(jnp.asarray(pooled), (1024, 768), (16, 0)))
    out = tpipe.sdxl_adm(torch.from_numpy(pooled), (1024, 768), (16, 0))
    assert out.shape == (2, 2816)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_cfg_batch_order_and_formula():
    """One doubled-batch call with [cond, uncond]; the result is
    uncond + s·(cond − uncond)."""
    seen = {}

    def make(ctx, y):
        seen["ctx"], seen["y"] = ctx, y

        def denoise(x, sigma):
            seen["x"] = x
            return x * ctx[:, :1, :1].reshape(-1, 1)

        return denoise

    cond, uncond = torch.full((1, 2, 3), 2.0), torch.full((1, 2, 3), 0.5)
    d = tguid.cfg_denoiser(make, cond, uncond, 3.0, torch.ones(1, 4), None)
    out = d(torch.ones(1, 5), torch.tensor(1.0))
    assert seen["x"].shape == (2, 5)
    assert torch.equal(seen["ctx"][0], cond[0]) and torch.equal(seen["ctx"][1], uncond[0])
    assert torch.equal(seen["y"], torch.tensor([[1.0] * 4, [0.0] * 4]))
    assert torch.allclose(out, torch.full((1, 5), 0.5 + 3.0 * (2.0 - 0.5)))


def test_euler_matches_closed_form():
    """With D(x, σ) = 0 each euler step scales x by σ_next/σ, so the run
    ends at x·σ_last/σ_first; the 1e-10 clamp keeps σ = 0 finite."""
    sigmas = tsched.sigmas_karras(5, 0.03, 14.6)
    x = torch.ones(3)
    out = tsamp.sample("euler", lambda x, s: torch.zeros_like(x), x, sigmas)
    assert torch.allclose(out, torch.zeros(3), atol=1e-6)
    out = tsamp.sample("euler", lambda x, s: torch.zeros_like(x), x,
                       sigmas[:-1])
    assert torch.allclose(out, x * sigmas[-2] / sigmas[0])


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny fp32 stack in both packages with the same weights, and
    JAX-encoded conditioning."""
    key = jax.random.key(0)
    model, params = junet.init_unet(junet.UNetConfig.tiny(dtype="float32"), key,
                                    sample_shape=(8, 8, 4), context_len=16)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(16, 16))
    jp = jpipe.Txt2ImgPipeline(model, params, vae)
    unet = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         jax.tree_util.tree_map(np.asarray, params)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray, vae.dec_params))
    tp = tpipe.Txt2ImgPipeline(unet, tv.eval())
    enc = jtext.TextEncoder(dataclasses.replace(jtext.TextEncoderConfig.tiny(),
                                                dtype="float32")).init(jax.random.key(2))
    ctx, pooled = enc.encode(["a cat"])
    unc, upooled = enc.encode([""])
    # the ADM vector as the sampler node builds it: pooled text cut (or
    # zero-padded) to the UNet's adm width
    y, uy = np.asarray(pooled)[:, :8], np.asarray(upooled)[:, :8]
    return jp, tp, [np.array(a) for a in (ctx, unc, y, uy)]


def test_tiny_pipeline_matches_jax(tiny_pair):
    jp, tp, (ctx, unc, y, uy) = tiny_pair
    spec = dict(height=16, width=16, steps=3, sampler="euler",
                scheduler="karras", guidance_scale=5.0)
    seed = 11
    ref = np.asarray(jp.generate(build_mesh({"dp": 1}), jpipe.GenerationSpec(**spec),
                                 seed, ctx, unc, y, uy))
    # participant 0's key, split into (noise, sampler) as the JAX pipeline does
    k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 0))
    noise = np.array(jax.random.normal(k_noise, (1, 8, 8, 4), jnp.float32))
    out = tp.sample_and_decode(torch.from_numpy(noise), tpipe.GenerationSpec(**spec),
                               *map(torch.from_numpy, (ctx, unc, y, uy)))
    assert out.shape == ref.shape == (1, 16, 16, 3)
    assert 0.0 <= out.min() and out.max() <= 1.0
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert tp.timings["steps"] == 3


def test_tiny_generate_is_seeded(tiny_pair):
    _, tp, (ctx, unc, y, uy) = tiny_pair
    spec = tpipe.GenerationSpec(height=16, width=16, steps=2, guidance_scale=1.0)
    args = [torch.from_numpy(a) for a in (ctx, unc, y, uy)]
    a, b, c = (tp.generate(spec, s, *args) for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def _workflow(**sampler):
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    prompt = strip_meta(json.loads(WORKFLOW.read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "tiny"
    prompt["5"]["inputs"].update(sampler)
    return prompt


def test_workflow_runs_through_port_executor(tmp_path):
    from comfyui_distributed_tpu_torch.graph import NODE_REGISTRY, GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    prompt = _workflow(width=24, height=16, steps=2)
    assert {n["class_type"] for n in prompt.values()} <= set(NODE_REGISTRY)
    ex = GraphExecutor({"model_registry": ModelRegistry("cpu", seed=0),
                        "output_dir": str(tmp_path)})
    out = ex.execute(prompt)
    images = out["6"][0]
    assert images.shape == (1, 16, 24, 3) and torch.isfinite(images).all()
    assert 0.0 <= images.min() and images.max() <= 1.0
    png = (tmp_path / "txt2img_00000.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(png[16:20], "big") == 24
    assert int.from_bytes(png[20:24], "big") == 16
    cond = out["2"][0]
    assert cond["context"].shape == (1, 16, 32) and cond["pooled"].shape == (1, 16)
    # the same prompt again is the same image
    assert torch.equal(ex.execute(prompt)["6"][0], images)


def test_workflow_rejects_unported_sampler(tmp_path):
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    ex = GraphExecutor({"model_registry": ModelRegistry("cpu"),
                        "output_dir": str(tmp_path)})
    # heun, refused before the samplers were ported, runs; a name no
    # sampler has fails the prompt
    images = ex.execute(_workflow(width=16, height=16, steps=2,
                                  sampler_name="heun"))["6"][0]
    assert tuple(images.shape) == (1, 16, 16, 3)
    assert torch.isfinite(images).all()
    with pytest.raises(Exception, match="unknown sampler 'bogus'"):
        ex.execute(_workflow(width=16, height=16, steps=1,
                             sampler_name="bogus"))


def test_adm_vector_is_padded_pooled_text():
    from comfyui_distributed_tpu_torch.graph.nodes_builtin import _adm_from_cond

    pooled = torch.arange(4.0).reshape(1, 4)
    adm = _adm_from_cond({"pooled": pooled}, 6, torch.device("cpu"))
    assert torch.equal(adm, torch.tensor([[0.0, 1.0, 2.0, 3.0, 0.0, 0.0]]))
    assert torch.equal(_adm_from_cond({"pooled": pooled}, 2, torch.device("cpu")),
                       pooled[:, :2])
    assert torch.equal(_adm_from_cond({}, 3, torch.device("cpu")), torch.zeros(1, 3))
