"""The port's FLUX txt2img path against the JAX package: the flow sigma
ladder, the ``flux`` presets, the ``flux-tiny`` pipeline end to end (the
port is handed JAX's own initial noise; the zero-initialised gates are
replaced as in ``tests/test_torch_dit.py``) and the shipped
``workflows/flux-txt2img.json`` through the port's graph executor."""

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

from comfyui_distributed_tpu.diffusion import pipeline_flow as jflow  # noqa: E402
from comfyui_distributed_tpu.diffusion import schedules as jsched  # noqa: E402
from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu.models import registry as jreg  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_flow as tflow  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import samplers as tsamp  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import schedules as tsched  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import PRESETS  # noqa: E402

from test_torch_dit import break_zero_init  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
WORKFLOW = Path(__file__).resolve().parents[1] / "workflows" / "flux-txt2img.json"


@pytest.mark.parametrize("steps,shift", [(28, 3.0), (3, 3.0), (5, 1.0), (1, 1.15)])
def test_sigmas_flow_match_jax(steps, shift):
    ref = np.asarray(jsched.sigmas_flow(steps, shift))
    out = tsched.sigmas_flow(steps, shift).numpy()
    assert out.shape == (steps + 1,) and out[0] == 1.0 and out[-1] == 0.0
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["flux", "flux-tiny"])
def test_flux_presets_match_jax(name):
    jp, tp = jreg.PRESETS[name], PRESETS[name]
    assert tp.kind == jp.kind == "dit" and tp.unet is None
    for field in ("vae", "text", "dit"):
        port = dataclasses.asdict(getattr(tp, field))
        ref = dataclasses.asdict(getattr(jp, field))
        assert {k: ref[k] for k in port} == port, field
    with torch.device("meta"):
        dec = tvae.AutoencoderKL(tp.vae).decoder
    # the decoder takes the DiT's latent channels
    assert dec.post_quant_conv.in_channels == dec.conv_in.in_channels \
        == tp.dit.in_channels


@pytest.fixture(scope="module")
def tiny_flow_pair():
    """The fp32 flux-tiny stack in both packages with the same weights
    (zero-init gates replaced), and JAX-encoded conditioning."""
    jcfg = jdit.DiTConfig.tiny(dtype="float32")
    model, params = jdit.init_dit(jcfg, jax.random.key(0), sample_hw=(8, 8),
                                  context_len=16)
    params = break_zero_init(params, 1)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(16, 16))
    jp = jflow.FlowPipeline(model, params, vae)
    dit = load_from_jax(tdit.DiT(tdit.DiTConfig.tiny(dtype="float32")), params)
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray, vae.dec_params))
    tp = tflow.FlowPipeline(dit.eval(), tv.eval())
    enc = jtext.TextEncoder(dataclasses.replace(jtext.TextEncoderConfig.tiny(),
                                                dtype="float32")).init(jax.random.key(2))
    ctx, pooled = enc.encode(["an isometric papercraft city"])
    return jp, tp, np.array(ctx), np.array(pooled)


def test_flux_tiny_pipeline_matches_jax(tiny_flow_pair):
    jp, tp, ctx, pooled = tiny_flow_pair
    spec = dict(height=16, width=16, steps=3, shift=3.0)
    seed = 5
    ref = np.asarray(jp.generate(build_mesh({"dp": 1}), jflow.FlowSpec(**spec),
                                 seed, ctx, pooled))
    # participant 0's key; the flow pipeline draws its noise from it directly
    key = jax.random.fold_in(jax.random.key(seed), 0)
    noise = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    out = tp.sample_and_decode(torch.from_numpy(noise), tflow.FlowSpec(**spec),
                               torch.from_numpy(ctx), torch.from_numpy(pooled))
    assert out.shape == ref.shape == (1, 16, 16, 3)
    assert 0.0 <= out.min() and out.max() <= 1.0
    # the sampler must have moved the latent: the same noise through a
    # zero velocity decodes to another image
    with torch.no_grad():
        still = tp.vae.decode(torch.from_numpy(noise)).div(2).add(0.5).clamp(0, 1)
    assert (out - still).abs().max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert tp.timings["steps"] == 3


def test_flux_tiny_generate_is_seeded(tiny_flow_pair):
    _, tp, ctx, pooled = tiny_flow_pair
    spec = tflow.FlowSpec(height=16, width=16, steps=2)
    args = [torch.from_numpy(a) for a in (ctx, pooled)]
    a, b, c = (tp.generate(spec, s, *args) for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("sampler", sorted(tsamp.PROGRAMS))
def test_flux_tiny_pipeline_matches_jax_with_every_sampler(tiny_flow_pair,
                                                           sampler):
    """Each of the 14 samplers through both flow pipelines: the JAX dp
    path draws the initial noise and the sampler's draws from one key
    (``normal(key)``, ``normal(fold_in(key, j))``), both handed to the
    port."""
    jp, tp, ctx, pooled = tiny_flow_pair
    spec = dict(height=16, width=16, steps=3, shift=3.0, sampler=sampler)
    seed = 6
    ref = np.asarray(jp.generate(build_mesh({"dp": 1}), jflow.FlowSpec(**spec),
                                 seed, ctx, pooled))
    key = jax.random.fold_in(jax.random.key(seed), 0)
    noise = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))

    def draws(j, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, j), tuple(shape), jnp.float32)))

    out = tp.sample_and_decode(torch.from_numpy(noise), tflow.FlowSpec(**spec),
                               torch.from_numpy(ctx), torch.from_numpy(pooled),
                               sampler_noise=draws)
    assert out.shape == ref.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("spec,match", [
    (dict(cfg=4.0), "CFG"), (dict(sampler="heun"), "heun")])
def test_flow_pipeline_rejects_unported(tiny_flow_pair, spec, match):
    """True CFG (ported since the SD3 slice; ``tests/test_torch_sd3.py``
    holds it to JAX's) needs its negative conditioning and runs with one;
    heun, refused before the port's samplers, runs."""
    _, tp, ctx, pooled = tiny_flow_pair
    fspec = tflow.FlowSpec(height=16, width=16, steps=2, **spec)
    args = (0, torch.from_numpy(ctx), torch.from_numpy(pooled))
    if match == "CFG":
        with pytest.raises(ValueError, match="requires negative conditioning"):
            tp.generate(fspec, *args)
        images = tp.generate(fspec, *args,
                             uncond_context=torch.zeros_like(args[1]))
        assert tuple(images.shape) == (1, 16, 16, 3)
        assert not torch.equal(images, tp.generate(
            dataclasses.replace(fspec, cfg=1.0), *args))
        return
    images = tp.generate(fspec, *args)
    assert tuple(images.shape) == (1, 16, 16, 3)
    assert torch.isfinite(images).all()


def _workflow(**sampler):
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    prompt = strip_meta(json.loads(WORKFLOW.read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "flux-tiny"
    prompt["4"]["inputs"].update(sampler)
    return prompt


def _executor(tmp_path):
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    return GraphExecutor({"model_registry": ModelRegistry("cpu", seed=0),
                          "output_dir": str(tmp_path)})


def test_flux_workflow_runs_through_port_executor(tmp_path):
    from comfyui_distributed_tpu_torch.graph import NODE_REGISTRY

    prompt = _workflow(width=24, height=16, steps=2)
    assert {n["class_type"] for n in prompt.values()} <= set(NODE_REGISTRY)
    ex = _executor(tmp_path)
    out = ex.execute(prompt)
    images = out["5"][0]
    assert images.shape == (1, 16, 24, 3) and torch.isfinite(images).all()
    assert 0.0 <= images.min() and images.max() <= 1.0
    png = (tmp_path / "flux_00000.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(png[16:20], "big") == 24
    assert int.from_bytes(png[20:24], "big") == 16
    assert torch.equal(ex.execute(prompt)["5"][0], images)
    prompt["3"]["inputs"]["seed"] = 1235
    assert not torch.equal(ex.execute(prompt)["5"][0], images)


@pytest.mark.parametrize("mode,item", [("sp", "A.6"), ("offload", "A.5"),
                                       ("tp", "A.6")])
def test_flux_workflow_rejects_unported_modes(tmp_path, mode, item):
    """Each mode other than ``dp`` is refused as a ``ValidationError`` on
    ``mode`` that names the ROADMAP item porting it, as the video nodes'
    refusals do (a bare ``NotImplementedError`` named none)."""
    from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError

    with pytest.raises(ValidationError, match="not ported yet") as err:
        _executor(tmp_path).execute(_workflow(width=16, height=16, steps=1,
                                              mode=mode))
    assert err.value.field == "mode" and f"item {item}" in str(err.value)


def test_flow_node_refuses_other_modes_before_touching_the_model():
    """The refusal needs no bundle: it comes before the spec is built."""
    from comfyui_distributed_tpu_torch.graph.nodes_builtin import TPUFlowTxt2Img
    from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError

    for mode in ("sp", "tp", "offload", "ring"):
        with pytest.raises(ValidationError) as err:
            TPUFlowTxt2Img().execute(None, {}, 0, 1, 16, 16, mode=mode)
        assert err.value.field == "mode"


def test_flow_node_defaults_pooled_to_zeros():
    """A conditioning without ``pooled`` samples with a zero pooled vector
    of the DiT's width, as the JAX node does."""
    from comfyui_distributed_tpu_torch.graph.nodes_builtin import TPUFlowTxt2Img
    from comfyui_distributed_tpu_torch.models.registry import ModelBundle

    bundle = ModelBundle(PRESETS["flux-tiny"], device="cpu", seed=0)
    ctx, _ = bundle.text_encoder.encode(["a"])
    args = dict(seed=3, steps=1, width=16, height=16)
    (a,) = TPUFlowTxt2Img().execute(bundle, {"context": ctx}, **args)
    (b,) = TPUFlowTxt2Img().execute(
        bundle, {"context": ctx, "pooled": torch.zeros(1, 16)}, **args)
    assert torch.equal(a, b)
