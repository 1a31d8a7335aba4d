"""The port's ``dp`` programs on two CPU ranks over gloo against the JAX
package on two of its eight virtual devices, on the same inputs:
flux-tiny and the tiny UNet stack against JAX's ``dp`` ``generate`` with
JAX's per-participant noise handed over (2e-4); through ``TPUTxt2Img`` /
``TPUFlowTxt2Img`` and the graph executor, participant 0 bitwise the
one-device run and participant 1 bitwise ``sample_and_decode`` of
participant 1's noise; every rank's registry bundle bitwise rank 0's
(parameter digests); the nodes without a mesh program refuse a mesh of
more than one rank."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.diffusion import pipeline_flow as jflow  # noqa: E402
from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh as jbuild_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_flow as tflow  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.bootstrap import MeshRuntime  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.rng import (participant_seed,  # noqa: E402
                                                        seed_generator,
                                                        step_noise)

from test_torch_dit import break_zero_init  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
HW = 16


@pytest.fixture(scope="module")
def mesh(cpu_share, tmp_path_factory):
    """Rank 0's ``{"dp": 2}`` mesh over two CPU ranks; ``sp`` calls re-lay
    the same ranks. Followers build registry bundles from seed 0."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    os.environ["CDT_LOG_DIR"] = str(tmp_path_factory.mktemp("mesh_logs"))
    m = build_mesh({"dp": 2}, 2, torch.device("cpu"))
    m.runtime = MeshRuntime(m, seed=0)
    yield m
    m.runtime.stop()
    if old is None:
        os.environ.pop("CDT_LOG_DIR", None)
    else:
        os.environ["CDT_LOG_DIR"] = old


def jmesh(axis):
    return jbuild_mesh({axis: 2}, jax.devices()[:2])


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a).copy())


def encoder():
    return jtext.TextEncoder(dataclasses.replace(
        jtext.TextEncoderConfig.tiny(), dtype="float32")).init(jax.random.key(2))


def flow_pair(cfg_kw: dict, sd3: bool = False):
    """(JAX pipeline, port pipeline) of a tiny DiT config, fp32, the
    zero-initialised gates replaced."""
    if sd3:
        jcfg = dataclasses.replace(jdit.DiTConfig.sd3_tiny(), dtype="float32")
        tcfg = tdit.DiTConfig.sd3_tiny(dtype="float32")
    else:
        jcfg = jdit.DiTConfig.tiny(dtype="float32", **cfg_kw)
        tcfg = tdit.DiTConfig.tiny(dtype="float32", **cfg_kw)
    model, params = jdit.init_dit(jcfg, jax.random.key(0), sample_hw=(8, 8),
                                  context_len=16)
    params = break_zero_init(params, 1)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(HW, HW))
    jp = jflow.FlowPipeline(model, params, vae)
    dit = load_from_jax(tdit.DiT(tcfg), params)
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray,
                                                     vae.dec_params))
    return jp, tflow.FlowPipeline(dit.eval(), tv.eval())


@pytest.fixture(scope="module")
def conditioning():
    enc = encoder()
    ctx, pooled = enc.encode(["an isometric papercraft city"])
    uctx, upooled = enc.encode(["blurry"])
    return [np.array(a) for a in (ctx, pooled, uctx, upooled)]


# --- dp ---------------------------------------------------------------------


def test_flow_dp_matches_jax(mesh, conditioning):
    ctx, pooled, _, _ = conditioning
    jp, tp = flow_pair({"pos_embed": "rope"})
    spec = dict(height=HW, width=HW, steps=2, shift=3.0)
    seed = 3
    ref = np.asarray(jp.generate(jmesh("dp"), jflow.FlowSpec(**spec), seed,
                                 ctx, pooled))
    noises = [_t(jax.random.normal(
        jax.random.fold_in(jax.random.key(seed), p), (1, 8, 8, 4),
        jnp.float32)) for p in range(2)]
    out = mesh.runtime.run("flow_dp", types.SimpleNamespace(pipeline=tp),
                           tflow.FlowSpec(**spec), seed, _t(ctx), _t(pooled),
                           noises=noises)
    assert out.shape == ref.shape == (2, HW, HW, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_txt2img_dp_matches_jax(mesh):
    key = jax.random.key(0)
    model, params = junet.init_unet(junet.UNetConfig.tiny(dtype="float32"),
                                    key, sample_shape=(8, 8, 4),
                                    context_len=16)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(HW, HW))
    jp = jpipe.Txt2ImgPipeline(model, params, vae)
    unet = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         jax.tree_util.tree_map(np.asarray, params)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray,
                                                     vae.dec_params))
    tp = tpipe.Txt2ImgPipeline(unet, tv.eval())
    enc = encoder()
    ctx, pooled = enc.encode(["a cat"])
    unc, upooled = enc.encode([""])
    y, uy = np.asarray(pooled)[:, :8], np.asarray(upooled)[:, :8]
    args = [np.array(a) for a in (ctx, unc, y, uy)]
    spec = dict(height=HW, width=HW, steps=2, sampler="euler",
                scheduler="karras", guidance_scale=5.0)
    seed = 11
    ref = np.asarray(jp.generate(jmesh("dp"), jpipe.GenerationSpec(**spec),
                                 seed, *args))
    noises = []
    for p in range(2):
        k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed),
                                                         p))
        noises.append(_t(jax.random.normal(k_noise, (1, 8, 8, 4),
                                           jnp.float32)))
    out = mesh.runtime.run("txt2img_dp", types.SimpleNamespace(pipeline=tp),
                           tpipe.GenerationSpec(**spec), seed,
                           *map(_t, args), noises=noises)
    assert out.shape == ref.shape == (2, HW, HW, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def _graph(name: str, seed: int) -> dict:
    """CheckpointLoader → CLIPTextEncode → the sampler node, literal
    inputs (node "4" the sampler)."""
    nodes = {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": name}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lighthouse", "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["1", 1]}},
    }
    common = dict(model=["1", 0], positive=["2", 0], seed=seed, steps=2,
                  width=HW, height=HW)
    if name == "tiny":
        nodes["4"] = {"class_type": "TPUTxt2Img", "inputs": dict(
            common, negative=["3", 0], cfg=5.0, sampler_name="euler",
            scheduler="karras")}
    else:
        nodes["4"] = {"class_type": "TPUFlowTxt2Img", "inputs": common}
    return nodes


@pytest.mark.parametrize("name", ["tiny", "flux-tiny"])
def test_dp_graph_participants(mesh, tmp_path, name):
    """Through the sampler node and the graph executor: participant 0 is
    bitwise the one-device run, participant 1 bitwise ``sample_and_decode``
    of participant 1's noise."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    registry = ModelRegistry("cpu", seed=0)
    seed = 21
    prompt = _graph(name, seed)
    base = {"model_registry": registry, "output_dir": str(tmp_path)}
    out = GraphExecutor(base).execute(prompt)
    solo = out["4"][0]
    both = GraphExecutor(dict(base, mesh=mesh)).execute(prompt)["4"][0]
    assert solo.shape == (1, HW, HW, 3) and both.shape == (2, HW, HW, 3)
    assert torch.equal(both[:1], solo)
    assert mesh.runtime.last_call["program"] in ("txt2img_dp", "flow_dp")
    # participant 1 by hand on rank 0's bundle
    pipe = registry.get(name).pipeline
    s1 = participant_seed(seed, 1)
    assert s1 != seed
    pos, neg = out["2"][0], out["3"][0]
    if name == "tiny":
        spec = tpipe.GenerationSpec(height=HW, width=HW, steps=2,
                                    guidance_scale=5.0)
        adm = pipe.unet.config.adm_in_channels

        def y_of(c):
            return torch.nn.functional.pad(c["pooled"].float(),
                                           (0, adm - c["pooled"].shape[-1]))

        noise = pipe.initial_noise(spec, seed_generator(s1, pipe.device))
        one = pipe.sample_and_decode(noise, spec, pos["context"],
                                     neg["context"], y_of(pos), y_of(neg),
                                     sampler_noise=step_noise(s1, pipe.device))
    else:
        spec = tflow.FlowSpec(height=HW, width=HW, steps=2)
        noise = pipe.initial_noise(spec, seed_generator(s1, pipe.device))
        one = pipe.sample_and_decode(noise, spec, pos["context"],
                                     pos["pooled"],
                                     sampler_noise=step_noise(s1, pipe.device))
    assert torch.equal(both[1:], one)
    assert not torch.equal(both[1:], both[:1])


@pytest.mark.parametrize("name", ["tiny", "flux-tiny"])
def test_every_rank_holds_the_same_weights(mesh, name):
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.parallel.programs import param_digest

    bundle = ModelRegistry("cpu", seed=0).get(name)
    digests = mesh.runtime.run("param_digest", bundle)
    assert len(digests) == 2 and digests[0] == digests[1]
    assert digests[0] == param_digest(bundle)
    other = ModelRegistry("cpu", seed=1).get(name)
    assert param_digest(other) != digests[0]


def test_nodes_without_a_mesh_program_refuse_a_mesh():
    from comfyui_distributed_tpu_torch.graph import nodes_builtin as nb
    from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError

    two = build_mesh({"dp": 2}, 2, torch.device("cpu"))
    cases = [
        (nb.TPUImg2Img, dict(model=None, image=None, positive=None,
                             negative=None, seed=0, steps=1, cfg=1.0,
                             denoise=0.5)),
        (nb.TPUInpaint, dict(model=None, image=None, mask=None, positive=None,
                             negative=None, seed=0, steps=1, cfg=1.0,
                             denoise=0.5)),
        (nb.ImageUpscaleWithModel, dict(upscale_model=None, image=None)),
        (nb.TPUTxt2Video, dict(model=None, positive=None, seed=0, frames=5,
                               steps=1, width=16, height=16)),
    ]
    for node, kw in cases:
        with pytest.raises(ValidationError, match="A.6b iii") as err:
            node().execute(mesh=two, **kw)
        assert err.value.field == "mesh"
    # a tp axis, refused until ROADMAP A.6b ii, builds now
    assert build_mesh({"dp": 1, "tp": 2}, 2,
                      torch.device("cpu")).shape == {"dp": 1, "tp": 2}
