"""The port's ``sp`` program (one image's latent rows over the ranks,
joint ring attention in every block) on two CPU ranks over gloo, against
the JAX package's ``generate_sp`` on two of its eight virtual devices with
JAX's full noise handed over, and against the port's one-rank run:
flux-tiny with sincos and RoPE positions, sd3-tiny with true CFG and the
learned table; a stochastic sampler's draws; a one-rank mesh bitwise the
one-device run. Tolerance 2e-4 (fp32 tiny stacks). The ``dp`` programs:
``tests/test_torch_mesh_dp.py``."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline_flow as jflow  # noqa: E402
from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh as jbuild_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_flow as tflow  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.bootstrap import MeshRuntime  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh, use_mesh  # noqa: E402

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


# --- sp ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["sincos", "rope", "sd3-cfg"])
def test_sp_matches_jax_and_the_one_rank_run(mesh, conditioning, case):
    ctx, pooled, uctx, upooled = conditioning
    sd3 = case == "sd3-cfg"
    jp, tp = flow_pair({} if sd3 else {"pos_embed": case}, sd3=sd3)
    spec = dict(height=HW, width=HW, steps=2, shift=3.0,
                cfg=4.5 if sd3 else 1.0)
    unc = dict(uncond_context=uctx, uncond_pooled=upooled) if sd3 else {}
    seed = 5
    ref = np.asarray(jp.generate_sp(jmesh("sp"), jflow.FlowSpec(**spec), seed,
                                    ctx, pooled, **unc))
    # JAX's sp noise: the full latent from the seed's key, row-sliced
    noise = np.array(jax.random.normal(jax.random.key(seed), (1, 8, 8, 4),
                                       jnp.float32))
    out = mesh.runtime.run(
        "flow_sp", types.SimpleNamespace(pipeline=tp),
        tflow.FlowSpec(**spec), seed, _t(ctx), _t(pooled), _t(uctx if sd3 else None),
        _t(upooled if sd3 else None), noise=_t(noise), layout="sp")
    assert out.shape == ref.shape == (1, HW, HW, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    one = tp.sample_and_decode(_t(noise), tflow.FlowSpec(**spec), _t(ctx),
                               _t(pooled), **{k: _t(v) for k, v in unc.items()})
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=TOL, rtol=TOL)
    assert (out - tp.vae.decode(_t(noise)).div(2).add(0.5).clamp(0, 1)
            ).abs().max() > 1e-2       # the sampler moved the latent


def test_sp_stochastic_sampler_draws_the_one_rank_run_rows(mesh,
                                                            conditioning):
    """A stochastic sampler's draws are the full draw's rows on each rank,
    so an sp run is the one-rank run of the same seed."""
    ctx, pooled, _, _ = conditioning
    _, tp = flow_pair({"pos_embed": "rope"})
    spec = tflow.FlowSpec(height=HW, width=HW, steps=3,
                          sampler="euler_ancestral")
    out = mesh.runtime.run("flow_sp", types.SimpleNamespace(pipeline=tp),
                           spec, 9, _t(ctx), _t(pooled), layout="sp")
    one = tp.generate(spec, 9, _t(ctx), _t(pooled))
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=TOL, rtol=TOL)


def test_a_one_rank_mesh_is_bitwise_the_one_device_run(conditioning):
    ctx, pooled, _, _ = conditioning
    _, tp = flow_pair({"pos_embed": "rope"})
    spec = tflow.FlowSpec(height=HW, width=HW, steps=2)
    one = build_mesh({"dp": 1}, 1, torch.device("cpu"))
    assert one.size == 1 and one.runtime is None
    with use_mesh(one):
        got = tp.generate_mesh(spec, 4, _t(ctx), _t(pooled))
    assert torch.equal(got, tp.generate(spec, 4, _t(ctx), _t(pooled)))
    with use_mesh(build_mesh({"sp": 1}, 1, torch.device("cpu"))):
        sp = tp.generate_sp(spec, 4, _t(ctx), _t(pooled))
    np.testing.assert_allclose(sp.numpy(), got.numpy(), atol=1e-6, rtol=1e-6)
