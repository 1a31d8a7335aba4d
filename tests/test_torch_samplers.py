"""The port's 14 samplers (``comfyui_distributed_tpu_torch.diffusion.samplers``)
against the JAX package's ``sample``.

Each runs on the same start latent and ladder, made with numpy from a
seed, (i) with an analytic denoiser and (ii) with the tiny UNet under CFG
(fp32, weights carried by ``from_jax``). The stochastic ones get JAX's own
draws through the port's noise source: draw ``j`` is
``normal(fold_in(key, j))``. Tolerance 2e-4 (module level; on the UNet,
2e-4 of the output's scale): the port computes each step's scalar
coefficients in float64 on the host, the JAX package in float32. Also:
the denoiser calls of a run against ``progress.total_calls``, the
unknown name, and the default noise source's keying.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's models need flax. Where it is missing (the card's
# machine), only the card tests of tests/test_torch_cuda.py run.
pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import progress as jprog  # noqa: E402
from comfyui_distributed_tpu.diffusion import samplers as jsamp  # noqa: E402
from comfyui_distributed_tpu.diffusion import schedules as jsched  # noqa: E402
from comfyui_distributed_tpu.diffusion.guidance import (  # noqa: E402
    cfg_denoiser as jcfg, eps_denoiser as jeps)
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import progress as tprog  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import samplers as tsamp  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import schedules as tsched  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion.guidance import (  # noqa: E402
    cfg_denoiser as tcfg, eps_denoiser as teps)
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.parallel import rng as trng  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
NAMES = sorted(jsamp.SAMPLERS)
SIGMAS = np.array([14.6, 7.0, 3.1, 1.2, 0.5, 0.1, 0.0], np.float32)


def jax_draws(key):
    """The port's noise source over JAX's draws: ``normal(fold_in(key, j))``."""
    def draw(j, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, j), tuple(shape), jnp.float32)))

    return draw


def _analytic(target):
    """D(x, σ) pulled toward a fixed target, depending on x and σ."""
    jt, tt = jnp.asarray(target), torch.from_numpy(target)

    def jden(x, s):
        return jt * 0.7 + x * 0.3 / (1 + s ** 2)

    def tden(x, s):
        return tt * 0.7 + x * 0.3 / (1 + s ** 2)

    return jden, tden


def test_the_port_has_every_jax_sampler():
    assert sorted(tsamp.SAMPLERS) == NAMES
    assert len(NAMES) == 14
    assert tsamp.STOCHASTIC <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_sampler_matches_jax_on_an_analytic_denoiser(name):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 4, 4, 3)).astype(np.float32) * SIGMAS[0]
    jden, tden = _analytic(rng.standard_normal((2, 4, 4, 3)).astype(np.float32))
    key = jax.random.key(3)
    ref = np.asarray(jsamp.sample(name, jden, jnp.asarray(x0),
                                  jnp.asarray(SIGMAS), key=key))
    out = tsamp.sample(name, tden, torch.from_numpy(x0),
                       torch.from_numpy(SIGMAS), noise=jax_draws(key))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_denoiser_calls_are_total_calls(name):
    """Every sampler calls the denoiser as often as the progress total
    says (second-order ones twice a step but the last), as the JAX
    package counts."""
    for steps in (1, 2, 6):
        sigmas = torch.from_numpy(np.linspace(10.0, 0.0, steps + 1,
                                              dtype=np.float32))
        calls = []

        def den(x, s):
            calls.append(float(s))
            return x * 0.5

        tsamp.sample(name, den, torch.ones(1, 2, 2, 1), sigmas,
                     noise=trng.step_noise(0, torch.device("cpu")))
        assert len(calls) == tprog.total_calls(name, steps) \
            == jprog.total_calls(name, steps)


def test_unknown_sampler_raises_value_error():
    with pytest.raises(ValueError, match="unknown sampler 'bogus'"):
        tsamp.sample("bogus", lambda x, s: x, torch.zeros(1), torch.ones(2))
    with pytest.raises(ValueError, match="unknown sampler"):
        jsamp.sample("bogus", lambda x, s: x, jnp.zeros(1), jnp.ones(2))


@pytest.mark.parametrize("name", sorted(tsamp.STOCHASTIC))
def test_stochastic_sampler_without_noise_raises(name):
    with pytest.raises(ValueError, match="noise source"):
        tsamp.sample(name, lambda x, s: x * 0.5, torch.ones(1),
                     torch.tensor([2.0, 1.0, 0.0]))


def test_ddim_without_noise_is_deterministic_as_in_jax():
    """``ddim`` with eta > 0 but no noise source runs deterministic, as
    the JAX one does without a key."""
    x = torch.ones(1, 2)
    sigmas = torch.tensor([3.0, 1.0, 0.0])
    den = lambda x, s: x * 0.25  # noqa: E731
    a = tsamp.sample("ddim", den, x, sigmas, eta=1.0)
    assert torch.equal(a, tsamp.sample("ddim", den, x, sigmas))


def test_step_noise_is_keyed_by_seed_and_draw_alone():
    cpu = torch.device("cpu")
    a, b = trng.step_noise(5, cpu), trng.step_noise(6, cpu)
    # draw 3 is the same whichever draws came before it
    first = a(3, (2, 3))
    a(0, (2, 3))
    assert torch.equal(a(3, (2, 3)), first)
    assert torch.equal(trng.step_noise(5, cpu)(3, (2, 3)), first)
    assert not torch.equal(a(4, (2, 3)), first)
    assert not torch.equal(b(3, (2, 3)), first)
    # unrelated to the seed's own generator (the initial noise)
    assert not torch.equal(torch.randn(2, 3, generator=trng.seed_generator(
        5, cpu)), first)
    stacked = trng.stacked_step_noise([5, 6], cpu)(3, (2, 2, 3))
    assert torch.equal(stacked[0], first) and torch.equal(stacked[1], b(3, (2, 3)))
    with pytest.raises(ValueError, match="2 rows"):
        trng.stacked_step_noise([5, 6], cpu)(3, (3, 2, 3))


def test_stochastic_samplers_depend_on_the_seed_only_through_the_source():
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((1, 4, 4, 3)).astype(np.float32))
    _, tden = _analytic(rng.standard_normal((1, 4, 4, 3)).astype(np.float32))
    sigmas = torch.from_numpy(SIGMAS)
    cpu = torch.device("cpu")
    for name in sorted(tsamp.STOCHASTIC):
        a, b, c = (tsamp.sample(name, tden, x0 * 14.6, sigmas,
                                noise=trng.step_noise(s, cpu))
                   for s in (1, 1, 2))
        assert torch.equal(a, b) and not torch.equal(a, c), name


# --- the tiny UNet under CFG --------------------------------------------------


@pytest.fixture(scope="module")
def unet_pair():
    cfg = junet.UNetConfig.tiny(dtype="float32")
    model, params = junet.init_unet(cfg, jax.random.key(0),
                                    sample_shape=(8, 8, 4), context_len=16)
    unet = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         jax.tree_util.tree_map(np.asarray, params)).eval()
    rng = np.random.default_rng(4)
    f32 = np.float32
    conds = dict(ctx=rng.standard_normal((1, 16, 32)).astype(f32),
                 unc=rng.standard_normal((1, 16, 32)).astype(f32),
                 y=rng.standard_normal((1, 8)).astype(f32),
                 uy=rng.standard_normal((1, 8)).astype(f32),
                 x=rng.standard_normal((1, 8, 8, 4)).astype(f32))
    return model, params, unet, conds


@pytest.mark.parametrize("name", NAMES)
def test_sampler_matches_jax_on_the_tiny_unet_with_cfg(unet_pair, name):
    model, params, unet, c = unet_pair
    js, ts = jsched.vp_schedule(), tsched.vp_schedule()
    sigmas = tsched.sigmas_karras(4, float(ts.sigmas[0]), float(ts.sigmas[-1]))
    key = jax.random.key(9)

    def jmodel(x, t, ctx, y):
        return model.apply(params, x, t, ctx, y)

    jden = jcfg(lambda ctx, y: jeps(jmodel, js, ctx, y),
                jnp.asarray(c["ctx"]), jnp.asarray(c["unc"]), 4.0,
                jnp.asarray(c["y"]), jnp.asarray(c["uy"]))
    x = c["x"] * float(sigmas[0])
    ref = np.asarray(jsamp.sample(name, jden, jnp.asarray(x),
                                  jnp.asarray(sigmas.numpy()), key=key))
    tden = tcfg(lambda ctx, y: teps(unet, ts, ctx, y),
                torch.from_numpy(c["ctx"]), torch.from_numpy(c["unc"]), 4.0,
                torch.from_numpy(c["y"]), torch.from_numpy(c["uy"]))
    with torch.no_grad():
        out = tsamp.sample(name, tden, torch.from_numpy(x), sigmas,
                           noise=jax_draws(key))
    assert np.isfinite(ref).all()
    # the latents reach |x| ~ 100 (CFG 4 on random weights): fp32
    # round-off of the two UNets is ~1e-5 of that, euler's included, so
    # the bound is 2e-4 of the output's scale
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL * scale, rtol=0)
