"""The port's building blocks (``comfyui_distributed_tpu_torch.models.layers``)
against the JAX package's flax modules.

Each case initialises the flax module, perturbs every parameter with
numpy noise (so biases and norm scales are not at their trivial init),
carries the tree into the port module with ``models/from_jax.py`` and
compares the outputs on the same numpy inputs, in fp32 at 2e-4. The port's
convolution blocks take NCHW; the JAX ones NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's models need flax. Where it is missing (the card's
# machine), only the card tests of tests/test_torch_cuda.py run.
pytest.importorskip("flax")

from comfyui_distributed_tpu.models import layers as jl  # noqa: E402
from comfyui_distributed_tpu_torch.models import layers as tl  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402

TOL = 2e-4
F32 = torch.float32


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _pair(jmod, tmod, *inputs, seed=0):
    """(JAX output, port module with the same weights, jnp inputs)."""
    jin = [None if a is None else jnp.asarray(a) for a in inputs]
    params = _perturbed(jmod.init(jax.random.key(seed), *jin), seed)
    load_from_jax(tmod, params)
    return np.asarray(jmod.apply(params, *jin)), tmod.eval()


def _nhwc_to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nchw_to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dim", [32, 33, 256])
def test_timestep_embedding(dim):
    t = np.array([0.0, 1.5, 999.0], np.float32)
    ref = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
    out = tl.timestep_embedding(torch.from_numpy(t), dim)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("channels,eps", [(64, 1e-5), (16, 1e-6)])
def test_group_norm32(channels, eps):
    x = _rand(1, 2, 5, 6, channels) * 3.0 + 1.0
    ref, mod = _pair(jl.GroupNorm32(epsilon=eps),
                     tl.GroupNorm32(channels, epsilon=eps), x)
    out = _nchw_to_nhwc(mod(_nhwc_to_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("cin,cout", [(32, 64), (32, 32)])
def test_res_block(cin, cout):
    x, emb = _rand(2, 2, 6, 5, cin), _rand(3, 2, 48)
    ref, mod = _pair(jl.ResBlock(cout, dtype=jnp.float32),
                     tl.ResBlock(cin, cout, 48, F32), x, emb)
    out = _nchw_to_nhwc(mod(_nhwc_to_nchw(x), torch.from_numpy(emb)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("context_dim", [None, 24])
def test_attention(context_dim):
    x = _rand(4, 2, 20, 32)
    ctx = None if context_dim is None else _rand(5, 2, 11, context_dim)
    ref, mod = _pair(jl.Attention(2, 16, dtype=jnp.float32),
                     tl.Attention(32, 2, 16, F32, context_dim), x, ctx)
    out = mod(torch.from_numpy(x),
              None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=TOL)


def test_geglu():
    x = _rand(6, 2, 7, 32)
    ref, mod = _pair(jl.GEGLU(dtype=jnp.float32), tl.GEGLU(32, F32), x)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=TOL, rtol=TOL)


def test_transformer_block():
    x, ctx = _rand(7, 2, 12, 32), _rand(8, 2, 9, 24)
    ref, mod = _pair(jl.TransformerBlock(2, 16, dtype=jnp.float32),
                     tl.TransformerBlock(32, 2, 16, 24, F32), x, ctx)
    out = mod(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=TOL)


def test_spatial_transformer():
    x, ctx = _rand(9, 2, 4, 5, 32), _rand(10, 2, 9, 24)
    ref, mod = _pair(jl.SpatialTransformer(2, depth=2, dtype=jnp.float32),
                     tl.SpatialTransformer(32, 2, 2, 24, F32), x, ctx)
    out = _nchw_to_nhwc(mod(_nhwc_to_nchw(x), torch.from_numpy(ctx)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("jcls,tcls,hw", [
    (jl.Downsample, tl.Downsample, (8, 6)),
    (jl.Downsample, tl.Downsample, (7, 5)),    # odd sizes: padding edges
    (jl.Upsample, tl.Upsample, (4, 3)),
])
def test_resampling(jcls, tcls, hw):
    x = _rand(11, 2, *hw, 16)
    ref, mod = _pair(jcls(24, dtype=jnp.float32), tcls(16, 24, F32), x)
    out = _nchw_to_nhwc(mod(_nhwc_to_nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_layer_norm_epsilon_is_flax_default():
    """flax LayerNorm uses eps 1e-6 (torch's default is 1e-5)."""
    block = tl.TransformerBlock(32, 2, 16, 24, F32)
    assert {block.LayerNorm_0.eps, block.LayerNorm_1.eps,
            block.LayerNorm_2.eps} == {1e-6}


def test_flax_init_distributions():
    """Random init follows flax's defaults: lecun-normal kernels (std
    1/√fan_in), zero biases, unit norm scales; seeded."""
    def build(seed):
        mod = tl.SpatialTransformer(256, 4, 1, 128, F32)
        return tl.flax_init_(mod, torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    w = a.block_0.ff.proj_in.weight           # [2048, 256]
    assert abs(w.std().item() - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert w.abs().max().item() <= 2 * 256 ** -0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(a.block_0.ff.proj_in.bias) == 0
    assert torch.all(a.block_0.LayerNorm_0.weight == 1)
    assert torch.equal(w, b.block_0.ff.proj_in.weight)
    assert not torch.equal(w, c.block_0.ff.proj_in.weight)
