"""The weight carry (``comfyui_distributed_tpu_torch.models.from_jax``):
every leaf of the JAX trees lands on exactly one port parameter of the
right shape — for the tiny presets, for the full SDXL UNet, VAE decoder
and text encoder and for the full FLUX DiT, whose trees are built
abstractly (shapes only) and whose port modules live on the meta
device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's models need flax. Where it is missing (the card's
# machine), only the card tests of tests/test_torch_cuda.py run.
pytest.importorskip("flax")

from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import text as ttext  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import (CarryError,  # noqa: E402
                                                           carry_plan,
                                                           load_from_jax)
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)


def _jax_trees(name):
    """(unet, vae decoder, text encoder) parameter trees of a preset as
    ShapeDtypeStructs."""
    ucfg = getattr(junet.UNetConfig, name)()
    vcfg = getattr(jvae.VAEConfig, name)()
    tcfg = jtext.TextEncoderConfig() if name == "sdxl" else jtext.TextEncoderConfig.tiny()
    key = jax.random.key(0)
    _, unet = junet.init_unet(ucfg, key, sample_shape=(8, 8, 4),
                              context_len=tcfg.max_len, abstract=True)
    dec = jvae.AutoencoderKL(vcfg).decoder
    vae = jax.eval_shape(dec.init, key, jnp.zeros((1, 8, 8, vcfg.latent_channels)))
    text = jax.eval_shape(jtext.TextEncoder(tcfg).module.init, key,
                          jnp.zeros((1, tcfg.max_len), jnp.int32))
    return unet, vae, text


def _port_modules(name):
    with torch.device("meta"):
        tcfg = ttext.TextEncoderConfig() if name == "sdxl" else ttext.TextEncoderConfig.tiny()
        return (tunet.UNet2D(getattr(tunet.UNetConfig, name)()),
                tvae.AutoencoderKL(getattr(tvae.VAEConfig, name)()).decoder,
                ttext.TextTransformer(tcfg))


def _n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name", ["tiny", "sdxl"])
def test_carry_covers_every_leaf(name):
    for tree, module in zip(_jax_trees(name), _port_modules(name)):
        plan = carry_plan(tree, module)
        params = dict(module.named_parameters())
        assert len(plan) == _n_leaves(tree) == len(params)
        n_jax = sum(int(np.prod(leaf.shape))
                    for leaf in jax.tree_util.tree_leaves(tree))
        assert n_jax == sum(p.numel() for p in params.values())


@pytest.mark.parametrize("name", ["tiny", "flux"])
def test_dit_carry_covers_every_leaf(name):
    """The DiT tree, built abstractly for ``flux`` (11.9 B parameters),
    against the port's DiT on the meta device: dense kernels transposed,
    fp32 qk-norm scales carried by name, the parameter-free LayerNorms
    absent on both sides."""
    jcfg = getattr(jdit.DiTConfig, name)()
    _, tree = jdit.init_dit(jcfg, jax.random.key(0), sample_hw=(8, 8),
                            context_len=16, abstract=True)
    with torch.device("meta"):
        module = tdit.DiT(getattr(tdit.DiTConfig, name)())
    plan = carry_plan(tree, module)
    params = dict(module.named_parameters())
    assert len(plan) == _n_leaves(tree) == len(params)
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))
    assert n_jax == sum(p.numel() for p in params.values())
    assert plan["double_0.img_mod.mod.weight"] == (
        ("double_0", "img_mod", "mod", "kernel"), "t")
    assert plan["single_0.qkv.q_scale"] == (("single_0", "qkv", "q_scale"), "")
    assert params["single_0.qkv.q_scale"].dtype == torch.float32
    assert params["img_out.weight"].dtype == torch.float32
    if name == "flux":
        assert 11.8e9 < n_jax < 12.0e9
        assert params["double_0.img_qkv.qkv.weight"].dtype == torch.bfloat16


def test_sdxl_unet_size():
    unet = _port_modules("sdxl")[0]
    n = sum(p.numel() for p in unet.parameters())
    assert 2.5e9 < n < 2.7e9
    attn1 = [m for name, m in unet.named_modules() if name.endswith("attn1")]
    attn2 = [m for name, m in unet.named_modules() if name.endswith("attn2")]
    assert len(attn1) == len(attn2) == 70


def _small_tree():
    rng = np.random.default_rng(0)
    return {"params": {
        "to_q": {"kernel": rng.standard_normal((8, 6)).astype(np.float32)},
        "conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                 "bias": rng.standard_normal(4).astype(np.float32)},
        "norm": {"scale": rng.standard_normal(4).astype(np.float32),
                 "bias": rng.standard_normal(4).astype(np.float32)},
    }}


class _Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.to_q = torch.nn.Linear(8, 6, bias=False)
        self.conv = torch.nn.Conv2d(2, 4, 3)
        self.norm = torch.nn.GroupNorm(2, 4)


def test_layout_rules():
    tree = _small_tree()
    m = load_from_jax(_Small(), tree)
    p = tree["params"]
    np.testing.assert_array_equal(m.to_q.weight.detach().numpy(), p["to_q"]["kernel"].T)
    np.testing.assert_array_equal(m.conv.weight.detach().numpy(),
                                  p["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(m.norm.weight.detach().numpy(), p["norm"]["scale"])
    np.testing.assert_array_equal(m.norm.bias.detach().numpy(), p["norm"]["bias"])


def test_unconsumed_leaf_raises():
    tree = _small_tree()
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(CarryError, match="does not consume.*extra"):
        load_from_jax(_Small(), tree)


def test_unset_parameter_raises():
    tree = _small_tree()
    del tree["params"]["norm"]
    with pytest.raises(CarryError, match="does not set.*norm"):
        load_from_jax(_Small(), tree)


def test_shape_mismatch_raises():
    tree = _small_tree()
    tree["params"]["to_q"]["kernel"] = np.zeros((6, 8), np.float32)
    with pytest.raises(CarryError, match="to_q"):
        load_from_jax(_Small(), tree)


def test_bundle_carries_jax_tiny_weights():
    """``ModelBundle.load_from_jax`` fills the three models of a bundle
    and leaves each in its preset dtype."""
    from comfyui_distributed_tpu_torch.models.registry import PRESETS, ModelBundle

    preset = dataclasses.replace(
        PRESETS["tiny"], unet=tunet.UNetConfig.tiny(dtype="float32"),
        vae=tvae.VAEConfig.tiny(dtype="float32"))
    bundle = ModelBundle(preset, device="cpu", seed=3)
    key = jax.random.key(5)
    _, unet = junet.init_unet(junet.UNetConfig.tiny(dtype="float32"), key,
                              sample_shape=(8, 8, 4), context_len=16)
    dec = jax.jit(jvae.AutoencoderKL(jvae.VAEConfig.tiny()).decoder.init)(
        key, jnp.zeros((1, 8, 8, 4)))
    text = jtext.TextEncoder(jtext.TextEncoderConfig.tiny()).init(key).params
    bundle.load_from_jax(*(jax.tree_util.tree_map(np.asarray, t)
                           for t in (unet, dec, text)))
    conv = np.asarray(unet["params"]["conv_in"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(
        bundle.pipeline.unet.conv_in.weight.numpy(), conv)
    assert bundle.text_encoder.module.tok_emb.weight.dtype == torch.bfloat16


def test_bundle_carries_jax_flux_tiny_weights():
    """``ModelBundle.load_from_jax`` fills a flow bundle's DiT by path."""
    from comfyui_distributed_tpu_torch.models.registry import PRESETS, ModelBundle

    bundle = ModelBundle(PRESETS["flux-tiny"], device="cpu", seed=3)
    key = jax.random.key(6)
    _, dit = jdit.init_dit(jdit.DiTConfig.tiny(), key, sample_hw=(8, 8),
                           context_len=16)
    dec = jax.jit(jvae.AutoencoderKL(jvae.VAEConfig.tiny()).decoder.init)(
        key, jnp.zeros((1, 8, 8, 4)))
    text = jtext.TextEncoder(jtext.TextEncoderConfig.tiny()).init(key).params
    bundle.load_from_jax(*(jax.tree_util.tree_map(np.asarray, t)
                           for t in (dit, dec, text)))
    port = bundle.pipeline.dit
    ref = np.array(dit["params"]["single_1"]["qkv"]["qkv"]["kernel"]).T
    np.testing.assert_array_equal(
        port.single_1.qkv.qkv.weight.float().numpy(),
        torch.from_numpy(ref).to(torch.bfloat16).float().numpy())
    # flax's zero init carried as it is
    assert not port.final_mod.mod.weight.any() and not port.img_out.weight.any()
    assert port.img_out.weight.dtype == torch.float32
