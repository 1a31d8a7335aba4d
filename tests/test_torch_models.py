"""The port's tiny models against the JAX package's: UNet2D, the VAE
decoder (with AutoencoderKL's scaling) and the hash-tokenised text
encoder, with weights carried by ``models/from_jax.py``; fp32 at 2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's models need flax. Where it is missing (the card's
# machine), only the card tests of tests/test_torch_cuda.py run.
pytest.importorskip("flax")

from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu_torch.models import text as ttext  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed):
    """Every leaf plus numpy noise, so zero-initialised biases and unit
    norm scales are carried as real values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        tree)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port_unet_config(jcfg):
    fields = {f.name for f in dataclasses.fields(tunet.UNetConfig)}
    return tunet.UNetConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                               if k in fields})


def test_unet_configs_match_jax():
    for name in ("sdxl", "tiny"):
        jcfg = getattr(junet.UNetConfig, name)()
        assert _port_unet_config(jcfg) == getattr(tunet.UNetConfig, name)()
    assert dataclasses.asdict(tvae.VAEConfig.sdxl()) == {
        k: v for k, v in dataclasses.asdict(jvae.VAEConfig.sdxl()).items()
        if k in {f.name for f in dataclasses.fields(tvae.VAEConfig)}}
    jt = dataclasses.asdict(jtext.TextEncoderConfig())
    assert {k: jt[k] for k in dataclasses.asdict(ttext.TextEncoderConfig())} \
        == dataclasses.asdict(ttext.TextEncoderConfig())


def test_tiny_unet_matches_jax():
    jcfg = junet.UNetConfig.tiny(dtype="float32")
    model, params = junet.init_unet(jcfg, jax.random.key(0),
                                    sample_shape=(8, 8, 4), context_len=16)
    params = _perturbed(_np(params), 0)
    port = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         params).eval()
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 6, 4)
    t = np.array([10.0, 731.5], np.float32)
    ctx = _rand(rng, 2, 16, 32)
    y = _rand(rng, 2, 8)
    ref = np.asarray(model.apply(params, x, t, ctx, y))
    with torch.no_grad():
        out = port(*map(torch.from_numpy, (x, t, ctx, y)))
    assert out.shape == (2, 8, 6, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_unet_requires_adm_vector():
    port = tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32"))
    with pytest.raises(ValueError, match="adm_in_channels"):
        port(torch.zeros(1, 8, 8, 4), torch.zeros(1), torch.zeros(1, 4, 32))


def test_tiny_vae_decode_matches_jax():
    jcfg = dataclasses.replace(jvae.VAEConfig.tiny(dtype="float32"),
                               scaling_factor=0.5, shift_factor=0.1)
    ae = jvae.AutoencoderKL(jcfg).init(jax.random.key(1), image_hw=(16, 16))
    ae.dec_params = _perturbed(_np(ae.dec_params), 2)
    cfg = dataclasses.replace(tvae.VAEConfig.tiny(dtype="float32"),
                              scaling_factor=0.5, shift_factor=0.1)
    port = tvae.AutoencoderKL(cfg)
    load_from_jax(port.decoder, ae.dec_params)
    z = _rand(np.random.default_rng(3), 2, 8, 6, 4)
    ref = np.asarray(ae.decode(jnp.asarray(z)))
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z))
    assert out.shape == (2, 16, 12, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def _tiny_text_pair(seed=2):
    jcfg = dataclasses.replace(jtext.TextEncoderConfig.tiny(), dtype="float32")
    enc = jtext.TextEncoder(jcfg).init(jax.random.key(seed))
    enc.params = _perturbed(_np(enc.params), seed)
    module = ttext.TextTransformer(ttext.TextEncoderConfig.tiny(dtype="float32"))
    load_from_jax(module, enc.params)
    return enc, ttext.TextEncoder(module)


def test_tiny_text_encoder_matches_jax():
    enc, port = _tiny_text_pair()
    texts = ["a photo of a cat", "blurry, low quality",
             "one two three four five six seven eight nine ten eleven "
             "twelve thirteen fourteen fifteen sixteen seventeen", ""]
    ctx_ref, pooled_ref = enc.encode(texts)
    ctx, pooled = port.encode(texts)
    assert ctx.shape == (4, 16, 32) and pooled.shape == (4, 16)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_ref),
                               atol=TOL, rtol=TOL)


def test_hash_tokenizer_matches_jax():
    cfg = jtext.TextEncoderConfig()
    enc = jtext.TextEncoder(cfg)
    for text in ["A Cinematic photo of a lighthouse at dawn", "", "x " * 100]:
        ids = ttext.hash_tokenize(text, cfg.max_len, cfg.vocab_size)
        assert ids == list(np.asarray(enc.tokenize([text]))[0])
        assert len(ids) == cfg.max_len and 1 in ids


def test_text_encoder_fp32_sites_and_eot():
    """The output projections are fp32 compute sites, LayerNorm takes
    flax's epsilon and each prompt ends in the EOT id the pooled row is
    read at."""
    _, port = _tiny_text_pair()
    m = port.module
    assert m.ctx_proj.weight.dtype == torch.float32
    assert m.pool_proj.weight.dtype == torch.float32
    assert m.LayerNorm_0.eps == 1e-6
    tokens = port.tokenize(["a b", "c"])
    assert tokens.tolist()[0][2] == 1 and tokens.tolist()[1][1] == 1
