"""The port's resize against ``jax.image.resize`` (the JAX package's
``ops/resize.py``): every kernel up and down at odd sizes within 2e-5,
the ComfyUI aliases, and the identity at scale 1, which skips every axis
and is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops import resize as jresize
from comfyui_distributed_tpu_torch.ops import resize as tresize
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

RESIZE_TOL = 2e-5


def _image(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


METHODS = ["bilinear", "cubic", "lanczos3", "lanczos5", "nearest"]
ALIASES = {"bicubic": "cubic", "lanczos": "lanczos3", "linear": "bilinear",
           "area": "bilinear", "nearest-exact": "nearest",
           "nearest_exact": "nearest"}


@pytest.mark.parametrize("size", [(26, 34), (7, 9), (13, 31), (40, 5)],
                         ids=["up", "down", "one-axis", "mixed"])
@pytest.mark.parametrize("method", METHODS)
def test_resize_to_matches_jax(method, size):
    img = _image(0, 2, 13, 17, 3)
    ref = np.asarray(jresize.resize_to(jnp.asarray(img), *size, method))
    out = tresize.resize_to(torch.from_numpy(img), *size, method)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("scale", [2.0, 0.5, 1.5])
@pytest.mark.parametrize("method", ["lanczos3", "bilinear", "nearest"])
def test_upscale_image_matches_jax(method, scale):
    img = _image(1, 1, 11, 15, 3)
    ref = np.asarray(jresize.upscale_image(jnp.asarray(img), scale, method))
    out = tresize.upscale_image(torch.from_numpy(img), scale, method).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("method", ["lanczos3", "lanczos5", "cubic",
                                    "bilinear", "nearest"])
def test_resize_identity_at_scale_one_is_exact(method):
    img = _image(2, 1, 9, 12, 3)
    out = tresize.upscale_image(torch.from_numpy(img), 1.0, method).numpy()
    ref = np.asarray(jresize.upscale_image(jnp.asarray(img), 1.0, method))
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_resize_aliases_match_jax(alias):
    assert tresize.normalize_method(alias) == jresize.normalize_method(alias) \
        == ALIASES[alias]
    img = _image(3, 1, 7, 6, 3)
    np.testing.assert_array_equal(
        tresize.resize_to(torch.from_numpy(img), 9, 4, alias).numpy(),
        tresize.resize_to(torch.from_numpy(img), 9, 4, ALIASES[alias]).numpy())


def test_resize_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown resize method"):
        tresize.upscale_image(torch.zeros(1, 4, 4, 3), 2.0, "magic")
