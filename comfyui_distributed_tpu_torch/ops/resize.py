"""Image resize with ``jax.image.resize``'s numbers (counterpart of the JAX
``ops/resize.py``; PyTorch has no resize with the same kernels).

``bilinear``, ``cubic`` (Keys, a = −0.5), ``lanczos3`` and ``lanczos5``
are ``jax.image.scale_and_translate`` with ``antialias=True``: per axis a
weight matrix built on the host with numpy in float32 (the kernel at
half-pixel centres, widened by 1/scale when shrinking, each output's
weights normalised to sum 1, outputs whose centre falls outside the
input zeroed), applied on the device as a product per axis. An axis
whose size does not change is skipped, so a resize to the same shape is
the identity before the clip. ``nearest`` gathers at
floor((i + ½)·in/out), as ``jax.image`` does.
"""

from __future__ import annotations

import numpy as np
import torch

_METHODS = {"bilinear", "lanczos3", "lanczos5", "nearest", "cubic"}
# ComfyUI workflow vocabulary → kernels
_ALIASES = {
    "nearest-exact": "nearest",
    "nearest_exact": "nearest",
    "bicubic": "cubic",
    "lanczos": "lanczos3",
    "linear": "bilinear",
    "area": "bilinear",    # closest kernel; area is downscale-only
}


def normalize_method(method: str) -> str:
    """Accept both kernel names and ComfyUI workflow values."""
    m = _ALIASES.get(method, method)
    if m not in _METHODS:
        raise ValueError(
            f"unknown resize method {method!r}; have "
            f"{sorted(_METHODS | set(_ALIASES))}")
    return m


def _lanczos(radius: int):
    def kernel(x: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            y = (np.float32(radius) * np.sin(np.float32(np.pi) * x)
                 * np.sin(np.float32(np.pi) * x / np.float32(radius)))
            out = np.where(x > 1e-3,
                           y / np.where(x != 0, np.float32(np.pi ** 2) * x * x,
                                        np.float32(1)),
                           np.float32(1))
        return np.where(x > radius, np.float32(0), out).astype(np.float32)
    return kernel


def _cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


_KERNELS = {"bilinear": _triangle, "cubic": _cubic,
            "lanczos3": _lanczos(3), "lanczos5": _lanczos(5)}


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[in_size, out_size] float32 weights of one axis (jax's
    ``compute_weight_mat`` with translation 0 and antialiasing)."""
    kernel = _KERNELS[method]
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0) - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale)
    weights = kernel(x.astype(np.float32))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1)),
                       np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size) - 0.5)
    return np.where(inside[None, :], weights, np.float32(0)).astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    offsets = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
               * np.float32(in_size) / np.float32(out_size))
    return np.floor(offsets).astype(np.int64)


def resize_to(images: torch.Tensor, height: int, width: int,
              method: str = "lanczos3") -> torch.Tensor:
    """Resize [B,H,W,C] to exactly (height, width): fp32 out, clipped to
    [0, 1] except for ``nearest``."""
    m = normalize_method(method)
    x = images.float()
    _, H, W, _ = x.shape
    height, width = int(height), int(width)
    if m == "nearest":
        if height != H:
            x = x[:, torch.from_numpy(_nearest_index(H, height)).to(x.device)]
        if width != W:
            x = x[:, :, torch.from_numpy(_nearest_index(W, width)).to(x.device)]
        return x
    if height != H:
        w = torch.from_numpy(weight_matrix(H, height, m)).to(x.device)
        x = torch.einsum("bhwc,ho->bowc", x, w)
    if width != W:
        w = torch.from_numpy(weight_matrix(W, width, m)).to(x.device)
        x = torch.einsum("bhwc,wo->bhoc", x, w)
    return torch.clamp(x, 0.0, 1.0)


def upscale_image(images: torch.Tensor, scale: float,
                  method: str = "lanczos3") -> torch.Tensor:
    """Resize [B,H,W,C] by ``scale`` (sizes rounded to ints)."""
    _, H, W, _ = images.shape
    return resize_to(images, int(round(H * scale)), int(round(W * scale)),
                     method)
