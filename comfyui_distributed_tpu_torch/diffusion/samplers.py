"""Samplers in sigma space (counterpart of the JAX ``diffusion/samplers.py``).

A sampler advances ``x`` down a sigma ladder with a denoiser
``denoise(x, sigma) -> x0_hat``. PyTorch runs eagerly, so a sampler is a
Python loop over the ladder. Only ``euler`` is ported so far.
"""

from __future__ import annotations

from typing import Callable

import torch

Denoiser = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _to_d(x: torch.Tensor, sigma: torch.Tensor,
          denoised: torch.Tensor) -> torch.Tensor:
    """x0 prediction → the k-diffusion ODE derivative."""
    return (x - denoised) / torch.clamp(sigma, min=1e-10)


def sample_euler(denoise: Denoiser, x: torch.Tensor,
                 sigmas: torch.Tensor) -> torch.Tensor:
    for i in range(sigmas.shape[0] - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        d = _to_d(x, sigma, denoise(x, sigma))
        x = x + d * (sigma_next - sigma)
    return x


SAMPLERS: dict[str, Callable] = {"euler": sample_euler}


def sample(name: str, denoise: Denoiser, x: torch.Tensor,
           sigmas: torch.Tensor) -> torch.Tensor:
    try:
        fn = SAMPLERS[name]
    except KeyError:
        raise NotImplementedError(
            f"sampler {name!r} is not yet ported; have {sorted(SAMPLERS)}") from None
    return fn(denoise, x, sigmas)
