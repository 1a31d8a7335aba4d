"""Denoiser construction: eps-prediction parameterization and
classifier-free guidance (counterpart of the JAX ``diffusion/guidance.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .samplers import Denoiser
from .schedules import NoiseSchedule

# model(x, t, context, y) -> prediction
ModelFn = Callable[..., torch.Tensor]


def eps_denoiser(model_fn: ModelFn, schedule: NoiseSchedule,
                 context: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> Denoiser:
    """eps-pred VP model → x0 denoiser: D(x,σ) = x − σ·eps(x·c_in, t(σ))."""

    def denoise(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        t = schedule.timestep_for_sigma(sigma)
        eps = model_fn(x * c_in, t.expand(x.shape[0]), context, y)
        return x - sigma * eps

    return denoise


def cfg_denoiser(make_denoiser: Callable[[torch.Tensor, Optional[torch.Tensor]],
                                         Denoiser],
                 context: torch.Tensor, uncond_context: torch.Tensor,
                 guidance_scale: float, y: Optional[torch.Tensor] = None,
                 uncond_y: Optional[torch.Tensor] = None) -> Denoiser:
    """Classifier-free guidance with one doubled-batch model call: the
    batch is ``[cond, uncond]`` and the result ``uncond + s·(cond − uncond)``."""
    ctx2 = torch.cat([context, uncond_context], dim=0)
    y2 = None
    if y is not None:
        y2 = torch.cat([y, uncond_y if uncond_y is not None
                        else torch.zeros_like(y)], dim=0)
    inner = make_denoiser(ctx2, y2)

    def denoise(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        out = inner(torch.cat([x, x], dim=0), sigma)
        cond, uncond = out.chunk(2, dim=0)
        return uncond + guidance_scale * (cond - uncond)

    return denoise
