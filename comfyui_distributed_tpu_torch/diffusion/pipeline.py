"""Text→image pipeline on one device (counterpart of the JAX
``diffusion/pipeline.py``'s ``Txt2ImgPipeline.generate``).

The JAX package runs the whole generation as one SPMD program over a
mesh; here one device runs it eagerly: noise → euler over the karras
ladder with a doubled-batch CFG denoiser → VAE decode → clip to [0, 1].
The noise draw (``initial_noise``) is split from the rest
(``sample_and_decode``) so a caller can supply its own noise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..models.layers import timestep_embedding
from ..models.unet import UNet2D
from ..models.vae import AutoencoderKL
from ..parallel.rng import seed_generator
from .guidance import cfg_denoiser, eps_denoiser
from .progress import wrap_denoiser
from .samplers import sample
from .schedules import (NoiseSchedule, sigmas_beta, sigmas_exponential,
                        sigmas_karras, sigmas_linear_quadratic, sigmas_normal,
                        sigmas_sgm_uniform, vp_schedule)


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    height: int = 1024
    width: int = 1024
    steps: int = 30
    sampler: str = "euler"
    scheduler: str = "karras"
    guidance_scale: float = 5.0
    per_device_batch: int = 1
    denoise: float = 1.0


def make_sigma_ladder(spec: GenerationSpec,
                      schedule: NoiseSchedule) -> torch.Tensor:
    n = max(1, round(spec.steps * spec.denoise))
    smin, smax = float(schedule.sigmas[0]), float(schedule.sigmas[-1])
    if spec.scheduler == "karras":
        full = sigmas_karras(spec.steps, smin, smax)
    elif spec.scheduler == "normal":
        full = sigmas_normal(spec.steps, schedule)
    elif spec.scheduler == "exponential":
        full = sigmas_exponential(spec.steps, smin, smax)
    elif spec.scheduler == "sgm_uniform":
        full = sigmas_sgm_uniform(spec.steps, schedule)
    elif spec.scheduler == "beta":
        full = sigmas_beta(spec.steps, schedule)
    elif spec.scheduler == "linear_quadratic":
        full = sigmas_linear_quadratic(spec.steps, sigma_max=smax)
    else:
        raise ValueError(f"unknown scheduler {spec.scheduler!r}")
    # partial denoise keeps the tail of the ladder (img2img convention)
    return full[-(n + 1):]


def sdxl_adm(pooled: torch.Tensor, orig_size: tuple[int, int],
             crop: tuple[int, int] = (0, 0),
             target_size: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """SDXL micro-conditioning vector: pooled text ⊕ 6×256-dim Fourier
    embeddings of (orig_h, orig_w, crop_top, crop_left, tgt_h, tgt_w)."""
    target_size = target_size or orig_size
    vals = [*orig_size, *crop, *target_size]
    B = pooled.shape[0]
    embs = [timestep_embedding(torch.full((B,), float(v), device=pooled.device),
                               256) for v in vals]
    return torch.cat([pooled.float()] + embs, dim=-1)


class Txt2ImgPipeline:
    """UNet + VAE + schedule on the device that holds the UNet's weights.

    ``timings`` holds the last run's seconds for sampling and decoding
    (host clock around work ending in a device synchronise)."""

    def __init__(self, unet: UNet2D, vae: AutoencoderKL,
                 schedule: Optional[NoiseSchedule] = None):
        self.unet = unet
        self.vae = vae
        self.schedule = schedule or vp_schedule()
        self.timings: dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def latent_channels(self) -> int:
        return self.unet.config.in_channels

    def initial_noise(self, spec: GenerationSpec,
                      generator: torch.Generator) -> torch.Tensor:
        """Unit normal latent noise [B, h, w, C] in fp32 on the device."""
        ds = self.vae.config.downscale
        shape = (spec.per_device_batch, spec.height // ds, spec.width // ds,
                 self.latent_channels)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    def _denoiser(self, context, y):
        return eps_denoiser(self.unet, self.schedule, context, y)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def sample_and_decode(self, noise: torch.Tensor, spec: GenerationSpec,
                          context: torch.Tensor, uncond_context: torch.Tensor,
                          y: Optional[torch.Tensor] = None,
                          uncond_y: Optional[torch.Tensor] = None,
                          progress_token: Optional[int] = None
                          ) -> torch.Tensor:
        """noise [B,h,w,C] → images [B,H,W,3] in [0, 1] (fp32).
        ``progress_token`` (a ``ProgressTracker.start`` token) streams
        each step's x0 to the progress sinks."""
        dev = self.device
        sigmas = make_sigma_ladder(spec, self.schedule).to(dev)
        batch = noise.shape[0]

        def rows(t):
            t = t.to(dev)
            return t.expand(batch, *t.shape[1:])

        ctx, unc = rows(context), rows(uncond_context)
        y_b = uy_b = None
        if self.unet.config.adm_in_channels:
            zeros = torch.zeros((1, self.unet.config.adm_in_channels))
            y_b = rows(zeros if y is None else y)
            uy_b = rows(zeros if uncond_y is None else uncond_y)
        if spec.guidance_scale != 1.0:
            denoise = cfg_denoiser(self._denoiser, ctx, unc,
                                   spec.guidance_scale, y_b, uy_b)
        else:
            denoise = self._denoiser(ctx, y_b)
        if progress_token is not None:
            denoise = wrap_denoiser(denoise, progress_token)
        t0 = time.perf_counter()
        x0 = sample(spec.sampler, denoise, noise.to(dev) * sigmas[0], sigmas)
        self._sync()
        t1 = time.perf_counter()
        images = self.vae.decode(x0)
        images = torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)
        self._sync()
        self.timings = {"sample_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1,
                        "steps": len(sigmas) - 1}
        return images

    def generate(self, spec: GenerationSpec, seed: int,
                 context: torch.Tensor, uncond_context: torch.Tensor,
                 y: Optional[torch.Tensor] = None,
                 uncond_y: Optional[torch.Tensor] = None,
                 progress_token: Optional[int] = None) -> torch.Tensor:
        noise = self.initial_noise(spec, seed_generator(seed, self.device))
        return self.sample_and_decode(noise, spec, context, uncond_context,
                                      y, uncond_y, progress_token)
