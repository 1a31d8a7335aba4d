"""Rectified-flow pipeline on one device (counterpart of the JAX
``diffusion/pipeline_flow.py``'s ``FlowPipeline`` in its ``dp`` mode with
one participant).

noise → the spec's sampler over the shifted flow ladder with the velocity
denoiser ``x − σ·v`` (distilled guidance as a model input, no CFG batch)
→ VAE decode → clip to [0, 1]. As in the JAX pipeline the noise is not scaled
by the first sigma (it is 1). ``initial_noise`` is split from
``sample_and_decode`` so a caller can supply its own noise; a stochastic
sampler draws from ``parallel/rng.step_noise`` of the run's seed or the
caller's noise source. True CFG (``cfg != 1``, the SD3 family) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..models.dit import DiT
from ..models.vae import AutoencoderKL
from ..parallel.rng import seed_generator, step_noise
from .progress import wrap_denoiser
from .samplers import Denoiser, NoiseSource, sample
from .schedules import sigmas_flow


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    height: int = 1024
    width: int = 1024
    steps: int = 28
    shift: float = 3.0              # resolution-dependent sigma shift
    guidance: float = 3.5           # distilled guidance (FLUX-dev)
    cfg: float = 1.0                # true CFG scale; 1.0 = off
    sampler: str = "euler"
    per_device_batch: int = 1


class FlowPipeline:
    """DiT + VAE on the device that holds the DiT's weights.

    ``timings`` holds the last run's seconds for sampling and decoding
    (host clock around work ending in a device synchronise)."""

    def __init__(self, dit: DiT, vae: AutoencoderKL):
        self.dit = dit
        self.vae = vae
        self.timings: dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        return self.dit.img_in.weight.device

    def initial_noise(self, spec: FlowSpec,
                      generator: torch.Generator) -> torch.Tensor:
        """Unit normal latent noise [B, h, w, C] in fp32 on the device."""
        ds = self.vae.config.downscale
        shape = (spec.per_device_batch, spec.height // ds, spec.width // ds,
                 self.dit.config.in_channels)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    def _denoiser(self, context: torch.Tensor, pooled: torch.Tensor,
                  guidance: float) -> Denoiser:
        def denoise(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
            t = sigma.expand(x.shape[0])
            g = torch.full((x.shape[0],), guidance, device=x.device)
            return x - sigma * self.dit(x, t, context, pooled, g)

        return denoise

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def sample_and_decode(self, noise: torch.Tensor, spec: FlowSpec,
                          context: torch.Tensor, pooled: torch.Tensor,
                          progress_token: Optional[int] = None,
                          sampler_noise: Optional[NoiseSource] = None
                          ) -> torch.Tensor:
        """noise [B,h,w,C] → images [B,H,W,3] in [0, 1] (fp32).
        ``progress_token`` (a ``ProgressTracker.start`` token) streams
        each step's x0 to the progress sinks; ``sampler_noise`` is the
        stochastic samplers' noise source."""
        if spec.cfg != 1.0:
            raise NotImplementedError(
                f"true CFG (cfg={spec.cfg}) is not yet ported; FLUX-dev "
                "takes cfg=1.0 with the distilled 'guidance' input")
        dev = self.device
        sigmas = sigmas_flow(spec.steps, spec.shift).to(dev)
        batch = noise.shape[0]

        def rows(t):
            t = t.to(dev)
            return t.expand(batch, *t.shape[1:])

        denoise = self._denoiser(rows(context), rows(pooled), spec.guidance)
        if progress_token is not None:
            denoise = wrap_denoiser(denoise, progress_token)
        t0 = time.perf_counter()
        x0 = sample(spec.sampler, denoise, noise.to(dev), sigmas,
                    sampler_noise)
        self._sync()
        t1 = time.perf_counter()
        images = self.vae.decode(x0)
        images = torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)
        self._sync()
        self.timings = {"sample_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1,
                        "steps": len(sigmas) - 1}
        return images

    def generate(self, spec: FlowSpec, seed: int, context: torch.Tensor,
                 pooled: torch.Tensor,
                 progress_token: Optional[int] = None) -> torch.Tensor:
        noise = self.initial_noise(spec, seed_generator(seed, self.device))
        return self.sample_and_decode(noise, spec, context, pooled,
                                      progress_token,
                                      step_noise(seed, self.device))
