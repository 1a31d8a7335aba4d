"""Text→image and image→image pipeline on one device (counterpart of the
JAX ``diffusion/pipeline.py``'s ``Txt2ImgPipeline``).

The JAX package runs the whole generation as one SPMD program over a
mesh; here one device runs it eagerly: noise → the spec's sampler over
its sigma ladder with a doubled-batch CFG denoiser → VAE decode → clip
to [0, 1]. The noise draw (``initial_noise``) is split from the rest
(``sample_and_decode``) so a caller can supply its own noise; a
stochastic sampler's draws come from a noise source
(``parallel/rng.step_noise`` of the run's seed, or the caller's).

``img2img`` encodes a source, noises it at the head of the partial
ladder (``spec.denoise``) and samples the tail; with a mask it inpaints
(``inpaint_denoiser``). ``with_control`` returns a clone that runs a
ControlNet (``models/controlnet.py``) beside the UNet on every model
call, fed a hint.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import torch

from ..models.layers import timestep_embedding
from ..models.unet import UNet2D
from ..models.vae import AutoencoderKL
from ..ops.resize import resize_to
from ..parallel.rng import seed_generator, step_noise
from .guidance import cfg_denoiser, eps_denoiser
from .progress import wrap_denoiser
from .samplers import Denoiser, NoiseSource, sample
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


def inpaint_denoiser(base: Denoiser, src: torch.Tensor, noise: torch.Tensor,
                     mask: torch.Tensor) -> Denoiser:
    """ComfyUI ``KSamplerX0Inpaint`` semantics (mask: 1 = regenerate):
    the sampler's input is recomposited with the source latent re-noised
    at the current sigma, using the run's own initial noise draw, and
    the denoised output is pinned to the source where the mask is 0. The
    input side keeps ancestral and SDE samplers on the source's
    trajectory at the mask's edge; pinning the output alone would only
    hide their drift where the mask is 0."""

    def denoise(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        x = x * mask + (src + noise * sigma) * (1.0 - mask)
        return base(x, sigma) * mask + src * (1.0 - mask)

    return denoise


class Txt2ImgPipeline:
    """UNet + VAE + schedule on the device that holds the UNet's weights.

    ``timings`` holds the last run's seconds for sampling and decoding
    (and, for ``img2img``, encoding): host clock around work ending in a
    device synchronise."""

    # (ControlNetBundle, strength) on a ``with_control`` clone
    _control: Optional[tuple] = None
    _CONTROL_CLONES = 4

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

    def _denoiser(self, context, y, hint: Optional[torch.Tensor] = None):
        """The eps denoiser. On a clone with a ControlNet and a ``hint``
        [b,H,W,C], the ControlNet runs before the UNet on every call and
        its residuals, scaled by the strength, go into the UNet's
        control hook. The hint is tiled to the model batch, so under
        CFG's doubled batch it conditions both passes; a batch it does
        not divide raises. Without a hint the UNet runs alone."""
        if self._control is None or hint is None:
            return eps_denoiser(self.unet, self.schedule, context, y)
        cn, strength = self._control
        hint = hint.float()

        def model_fn(x, t, ctx, y_):
            h = hint
            if h.shape[0] != x.shape[0]:
                if x.shape[0] % h.shape[0]:
                    raise ValueError(f"control hint batch {h.shape[0]} does "
                                     f"not divide model batch {x.shape[0]}")
                h = torch.cat([h] * (x.shape[0] // h.shape[0]))
            down, mid = cn.model(x, t, ctx, y_, h)
            return self.unet(x, t, ctx, y_, control=(
                [d * strength for d in down], mid * strength))

        return eps_denoiser(model_fn, self.schedule, context, y)

    def with_control(self, cn_bundle, strength: float = 1.0
                     ) -> "Txt2ImgPipeline":
        """A clone carrying a ControlNet at ``strength``; the pipeline
        itself is untouched. Clones are kept per (ControlNet uid,
        strength), at most 4, so a repeated node reuses its clone."""
        cache = self.__dict__.setdefault("_control_clones", {})
        key = (cn_bundle.uid, float(strength))
        clone = cache.get(key)
        if clone is None:
            if len(cache) >= self._CONTROL_CLONES:
                cache.pop(next(iter(cache)))
            clone = copy.copy(self)
            clone._control = (cn_bundle, float(strength))
            clone._control_clones = {}
            clone.timings = {}
            cache[key] = clone
        return clone

    def _require_hint(self, hint) -> None:
        if self._control is not None and hint is None:
            raise ValueError("pipeline carries a ControlNet but no hint "
                             "was given")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def sample_and_decode(self, noise: torch.Tensor, spec: GenerationSpec,
                          context: torch.Tensor, uncond_context: torch.Tensor,
                          y: Optional[torch.Tensor] = None,
                          uncond_y: Optional[torch.Tensor] = None,
                          progress_token: Optional[int] = None,
                          hint: Optional[torch.Tensor] = None,
                          init_latent: Optional[torch.Tensor] = None,
                          inpaint_mask: Optional[torch.Tensor] = None,
                          sampler_noise: Optional[NoiseSource] = None
                          ) -> torch.Tensor:
        """noise [B,h,w,C] → images [B,H,W,3] in [0, 1] (fp32).
        ``sampler_noise`` is the stochastic samplers' noise source
        (``samplers.sample``).
        ``progress_token`` (a ``ProgressTracker.start`` token) streams
        each step's x0 to the progress sinks. ``hint`` feeds a
        ``with_control`` clone's ControlNet. ``init_latent`` switches to
        img2img: the source latent is noised to the ladder's head
        instead of starting from noise alone; ``inpaint_mask``
        ([B,h,w,1], 1 = regenerate) then applies ``inpaint_denoiser``."""
        dev = self.device
        sigmas = make_sigma_ladder(spec, self.schedule).to(dev)
        batch = noise.shape[0]
        noise = noise.to(dev)

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
            denoise = cfg_denoiser(
                lambda c, yy: self._denoiser(c, yy, hint=hint), ctx, unc,
                spec.guidance_scale, y_b, uy_b)
        else:
            denoise = self._denoiser(ctx, y_b, hint=hint)
        if init_latent is None:
            x = noise * sigmas[0]
        else:
            x = init_latent + noise * sigmas[0]
            if inpaint_mask is not None:
                denoise = inpaint_denoiser(denoise, init_latent, noise,
                                           inpaint_mask)
        if progress_token is not None:
            denoise = wrap_denoiser(denoise, progress_token)
        t0 = time.perf_counter()
        x0 = sample(spec.sampler, denoise, x, sigmas, sampler_noise)
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
                 progress_token: Optional[int] = None,
                 hint: Optional[torch.Tensor] = None) -> torch.Tensor:
        self._require_hint(hint)
        noise = self.initial_noise(spec, seed_generator(seed, self.device))
        return self.sample_and_decode(
            noise, spec, context, uncond_context, y, uncond_y, progress_token,
            hint=hint, sampler_noise=step_noise(seed, self.device))

    @torch.no_grad()
    def img2img(self, spec: GenerationSpec, seed: int, images: torch.Tensor,
                context: torch.Tensor, uncond_context: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                uncond_y: Optional[torch.Tensor] = None,
                hint: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                sampler_noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """images [B,H,W,3] in [0, 1] → [B,H,W,3]: VAE encode, noise from
        ``seed`` (or ``noise`` [B,h,w,C] from the caller) at the head of
        the partial ladder, sample its tail (a stochastic sampler's draws
        from ``step_noise(seed)`` or ``sampler_noise``), decode. ``mask``
        [B,H,W,1] or [B,H,W] (1 = repaint) switches to inpainting: it is resized to
        the latent grid with ``jax.image.resize``'s bilinear weights
        (``ops/resize.py``, antialiased on this 8× shrink) for
        ``inpaint_denoiser``, and the decoded image is composited with
        the source at pixel level, so unmasked pixels are exactly the
        source."""
        self._require_hint(hint)
        dev = self.device
        images = images.to(dev).float()
        t0 = time.perf_counter()
        lat = self.vae.encode(images * 2.0 - 1.0)
        self._sync()
        encode_s = time.perf_counter() - t0
        m = None
        if mask is not None:
            mask = mask.to(dev).float()
            if mask.ndim == 3:
                mask = mask[..., None]
            mask = mask.expand(images.shape[0], *mask.shape[1:])
            m = resize_to(mask, lat.shape[1], lat.shape[2], "bilinear")
        if noise is None:
            noise = torch.randn(lat.shape, generator=seed_generator(seed, dev),
                                dtype=torch.float32, device=dev)
        if sampler_noise is None:
            sampler_noise = step_noise(seed, dev)
        out = self.sample_and_decode(noise, spec, context, uncond_context, y,
                                     uncond_y, hint=hint, init_latent=lat,
                                     inpaint_mask=m,
                                     sampler_noise=sampler_noise)
        if mask is not None:
            # the latent pinning keeps seams coherent, but the decoder's
            # mid attention bleeds repainted content everywhere: unmasked
            # pixels must be exactly the source
            out = images * (1.0 - mask) + out * mask
        self.timings["encode_s"] = encode_s
        return out
