"""Text→video and image→video pipeline on one device (counterpart of the
JAX ``diffusion/pipeline_video.py``'s ``VideoPipeline`` in its ``dp``
mode with one participant).

noise → the spec's sampler over the shifted flow ladder with a
doubled-batch CFG denoiser against a zero context → VAE decode → clip to
[0, 1]. With the WAN 3D causal VAE (``models/wan_vae.py``) the
transformer runs on a 4× shorter latent frame axis and the decode runs
whole-clip, spatially tiled past ``constants.vae_tile_threshold``
exactly where the JAX pipeline tiles (its seams are part of the
output); with the image VAE (``wan-tiny``, ``video-mmdit``) each frame
decodes alone.

A dual-expert bundle (WAN 2.2: ``dit_low`` and ``expert_boundary``)
splits the ladder where the current sigma falls below the boundary: the
high-noise expert samples the head, the low-noise expert the tail from
the head's result, with a noise source of its own for stochastic
samplers (JAX folds 0x10E into the key). i2v conditions every model
call on the start image: ``i2v_condition`` encodes it followed by blank
frames and builds a mask that is 1 on the first latent frame, and the
model input is ``concat([x, mask, y])`` (``i2v_input_concat``).

``sample_and_decode`` takes the caller's noise, so tests can hand over
JAX's; ``generate``/``generate_i2v`` draw it from the seed. Each call
runs under a ``pipeline_call`` span, and the synchronised sampling time
per step lands in ``cdt_sampler_step_seconds``, read where the call
synchronises for its own timings. The offloaded and the ``sp``/``tp``
programs of the JAX pipeline are not ported (ROADMAP items A.5, A.6).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
from torch import nn

from ..models.video_dit import pad_frames_4n1
from ..parallel.rng import seed_generator, step_noise, step_seed
from ..utils import constants
from .pipeline import pipeline_call
from .progress import wrap_denoiser
from .samplers import Denoiser, NoiseSource, sample
from .schedules import sigmas_flow

LOW_EXPERT_FOLD = 0x10E      # the low segment's noise stream (JAX's fold)


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    frames: int = 17               # padded to 4n+1
    height: int = 480
    width: int = 832
    steps: int = 20
    shift: float = 3.0
    guidance_scale: float = 1.0    # true CFG (WAN's), not distilled
    sampler: str = "euler"

    @property
    def padded_frames(self) -> int:
        return pad_frames_4n1(self.frames)


def i2v_input_concat(y: torch.Tensor, mask: torch.Tensor
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The i2v model input ``concat([x, mask, y])`` over the channel
    axis, the conditioning broadcast over ``x``'s batch."""
    def inp_fn(x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:4]
        return torch.cat([x, mask.expand(*lead, mask.shape[-1]),
                          y.expand(*lead, y.shape[-1])], dim=-1)

    return inp_fn


class VideoPipeline:
    """The video transformer (``WanModel`` or ``VideoDiT``), an optional
    low-noise expert and the VAE on the transformer's device.

    ``timings`` holds the last run's seconds for sampling and decoding
    (and the start image's encode for i2v), each ending in a device
    synchronise, and the model calls of each expert."""

    def __init__(self, dit: nn.Module, vae: nn.Module,
                 dit_low: Optional[nn.Module] = None,
                 expert_boundary: Optional[float] = None):
        self.dit = dit
        self.dit_low = dit_low
        self.expert_boundary = expert_boundary
        self.vae = vae
        self.timings: dict = {}

    @property
    def device(self) -> torch.device:
        return next(self.dit.parameters()).device

    @property
    def is_moe(self) -> bool:
        return self.dit_low is not None and self.expert_boundary is not None

    def _expert_split(self, sigmas: torch.Tensor) -> int:
        """Leading steps the high-noise expert takes: those whose current
        sigma is at or above the boundary (flow sigmas are normalised
        timesteps)."""
        cur = sigmas[:-1].tolist()
        return sum(1 for s in cur if s >= self.expert_boundary)

    @property
    def temporal_downscale(self) -> int:
        return getattr(self.vae.config, "temporal_downscale", 1)

    def latent_frames(self, spec: VideoSpec) -> int:
        """The transformer's frame axis: the padded pixel frames compressed
        by the VAE's temporal factor (1 for the image VAE)."""
        return (spec.padded_frames - 1) // self.temporal_downscale + 1

    def latent_shape(self, spec: VideoSpec) -> tuple[int, int, int, int, int]:
        """[1, f, h, w, C] of the sampled latent (an i2v model's output
        channels: its input adds the conditioning's)."""
        cfg = self.dit.config
        ds = self.vae.config.downscale
        channels = getattr(cfg, "out_channels", cfg.in_channels)
        return (1, self.latent_frames(spec), spec.height // ds,
                spec.width // ds, channels)

    def initial_noise(self, spec: VideoSpec,
                      generator: torch.Generator) -> torch.Tensor:
        """Unit normal latent noise [1, f, h, w, C] in fp32 on the device."""
        return torch.randn(self.latent_shape(spec), generator=generator,
                           dtype=torch.float32, device=self.device)

    def decode_frames(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, f, h, w, c] → [B, F, H, W, 3] in [0, 1]: whole-clip through
        a 3D causal VAE (tiled past the threshold), frame by frame through
        the image VAE."""
        if self.temporal_downscale > 1:
            thresh = constants.vae_tile_threshold()
            if thresh and latents.shape[2] * latents.shape[3] > thresh:
                frames = self.vae.decode_tiled(
                    latents, tile=constants.vae_tile(),
                    overlap=constants.vae_tile_overlap())
            else:
                frames = self.vae.decode(latents)
            return torch.clamp(frames / 2.0 + 0.5, 0.0, 1.0)
        B, Fr = latents.shape[:2]
        frames = self.vae.decode(latents.reshape(B * Fr, *latents.shape[2:]))
        frames = torch.clamp(frames / 2.0 + 0.5, 0.0, 1.0)
        return frames.reshape(B, Fr, *frames.shape[1:])

    def _denoiser(self, model: nn.Module, context: torch.Tensor,
                  pooled: torch.Tensor, guidance_scale: float,
                  inp_fn: Optional[Callable] = None) -> Denoiser:
        """The velocity denoiser ``x − σ·v``; with CFG one doubled-batch
        call against a zero context and a zero pooled vector.
        ``inp_fn`` maps the latent to the model input (i2v's concat)."""
        calls = self.timings.setdefault("calls", {})
        name = "low" if model is self.dit_low else "high"

        def model_call(x, sigma, ctx, pl):
            calls[name] = calls.get(name, 0) + 1
            t = sigma.expand(x.shape[0])
            inp = x if inp_fn is None else inp_fn(x)
            return x - sigma * model(inp, t, ctx, pl)

        if guidance_scale == 1.0:
            return lambda x, s: model_call(x, s, context, pooled)
        ctx2 = torch.cat([context, torch.zeros_like(context)])
        pl2 = torch.cat([pooled, torch.zeros_like(pooled)])

        def denoise(x, sigma):
            out = model_call(torch.cat([x, x]), sigma, ctx2, pl2)
            cond, uncond = out.chunk(2)
            return uncond + guidance_scale * (cond - uncond)

        return denoise

    def _sample_expert(self, spec: VideoSpec, make_den, x: torch.Tensor,
                       sigmas: torch.Tensor, noise: Optional[NoiseSource],
                       noise_low: Optional[NoiseSource]) -> torch.Tensor:
        """The sampler over the ladder, switching experts at the split."""
        if not self.is_moe:
            return sample(spec.sampler, make_den(self.dit), x, sigmas, noise)
        split = self._expert_split(sigmas)
        steps = sigmas.shape[0] - 1
        if split <= 0:
            return sample(spec.sampler, make_den(self.dit_low), x, sigmas,
                          noise)
        if split >= steps:
            return sample(spec.sampler, make_den(self.dit), x, sigmas, noise)
        x_mid = sample(spec.sampler, make_den(self.dit), x,
                       sigmas[:split + 1], noise)
        return sample(spec.sampler, make_den(self.dit_low), x_mid,
                      sigmas[split:], noise_low)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def sample_and_decode(self, noise: torch.Tensor, spec: VideoSpec,
                          context: torch.Tensor, pooled: torch.Tensor,
                          progress_token: Optional[int] = None,
                          sampler_noise: Optional[NoiseSource] = None,
                          sampler_noise_low: Optional[NoiseSource] = None,
                          cond: Optional[tuple] = None) -> torch.Tensor:
        """noise [1, f, h, w, C] → videos [1, F, H, W, 3] in [0, 1] (fp32).
        ``cond`` is i2v's ``(y, mask)``; ``progress_token`` streams each
        model call's x0; the noise sources feed stochastic samplers (the
        high segment's, the low segment's)."""
        dev = self.device
        sigmas = sigmas_flow(spec.steps, spec.shift).to(dev)
        inp_fn = None if cond is None else i2v_input_concat(*cond)
        context, pooled = context.to(dev), pooled.to(dev)
        timings = {"calls": {}}
        self.timings = timings

        def make_den(model):
            den = self._denoiser(model, context, pooled, spec.guidance_scale,
                                 inp_fn)
            if progress_token is not None:
                den = wrap_denoiser(den, progress_token)
            return den

        label = "video_dp" if cond is None else "video_i2v"
        with pipeline_call(self, label, lambda: self.timings):
            t0 = time.perf_counter()
            x0 = self._sample_expert(spec, make_den, noise.to(dev), sigmas,
                                     sampler_noise, sampler_noise_low)
            self._sync()
            t1 = time.perf_counter()
            videos = self.decode_frames(x0)
            self._sync()
            timings.update(sample_s=t1 - t0,
                           decode_s=time.perf_counter() - t1,
                           steps=len(sigmas) - 1)
        return videos

    def _noise_sources(self, seed: int) -> tuple[NoiseSource, NoiseSource]:
        return (step_noise(seed, self.device),
                step_noise(step_seed(seed, LOW_EXPERT_FOLD), self.device))

    def generate(self, spec: VideoSpec, seed: int, context: torch.Tensor,
                 pooled: torch.Tensor,
                 progress_token: Optional[int] = None) -> torch.Tensor:
        """One t2v video of ``seed``: [1, F, H, W, 3]."""
        noise = self.initial_noise(spec, seed_generator(seed, self.device))
        return self.sample_and_decode(noise, spec, context, pooled,
                                      progress_token,
                                      *self._noise_sources(seed))

    @torch.no_grad()
    def i2v_condition(self, image: torch.Tensor, spec: VideoSpec
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """``image`` [B, H, W, 3] in [0, 1] → ``y``, the causal VAE
        encoding of the image followed by blank frames, and ``mask``, one
        channel per compressed pixel frame: 1 on the first latent frame
        (the published polarity: content given), 0 elsewhere."""
        B, H, W, C = image.shape
        image = image.to(self.device, torch.float32)
        vid = torch.cat([image[:, None] * 2.0 - 1.0,
                         image.new_zeros((B, spec.padded_frames - 1, H, W, C))],
                        dim=1)
        y = self.vae.encode(vid)
        td = max(self.temporal_downscale, 1)
        mask = y.new_zeros(y.shape[:4] + (td,))
        mask[:, 0] = 1.0
        return y, mask

    def generate_i2v(self, spec: VideoSpec, seed: int, image: torch.Tensor,
                     context: torch.Tensor, pooled: torch.Tensor,
                     progress_token: Optional[int] = None) -> torch.Tensor:
        """One i2v video of ``seed`` from the start image [1, H, W, 3]."""
        t0 = time.perf_counter()
        cond = self.i2v_condition(image, spec)
        self._sync()
        encode_s = time.perf_counter() - t0
        noise = self.initial_noise(spec, seed_generator(seed, self.device))
        videos = self.sample_and_decode(noise, spec, context, pooled,
                                        progress_token,
                                        *self._noise_sources(seed), cond=cond)
        self.timings["encode_s"] = encode_s
        return videos
