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
synchronises for its own timings. The ``sp``/``tp`` programs of the JAX
pipeline are not ported (ROADMAP item A.6b iii).

``generate_offloaded``/``generate_offloaded_i2v`` run one video through
``OffloadedWan`` executors (``diffusion/offload.py``), one expert's store
on the card at a time: a dual-expert run samples the high segment,
synchronises, honours an interrupt, releases the high store and builds
(or fetches) the low one. The noise and both segments' draws are the
``dp`` run's of the seed.
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
from .offload import ExecutorCache, i2v_input_concat
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
        # offload: where each expert's blocks come from (an offload
        # bundle sets its drawn blocks), the card its executors run on
        # (default: the transformer's), and the executors by expert
        self.offload_sources: dict = {}
        self.offload_device: Optional[torch.device] = None
        self._offload = ExecutorCache()

    @property
    def device(self) -> torch.device:
        return self.offload_device or next(self.dit.parameters()).device

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

    def _sync(self, device: Optional[torch.device] = None) -> None:
        device = device or self.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

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

    # --- offload (diffusion/offload.py) ---------------------------------------

    def offload_executor(self, which: str = "high",
                         resident_bytes: Optional[int] = None,
                         stream_dtype: Optional[str] = None):
        """Build or fetch expert ``which``'s ``OffloadedWan`` (``"high"``:
        ``dit``, ``"low"``: ``dit_low``), cached by (resident bytes, stream
        dtype, block source); a build under another key releases that
        expert's previous store first."""
        from .offload import ModuleBlocks, OffloadedWan, normalize_stream_dtype

        model = self.dit if which == "high" else self.dit_low
        if model is None:
            raise ValueError(f"no weights for expert {which!r}")
        if not hasattr(model.config, "num_layers"):
            raise ValueError(
                f"offload runs WAN transformers; {type(model).__name__} has "
                "no offload executor")
        sd = normalize_stream_dtype(stream_dtype)
        source = self.offload_sources.get(which) or ModuleBlocks(model)
        return self._offload.get(
            which, (resident_bytes, sd, id(source)),
            lambda: OffloadedWan(model, source, resident_bytes=resident_bytes,
                                 device=self.offload_device, stream_dtype=sd))

    def release_offload(self) -> None:
        self._offload.release()

    def offload_stores(self) -> list:
        return self._offload.stores()

    @torch.no_grad()
    def generate_offloaded(self, spec: VideoSpec, seed: int,
                           context: torch.Tensor,
                           resident_bytes: Optional[int] = None,
                           stream_dtype: Optional[str] = None,
                           progress_token: Optional[int] = None,
                           should_stop=None,
                           noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """One t2v video [1, F, H, W, 3] through the offload executors."""
        return self._offloaded_sample(spec, seed, context, None,
                                      resident_bytes, stream_dtype,
                                      progress_token, should_stop, noise)

    @torch.no_grad()
    def generate_offloaded_i2v(self, spec: VideoSpec, seed: int,
                               image: torch.Tensor, context: torch.Tensor,
                               resident_bytes: Optional[int] = None,
                               stream_dtype: Optional[str] = None,
                               progress_token: Optional[int] = None,
                               should_stop=None,
                               noise: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """One i2v video from the start image [1, H, W, 3]: the concat of
        ``i2v_condition``'s latents and mask on every model call."""
        if image.shape[0] != 1:
            raise ValueError("offloaded generation is single-video (batch 1)")
        t0 = time.perf_counter()
        cond = self.i2v_condition(image, spec)
        self._sync()
        encode_s = time.perf_counter() - t0
        videos = self._offloaded_sample(spec, seed, context, cond,
                                        resident_bytes, stream_dtype,
                                        progress_token, should_stop, noise)
        self.timings["encode_s"] = encode_s
        return videos

    def _offloaded_sample(self, spec: VideoSpec, seed: int, context, cond,
                          resident_bytes, stream_dtype, progress_token,
                          should_stop, noise) -> torch.Tensor:
        from .offload import OffloadedWan, require_ladder, sample_ladder

        if context.shape[0] != 1:
            raise ValueError("offloaded generation is single-video (batch 1)")
        # decided from the plans, before any expert is built
        require_ladder(spec.sampler, any(
            OffloadedWan.streams(m, resident_bytes, stream_dtype)
            for m in (self.dit, self.dit_low) if m is not None))
        dev = self.offload_device or self.device
        sigmas = sigmas_flow(spec.steps, spec.shift).to(dev)
        if noise is None:
            noise = torch.randn(self.latent_shape(spec),
                                generator=seed_generator(seed, dev),
                                dtype=torch.float32, device=dev)
        high_noise, low_noise = (step_noise(seed, dev),
                                 step_noise(step_seed(seed, LOW_EXPERT_FOLD),
                                            dev))
        context = context.to(dev)
        inp_fn = None if cond is None else i2v_input_concat(*cond)
        calls: dict[str, int] = {}
        timings: dict = {"calls": calls}
        self.timings = timings

        def run(which, x, sig, draws):
            other = "low" if which == "high" else "high"
            if other in self._offload.experts():
                # one expert's store on the card at a time
                self._sync(dev)
                self._offload.evict(other)
            if dev.type == "cuda":
                timings.setdefault("allocated_before", {})[which] = \
                    torch.cuda.memory_allocated(dev)
            off = self.offload_executor(which, resident_bytes, stream_dtype)

            def count():
                calls[which] = calls.get(which, 0) + 1

            den = off.denoiser(context, spec.guidance_scale, inp_fn, count)
            if progress_token is not None:
                den = wrap_denoiser(den, progress_token)
            return sample_ladder(spec.sampler, den, x, sig, draws,
                                 should_stop)

        label = "video_offload" if cond is None else "video_i2v_offload"
        with pipeline_call(self, label, lambda: self.timings):
            t0 = time.perf_counter()
            x = noise.to(dev)
            split = self._expert_split(sigmas) if self.is_moe else None
            steps = sigmas.shape[0] - 1
            if split is None or split >= steps:
                x0 = run("high", x, sigmas, high_noise)
            elif split <= 0:
                x0 = run("low", x, sigmas, high_noise)
            else:
                x_mid = run("high", x, sigmas[:split + 1], high_noise)
                self._sync(dev)
                if should_stop is not None and should_stop():
                    # before the low expert is built
                    raise InterruptedError(
                        "offloaded two-expert sampling interrupted at the "
                        "expert boundary")
                self._offload.evict("high")
                if dev.type == "cuda":
                    timings["allocated_after_release"] = \
                        torch.cuda.memory_allocated(dev)
                x0 = run("low", x_mid, sigmas[split:], low_noise)
            self._sync(dev)
            t1 = time.perf_counter()
            videos = self.decode_frames(x0)
            self._sync(dev)
            timings.update(sample_s=t1 - t0,
                           decode_s=time.perf_counter() - t1,
                           steps=steps)
        return videos
