"""Rectified-flow pipeline on one device (counterpart of the JAX
``diffusion/pipeline_flow.py``'s ``FlowPipeline`` in its ``dp`` mode with
one participant).

noise → the spec's sampler over the shifted flow ladder with the velocity
denoiser ``x − σ·v`` → VAE decode → clip to [0, 1]. FLUX-dev takes
``cfg == 1`` and its distilled guidance as a model input; the SD3 family
takes true CFG (``cfg != 1``): cond and uncond doubled into one batch, one
DiT call a step (``guidance.cfg_denoiser``), the negative conditioning
required. As in the JAX pipeline the noise is not scaled by the first
sigma (it is 1). ``initial_noise`` is split from ``sample_and_decode`` so
a caller can supply its own noise; a stochastic sampler draws from
``parallel/rng.step_noise`` of the run's seed or the caller's noise
source.

Over a device mesh (``parallel/``, run on every rank by
``parallel/programs``): ``generate_mesh`` is the ``dp`` fan-out
(participant i's noise from ``participant_seed(seed, i)``, the images
gathered on every rank in participant order) and ``generate_sp`` one
image's latent rows sharded over ``sp`` with joint ring attention in
every block (JAX's ``generate_sp_fn``): the one-device run's noise
row-sliced per rank (a stochastic sampler's draws too), true CFG as
one doubled batch, the latents gathered, decoded on coordinate 0 only.

``generate_offloaded`` runs one image through an ``OffloadedFlux``
executor (``diffusion/offload.py``): the DiT's blocks packed, fp8 by
default, resident on the card under a budget or streamed from the host,
cached per (resident bytes, stream dtype, block source). The noise and
the sampler's draws are the ``dp`` run's of the seed, so an offloaded
``native`` run is a ``dp`` run of the same weights.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..models.dit import DiT
from ..models.vae import AutoencoderKL
from ..parallel.rng import seed_generator, step_noise
from .guidance import cfg_denoiser
from .offload import ExecutorCache
from .pipeline import pipeline_call
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
        # the offload executor (one at a time) and where its blocks come
        # from: an offload bundle sets its drawn blocks here
        self.offload_source = None
        # the card a host-held core's executor runs on (default: the DiT's)
        self.offload_device: Optional[torch.device] = None
        self._offload = ExecutorCache()

    @property
    def device(self) -> torch.device:
        return self.offload_device or self.dit.img_in.weight.device

    def __getstate__(self) -> dict:
        """Pickled (a mesh call carrying a pipeline whole) without its
        offload executor, a card store behind a lock."""
        state = dict(self.__dict__)
        state.update(_offload=None, offload_source=None)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._offload = ExecutorCache()

    def initial_noise(self, spec: FlowSpec,
                      generator: torch.Generator) -> torch.Tensor:
        """Unit normal latent noise [B, h, w, C] in fp32 on the
        generator's device."""
        ds = self.vae.config.downscale
        shape = (spec.per_device_batch, spec.height // ds, spec.width // ds,
                 self.dit.config.in_channels)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device)

    def _denoiser(self, context: torch.Tensor, pooled: torch.Tensor,
                  guidance: float, cfg: float = 1.0,
                  uncond_context: Optional[torch.Tensor] = None,
                  uncond_pooled: Optional[torch.Tensor] = None,
                  sp_axis: Optional[str] = None) -> Denoiser:
        """``cfg != 1`` batches the cond and uncond passes into one
        doubled-batch DiT call; ``cfg == 1`` is the plain velocity
        denoiser. ``sp_axis``: the latent is a row shard over that mesh
        axis."""
        def make(ctx, pl):
            def denoise(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
                t = sigma.expand(x.shape[0])
                g = torch.full((x.shape[0],), guidance, device=x.device)
                return x - sigma * self.dit(x, t, ctx, pl, g,
                                            sp_axis=sp_axis)

            return denoise

        if cfg == 1.0:
            return make(context, pooled)
        if uncond_context is None:
            # sampling without the guidance the caller asked for would
            # quietly give another image
            raise ValueError(
                f"cfg={cfg} requires negative conditioning: pass "
                "uncond_context (and uncond_pooled) through generate, or "
                "wire the FlowSampler node's 'negative' input; FLUX-dev "
                "distilled guidance wants cfg=1.0 with the 'guidance' "
                "field instead")
        return cfg_denoiser(make, context, uncond_context, cfg, y=pooled,
                            uncond_y=uncond_pooled)

    def _sync(self, device: Optional[torch.device] = None) -> None:
        device = device or self.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @torch.no_grad()
    def sample_and_decode(self, noise: torch.Tensor, spec: FlowSpec,
                          context: torch.Tensor, pooled: torch.Tensor,
                          progress_token: Optional[int] = None,
                          sampler_noise: Optional[NoiseSource] = None,
                          uncond_context: Optional[torch.Tensor] = None,
                          uncond_pooled: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """noise [B,h,w,C] → images [B,H,W,3] in [0, 1] (fp32).
        ``progress_token`` (a ``ProgressTracker.start`` token) streams
        each step's x0 to the progress sinks; ``sampler_noise`` is the
        stochastic samplers' noise source; ``uncond_context`` and
        ``uncond_pooled`` are the negative conditioning of ``spec.cfg !=
        1`` (``uncond_context`` required then, ``uncond_pooled`` zeros
        when omitted), ignored otherwise."""
        dev = self.device
        sigmas = sigmas_flow(spec.steps, spec.shift).to(dev)
        batch = noise.shape[0]

        def rows(t):
            if t is None:
                return None
            t = t.to(dev)
            return t.expand(batch, *t.shape[1:])

        denoise = self._denoiser(rows(context), rows(pooled), spec.guidance,
                                 spec.cfg, rows(uncond_context),
                                 rows(uncond_pooled))
        if progress_token is not None:
            denoise = wrap_denoiser(denoise, progress_token)
        with pipeline_call(self, "flow_dp", lambda: self.timings):
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
                 progress_token: Optional[int] = None,
                 uncond_context: Optional[torch.Tensor] = None,
                 uncond_pooled: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """One seeded image batch; ``uncond_context``/``uncond_pooled``
        carry the negative conditioning, as in ``sample_and_decode``."""
        noise = self.initial_noise(spec, seed_generator(seed, self.device))
        return self.sample_and_decode(noise, spec, context, pooled,
                                      progress_token,
                                      step_noise(seed, self.device),
                                      uncond_context, uncond_pooled)

    # --- over a device mesh (parallel/) ---------------------------------------

    def generate_mesh(self, spec: FlowSpec, seed: int, context: torch.Tensor,
                      pooled: torch.Tensor,
                      uncond_context: Optional[torch.Tensor] = None,
                      uncond_pooled: Optional[torch.Tensor] = None,
                      axis: str = "dp", noises=None,
                      progress_token: Optional[int] = None) -> torch.Tensor:
        """This rank's part of the ``dp`` fan-out over ``axis``: participant
        i samples and decodes from ``participant_seed(seed, i)``; the
        images come back gathered in participant order. ``noises`` (one
        per participant) replaces the seeded noise."""
        from ..parallel.collectives import gather_batch, shard_index
        from ..parallel.rng import participant_seed

        index = shard_index(axis)
        pseed = participant_seed(seed, index)
        noise = (noises[index] if noises is not None else
                 self.initial_noise(spec, seed_generator(pseed, self.device)))
        images = self.sample_and_decode(noise, spec, context, pooled,
                                        progress_token,
                                        step_noise(pseed, self.device),
                                        uncond_context, uncond_pooled)
        return gather_batch(images, axis)

    @torch.no_grad()
    def generate_tp(self, spec: FlowSpec, seed: int, context: torch.Tensor,
                    pooled: torch.Tensor, dp_axis: str = "dp",
                    tp_axis: str = "tp", noises=None,
                    progress_token: Optional[int] = None
                    ) -> Optional[torch.Tensor]:
        """This rank's part of the dp×tp program (JAX's
        ``generate_tp_fn``): ``self`` is the rank's shard
        (``parallel/tensor.shard_pipeline``), its DiT blocks split over
        ``tp_axis``. Participant i of ``dp_axis`` (0 without one) samples
        from ``participant_seed(seed, i)`` (``noises``: one per
        participant, a test's); the tp-index-0 rank of its group decodes,
        and the images come back gathered over ``dp_axis``; the other
        ranks return None. True CFG is refused, as in JAX."""
        from ..parallel.collectives import gather_batch, shard_index
        from ..parallel.mesh import current_mesh
        from ..parallel.rng import participant_seed

        if spec.cfg != 1.0:
            raise ValueError(
                "true CFG (spec.cfg != 1.0) is not wired through tp "
                "mode — use cfg=1.0 with FLUX distilled 'guidance', or "
                "run the dp/sp paths")
        mesh = current_mesh()
        index = shard_index(dp_axis) if dp_axis in mesh.axes else 0
        pseed = participant_seed(seed, index)
        dev = self.device
        noise = (noises[index].to(dev) if noises is not None else
                 self.initial_noise(spec, seed_generator(pseed, dev)))
        sigmas = sigmas_flow(spec.steps, spec.shift).to(dev)
        batch = noise.shape[0]

        def rows(t):
            t = t.to(dev)
            return t.expand(batch, *t.shape[1:])

        denoise = self._denoiser(rows(context), rows(pooled), spec.guidance)
        if progress_token is not None:
            denoise = wrap_denoiser(denoise, progress_token)
        with pipeline_call(self, "flow_tp", lambda: self.timings):
            t0 = time.perf_counter()
            x0 = sample(spec.sampler, denoise, noise, sigmas,
                        step_noise(pseed, dev))
            self._sync()
            t1 = time.perf_counter()
            self.timings = {"sample_s": t1 - t0, "decode_s": 0.0,
                            "steps": len(sigmas) - 1}
            if tp_axis in mesh.axes and shard_index(tp_axis) != 0:
                return None
            images = torch.clamp(self.vae.decode(x0) / 2.0 + 0.5, 0.0, 1.0)
            self._sync()
            self.timings["decode_s"] = time.perf_counter() - t1
        return (gather_batch(images, dp_axis) if dp_axis in mesh.axes
                else images)

    @torch.no_grad()
    def generate_sp(self, spec: FlowSpec, seed: int, context: torch.Tensor,
                    pooled: torch.Tensor,
                    uncond_context: Optional[torch.Tensor] = None,
                    uncond_pooled: Optional[torch.Tensor] = None,
                    axis: str = "sp",
                    noise: Optional[torch.Tensor] = None
                    ) -> Optional[torch.Tensor]:
        """This rank's part of one image over ``axis``: the full latent's
        noise (the one-device run's of ``seed``, or ``noise``), this
        rank's rows of it; every sampler draw the full draw's rows; the
        x0 rows gathered; coordinate 0 decodes and returns the images
        [1,H,W,3], the others None."""
        from ..parallel.collectives import all_gather
        from ..parallel.mesh import axis_group

        if spec.per_device_batch != 1:
            raise ValueError("sp generates one image (per_device_batch 1)")
        g = axis_group(axis)
        dev = self.device
        ds = self.vae.config.downscale
        lat_h = spec.height // ds
        p = self.dit.config.patch_size
        if (lat_h // p) % g.size:
            raise ValueError(f"latent rows/patch ({lat_h}/{p}) must divide "
                             f"over {g.size} shards")
        rows = lat_h // g.size
        if noise is None:
            noise = self.initial_noise(spec, seed_generator(seed, dev))
        x = noise.to(dev)[:, g.index * rows:(g.index + 1) * rows]
        draws = step_noise(seed, dev)

        def row_noise(j: int, shape: tuple) -> torch.Tensor:
            full = (shape[0], shape[1] * g.size, *shape[2:])
            return draws(j, full)[:, g.index * rows:(g.index + 1) * rows]

        sigmas = sigmas_flow(spec.steps, spec.shift).to(dev)
        if spec.cfg != 1.0 and uncond_pooled is None and pooled is not None:
            uncond_pooled = torch.zeros_like(pooled)

        def on(t):
            return None if t is None else t.to(dev)

        denoise = self._denoiser(on(context), on(pooled), spec.guidance,
                                 spec.cfg, on(uncond_context),
                                 on(uncond_pooled), sp_axis=axis)
        with pipeline_call(self, "flow_sp", lambda: self.timings):
            t0 = time.perf_counter()
            x0 = sample(spec.sampler, denoise, x, sigmas, row_noise)
            latents = all_gather(x0, axis, dim=1)
            self._sync()
            t1 = time.perf_counter()
            images = None
            if g.index == 0:
                images = torch.clamp(self.vae.decode(latents) / 2.0 + 0.5,
                                     0.0, 1.0)
                self._sync()
            self.timings = {"sample_s": t1 - t0,
                            "decode_s": time.perf_counter() - t1,
                            "steps": len(sigmas) - 1}
        return images

    # --- offload (diffusion/offload.py) ---------------------------------------

    def offload_executor(self, resident_bytes: Optional[int] = None,
                         stream_dtype: Optional[str] = None):
        """Build or fetch the ``OffloadedFlux`` executor, cached by
        (resident bytes, stream dtype, block source). One is kept: a build
        under another key releases the previous store first."""
        from .offload import ModuleBlocks, OffloadedFlux, normalize_stream_dtype

        sd = normalize_stream_dtype(stream_dtype)
        source = self.offload_source or ModuleBlocks(self.dit)
        return self._offload.get(
            "high", (resident_bytes, sd, id(source)),
            lambda: OffloadedFlux(self.dit, source,
                                  resident_bytes=resident_bytes,
                                  device=self.offload_device, stream_dtype=sd))

    def release_offload(self) -> None:
        """Free the cached executor's store, if any."""
        self._offload.release()

    def offload_stores(self) -> list:
        return self._offload.stores()

    @torch.no_grad()
    def generate_offloaded(self, spec: FlowSpec, seed: int,
                           context: torch.Tensor, pooled: torch.Tensor,
                           resident_bytes: Optional[int] = None,
                           stream_dtype: Optional[str] = None,
                           progress_token: Optional[int] = None,
                           should_stop=None,
                           noise: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """One image [1,H,W,3] in [0, 1] through the offload executor,
        any sampler a step at a time, ``should_stop`` checked before every
        step. Refused before anything is built: batch over 1, ``cfg !=
        1``, and JAX's euler-only rule (``offload.require_ladder``).
        ``noise`` replaces the seed's initial noise (a test hands over
        JAX's)."""
        from .offload import OffloadedFlux, require_ladder, sample_ladder

        if spec.per_device_batch != 1 or context.shape[0] != 1:
            raise ValueError(
                "offloaded generation is single-image (batch 1): the "
                "streamed weight window serves one latent at a time")
        if spec.cfg != 1.0:
            raise ValueError(
                "true CFG (spec.cfg != 1.0) is not wired through the "
                "offload executor: use cfg=1.0 with FLUX distilled "
                "'guidance', or the dp path")
        require_ladder(spec.sampler, OffloadedFlux.streams(
            self.dit, resident_bytes, stream_dtype))
        off = self.offload_executor(resident_bytes, stream_dtype)
        dev = off.device
        if noise is None:
            noise = self.initial_noise(spec, seed_generator(seed, dev))
        sigmas = sigmas_flow(spec.steps, spec.shift).to(dev)
        context, pooled = context.to(dev), pooled.to(dev)
        with pipeline_call(self, "flow_offload", lambda: self.timings):
            t0 = time.perf_counter()
            denoise = off.denoiser(context, pooled, spec.guidance)
            if progress_token is not None:
                denoise = wrap_denoiser(denoise, progress_token)
            x0 = sample_ladder(spec.sampler, denoise, noise.to(dev), sigmas,
                               step_noise(seed, dev), should_stop)
            self._sync(dev)
            t1 = time.perf_counter()
            images = torch.clamp(self.vae.decode(x0) / 2.0 + 0.5, 0.0, 1.0)
            self._sync(dev)
            self.timings = {"sample_s": t1 - t0,
                            "decode_s": time.perf_counter() - t1,
                            "steps": len(sigmas) - 1,
                            "streamed_bytes": off.streamed_bytes}
        return images
