"""Text→image and image→image pipeline on one device (counterpart of the
JAX ``diffusion/pipeline.py``'s ``Txt2ImgPipeline``).

The JAX package runs the whole generation as one SPMD program over a
mesh; here one device runs it eagerly: noise → the spec's sampler over
its sigma ladder with a doubled-batch CFG denoiser → VAE decode → clip
to [0, 1]. The noise draw (``initial_noise``) is split from the rest
(``sample_and_decode``) so a caller can supply its own noise; a
stochastic sampler's draws come from a noise source
(``parallel/rng.step_noise`` of the run's seed, or the caller's).

Stage-split serving (``cluster/stages``) runs the two halves apart:
``generate_latents`` stops a group's requests at ``x0``, and
``decode_latents`` finishes them later on another thread, each image
bitwise ``generate``'s.

``generate_preemptible`` is ``generate`` in resumable K-step segments
(step-granular preemption, ``cluster/preemption.py``): between segments
it may stop and return the sampler's whole state as a
``diffusion/checkpoint.LatentCheckpoint``, and a later call (in this
process or another) resumes from it; interrupted or not, its image is
bitwise ``generate``'s.

``img2img`` encodes a source, noises it at the head of the partial
ladder (``spec.denoise``) and samples the tail; with a mask it inpaints
(``inpaint_denoiser``). ``with_control`` returns a clone that runs a
ControlNet (``models/controlnet.py``) beside the UNet on every model
call, fed a hint.

Each call's sampling and decode run under a ``pipeline_call`` span; its
wall-clock lands in
``cdt_pipeline_compile_seconds`` (a pipeline's first call) or
``cdt_pipeline_execute_seconds``, and the synchronised sampling time
per ladder step in ``cdt_sampler_step_seconds``. Both clocks are read
where the call synchronises for its own timings anyway: telemetry adds
no synchronisation.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from contextlib import contextmanager
from typing import Callable, Optional

import torch

from .. import telemetry
from ..models.layers import timestep_embedding
from ..telemetry import metrics as _tm
from ..models.unet import UNet2D
from ..models.vae import AutoencoderKL
from ..ops.resize import resize_to
from ..parallel.rng import seed_generator, step_noise
from .checkpoint import BACKEND as CHECKPOINT_BACKEND
from .guidance import cfg_denoiser, eps_denoiser
from .progress import wrap_denoiser
from .samplers import (Denoiser, NoiseSource, make_program,
                       run_segment, sample)
from .schedules import (NoiseSchedule, sigmas_beta, sigmas_exponential,
                        sigmas_karras, sigmas_linear_quadratic, sigmas_normal,
                        sigmas_sgm_uniform, vp_schedule)


class _AttnKernelSummary:
    """A span attribute read when the span closes: the attention tiers
    chosen by then (``ops/attention.selection_summary``)."""

    def __str__(self) -> str:
        from ..ops.attention import selection_summary

        return selection_summary() or "none"


@contextmanager
def pipeline_call(owner, label: str, timings: Callable[[], dict]):
    """Time one pipeline call of ``owner`` under a ``pipeline_call`` span
    and record it (first call or later, by ``owner`` and ``label``), with
    ``timings()["sample_s"] / timings()["steps"]`` as the step time. Off
    with telemetry: nothing but one boolean read."""
    if not telemetry.enabled():
        yield
        return
    t0 = time.perf_counter()
    with telemetry.span("pipeline_call", pipeline=label,
                        attn_kernels=_AttnKernelSummary()):
        yield
    dt = time.perf_counter() - t0
    seen = owner.__dict__.setdefault("_telemetry_labels", set())
    family = (_tm.PIPELINE_EXECUTE_SECONDS if label in seen
              else _tm.PIPELINE_COMPILE_SECONDS)
    seen.add(label)
    family.labels(pipeline=label).observe(dt)
    t = timings()
    if t.get("steps"):
        _tm.SAMPLER_STEP_SECONDS.labels(pipeline=label).observe(
            t["sample_s"] / t["steps"])


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
                          sampler_noise: Optional[NoiseSource] = None,
                          label: Optional[str] = None) -> torch.Tensor:
        """noise [B,h,w,C] → images [B,H,W,3] in [0, 1] (fp32).
        ``sampler_noise`` is the stochastic samplers' noise source
        (``samplers.sample``).
        ``progress_token`` (a ``ProgressTracker.start`` token) streams
        each step's x0 to the progress sinks. ``hint`` feeds a
        ``with_control`` clone's ControlNet. ``init_latent`` switches to
        img2img: the source latent is noised to the ladder's head
        instead of starting from noise alone; ``inpaint_mask``
        ([B,h,w,1], 1 = regenerate) then applies ``inpaint_denoiser``.
        The two halves are ``_sample_latent`` (to the final ``x0``) and
        ``_decode_latent``, which stage-split serving runs apart."""
        if label is None:
            label = "txt2img" if init_latent is None else "img2img"
        timings: dict = {}
        with pipeline_call(self, label, lambda: self.timings):
            x0 = self._sample_latent(
                noise, spec, context, uncond_context, y, uncond_y,
                progress_token, hint, init_latent, inpaint_mask,
                sampler_noise, timings)
            t1 = time.perf_counter()
            images = self._decode_latent(x0)
            self._sync()
            self.timings = {"sample_s": timings["sample_s"],
                            "decode_s": time.perf_counter() - t1,
                            "steps": timings["steps"]}
        return images

    def _sample_latent(self, noise: torch.Tensor, spec: GenerationSpec,
                       context: torch.Tensor, uncond_context: torch.Tensor,
                       y: Optional[torch.Tensor], uncond_y: Optional[torch.Tensor],
                       progress_token: Optional[int],
                       hint: Optional[torch.Tensor],
                       init_latent: Optional[torch.Tensor],
                       inpaint_mask: Optional[torch.Tensor],
                       sampler_noise: Optional[NoiseSource],
                       timings: dict) -> torch.Tensor:
        """The sampling half of ``sample_and_decode``: the final ``x0``
        [B,h,w,C] fp32, synchronised; ``timings`` gets ``sample_s`` and
        ``steps``."""
        denoise, x, sigmas, ladder = self._prepare_sampling(
            noise, spec, context, uncond_context, y, uncond_y,
            progress_token, hint, init_latent, inpaint_mask)
        t0 = time.perf_counter()
        x0 = sample(spec.sampler, denoise, x, sigmas, sampler_noise,
                    ladder=ladder)
        self._sync()
        timings.update(sample_s=time.perf_counter() - t0,
                       steps=len(sigmas) - 1)
        return x0

    def _prepare_sampling(self, noise: torch.Tensor, spec: GenerationSpec,
                          context: torch.Tensor, uncond_context: torch.Tensor,
                          y: Optional[torch.Tensor],
                          uncond_y: Optional[torch.Tensor],
                          progress_token: Optional[int],
                          hint: Optional[torch.Tensor],
                          init_latent: Optional[torch.Tensor],
                          inpaint_mask: Optional[torch.Tensor]) -> tuple:
        """A run's denoiser (CFG, ControlNet, inpainting, progress), its
        starting latent, the sigma ladder on the device and its host
        values: what the sampler is bound to."""
        dev = self.device
        ladder = make_sigma_ladder(spec, self.schedule)
        sigmas = ladder.to(dev)
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
        return denoise, x, sigmas, ladder.tolist()

    def _decode_latent(self, x0: torch.Tensor) -> torch.Tensor:
        """The decode half: VAE decode of ``x0`` and the clip to [0, 1]."""
        images = self.vae.decode(x0)
        return torch.clamp(images / 2.0 + 0.5, 0.0, 1.0)

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

    # --- step-granular preemption (cluster/preemption.py) ---------------------

    def checkpoint_identity(self, spec: GenerationSpec, seed: int,
                            conditioning: Optional[tuple] = None) -> dict:
        """What a checkpoint must match to resume this exact run: the JAX
        package's fields (one card: ``n_dp`` 1) and ``backend: "torch"``.
        ``conditioning`` (context, uncond, y, uy) binds it to the
        prompt's content, so another prompt of equal geometry and seed
        cannot resume it."""
        identity = {
            "sampler": spec.sampler, "scheduler": spec.scheduler,
            "steps": int(spec.steps), "height": int(spec.height),
            "width": int(spec.width), "cfg": float(spec.guidance_scale),
            "per_device_batch": int(spec.per_device_batch),
            "seed": int(seed), "n_dp": 1, "backend": CHECKPOINT_BACKEND,
        }
        if conditioning is not None:
            identity["conditioning"] = conditioning_digest(*conditioning)
        return identity

    @torch.no_grad()
    def generate_preemptible(
        self, spec: GenerationSpec, seed: int, context: torch.Tensor,
        uncond_context: torch.Tensor, y: Optional[torch.Tensor] = None,
        uncond_y: Optional[torch.Tensor] = None, *,
        segment_steps: Optional[int] = None,
        should_preempt: Optional[Callable[[], Optional[str]]] = None,
        resume=None, progress_token: Optional[int] = None,
    ) -> dict:
        """``generate`` in resumable segments of ``segment_steps``
        (``CDT_PREEMPT_SEGMENT_STEPS``) ladder steps on the device.

        Each segment ends with a synchronisation: the boundary is the
        preemption point. There ``should_preempt()`` (a reason or None) is
        asked; on a reason the sampler's state is copied to the host and
        ``{"checkpoint": LatentCheckpoint, "reason", "step"}`` returned,
        nothing decoded. ``resume`` (a ``LatentCheckpoint``) continues a
        parked run: its identity, state shapes and step are checked (a
        mismatch raises ``CheckpointRestoreError``), its state uploaded.
        At least one segment runs per call, so a preemption storm cannot
        stop a job from advancing. Completion decodes and returns
        ``{"images", "step"}``, bitwise ``generate`` for the same inputs,
        interrupted or not."""
        from ..utils import constants
        from .checkpoint import (CheckpointRestoreError, LatentCheckpoint,
                                 leaves_to_state, state_to_leaves)

        seg_steps = max(1, int(segment_steps
                               or constants.preempt_segment_steps()))
        dev = self.device
        identity = self.checkpoint_identity(
            spec, seed, conditioning=(context, uncond_context, y, uncond_y))
        # the initial noise is drawn only for a fresh run (a resumed one
        # has its latent in the state); its shape is the spec's
        ds = self.vae.config.downscale
        shape = (spec.per_device_batch, spec.height // ds, spec.width // ds,
                 self.latent_channels)
        noise = (torch.zeros(shape, device=dev) if resume is not None else
                 self.initial_noise(spec, seed_generator(seed, dev)))
        timings: dict = {}
        with pipeline_call(self, "txt2img", lambda: timings):
            denoise, x, sigmas, ladder = self._prepare_sampling(
                noise, spec, context, uncond_context, y, uncond_y,
                progress_token, None, None, None)
            program = make_program(spec.sampler, denoise, sigmas,
                                   step_noise(seed, dev), ladder=ladder)
            init, _, extract = program
            n = len(ladder) - 1
            resume_t0 = None
            if resume is not None:
                resume.validate_meta(identity)
                want = tuple(tuple(v.shape) if isinstance(v, torch.Tensor)
                             else () for v in init(x.to("meta")))
                got = tuple(tuple(leaf.shape) for leaf in resume.carry)
                if got != want:
                    raise CheckpointRestoreError(
                        f"checkpoint state shapes {got} do not match this "
                        f"run's {want}")
                if not 0 <= resume.step <= n:
                    raise CheckpointRestoreError(
                        f"checkpoint step {resume.step} outside the ladder "
                        f"0..{n}")
                resume_t0 = time.perf_counter()
                state = leaves_to_state(resume.carry, dev)
                start = int(resume.step)
            else:
                state = init(x)
                start = 0
            t0 = time.perf_counter()
            done_here = 0
            while start < n:
                if done_here and should_preempt is not None:
                    reason = should_preempt()
                    if reason:
                        ckpt = LatentCheckpoint(
                            sampler=spec.sampler, step=start, total_steps=n,
                            carry=state_to_leaves(state), meta=identity)
                        return {"checkpoint": ckpt, "reason": reason,
                                "step": start}
                length = min(seg_steps, n - start)
                state = run_segment(program, state, start, length)
                self._sync()
                if resume_t0 is not None and telemetry.enabled():
                    # a restore's upload and its first segment
                    _tm.RESUME_SECONDS.observe(time.perf_counter() - resume_t0)
                resume_t0 = None
                start += length
                done_here += length
            t1 = time.perf_counter()
            images = self._decode_latent(extract(state))
            self._sync()
            timings.update(sample_s=t1 - t0, steps=done_here,
                           decode_s=time.perf_counter() - t1)
            self.timings = dict(timings)
        return {"images": images, "step": n}

    # --- the fleet cache's near tier (cluster/cache/fleet.py) -----------------

    @torch.no_grad()
    def generate_near(
        self, spec: GenerationSpec, seed: int, latent: torch.Tensor,
        context: torch.Tensor, uncond_context: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        uncond_y: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        sampler_noise: Optional[NoiseSource] = None,
    ) -> torch.Tensor:
        """A near-tier re-roll from a donor's mid-trajectory latent
        [B,h,w,C]: ``img2img``'s math with the VAE encode replaced by the
        donor latent. ``spec.denoise`` (the donor's remaining steps over
        its total) selects the ladder's tail; the latent is noised at its
        head with noise drawn from ``seed`` (or ``noise`` from the caller)
        and the tail sampled and decoded. Not bitwise a run from scratch,
        by design: the donor state stands in for a clean init and the
        request's own seed re-rolls the rest. ``y``/``uncond_y`` default
        to zeros where the UNet takes them."""
        dev = self.device
        lat = torch.as_tensor(latent).to(dev, torch.float32)
        if noise is None:
            noise = torch.randn(lat.shape, generator=seed_generator(seed, dev),
                                dtype=torch.float32, device=dev)
        if sampler_noise is None:
            sampler_noise = step_noise(seed, dev)
        return self.sample_and_decode(
            noise, spec, context, uncond_context, y, uncond_y,
            init_latent=lat, sampler_noise=sampler_noise,
            label="txt2img_near")

    def generate_microbatch(
        self, spec: GenerationSpec, seeds: "list[int]",
        contexts: "list[torch.Tensor]",
        uncond_contexts: "list[torch.Tensor]",
        ys: "list[Optional[torch.Tensor]] | None" = None,
        uys: "list[Optional[torch.Tensor]] | None" = None,
    ) -> "list[torch.Tensor]":
        """N same-shape requests as one group (the front door's
        microbatch): one ``[per_device_batch, H, W, 3]`` tensor per
        request, each bitwise ``generate(spec, seeds[r], contexts[r],
        ...)``.

        The JAX package unrolls R per-request subgraphs at solo shapes
        inside one program, because stacking the requests into the
        products' batch drifts. Eager PyTorch's faithful form of that is
        R calls at solo shapes on one stream, which is what runs here.
        JAX's power-of-two pad slots (request 0 repeated, outputs
        dropped) are not run: they cost work and buy nothing eagerly.
        Stochastic samplers and ControlNet clones raise JAX's errors."""
        self._check_microbatch(spec, seeds, contexts, uncond_contexts)
        R = len(seeds)
        ys = list(ys) if ys is not None else [None] * R
        uys = list(uys) if uys is not None else [None] * R
        return [self.generate(spec, int(seeds[r]), contexts[r],
                              uncond_contexts[r], ys[r], uys[r])
                for r in range(R)]

    # --- stage-split serving (cluster/stages) --------------------------------

    def _check_microbatch(self, spec: GenerationSpec, seeds, contexts,
                          uncond_contexts) -> None:
        if not (len(seeds) == len(contexts) == len(uncond_contexts)):
            raise ValueError("seeds/contexts/uncond_contexts length mismatch")
        if spec.sampler not in DETERMINISTIC_SAMPLERS:
            raise ValueError(
                f"sampler {spec.sampler!r} is stochastic — microbatching "
                f"requires one of {sorted(DETERMINISTIC_SAMPLERS)}")
        if self._control is not None:
            raise ValueError("microbatching does not support ControlNet "
                             "pipelines (per-request hints are not stacked)")

    @torch.no_grad()
    def generate_latents(
        self, spec: GenerationSpec, seeds: "list[int]",
        contexts: "list[torch.Tensor]",
        uncond_contexts: "list[torch.Tensor]",
        ys: "list[Optional[torch.Tensor]] | None" = None,
        uys: "list[Optional[torch.Tensor]] | None" = None,
    ) -> "list[torch.Tensor]":
        """``generate_microbatch`` stopped at ``x0``: the denoise pool's
        call in stage-split serving. One ``[per_device_batch, h, w, C]``
        fp32 latent a request, on the device, each the bytes that
        ``generate`` feeds its VAE; ``decode_latents`` finishes them
        (possibly gathered across groups), bitwise ``generate``.

        The JAX package's form is one program of R solo-shaped subgraphs
        (``latent_microbatch_fn``); eagerly it is R solo-shaped calls in
        a row, as ``generate_microbatch`` runs. Each call carries its own
        ``no_grad``: a pool thread does not inherit its caller's."""
        self._check_microbatch(spec, seeds, contexts, uncond_contexts)
        R = len(seeds)
        ys = list(ys) if ys is not None else [None] * R
        uys = list(uys) if uys is not None else [None] * R
        out = []
        for r in range(R):
            seed = int(seeds[r])
            noise = self.initial_noise(spec, seed_generator(seed, self.device))
            timings: dict = {}
            with pipeline_call(self, "txt2img_lat", lambda: timings):
                out.append(self._sample_latent(
                    noise, spec, contexts[r], uncond_contexts[r], ys[r],
                    uys[r], None, None, None, None,
                    step_noise(seed, self.device), timings))
        return out

    @torch.no_grad()
    def decode_latents(self, latents: "list[torch.Tensor]"
                       ) -> "list[torch.Tensor]":
        """Decode final latents (any mix of requests of one shape): one
        ``[B, H, W, 3]`` image in [0, 1] a latent, bitwise the fused
        path's decode of the same bytes. Each latent decodes alone at
        its solo shape, in a row: stacking them into the convolutions'
        batch would let cuDNN and cuBLAS pick other algorithms and change
        the bits, as it reassociates JAX's reductions (JAX
        ``pipeline.decode_fn``). JAX's power-of-two pad slots are not
        run: eagerly they cost work and buy nothing."""
        if not latents:
            return []
        first = tuple(latents[0].shape)
        for lat in latents[1:]:
            if tuple(lat.shape) != first:
                raise ValueError(
                    f"decode batch mixes latent shapes {first} and "
                    f"{tuple(lat.shape)} — bucket by shape first")
        out = []
        with pipeline_call(self, "vae_decode_batch", dict):
            for lat in latents:
                out.append(self._decode_latent(
                    torch.as_tensor(lat).to(self.device, torch.float32)))
            self._sync()
        return out

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


def conditioning_digest(*tensors) -> str:
    """Content digest of a conditioning tuple (shape, dtype and bytes of
    each tensor; a None slot pinned), the JAX package's
    ``_conditioning_digest`` over the port's tensors: the identity part
    that ties a parked latent to its prompt."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        if t is None:
            h.update(b"|none")
            continue
        arr = t.detach().cpu().contiguous().numpy()
        h.update(f"|{arr.shape}:{arr.dtype}:".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


# samplers whose trajectory is a pure function of (noise, conditioning):
# the JAX package replays N solo runs of these inside one microbatch; its
# stochastic families draw batch-shaped step noise from one key and are
# left out (the classifier sends them down the solo path)
DETERMINISTIC_SAMPLERS = frozenset({"euler", "heun", "dpmpp_2m", "ddim"})


def demux_microbatch(out: torch.Tensor, n_requests: int,
                     per_device_batch: int) -> "list[torch.Tensor]":
    """Split a stacked ``[R·B, ...]`` output into the R per-request
    ``[B, ...]`` blocks, request-major (the JAX package's demux on one
    device: a single shard block). Nothing on the serving path stacks
    requests yet (``generate_microbatch`` returns one tensor a request):
    this is for a future stacked path and the batch-invariance check."""
    R, B = int(n_requests), int(per_device_batch)
    if out.shape[0] != R * B:
        raise ValueError(
            f"microbatch output has {out.shape[0]} rows, expected "
            f"n_dp(1) · R({R}) · B({B}) = {R * B}")
    return [out[r * B:(r + 1) * B] for r in range(R)]
