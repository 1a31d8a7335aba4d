"""The tile engine: Ultimate SD Upscale on one device (counterpart of the
JAX ``tiles/engine.py``).

resize → extract every crop (static origins) → img2img the crops in
fixed-size chunks, the last one padded with zero tiles → feathered,
weight-normalised composite. The JAX package runs the chunks as one
SPMD program over a mesh; here one device runs them one after another.

One plan serves both ways of running it (``range_plan``): ``upscale``
runs the whole tile range locally, and the cross-host farm
(``cluster/tile_farm.py``) hands ranges of the same plan to any host.
Two things make a farmed image bitwise equal to a direct one:

- the UNet always sees a chunk of the same size, so cuBLAS and cuDNN
  pick the same algorithms on every host;
- each tile's noise comes from a generator seeded from (seed, global
  tile index) (``parallel/rng.tile_seed``), and so does each of its
  stochastic sampler's draws (``step_noise`` of that tile seed, stacked
  over the chunk), so no host, chunk or requeue changes it. The JAX
  package folds the index into a threefry key instead, and gives a
  whole chunk one sampler key, so its sampler draws depend on how the
  tiles are grouped (a documented divergence): the parity tests hand
  JAX's noise over (``noise=``, ``step_noise=``).

The VAE encodes and decodes one tile at a time inside a chunk, on every
host alike: its single-head mid attention materialises an
[N, N] fp32 score matrix (N = 18 496 tokens for a 1088² crop, 1.37 GB).

Two maps are cropped per tile like the image (the reference's per-tile
conditioning crop): a spatial map (``spatial_cond``: 1 = denoise, 0 =
keep the source pixels), and a ControlNet hint for a ``with_control``
pipeline, which lives in the hint stem's space (latent resolution × 8),
so its grid is the image's scaled by ``8 // vae.downscale``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion.guidance import cfg_denoiser
from ..diffusion.pipeline import GenerationSpec, make_sigma_ladder, pipeline_call
from ..diffusion.samplers import sample
from ..models.controlnet import HINT_DOWNSCALE
from ..ops.blend import composite_tiles, extract_tiles, feather_mask
from ..ops.resize import resize_to, upscale_image
from ..parallel.rng import seed_generator, stacked_step_noise, tile_seed
from ..utils import constants
from .grid import TileGrid, compute_tile_grid


@dataclasses.dataclass(frozen=True)
class UpscaleSpec:
    scale: float = 2.0
    tile_w: int = 512
    tile_h: int = 512
    padding: int = 32
    feather: Optional[int] = None     # None → padding
    steps: int = 20
    denoise: float = 0.3
    sampler: str = "euler"
    scheduler: str = "karras"
    guidance_scale: float = 5.0
    resize_method: str = "lanczos3"

    def generation_spec(self) -> GenerationSpec:
        return GenerationSpec(steps=self.steps, denoise=self.denoise,
                              sampler=self.sampler, scheduler=self.scheduler,
                              guidance_scale=self.guidance_scale)


@dataclasses.dataclass
class TileRangePlan:
    """What the farm drivers use: the tile geometry and the fixed-chunk
    range processor."""

    grid: TileGrid
    chunk: int
    run_range: Callable[[int, int], np.ndarray]
    feather: Optional[int]
    # degraded fill for dead-lettered farm tasks: the plain-resized
    # source crops, no diffusion (cluster/tile_farm.assemble_tiles)
    source_range: Optional[Callable[[int, int], np.ndarray]] = None

    @property
    def num_tiles(self) -> int:
        return self.grid.num_tiles


class TileUpscaler:
    """Drives a ``Txt2ImgPipeline``'s UNet and VAE over a tile axis.

    ``timings`` lists, per chunk this upscaler ran, the seconds of
    encode, sampling and decode (host clock around work that ends in a
    device synchronise). The pipeline's ``timings`` (its last run's)
    become ``{"tile_chunks": <that list>, "composite_s": …}``."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.timings: list[dict[str, float]] = []
        pipeline.timings = {"tile_chunks": self.timings}

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def grid_for(self, image_h: int, image_w: int, spec: UpscaleSpec) -> TileGrid:
        out_h = int(round(image_h * spec.scale))
        out_w = int(round(image_w * spec.scale))
        return compute_tile_grid(out_w, out_h, spec.tile_w, spec.tile_h,
                                 spec.padding)

    @torch.no_grad()
    def _img2img_tiles(self, tiles: torch.Tensor, noise: torch.Tensor,
                       context: torch.Tensor, uncond_context: torch.Tensor,
                       y: Optional[torch.Tensor], uncond_y: Optional[torch.Tensor],
                       spec: UpscaleSpec, sigmas: torch.Tensor,
                       tile_masks: Optional[torch.Tensor] = None,
                       hint_tiles: Optional[torch.Tensor] = None,
                       sampler_noise=None) -> torch.Tensor:
        """img2img a [n, ch, cw, C] tile chunk with its [n, h, w, C_lat]
        unit noise → [n, ch, cw, C] in [0, 1]. ``tile_masks`` [n, ch, cw,
        1] blend the result with the source tiles (1 = denoise);
        ``hint_tiles`` feed the pipeline's ControlNet; ``sampler_noise``
        is the chunk's noise source for a stochastic sampler."""
        with pipeline_call(self, "tile_img2img", lambda: self.timings[-1]):
            return self._run_tiles(tiles, noise, context, uncond_context, y,
                                   uncond_y, spec, sigmas, tile_masks,
                                   hint_tiles, sampler_noise)

    def _run_tiles(self, tiles, noise, context, uncond_context, y, uncond_y,
                   spec, sigmas, tile_masks, hint_tiles, sampler_noise):
        pipe = self.pipeline
        vae = pipe.vae
        n = tiles.shape[0]
        t0 = time.perf_counter()
        latents = torch.cat([vae.encode(t[None] * 2.0 - 1.0) for t in tiles])
        pipe._sync()
        t1 = time.perf_counter()
        noised = latents + noise * sigmas[0]

        def rows(t):
            return t.to(pipe.device).expand(n, *t.shape[1:])

        gspec = spec.generation_spec()
        y_b = None if y is None else rows(y)
        uy_b = None if uncond_y is None else rows(uncond_y)
        if gspec.guidance_scale != 1.0:
            denoise = cfg_denoiser(
                lambda c, yy: pipe._denoiser(c, yy, hint=hint_tiles),
                rows(context), rows(uncond_context), gspec.guidance_scale,
                y_b, uy_b)
        else:
            denoise = pipe._denoiser(rows(context), y_b, hint=hint_tiles)
        x0 = sample(gspec.sampler, denoise, noised, sigmas, sampler_noise)
        pipe._sync()
        t2 = time.perf_counter()
        out = torch.cat([vae.decode(x[None]) for x in x0])
        out = torch.clamp(out / 2.0 + 0.5, 0.0, 1.0)
        if tile_masks is not None:
            out = tiles * (1.0 - tile_masks) + out * tile_masks
        pipe._sync()
        self.timings.append({"encode_s": t1 - t0, "sample_s": t2 - t1,
                             "decode_s": time.perf_counter() - t2,
                             "tiles": n, "steps": len(sigmas) - 1})
        return out

    def tiles_per_device_default(self, tile_w: int, tile_h: int) -> int:
        """Tiles per chunk: ``CDT_TILES_PER_DEVICE`` when set; 1 on the
        CPU (tests and tiny stacks); on the card 8 up to 512² tiles, 4
        up to 1024², else 1 (activations grow with the tile area)."""
        env = constants.tiles_per_device()
        if env > 0:
            return env
        if self.device.type == "cpu":
            return 1
        area = tile_w * tile_h
        if area <= 512 * 512:
            return 8
        if area <= 1024 * 1024:
            return 4
        return 1

    def _conditioning(self, y, uncond_y):
        """The ADM vectors the UNet takes (zeros where none is given), or
        None for a UNet without ADM."""
        adm = self.pipeline.unet.config.adm_in_channels
        if not adm:
            return None, None
        zeros = torch.zeros((1, adm), device=self.device)
        return (zeros if y is None else y.float(),
                zeros if uncond_y is None else uncond_y.float())

    def range_plan(self, image: torch.Tensor, spec: UpscaleSpec, seed: int,
                   context: torch.Tensor, uncond_context: torch.Tensor,
                   y: Optional[torch.Tensor] = None,
                   uncond_y: Optional[torch.Tensor] = None,
                   tiles_per_device: Optional[int] = None,
                   first_index: int = 0,
                   noise: Optional[torch.Tensor] = None,
                   spatial_cond: Optional[torch.Tensor] = None,
                   control_hint: Optional[torch.Tensor] = None,
                   step_noise: Optional[Callable[[int], torch.Tensor]] = None
                   ) -> TileRangePlan:
        """Resize one [H, W, C] image and cut its crops once; the plan's
        ``run_range(start, end)`` img2imgs tiles [start, end) in chunks
        of ``chunk`` and returns them as fp32 numpy [end − start, ch, cw, C].

        Tile i's noise is drawn from ``tile_seed(seed, first_index + i)``
        (``upscale`` numbers the tiles of a batch across its images), or
        taken from ``noise[i]`` ([T, h, w, C_lat]) where given; so is
        draw j of a stochastic sampler (``step_noise`` of that tile seed),
        or row i of ``step_noise(j)`` ([T, h, w, C_lat]) where given. A range
        wider than the chunk loops over sub-chunks, so a task sized by
        another host's chunk still runs; only the padding differs.

        ``spatial_cond`` [H', W'] or [H', W', 1] (1 = denoise) is resized
        to the output grid (bilinear) and cropped per tile like the
        image; padded tiles get ones. ``control_hint`` [h, w, C] is this
        image's hint, already at the output size × ``8 // vae.downscale``
        (``upscale`` resizes it), cropped with the scaled grid; padded
        tiles get zeros. The farm passes no hint, as the JAX package's
        does."""
        dev = self.device
        H, W, _ = image.shape
        grid = self.grid_for(H, W, spec)
        T = grid.num_tiles
        if tiles_per_device is None:
            tiles_per_device = self.tiles_per_device_default(spec.tile_w,
                                                             spec.tile_h)
        chunk = max(1, min(tiles_per_device, T))
        sigmas = make_sigma_ladder(spec.generation_spec(),
                                   self.pipeline.schedule).to(dev)
        y, uncond_y = self._conditioning(y, uncond_y)
        up = upscale_image(image[None].to(dev), spec.scale,
                           spec.resize_method)[0]
        all_tiles = extract_tiles(up, grid)              # [T, ch, cw, C]
        all_stiles = all_htiles = None
        if spatial_cond is not None:
            smap = spatial_cond.to(dev).float()
            if smap.ndim == 2:
                smap = smap[..., None]
            if tuple(smap.shape[:2]) != (grid.image_h, grid.image_w):
                smap = resize_to(smap[None], grid.image_h, grid.image_w,
                                 "bilinear")[0]
            all_stiles = extract_tiles(smap, grid)
        if control_hint is not None:
            all_htiles = extract_tiles(control_hint.to(dev).float(),
                                       self.hint_grid(grid))
        ds = self.pipeline.vae.config.downscale
        latent_shape = (grid.crop_h // ds, grid.crop_w // ds,
                        self.pipeline.latent_channels)

        def tile_noise(i: int) -> torch.Tensor:
            if noise is not None and i < T:
                return noise[i].to(dev, torch.float32)
            gen = seed_generator(tile_seed(seed, first_index + i), dev)
            return torch.randn(latent_shape, generator=gen,
                               dtype=torch.float32, device=dev)

        def padded(tiles: Optional[torch.Tensor], start: int, end: int,
                   fill: float) -> Optional[torch.Tensor]:
            if tiles is None:
                return None
            seg = tiles[start:end]
            if seg.shape[0] < chunk:
                seg = torch.cat([seg, seg.new_full(
                    (chunk - seg.shape[0],) + seg.shape[1:], fill)])
            return seg

        def chunk_step_noise(start: int, end: int):
            if step_noise is None:
                return stacked_step_noise(
                    [tile_seed(seed, first_index + i)
                     for i in range(start, start + chunk)], dev)

            def draw(j: int, shape: tuple) -> torch.Tensor:
                rows = step_noise(j)[start:end].to(dev, torch.float32)
                return torch.cat([rows, rows.new_zeros(
                    (shape[0] - rows.shape[0],) + rows.shape[1:])])

            return draw

        def run_one(start: int, end: int) -> np.ndarray:
            nz = torch.stack([tile_noise(i) for i in range(start, start + chunk)])
            out = self._img2img_tiles(
                padded(all_tiles, start, end, 0.0), nz, context,
                uncond_context, y, uncond_y, spec, sigmas,
                tile_masks=padded(all_stiles, start, end, 1.0),
                hint_tiles=padded(all_htiles, start, end, 0.0),
                sampler_noise=chunk_step_noise(start, end))
            return out[:end - start].float().cpu().numpy()

        def run_range(start: int, end: int) -> np.ndarray:
            if start >= end:
                return np.zeros((0,) + tuple(all_tiles.shape[1:]), np.float32)
            return np.concatenate([run_one(s, min(s + chunk, end))
                                   for s in range(start, end, chunk)])

        def source_range(start: int, end: int) -> np.ndarray:
            return all_tiles[start:end].float().cpu().numpy()

        return TileRangePlan(grid=grid, chunk=chunk, run_range=run_range,
                             feather=spec.feather, source_range=source_range)

    def hint_grid(self, grid: TileGrid) -> TileGrid:
        """The image grid in the hint stem's space (latent resolution ×
        8), so that each hint crop aligns with its image crop."""
        hf = HINT_DOWNSCALE // self.pipeline.vae.config.downscale
        return compute_tile_grid(grid.image_w * hf, grid.image_h * hf,
                                 grid.tile_w * hf, grid.tile_h * hf,
                                 grid.padding * hf)

    def tile_hints(self, control_hint: Optional[torch.Tensor], grid: TileGrid,
                   batch: int) -> Optional[torch.Tensor]:
        """A [1 or B, h, w, C] control map resized (bilinear, per image)
        to the output size × ``8 // vae.downscale`` and expanded to the
        batch, for ``range_plan``; None without a hint or without a
        ControlNet on the pipeline (the hint is then ignored, as in the
        JAX package)."""
        if control_hint is None or self.pipeline._control is None:
            return None
        hb = control_hint.shape[0]
        if hb not in (1, batch):
            raise ValueError(f"control hint batch {hb} incompatible with "
                             f"image batch {batch} (must be 1 or {batch})")
        hg = self.hint_grid(grid)
        control_hint = control_hint.to(self.device).float()
        if tuple(control_hint.shape[1:3]) != (hg.image_h, hg.image_w):
            control_hint = resize_to(control_hint, hg.image_h, hg.image_w,
                                     "bilinear")
        return control_hint.expand(batch, *control_hint.shape[1:])

    def composite(self, tiles, plan: TileRangePlan) -> torch.Tensor:
        """Blend a complete [T, ch, cw, C] tile set into the [H, W, C]
        output image on the device."""
        t0 = time.perf_counter()
        tiles = torch.as_tensor(np.asarray(tiles, np.float32)).to(self.device)
        masks = feather_mask(plan.grid, plan.feather, device=self.device)
        out = composite_tiles(tiles, masks, plan.grid)
        self.pipeline._sync()
        self.pipeline.timings["composite_s"] = time.perf_counter() - t0
        return out

    def upscale(self, images: torch.Tensor, spec: UpscaleSpec, seed: int,
                context: torch.Tensor, uncond_context: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                uncond_y: Optional[torch.Tensor] = None,
                tiles_per_device: Optional[int] = None,
                noise: Optional[torch.Tensor] = None,
                spatial_cond: Optional[torch.Tensor] = None,
                control_hint: Optional[torch.Tensor] = None,
                step_noise: Optional[Callable[[int], torch.Tensor]] = None
                ) -> torch.Tensor:
        """[B, H, W, C] → [B, H·s, W·s, C] in [0, 1] on the device: each
        image's plan run over its whole range, then composited. Tiles are
        numbered across the batch (image b's first is b·T), as in the JAX
        package's single program. ``noise``: [B·T, h, w, C_lat];
        ``step_noise(j)``: the sampler's draw j, [B·T, h, w, C_lat].
        ``spatial_cond``: [B, H, W, 1] (input size) or [B, H·s, W·s, 1]
        (output size) region mask. ``control_hint``: [1 or B, h, w, C]
        control map for a ``with_control`` pipeline's ControlNet, resized
        (bilinear, per image) to the output size × ``8 // vae.downscale``;
        without a ControlNet it is ignored, as in the JAX package."""
        B, H, W, _ = images.shape
        grid = self.grid_for(H, W, spec)
        T = grid.num_tiles
        if spatial_cond is not None:
            spatial_cond = spatial_cond.to(self.device).float()
            spatial_cond = spatial_cond.expand(B, *spatial_cond.shape[1:])
        control_hint = self.tile_hints(control_hint, grid, B)
        outs = []
        for b in range(B):
            plan = self.range_plan(
                images[b], spec, seed, context, uncond_context, y, uncond_y,
                tiles_per_device=tiles_per_device, first_index=b * T,
                noise=None if noise is None else noise[b * T:(b + 1) * T],
                spatial_cond=None if spatial_cond is None else spatial_cond[b],
                control_hint=None if control_hint is None else control_hint[b],
                step_noise=None if step_noise is None else (
                    lambda j, b=b: step_noise(j)[b * T:(b + 1) * T]))
            outs.append(self.composite(plan.run_range(0, plan.num_tiles), plan))
        return torch.stack(outs)
