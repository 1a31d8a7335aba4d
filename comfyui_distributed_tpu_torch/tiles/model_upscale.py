"""Tiled application of a learned upscaler (counterpart of the JAX
``tiles/model_upscale.py``).

The JAX package shards the tile batch over its mesh in one SPMD program;
on one card the tiles go through the model in fixed-size batches, the
last one padded with zero tiles, so every batch has one shape. The
output composite reuses the static-grid machinery at ×s coordinates with
a feather of ``max(1, padding·s // 2)``.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from ..ops.blend import composite_tiles, extract_tiles, feather_mask
from .grid import compute_tile_grid, pad_count_to

TILE_BATCH = 4      # tiles per model call


@torch.no_grad()
def tiled_model_upscale(bundle, images: torch.Tensor, tile: int = 256,
                        padding: int = 16) -> torch.Tensor:
    """Upscale [B, H, W, C] images in [0, 1] by the bundle's scale →
    [B, H·s, W·s, C] fp32 on the bundle's device.

    Deterministic and invariant to ``TILE_BATCH`` up to the round-off of
    the batch shape: tiles are composited in grid order whichever batch
    computed them. The bundle's ``timings`` get the call's seconds (host
    clock around work that ends in a device synchronise)."""
    t0 = time.perf_counter()
    images = images.to(bundle.device, torch.float32)
    B, H, W, _ = images.shape
    s = bundle.scale
    # ×2/×1 checkpoints run a pixel-unshuffle stem: every crop dimension
    # must divide by the unshuffle factor, so align the geometry and
    # edge-pad the image, cropping the output back at the end
    f = bundle.model.config.unshuffle
    tile = max(f, (tile // f) * f)
    padding = (padding // f) * f
    pad_h, pad_w = (-H) % f, (-W) % f
    if pad_h or pad_w:
        images = F.pad(images.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                       mode="replicate").permute(0, 2, 3, 1)
    Hp, Wp = images.shape[1:3]
    grid = compute_tile_grid(Wp, Hp, tile, tile, padding)
    out_grid = compute_tile_grid(Wp * s, Hp * s, tile * s, tile * s,
                                 padding * s)
    assert out_grid.num_tiles == grid.num_tiles
    masks = feather_mask(out_grid, feather=max(1, (padding * s) // 2),
                         device=images.device)

    tile_batch = TILE_BATCH
    tiles = torch.cat([extract_tiles(images[b], grid) for b in range(B)])
    total = tiles.shape[0]
    padded = pad_count_to(total, tile_batch)
    if padded > total:
        tiles = torch.cat([tiles, tiles.new_zeros(
            (padded - total,) + tiles.shape[1:])])
    done = torch.cat([bundle.apply(tiles[i:i + tile_batch])
                      for i in range(0, padded, tile_batch)])[:total]
    T = grid.num_tiles
    out = torch.stack([composite_tiles(done[b * T:(b + 1) * T], masks,
                                       out_grid) for b in range(B)])
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    bundle.timings = {"seconds": time.perf_counter() - t0, "tiles": total,
                      "tile_batch": tile_batch}
    return out[:, :H * s, :W * s, :]
