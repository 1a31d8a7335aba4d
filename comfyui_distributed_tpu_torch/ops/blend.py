"""Feathered-mask tile compositing (counterpart of the JAX ``ops/blend.py``).

Each tile gets a feathered weight mask (1 inside its core cell, a
smoothstep ramp to 0 across the padding ring) and the canvas is the
weight-normalised sum of all tiles, accumulated in tile order. Every
pixel lies in some tile's core (weight 1), so the denominator is at
least 1, and the result does not depend on which host made which tile.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

if TYPE_CHECKING:  # no runtime cycle with the tiles package
    from ..tiles.grid import TileGrid


def _ramp(n: int, start_inside: int, width: int, ascending: bool) -> np.ndarray:
    """1-D smoothstep ramp of length ``n``: reaches 1 at ``start_inside``
    (from either the left or the right edge) over ``width`` pixels."""
    idx = np.arange(n, dtype=np.float32)
    d = idx - (start_inside - width) if ascending else (start_inside + width - 1) - idx
    t = np.clip(d / max(width, 1), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def feather_mask(grid: "TileGrid", feather: Optional[int] = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-tile weight masks [T, crop_h, crop_w, 1] (fp32).

    Weight 1 over the tile's core cell, smoothstepping to 0 across
    ``feather`` pixels of the padding ring (default: the grid padding).
    Crop edges on the image border keep weight 1: nothing to blend with.
    """
    f = grid.padding if feather is None else feather
    masks = np.zeros((grid.num_tiles, grid.crop_h, grid.crop_w), np.float32)
    for i, reg in enumerate(grid.regions):
        wx = np.ones(grid.crop_w, np.float32)
        if reg.x0 > 0:  # the crop's left edge is interior: ramp up into the core
            wx *= _ramp(grid.crop_w, reg.core_x0, f, ascending=True)
        if reg.x0 + grid.crop_w < grid.image_w:
            wx *= _ramp(grid.crop_w, reg.core_x0 + reg.core_w - 1, f, ascending=False)
        wy = np.ones(grid.crop_h, np.float32)
        if reg.y0 > 0:
            wy *= _ramp(grid.crop_h, reg.core_y0, f, ascending=True)
        if reg.y0 + grid.crop_h < grid.image_h:
            wy *= _ramp(grid.crop_h, reg.core_y0 + reg.core_h - 1, f, ascending=False)
        masks[i] = wy[:, None] * wx[None, :]
    return torch.from_numpy(masks[..., None]).to(device)


def composite_tiles(tiles: torch.Tensor,     # [T, crop_h, crop_w, C]
                    masks: torch.Tensor,     # [T, crop_h, crop_w, 1]
                    grid: "TileGrid") -> torch.Tensor:
    """Weight-normalised sum of the tiles on the [H, W, C] canvas, added
    in tile order at each tile's origin, on the tiles' device."""
    C = tiles.shape[-1]
    canvas = torch.zeros((grid.image_h, grid.image_w, C), dtype=tiles.dtype,
                         device=tiles.device)
    weight = torch.zeros((grid.image_h, grid.image_w, 1), dtype=tiles.dtype,
                         device=tiles.device)
    masks = masks.to(device=tiles.device, dtype=tiles.dtype)
    for i, reg in enumerate(grid.regions):
        ys = slice(reg.y0, reg.y0 + grid.crop_h)
        xs = slice(reg.x0, reg.x0 + grid.crop_w)
        canvas[ys, xs].add_(tiles[i] * masks[i])
        weight[ys, xs].add_(masks[i])
    return canvas / torch.clamp(weight, min=1e-8)


def extract_tiles(image: torch.Tensor, grid: "TileGrid") -> torch.Tensor:
    """All crops of one [H, W, C] image → [T, crop_h, crop_w, C]."""
    return torch.stack([
        image[reg.y0:reg.y0 + grid.crop_h, reg.x0:reg.x0 + grid.crop_w]
        for reg in grid.regions], dim=0)
