"""Static tile-grid math (the port's copy of the JAX ``tiles/grid.py``).

An origin-anchored ``ceil(H/th) × ceil(W/tw)`` grid of padded crops, all
of one size, so that a batch of tiles is one tensor shape. Near the image
borders a crop's origin shifts inward (it is not shrunk): border tiles
overlap their neighbours more, and the normalized blend
(``ops/blend.py``) makes overlap harmless. Host-side Python over ints.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TileRegion:
    """One tile: crop rect (uniform size) + its core rect in crop coords."""

    x0: int                 # crop origin in image coords
    y0: int
    core_x0: int            # core (unpadded cell) origin within the crop
    core_y0: int
    core_w: int
    core_h: int


@dataclasses.dataclass(frozen=True)
class TileGrid:
    image_w: int
    image_h: int
    tile_w: int
    tile_h: int
    padding: int
    crop_w: int             # uniform crop width  (tile_w + 2·padding, clamped)
    crop_h: int
    cols: int
    rows: int
    regions: tuple[TileRegion, ...]

    @property
    def num_tiles(self) -> int:
        return self.cols * self.rows


def compute_tile_grid(
    image_w: int, image_h: int, tile_w: int, tile_h: int, padding: int = 32
) -> TileGrid:
    """Build the static grid: ``ceil`` cell counts; every crop is exactly
    ``(crop_h, crop_w)`` and lies fully inside the image."""
    cols = max(1, math.ceil(image_w / tile_w))
    rows = max(1, math.ceil(image_h / tile_h))
    crop_w = min(image_w, tile_w + 2 * padding)
    crop_h = min(image_h, tile_h + 2 * padding)

    regions = []
    for r in range(rows):
        for c in range(cols):
            cell_x0 = c * tile_w
            cell_y0 = r * tile_h
            cell_w = min(tile_w, image_w - cell_x0)
            cell_h = min(tile_h, image_h - cell_y0)
            # padded crop, shifted inward to stay in bounds
            x0 = min(max(cell_x0 - padding, 0), image_w - crop_w)
            y0 = min(max(cell_y0 - padding, 0), image_h - crop_h)
            regions.append(
                TileRegion(
                    x0=x0,
                    y0=y0,
                    core_x0=cell_x0 - x0,
                    core_y0=cell_y0 - y0,
                    core_w=cell_w,
                    core_h=cell_h,
                )
            )
    return TileGrid(
        image_w=image_w,
        image_h=image_h,
        tile_w=tile_w,
        tile_h=tile_h,
        padding=padding,
        crop_w=crop_w,
        crop_h=crop_h,
        cols=cols,
        rows=rows,
        regions=tuple(regions),
    )


def pad_count_to(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple`` (the padded tile
    count of a fixed-size batch)."""
    if multiple <= 0:
        return n
    return ((n + multiple - 1) // multiple) * multiple
