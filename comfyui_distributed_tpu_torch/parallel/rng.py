"""Seed → ``torch.Generator``.

Counterpart of ``comfyui_distributed_tpu/parallel/rng.py``. The JAX
package folds the participant index into a threefry key; the port draws
with PyTorch's own generator, so the same seed gives other numbers than
JAX (a documented divergence — tests feed both sides the same noise).
Only participant 0 (the single-device "master") exists in this port.
The tile engine draws each tile's noise from a generator of its own
(``tile_seed``). A stochastic sampler's draw ``j`` comes from a generator
seeded from (seed, j) alone (``step_noise``), the counterpart of JAX's
``normal(fold_in(key, j))``: a draw never depends on how many were made
before it.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Sequence

import torch


def seed_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (participant 0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return gen


def _hash_seed(kind: str, seed: int, index: int) -> int:
    digest = hashlib.sha256(f"cdt-{kind}:{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def tile_seed(seed: int, index: int) -> int:
    """The seed of global tile ``index`` of a job seeded ``seed``: a hash
    of both, so that neighbouring seeds and indices draw unrelated noise
    and which host or batch runs a tile never changes its noise."""
    return _hash_seed("tile", seed, index)


def step_seed(seed: int, draw: int) -> int:
    """The seed of a stochastic sampler's draw ``draw`` in a run seeded
    ``seed`` (a hash of both, unrelated to ``seed``'s own generator)."""
    return _hash_seed("step", seed, draw)


# noise(j, shape) -> unit normal fp32 noise of draw j
NoiseSource = Callable[[int, tuple], torch.Tensor]


def step_noise(seed: int, device: torch.device) -> NoiseSource:
    """A sampler's noise source: draw ``j`` is unit normal fp32 noise of
    the requested shape on ``device`` from a generator seeded
    ``step_seed(seed, j)``."""

    def draw(j: int, shape: tuple) -> torch.Tensor:
        return torch.randn(tuple(shape),
                           generator=seed_generator(step_seed(seed, j), device),
                           dtype=torch.float32, device=device)

    return draw


def stacked_step_noise(seeds: Sequence[int],
                       device: torch.device) -> NoiseSource:
    """The noise source of a batch whose row ``r`` is its own run seeded
    ``seeds[r]`` (the tile engine's chunk of tiles): draw ``j`` stacks each
    row's draw ``j`` of ``shape[1:]``, so a row's noise does not depend on
    the rows it is batched with."""
    rows = [step_noise(seed, device) for seed in seeds]

    def draw(j: int, shape: tuple) -> torch.Tensor:
        if shape[0] != len(rows):
            raise ValueError(f"noise for {len(rows)} rows, asked for "
                             f"shape {tuple(shape)}")
        return torch.stack([row(j, tuple(shape[1:])) for row in rows])

    return draw
