"""Seed → ``torch.Generator``.

Counterpart of ``comfyui_distributed_tpu/parallel/rng.py``. The JAX
package folds the participant index into a threefry key; the port draws
with PyTorch's own generator, so the same seed gives other numbers than
JAX (a documented divergence — tests feed both sides the same noise).
Participant 0 (the master, mesh coordinate 0 along ``dp``) draws from
``seed`` itself, so a one-rank mesh is bitwise the one-device run;
participant i > 0 draws from a hash of (seed, i) (``participant_seed``),
the counterpart of JAX's ``fold_in(key, i)``. The tile engine draws each tile's noise from a generator of its own
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


def participant_seed(seed: int, index: int) -> int:
    """The seed participant ``index`` of a mesh run seeded ``seed`` draws
    from: ``seed`` itself for participant 0, else a hash of both."""
    return int(seed) if index == 0 else _hash_seed("participant", seed, index)


def participant_seeds(seed: int, n: int) -> list[int]:
    """The reference's visible seed list for UIs and logs (master =
    seed, worker N = seed + N + 1); sampling uses ``participant_seed``."""
    return [seed] + [seed + i + 1 for i in range(n - 1)]


def tile_seed(seed: int, index: int) -> int:
    """The seed of global tile ``index`` of a job seeded ``seed``: a hash
    of both, so that neighbouring seeds and indices draw unrelated noise
    and which host or batch runs a tile never changes its noise."""
    return _hash_seed("tile", seed, index)


def expert_seed(seed: int, expert: int) -> int:
    """The seed of a dual-expert bundle's expert ``expert`` (1: the
    low-noise one) drawn at random init from ``seed`` (JAX folds 1 into
    the model key)."""
    return _hash_seed("expert", seed, expert)


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
