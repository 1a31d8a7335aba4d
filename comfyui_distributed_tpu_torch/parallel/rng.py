"""Seed → ``torch.Generator``.

Counterpart of ``comfyui_distributed_tpu/parallel/rng.py``. The JAX
package folds the participant index into a threefry key; the port draws
with PyTorch's own generator, so the same seed gives other numbers than
JAX (a documented divergence — tests feed both sides the same noise).
Only participant 0 (the single-device "master") exists in this port.
The tile engine draws each tile's noise from a generator of its own
(``tile_seed``).
"""

from __future__ import annotations

import hashlib

import torch


def seed_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (participant 0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return gen


def tile_seed(seed: int, index: int) -> int:
    """The seed of global tile ``index`` of a job seeded ``seed``: a hash
    of both, so that neighbouring seeds and indices draw unrelated noise
    and which host or batch runs a tile never changes its noise."""
    digest = hashlib.sha256(f"cdt-tile:{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little")
