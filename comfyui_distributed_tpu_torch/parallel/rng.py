"""Seed → ``torch.Generator``.

Counterpart of ``comfyui_distributed_tpu/parallel/rng.py``. The JAX
package folds the participant index into a threefry key; the port draws
with PyTorch's own generator, so the same seed gives other numbers than
JAX (a documented divergence — tests feed both sides the same noise).
Only participant 0 (the single-device "master") exists in this port.
"""

from __future__ import annotations

import torch


def seed_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (participant 0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    return gen
