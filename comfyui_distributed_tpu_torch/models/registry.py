"""Named model registry: checkpoint name → assembled stack (counterpart of
the JAX ``models/registry.py``).

The port has no checkpoint loading yet: every bundle is random-initialised
from a seed, drawn on its device in the preset's dtype with flax's default
distributions (``layers.flax_init_``), or filled from a JAX parameter
tree with ``ModelBundle.load_from_jax``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Mapping

import torch
from torch import nn

from ..diffusion.pipeline import Txt2ImgPipeline
from ..parallel.rng import seed_generator
from ..utils.device import DeviceLike, resolve_device
from ..utils.exceptions import ValidationError
from ..utils.logging import log
from .from_jax import load_from_jax
from .layers import flax_init_
from .text import TextEncoder, TextEncoderConfig, TextTransformer
from .unet import UNet2D, UNetConfig
from .vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    unet: UNetConfig
    vae: VAEConfig
    text: TextEncoderConfig


PRESETS: dict[str, ModelPreset] = {
    "sdxl": ModelPreset("sdxl", UNetConfig.sdxl(), VAEConfig.sdxl(),
                        TextEncoderConfig()),
    "tiny": ModelPreset("tiny", UNetConfig.tiny(), VAEConfig.tiny(),
                        TextEncoderConfig.tiny()),
}


def _random(build: Callable[[], nn.Module], device: torch.device,
            generator: torch.Generator) -> nn.Module:
    """Build ``module`` without allocating, then allocate it on ``device``
    and draw its weights there."""
    with torch.device("meta"):
        module = build()
    module = module.to_empty(device=device)
    flax_init_(module, generator)
    return module.eval().requires_grad_(False)


class ModelBundle:
    """Loaded stack: txt2img pipeline (UNet + VAE decoder) and text encoder."""

    def __init__(self, preset: ModelPreset, device: DeviceLike = None,
                 seed: int = 0):
        self.preset = preset
        self.device = resolve_device(device)
        gen = seed_generator(seed, self.device)
        self.text_encoder = TextEncoder(
            _random(lambda: TextTransformer(preset.text), self.device, gen))
        unet = _random(lambda: UNet2D(preset.unet), self.device, gen)
        vae = _random(lambda: AutoencoderKL(preset.vae), self.device, gen)
        self.pipeline = Txt2ImgPipeline(unet, vae)

    def load_from_jax(self, unet: Mapping, vae_dec: Mapping,
                      text: Mapping) -> "ModelBundle":
        """Replace the weights with the JAX package's trees (UNet params,
        VAE decoder params, text-encoder params)."""
        load_from_jax(self.pipeline.unet, unet)
        load_from_jax(self.pipeline.vae.decoder, vae_dec)
        load_from_jax(self.text_encoder.module, text)
        return self


class ModelRegistry:
    """Bundles by preset name, built on first use on one device."""

    def __init__(self, device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        self.seed = int(seed)
        self._cache: dict[str, ModelBundle] = {}
        self._lock = threading.Lock()

    def available(self) -> list[str]:
        return sorted(PRESETS)

    def get(self, name: str) -> ModelBundle:
        with self._lock:
            if name not in self._cache:
                preset = PRESETS.get(name)
                if preset is None:
                    raise ValidationError(
                        f"unknown model {name!r}; have {self.available()}")
                self._cache[name] = ModelBundle(preset, self.device, self.seed)
                log(f"built {name} on {self.device} (random init, "
                    f"seed {self.seed})")
            return self._cache[name]
