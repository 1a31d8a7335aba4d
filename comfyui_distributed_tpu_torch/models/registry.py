"""Named model registry: checkpoint name → assembled stack (counterpart of
the JAX ``models/registry.py``).

The port has no checkpoint loading yet: every bundle is random-initialised
from a seed, drawn on its device in the preset's dtype with flax's default
distributions (``layers.flax_init_``), or filled from a JAX parameter
tree with ``ModelBundle.load_from_jax``.

One departure from flax is deliberate: the JAX DiT zero-initialises its
adaLN ``mod`` kernels and ``img_out``, so a randomly initialised JAX DiT
has every gate at 0, every block is the identity and the velocity is
exactly 0. The port draws those Linears lecun-normal like every other,
so that a random-init FLUX image depends on every block and on its
attention kernel.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from ..diffusion.pipeline import Txt2ImgPipeline
from ..diffusion.pipeline_flow import FlowPipeline
from ..parallel.rng import seed_generator
from ..utils.device import DeviceLike, resolve_device
from ..utils.exceptions import ValidationError
from ..utils.logging import log
from .controlnet import PRESETS as CONTROLNET_PRESETS
from .controlnet import ControlNetBundle, init_controlnet
from .dit import DiT, DiTConfig
from .from_jax import load_from_jax
from .layers import flax_init_
from .text import TextEncoder, TextEncoderConfig, TextTransformer
from .unet import UNet2D, UNetConfig
from .upscaler import PRESETS as UPSCALER_PRESETS
from .upscaler import RRDBNet, UpscalerBundle
from .vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    unet: Optional[UNetConfig]
    vae: VAEConfig
    text: TextEncoderConfig
    dit: Optional[DiTConfig] = None       # flow (FLUX-class) models

    @property
    def kind(self) -> str:
        return "dit" if self.dit is not None else "unet"


PRESETS: dict[str, ModelPreset] = {
    "sdxl": ModelPreset("sdxl", UNetConfig.sdxl(), VAEConfig.sdxl(),
                        TextEncoderConfig()),
    # SD 1.5 at its published widths, with the hash-tokenised text encoder
    # at CLIP-L's width (768); no ADM
    "sd15": ModelPreset("sd15", UNetConfig.sd15(),
                        VAEConfig(scaling_factor=0.18215),
                        TextEncoderConfig(output_dim=768, pooled_dim=768)),
    "tiny": ModelPreset("tiny", UNetConfig.tiny(), VAEConfig.tiny(),
                        TextEncoderConfig.tiny()),
    # FLUX.1 at full width with the hash-tokenised text encoder at T5's
    # width (4096) and CLIP-L's pooled width (768); 16-channel VAE
    "flux": ModelPreset(
        "flux", None,
        VAEConfig(latent_channels=16, scaling_factor=0.3611,
                  shift_factor=0.1159),
        TextEncoderConfig(output_dim=4096, pooled_dim=768),
        dit=DiTConfig.flux()),
    "flux-tiny": ModelPreset("flux-tiny", None, VAEConfig.tiny(),
                             TextEncoderConfig.tiny(), dit=DiTConfig.tiny()),
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
    """Loaded stack: the pipeline (UNet or DiT, and the VAE) and the text
    encoder. A UNet bundle's VAE has its encoder too (the tile img2img
    engine encodes); a DiT bundle's has the decoder only."""

    def __init__(self, preset: ModelPreset, device: DeviceLike = None,
                 seed: int = 0):
        self.preset = preset
        self.device = resolve_device(device)
        gen = seed_generator(seed, self.device)
        self.text_encoder = TextEncoder(
            _random(lambda: TextTransformer(preset.text), self.device, gen))
        flow = preset.kind == "dit"
        core = _random(lambda: DiT(preset.dit) if flow else UNet2D(preset.unet),
                       self.device, gen)
        vae = _random(lambda: AutoencoderKL(preset.vae, encoder=not flow),
                      self.device, gen)
        self.pipeline = (FlowPipeline if flow else Txt2ImgPipeline)(core, vae)

    @property
    def core(self) -> nn.Module:
        """The denoiser: the UNet, or the DiT of a flow model."""
        return (self.pipeline.dit if self.preset.kind == "dit"
                else self.pipeline.unet)

    def load_from_jax(self, core: Mapping, vae_dec: Mapping,
                      text: Mapping,
                      vae_enc: Optional[Mapping] = None) -> "ModelBundle":
        """Replace the weights with the JAX package's trees (UNet or DiT
        params, VAE decoder params, text-encoder params and, where given,
        the VAE encoder params; without them an encoder keeps its
        weights)."""
        load_from_jax(self.core, core)
        load_from_jax(self.pipeline.vae.decoder, vae_dec)
        load_from_jax(self.text_encoder.module, text)
        if vae_enc is not None:
            if self.pipeline.vae.encoder is None:
                raise ValueError(f"the {self.preset.name} bundle has no "
                                 "VAE encoder to carry vae_enc into")
            load_from_jax(self.pipeline.vae.encoder, vae_enc)
        return self


class ModelRegistry:
    """Bundles by preset name, built on first use on one device; the
    upscalers (``get_upscaler``) and ControlNets (``get_controlnet``)
    beside them, drawn from the same seed, so that every controller of a
    cluster builds the same weights."""

    CONTROLNETS_KEPT = 4

    def __init__(self, device: DeviceLike = None, seed: int = 0):
        self.device = resolve_device(device)
        self.seed = int(seed)
        self._cache: dict[str, ModelBundle] = {}
        self._upscalers: dict[str, UpscalerBundle] = {}
        self._controlnets: dict[str, ControlNetBundle] = {}
        self._lock = threading.Lock()

    def get_upscaler(self, name: str) -> UpscalerBundle:
        """The RRDBNet preset ``name``, random-initialised on first use."""
        with self._lock:
            if name not in self._upscalers:
                config = UPSCALER_PRESETS.get(name)
                if config is None:
                    raise ValidationError(
                        f"unknown upscale model {name!r}; have "
                        f"{sorted(UPSCALER_PRESETS)}", field="model_name")
                model = _random(lambda: RRDBNet(config), self.device,
                                seed_generator(self.seed, self.device))
                self._upscalers[name] = UpscalerBundle(model, name)
                log(f"built upscaler {name} on {self.device} (random init, "
                    f"seed {self.seed})")
            return self._upscalers[name]

    def get_controlnet(self, name: str) -> ControlNetBundle:
        """The ControlNet preset ``name`` (``tiny``, ``sdxl``),
        random-initialised on first use; the registry keeps at most
        ``CONTROLNETS_KEPT``, dropping the oldest."""
        with self._lock:
            if name not in self._controlnets:
                config = CONTROLNET_PRESETS.get(name)
                if config is None:
                    raise ValidationError(
                        f"unknown control net {name!r}; have "
                        f"{sorted(CONTROLNET_PRESETS)}",
                        field="control_net_name")
                if len(self._controlnets) >= self.CONTROLNETS_KEPT:
                    self._controlnets.pop(next(iter(self._controlnets)))
                t0 = time.perf_counter()
                self._controlnets[name] = init_controlnet(
                    config, self.device, self.seed, name=name)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                log(f"built controlnet {name} on {self.device} in "
                    f"{time.perf_counter() - t0:.2f} s (random init, "
                    f"seed {self.seed})")
            return self._controlnets[name]

    def available(self) -> list[str]:
        return sorted(PRESETS)

    def get(self, name: str) -> ModelBundle:
        with self._lock:
            if name not in self._cache:
                preset = PRESETS.get(name)
                if preset is None:
                    raise ValidationError(
                        f"unknown model {name!r}; have {self.available()}")
                t0 = time.perf_counter()
                self._cache[name] = ModelBundle(preset, self.device, self.seed)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                log(f"built {name} on {self.device} in "
                    f"{time.perf_counter() - t0:.2f} s (random init, "
                    f"seed {self.seed})")
            return self._cache[name]
