"""ControlNet, LDM ``cldm`` architecture (counterpart of the JAX
``models/controlnet.py``).

A copy of the UNet's encoder and middle (``models/unet.py``), an 8-conv
hint stem (image-resolution hint → latent resolution, three stride-2
convs), one 1×1 conv per skip connection (``zero_{i}``) and one on the
middle state (``mid_out``). It returns residuals the UNet adds to its
skips and middle state (``UNet2D.forward(..., control=)``), NCHW like the
UNet's skips. The attention sites are the UNet's own blocks, so they go
through the same ``ops/attention.py`` dispatch (on the card, K1 for
SDXL's self-attention and K2 for its cross-attention; the one-head
kernel for every SD 1.5 site).

Attribute names follow the JAX parameter tree (``time_1``, ``hint_{j}``,
``conv_in``, ``zero_{i}``, ``down_{l}_res_{i}``, ``mid_out``, …), so
``models/from_jax.py`` carries a JAX ``ControlNet``'s params by path.
Compute types are JAX's: the trunk runs in the config's dtype, the zero
convs and ``mid_out`` in fp32 with fp32 parameters.

One departure from flax is deliberate: flax draws the zero convs and
``mid_out`` as zeros, so a random-init ControlNet returns zeros and
control would change nothing. The port draws them lecun-normal scaled by
``ZERO_CONV_SCALE`` (0.1), so the residuals stay about a tenth of the
skips they are added to and a random-init image depends on the control
path and its attention kernels.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.rng import seed_generator
from ..utils.device import DeviceLike, resolve_device
from .layers import (Downsample, ResBlock, SpatialTransformer, flax_init_,
                     timestep_embedding)
from .unet import UNetConfig

# hint-stem channel ladder (published cldm: 16,16,32,32,96,96,256 → model_ch)
_HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)
_HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2)
HINT_DOWNSCALE = 8          # three stride-2 convs

# scale of the lecun-normal draw of the zero convs and mid_out
ZERO_CONV_SCALE = 0.1

# random-init presets
PRESETS = {"tiny": UNetConfig.tiny(), "sd15": UNetConfig.sd15(),
           "sdxl": UNetConfig.sdxl()}


class ZeroConv(nn.Conv2d):
    """A 1×1 convolution with fp32 parameters and compute (the JAX
    ``zero_{i}``/``mid_out``), drawn small instead of zero at random
    init."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """Runs after ``flax_init_`` drew the lecun-normal kernel."""
        self.weight.mul_(ZERO_CONV_SCALE)


class ControlNet(nn.Module):
    """x[B,h,w,C], t[B], context, y, hint[B,H,W,3] → (skip residuals,
    mid residual), fp32 NCHW."""

    def __init__(self, config: UNetConfig, hint_channels: int = 3):
        super().__init__()
        self.config = cfg = config
        self.hint_channels = hint_channels
        dt = cfg.torch_dtype
        mc = cfg.model_channels
        time_dim = mc * 4

        def attn(ch: int, depth: int) -> SpatialTransformer:
            return SpatialTransformer(ch, cfg.heads_for(ch), depth,
                                      cfg.context_dim, dt)

        self.time_1 = nn.Linear(mc, time_dim, dtype=dt)
        self.time_2 = nn.Linear(time_dim, time_dim, dtype=dt)
        if cfg.adm_in_channels:
            self.label_1 = nn.Linear(cfg.adm_in_channels, time_dim, dtype=dt)
            self.label_2 = nn.Linear(time_dim, time_dim, dtype=dt)
        cin = hint_channels
        for j, (ch, stride) in enumerate(zip(_HINT_CHANNELS, _HINT_STRIDES)):
            self.add_module(f"hint_{j}", nn.Conv2d(cin, ch, 3, stride=stride,
                                                   padding=1, dtype=dt))
            cin = ch
        self.add_module(f"hint_{len(_HINT_CHANNELS)}",
                        nn.Conv2d(cin, mc, 3, padding=1, dtype=dt))
        self.conv_in = nn.Conv2d(cfg.in_channels, mc, 3, padding=1, dtype=dt)
        self.zero_0 = ZeroConv(mc)
        zi, cur = 1, mc
        last = len(cfg.channel_mult) - 1
        for level, mult in enumerate(cfg.channel_mult):
            ch = mc * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}",
                                ResBlock(cur, ch, time_dim, dt))
                cur = ch
                if cfg.transformer_depth[level]:
                    self.add_module(f"down_{level}_attn_{i}",
                                    attn(ch, cfg.transformer_depth[level]))
                self.add_module(f"zero_{zi}", ZeroConv(ch))
                zi += 1
            if level < last:
                self.add_module(f"down_{level}_ds", Downsample(cur, ch, dt))
                self.add_module(f"zero_{zi}", ZeroConv(ch))
                zi += 1
        mid = mc * cfg.channel_mult[-1]
        self.mid_res_1 = ResBlock(cur, mid, time_dim, dt)
        if cfg.mid_depth:
            self.mid_attn = attn(mid, cfg.mid_depth)
        self.mid_res_2 = ResBlock(mid, mid, time_dim, dt)
        self.mid_out = ZeroConv(mid)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor], y: Optional[torch.Tensor],
                hint: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        cfg = self.config
        dt = cfg.torch_dtype
        if hint.shape[-1] != self.hint_channels:
            raise ValueError(f"hint has {hint.shape[-1]} channels, module "
                             f"expects {self.hint_channels}")
        emb = self.time_1(timestep_embedding(t, cfg.model_channels).to(dt))
        emb = self.time_2(F.silu(emb))
        if cfg.adm_in_channels:
            if y is None:
                raise ValueError("config.adm_in_channels set but y not given")
            emb = emb + self.label_2(F.silu(self.label_1(y.to(dt))))
        if context is not None:
            context = context.to(dt)

        def block(name: str):
            return getattr(self, name)

        # hint stem: image-resolution control map → latent-resolution features
        g = hint.to(dt).permute(0, 3, 1, 2)
        for j in range(len(_HINT_CHANNELS)):
            g = F.silu(block(f"hint_{j}")(g))
        g = block(f"hint_{len(_HINT_CHANNELS)}")(g)

        h = self.conv_in(x.to(dt).permute(0, 3, 1, 2)) + g
        outs = [self.zero_0(h)]
        zi = 1
        last = len(cfg.channel_mult) - 1
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = block(f"down_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level]:
                    h = block(f"down_{level}_attn_{i}")(h, context)
                outs.append(block(f"zero_{zi}")(h))
                zi += 1
            if level < last:
                h = block(f"down_{level}_ds")(h)
                outs.append(block(f"zero_{zi}")(h))
                zi += 1
        h = self.mid_res_1(h, emb)
        if cfg.mid_depth:
            h = self.mid_attn(h, context)
        h = self.mid_res_2(h, emb)
        return outs, self.mid_out(h)


_uid_counter = itertools.count()


@dataclasses.dataclass
class ControlNetBundle:
    """Module and the conditioning payload contract: a conditioning
    entry carries ``{"model": bundle, "hint": [B,H,W,3], "strength":
    float}`` under its ``"control"`` key (``ControlNetApply``).

    ``uid`` is process-unique, for the pipelines' control clones
    (``id()`` is recycled after garbage collection)."""

    model: ControlNet
    name: str = "controlnet"
    uid: int = dataclasses.field(default_factory=_uid_counter.__next__)

    @property
    def device(self) -> torch.device:
        return self.model.conv_in.weight.device


def init_controlnet(config: UNetConfig, device: DeviceLike = None,
                    seed: int = 0, hint_channels: int = 3,
                    name: str = "controlnet") -> ControlNetBundle:
    """A random-init ControlNet on ``device`` (``cuda`` unless the caller
    asks for the CPU), drawn from ``seed`` with flax's distributions
    (``layers.flax_init_``) and the zero convs scaled as the module
    docstring says."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = ControlNet(config, hint_channels=hint_channels)
    model = model.to_empty(device=device)
    flax_init_(model, seed_generator(seed, device))
    return ControlNetBundle(model.eval().requires_grad_(False), name=name)
