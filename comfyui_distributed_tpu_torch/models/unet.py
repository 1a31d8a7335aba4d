"""SDXL-class latent UNet (counterpart of the JAX ``models/unet.py``).

``UNetConfig.sdxl()`` is SDXL-base's shape (320·[1,2,4], transformer
depths [0,2,10], ctx 2048, adm 2816); ``UNetConfig.sd15()`` SD 1.5's
(320·[1,2,4,4], one transformer block at each of the first three levels,
8 heads, ctx 768, no adm) as the JAX package's preset gives it: a
conv-only fourth level and no middle transformer; ``UNetConfig.tiny()``
a 2-level toy for tests.

The middle transformer's depth is ``middle_depth`` where it is set, else
JAX's rule, the last level's ``transformer_depth``. A published SD 1.5
file has a middle transformer of depth 1 (1280 channels, 8 heads of
160) under the conv-only fourth level: the registry reads it from the
file (``convert.middle_depth_of``) and builds that core, a departure
from the JAX preset, which cannot load such a file. The public
forward takes and returns NHWC like the JAX model; inside it runs NCHW. ``forward(..., control=)`` takes a ControlNet's
residuals (``models/controlnet.py``) in that NCHW layout.

A latent side need not be a multiple of 2 per downsampling: each
upsampling goes to the size of the skip it meets, as ComfyUI's UNet
does, so a 816² tile (latent 102: 51 and 26 below) runs. The JAX UNet
upsamples 2× and its concatenation fails there (26 → 52 against 51).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import torch_dtype
from .layers import (Downsample, GroupNorm32, ResBlock, SpatialTransformer,
                     Upsample, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    transformer_depth: tuple[int, ...] = (0, 2, 10)
    num_heads: int = -1            # -1: derive from head_dim
    head_dim: int = 64
    context_dim: int = 2048
    adm_in_channels: int = 0       # SDXL: 2816 (pooled text + size conds)
    dtype: str = "bfloat16"
    middle_depth: int = -1         # -1: transformer_depth[-1] (JAX's rule)

    @classmethod
    def sdxl(cls) -> "UNetConfig":
        return cls(adm_in_channels=2816)

    @classmethod
    def sd15(cls) -> "UNetConfig":
        """8 heads everywhere: head widths 40, 80 and 160."""
        return cls(channel_mult=(1, 2, 4, 4), transformer_depth=(1, 1, 1, 0),
                   context_dim=768, head_dim=-1, num_heads=8)

    @classmethod
    def tiny(cls, dtype: str = "bfloat16") -> "UNetConfig":
        return cls(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                   transformer_depth=(0, 1), context_dim=32, head_dim=16,
                   adm_in_channels=8, dtype=dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def mid_depth(self) -> int:
        """Transformer blocks in the middle block (0: two res blocks)."""
        return (self.transformer_depth[-1] if self.middle_depth < 0
                else self.middle_depth)

    def heads_for(self, channels: int) -> int:
        if self.num_heads > 0:
            return self.num_heads
        return max(1, channels // self.head_dim)


class UNet2D(nn.Module):
    """Latent UNet: x[B,H,W,C_in], t[B], context[B,N,ctx], y[B,adm] → eps."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
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
        self.conv_in = nn.Conv2d(cfg.in_channels, mc, 3, padding=1, dtype=dt)
        skips = [mc]
        cur = mc
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
                skips.append(ch)
            if level < last:
                self.add_module(f"down_{level}_ds", Downsample(cur, ch, dt))
                skips.append(ch)
        mid = mc * cfg.channel_mult[-1]
        self.mid_res_1 = ResBlock(cur, mid, time_dim, dt)
        if cfg.mid_depth:
            self.mid_attn = attn(mid, cfg.mid_depth)
        self.mid_res_2 = ResBlock(mid, mid, time_dim, dt)
        cur = mid
        for level in reversed(range(len(cfg.channel_mult))):
            ch = mc * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_res_{i}",
                                ResBlock(cur + skips.pop(), ch, time_dim, dt))
                cur = ch
                if cfg.transformer_depth[level]:
                    self.add_module(f"up_{level}_attn_{i}",
                                    attn(ch, cfg.transformer_depth[level]))
            if level > 0:
                self.add_module(f"up_{level}_us", Upsample(ch, ch, dt))
        self.norm_out = GroupNorm32(cur)
        # fp32 compute site, as in the JAX model
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1,
                                  dtype=torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None,
                control: Optional[tuple] = None) -> torch.Tensor:
        """``control``: optional ``(down_residuals, mid_residual)`` from a
        ControlNet, one residual per skip in push order plus one for the
        middle state (LDM ``cldm`` semantics), each NCHW like the skips:
        the only NHWC↔NCHW transposes are this forward's first and last,
        and the ControlNet's hint and ``x`` on entry."""
        cfg = self.config
        dt = cfg.torch_dtype
        emb = self.time_1(timestep_embedding(t, cfg.model_channels).to(dt))
        emb = self.time_2(F.silu(emb))
        if cfg.adm_in_channels:
            if y is None:
                raise ValueError("config.adm_in_channels set but y not given")
            yemb = self.label_2(F.silu(self.label_1(y.to(dt))))
            emb = emb + yemb
        if context is not None:
            context = context.to(dt)

        def block(name: str):
            return getattr(self, name, None)

        h = self.conv_in(x.to(dt).permute(0, 3, 1, 2))
        skips = [h]
        last = len(cfg.channel_mult) - 1
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = block(f"down_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level]:
                    h = block(f"down_{level}_attn_{i}")(h, context)
                skips.append(h)
            if level < last:
                h = block(f"down_{level}_ds")(h)
                skips.append(h)
        h = self.mid_res_1(h, emb)
        if cfg.mid_depth:
            h = self.mid_attn(h, context)
        h = self.mid_res_2(h, emb)
        if control is not None:
            down_res, mid_res = control
            assert len(down_res) == len(skips), (
                f"control carries {len(down_res)} skip residuals, "
                f"UNet has {len(skips)}")
            h = h + mid_res.to(h.dtype)
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_res)]
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = block(f"up_{level}_res_{i}")(h, emb)
                if cfg.transformer_depth[level]:
                    h = block(f"up_{level}_attn_{i}")(h, context)
            if level > 0:
                # to the size of the skip it meets next, as ComfyUI's UNet
                # does: a latent side that is not a multiple of 8 (a
                # 816² tile: 102 → 51 → 26) comes back as 26 → 51
                h = block(f"up_{level}_us")(h, skips[-1].shape[-2:])
        h = F.silu(self.norm_out(h))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)
