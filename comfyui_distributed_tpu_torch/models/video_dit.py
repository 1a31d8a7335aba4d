"""The generic MMDiT over frames (``video-mmdit``) and the 4n+1 frame rule
(counterpart of the JAX ``models/video_dit.py``).

A latent video [B, F, h, w, C] is patchified per frame (p×p spatial,
temporal patch 1), tokens frame-major, with an axial 3-D sinusoidal
position table (time, row, column) added; the blocks are the image DiT's
double and single blocks (``models/dit.py``) without RoPE, over the
joint ``[text, video]`` sequence. At ``VideoDiTConfig.wan()``'s width
(hidden 5120, 40 heads of 128) every joint-attention site takes the
one-head ``[B·H, N, D]`` kernel.

Attribute names follow the JAX parameter tree (``img_in``, ``txt_in``,
``t_in``, ``pool_in``, ``vec_mlp``, ``double_{i}``, ``single_{i}``,
``final_mod``, ``img_out``). As for FLUX (``models/registry.py``), the
port's random init draws the adaLN ``mod`` kernels and ``img_out``
lecun-normal where flax draws zeros. The sequence-parallel branch is not
ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import torch_dtype
from .dit import (DiTConfig, DoubleBlock, Modulation, SingleBlock,
                  _layer_norm, _modulate)
from .layers import timestep_embedding


def pad_frames_4n1(frames: int) -> int:
    """The smallest 4n+1 ≥ ``frames`` (the video models' frame rule)."""
    if frames <= 1:
        return 1
    return ((frames - 2) // 4 + 1) * 4 + 1


def validate_frames_4n1(frames: int) -> bool:
    return frames >= 1 and (frames - 1) % 4 == 0


@dataclasses.dataclass(frozen=True)
class VideoDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    hidden: int = 5120
    depth_double: int = 20
    depth_single: int = 20
    heads: int = 40
    context_dim: int = 4096
    pooled_dim: int = 768
    dtype: str = "bfloat16"

    @classmethod
    def wan(cls) -> "VideoDiTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VideoDiTConfig":
        return cls(patch_size=2, in_channels=4, hidden=64, depth_double=1,
                   depth_single=1, heads=4, context_dim=32, pooled_dim=16)

    def as_dit_config(self) -> DiTConfig:
        return DiTConfig(
            patch_size=self.patch_size, in_channels=self.in_channels,
            hidden=self.hidden, depth_double=self.depth_double,
            depth_single=self.depth_single, heads=self.heads,
            context_dim=self.context_dim, pooled_dim=self.pooled_dim,
            guidance_embed=False, dtype=self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def patchify_video(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, F, H, W, C] → [B, F·(H/p)·(W/p), p·p·C], frame-major."""
    B, Fr, H, W, C = x.shape
    x = x.reshape(B, Fr, H // p, p, W // p, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(B, Fr * (H // p) * (W // p), p * p * C)


def unpatchify_video(tokens: torch.Tensor, fhw: tuple[int, int, int], p: int,
                     c: int) -> torch.Tensor:
    Fr, H, W = fhw
    x = tokens.reshape(tokens.shape[0], Fr, H // p, W // p, p, p, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(-1, Fr, H, W, c)


def sincos_3d(f: int, h: int, w: int, dim: int,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Axial 3-D position table [f·h·w, dim] in fp32: a quarter of the
    width for time, the rest split between rows and columns."""
    def axis_table(n, d):
        pos = torch.arange(n, dtype=torch.float32, device=device)
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(d // 2, dtype=torch.float32,
                                         device=device) / max(d // 2, 1))
        args = pos[:, None] * freqs[None]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)

    dt_ = dim // 4
    dh = (dim - dt_) // 2
    dw = dim - dt_ - dh
    return torch.cat([
        axis_table(f, dt_).repeat_interleave(h * w, dim=0),
        axis_table(h, dh).repeat_interleave(w, dim=0).repeat(f, 1),
        axis_table(w, dw).repeat(f * h, 1),
    ], dim=-1)


class VideoDiT(nn.Module):
    """x [B, F, h, w, C], t [B], context [B, T, ctx], pooled [B, P] →
    velocity [B, F, h, w, C] (fp32)."""

    def __init__(self, config: VideoDiTConfig):
        super().__init__()
        self.config = cfg = config
        dcfg = cfg.as_dit_config()
        dt, H, p = cfg.torch_dtype, cfg.hidden, cfg.patch_size
        self.img_in = nn.Linear(p * p * cfg.in_channels, H, dtype=dt)
        self.txt_in = nn.Linear(cfg.context_dim, H, dtype=dt)
        self.t_in = nn.Linear(256, H, dtype=dt)
        self.pool_in = nn.Linear(cfg.pooled_dim, H, dtype=dt)
        self.vec_mlp = nn.Linear(H, H, dtype=dt)
        for i in range(cfg.depth_double):
            self.add_module(f"double_{i}", DoubleBlock(dcfg))
        for i in range(cfg.depth_single):
            self.add_module(f"single_{i}", SingleBlock(dcfg))
        self.final_mod = Modulation(1, H, dt)
        # fp32 compute site, as in the JAX model
        self.img_out = nn.Linear(H, p * p * cfg.in_channels,
                                 dtype=torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                pooled: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt, p = cfg.torch_dtype, cfg.patch_size
        B, Fr, H, W, C = x.shape
        img = self.img_in(patchify_video(x.to(dt), p))
        img = img + sincos_3d(Fr, H // p, W // p, cfg.hidden,
                              x.device)[None].to(dt)
        txt = self.txt_in(context.to(dt))
        vec = self.t_in(timestep_embedding(t * 1000.0, 256).to(dt))
        vec = vec + self.pool_in(pooled.to(dt))
        vec = self.vec_mlp(F.silu(vec))
        for i in range(cfg.depth_double):
            img, txt = getattr(self, f"double_{i}")(img, txt, vec)
        T = txt.shape[1]
        xcat = torch.cat([txt, img], dim=1)
        for i in range(cfg.depth_single):
            xcat = getattr(self, f"single_{i}")(xcat, vec)
        img = xcat[:, T:]
        sh, sc, _ = self.final_mod(vec)
        img = _modulate(_layer_norm(img), sh, sc)
        out = self.img_out(img.float())
        return unpatchify_video(out, (Fr, H, W), p, C)
