"""AutoencoderKL (counterpart of the JAX ``models/vae.py``): the decoder
of the txt2img paths and the encoder of the tile img2img engine.

The single-head mid attention of both halves is a plain matmul+softmax,
as in the JAX model (XLA runs it there; no Pallas kernel). NHWC at the
public boundary.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import torch_dtype
from .layers import GroupNorm32


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    scaling_factor: float = 0.13025      # SDXL VAE
    shift_factor: float = 0.0
    dtype: str = "bfloat16"

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls, dtype: str = "bfloat16") -> "VAEConfig":
        """2× downscale toy VAE for tests (8× in real configs)."""
        return cls(base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                   scaling_factor=1.0, dtype=dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.channel_mult) - 1)


_VAE_EPS = 1e-6     # LDM's AutoencoderKL GroupNorm epsilon (UNet: 1e-5)


class _VAEResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(in_channels, epsilon=_VAE_EPS)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        self.GroupNorm32_1 = GroupNorm32(out_channels, epsilon=_VAE_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        self.skip = (nn.Conv2d(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.GroupNorm32_0(x)))
        h = self.conv2(F.silu(self.GroupNorm32_1(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class _VAEAttention(nn.Module):
    """LDM AttnBlock: single-head attention with biased q/k/v/out; logits
    and softmax in fp32, probabilities rounded to the operand dtype."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.to_q = nn.Linear(channels, channels, dtype=dtype)
        self.to_k = nn.Linear(channels, channels, dtype=dtype)
        self.to_v = nn.Linear(channels, channels, dtype=dtype)
        self.to_out = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        C = h.shape[-1]
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) / (C ** 0.5)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return self.to_out(torch.matmul(p, v))


class _MidBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.res1 = _VAEResBlock(channels, channels, dtype)
        self.GroupNorm32_0 = GroupNorm32(channels, epsilon=_VAE_EPS)
        self.attn = _VAEAttention(channels, dtype)
        self.res2 = _VAEResBlock(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.res1(x)
        B, C, H, W = x.shape
        h = self.GroupNorm32_0(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.attn(h)
        x = x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.res2(x)


class Encoder(nn.Module):
    """Pixels [B,H,W,3] in ~[-1,1] → moments [B,h,w,2·C_lat] (mean ⊕
    logvar)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.torch_dtype
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.base_channels, 3,
                                 padding=1, dtype=dt)
        ch = cfg.base_channels
        for level, mult in enumerate(cfg.channel_mult):
            out = cfg.base_channels * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}",
                                _VAEResBlock(ch, out, dt))
                ch = out
            if level < len(cfg.channel_mult) - 1:
                self.add_module(f"down_{level}_ds",
                                nn.Conv2d(ch, ch, 3, stride=2, dtype=dt))
        self.mid = _MidBlock(ch, dt)
        self.norm_out = GroupNorm32(ch, epsilon=_VAE_EPS)
        # fp32 compute sites, as in the JAX model
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1,
                                  dtype=torch.float32)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1,
                                    dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.conv_in(x.permute(0, 3, 1, 2).to(cfg.torch_dtype))
        for level in range(len(cfg.channel_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h)
            if level < len(cfg.channel_mult) - 1:
                # LDM's asymmetric (0, 1) padding before the stride-2 conv
                h = getattr(self, f"down_{level}_ds")(F.pad(h, (0, 1, 0, 1)))
        h = F.silu(self.norm_out(self.mid(h)))
        h = self.quant_conv(self.conv_out(h.float()))
        return h.permute(0, 2, 3, 1)


class Decoder(nn.Module):
    """Scaled-back latent z [B,h,w,C_lat] → pixels [B,H,W,3] in ~[-1,1]."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.torch_dtype
        # fp32 compute sites, as in the JAX model
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1,
                                         dtype=torch.float32)
        ch = cfg.base_channels * cfg.channel_mult[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1,
                                 dtype=dt)
        self.mid = _MidBlock(ch, dt)
        for level in reversed(range(len(cfg.channel_mult))):
            out = cfg.base_channels * cfg.channel_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_res_{i}",
                                _VAEResBlock(ch, out, dt))
                ch = out
            if level > 0:
                self.add_module(f"up_{level}_us",
                                nn.Conv2d(ch, ch, 3, padding=1, dtype=dt))
        self.norm_out = GroupNorm32(ch, epsilon=_VAE_EPS)
        self.conv_out = nn.Conv2d(ch, cfg.in_channels, 3, padding=1,
                                  dtype=torch.float32)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.post_quant_conv(z.float().permute(0, 3, 1, 2))
        h = self.mid(self.conv_in(h.to(cfg.torch_dtype)))
        for level in reversed(range(len(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_res_{i}")(h)
            if level > 0:
                h = getattr(self, f"up_{level}_us")(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        h = F.silu(self.norm_out(h))
        return self.conv_out(h.float()).permute(0, 2, 3, 1)


class AutoencoderKL(nn.Module):
    """Decoder, and with ``encoder=True`` the encoder, with the
    scaling-factor handling: ``encode`` maps [-1, 1] pixels to scaled
    latents (the posterior's mean: inference never samples it),
    ``decode`` maps scaled latents back to [-1, 1] pixels.

    The encoder is registered after the decoder, so a seeded random
    init draws the decoder's weights whether or not it builds one."""

    def __init__(self, config: VAEConfig, encoder: bool = False):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.encoder = Encoder(config) if encoder else None

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        if self.encoder is None:
            raise RuntimeError("this AutoencoderKL was built without an encoder")
        mean = self.encoder(images)[..., :self.config.latent_channels]
        return (mean - self.config.shift_factor) * self.config.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(latents / self.config.scaling_factor
                            + self.config.shift_factor)
