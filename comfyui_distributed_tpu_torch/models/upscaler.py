"""RRDBNet (ESRGAN-family) learned upscaler (counterpart of the JAX
``models/upscaler.py``).

The standard RRDBNet topology that published ESRGAN and Real-ESRGAN
checkpoints map onto. Convolutions run in the config's dtype (bf16 for
the presets) and the last one in fp32, as in the JAX model. ×2 and ×1
checkpoints put a pixel-unshuffle stem (torch's channel order) in front
of the 4× trunk. NHWC at the public boundary, NCHW inside. Published
``.safetensors`` weights (both ESRGAN layouts) load through
``models/convert.load_upscaler_checkpoint``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import torch_dtype


@dataclasses.dataclass(frozen=True)
class UpscalerConfig:
    scale: int = 4                    # output scale of the checkpoint
    in_channels: int = 3
    out_channels: int = 3
    num_feat: int = 64
    num_block: int = 23
    grow_ch: int = 32
    dtype: str = "bfloat16"

    @classmethod
    def esrgan_x4(cls) -> "UpscalerConfig":
        return cls()

    @classmethod
    def realesrgan_x2(cls) -> "UpscalerConfig":
        # ×2 models keep the 4× trunk behind a pixel-unshuffle stem
        return cls(scale=2)

    @classmethod
    def tiny(cls, scale: int = 2, dtype: str = "bfloat16") -> "UpscalerConfig":
        return cls(scale=scale, num_feat=8, num_block=2, grow_ch=4, dtype=dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def unshuffle(self) -> int:
        """The stem's pixel-unshuffle factor (1: none)."""
        return {4: 1, 2: 2, 1: 4}[self.scale]


PRESETS = {
    "esrgan-x4": UpscalerConfig.esrgan_x4(),
    "realesrgan-x2": UpscalerConfig.realesrgan_x2(),
    "tiny-x2": UpscalerConfig.tiny(scale=2),
    "tiny-x4": UpscalerConfig.tiny(scale=4),
}


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(cin: int, cout: int, dtype: torch.dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, dtype=dtype)


class _DenseBlock(nn.Module):
    """Residual dense block: 5 convs, each seeing all prior features."""

    def __init__(self, num_feat: int, grow_ch: int, dtype: torch.dtype):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}",
                            _conv(num_feat + i * grow_ch, grow_ch, dtype))
        self.conv5 = _conv(num_feat + 4 * grow_ch, num_feat, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(getattr(self, f"conv{i + 1}")(
                torch.cat(feats, dim=1))))
        return x + 0.2 * self.conv5(torch.cat(feats, dim=1))


class _RRDB(nn.Module):
    def __init__(self, num_feat: int, grow_ch: int, dtype: torch.dtype):
        super().__init__()
        self.rdb1 = _DenseBlock(num_feat, grow_ch, dtype)
        self.rdb2 = _DenseBlock(num_feat, grow_ch, dtype)
        self.rdb3 = _DenseBlock(num_feat, grow_ch, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """[B,H,W,3] in [0,1] → [B,H·s,W·s,3] in [0,1] (fp32)."""

    def __init__(self, config: UpscalerConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.torch_dtype
        f = cfg.unshuffle
        self.conv_first = _conv(cfg.in_channels * f * f, cfg.num_feat, dt)
        for i in range(cfg.num_block):
            self.add_module(f"body_{i}", _RRDB(cfg.num_feat, cfg.grow_ch, dt))
        self.conv_body = _conv(cfg.num_feat, cfg.num_feat, dt)
        self.conv_up1 = _conv(cfg.num_feat, cfg.num_feat, dt)
        self.conv_up2 = _conv(cfg.num_feat, cfg.num_feat, dt)
        self.conv_hr = _conv(cfg.num_feat, cfg.num_feat, dt)
        self.conv_last = _conv(cfg.num_feat, cfg.out_channels, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = x.permute(0, 3, 1, 2).to(cfg.torch_dtype)
        if cfg.unshuffle > 1:
            # torch's channel order c·f² + fy·f + fx, which checkpoints use
            h = F.pixel_unshuffle(h, cfg.unshuffle)
        feat = self.conv_first(h)
        body = feat
        for i in range(cfg.num_block):
            body = getattr(self, f"body_{i}")(body)
        feat = feat + self.conv_body(body)
        # the trunk is always 4×: two nearest-neighbour ×2 hops
        feat = _lrelu(self.conv_up1(F.interpolate(feat, scale_factor=2,
                                                  mode="nearest")))
        feat = _lrelu(self.conv_up2(F.interpolate(feat, scale_factor=2,
                                                  mode="nearest")))
        out = self.conv_last(_lrelu(self.conv_hr(feat)).float())
        return torch.clamp(out, 0.0, 1.0).permute(0, 2, 3, 1)


class UpscalerBundle:
    """Module and the checkpoint's scale, as they flow through the graph
    from ``UpscaleModelLoader`` to ``ImageUpscaleWithModel``."""

    def __init__(self, model: RRDBNet, name: str = "upscaler"):
        self.model = model
        self.name = name
        self.timings: dict = {}     # the last tiled upscale's

    @property
    def scale(self) -> int:
        return self.model.config.scale

    @property
    def device(self) -> torch.device:
        return self.model.conv_first.weight.device

    @torch.no_grad()
    def apply(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images.to(self.device))
