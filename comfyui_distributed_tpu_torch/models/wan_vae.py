"""WAN-geometry 3D causal video VAE (counterpart of the JAX
``models/wan_vae.py``).

Video compresses 4× in time and 8× in space through a causal 3D conv
stack: ``T`` pixel frames ↔ ``(T − 1)/4 + 1`` latent frames, the first
frame compressed alone (a single image is a 1-frame video):

- causal 3D convolutions: time padded at the front only, with copies of
  the first frame (no future leaks in), space zero-padded to its size;
- channel RMS norms, SiLU residual blocks, single-head spatial attention
  over each frame in the bottleneck (an XLA einsum in the JAX package,
  so plain PyTorch here: no kernel, no fused attention);
- temporal downsampling by a stride-2 causal conv (``ceil(T/2)``),
  upsampling by a frame-pair expansion less the leading duplicate
  (``2T − 1``).

``WanVAE3D`` has ``encode``/``decode`` over ``[B, T, H, W, C]`` (a rank-4
input is one frame) and ``decode_tiled``: the decoder's head (up to the
mid blocks, with the global spatial attention) runs whole-frame at latent
resolution, the upsampling tail runs on overlapping spatial tiles that
are blended with the JAX package's feathers (``_tile_starts``,
``_pair_feathers``, ``_axis_ramp``, copied exactly): the seams are part
of the output. Inside, tensors are ``[B, C, T, H, W]``; a 2D convolution
over each frame is a Conv3d with a 1-frame kernel.

Attribute names follow the JAX parameter tree (``conv_in.conv``,
``down_{level}_res_{i}``, ``mid_attn.qkv``, ``up_{level}_us.time.conv``,
``quant``, ``post_quant``). Published WAN VAE weights are not read by
either package (their streaming-cache forward has other chunk
semantics).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import torch_dtype


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    in_channels: int = 3
    latent_channels: int = 16
    base_dim: int = 96
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # one per downsampling transition: True adds stride-2 temporal
    # compression to that spatial downsample
    temporal_downsample: tuple[bool, ...] = (False, True, True)
    scaling_factor: float = 1.0
    dtype: str = "float32"

    @classmethod
    def wan(cls, dtype: str = "bfloat16") -> "WanVAEConfig":
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls, **kw) -> "WanVAEConfig":
        base = dict(latent_channels=4, base_dim=16, dim_mult=(1, 2),
                    num_res_blocks=1, temporal_downsample=(True,))
        base.update(kw)
        return cls(**base)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)

    @property
    def temporal_downscale(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def latent_frames(self, frames: int) -> int:
        """4n+1 pixel frames → n+1 latent frames."""
        return (frames - 1) // self.temporal_downscale + 1

    def pixel_frames(self, latent_frames: int) -> int:
        return (latent_frames - 1) * self.temporal_downscale + 1


def _tile_starts(full: int, t: int, step: int) -> list[int]:
    """Tile starts from the origin, the last clamped to ``full - t``."""
    if full <= t:
        return [0]
    out = list(range(0, full - t, step)) + [full - t]
    return sorted(set(out))


def _pair_feathers(starts_list: list[int], t: int):
    """Each tile's (lo, hi) feather widths in latent units: the actual
    overlap with each neighbour (the clamped last tile overlaps more)."""
    ovs = [starts_list[i - 1] + t - starts_list[i]
           for i in range(1, len(starts_list))]
    return [0] + ovs, ovs + [0]


def _axis_ramp(n_lat: int, lo_o: int, hi_o: int, *, scale: int) -> np.ndarray:
    """Per-pixel weight along one axis of a decoded tile; the two ramps
    multiply."""
    n = n_lat * scale
    wgt = np.ones((n,), np.float32)
    o = min(lo_o, n_lat) * scale
    if o:
        wgt[:o] *= np.linspace(1.0 / (o + 1), 1.0, o, dtype=np.float32)
    o = min(hi_o, n_lat) * scale
    if o:
        wgt[-o:] *= np.linspace(1.0, 1.0 / (o + 1), o, dtype=np.float32)
    return wgt


def _pad_time_causal(x: torch.Tensor, n: int) -> torch.Tensor:
    """Front-pad the frame axis (dim 2) with ``n`` copies of frame 0."""
    if n == 0:
        return x
    return torch.cat([x[:, :, :1].expand(-1, -1, n, -1, -1), x], dim=2)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear over the channel axis of ``[B, C, T, H, W]``."""
    return layer(x.movedim(1, -1)).movedim(-1, 1)


class CausalConv3d(nn.Module):
    """Causal (front-padded) in time, zero-padded to size in space."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3, 3),
                 time_stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.time_stride = tuple(kernel), time_stride
        self.conv = nn.Conv3d(in_ch, out_ch, self.kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kh, kw = self.kernel
        return F.conv3d(_pad_time_causal(x, kt - 1), self.conv.weight,
                        self.conv.bias, stride=(self.time_stride, 1, 1),
                        padding=(0, kh // 2, kw // 2))


class ChannelRMSNorm(nn.Module):
    """The channel axis L2-normalised × √C × a learned gamma, in fp32."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels, dtype=torch.float32))

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        xf = x.float()
        n = xf * torch.rsqrt((xf * xf).sum(1, keepdim=True) + 1e-12)
        return ((n * (c ** 0.5)).to(x.dtype)
                * self.gamma.to(x.dtype).view(1, c, 1, 1, 1))


class ResBlock3d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = ChannelRMSNorm(in_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, dtype=dtype)
        self.norm2 = ChannelRMSNorm(out_ch)
        self.conv2 = CausalConv3d(out_ch, out_ch, dtype=dtype)
        self.skip = (nn.Linear(in_ch, out_ch, dtype=dtype)
                     if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = _dense(self.skip, x)
        return x + h


class SpatialAttention(nn.Module):
    """Single-head self-attention over each frame's pixels: logits,
    softmax and P·V in the operand dtype, as the JAX einsums compute
    them."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.norm = ChannelRMSNorm(channels)
        self.qkv = nn.Linear(channels, 3 * channels, dtype=dtype)
        self.proj = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C)
        q, k, v = self.qkv(h).chunk(3, dim=-1)
        s = torch.einsum("bqc,bkc->bqk", q, k) / (C ** 0.5)
        out = torch.einsum("bqk,bkc->bqc", torch.softmax(s, dim=-1), v)
        out = self.proj(out).view(B, T, H, W, C).permute(0, 4, 1, 2, 3)
        return x + out


class _Downsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temporal: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.space = nn.Conv2d(in_ch, out_ch, 3, dtype=dtype)
        self.time = (nn.Conv3d(out_ch, out_ch, (2, 1, 1), dtype=dtype)
                     if temporal else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # each frame: zero-pad bottom/right, stride-2 3×3 conv (WAN's)
        h = F.conv3d(F.pad(x, (0, 1, 0, 1)), self.space.weight[:, :, None],
                     self.space.bias, stride=(1, 2, 2))
        if self.time is not None:
            # stride-2 causal conv: T → ceil(T/2), frame 0 kept alone
            h = F.conv3d(_pad_time_causal(h, 1), self.time.weight,
                         self.time.bias, stride=(2, 1, 1))
        return h


class _Upsample(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temporal: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.time = (CausalConv3d(in_ch, 2 * in_ch, (3, 1, 1), dtype=dtype)
                     if temporal else None)
        self.space = nn.Conv2d(in_ch, out_ch, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.time is not None:
            # each latent frame expands to a frame pair, the leading
            # duplicate dropped: T → 2T − 1
            B, C, T, H, W = x.shape
            h = self.time(x).view(B, 2, C, T, H, W).permute(0, 2, 3, 1, 4, 5)
            x = h.reshape(B, C, 2 * T, H, W)[:, :, 1:]
        x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        return F.conv3d(x, self.space.weight[:, :, None], self.space.bias,
                        padding=(0, 1, 1))


class WanVAEEncoder(nn.Module):
    """[B, C, T, H, W] pixels → [B, T', h, w, 2·latent] moments (fp32,
    channels last)."""

    def __init__(self, config: WanVAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.torch_dtype
        dims = [cfg.base_dim * m for m in cfg.dim_mult]
        self.conv_in = CausalConv3d(cfg.in_channels, dims[0], dtype=dt)
        prev = dims[0]
        for level, dim in enumerate(dims):
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_res_{i}",
                                ResBlock3d(prev, dim, dt))
                prev = dim
            if level < len(dims) - 1:
                self.add_module(f"down_{level}_ds", _Downsample(
                    dim, dims[level + 1], cfg.temporal_downsample[level], dt))
                prev = dims[level + 1]
        self.mid_res1 = ResBlock3d(prev, dims[-1], dt)
        self.mid_attn = SpatialAttention(dims[-1], dt)
        self.mid_res2 = ResBlock3d(dims[-1], dims[-1], dt)
        self.norm_out = ChannelRMSNorm(dims[-1])
        self.conv_out = CausalConv3d(dims[-1], cfg.latent_channels * 2,
                                     dtype=dt)
        self.quant = nn.Linear(cfg.latent_channels * 2,
                               cfg.latent_channels * 2, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = self.conv_in(x.to(cfg.torch_dtype))
        for level in range(len(cfg.dim_mult)):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_res_{i}")(h)
            if level < len(cfg.dim_mult) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
        h = self.mid_res2(self.mid_attn(self.mid_res1(h)))
        h = self.conv_out(F.silu(self.norm_out(h)))
        return self.quant(h.movedim(1, -1).float())


class WanVAEDecoder(nn.Module):
    """``stage`` splits the decoder for the tiled decode: ``"head"`` (the
    post-quant projection, conv_in and the mid blocks, with the global
    spatial attention, at latent resolution) and ``"tail"`` (the
    upsampling stack and the output conv: local convolutions only);
    ``"all"`` runs both. Head input: [B, T, h, w, latent] scaled latents;
    head output and tail input: [B, C, T, h, w]; tail output: [B, C, T',
    H, W] fp32."""

    def __init__(self, config: WanVAEConfig):
        super().__init__()
        self.config = cfg = config
        dt = cfg.torch_dtype
        dims = [cfg.base_dim * m for m in cfg.dim_mult]
        self.post_quant = nn.Linear(cfg.latent_channels, cfg.latent_channels,
                                    dtype=torch.float32)
        self.conv_in = CausalConv3d(cfg.latent_channels, dims[-1], dtype=dt)
        self.mid_res1 = ResBlock3d(dims[-1], dims[-1], dt)
        self.mid_attn = SpatialAttention(dims[-1], dt)
        self.mid_res2 = ResBlock3d(dims[-1], dims[-1], dt)
        prev = dims[-1]
        for level in reversed(range(len(dims))):
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_res_{i}",
                                ResBlock3d(prev, dims[level], dt))
                prev = dims[level]
            if level > 0:
                self.add_module(f"up_{level}_us", _Upsample(
                    prev, dims[level - 1], cfg.temporal_downsample[level - 1],
                    dt))
                prev = dims[level - 1]
        self.norm_out = ChannelRMSNorm(dims[0])
        self.conv_out = CausalConv3d(dims[0], cfg.in_channels, dtype=dt)

    def forward(self, z: torch.Tensor, stage: str = "all") -> torch.Tensor:
        cfg = self.config
        dt = cfg.torch_dtype
        h = z
        if stage in ("all", "head"):
            zq = self.post_quant(z.float()).movedim(-1, 1)
            h = self.conv_in(zq.to(dt))
            h = self.mid_res2(self.mid_attn(self.mid_res1(h)))
            if stage == "head":
                return h
        h = h.to(dt)
        for level in reversed(range(len(cfg.dim_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_res_{i}")(h)
            if level > 0:
                h = getattr(self, f"up_{level}_us")(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return h.float()


class WanVAE3D(nn.Module):
    """Encoder and decoder over videos [B, T, H, W, C] (channels last at
    the boundary), the interface of ``AutoencoderKL``: ``encode`` maps
    [-1, 1] pixels to scaled latents (the moments' mean), ``decode`` and
    ``decode_tiled`` map them back (fp32)."""

    def __init__(self, config: WanVAEConfig):
        super().__init__()
        self.config = config
        self.encoder = WanVAEEncoder(config)
        self.decoder = WanVAEDecoder(config)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        single = video.ndim == 4
        if single:
            video = video[:, None]
        moments = self.encoder(video.permute(0, 4, 1, 2, 3))
        lat = moments[..., :self.config.latent_channels] \
            * self.config.scaling_factor
        return lat[:, 0] if single else lat

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        single = latents.ndim == 4
        if single:
            latents = latents[:, None]
        out = self.decoder(latents / self.config.scaling_factor)
        out = out.permute(0, 2, 3, 4, 1)
        return out[:, 0] if single else out

    def decode_tiled(self, latents: torch.Tensor, tile: int = 32,
                     overlap: int = 8) -> torch.Tensor:
        """The decode with the upsampling tail run tile by tile: the head
        whole-frame, then each ``tile``² latent tile (overlapping its
        neighbours by at least ``overlap``) through the tail, blended with
        per-axis linear feathers over the actual overlaps and normalised
        by the summed weights. The temporal axis stays whole."""
        B, f, h, w, _ = latents.shape
        if h <= tile and w <= tile:
            return self.decode(latents)
        if overlap >= tile:
            raise ValueError(f"vae tile overlap ({overlap}) must be smaller "
                             f"than the tile ({tile})")
        head = self.decoder(latents / self.config.scaling_factor,
                            stage="head")              # [B, C, f, h, w]
        s = self.config.downscale
        step = max(1, tile - overlap)
        th, tw = min(tile, h), min(tile, w)
        ys, xs = _tile_starts(h, th, step), _tile_starts(w, tw, step)
        ylo, yhi = _pair_feathers(ys, th)
        xlo, xhi = _pair_feathers(xs, tw)
        F_out = (f - 1) * self.config.temporal_downscale + 1
        dev = latents.device
        acc = torch.zeros((B, F_out, h * s, w * s, self.config.in_channels),
                          dtype=torch.float32, device=dev)
        wsum = torch.zeros((h * s, w * s, 1), dtype=torch.float32, device=dev)
        for iy, y0 in enumerate(ys):
            for ix, x0 in enumerate(xs):
                part = self.decoder(head[:, :, :, y0:y0 + th, x0:x0 + tw],
                                    stage="tail").permute(0, 2, 3, 4, 1)
                wy = _axis_ramp(th, ylo[iy], yhi[iy], scale=s)
                wx = _axis_ramp(tw, xlo[ix], xhi[ix], scale=s)
                wgt = torch.from_numpy(wy[:, None, None]
                                       * wx[None, :, None]).to(dev)
                rows = slice(y0 * s, (y0 + th) * s)
                cols = slice(x0 * s, (x0 + tw) * s)
                acc[:, :, rows, cols, :] += part * wgt
                wsum[rows, cols, :] += wgt
        return acc / wsum
