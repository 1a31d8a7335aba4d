"""WAN 2.x video transformer (counterpart of the JAX ``models/wan.py``).

The published WAN t2v architecture, weight-faithful so that a published
file converts by renaming (``models/convert.convert_wan``):

- a Conv3d patch embedding (temporal patch 1, spatial 2×2), tokens
  frame-major;
- identical blocks: self-attention with full-width learned-scale RMS
  qk-norm and 3-axis RoPE, cross-attention to the text context (no
  RoPE), a tanh-GELU feed-forward; each block's ``[1, 6, dim]``
  ``modulation`` is added to the shared time projection in fp32 and
  chunked into shift/scale/gate for the two branches;
- a head: parameter-free LayerNorm, a learned ``[1, 2, dim]`` shift/scale
  over the unprojected time embedding, a Linear in fp32, and the
  unpatchify with the channel last (the published ``view(*v,
  *patch_size, c)``).

Every attention site calls ``ops.attention.full_attention``: at WAN
14B's width (40 heads of 128, H·D = 5120) the packed layout is not
legal, so both sites take the one-head ``[B·H, N, D]`` kernel; the
cross-attention over at most 128 text tokens launches its short-key
kernel, over UMT5's 512 the streamed core. RoPE is the port's own
``models/dit.rope_freqs``/``apply_rope`` over (frame, row, col) ids.

Attribute names follow the JAX parameter tree (``patch_embedding``,
``time_emb_0``, ``block_{i}.self_attn.norm_q.weight``,
``block_{i}.modulation``, ``head_modulation``), so ``models/from_jax.py``
carries a JAX tree. The qk-norm scales and both modulations are fp32
parameters, cast at use as the JAX module casts its fp32 parameters; the
head runs in fp32. The sequence-parallel (ring) branch is not ported yet
(ROADMAP A.6b iii).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import full_attention
from ..utils.device import torch_dtype
from .dit import Rope, apply_rope, rope_freqs
from .layers import timestep_embedding


@dataclasses.dataclass(frozen=True)
class WanConfig:
    patch_size: tuple[int, int, int] = (1, 2, 2)
    in_channels: int = 16
    out_channels: int = 16
    dim: int = 5120
    ffn_dim: int = 13824
    num_layers: int = 40
    num_heads: int = 40
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    cross_attn_norm: bool = True
    dtype: str = "bfloat16"

    @classmethod
    def wan_14b(cls) -> "WanConfig":
        return cls()

    @classmethod
    def wan_1_3b(cls) -> "WanConfig":
        return cls(dim=1536, ffn_dim=8960, num_layers=30, num_heads=12)

    @classmethod
    def tiny(cls, **kw) -> "WanConfig":
        base = dict(in_channels=4, out_channels=4, dim=48, ffn_dim=96,
                    num_layers=2, num_heads=4, text_dim=32, freq_dim=32,
                    dtype="float32")
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def axes_dim(self) -> tuple[int, int, int]:
        """Per-axis RoPE widths over (frame, row, col): 2·(D/6) each for
        rows and columns, the rest for time ((44, 42, 42) at D 128)."""
        d = self.head_dim
        dh = 2 * (d // 6)
        return (d - 2 * dh, dh, dh)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def video_ids(f: int, h: int, w: int, frame_offset: int = 0,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """[f·h·w, 3] (frame, row, col) token ids, frame-major."""
    fs = torch.arange(f, device=device) + frame_offset
    fs = fs.repeat_interleave(h * w)
    rows = torch.arange(h, device=device).repeat_interleave(w).repeat(f)
    cols = torch.arange(w, device=device).repeat(f * h)
    return torch.stack([fs, rows, cols], dim=-1)


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Parameter-free LayerNorm, statistics in fp32, output in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


class WanRMSNorm(nn.Module):
    """Full-width RMS norm with a learned scale (WAN's qk-norm): fp32
    statistics, the normalised value cast to the input dtype before the
    scale."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width, dtype=torch.float32))

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(-1, keepdim=True)
        return ((x * torch.rsqrt(var + self.eps)).to(x.dtype)
                * self.weight.to(x.dtype))


class WanAttention(nn.Module):
    """q/k/v/o Linears with RMS qk-norm: the self-attention site (keys from
    ``x`` itself, RoPE ``pe``) and the text cross-attention (no RoPE)."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        dt, d = cfg.torch_dtype, cfg.dim
        self.heads, self.head_dim = cfg.num_heads, cfg.head_dim
        for name in ("q", "k", "v", "o"):
            self.add_module(name, nn.Linear(d, d, dtype=dt))
        self.norm_q = WanRMSNorm(d, cfg.eps)
        self.norm_k = WanRMSNorm(d, cfg.eps)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                pe: Optional[Rope] = None) -> torch.Tensor:
        B, N, C = x.shape
        T = context.shape[1]
        q = self.norm_q(self.q(x)).view(B, N, self.heads, self.head_dim)
        k = self.norm_k(self.k(context)).view(B, T, self.heads, self.head_dim)
        v = self.v(context).view(B, T, self.heads, self.head_dim)
        if pe is not None:
            q, k = apply_rope(q, pe), apply_rope(k, pe)
        return self.o(full_attention(q, k, v).reshape(B, N, C))


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        dt = cfg.torch_dtype
        self.eps = cfg.eps
        self.cross_attn_norm = cfg.cross_attn_norm
        self.modulation = nn.Parameter(
            torch.zeros(1, 6, cfg.dim, dtype=torch.float32))
        self.self_attn = WanAttention(cfg)
        if cfg.cross_attn_norm:
            self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps,
                                      dtype=torch.float32)
        self.cross_attn = WanAttention(cfg)
        self.ffn_0 = nn.Linear(cfg.dim, cfg.ffn_dim, dtype=dt)
        self.ffn_2 = nn.Linear(cfg.ffn_dim, cfg.dim, dtype=dt)

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """flax ``normal(0.02)`` for the modulation."""
        w = torch.empty(self.modulation.shape, dtype=torch.float32,
                        device=self.modulation.device)
        self.modulation.copy_(w.normal_(0.0, 0.02, generator=generator))

    def forward(self, x: torch.Tensor, e0: torch.Tensor, context: torch.Tensor,
                pe: Rope) -> torch.Tensor:
        """x [B, N, dim]; e0 [B, 6, dim], the shared time projection."""
        m = (self.modulation + e0.float()).to(x.dtype)
        m0, m1, m2, m3, m4, m5 = (m[:, i, None, :] for i in range(6))
        y = _layer_norm(x, self.eps) * (1 + m1) + m0
        y = self.self_attn(y, y, pe)
        x = x + y * m2
        h = x
        if self.cross_attn_norm:
            h = self.norm3(x.float()).to(x.dtype)
        x = x + self.cross_attn(h, context)
        y = _layer_norm(x, self.eps) * (1 + m4) + m3
        y = self.ffn_2(F.gelu(self.ffn_0(y), approximate="tanh"))
        return x + y * m5


class WanModel(nn.Module):
    """x [B, F, h, w, C], t [B] (flow time in [0, 1]), context [B, T,
    text_dim] → velocity [B, F, h, w, out_channels] (fp32). ``pooled`` is
    accepted and ignored (WAN has no pooled-vector input), so the video
    pipeline drives either architecture."""

    def __init__(self, config: WanConfig):
        super().__init__()
        self.config = cfg = config
        dt, d = cfg.torch_dtype, cfg.dim
        self.patch_embedding = nn.Conv3d(cfg.in_channels, d, cfg.patch_size,
                                         stride=cfg.patch_size, dtype=dt)
        self.text_emb_0 = nn.Linear(cfg.text_dim, d, dtype=dt)
        self.text_emb_2 = nn.Linear(d, d, dtype=dt)
        self.time_emb_0 = nn.Linear(cfg.freq_dim, d, dtype=dt)
        self.time_emb_2 = nn.Linear(d, d, dtype=dt)
        self.time_proj_1 = nn.Linear(d, 6 * d, dtype=dt)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", WanBlock(cfg))
        self.head_modulation = nn.Parameter(
            torch.zeros(1, 2, d, dtype=torch.float32))
        pt, ph, pw = cfg.patch_size
        # fp32 compute site, as in the JAX model
        self.head = nn.Linear(d, pt * ph * pw * cfg.out_channels,
                              dtype=torch.float32)

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        w = torch.empty(self.head_modulation.shape, dtype=torch.float32,
                        device=self.head_modulation.device)
        self.head_modulation.copy_(w.normal_(0.0, 0.02, generator=generator))

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.torch_dtype
        B, Fr, H, W, _ = x.shape
        pt, ph, pw = cfg.patch_size
        f, h, w = Fr // pt, H // ph, W // pw
        tok = self.patch_embedding(x.to(dt).permute(0, 4, 1, 2, 3))
        tok = tok.flatten(2).transpose(1, 2)            # [B, f·h·w, dim]
        pe = rope_freqs(video_ids(f, h, w, device=x.device), cfg.axes_dim,
                        10000.0)

        emb = timestep_embedding(t * 1000.0, cfg.freq_dim).to(dt)
        e = self.time_emb_2(F.silu(self.time_emb_0(emb)))
        e0 = self.time_proj_1(F.silu(e)).view(B, 6, cfg.dim)
        ctx = self.text_emb_2(F.gelu(self.text_emb_0(context.to(dt)),
                                     approximate="tanh"))
        for i in range(cfg.num_layers):
            tok = getattr(self, f"block_{i}")(tok, e0, ctx, pe)

        hm = (self.head_modulation + e.float()[:, None, :]).to(dt)
        sh, sc = hm[:, 0, None, :], hm[:, 1, None, :]
        tok = _layer_norm(tok, cfg.eps) * (1 + sc) + sh
        out = self.head(tok.float())
        # the head's features are (pt, ph, pw, c): the channel last
        o = cfg.out_channels
        out = out.view(B, f, h, w, pt, ph, pw, o)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return out.reshape(B, Fr, H, W, o)
