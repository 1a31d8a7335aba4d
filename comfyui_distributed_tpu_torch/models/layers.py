"""Shared building blocks (counterpart of the JAX ``models/layers.py``).

Attribute names follow the JAX parameter tree, flax's automatic names
included (``GroupNorm32_0``, ``LayerNorm_1``, ``Conv_0``), so that
``models/from_jax.py`` carries weights by path. Convolution blocks take
NCHW tensors; the models convert from and to the JAX package's NHWC at
their public boundary.

Numerics kept from the JAX modules: GroupNorm in fp32 with ``min(32, C)``
groups; LayerNorm epsilon 1e-6 (flax's default, not torch's 1e-5); exact
(erf) GELU in ``GEGLU``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_feasible, full_attention, self_attention

LN_EPS = 1e-6       # flax nn.LayerNorm default


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] -> [B, dim] (DDPM convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm computed in float32 (fp32 parameters), output cast back
    to the input dtype. NCHW."""

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 num_groups: int = 32):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(min(num_groups, channels), channels,
                                        eps=epsilon, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x.float()).to(x.dtype)


class ResBlock(nn.Module):
    """GN→SiLU→conv, time-embedding shift, GN→SiLU→conv, residual."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.GroupNorm32_0 = GroupNorm32(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        self.time_proj = nn.Linear(emb_dim, out_channels, dtype=dtype)
        self.GroupNorm32_1 = GroupNorm32(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               dtype=dtype)
        self.skip = (nn.Conv2d(in_channels, out_channels, 1, dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.GroupNorm32_0(x)))
        h = h + self.time_proj(F.silu(emb))[:, :, None, None]
        h = self.conv2(F.silu(self.GroupNorm32_1(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention over [B, N, C] with optional cross context.

    A self-attention site whose geometry the fused tier takes
    (``ops/attention.fused_feasible``) hands the block input and the three
    projection weights to it (one projection GEMM, then the attention
    core over its output), as the JAX ``Attention`` does; every other site
    projects q/k/v with its own ``to_q``/``to_k``/``to_v`` and takes
    ``full_attention`` (the packed or the one-head kernel). On the CPU a
    fusable site runs the fused tier's plain version."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype, context_dim: Optional[int] = None):
        super().__init__()
        inner = num_heads * head_dim
        kv_dim = query_dim if context_dim is None else context_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = nn.Linear(kv_dim, inner, bias=False, dtype=dtype)
        self.to_v = nn.Linear(kv_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.Linear(inner, query_dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, C = x.shape
        H, D = self.num_heads, self.head_dim
        if context is None and fused_feasible(C, H, D):
            out = self_attention(x, self.to_q.weight, self.to_k.weight,
                                 self.to_v.weight, H)
        else:
            ctx = x if context is None else context
            M = ctx.shape[1]
            out = full_attention(self.to_q(x).view(B, N, H, D),
                                 self.to_k(ctx).view(B, M, H, D),
                                 self.to_v(ctx).view(B, M, H, D))
        return self.to_out(out.reshape(B, N, H * D))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, mult: int = 4):
        super().__init__()
        self.proj_in = nn.Linear(dim, dim * mult * 2, dtype=dtype)
        self.proj_out = nn.Linear(dim * mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate))


class TransformerBlock(nn.Module):
    """LN→self-attn, LN→cross-attn, LN→GEGLU-FF, all residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, dtype: torch.dtype):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.attn1 = Attention(dim, num_heads, head_dim, dtype)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.attn2 = Attention(dim, num_heads, head_dim, dtype, context_dim)
        self.LayerNorm_2 = nn.LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.ff = GEGLU(dim, dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn1(self.LayerNorm_0(x))
        x = x + self.attn2(self.LayerNorm_1(x), context)
        return x + self.ff(self.LayerNorm_2(x))


class SpatialTransformer(nn.Module):
    """Project [B,C,H,W] to tokens, run transformer blocks, project back."""

    def __init__(self, channels: int, num_heads: int, depth: int,
                 context_dim: int, dtype: torch.dtype):
        super().__init__()
        self.depth = depth
        self.GroupNorm32_0 = GroupNorm32(channels)
        self.proj_in = nn.Linear(channels, channels, dtype=dtype)
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(
                channels, num_heads, channels // num_heads, context_dim, dtype))
        self.proj_out = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.GroupNorm32_0(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        h = self.proj_out(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, 3, stride=2,
                                padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class Upsample(nn.Module):
    """Nearest 2× upsampling (or nearest to ``size``, the skip it meets:
    a side that was odd before its downsampling), then a 3×3 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                                dtype=dtype)

    def forward(self, x: torch.Tensor, size=None) -> torch.Tensor:
        if size is None:
            return self.Conv_0(F.interpolate(x, scale_factor=2, mode="nearest"))
        return self.Conv_0(F.interpolate(x, size=tuple(size), mode="nearest"))


_TRUNC = 0.87962566103423978    # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter in place with flax's default
    distributions: lecun-normal (truncated at ±2σ) kernels of Linear and
    Conv2d, zero biases, normal(1/√width) embeddings, unit/zero norms.
    Parameters this function does not know (e.g. ``pos_emb``) are left to
    their module's own ``reset_parameters``-style hook ``flax_init``."""
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Conv2d)):
            fan_in = sub.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC
            w = torch.empty(sub.weight.shape, dtype=torch.float32,
                            device=sub.weight.device)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            sub.weight.copy_(w)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            w = torch.empty(sub.weight.shape, dtype=torch.float32,
                            device=sub.weight.device)
            w.normal_(0.0, sub.embedding_dim ** -0.5, generator=generator)
            sub.weight.copy_(w)
        elif isinstance(sub, (nn.LayerNorm, nn.GroupNorm)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        hook = getattr(sub, "flax_init", None)
        if hook is not None:
            hook(generator)
    return module
