"""FLUX-class rectified-flow MMDiT (counterpart of the JAX ``models/dit.py``).

Double-stream blocks (separate image and text weights, one joint
attention over ``[txt, img]``) followed by single-stream blocks over the
merged sequence, adaLN modulation from (timestep, pooled text, distilled
guidance), patchified latents in, velocity out. ``DiTConfig.flux()`` is
FLUX.1's shape (19 double + 38 single blocks, hidden 3072, 24 heads of
128, 3-axis RoPE); ``DiTConfig.tiny()`` a toy for tests.

Attribute names follow the JAX parameter tree (``double_{i}.img_mod.mod``,
``single_{i}.qkv.qkv``, ``final_mod``, ...) so that
``models/from_jax.py`` carries weights by path. Every joint-attention
site calls ``ops.attention.full_attention``; at FLUX's width (H·D = 3072)
that is the one-head ``[B·H, N, D]`` kernel.

Numerics kept from the JAX module: parameter-free LayerNorm (eps 1e-6,
statistics in fp32, output in the model dtype); tanh GELU in the MLPs;
RMS qk-norm whose fp32 inverse root is cast to the operand dtype before
the multiply; RoPE over interleaved pairs in fp32; ``img_out`` in fp32.
The SD3 presets (learned position table, no qk-norm) and the
sequence-parallel (ring) branches are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import full_attention
from ..utils.device import torch_dtype
from .layers import LN_EPS, timestep_embedding

Rope = tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    patch_size: int = 2
    in_channels: int = 16            # FLUX VAE: 16 latent channels
    hidden: int = 3072
    depth_double: int = 19
    depth_single: int = 38
    heads: int = 24
    context_dim: int = 4096          # T5 features
    pooled_dim: int = 768            # CLIP pooled
    guidance_embed: bool = True      # FLUX-dev distilled guidance input
    dtype: str = "bfloat16"
    pos_embed: str = "sincos"        # "sincos" | "rope"
    rope_theta: float = 10000.0
    rope_axes_dim: Optional[tuple[int, int, int]] = None   # None → derived

    def __post_init__(self):
        if self.pos_embed not in ("sincos", "rope"):
            raise NotImplementedError(
                f"pos_embed={self.pos_embed!r} is not yet ported; have "
                "'sincos' and 'rope'")

    @classmethod
    def flux(cls) -> "DiTConfig":
        # FLUX.1: head_dim 128 = 16 (txt/time axis) + 56 (row) + 56 (col)
        return cls(pos_embed="rope", rope_axes_dim=(16, 56, 56))

    @classmethod
    def tiny(cls, pos_embed: str = "sincos", **kw) -> "DiTConfig":
        base = dict(patch_size=2, in_channels=4, hidden=64, depth_double=2,
                    depth_single=2, heads=4, context_dim=32, pooled_dim=16,
                    pos_embed=pos_embed)
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def axes_dim(self) -> tuple[int, int, int]:
        """Per-axis RoPE widths (sum to head_dim, all even)."""
        if self.rope_axes_dim is not None:
            return self.rope_axes_dim
        d0 = max(2, (self.head_dim // 8) // 2 * 2)
        rest = self.head_dim - d0
        dh = (rest // 2) // 2 * 2
        return (d0, dh, rest - dh)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B,H,W,C] → [B, (H/p)(W/p), p·p·C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(tokens: torch.Tensor, hw: tuple[int, int], p: int,
               c: int) -> torch.Tensor:
    """[B, (H/p)(W/p), p·p·c] → [B,H,W,c]."""
    B = tokens.shape[0]
    x = tokens.reshape(B, hw[0] // p, hw[1] // p, p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, hw[0], hw[1], c)


def sincos_2d(h: int, w: int, dim: int,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Axial 2-D sinusoidal position table [h·w, dim] in fp32."""
    def axis_table(n, d):
        pos = torch.arange(n, dtype=torch.float32, device=device)
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(d // 2, dtype=torch.float32,
                                         device=device) / (d // 2))
        args = pos[:, None] * freqs[None]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)

    dh = dim // 2
    th = axis_table(h, dh)                      # [h, dh]
    tw = axis_table(w, dim - dh)                # [w, dim-dh]
    return torch.cat([th.repeat_interleave(w, dim=0), tw.repeat(h, 1)],
                     dim=-1)


def rope_freqs(ids: torch.Tensor, axes_dim: tuple[int, ...],
               theta: float) -> Rope:
    """FLUX multi-axis RoPE table. ``ids`` [N, n_axes] integer positions
    (text tokens all zero, image tokens (0, row, col)) → (cos, sin), each
    [N, head_dim/2]: axis a contributes ``axes_dim[a]/2`` frequencies,
    concatenated in axis order."""
    parts_cos, parts_sin = [], []
    for a, d in enumerate(axes_dim):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=ids.device) * 2.0 / d))
        args = ids[:, a].float()[:, None] * freqs[None]
        parts_cos.append(torch.cos(args))
        parts_sin.append(torch.sin(args))
    return torch.cat(parts_cos, dim=-1), torch.cat(parts_sin, dim=-1)


def apply_rope(x: torch.Tensor, pe: Rope) -> torch.Tensor:
    """Rotate interleaved pairs of x [B, N, heads, head_dim] in fp32."""
    cos = pe[0][None, :, None, :].float()
    sin = pe[1][None, :, None, :].float()
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def image_ids(h: int, w: int,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """[h·w, 3] FLUX image token ids: (0, row, col)."""
    rows = torch.arange(h, device=device).repeat_interleave(w)
    cols = torch.arange(w, device=device).repeat(h)
    return torch.stack([torch.zeros_like(rows), rows, cols], dim=-1)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(use_scale=False, use_bias=False)``: statistics in
    fp32, output in the input dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # flax nn.gelu default


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True)
                           + eps).to(x.dtype)


class MLPEmbedder(nn.Module):
    """Conditioning embedder: Linear → silu → Linear."""

    def __init__(self, in_dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden, dtype=dtype)
        self.out_layer = nn.Linear(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


class Modulation(nn.Module):
    """adaLN: conditioning vector → (shift, scale, gate) × n, each
    [B, 1, hidden]."""

    def __init__(self, n_outputs: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.n_outputs = n_outputs
        self.mod = nn.Linear(hidden, hidden * 3 * n_outputs, dtype=dtype)

    def forward(self, vec: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.mod(F.silu(vec))[:, None, :].chunk(3 * self.n_outputs,
                                                      dim=-1)


class _QKV(nn.Module):
    """One Linear to q|k|v, heads split, RMS qk-norm with fp32 scales."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, hidden * 3, dtype=dtype)
        self.q_scale = nn.Parameter(torch.ones(hidden // heads,
                                               dtype=torch.float32))
        self.k_scale = nn.Parameter(torch.ones(hidden // heads,
                                               dtype=torch.float32))

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """``q_scale``/``k_scale`` start at one, as the flax parameters."""
        self.q_scale.fill_(1.0)
        self.k_scale.fill_(1.0)

    def forward(self, x: torch.Tensor):
        B, N, _ = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.heads, -1).unbind(2)
        q = _rms(q) * self.q_scale.to(x.dtype)
        k = _rms(k) * self.k_scale.to(x.dtype)
        return q, k, v


class DoubleBlock(nn.Module):
    """Separate image/text streams with one joint attention (MMDiT)."""

    def __init__(self, config: DiTConfig):
        super().__init__()
        dt, H = config.torch_dtype, config.hidden
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", Modulation(2, H, dt))
            self.add_module(f"{s}_qkv", _QKV(H, config.heads, dt))
            self.add_module(f"{s}_proj", nn.Linear(H, H, dtype=dt))
            self.add_module(f"{s}_mlp_up", nn.Linear(H, 4 * H, dtype=dt))
            self.add_module(f"{s}_mlp_down", nn.Linear(4 * H, H, dtype=dt))

    def forward(self, img, txt, vec, pe_img: Optional[Rope] = None,
                pe_txt: Optional[Rope] = None):
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(vec)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(vec)
        iq, ik, iv = self.img_qkv(_modulate(_layer_norm(img), i_sh1, i_sc1))
        tq, tk, tv = self.txt_qkv(_modulate(_layer_norm(txt), t_sh1, t_sc1))
        if pe_img is not None:
            iq, ik = apply_rope(iq, pe_img), apply_rope(ik, pe_img)
            tq, tk = apply_rope(tq, pe_txt), apply_rope(tk, pe_txt)
        out = full_attention(torch.cat([tq, iq], dim=1),
                             torch.cat([tk, ik], dim=1),
                             torch.cat([tv, iv], dim=1))
        B, T, C = txt.shape
        t_out = out[:, :T].reshape(B, T, C)
        i_out = out[:, T:].reshape(B, -1, C)
        img = img + i_g1 * self.img_proj(i_out)
        txt = txt + t_g1 * self.txt_proj(t_out)
        img_m = _modulate(_layer_norm(img), i_sh2, i_sc2)
        txt_m = _modulate(_layer_norm(txt), t_sh2, t_sc2)
        img = img + i_g2 * self.img_mlp_down(_gelu(self.img_mlp_up(img_m)))
        txt = txt + t_g2 * self.txt_mlp_down(_gelu(self.txt_mlp_up(txt_m)))
        return img, txt


class SingleBlock(nn.Module):
    """Merged-stream block: attention and MLP side by side, one output
    projection over both."""

    def __init__(self, config: DiTConfig):
        super().__init__()
        dt, H = config.torch_dtype, config.hidden
        self.mod = Modulation(1, H, dt)
        self.qkv = _QKV(H, config.heads, dt)
        self.mlp_up = nn.Linear(H, 4 * H, dtype=dt)
        self.out = nn.Linear(5 * H, H, dtype=dt)

    def forward(self, x, vec, pe_full: Optional[Rope] = None):
        sh, sc, g = self.mod(vec)
        xn = _modulate(_layer_norm(x), sh, sc)
        q, k, v = self.qkv(xn)
        if pe_full is not None:
            q, k = apply_rope(q, pe_full), apply_rope(k, pe_full)
        out = full_attention(q, k, v).reshape(x.shape)
        fused = torch.cat([out, _gelu(self.mlp_up(xn))], dim=-1)
        return x + g * self.out(fused)


class DiT(nn.Module):
    """x [B,h,w,C], t [B] (flow time in [0,1]), context [B,T,ctx],
    pooled [B,P], guidance [B] → velocity [B,h,w,C] (fp32)."""

    def __init__(self, config: DiTConfig):
        super().__init__()
        self.config = cfg = config
        dt, H, p = cfg.torch_dtype, cfg.hidden, cfg.patch_size
        self.img_in = nn.Linear(p * p * cfg.in_channels, H, dtype=dt)
        self.txt_in = nn.Linear(cfg.context_dim, H, dtype=dt)
        self.time_in = MLPEmbedder(256, H, dt)
        self.vector_in = MLPEmbedder(cfg.pooled_dim, H, dt)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(256, H, dt)
        for i in range(cfg.depth_double):
            self.add_module(f"double_{i}", DoubleBlock(cfg))
        for i in range(cfg.depth_single):
            self.add_module(f"single_{i}", SingleBlock(cfg))
        self.final_mod = Modulation(1, H, dt)
        # fp32 compute site, as in the JAX model
        self.img_out = nn.Linear(H, p * p * cfg.in_channels,
                                 dtype=torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, pooled: torch.Tensor,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        dt, p = cfg.torch_dtype, cfg.patch_size
        B, H, W, C = x.shape
        dev = x.device
        img = self.img_in(patchify(x.to(dt), p))
        pe_img = pe_txt = pe_full = None
        if cfg.pos_embed == "rope":
            ids_txt = torch.zeros((context.shape[1], 3), dtype=torch.long,
                                  device=dev)
            pe_img = rope_freqs(image_ids(H // p, W // p, dev), cfg.axes_dim,
                                cfg.rope_theta)
            pe_txt = rope_freqs(ids_txt, cfg.axes_dim, cfg.rope_theta)
            pe_full = (torch.cat([pe_txt[0], pe_img[0]], dim=0),
                       torch.cat([pe_txt[1], pe_img[1]], dim=0))
        else:
            img = img + sincos_2d(H // p, W // p, cfg.hidden, dev)[None].to(dt)
        txt = self.txt_in(context.to(dt))

        vec = self.time_in(timestep_embedding(t * 1000.0, 256).to(dt))
        vec = vec + self.vector_in(pooled.to(dt))
        if cfg.guidance_embed:
            g = guidance if guidance is not None else torch.full((B,), 3.5,
                                                                 device=dev)
            vec = vec + self.guidance_in(
                timestep_embedding(g * 1000.0, 256).to(dt))

        for i in range(cfg.depth_double):
            img, txt = getattr(self, f"double_{i}")(img, txt, vec, pe_img,
                                                    pe_txt)
        T = txt.shape[1]
        xcat = torch.cat([txt, img], dim=1)
        for i in range(cfg.depth_single):
            xcat = getattr(self, f"single_{i}")(xcat, vec, pe_full)
        img = xcat[:, T:]

        sh, sc, _ = self.final_mod(vec)
        img = _modulate(_layer_norm(img), sh, sc)
        out = self.img_out(img.float())
        return unpatchify(out, (H, W), p, C)
