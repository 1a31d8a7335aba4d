"""FLUX- and SD3-class rectified-flow MMDiT (counterpart of the JAX
``models/dit.py``).

Double-stream blocks (separate image and text weights, one joint
attention over ``[txt, img]``) followed by single-stream blocks over the
merged sequence, adaLN modulation from (timestep, pooled text[, distilled
guidance]), patchified latents in, velocity out. ``DiTConfig.flux()`` is
FLUX.1's shape (19 double + 38 single blocks, hidden 3072, 24 heads of
128, 3-axis RoPE); ``sd3_medium()`` (24 joint blocks, 24 heads of 64, no
qk-norm) and ``sd35_large()`` (38 joint blocks, 38 heads of 64, RMS
qk-norm) are SD3's: joint blocks only, a learned ``m²``-entry position
table centre-cropped to the patch grid, no guidance embedder;
``tiny()`` and ``sd3_tiny()`` are toys for tests.

Attribute names follow the JAX parameter tree (``double_{i}.img_mod.mod``,
``single_{i}.qkv.qkv``, ``final_mod``, ``pos_emb``, ...) so that
``models/from_jax.py`` carries weights by path. Every joint-attention
site calls ``ops.attention.full_attention``: at FLUX's width (H·D = 3072)
and SD3.5-large's (2432) that is the one-head ``[B·H, N, D]`` kernel, at
SD3-medium's (1536) the packed kernel.

Numerics kept from the JAX module: parameter-free LayerNorm (eps 1e-6,
statistics in fp32, output in the model dtype); tanh GELU in the MLPs;
RMS qk-norm whose fp32 inverse root is cast to the operand dtype before
the multiply; RoPE over interleaved pairs in fp32; the learned position
table in fp32, cast to the model dtype where it is added; ``img_out`` in
fp32.

Sequence parallelism (``sp_axis``, the JAX module's ring branches):
``x`` is this shard's row block of the latent; every joint attention is
``ops.attention.joint_ring_attention`` (the text K/V folded in once, the
image K/V rotating over the axis); RoPE's row ids are offset by the
shard's first patch row, the learned SD3 table is cropped at the shard's
rows of the centred global grid, the sincos table sliced at its rows, so
a sharded forward adds the positions of the unsharded one. The output
stays the shard's rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import full_attention, joint_ring_attention
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
    pos_embed: str = "sincos"        # "sincos" | "rope" | "learned"
    pos_embed_max_size: int = 0      # "learned": side of the square table
    qk_norm: bool = True             # RMS qk-norm (FLUX, SD3.5; SD3-medium
                                     # checkpoints have no norm scales)
    rope_theta: float = 10000.0
    rope_axes_dim: Optional[tuple[int, int, int]] = None   # None → derived

    def __post_init__(self):
        if self.pos_embed not in ("sincos", "rope", "learned"):
            raise ValueError(f"unknown pos_embed {self.pos_embed!r}; have "
                             "'sincos', 'rope' and 'learned'")

    @classmethod
    def flux(cls) -> "DiTConfig":
        # FLUX.1: head_dim 128 = 16 (txt/time axis) + 56 (row) + 56 (col)
        return cls(pos_embed="rope", rope_axes_dim=(16, 56, 56))

    @classmethod
    def sd3_medium(cls) -> "DiTConfig":
        """SD3-medium (2B): 24 joint blocks, width 1536, no qk-norm."""
        return cls(hidden=1536, depth_double=24, depth_single=0, heads=24,
                   context_dim=4096, pooled_dim=2048, guidance_embed=False,
                   pos_embed="learned", pos_embed_max_size=192,
                   qk_norm=False)

    @classmethod
    def sd35_large(cls) -> "DiTConfig":
        """SD3.5-large (8B): 38 joint blocks, width 2432, RMS qk-norm."""
        return cls(hidden=2432, depth_double=38, depth_single=0, heads=38,
                   context_dim=4096, pooled_dim=2048, guidance_embed=False,
                   pos_embed="learned", pos_embed_max_size=192,
                   qk_norm=True)

    @classmethod
    def tiny(cls, pos_embed: str = "sincos", **kw) -> "DiTConfig":
        base = dict(patch_size=2, in_channels=4, hidden=64, depth_double=2,
                    depth_single=2, heads=4, context_dim=32, pooled_dim=16,
                    pos_embed=pos_embed)
        base.update(kw)
        return cls(**base)

    @classmethod
    def sd3_tiny(cls, **kw) -> "DiTConfig":
        """SD3-shaped tiny: joint-only depth, a learned 12×12 table, no
        qk-norm (``tiny()``'s guidance embedder kept, as in JAX's)."""
        base = dict(pos_embed_max_size=12, depth_double=2, depth_single=0,
                    qk_norm=False)
        base.update(kw)
        return cls.tiny(pos_embed="learned", **base)

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


def image_ids(h: int, w: int, device: Optional[torch.device] = None,
              row_offset: int = 0) -> torch.Tensor:
    """[h·w, 3] FLUX image token ids: (0, row, col); rows start at
    ``row_offset`` (a sequence shard's first patch row)."""
    rows = (torch.arange(h, device=device) + row_offset).repeat_interleave(w)
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
    """One Linear to q|k|v, heads split, RMS qk-norm with fp32 scales
    (none without ``qk_norm``: SD3-medium's raw q/k)."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype,
                 qk_norm: bool = True):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, hidden * 3, dtype=dtype)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_scale = nn.Parameter(torch.ones(hidden // heads,
                                                   dtype=torch.float32))
            self.k_scale = nn.Parameter(torch.ones(hidden // heads,
                                                   dtype=torch.float32))

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """``q_scale``/``k_scale`` start at one, as the flax parameters."""
        if self.qk_norm:
            self.q_scale.fill_(1.0)
            self.k_scale.fill_(1.0)

    def forward(self, x: torch.Tensor):
        B, N, _ = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.heads, -1).unbind(2)
        if self.qk_norm:
            q = _rms(q) * self.q_scale.to(x.dtype)
            k = _rms(k) * self.k_scale.to(x.dtype)
        return q, k, v


class DoubleBlock(nn.Module):
    """Separate image/text streams with one joint attention (MMDiT).

    A tensor-parallel shard (``parallel/tensor.shard_module``) holds its
    rank's heads of both q|k|v and its slice of both MLPs; the
    projections and the MLPs' down halves are summed over ``tp_axis``."""

    tp_axis: Optional[str] = None

    def __init__(self, config: DiTConfig):
        super().__init__()
        dt, H = config.torch_dtype, config.hidden
        self.heads = config.heads
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", Modulation(2, H, dt))
            self.add_module(f"{s}_qkv", _QKV(H, config.heads, dt,
                                             config.qk_norm))
            self.add_module(f"{s}_proj", nn.Linear(H, H, dtype=dt))
            self.add_module(f"{s}_mlp_up", nn.Linear(H, 4 * H, dtype=dt))
            self.add_module(f"{s}_mlp_down", nn.Linear(4 * H, H, dtype=dt))

    def forward(self, img, txt, vec, pe_img: Optional[Rope] = None,
                pe_txt: Optional[Rope] = None,
                sp_axis: Optional[str] = None):
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(vec)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(vec)
        iq, ik, iv = self.img_qkv(_modulate(_layer_norm(img), i_sh1, i_sc1))
        tq, tk, tv = self.txt_qkv(_modulate(_layer_norm(txt), t_sh1, t_sc1))
        if pe_img is not None:
            iq, ik = apply_rope(iq, pe_img), apply_rope(ik, pe_img)
            tq, tk = apply_rope(tq, pe_txt), apply_rope(tk, pe_txt)
        q = torch.cat([tq, iq], dim=1)
        if sp_axis is None:
            out = full_attention(q, torch.cat([tk, ik], dim=1),
                                 torch.cat([tv, iv], dim=1))
        else:
            out = joint_ring_attention(q, tk, tv, ik, iv, sp_axis)
        B, T, _ = txt.shape
        t_out = out[:, :T].reshape(B, T, -1)
        i_out = out[:, T:].reshape(B, img.shape[1], -1)
        row = self._row
        img = img + i_g1 * row(self.img_proj, i_out)
        txt = txt + t_g1 * row(self.txt_proj, t_out)
        img_m = _modulate(_layer_norm(img), i_sh2, i_sc2)
        txt_m = _modulate(_layer_norm(txt), t_sh2, t_sc2)
        img = img + i_g2 * row(self.img_mlp_down,
                               _gelu(self.img_mlp_up(img_m)))
        txt = txt + t_g2 * row(self.txt_mlp_down,
                               _gelu(self.txt_mlp_up(txt_m)))
        return img, txt

    def _row(self, linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return _row_linear(linear, x, self.tp_axis)


class SingleBlock(nn.Module):
    """Merged-stream block: attention and MLP side by side, one output
    projection over both. A tensor-parallel shard holds its rank's heads
    and MLP slice, and the columns of ``out`` they feed (not contiguous:
    its attention columns, then its MLP columns), summed over
    ``tp_axis``."""

    tp_axis: Optional[str] = None

    def __init__(self, config: DiTConfig):
        super().__init__()
        dt, H = config.torch_dtype, config.hidden
        self.heads = config.heads
        self.mod = Modulation(1, H, dt)
        self.qkv = _QKV(H, config.heads, dt, config.qk_norm)
        self.mlp_up = nn.Linear(H, 4 * H, dtype=dt)
        self.out = nn.Linear(5 * H, H, dtype=dt)

    def forward(self, x, vec, pe_full: Optional[Rope] = None,
                txt_len: int = 0, sp_axis: Optional[str] = None):
        sh, sc, g = self.mod(vec)
        xn = _modulate(_layer_norm(x), sh, sc)
        q, k, v = self.qkv(xn)
        if pe_full is not None:
            q, k = apply_rope(q, pe_full), apply_rope(k, pe_full)
        if sp_axis is None:
            out = full_attention(q, k, v)
        else:
            # the text tokens lead the sequence on every shard
            T = txt_len
            out = joint_ring_attention(q, k[:, :T], v[:, :T], k[:, T:],
                                       v[:, T:], sp_axis)
        out = out.reshape(*x.shape[:2], -1)
        fused = torch.cat([out, _gelu(self.mlp_up(xn))], dim=-1)
        return x + g * _row_linear(self.out, fused, self.tp_axis)


def _row_linear(linear: nn.Linear, x: torch.Tensor,
                tp_axis: Optional[str]) -> torch.Tensor:
    """``linear(x)``, or its row-parallel form on a shard."""
    if tp_axis is None:
        return linear(x)
    from ..parallel.tensor import row_parallel

    return row_parallel(linear, x, tp_axis)


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
        if cfg.pos_embed == "learned":
            m = cfg.pos_embed_max_size
            self.pos_emb = nn.Parameter(torch.zeros(m * m, H))
        # fp32 compute site, as in the JAX model
        self.img_out = nn.Linear(H, p * p * cfg.in_channels,
                                 dtype=torch.float32)

    @torch.no_grad()
    def flax_init(self, generator: torch.Generator) -> None:
        """``pos_emb`` ~ normal(0.01), as the flax parameter."""
        if self.config.pos_embed == "learned":
            self.pos_emb.normal_(0.0, 0.01, generator=generator)

    def learned_positions(self, hp: int, wp: int, shards: int = 1,
                          index: int = 0) -> torch.Tensor:
        """SD3's table centre-cropped to the global ``(hp·shards) × wp``
        patch grid, rows of shard ``index``: [hp·wp, hidden] in fp32."""
        m = self.config.pos_embed_max_size
        gh = hp * shards
        if gh > m or wp > m:
            raise ValueError(
                f"sample grid {gh}×{wp} exceeds the learned position "
                f"table ({m}×{m}): SD3-family models cannot sample "
                "beyond pos_embed_max_size patches per side")
        top, left = (m - gh) // 2 + index * hp, (m - wp) // 2
        table = self.pos_emb.view(m, m, -1)
        return table[top:top + hp, left:left + wp].reshape(hp * wp, -1)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, pooled: torch.Tensor,
                guidance: Optional[torch.Tensor] = None,
                sp_axis: Optional[str] = None) -> torch.Tensor:
        """``sp_axis``: ``x`` is this shard's row block over that mesh
        axis (module docstring)."""
        cfg = self.config
        dt, p = cfg.torch_dtype, cfg.patch_size
        B, H, W, C = x.shape
        dev = x.device
        shards, index = 1, 0
        if sp_axis is not None:
            from ..parallel.mesh import axis_group

            g = axis_group(sp_axis)
            shards, index = g.size, g.index
        img = self.img_in(patchify(x.to(dt), p))
        pe_img = pe_txt = pe_full = None
        if cfg.pos_embed == "rope":
            ids_txt = torch.zeros((context.shape[1], 3), dtype=torch.long,
                                  device=dev)
            ids_img = image_ids(H // p, W // p, dev,
                                row_offset=index * (H // p))
            pe_img = rope_freqs(ids_img, cfg.axes_dim, cfg.rope_theta)
            pe_txt = rope_freqs(ids_txt, cfg.axes_dim, cfg.rope_theta)
            pe_full = (torch.cat([pe_txt[0], pe_img[0]], dim=0),
                       torch.cat([pe_txt[1], pe_img[1]], dim=0))
        elif cfg.pos_embed == "learned":
            img = img + self.learned_positions(H // p, W // p, shards,
                                               index)[None].to(dt)
        elif shards == 1:
            img = img + sincos_2d(H // p, W // p, cfg.hidden, dev)[None].to(dt)
        else:
            # the global table, this shard's rows
            per = (H // p) * (W // p)
            pos = sincos_2d((H * shards) // p, W // p, cfg.hidden, dev)
            img = img + pos[index * per:(index + 1) * per][None].to(dt)
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
                                                    pe_txt, sp_axis)
        T = txt.shape[1]
        xcat = torch.cat([txt, img], dim=1)
        for i in range(cfg.depth_single):
            xcat = getattr(self, f"single_{i}")(xcat, vec, pe_full, T,
                                                sp_axis)
        img = xcat[:, T:]

        sh, sc, _ = self.final_mod(vec)
        img = _modulate(_layer_norm(img), sh, sc)
        out = self.img_out(img.float())
        return unpatchify(out, (H, W), p, C)
