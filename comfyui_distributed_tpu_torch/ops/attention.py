"""Attention dispatch of the port (counterpart of the JAX ``select_kernel``
/ ``full_attention`` in ``ops/attention.py``).

On a CUDA device every site goes to a hand-written kernel:

- a self-attention site (``self_attention``: block input and projection
  weights) to the fused QKV kernel where its geometry allows the fused
  tier (``fused_feasible``); a self-attention site that does not
  (SD 1.5's 40-, 80- and 160-wide heads) projects q/k/v itself and
  takes ``full_attention`` (``models/layers.Attention``);
- a site over projected q/k/v (``full_attention``) to the packed kernel
  where the packed-heads layout is legal for its geometry
  (``packed_legal``: SDXL's cross-attention, H·D = 640 or 1280), and to
  the one-head ``[B·H, N, D]`` kernel everywhere else (FLUX's joint
  attention, H·D = 3072; every SD 1.5 site).

Both rules are the JAX package's geometric predicates (``_packed_legal``
and the geometric part of ``_fused_feasible``), copied here. The fused
predicate leaves out the JAX one's VMEM shrink
(``_shrink_blocks_for_vmem``): that is a budget of the TPU's VMEM, and
the port's projection GEMM streams x and the weights through shared
memory with no such limit. No tuning table or engagement floor applies:
those were measured on a TPU. On the CPU the plain versions run.
PyTorch's fused attention is never called.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as fa

LANES = 128              # packed row width must be a multiple of this
PACKED_MAX_HD = 2048     # widest packed row (H·D) the layout takes


def packed_legal(num_heads: int, head_dim: int) -> bool:
    """Whether the packed-heads layout takes this geometry."""
    hd = num_heads * head_dim
    return (hd % LANES == 0 and num_heads <= LANES and hd <= PACKED_MAX_HD
            and head_dim % 64 == 0)


def fused_feasible(channels: int, num_heads: int, head_dim: int) -> bool:
    """Whether the fused QKV tier takes a self-attention site of model
    width ``channels``: the packed-heads geometry plus a model width in
    whole lanes."""
    hd = num_heads * head_dim
    return (hd % LANES == 0 and num_heads <= LANES and head_dim % 64 == 0
            and channels % LANES == 0)


def select_kernel(device: torch.device, self_attention: bool,
                  num_heads: int, head_dim: int,
                  channels: Optional[int] = None) -> str:
    """``"fused"`` / ``"packed"`` / ``"bh"`` on CUDA, ``"plain"`` on the
    CPU. ``channels`` is a self-attention site's model width (default
    H·D, as every preset has)."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"no attention kernel for device {device}")
    if channels is None:
        channels = num_heads * head_dim
    if self_attention and fused_feasible(channels, num_heads, head_dim):
        return "fused"
    return "packed" if packed_legal(num_heads, head_dim) else "bh"


def self_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention from the block input on the fused tier: ``[B, N,
    C]`` and ``[H·D, C]`` weights → ``[B, N, H, D]``. A CUDA site must be
    ``fused_feasible``; the caller projects the others itself."""
    D = wq.shape[0] // num_heads
    kind = select_kernel(x.device, True, num_heads, D, x.shape[-1])
    if kind == "plain":
        return fa.fused_qkv_attention_plain(x, wq, wk, wv, num_heads)
    if kind != "fused":
        raise ValueError(f"the fused tier does not take C={x.shape[-1]}, "
                         f"H={num_heads}, D={D}; project q/k/v and call "
                         "full_attention")
    return fa.fused_qkv_attention(x, wq, wk, wv, num_heads)


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Attention over projected ``[B, N, H, D]`` operands."""
    _, _, H, D = q.shape
    kind = select_kernel(q.device, False, H, D)
    if kind == "plain":
        return fa.flash_attention_plain(q, k, v)
    return fa.flash_attention(q, k, v, layout=kind)
