"""Attention dispatch of the port (counterpart of the JAX ``select_kernel``
/ ``full_attention`` in ``ops/attention.py``).

On a CUDA device every site goes to a hand-written kernel: a
self-attention site (``context is None``) to the fused QKV kernel, a
cross-attention site to the packed kernel. On the CPU the plain versions
run. No tuning table or engagement floor applies: those were measured on
a TPU. PyTorch's fused attention is never called.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa


def select_kernel(device: torch.device, self_attention: bool) -> str:
    """``"fused"`` / ``"packed"`` on CUDA, ``"plain"`` on the CPU."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"no attention kernel for device {device}")
    return "fused" if self_attention else "packed"


def self_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention from the block input: ``[B, N, C]`` and ``[H·D, C]``
    weights → ``[B, N, H, D]``."""
    if select_kernel(x.device, self_attention=True) == "plain":
        return fa.fused_qkv_attention_plain(x, wq, wk, wv, num_heads)
    return fa.fused_qkv_attention(x, wq, wk, wv, num_heads)


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Attention over projected ``[B, N, H, D]`` operands."""
    if select_kernel(q.device, self_attention=False) == "plain":
        return fa.flash_attention_plain(q, k, v)
    return fa.flash_attention(q, k, v, layout="packed")
