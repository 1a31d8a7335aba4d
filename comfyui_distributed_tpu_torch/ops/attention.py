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

Each tier a process selects on the card for a geometry is logged once
and counted once in ``cdt_attn_kernel_selected{tier, geometry}``, the
geometry keyed as the JAX package keys it (``hH.dD.qN.kvN.dtype``, the
sequence lengths bucketed to powers of two from 128).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils.logging import log
from . import flash_attention as fa

LANES = 128              # packed row width must be a multiple of this
PACKED_MAX_HD = 2048     # widest packed row (H·D) the layout takes


_SEEN: set[tuple] = set()                  # raw (tier, H, D, Nq, Nk, dtype)
_SELECTIONS: set[tuple[str, str]] = set()  # (geometry, tier)
_SELECTIONS_LOCK = threading.Lock()
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32"}


def seq_bucket(n: int) -> int:
    """Next power of two ≥ n, floored at 128 (one label for a resolution
    family)."""
    b = 128
    while b < n:
        b *= 2
    return b


def geometry_key(num_heads: int, head_dim: int, q_len: int, kv_len: int,
                 dtype: torch.dtype) -> str:
    return (f"h{num_heads}.d{head_dim}.q{seq_bucket(q_len)}"
            f".kv{seq_bucket(kv_len)}.{_DTYPE_NAMES.get(dtype, str(dtype))}")


def _note_selection(tier: str, num_heads: int, head_dim: int, q_len: int,
                    kv_len: int, dtype: torch.dtype) -> None:
    raw = (tier, num_heads, head_dim, q_len, kv_len, dtype)
    if raw in _SEEN:                # the steady state: one set lookup
        return
    geometry = geometry_key(num_heads, head_dim, q_len, kv_len, dtype)
    with _SELECTIONS_LOCK:
        _SEEN.add(raw)
        if (geometry, tier) in _SELECTIONS:
            return
        _SELECTIONS.add((geometry, tier))
    log(f"attention: {geometry} → {tier}")
    if telemetry.enabled():
        _tm.ATTN_KERNEL_SELECTED.labels(tier=tier, geometry=geometry).inc()


def selection_summary() -> str:
    """'geometry=tier' of every kernel choice this process has made on
    the card (the ``attn_kernels`` attribute of a ``pipeline_call``
    span)."""
    with _SELECTIONS_LOCK:
        return ",".join(sorted(f"{g}={t}" for g, t in _SELECTIONS))


def reset_selections() -> None:
    with _SELECTIONS_LOCK:
        _SEEN.clear()
        _SELECTIONS.clear()


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
                  channels: Optional[int] = None,
                  q_len: Optional[int] = None, kv_len: Optional[int] = None,
                  dtype: torch.dtype = torch.bfloat16) -> str:
    """``"fused"`` / ``"packed"`` / ``"bh"`` on CUDA, ``"plain"`` on the
    CPU. ``channels`` is a self-attention site's model width (default
    H·D, as every preset has). With the sequence lengths given, a CUDA
    choice is noted (logged and counted once per geometry)."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"no attention kernel for device {device}")
    if channels is None:
        channels = num_heads * head_dim
    if self_attention and fused_feasible(channels, num_heads, head_dim):
        tier = "fused"
    else:
        tier = "packed" if packed_legal(num_heads, head_dim) else "bh"
    if q_len is not None:
        _note_selection(tier, num_heads, head_dim, q_len,
                        q_len if kv_len is None else kv_len, dtype)
    return tier


def self_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention from the block input on the fused tier: ``[B, N,
    C]`` and ``[H·D, C]`` weights → ``[B, N, H, D]``. A CUDA site must be
    ``fused_feasible``; the caller projects the others itself."""
    D = wq.shape[0] // num_heads
    kind = select_kernel(x.device, True, num_heads, D, x.shape[-1],
                         q_len=x.shape[1], dtype=x.dtype)
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
    _, Nq, H, D = q.shape
    kind = select_kernel(q.device, False, H, D, q_len=Nq, kv_len=k.shape[1],
                         dtype=q.dtype)
    if kind == "plain":
        return fa.flash_attention_plain(q, k, v)
    return fa.flash_attention(q, k, v, layout=kind)
