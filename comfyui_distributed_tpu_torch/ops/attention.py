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

Attention over a mesh axis (``sp``), the JAX module's ring family:
``ring_attention`` and ``joint_ring_attention`` rotate the K/V shards
around the ring and fold each arriving block into a streaming softmax
(``_flash_block``, ``_hop_attend``: sub-blocks of ``CDT_RING_BLOCK`` keys,
the remainder block last), as the JAX package computes them outside any
Pallas kernel; ``ulysses_attention`` redistributes heads with two
all-to-alls around ``full_attention`` (the kernels on the card). The
next hop's transfer is started before the current hop's block is
folded in. The ring skips JAX's last rotation, which returns every
shard its own block and is never read.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils import constants
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


# --- attention over a mesh axis --------------------------------------------------


def _flash_block(q, k, v, m, l, acc, scale):
    """One K/V block of streaming-softmax attention, in fp32.

    q [B,Nq,H,D]; k, v [B,Nk,H,D]; m, l [B,H,Nq]; acc [B,Nq,H,D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)                       # [B,H,Nq]
    p = torch.exp(s - m_new[..., None])               # [B,H,Nq,Nk]
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    acc_new = acc * corr.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _hop_attend(qf, k_cur, v_cur, m, l, acc, scale, blk: int):
    """Fold one hop's K/V into the running softmax state, ``blk`` keys at
    a time (0: the whole hop), the remainder block last: the fp32 logits
    of a hop stay bounded at [B, H, Nq, blk]."""
    nk = k_cur.shape[1]
    if blk <= 0 or nk <= blk:
        return _flash_block(qf, k_cur.float(), v_cur.float(), m, l, acc,
                            scale)
    for start in range(0, nk, blk):
        kb = k_cur[:, start:start + blk].float()
        vb = v_cur[:, start:start + blk].float()
        m, l, acc = _flash_block(qf, kb, vb, m, l, acc, scale)
    return m, l, acc


def _ring(qf, k, v, axis: str, state, quant: Optional[str],
          block: Optional[int]):
    """Rotate (k, v) around ``axis``, folding each shard's block into
    ``state`` (m, l, acc). ``quant`` (default ``CDT_COLLECTIVE_QUANT``):
    ``"int8"`` quantises each shard's block once and rotates the int8
    payloads with their scales, ``"none"`` is exact; ``block`` defaults
    to ``CDT_RING_BLOCK``."""
    from ..parallel.collectives import (ring_start, wire_dequantize,
                                        wire_quantize)
    from ..parallel.mesh import axis_group

    n = axis_group(axis).size
    scale = 1.0 / (qf.shape[-1] ** 0.5)
    quant = quant or constants.collective_quant()
    blk = constants.ring_block() if block is None else block
    payload = ([*wire_quantize(k), *wire_quantize(v)] if quant == "int8"
               else [k, v])
    m, l, acc = state
    for hop in range(n):
        pending = ring_start(payload, axis) if hop < n - 1 else None
        if quant == "int8":
            kq, ks, vq, vs = payload
            k_cur, v_cur = wire_dequantize(kq, ks), wire_dequantize(vq, vs)
        else:
            k_cur, v_cur = payload
        m, l, acc = _hop_attend(qf, k_cur, v_cur, m, l, acc, scale, blk)
        if pending is not None:
            payload = pending.wait()
    return acc / l.transpose(1, 2)[..., None]


def _empty_state(q: torch.Tensor):
    B, Nq, H, D = q.shape
    m = torch.full((B, H, Nq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Nq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Nq, H, D), dtype=torch.float32, device=q.device)
    return m, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = constants.AXIS_SEQUENCE,
                   quant: Optional[str] = None,
                   block: Optional[int] = None) -> torch.Tensor:
    """Exact attention with K/V sharded over ``axis``: every shard holds
    [B, N/s, H, D] of q/k/v and gets its queries' outputs. Under the
    int8 wire (``quant``, default ``CDT_COLLECTIVE_QUANT``) every
    contribution carries one quantisation round (``absmax/254``)."""
    qf = q.float()
    return _ring(qf, k, v, axis, _empty_state(q), quant, block).to(q.dtype)


def joint_ring_attention(q: torch.Tensor, txt_k: torch.Tensor,
                         txt_v: torch.Tensor, img_k: torch.Tensor,
                         img_v: torch.Tensor,
                         axis: str = constants.AXIS_SEQUENCE,
                         quant: Optional[str] = None,
                         block: Optional[int] = None) -> torch.Tensor:
    """Ring attention over a joint text + image sequence (MMDiT): the
    image K/V are sharded and rotate; the short text K/V, replicated on
    every shard, are folded in once, first. ``q`` may mix text and image
    queries. The int8 wire applies to the rotating image K/V only."""
    qf = q.float()
    scale = 1.0 / (q.shape[-1] ** 0.5)
    state = _flash_block(qf, txt_k.float(), txt_v.float(), *_empty_state(q),
                         scale)
    return _ring(qf, img_k, img_v, axis, state, quant, block).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: str = constants.AXIS_SEQUENCE) -> torch.Tensor:
    """Exact attention by head redistribution: [B, N/s, H, D] shards go
    all-to-all to [B, N, H/s, D], attend locally (``full_attention``: the
    kernels on the card) and go back. Needs H divisible by the shards."""
    from ..parallel.collectives import all_to_all_heads
    from ..parallel.mesh import axis_group

    n = axis_group(axis).size
    H = q.shape[2]
    if H % n:
        raise ValueError(
            f"ulysses needs heads ({H}) divisible by shards ({n})")

    def to_heads(x):
        return all_to_all_heads(x, axis, split_dim=2, concat_dim=1)

    out = full_attention(to_heads(q), to_heads(k), to_heads(v))
    return all_to_all_heads(out, axis, split_dim=1, concat_dim=2)
