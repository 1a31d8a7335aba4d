"""Collectives over one mesh axis (counterpart of the JAX package's
``parallel/collectives.py``).

Called inside a program that runs on every rank (``parallel/programs``,
the current mesh set by ``use_mesh``), with an axis name, as the JAX
functions are called inside ``shard_map``. On a one-rank axis each is
the identity.

The ranks of an axis talk over its process group: gloo where ranks share
a card or run on the CPU, NCCL where each rank has a card of its own
(``parallel/bootstrap.choose_backend``). Gloo has no CUDA transport, so a
CUDA tensor on a gloo group is staged through host memory: copied to
the host, sent, received into a host buffer and copied back to the
rank's card. That staging lives here (``_to_wire``/``_from_wire``) and
nowhere else. Payloads that are only moved (gathers, all-to-all, ring
hops) travel as their raw bytes, whatever their dtype.

``tp_sum`` is the tensor-parallel sum (GSPMD's all-reduce after a
row-parallel product, ``parallel/tensor.row_parallel``): one fused
all-reduce over the axis group, in the payload's own dtype (bf16 on the
card: over two ranks the sum of two bf16 partials rounds once, as the
fp32 sum cast back would; fp32 in the CPU tests). Every rank receives
the same bits, so the replicated activations stay equal on every rank.

The ring's opt-in int8 wire (``CDT_COLLECTIVE_QUANT=int8``: per-tensor
absmax scale, EQuARX) lives here too: ``wire_quantize`` before a hop,
``wire_dequantize`` after it, one rounding of at most ``absmax/254`` an
element.

Point-to-point hops carry a tag from the group's counter, which every
rank advances in the same order (the programs are SPMD), so two hops in
flight at once never cross.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils import constants
from .mesh import AxisGroup, axis_group


def _to_wire(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    x = x.detach().contiguous()
    return x.cpu() if g.staged and x.is_cuda else x


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(like.device) if t.device != like.device else t


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).view(torch.uint8)


def _next_tag(g: AxisGroup, n: int = 1) -> int:
    tag = getattr(g, "_tag", 0)
    g._tag = (tag + n) % (1 << 24)
    return tag


class Exchange:
    """Payloads in flight to one peer and from another: ``wait()``
    returns what arrived, on the payloads' devices."""

    def __init__(self, g: AxisGroup, payloads: Sequence[torch.Tensor],
                 dst: int, src: int):
        self._like = list(payloads)
        self._keep, self._bufs, self._works = [], [], []
        tag = _next_tag(g, len(payloads))
        for i, x in enumerate(payloads):
            w = _bytes(_to_wire(x, g))
            buf = torch.empty_like(w)
            self._keep.append(w)
            self._bufs.append(buf)
            self._works.append(g.pg.send([w], dst, tag + i))
            self._works.append(g.pg.recv([buf], src, tag + i))

    def wait(self) -> list[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._keep = []
        return [_from_wire(b.view(x.dtype).view(x.shape), x)
                for b, x in zip(self._bufs, self._like)]


class _Done:
    def __init__(self, payloads):
        self._payloads = list(payloads)

    def wait(self) -> list[torch.Tensor]:
        return self._payloads


def shard_index(axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return axis_group(axis).index


def ring_start(payloads: Sequence[torch.Tensor], axis: str,
               shift: int = 1):
    """Start one ring hop of ``payloads``: shard i sends to i+shift and
    receives from i−shift. Returns a handle whose ``wait()`` gives the
    received payloads; the caller computes meanwhile."""
    g = axis_group(axis)
    if shift % g.size == 0:         # every shard keeps its own
        return _Done(payloads)
    # the group's process group numbers its ranks by coordinate
    return Exchange(g, payloads, (g.index + shift) % g.size,
                    (g.index - shift) % g.size)


def ring_shift(x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
    """Rotate shards around the ring: shard i receives shard i−shift
    (JAX's ``ppermute``)."""
    return ring_start([x], axis, shift).wait()[0]


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """One fused all-gather: every shard's ``x`` concatenated along
    ``dim`` in coordinate order (shapes must agree)."""
    g = axis_group(axis)
    if g.size == 1:
        return x
    w = _bytes(_to_wire(x, g))
    outs = [torch.empty_like(w) for _ in range(g.size)]
    g.pg.allgather([outs], [w]).wait()
    parts = [_from_wire(o.view(x.dtype).view(x.shape), x) for o in outs]
    return torch.cat(parts, dim=dim)


def tp_sum(x: torch.Tensor, axis: str = constants.AXIS_TENSOR
           ) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis`` (module docstring); the
    identity on a one-rank axis. ``x`` is a fresh partial product: the
    sum may reuse its memory."""
    g = axis_group(axis)
    if g.size == 1:
        return x
    w = _to_wire(x, g)
    g.pg.allreduce([w]).wait()
    return _from_wire(w, x)


def gather_batch(x: torch.Tensor,
                 axis: str = constants.AXIS_DATA) -> torch.Tensor:
    """All-gather along dim 0 in participant (coordinate) order: index 0,
    the master, first."""
    return all_gather(x, axis, dim=0)


def all_to_all_heads(x: torch.Tensor, axis: str, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all (Ulysses): ``x`` split ``n`` ways along
    ``split_dim``, block j sent to shard j; the blocks received
    concatenated along ``concat_dim`` in source order."""
    g = axis_group(axis)
    n = g.size
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"must divide over {n} shards")
    blocks = torch.stack(torch.chunk(x, n, dim=split_dim))   # [n, ...]
    w = _to_wire(blocks, g)
    out = torch.empty_like(w)
    g.pg.alltoall_base(_bytes(out), _bytes(w), [], []).wait()
    got = _from_wire(out, x)
    return torch.cat(list(got.unbind(0)), dim=concat_dim)


def wire_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8: ``(q, scale)``, ``scale`` an fp32 scalar;
    an all-zero payload has scale 0 and comes back exact."""
    xf = x.float()
    absmax = xf.abs().max()
    scale = absmax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe), -127, 127)
    return q.to(torch.int8), scale.float()


def wire_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
