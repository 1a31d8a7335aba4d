"""Offloaded FLUX and WAN transformers on one card (the port's
``diffusion/offload.py``, after the JAX package's).

A transformer whose bf16 weights crowd the card (FLUX.1 [dev]: 11.9 B
parameters, 23.8 GB; a WAN 14B expert: 28.6 GB; WAN 2.2's two: 57.2 GB)
runs with its transformer blocks packed:

- each block's leaves go into one flat buffer per dtype. Under
  ``float8_e4m3fn`` (the default, ``CDT_OFFLOAD_STREAM_DTYPE``) every
  float leaf with at least two axes and 4096 elements is quantised to
  e4m3 with one absmax scale per output channel, JAX's
  ``_should_quantize_meta``. The output channel is the JAX layout's last
  axis: axis 0 of a port ``Linear`` weight ([out, in]), the last axis of
  a leaf both packages store alike (WAN's fp32 ``modulation`` [1, 6,
  dim]). A leaf dequantises as ``(q.float() * scale).to(dtype)``, JAX's
  arithmetic, so equal bytes give equal weights;
- ``plan_offload`` places the blocks in execution order under the
  resident budget (``CDT_OFFLOAD_RESIDENT_GB``) after the glue (the
  embedders and the head, which stay on the card). When every block fits,
  each kind's blocks are stacked on the card. Otherwise the blocks past
  the budget live in pinned host memory and are copied on a side stream
  into two card slots a kind: the compute waits on the copy's event, and
  the copy of a block waits on the end of the block that last read its
  slot, so at most the current block and the next are in flight (JAX's
  backpressure, here without a host synchronisation);
- a block runs the port's own ``DoubleBlock``, ``SingleBlock`` or
  ``WanBlock`` forward over its dequantised weights through
  ``torch.func.functional_call`` on a ``meta``-device template: no second
  copy of the module exists. Attention in the blocks goes through
  ``ops.attention.full_attention`` as in the resident model (the
  one-head kernel at FLUX's and WAN's widths);
- ``_QuantCache`` (``CDT_OFFLOAD_CACHE_DIR``) keeps packed blocks on disk
  under a fingerprint of the block weights; a cache it cannot use means
  quantising again, never a failure.

Block weights come from a block source: ``ModuleBlocks`` reads a module's
own parameters (a resident bundle, or a core kept in host memory, copied
to the card block by block); an offload bundle's ``models/registry.
DrawnBlocks`` draws each block on the card from the generator state saved
before it, so such a bundle never holds its bf16 blocks whole.

Departures from the JAX module, each because the port runs eagerly: a
fully resident executor runs its forward block by block over the stacked
rows (JAX scans one compiled program); every executor, resident or
streamed, samples through one ladder, ``sample_ladder``: any sampler's
program a step at a time, an interrupt checked before every step (JAX
compiles a resident executor's whole ladder and keeps a separate
euler-only host loop for streamed ones; ``require_ladder`` keeps JAX's
euler-only refusal for those cases all the same); the glue stays the model's own
modules (released with the bundle, not the store); the quant cache's
fingerprint is a SHA-256 over sampled bytes (JAX's uses its native
``hash64``) and its entries live under ``CDT_OFFLOAD_CACHE_DIR/torch``;
an SD3-family learned position table is refused (JAX's embed adds a
sinusoidal table in its place); progress comes from ``wrap_denoiser``
on the denoiser in every ladder mode.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import threading
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.dit import (DoubleBlock, SingleBlock, _layer_norm, _modulate,
                          image_ids, patchify, rope_freqs, sincos_2d,
                          unpatchify)
from ..models.layers import timestep_embedding
from ..models.wan import WanBlock, video_ids
from ..models.wan import _layer_norm as _wan_layer_norm
from ..utils import constants
from ..utils.logging import log
from .samplers import Denoiser, NoiseSource, make_program, run_segment

GLUE_KEYS = ("img_in", "txt_in", "time_in", "vector_in", "guidance_in",
             "final_mod", "img_out")
WAN_GLUE_KEYS = ("patch_embedding", "time_emb_0", "time_emb_2",
                 "time_proj_1", "text_emb_0", "text_emb_2",
                 "head_modulation", "head")

F8 = constants.F8_NAME
F8_MAX = 448.0               # the largest finite e4m3fn magnitude
QUANT_MIN_SIZE = 4096        # only matrices are worth quantising
SCALE = "scale"              # the fp32 buffer of the per-channel scales


# --- knobs ----------------------------------------------------------------------


def offload_enabled(default: bool = False) -> bool:
    """``CDT_OFFLOAD``; unset gives ``default`` (off on server paths)."""
    value = constants.offload()
    return default if value is None else value


def resident_budget_bytes() -> int:
    return int(constants.offload_resident_gb() * (1 << 30))


def stream_dtype_default() -> str:
    return constants.offload_stream_dtype()


def ladder_mode() -> str:
    """``jit`` or ``step``: JAX's compiled or per-step ladder. The port
    runs one ladder either way (``sample_ladder``); the knob keeps only
    JAX's refusal of a sampler other than euler in ``step`` mode
    (``require_ladder``)."""
    return constants.offload_ladder()


def normalize_stream_dtype(sd: Optional[str]) -> str:
    """The canonical stream dtype (``float8_e4m3fn`` or ``native``), one
    definition for the executors and every cache key over them."""
    return stream_dtype_default() if not sd else constants.stream_dtype_name(sd)


# --- layout: which leaves quantise, where each lands ----------------------------


def should_quantize(shape, dtype: torch.dtype, quantize: bool) -> bool:
    """JAX's ``_should_quantize_meta``: one predicate for the planner and
    the packer, on shapes alone (a ``meta`` module plans)."""
    return (quantize and len(shape) >= 2 and dtype.is_floating_point
            and math.prod(int(s) for s in shape) >= QUANT_MIN_SIZE)


def scale_axis(block: nn.Module, name: str) -> int:
    """The axis of one scale per output channel of leaf ``name``: the JAX
    layout's last axis. A ``Linear``'s or a convolution's weight is stored
    [out, in, ...] here and [..., in, out] there (``models/from_jax.py``),
    so its axis is 0; every other leaf has JAX's layout."""
    owner, _, leaf = name.rpartition(".")
    module = block.get_submodule(owner) if owner else block
    if leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv2d,
                                                nn.Conv3d)):
        return 0
    param = getattr(module, leaf)
    return param.ndim - 1


def buffer_dtype(key: str) -> torch.dtype:
    """The element type of a packed buffer: the fp8 bytes are kept as
    ``uint8`` (viewed as ``float8_e4m3fn`` at use), the scales as fp32,
    every other buffer in its leaves' dtype."""
    if key == F8:
        return torch.uint8
    if key == SCALE:
        return torch.float32
    return getattr(torch, key)


def _dtype_key(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Leaf:
    """Where one leaf of a block lives in the packed buffers."""
    name: str
    buf: str
    offset: int
    shape: tuple
    scale_offset: int        # -1: stored as it is
    axis: int                # the scale axis of a quantised leaf
    dtype: torch.dtype

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A block kind's packed layout: its leaves in parameter order and the
    length of each buffer."""
    leaves: tuple
    sizes: tuple             # ((key, length), ...)

    @property
    def nbytes(self) -> int:
        return sum(n * torch.empty((), dtype=buffer_dtype(k)).element_size()
                   for k, n in self.sizes)

    def rows(self) -> list:
        """JSON rows of the leaves (the quant cache's manifest)."""
        return [[l.name, l.buf, l.offset, list(l.shape), l.scale_offset,
                 l.axis, _dtype_key(l.dtype)] for l in self.leaves]


def block_layout(block: nn.Module, quantize: bool) -> Layout:
    """The packed layout of ``block`` (any device, ``meta`` too)."""
    offsets: dict[str, int] = {}
    leaves = []
    for name, p in block.named_parameters():
        shape = tuple(int(s) for s in p.shape)
        if should_quantize(shape, p.dtype, quantize):
            axis = scale_axis(block, name)
            off, s_off = offsets.get(F8, 0), offsets.get(SCALE, 0)
            leaves.append(Leaf(name, F8, off, shape, s_off, axis, p.dtype))
            offsets[F8] = off + math.prod(shape)
            offsets[SCALE] = s_off + shape[axis]
        else:
            key = _dtype_key(p.dtype)
            off = offsets.get(key, 0)
            leaves.append(Leaf(name, key, off, shape, -1, -1, p.dtype))
            offsets[key] = off + math.prod(shape)
    return Layout(tuple(leaves), tuple(offsets.items()))


def block_packed_bytes(block: nn.Module, quantize: bool) -> int:
    """Packed bytes of one block, without packing it."""
    return block_layout(block, quantize).nbytes


def _kind_of(name: str) -> str:
    """``double_3`` → ``double``: every block of a kind shares a layout."""
    return name.rsplit("_", 1)[0]


def block_names(module: nn.Module, prefixes: tuple) -> list[str]:
    """The blocks of ``module`` in execution order (``prefixes`` in
    order, each kind by index)."""
    children = [n for n, _ in module.named_children()]
    order = []
    for prefix in prefixes:
        names = [n for n in children if n.startswith(prefix + "_")
                 and n[len(prefix) + 1:].isdigit()]
        order += sorted(names, key=lambda n: int(n.rsplit("_", 1)[1]))
    return order


def _glue_objects(module: nn.Module, glue_keys: tuple) -> dict:
    """The glue of ``module`` present under ``glue_keys``: child modules,
    or parameters of the module itself (WAN's ``head_modulation``)."""
    out = {}
    for key in glue_keys:
        obj = getattr(module, key, None)
        if isinstance(obj, (nn.Module, torch.Tensor)):
            out[key] = obj
    return out


def _tensor_bytes(obj) -> int:
    tensors = obj.parameters() if isinstance(obj, nn.Module) else [obj]
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_offload(module: nn.Module, budget: int,
                 stream_dtype: Optional[str] = None,
                 block_prefixes: tuple = ("double", "single"),
                 glue_keys: tuple = GLUE_KEYS) -> dict:
    """Which blocks would be resident and which streamed under
    ``budget`` bytes, without building anything: the glue counts first,
    then each block in execution order while it fits (JAX's plan, with
    the glue's bytes beside it). Works on a module built on the ``meta``
    device (a full-width plan in a test)."""
    quantize = normalize_stream_dtype(stream_dtype) == F8
    order = block_names(module, block_prefixes)
    glue = sum(_tensor_bytes(o) for o in
               _glue_objects(module, glue_keys).values())
    used = glue
    resident, streamed, streamed_bytes = [], [], 0
    sizes: dict[str, int] = {}
    for name in order:
        kind = _kind_of(name)
        if kind not in sizes:
            sizes[kind] = block_packed_bytes(getattr(module, name), quantize)
        size = sizes[kind]
        if used + size <= budget:
            resident.append(name)
            used += size
        else:
            streamed.append(name)
            streamed_bytes += size
    return {"order": order, "resident": resident, "streamed": streamed,
            "resident_bytes": used, "streamed_bytes": streamed_bytes,
            "glue_bytes": glue, "fully_resident": not streamed}


# --- quantise, pack, dequantise ----------------------------------------------------


def quantize_leaf(a: torch.Tensor, axis: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``a`` → (e4m3 ``q`` in ``a``'s layout, fp32 ``scale`` over
    ``axis``): JAX's ``_flatten_block`` arithmetic in fp32 (absmax over
    every other axis, a zero channel scaled by 1, ``w / scale`` rounded
    to nearest even)."""
    w = a.float()
    reduce = tuple(d for d in range(a.ndim) if d != axis)
    absmax = w.abs().amax(dim=reduce)
    # a tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, which can round differently from numpy's division
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, F8_MAX))
    view = [1] * a.ndim
    view[axis] = -1
    return (w / scale.view(view)).to(torch.float8_e4m3fn), scale


def empty_buffers(layout: Layout, device, pin: bool = False) -> dict:
    return {k: torch.empty(n, dtype=buffer_dtype(k), device=device,
                           pin_memory=pin)
            for k, n in layout.sizes}


@torch.no_grad()
def pack_block(params: Mapping[str, torch.Tensor], layout: Layout,
               out: Optional[dict] = None,
               device: Optional[torch.device] = None) -> dict:
    """A block's parameters → its packed buffers (``out``, or new ones on
    ``device``: by default the parameters'), quantising on that device."""
    if out is None:
        dev = device or next(iter(params.values())).device
        out = empty_buffers(layout, dev)
    for leaf in layout.leaves:
        buf = out[leaf.buf]
        a = params[leaf.name].detach().to(buf.device)
        seg = buf[leaf.offset:leaf.offset + leaf.numel]
        if leaf.scale_offset >= 0:
            q, scale = quantize_leaf(a, leaf.axis)
            seg.copy_(q.view(torch.uint8).reshape(-1))
            out[SCALE][leaf.scale_offset:leaf.scale_offset
                       + scale.numel()].copy_(scale)
        else:
            seg.copy_(a.reshape(-1))
    return out


def unpack_block(bufs: Mapping[str, torch.Tensor],
                 layout: Layout) -> dict[str, torch.Tensor]:
    """Packed buffers → the block's parameters: views of the native
    buffers, dequantised copies of the fp8 leaves."""
    out = {}
    for leaf in layout.leaves:
        seg = bufs[leaf.buf][leaf.offset:leaf.offset + leaf.numel]
        if leaf.scale_offset < 0:
            out[leaf.name] = seg.view(leaf.shape)
            continue
        n = leaf.shape[leaf.axis]
        view = [1] * len(leaf.shape)
        view[leaf.axis] = n
        scale = bufs[SCALE][leaf.scale_offset:leaf.scale_offset + n]
        q = seg.view(torch.float8_e4m3fn).view(leaf.shape)
        out[leaf.name] = (q.float() * scale.view(view)).to(leaf.dtype)
    return out


# --- block sources ------------------------------------------------------------------


class ModuleBlocks:
    """A module's own block weights: a resident core's, or a host-held
    core's, copied to the card one block at a time."""

    def __init__(self, module: nn.Module):
        self.module = module

    def block_params(self, name: str, device) -> dict[str, torch.Tensor]:
        return {n: p.detach().to(device)
                for n, p in getattr(self.module, name).named_parameters()}

    def done(self, name: str) -> None:
        """The executor is through with block ``name``'s weights."""


# --- the quant cache -------------------------------------------------------------


def quant_cache_dir() -> Optional[str]:
    return constants.offload_cache_dir() or None


@torch.no_grad()
def params_fingerprint(source, names: list, device) -> str:
    """Content fingerprint of the block weights: per leaf its name,
    shape, dtype and at most 4096 bytes sampled at an even stride (a
    checkpoint whose changes all fall between the samples is the blind
    spot, as in JAX's). Reads every block once through ``source``."""
    h = hashlib.sha256(b"cdt-torch-quant-cache-v1|e4m3-perchannel")
    for name in names:
        for pname, p in source.block_params(name, device).items():
            raw = p.detach().contiguous().reshape(-1).view(torch.uint8)
            stride = max(1, raw.numel() // 4096)
            h.update(f"{name}.{pname}|{tuple(p.shape)}|{p.dtype}|".encode())
            h.update(raw[::stride][:4096].cpu().numpy().tobytes())
        source.done(name)
    return h.hexdigest()[:16]


class _QuantCache:
    """Packed blocks as ``<name>.<buffer>.npy`` byte files and a JSON
    manifest of the layouts, in a fingerprint-named subdirectory of
    ``<root>/torch``: builds of different weights sharing one root never
    read each other's files. Writes are a temporary file and a rename. A
    manifest whose layouts are not the module's, or an entry that cannot
    be read, means quantising again (logged), never a failure."""

    def __init__(self, root: str, fingerprint: str, layouts: dict):
        self.fingerprint = fingerprint
        self.dir = Path(root) / "torch" / fingerprint
        self.dir.mkdir(parents=True, exist_ok=True)   # may raise: see open
        self.manifest = self.dir / "manifest.json"
        self.layouts = layouts
        self.valid = False
        try:
            m = json.loads(self.manifest.read_text())
            self.valid = (m.get("fingerprint") == fingerprint
                          and m.get("layouts") == {k: v.rows()
                                                   for k, v in layouts.items()})
        except (OSError, ValueError, TypeError, AttributeError):
            pass

    def _path(self, name: str, key: str) -> Path:
        return self.dir / f"{name}.{key}.npy"

    def load(self, name: str) -> Optional[dict]:
        if not self.valid:
            return None
        layout = self.layouts[_kind_of(name)]
        out = {}
        for key, n in layout.sizes:
            path = self._path(name, key)
            try:
                arr = np.load(path)
                dt = buffer_dtype(key)
                width = torch.empty((), dtype=dt).element_size()
                if arr.dtype != np.uint8 or arr.shape != (n * width,):
                    raise ValueError(f"{arr.dtype}{arr.shape}, want "
                                     f"{n * width} bytes")
                out[key] = torch.from_numpy(arr).view(dt)
            except (OSError, ValueError, TypeError) as e:
                log(f"offload: quant cache entry {path} unreadable ({e}); "
                    "quantising the block again")
                return None
        return out

    def save(self, name: str, bufs: dict) -> None:
        for key, t in bufs.items():
            path = self._path(name, key)
            tmp = path.with_suffix(".tmp.npy")
            try:
                np.save(tmp, t.detach().cpu().contiguous().view(torch.uint8)
                        .numpy())
                os.replace(tmp, path)
            except OSError:
                return

    def finalize(self) -> None:
        payload = json.dumps({"fingerprint": self.fingerprint,
                              "layouts": {k: v.rows()
                                          for k, v in self.layouts.items()}})
        tmp = self.manifest.with_suffix(".tmp")
        try:
            tmp.write_text(payload)
            os.replace(tmp, self.manifest)
        except OSError:
            return
        self.valid = True


def _open_quant_cache(root: str, fingerprint: str,
                      layouts: dict) -> Optional[_QuantCache]:
    """Never fatal: a directory that cannot be made means no cache."""
    try:
        return _QuantCache(root, fingerprint, layouts)
    except OSError as e:
        log(f"offload: quant cache under {root} unusable ({e}); not caching")
        return None


# --- the block store -------------------------------------------------------------


def _budget(resident_bytes: Optional[int]) -> int:
    return (resident_budget_bytes() if resident_bytes is None
            else int(resident_bytes))


def _glue_device(module: nn.Module, glue_keys: tuple) -> torch.device:
    for obj in _glue_objects(module, glue_keys).values():
        t = next(obj.parameters()) if isinstance(obj, nn.Module) else obj
        if t.device.type != "meta":
            return t.device
    raise ValueError("offload: the module's glue is on no device")


class _BlockStore:
    """The substrate both executors share: the plan, the packed blocks
    (stacked, resident or streamed), the two card slots a streamed kind
    copies into, and the glue on the card."""

    prefixes: tuple = ()
    glue_keys: tuple = ()

    def _template(self, kind: str) -> nn.Module:
        raise NotImplementedError

    @classmethod
    def streams(cls, module: nn.Module, resident_bytes: Optional[int] = None,
                stream_dtype: Optional[str] = None) -> bool:
        """Whether an executor of ``module`` built with these arguments
        would stream blocks: its plan, without building it."""
        plan = plan_offload(module, _budget(resident_bytes),
                            normalize_stream_dtype(stream_dtype),
                            cls.prefixes, cls.glue_keys)
        return not plan["fully_resident"]

    def _build(self, module: nn.Module, source, budget: int,
               stream_dtype: Optional[str], expected_blocks: int,
               device) -> None:
        sd = normalize_stream_dtype(stream_dtype)
        self.stream_dtype = sd
        quantize = sd == F8
        self.module = module
        self.device = torch.device(device) if device is not None else \
            _glue_device(module, self.glue_keys)
        self.source = source if source is not None else ModuleBlocks(module)
        self.plan = plan_offload(module, budget, sd, self.prefixes,
                                 self.glue_keys)
        order = self.plan["order"]
        if len(order) != expected_blocks:
            # a partly restored or mis-converted model must fail at the
            # build, not run fewer blocks into a plausible wrong image
            raise ValueError(
                f"offload: the module holds {len(order)} transformer blocks "
                f"({self.prefixes}) but its config declares {expected_blocks}")
        self.block_order = order
        kinds = list(dict.fromkeys(_kind_of(n) for n in order))
        with torch.device("meta"):
            self.templates = {k: self._template(k).eval() for k in kinds}
        self.layouts = {k: block_layout(self.templates[k], quantize)
                        for k in kinds}
        self.stacked: dict[str, dict] = {}
        self.resident: dict[str, dict] = {}
        self.streamed: dict[str, dict] = {}
        self._rows: dict[str, tuple] = {}
        self._slots: dict[tuple, dict] = {}
        self._slot_free: dict[tuple, object] = {}
        self._slot_of: dict[str, tuple] = {}
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.released = False
        self._place_glue()

        cache = None
        if quantize and quant_cache_dir() and order:
            cache = _open_quant_cache(
                quant_cache_dir(),
                params_fingerprint(self.source, order, self.device),
                self.layouts)

        def packed(name: str, out: Optional[dict] = None) -> dict:
            """The block's buffers: from the cache, else quantised from
            the source (and cached)."""
            layout = self.layouts[_kind_of(name)]
            bufs = cache.load(name) if cache is not None else None
            if bufs is not None:
                if out is None:
                    return {k: v.to(self.device) for k, v in bufs.items()}
                for k, v in bufs.items():
                    out[k].copy_(v)
                return out
            bufs = pack_block(self.source.block_params(name, self.device),
                              layout, out=out, device=self.device)
            self.source.done(name)
            if cache is not None:
                cache.save(name, bufs)
            return bufs

        if self.plan["fully_resident"]:
            for kind in kinds:
                names = [n for n in order if _kind_of(n) == kind]
                rows = {k: torch.empty((len(names), n), dtype=buffer_dtype(k),
                                       device=self.device)
                        for k, n in self.layouts[kind].sizes}
                for i, name in enumerate(names):
                    packed(name, {k: v[i] for k, v in rows.items()})
                    self._rows[name] = (kind, i)
                self.stacked[kind] = rows
        else:
            resident = set(self.plan["resident"])
            count: dict[str, int] = {}
            for name in order:
                if name in resident:
                    self.resident[name] = packed(name)
                    continue
                kind = _kind_of(name)
                host = empty_buffers(self.layouts[kind], "cpu", pin=cuda)
                bufs = packed(name)
                for k, v in bufs.items():
                    host[k].copy_(v)
                del bufs
                self.streamed[name] = host
                j = count.get(kind, 0)
                count[kind] = j + 1
                self._slot_of[name] = (kind, j % 2)
        if cache is not None and not cache.valid:
            cache.finalize()
        self.resident_bytes = self.plan["resident_bytes"]
        self.streamed_bytes = self.plan["streamed_bytes"]

    def _place_glue(self) -> None:
        """The glue on the card: the module's own (a resident or drawn
        core), or copies of a host-held core's, which the store owns."""
        self.glue: dict = {}
        self._own_glue = False
        for key, obj in _glue_objects(self.module, self.glue_keys).items():
            t = next(obj.parameters()) if isinstance(obj, nn.Module) else obj
            if t.device != self.device:
                obj = copy.deepcopy(obj).to(self.device)
                self._own_glue = True
            self.glue[key] = obj

    def store_bytes(self) -> int:
        """Card bytes the store holds: stacked, resident, the slots and
        any glue it owns."""
        total = 0
        for group in (list(self.stacked.values()) + list(self.resident.values())
                      + list(self._slots.values())):
            total += sum(t.numel() * t.element_size() for t in group.values())
        if self._own_glue:
            total += sum(_tensor_bytes(o) for o in self.glue.values())
        return total

    def _slot(self, key: tuple) -> dict:
        slot = self._slots.get(key)
        if slot is None:
            slot = empty_buffers(self.layouts[key[0]], self.device)
            self._slots[key] = slot
            if self._copy_stream is not None:
                # the allocator may hand out memory that work queued on the
                # compute stream still reads: the first copy waits for it
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
                self._slot_free[key] = event
        return slot

    def _blocks(self):
        """Yield ``(name, weights)`` in execution order. A streamed
        block's copy into its slot is issued one block ahead, on the side
        stream after the event of the block that last read that slot; the
        compute stream waits on the copy's event before dequantising."""
        if self.released:
            raise RuntimeError("offload executor released: build a new one")
        order = self.block_order
        cuda = self._copy_stream is not None
        ready: dict[int, object] = {}

        def issue(i: int) -> None:
            name = order[i]
            if name not in self.streamed:
                return
            key = self._slot_of[name]
            slot = self._slot(key)
            src = self.streamed[name]
            if not cuda:
                for k, v in src.items():
                    slot[k].copy_(v)
                return
            free = self._slot_free.get(key)
            if free is not None:
                self._copy_stream.wait_event(free)
            with torch.cuda.stream(self._copy_stream):
                for k, v in src.items():
                    slot[k].copy_(v, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
            ready[i] = event

        compute = torch.cuda.current_stream(self.device) if cuda else None
        issue(0)
        for i, name in enumerate(order):
            if i + 1 < len(order):
                issue(i + 1)
            kind = _kind_of(name)
            if name in self.streamed:
                key = self._slot_of[name]
                if cuda:
                    compute.wait_event(ready.pop(i))
                bufs = self._slots[key]
            elif name in self._rows:
                kind, row = self._rows[name]
                bufs = {k: v[row] for k, v in self.stacked[kind].items()}
            else:
                bufs = self.resident[name]
            yield name, unpack_block(bufs, self.layouts[kind])
            if cuda and name in self.streamed:
                event = torch.cuda.Event()
                event.record(compute)
                self._slot_free[self._slot_of[name]] = event

    def release(self) -> None:
        release_store(self)


def release_store(obj) -> None:
    """Free every card buffer a store holds (stacked, resident, slots, the
    glue it owns) and its pinned host blocks: the dual-expert swap places
    the other expert in that memory. The executor is dead afterwards."""
    if getattr(obj, "_copy_stream", None) is not None:
        obj._copy_stream.synchronize()
    obj.stacked, obj.resident, obj.streamed = {}, {}, {}
    obj._rows, obj._slots, obj._slot_free = {}, {}, {}
    if getattr(obj, "_own_glue", False):
        obj.glue = {}
    obj.released = True


# --- FLUX ------------------------------------------------------------------------


class OffloadedFlux(_BlockStore):
    """FLUX-class DiT on one card with packed, resident or streamed blocks.
    ``forward`` equals ``DiT.forward`` (exactly under ``native``, to the
    quantisation under fp8)."""

    prefixes = ("double", "single")
    glue_keys = GLUE_KEYS

    def __init__(self, dit: nn.Module, source=None,
                 resident_bytes: Optional[int] = None, device=None,
                 stream_dtype: Optional[str] = None):
        self.cfg = dit.config
        if self.cfg.pos_embed == "learned":
            raise ValueError(
                "offload runs FLUX-class DiTs (RoPE or sinusoidal "
                "positions); an SD3-family learned position table is not "
                "part of the offload glue")
        self._build(dit, source, _budget(resident_bytes), stream_dtype,
                    self.cfg.depth_double + self.cfg.depth_single, device)
        self._pe_key = None
        self._pe = (None, None, None)

    def _template(self, kind: str) -> nn.Module:
        return (DoubleBlock if kind == "double" else SingleBlock)(self.cfg)

    def _rope_tables(self, H: int, W: int, txt_len: int):
        """Cached per (H, W, text length): the same every step."""
        cfg = self.cfg
        if cfg.pos_embed != "rope":
            return None, None, None
        key = (H, W, txt_len)
        if self._pe_key != key:
            p, dev = cfg.patch_size, self.device
            pe_img = rope_freqs(image_ids(H // p, W // p, dev), cfg.axes_dim,
                                cfg.rope_theta)
            pe_txt = rope_freqs(torch.zeros((txt_len, 3), dtype=torch.long,
                                            device=dev),
                                cfg.axes_dim, cfg.rope_theta)
            pe_full = (torch.cat([pe_txt[0], pe_img[0]], dim=0),
                       torch.cat([pe_txt[1], pe_img[1]], dim=0))
            self._pe_key, self._pe = key, (pe_img, pe_txt, pe_full)
        return self._pe

    def _embed(self, x, t, context, pooled, guidance):
        cfg, g = self.cfg, self.glue
        dt, p = cfg.torch_dtype, cfg.patch_size
        B, H, W, _ = x.shape
        img = g["img_in"](patchify(x.to(dt), p))
        if cfg.pos_embed == "sincos":
            img = img + sincos_2d(H // p, W // p, cfg.hidden,
                                  x.device)[None].to(dt)
        txt = g["txt_in"](context.to(dt))
        vec = g["time_in"](timestep_embedding(t * 1000.0, 256).to(dt))
        vec = vec + g["vector_in"](pooled.to(dt))
        if cfg.guidance_embed:
            gv = guidance if guidance is not None else torch.full(
                (B,), 3.5, device=x.device)
            vec = vec + g["guidance_in"](
                timestep_embedding(gv * 1000.0, 256).to(dt))
        return img, txt, vec

    def _head(self, img, vec):
        sh, sc, _ = self.glue["final_mod"](vec)
        img = _modulate(_layer_norm(img), sh, sc)
        return self.glue["img_out"](img.float())

    @torch.no_grad()
    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, pooled: torch.Tensor,
                guidance: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One velocity evaluation [B,h,w,C] (fp32), as ``DiT.forward``."""
        B, H, W, C = x.shape
        pe_img, pe_txt, pe_full = self._rope_tables(H, W, context.shape[1])
        img, txt, vec = self._embed(x, t, context, pooled, guidance)
        T = txt.shape[1]
        xcat = None
        for name, params in self._blocks():
            if name.startswith("double"):
                img, txt = functional_call(self.templates["double"], params,
                                           (img, txt, vec, pe_img, pe_txt))
            else:
                if xcat is None:
                    xcat = torch.cat([txt, img], dim=1)
                xcat = functional_call(self.templates["single"], params,
                                       (xcat, vec, pe_full))
        img = xcat[:, T:] if xcat is not None else img
        return unpatchify(self._head(img, vec), (H, W), self.cfg.patch_size,
                          C)

    def denoiser(self, context: torch.Tensor, pooled: torch.Tensor,
                 guidance: float) -> Denoiser:
        """The velocity denoiser ``x − σ·v`` of ``FlowPipeline``."""
        def denoise(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
            t = sigma.expand(x.shape[0])
            g = torch.full((x.shape[0],), guidance, device=x.device)
            return x - sigma * self.forward(x, t, context, pooled, g)

        return denoise


# --- WAN -------------------------------------------------------------------------


def i2v_input_concat(y: torch.Tensor, mask: torch.Tensor
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The i2v model input ``concat([x, mask, y])`` (one definition for
    the resident and the offloaded denoisers)."""
    def inp_fn(x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:4]
        return torch.cat([x, mask.expand(*lead, mask.shape[-1]),
                          y.expand(*lead, y.shape[-1])], dim=-1)

    return inp_fn


class OffloadedWan(_BlockStore):
    """WAN transformer on one card with packed, resident or streamed
    blocks (a WAN 14B expert: 40 blocks). CFG runs the cond and the
    uncond (a zero context) as two batch-1 forwards, halving the
    activations against the resident path's doubled batch."""

    prefixes = ("block",)
    glue_keys = WAN_GLUE_KEYS

    def __init__(self, wan: nn.Module, source=None,
                 resident_bytes: Optional[int] = None, device=None,
                 stream_dtype: Optional[str] = None):
        self.cfg = wan.config
        self._build(wan, source, _budget(resident_bytes), stream_dtype,
                    self.cfg.num_layers,
                    device)
        self._pe_key = None
        self._pe = None

    def _template(self, kind: str) -> nn.Module:
        return WanBlock(self.cfg)

    def _pe_tables(self, f: int, h: int, w: int):
        if self._pe_key != (f, h, w):
            self._pe = rope_freqs(video_ids(f, h, w, device=self.device),
                                  self.cfg.axes_dim, 10000.0)
            self._pe_key = (f, h, w)
        return self._pe

    def _embed(self, x, t, context):
        cfg, g = self.cfg, self.glue
        dt = cfg.torch_dtype
        B = x.shape[0]
        tok = g["patch_embedding"](x.to(dt).permute(0, 4, 1, 2, 3))
        tok = tok.flatten(2).transpose(1, 2)
        emb = timestep_embedding(t * 1000.0, cfg.freq_dim).to(dt)
        e = g["time_emb_2"](F.silu(g["time_emb_0"](emb)))
        e0 = g["time_proj_1"](F.silu(e)).view(B, 6, cfg.dim)
        ctx = g["text_emb_2"](F.gelu(g["text_emb_0"](context.to(dt)),
                                     approximate="tanh"))
        return tok, e0, e, ctx

    def _head(self, tok, e, shape):
        cfg = self.cfg
        B, Fr, H, W = shape
        pt, ph, pw = cfg.patch_size
        f, h, w = Fr // pt, H // ph, W // pw
        hm = (self.glue["head_modulation"] + e.float()[:, None, :]).to(
            cfg.torch_dtype)
        sh, sc = hm[:, 0, None, :], hm[:, 1, None, :]
        tok = _wan_layer_norm(tok, cfg.eps) * (1 + sc) + sh
        out = self.glue["head"](tok.float())
        o = cfg.out_channels
        out = out.view(B, f, h, w, pt, ph, pw, o)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return out.reshape(B, Fr, H, W, o)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """One velocity evaluation [B,F,h,w,C] (fp32), as
        ``WanModel.forward``."""
        B, Fr, H, W, _ = x.shape
        pt, ph, pw = self.cfg.patch_size
        pe = self._pe_tables(Fr // pt, H // ph, W // pw)
        tok, e0, e, ctx = self._embed(x, t, context)
        for _, params in self._blocks():
            tok = functional_call(self.templates["block"], params,
                                  (tok, e0, ctx, pe))
        return self._head(tok, e, (B, Fr, H, W))

    def denoiser(self, context: torch.Tensor, guidance_scale: float = 1.0,
                 inp_fn: Optional[Callable] = None,
                 on_call: Optional[Callable] = None) -> Denoiser:
        """``x − σ·v``; with CFG the cond and the uncond (zero context) as
        two sequential forwards. ``inp_fn`` maps the latent to the model
        input (i2v's concat); ``on_call`` counts the model calls."""
        uncond = torch.zeros_like(context)

        def model_call(x, sigma, ctx):
            if on_call is not None:
                on_call()
            t = sigma.expand(x.shape[0])
            inp = x if inp_fn is None else inp_fn(x)
            return x - sigma * self.forward(inp, t, ctx)

        if guidance_scale == 1.0:
            return lambda x, s: model_call(x, s, context)

        def denoise(x, sigma):
            cond = model_call(x, sigma, context)
            unc = model_call(x, sigma, uncond)
            return unc + guidance_scale * (cond - unc)

        return denoise


# --- the ladder and the executor cache ----------------------------------------------


def require_ladder(sampler: str, streamed: bool) -> None:
    """JAX's rule, kept for parity: a sampler other than euler is refused
    when an executor streams or ``CDT_OFFLOAD_LADDER=step``. JAX's
    per-step host loop implements only the euler update; the port's
    ``sample_ladder`` runs every sampler in either case."""
    if sampler != "euler" and (streamed or ladder_mode() == "step"):
        raise ValueError(
            "the per-step offloaded ladder supports euler only (got "
            f"{sampler!r}); fully resident executors with "
            "CDT_OFFLOAD_LADDER=jit run every sampler")


def sample_ladder(sampler: str, denoise: Denoiser, x: torch.Tensor,
                  sigmas: torch.Tensor, noise: Optional[NoiseSource] = None,
                  should_stop: Optional[Callable[[], bool]] = None
                  ) -> torch.Tensor:
    """Sampler ``sampler`` one step at a time over ``samplers``' program
    (bitwise ``samplers.sample``, so a streamed run equals a resident
    one), ``should_stop()`` checked before every step
    (``InterruptedError``). With a ``should_stop`` each step ends in a
    synchronisation: the card runs behind the host, and a check while
    the ladder is still queued would stop nothing."""
    program = make_program(sampler, denoise, sigmas, noise)
    init, _, extract = program
    state = init(x)
    steps = sigmas.shape[0] - 1
    for i in range(steps):
        if should_stop is not None and should_stop():
            raise InterruptedError(
                f"offloaded sampling interrupted at step {i}/{steps}")
        state = run_segment(program, state, i, 1)
        if should_stop is not None and x.is_cuda:
            torch.cuda.synchronize(x.device)
    return extract(state)


class ExecutorCache:
    """A pipeline's offload executors by expert (``"high"``, ``"low"``),
    each cached by its key (resident bytes, stream dtype, block source):
    a build under another key releases that expert's store first. Builds,
    fetches and releases hold one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cached: dict[str, tuple] = {}

    def get(self, which: str, key: tuple, build: Callable[[], _BlockStore]):
        with self._lock:
            cached = self._cached.get(which)
            if cached is not None and cached[0] == key:
                return cached[1]
            self._evict(which)
            off = build()
            self._cached[which] = (key, off)
            return off

    def _evict(self, which: str) -> None:
        cached = self._cached.pop(which, None)
        if cached is not None:
            cached[1].release()

    def evict(self, which: str) -> None:
        """Release expert ``which``'s store and drop it."""
        with self._lock:
            self._evict(which)

    def release(self) -> None:
        """Release every store."""
        with self._lock:
            for which in list(self._cached):
                self._evict(which)

    def experts(self) -> set:
        return set(self._cached)

    def stores(self) -> list:
        return [off for _, off in self._cached.values()]
