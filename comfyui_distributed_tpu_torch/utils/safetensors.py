"""Reader and writer of the ``.safetensors`` format, on torch and the
standard library alone (the ``safetensors`` package is not assumed).

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the data that follows the header; an optional
``"__metadata__"`` entry of strings), then the tensor bytes.

``SafetensorsFile`` maps the file (``mmap``) and hands each tensor over
on its own as a CPU tensor over the mapped bytes: nothing copies the
whole file. A caller copies each tensor where it belongs (a parameter's
``copy_``, which casts to that parameter's dtype and device) and drops
it. A tensor whose bytes are not aligned to its element size is copied
once into an aligned buffer. ``save_file`` computes every offset from
the shapes first, writes the header, then streams each tensor (cast
where it lies, then moved to the host, one at a time).

The dtypes are those of the published checkpoints: F64/F32/F16/BF16,
the two fp8 formats (``F8_E4M3`` → ``torch.float8_e4m3fn``, ``F8_E5M2``
→ ``torch.float8_e5m2``; FLUX and T5 files are often published in
e4m3), I64/I32/I16/I8, U8 and BOOL. A reader never computes in fp8: the
parameter's ``copy_`` casts.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Iterator, Mapping, Optional, Union

import torch

DTYPES = {"F16": torch.float16, "BF16": torch.bfloat16,
          "F32": torch.float32, "F64": torch.float64,
          "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
          "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}
MAX_HEADER = 100 * 1024 * 1024      # bytes of JSON a header may take
ALIGN = 8                           # the writer pads the header to this


class SafetensorsError(ValueError):
    """A file that is not a well-formed ``.safetensors``."""


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def parse_header(raw: bytes, data_size: int, where: str = "") -> dict:
    """Validate a header against the size of the data behind it; returns
    name → (dtype, shape, begin, end) (metadata left out)."""
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorsError(f"{where}: header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{where}: header is not a JSON object")
    entries = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype_name, shape = info["dtype"], list(info["shape"])
            begin, end = (int(x) for x in info["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise SafetensorsError(
                f"{where}: entry {name!r} lacks dtype, shape or "
                "data_offsets") from None
        if dtype_name not in DTYPES:
            raise SafetensorsError(
                f"{where}: entry {name!r} has dtype {dtype_name!r}; have "
                f"{sorted(DTYPES)}")
        if any(not isinstance(d, int) or d < 0 for d in shape):
            raise SafetensorsError(f"{where}: entry {name!r} has shape {shape}")
        dtype = DTYPES[dtype_name]
        if not 0 <= begin <= end <= data_size:
            raise SafetensorsError(
                f"{where}: entry {name!r} has offsets [{begin}, {end}] outside "
                f"the {data_size} data bytes")
        if end - begin != _numel(shape) * _itemsize(dtype):
            raise SafetensorsError(
                f"{where}: entry {name!r} spans {end - begin} bytes, its "
                f"shape {shape} in {dtype_name} needs "
                f"{_numel(shape) * _itemsize(dtype)}")
        entries[name] = (dtype, tuple(shape), begin, end)
    return entries


class SafetensorsFile(Mapping[str, torch.Tensor]):
    """A mapped ``.safetensors`` file as a read-only mapping of names to
    CPU tensors over its bytes. Use it as a context manager, or call
    ``close``; tensors handed out keep the mapping alive."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        where = str(self.path)
        with open(self.path, "rb") as f:
            size = self.path.stat().st_size
            if size < 8:
                raise SafetensorsError(f"{where}: {size} bytes, no header")
            (n,) = struct.unpack("<Q", f.read(8))
            if n > min(MAX_HEADER, size - 8):
                raise SafetensorsError(
                    f"{where}: header length {n} does not fit the file "
                    f"({size} bytes)")
            raw = f.read(n)
            self._start = 8 + n
            self._entries = parse_header(raw, size - self._start, where)
            # a private (copy-on-write) mapping: writable for
            # torch.frombuffer, never written back
            self._mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                        if size > self._start else None)

    def __getitem__(self, name: str) -> torch.Tensor:
        dtype, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        offset = self._start + begin
        raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - begin,
                               offset=offset)
        if offset % _itemsize(dtype):
            raw = raw.clone()
        return raw.view(dtype).view(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name) -> bool:
        return name in self._entries

    def close(self) -> None:
        """Unmap, unless a tensor handed out still views the mapping (it
        is then unmapped when the last one goes)."""
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass
            self._mm = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: Union[str, Path]) -> dict[str, torch.Tensor]:
    """Every tensor of a (small) file as its own CPU tensor."""
    with SafetensorsFile(path) as f:
        return {k: f[k].clone() for k in f}


def save_file(tensors: Mapping[str, torch.Tensor], path: Union[str, Path],
              dtype: Optional[torch.dtype] = None) -> int:
    """Write ``tensors`` (on any device) to ``path``, each floating-point
    one cast to ``dtype`` where one is given; returns the bytes written.
    Offsets are computed from the shapes before anything is written, then
    each tensor is moved to the host and written on its own."""
    def dtype_of(t: torch.Tensor) -> torch.dtype:
        return dtype if dtype is not None and t.is_floating_point() else t.dtype

    header: dict = {}
    offset = 0
    for name, t in tensors.items():
        dt = dtype_of(t)
        if dt not in NAMES:
            raise SafetensorsError(f"cannot write {name!r} as {dt}")
        nbytes = t.numel() * _itemsize(dt)
        header[name] = {"dtype": NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-(8 + len(raw)) % ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, t in tensors.items():
            # cast where the tensor lies (on the card: fewer bytes to move)
            host = t.detach().to(dtype_of(t)).to("cpu").contiguous()
            f.write(memoryview(host.view(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset
