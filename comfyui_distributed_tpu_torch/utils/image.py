"""Image tensor ↔ uint8 ↔ PNG, with the standard library only (zlib and
struct), so the port needs no imaging package. The base64 forms carry
images in the collector's JSON envelopes."""

from __future__ import annotations

import base64
import binascii
import struct
import zlib

import numpy as np

from .constants import max_frame_raw_bytes
from .exceptions import ValidationError

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}      # PNG color type → channels (RGB, RGBA)


def to_uint8(images) -> np.ndarray:
    """[B,H,W,C] float [0,1] (or uint8; numpy or a tensor on any device)
    → contiguous uint8 numpy."""
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    arr = np.asarray(images)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4:
        raise ValidationError(f"expected [B,H,W,C] image batch, got shape {arr.shape}")
    if arr.dtype != np.uint8:
        arr = (np.clip(arr.astype(np.float32), 0.0, 1.0) * 255.0).round().astype(np.uint8)
    return np.ascontiguousarray(arr)


def from_uint8(arr: np.ndarray) -> np.ndarray:
    """uint8 [..., C] → float32 in [0,1]."""
    return arr.astype(np.float32) / 255.0


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image, compress_level: int = 0) -> bytes:
    """One [H,W,C] image (C = 1, 3 or 4) → PNG bytes, 8 bits per channel."""
    arr = to_uint8(image)[0]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}.get(c)
    if color is None:
        raise ValidationError(f"PNG needs 1, 3 or 4 channels, got {c}")
    # each scanline: filter byte 0 (none) + the row's bytes
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)],
                         axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, compress_level))
            + _chunk(b"IEND", b""))


def _read_chunks(data: bytes) -> tuple[tuple, bytes]:
    """(IHDR fields, concatenated IDAT payload), every chunk crc-checked."""
    if data[:8] != _SIGNATURE:
        raise ValidationError("not a PNG")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValidationError("PNG truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValidationError(f"PNG chunk {kind!r} truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValidationError(f"PNG chunk {kind!r} crc mismatch")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValidationError("bad PNG IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValidationError("PNG without IHDR or IDAT")
    return header, b"".join(idat)


def _unfilter_sequential(line: np.ndarray, prior: np.ndarray, bpp: int,
                         paeth: bool) -> np.ndarray:
    """Average (3) or Paeth (4): each byte depends on the one ``bpp``
    before it in the same row, so the row is undone byte by byte."""
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if paeth:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → float32 [H,W,C] in [0,1]: 8-bit RGB or RGBA, not
    interlaced, scanline filters 0-4."""
    (w, h, depth, color, comp, filt, interlace), idat = _read_chunks(bytes(data))
    c = _CHANNELS.get(color)
    if depth != 8 or c is None or comp or filt or interlace:
        raise ValidationError(
            f"PNG not supported (depth {depth}, color type {color}, "
            f"interlace {interlace}): only 8-bit RGB/RGBA, not interlaced")
    stride = w * c
    size = h * (stride + 1)
    if not w or not h or size > max_frame_raw_bytes():
        raise ValidationError(f"PNG size {w}x{h} out of range")
    try:
        raw = zlib.decompressobj().decompress(idat, size + 1)
    except zlib.error as e:
        raise ValidationError(f"PNG data corrupt: {e}") from None
    if len(raw) != size:
        raise ValidationError(f"PNG data holds {len(raw)} bytes, expected {size}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:        # Sub: running sum along the row, per channel
            cur = np.cumsum(line.reshape(w, c), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:        # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = _unfilter_sequential(line, prior, c, paeth=kind == 4)
        else:
            raise ValidationError(f"PNG row {y}: unknown filter {kind}")
        out[y] = cur
        prior = out[y]
    return from_uint8(out.reshape(h, w, c))


def encode_image_b64(image, compress_level: int = 0) -> str:
    return base64.b64encode(encode_png(image, compress_level)).decode("ascii")


def decode_image_b64(data: str) -> np.ndarray:
    try:
        raw = base64.b64decode(data)
    except (binascii.Error, ValueError) as e:
        raise ValidationError(f"invalid base64 image payload: {e}") from e
    return decode_png(raw)
