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
# PNG color type → (samples per pixel, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """Apply PNG scanline filter ``kind`` (0-4) to every row of the
    [h, stride] byte array (each row predicted from the raw bytes)."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter {kind} out of range 0-4")
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(image, compress_level: int = 0, filter_type: int = 0) -> bytes:
    """One [H,W,C] image (C = 1, 3 or 4) → PNG bytes, 8 bits per channel,
    every scanline under filter ``filter_type`` (0 none … 4 Paeth)."""
    arr = to_uint8(image)[0]
    h, w, c = arr.shape
    color = {1: 0, 3: 2, 4: 6}.get(c)
    if color is None:
        raise ValidationError(f"PNG needs 1, 3 or 4 channels, got {c}")
    rows = _filter_rows(arr.reshape(h, w * c), c, filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows],
                         axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, compress_level))
            + _chunk(b"IEND", b""))


def _read_chunks(data: bytes) -> tuple[tuple, bytes, bytes, bytes]:
    """(IHDR fields, concatenated IDAT payload, PLTE, tRNS), every chunk
    crc-checked."""
    if data[:8] != _SIGNATURE:
        raise ValidationError("not a PNG")
    pos, header, idat, plte, trns = 8, None, [], b"", b""
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
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValidationError("PNG without IHDR or IDAT")
    return header, b"".join(idat), plte, trns


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


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[h, 1 + stride] filtered scanlines → [h, stride] bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:        # Sub: running sum along the row, per byte lane
            cur = np.cumsum(line.reshape(stride // bpp, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:        # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = _unfilter_sequential(line, prior, bpp, paeth=kind == 4)
        else:
            raise ValidationError(f"PNG row {y}: unknown filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _samples(data: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """[h, stride] unfiltered bytes → [h, width, channels] samples (uint8,
    or uint16 at depth 16; sub-byte samples unpacked most significant
    first)."""
    h = data.shape[0]
    if depth == 16:
        vals = data.reshape(h, -1, 2).astype(np.uint16)
        vals = (vals[..., 0] << 8) | vals[..., 1]
    elif depth == 8:
        vals = data
    else:
        bits = np.unpackbits(data, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (bits * weights).sum(axis=-1, dtype=np.uint8)
    return vals[:, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → float32 [H,W,C] in [0,1], as Pillow's ``open`` then
    ``convert("RGB")`` gives it (the JAX package decodes through Pillow):
    every color type and bit depth of the standard, Adam7 interlace
    included. RGBA keeps its alpha (C = 4), and so does 16-bit gray with
    alpha, which Pillow opens as RGBA; everything else becomes RGB, with
    alpha, ``tRNS`` and the palette's transparency dropped. 16-bit
    samples keep their high byte, except 16-bit grayscale, which Pillow
    clips to 255."""
    (w, h, depth, color, comp, filt, interlace), idat, plte, trns = \
        _read_chunks(bytes(data))
    spec = _COLOR_TYPES.get(color)
    if spec is None or depth not in spec[1] or comp or filt or interlace > 1:
        raise ValidationError(
            f"PNG not supported (depth {depth}, color type {color}, "
            f"compression {comp}, filter method {filt}, interlace {interlace})")
    channels = spec[0]
    bits = channels * depth
    bpp = max(1, bits // 8)       # filter distance in bytes
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    geometry = []
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            geometry.append((x0, y0, dx, dy, pw, ph, -(-pw * bits // 8)))
    size = sum(ph * (stride + 1) for *_, ph, stride in geometry)
    if not w or not h or size > max_frame_raw_bytes():
        raise ValidationError(f"PNG size {w}x{h} out of range")
    try:
        raw = zlib.decompressobj().decompress(idat, size + 1)
    except zlib.error as e:
        raise ValidationError(f"PNG data corrupt: {e}") from None
    if len(raw) != size:
        raise ValidationError(f"PNG data holds {len(raw)} bytes, expected {size}")
    buf = np.frombuffer(raw, np.uint8)
    samples = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph, stride in geometry:
        rows = buf[pos:pos + ph * (stride + 1)].reshape(ph, stride + 1)
        pos += ph * (stride + 1)
        samples[y0::dy, x0::dx] = _samples(_unfilter(rows, bpp), pw,
                                           channels, depth)
    return from_uint8(_as_rgb(samples, color, depth, plte))


def _as_rgb(samples: np.ndarray, color: int, depth: int,
            plte: bytes) -> np.ndarray:
    """Samples → uint8 RGB (RGBA for color type 6 and for 16-bit gray
    with alpha), Pillow's reduction."""
    if color == 3:
        if not plte or len(plte) % 3:
            raise ValidationError("palette PNG without a valid PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        palette[:len(entries)] = entries
        return palette[samples[..., 0]]
    if depth == 16:
        samples = (np.minimum(samples, 255) if color == 0
                   else samples >> 8).astype(np.uint8)
    elif color == 0 and depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if color == 4 and depth == 16:
        return np.concatenate([np.repeat(samples[..., :1], 3, axis=-1),
                               samples[..., 1:]], axis=-1)
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples)


def encode_image_b64(image, compress_level: int = 0) -> str:
    return base64.b64encode(encode_png(image, compress_level)).decode("ascii")


def decode_image_b64(data: str) -> np.ndarray:
    try:
        raw = base64.b64decode(data)
    except (binascii.Error, ValueError) as e:
        raise ValidationError(f"invalid base64 image payload: {e}") from e
    return decode_png(raw)
