"""Image tensor → uint8 → PNG, with the standard library only (zlib and
struct), so the port needs no imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .exceptions import ValidationError


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
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, compress_level))
            + _chunk(b"IEND", b""))
