"""CDTF frames: the cross-host wire format of one tensor, byte for byte
the JAX package's (``native.py``'s pure-Python codec).

Layout, little-endian: ``b"CDTF"``, version 1, dtype code, ndim, flags
(bit 0: zlib payload); ndim × u64 dims; u32 crc32 of the raw bytes; u64
stored payload length; u64 raw length; the payload. The bfloat16 code
(8) of the JAX package needs ``ml_dtypes`` and is not accepted here.
"""

from __future__ import annotations

import zlib

import numpy as np

from .constants import max_frame_raw_bytes

_DTYPES: dict[int, np.dtype] = {
    0: np.dtype(np.uint8),
    1: np.dtype(np.float32),
    2: np.dtype(np.float16),
    3: np.dtype(np.int32),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int64),
    6: np.dtype(np.float64),
    7: np.dtype(np.bool_),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

_MAGIC = b"CDTF"
_VERSION = 1


def pack_frame(arr: np.ndarray, level: int = 1) -> bytes:
    """Array → framed bytes. ``level`` 0 = raw, 1-9 = zlib (kept only when
    it actually shrinks the payload)."""
    a = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(np.dtype(a.dtype))
    if code is None:
        raise ValueError(
            f"unsupported frame dtype {a.dtype}; supported: "
            f"{sorted(str(d) for d in _DTYPE_CODES)}")
    raw = a.tobytes()
    payload = raw
    flags = 0
    if level > 0:
        z = zlib.compress(raw, level)
        if len(z) < len(raw):
            payload, flags = z, 1
    head = _MAGIC + bytes([_VERSION, code, a.ndim, flags])
    head += b"".join(int(d).to_bytes(8, "little") for d in a.shape)
    head += zlib.crc32(raw).to_bytes(4, "little")
    head += len(payload).to_bytes(8, "little")
    head += len(raw).to_bytes(8, "little")
    return head + payload


def unpack_frame(data: bytes) -> np.ndarray:
    """Framed bytes → array (crc-verified). Every size in the header is
    bounded before anything is allocated: frames arrive on routes any peer
    can reach."""
    data = bytes(data)
    if len(data) < 8 or data[:4] != _MAGIC or data[4] != _VERSION:
        raise ValueError("not a CDTF frame")
    code, ndim, flags = data[5], data[6], data[7]
    if ndim > 8 or code not in _DTYPES:
        raise ValueError(f"bad frame header (dtype={code} ndim={ndim})")
    off = 8
    if len(data) < off + 8 * ndim + 20:
        raise ValueError("frame header truncated")
    shape = tuple(int.from_bytes(data[off + 8 * i: off + 8 * i + 8], "little")
                  for i in range(ndim))
    off += 8 * ndim
    crc = int.from_bytes(data[off:off + 4], "little")
    off += 4
    stored = int.from_bytes(data[off:off + 8], "little")
    off += 8
    raw_len = int.from_bytes(data[off:off + 8], "little")
    off += 8

    expected = _DTYPES[code].itemsize
    for d in shape:
        expected *= d
    if raw_len != expected:
        raise ValueError(
            f"frame raw size {raw_len} != shape/dtype size {expected}")
    cap = max_frame_raw_bytes()
    if raw_len > cap:
        raise ValueError(f"frame raw size {raw_len} exceeds cap {cap}")
    if stored > len(data) - off:
        raise ValueError("frame payload truncated")
    payload = data[off:off + stored]
    if flags & 1:
        # bounded inflate: never more than raw_len + 1 bytes, whatever the
        # stream claims
        try:
            raw = zlib.decompressobj().decompress(payload, raw_len + 1)
        except zlib.error as e:
            raise ValueError(f"frame decompress failed: {e}") from None
    else:
        raw = payload
    if len(raw) != raw_len or zlib.crc32(raw) != crc:
        raise ValueError("frame crc mismatch")
    return np.frombuffer(raw, dtype=_DTYPES[code]).reshape(shape)
