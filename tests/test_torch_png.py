"""The port's stdlib PNG decoder against the JAX package's, which decodes
through Pillow: bitwise equal float32 images for every color type, bit
depth, palette and ``tRNS`` form and for Adam7 interlace.

Two sources of PNGs: Pillow's own writer (modes 1, L, LA, P with and
without transparency, I;16, RGB and RGBA, under its default adaptive
filter choice and under ``optimize``, which adds the Average filter),
and a raw writer below for what Pillow does not write (2- and 4-bit
samples, 16-bit color, gray and RGB ``tRNS``, interlace), each scanline
under another filter so all five are undone."""

import io
import struct
import zlib

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from comfyui_distributed_tpu.utils.image import decode_png as jax_decode  # noqa: E402
from comfyui_distributed_tpu_torch.utils.image import (  # noqa: E402
    decode_png, encode_png)
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError  # noqa: E402

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Filter scanline y with filter (first + y) % 5."""
    x = rows.astype(np.int32)
    out = []
    for y in range(x.shape[0]):
        kind = (first + y) % 5
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (a + up) >> 1
        else:
            p = a + up - c
            pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, c))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] samples → [h, stride] bytes."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (flat << shifts).sum(-1).astype(np.uint8)


def raw_png(samples, depth, color, interlace=0, plte=b"", trns=b"",
            first_filter=0) -> bytes:
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for i, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        data += _filter(_pack(sub, depth), bpp, first_filter + i)
    head = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    body = _chunk(b"IHDR", head)
    if plte:
        body += _chunk(b"PLTE", plte)
    if trns:
        body += _chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(data))
            + _chunk(b"IEND", b""))


def _assert_same(data: bytes):
    ref = jax_decode(data)
    out = decode_png(data)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    return out


def _pillow_png(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pillow_images():
    rng = np.random.default_rng(0)
    h, w = 19, 23
    # smooth rows compress into every filter kind, noise keeps it honest
    base = (np.cumsum(rng.integers(0, 9, (h, w, 4)), axis=1)
            + rng.integers(0, 3, (h, w, 4))).astype(np.uint8)
    gray16 = (np.cumsum(rng.integers(0, 4000, (h, w)), axis=1) % 65536
              ).astype(np.uint16)
    pal = Image.fromarray(base[..., 0] % 7).convert("L").convert("P")
    pal.putpalette(list(rng.integers(0, 256, 768)))
    return {
        "1": (Image.fromarray(base[..., 0] > 30).convert("1"), {}),
        "L": (Image.fromarray(base[..., 0]), {}),
        "LA": (Image.fromarray(base[..., :2]), {}),
        "P": (pal, {}),
        "P_trns": (pal, {"transparency": 3}),
        "P_trns_bytes": (pal, {"transparency": bytes(range(0, 256, 37))}),
        "I;16": (Image.fromarray(gray16), {}),
        "RGB": (Image.fromarray(base[..., :3]), {}),
        "RGBA": (Image.fromarray(base), {}),
    }


@pytest.mark.parametrize("strategy", [{}, {"optimize": True}],
                         ids=["adaptive", "optimize"])
@pytest.mark.parametrize("mode", list(_pillow_images()))
def test_pillow_written_png_decodes_like_jax(mode, strategy):
    img, extra = _pillow_images()[mode]
    out = _assert_same(_pillow_png(img, **extra, **strategy))
    assert out.shape[-1] == (4 if mode == "RGBA" else 3)


def _samples(rng, h, w, ch, depth):
    return rng.integers(0, 1 << depth, (h, w, ch)).astype(
        np.uint16 if depth == 16 else np.uint8)


CASES = ([(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)]
         + [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16)]
         + [(6, 8), (6, 16)])


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", CASES)
def test_raw_png_decodes_like_jax(color, depth, interlace):
    rng = np.random.default_rng(color * 100 + depth)
    h, w = 13, 11     # odd sizes: Adam7 passes of unequal width
    samples = _samples(rng, h, w, CHANNELS[color], depth)
    plte = (rng.integers(0, 256, 3 * (1 << depth)).astype(np.uint8).tobytes()
            if color == 3 else b"")
    _assert_same(raw_png(samples, depth, color, interlace, plte,
                         first_filter=color + depth))


@pytest.mark.parametrize("color,depth,trns", [
    (0, 8, struct.pack(">H", 7)),
    (0, 16, struct.pack(">H", 700)),
    (2, 8, struct.pack(">HHH", 1, 2, 3)),
    (2, 16, struct.pack(">HHH", 100, 200, 300)),
    (3, 4, bytes([0, 128, 255, 7])),
    (3, 8, bytes(range(0, 250, 3))),
])
def test_trns_png_decodes_like_jax(color, depth, trns):
    rng = np.random.default_rng(depth)
    samples = _samples(rng, 9, 10, CHANNELS[color], depth)
    samples[0, 0] = 7 if color == 0 and depth == 8 else samples[0, 0]
    plte = (rng.integers(0, 256, 3 * (1 << depth)).astype(np.uint8).tobytes()
            if color == 3 else b"")
    for interlace in (0, 1):
        _assert_same(raw_png(samples, depth, color, interlace, plte, trns))


def test_short_palette_and_filters_of_the_port_writer():
    """A palette shorter than the indices it is given; and the port's own
    writer under each filter decodes to what it was given."""
    rng = np.random.default_rng(5)
    samples = rng.integers(0, 4, (6, 7, 1)).astype(np.uint8)
    _assert_same(raw_png(samples, 8, 3, plte=bytes(range(6))))
    img = rng.random((17, 9, 3)).astype(np.float32)
    for f in range(5):
        data = encode_png(img, filter_type=f)
        np.testing.assert_array_equal(decode_png(data), jax_decode(data))


def test_bad_pngs_raise():
    ok = raw_png(np.zeros((2, 2, 3), np.uint8), 8, 2)
    with pytest.raises(ValidationError):
        decode_png(ok[:20])
    # RGB at 4 bits a sample is not a PNG combination
    bad = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 4, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(b"\0\0\0\0" * 2))
           + _chunk(b"IEND", b""))
    with pytest.raises(ValidationError, match="not supported"):
        decode_png(bad)
    with pytest.raises(ValidationError, match="PLTE"):
        decode_png(raw_png(np.zeros((2, 2, 1), np.uint8), 8, 3))
