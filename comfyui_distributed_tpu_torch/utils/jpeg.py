"""Baseline JPEG in numpy: the codec of the MJPG frames in the port's AVI
files (``utils/video_io.py``), where the JAX package calls OpenCV's
``cv2.imencode``/``cv2.imdecode``. The card's machine has no OpenCV and
no imaging package, so the port carries its own, as it carries its own
PNG codec (``utils/image.py``).

Both directions reproduce libjpeg's integer arithmetic, so that the bytes
and pixels equal OpenCV's (libjpeg-turbo's) exactly:

- ``encode_jpeg``: 8-bit baseline sequential, a JFIF APP0, YCbCr at
  4:2:0 (luma 2×2, chroma 1×1), the Annex K quantisation tables scaled by
  libjpeg's quality rule (``jcparam.c``), the Annex K Huffman tables, no
  restart markers. It follows the fixed-point RGB→YCbCr of
  ``jccolor.c``, the h2v2 downsampling with its alternating bias
  (``jcsample.c``), edge replication and the dummy blocks of
  ``jcprepct.c``/``jccoefct.c``, and the integer forward DCT of
  ``jfdctint.c``. Every stage is vectorised over all blocks, the
  bitstream too (code lengths and codes for each symbol, then bit
  packing and byte stuffing).
- ``decode_jpeg``: SOF0/SOF1 at 8 bits with 1 or 3 components, any
  integer sampling factors, interleaved or not, DRI/RSTn restart
  intervals, and frames without a DHT (the Annex K tables stand in, as
  libjpeg and ffmpeg do for Motion-JPEG). The entropy stage is a
  table-driven loop over 16-bit lookaheads; dequantisation, the integer
  IDCT of ``jidctint.c``, the fancy upsampling of ``jdsample.c`` (h2v1,
  h1v2, h2v2) and the YCbCr→RGB tables of ``jdcolor.c`` are vectorised.
  A progressive, lossless, hierarchical or arithmetic-coded frame raises
  ``ValidationError`` naming its SOF type.

This is host work, as OpenCV's codec is host work in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np

from .exceptions import ValidationError

# zigzag index → natural (row-major) index within an 8×8 block
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))), np.int64)

# Annex K.1 quantisation tables, natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
_STD_DC = (
    (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
)
_STD_AC = (
    (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
)

# libjpeg's fixed-point constants (CONST_BITS 13 for the DCTs, SCALEBITS
# 16 for the colour tables)
_CONST_BITS, _PASS1_BITS, _SCALEBITS = 13, 2, 16
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172

_SOF_NAMES = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The luma and chroma tables (natural order) at ``quality``:
    libjpeg's ``jpeg_quality_scaling`` and ``jpeg_add_quant_table`` with
    ``force_baseline``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_LUMA_Q, _CHROMA_Q))


# --- the DCTs (jfdctint.c / jidctint.c, one pass along the last axis) ----------


def _fdct_pass(d: np.ndarray, final: bool) -> np.ndarray:
    """One 1-D pass of ``jpeg_fdct_islow`` over the last axis of ``d``
    (int64 [..., 8]): pass 1 (rows) keeps PASS1_BITS of extra precision,
    pass 2 (``final``, columns) removes it."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    shift = _CONST_BITS + _PASS1_BITS if final else _CONST_BITS - _PASS1_BITS
    if final:
        out[..., 0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    else:
        out[..., 0] = (tmp10 + tmp11) << _PASS1_BITS
        out[..., 4] = (tmp10 - tmp11) << _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0541
    out[..., 2] = _descale(z1 + tmp13 * _F0765, shift)
    out[..., 6] = _descale(z1 - tmp12 * _F1847, shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[..., 7] = _descale(tmp4 * _F0298 + z1 + z3, shift)
    out[..., 5] = _descale(tmp5 * _F2053 + z2 + z4, shift)
    out[..., 3] = _descale(tmp6 * _F3072 + z2 + z3, shift)
    out[..., 1] = _descale(tmp7 * _F1501 + z1 + z4, shift)
    return out


def forward_dct(blocks: np.ndarray) -> np.ndarray:
    """``jpeg_fdct_islow`` on [N, 8, 8] samples already centred on 0;
    the output is 8× the orthonormal DCT, as libjpeg's."""
    rows = _fdct_pass(blocks.astype(np.int64), final=False)
    return np.swapaxes(_fdct_pass(np.swapaxes(rows, 1, 2), final=True), 1, 2)


def _idct_pass(d: np.ndarray, final: bool) -> np.ndarray:
    """One 1-D pass of ``jpeg_idct_islow`` over the last axis: pass 1
    (columns of the dequantised coefficients), pass 2 (``final``, rows)
    descaled by PASS1_BITS + 3 more."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    tmp0 = tmp0 * _F0298 + z1 + z3
    tmp1 = tmp1 * _F2053 + z2 + z4
    tmp2 = tmp2 * _F3072 + z2 + z3
    tmp3 = tmp3 * _F1501 + z1 + z4
    shift = (_CONST_BITS + _PASS1_BITS + 3 if final
             else _CONST_BITS - _PASS1_BITS)
    out = np.empty_like(d)
    for i, v in enumerate((tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1,
                           tmp13 + tmp0, tmp13 - tmp0, tmp12 - tmp1,
                           tmp11 - tmp2, tmp10 - tmp3)):
        out[..., i] = _descale(v, shift)
    return out


def inverse_dct(coefs: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` on dequantised [N, 8, 8] coefficients → uint8
    samples, through libjpeg's post-IDCT range limit (which wraps at ±512
    before it clamps)."""
    cols = _idct_pass(np.swapaxes(coefs.astype(np.int64), 1, 2), final=False)
    out = _idct_pass(np.swapaxes(cols, 1, 2), final=True)
    wrapped = ((out + 512) & 1023) - 512
    return np.clip(wrapped + 128, 0, 255).astype(np.uint8)


# --- Huffman tables -----------------------------------------------------------


def _code_table(bits: bytes, vals: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes (Annex C): per symbol, its code and code length."""
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]], lengths[vals[k]] = code, length
            code += 1
            k += 1
        if code > (1 << length):
            raise ValidationError("JPEG Huffman table is malformed")
        code <<= 1
    return codes, lengths


def _extend(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The signed value of ``size`` magnitude bits (F.2.2.1 EXTEND)."""
    return np.where(v < (1 << np.maximum(size - 1, 0)),
                    v - (1 << size) + 1, v)


@functools.lru_cache(maxsize=64)
def _lookup(bits: bytes, vals: bytes) -> tuple[list, list]:
    """Decoding tables over a 16-bit lookahead: ``slow[peek]`` is
    ``length << 8 | symbol`` (0: no such code); ``fast[peek]`` is
    ``(bits used, zero run, value)`` where the code and its value bits fit
    the lookahead and the symbol carries a value, else None."""
    if sum(bits) > len(vals) or sum(bits) > 256:
        raise ValidationError("JPEG Huffman table is malformed")
    codes, lengths = _code_table(bits, vals)
    peek = np.arange(1 << 16, dtype=np.int64)
    slow = np.zeros(1 << 16, np.int64)
    fast_len = np.zeros(1 << 16, np.int64)
    fast_run = np.zeros(1 << 16, np.int64)
    fast_val = np.zeros(1 << 16, np.int64)
    for sym in set(vals[:sum(bits)]):
        n = int(lengths[sym])
        lo = int(codes[sym]) << (16 - n)
        hi = lo + (1 << (16 - n))
        slow[lo:hi] = n << 8 | sym
        run, size = sym >> 4, sym & 15
        if size and n + size <= 16:
            v = (peek[lo:hi] >> (16 - n - size)) & ((1 << size) - 1)
            fast_len[lo:hi] = n + size
            fast_run[lo:hi] = run
            fast_val[lo:hi] = _extend(v, np.full_like(v, size))
    fast = [None] * (1 << 16)
    for i in np.flatnonzero(fast_len).tolist():
        fast[i] = (int(fast_len[i]), int(fast_run[i]), int(fast_val[i]))
    return slow.tolist(), fast


# --- encoder -----------------------------------------------------------------


def _rgb_to_ycc(rgb: np.ndarray) -> tuple[np.ndarray, ...]:
    """``jccolor.c`` ``rgb_ycc_convert``: fixed-point tables, ONE_HALF
    rounding for Y and ONE_HALF - 1 for the chroma offsets."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << (_SCALEBITS - 1)
    offset = 128 << _SCALEBITS
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + offset + half - 1) >> _SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + offset + half - 1) >> _SCALEBITS
    return y, cb, cr


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[R·8, C·8] → [R, C, 8, 8]."""
    R, C = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(R, 8, C, 8).swapaxes(1, 2)


def _quantize(coefs: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """``jcdctmgr.c``: divide by quantval·8, rounding half away from 0."""
    d = (qtab * 8).reshape(8, 8)
    mag = (np.abs(coefs) + (d >> 1)) // d
    return np.where(coefs < 0, -mag, mag)


def _nbits(v: np.ndarray) -> np.ndarray:
    """Magnitude category: the bit length of |v|."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while np.any(a):
        n += a > 0
        a >>= 1
    return n


def _pack_bits(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate ``lens[i]`` low bits of ``vals[i]`` (≤ 32 each), pad
    the last byte with ones, and stuff a zero after every 0xFF."""
    col = np.arange(32)
    parts = []
    step = 1 << 18
    for s in range(0, len(vals), step):
        v, n = vals[s:s + step], lens[s:s + step]
        left = (v << (32 - n)).astype(">u4")
        bits = np.unpackbits(left.view(np.uint8).reshape(-1, 4), axis=1)
        parts.append(bits[col[None, :] < n[:, None]])
    bitstream = np.concatenate(parts + [np.ones(-int(lens.sum()) % 8, np.uint8)])
    data = np.packbits(bitstream)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _entropy_code(zz: np.ndarray, tables: np.ndarray) -> bytes:
    """Huffman-code blocks [N, 64] (zigzag order, DC already as
    differences) with the Annex K tables ``tables[i]`` (0 luma, 1
    chroma), as ``jchuff.c`` ``encode_one_block`` does, all blocks at
    once."""
    nb = zz.shape[0]
    dc_codes = [_code_table(*t) for t in _STD_DC]
    ac_codes = [_code_table(*t) for t in _STD_AC]
    dc_code = np.stack([c for c, _ in dc_codes])
    dc_len = np.stack([n for _, n in dc_codes])
    ac_code = np.stack([c for c, _ in ac_codes])
    ac_len = np.stack([n for _, n in ac_codes])

    dc = zz[:, 0]
    dsize = _nbits(dc)
    dbits = np.where(dc < 0, dc - 1, dc) & ((1 << dsize) - 1)
    # the AC coefficients that are not zero, block by block
    b, k = np.nonzero(zz[:, 1:])
    v = zz[b, k + 1]
    k = k + 1
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    last = np.ones(len(b), bool)
    last[:-1] = b[1:] != b[:-1]
    prev = np.zeros_like(k)
    prev[1:] = k[:-1]
    prev[first] = 0
    run = k - prev - 1
    nzrl = run >> 4                       # ZRL symbols before this one
    size = _nbits(v)
    sym = ((run & 15) << 4) | size
    end_k = np.zeros(nb, np.int64)
    end_k[b[last]] = k[last]
    eob = end_k < 63
    # items per block: DC, (ZRLs + 1) per coefficient, EOB
    per_block = 1 + eob + np.bincount(b, weights=nzrl + 1,
                                      minlength=nb).astype(np.int64)
    start = np.concatenate([[0], np.cumsum(per_block)[:-1]])
    total = int(per_block.sum())
    vals = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)

    t = tables
    vals[start] = (dc_code[t, dsize] << dsize) | dbits
    lens[start] = dc_len[t, dsize] + dsize
    span = nzrl + 1
    before = np.cumsum(span) - span       # items of earlier coefficients
    first_of = np.maximum.accumulate(np.where(first, np.arange(len(b)), 0))
    at = start[b] + 1 + before - before[first_of]
    tb = t[b]
    vbits = np.where(v < 0, v - 1, v) & ((1 << size) - 1)
    vals[at + nzrl] = (ac_code[tb, sym] << size) | vbits
    lens[at + nzrl] = ac_len[tb, sym] + size
    if nzrl.any():
        ramp = np.arange(int(nzrl.sum())) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        zpos = np.repeat(at, nzrl) + ramp
        zt = np.repeat(tb, nzrl)
        vals[zpos] = ac_code[zt, 0xF0]
        lens[zpos] = ac_len[zt, 0xF0]
    epos = (start + per_block - 1)[eob]
    vals[epos] = ac_code[t[eob], 0x00]
    lens[epos] = ac_len[t[eob], 0x00]
    return _pack_bits(vals, lens)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """[H, W, 3] uint8 RGB → baseline JFIF bytes at 4:2:0, byte for byte
    what ``cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, quality])``
    writes."""
    img = np.asarray(rgb)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValidationError(
            f"JPEG encode takes [H,W,3] uint8, got {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    if not (0 < H <= 65535 and 0 < W <= 65535):
        raise ValidationError(f"JPEG size {W}x{H} is out of range")
    qy, qc = quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(img)
    mr, mc = -(-H // 16), -(-W // 16)    # MCUs of 16×16 pixels
    # luma: the edge replicated to whole MCUs
    lum = np.pad(y, ((0, mr * 16 - H), (0, mc * 16 - W)), mode="edge")
    # chroma: replicate to even rows and whole MCU columns, average 2×2
    # with the bias 1, 2, 1, 2 along a row, then replicate the last
    # downsampled row to whole MCUs
    chroma = []
    for c in (cb, cr):
        c = np.pad(c, ((0, H & 1), (0, mc * 16 - W)), mode="edge")
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        s = (s + 1 + (np.arange(s.shape[1]) & 1)) >> 2
        chroma.append(np.pad(s, ((0, mr * 8 - s.shape[0]), (0, 0)), mode="edge"))

    yq = _quantize(forward_dct(_blocks(lum - 128).reshape(-1, 8, 8)), qy)
    yq = yq.reshape(mr * 2, mc * 2, 64)
    # jccoefct.c's dummy blocks: past the luma's blocks a block is zero
    # with the DC of the block before it in the MCU
    wb, hb = -(-W // 8), -(-H // 8)
    if wb < mc * 2:
        yq[:hb, wb] = 0
        yq[:hb, wb, 0] = yq[:hb, wb - 1, 0]
    if hb < mr * 2:
        yq[hb] = 0
        yq[hb, :, 0] = np.repeat(yq[hb - 1, 1::2, 0], 2)
    cq = [_quantize(forward_dct(_blocks(c - 128).reshape(-1, 8, 8)), qc)
          .reshape(mr * mc, 1, 64) for c in chroma]
    # MCU order: 4 luma blocks (row-major), Cb, Cr
    ymcu = yq.reshape(mr, 2, mc, 2, 64).swapaxes(1, 2).reshape(mr * mc, 4, 64)
    for comp in (ymcu, *cq):
        dc = comp[:, :, 0].reshape(-1)
        comp[:, :, 0] = np.diff(dc, prepend=0).reshape(comp.shape[:2])
    blocks = np.concatenate([ymcu, *cq], axis=1).reshape(-1, 64)[:, ZIGZAG]
    tables = np.tile(np.array([0, 0, 0, 0, 1, 1]), mr * mc)
    scan = _entropy_code(blocks, tables)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate((qy, qc)):
        out.append(_segment(0xDB, bytes([i]) + q[ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big")
                        + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for i in range(2):
        for cls, (bits, vals) in ((0, _STD_DC[i]), (1, _STD_AC[i])):
            out.append(_segment(0xC4, bytes([cls << 4 | i]) + bits + vals))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


# --- decoder -----------------------------------------------------------------


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "tq_dc", "ta", "coefs", "bw", "bh",
                 "dw", "dh")

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq


def _peeks(seg: bytes) -> memoryview:
    """The 16 bits at every bit offset of one restart interval's
    unstuffed bytes (zero padded past the end), as a uint16 view: the
    decoder's one lookup a symbol."""
    u = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.uint32)
    win = (u[:-2] << 16) | (u[1:-1] << 8) | u[2:]          # 24 bits a byte
    out = np.empty((win.size, 8), np.uint16)
    for shift in range(8):
        out[:, shift] = (win >> (8 - shift)) & 0xFFFF
    return memoryview(out.reshape(-1)).cast("B").cast("H")


def _entropy_segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The scan's entropy-coded bytes from ``pos``: split at RSTn markers,
    0xFF00 unstuffed; returns them and the offset of the next marker."""
    arr = np.frombuffer(data, np.uint8)[pos:]
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    end_at = ff[(nxt != 0) & (nxt != 0xFF) & ~rst]
    end = int(end_at[0]) if len(end_at) else len(arr)
    cuts = ff[rst & (ff < end)]
    segs, lo = [], 0
    for hi in [*cuts.tolist(), end]:
        seg = arr[lo:hi]
        stuffed = np.flatnonzero((seg[:-1] == 0xFF) & (seg[1:] == 0)) + 1
        segs.append(np.delete(seg, stuffed).tobytes())
        lo = hi + 2
    return segs, pos + end


def _decode_scan(comps: list, segs: list[bytes], restart: int,
                 dc_tabs: dict, ac_tabs: dict, mcus: tuple[int, int]) -> None:
    """Huffman-decode one sequential scan into each component's
    ``coefs`` (flat lists, natural order within a block)."""
    zz = ZIGZAG.tolist()
    mask = [(1 << s) - 1 for s in range(17)]
    plan = []                 # per component: (coefs, tables, blocks of an MCU)
    for c in comps:
        if c.tq_dc not in dc_tabs or c.ta not in ac_tabs:
            raise ValidationError("JPEG scan names an undefined Huffman table")
        if len(comps) == 1:
            offs = [0]
        else:
            offs = [(r * c.bw + x) * 64 for r in range(c.v) for x in range(c.h)]
        plan.append((c, _lookup(*dc_tabs[c.tq_dc])[0], _lookup(*ac_tabs[c.ta]),
                     offs))
    if len(comps) == 1:
        c = comps[0]
        rows, cols = -(-c.dh // 8), -(-c.dw // 8)
        order = [((r * c.bw + x) * 64,) for r in range(rows) for x in range(cols)]
    else:
        rows, cols = mcus
        order = None
    n_units = rows * cols
    seg_i, peek, p = 0, _peeks(segs[0]), 0
    preds = [0] * len(comps)
    try:
        for unit in range(n_units):
            if restart and unit and unit % restart == 0:
                seg_i += 1
                if seg_i >= len(segs):
                    raise ValidationError("JPEG restart marker missing")
                peek, p, preds = _peeks(segs[seg_i]), 0, [0] * len(comps)
            if order is not None:
                bases = order[unit]
            else:
                mr, mcol = divmod(unit, cols)
            for ci, (c, dc_slow, (ac_slow, ac_fast), offs) in enumerate(plan):
                coefs = c.coefs
                if order is not None:
                    starts = bases
                else:
                    b0 = (mr * c.v * c.bw + mcol * c.h) * 64
                    starts = [b0 + o for o in offs]
                for base in starts:
                    e = dc_slow[peek[p]]
                    if not e:
                        raise ValidationError("corrupt JPEG data (bad DC code)")
                    p += e >> 8
                    s = e & 255
                    if s:
                        bits = peek[p] >> (16 - s)
                        p += s
                        preds[ci] += bits if bits >> (s - 1) else bits - mask[s]
                    coefs[base] = preds[ci]
                    k = 1
                    while k < 64:
                        pk = peek[p]
                        f = ac_fast[pk]
                        if f is not None:
                            p += f[0]
                            k += f[1]
                            coefs[base + zz[k]] = f[2]
                            k += 1
                            continue
                        e = ac_slow[pk]
                        if not e:
                            raise ValidationError("corrupt JPEG data (bad AC code)")
                        p += e >> 8
                        s = e & 15
                        if not s:
                            if e & 255 != 0xF0:
                                break             # EOB
                            k += 16
                            continue
                        k += (e >> 4) & 15
                        bits = peek[p] >> (16 - s)
                        p += s
                        coefs[base + zz[k]] = bits if bits >> (s - 1) else bits - mask[s]
                        k += 1
    except IndexError:
        raise ValidationError("corrupt or truncated JPEG scan") from None


def _upsample(plane: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """``jdsample.c``: fancy (triangle) upsampling for h2v1, h1v2 and
    h2v2 with the edges replicated, as libjpeg does for a component wider
    than 2 samples; plain replication otherwise."""
    p = plane.astype(np.int64)
    if hx == 1 and vx == 1:
        return plane
    fancy_h = hx == 2 and p.shape[1] > 2
    if (hx, vx) == (2, 1) and fancy_h:
        e = np.pad(p, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((p.shape[0], p.shape[1] * 2), np.int64)
        out[:, 0::2] = (3 * p + e[:, :-2] + 1) >> 2
        out[:, 1::2] = (3 * p + e[:, 2:] + 2) >> 2
        return out.astype(np.uint8)
    if (hx, vx) == (1, 2):
        e = np.pad(p, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((p.shape[0] * 2, p.shape[1]), np.int64)
        out[0::2] = (3 * p + e[:-2] + 1) >> 2
        out[1::2] = (3 * p + e[2:] + 2) >> 2
        return out.astype(np.uint8)
    if (hx, vx) == (2, 2) and fancy_h:
        e = np.pad(p, ((1, 1), (0, 0)), mode="edge")
        out = np.empty((p.shape[0] * 2, p.shape[1] * 2), np.int64)
        for r, near in ((0, e[:-2]), (1, e[2:])):
            cs = 3 * p + near
            ce = np.pad(cs, ((0, 0), (1, 1)), mode="edge")
            out[r::2, 0::2] = (3 * cs + ce[:, :-2] + 8) >> 4
            out[r::2, 1::2] = (3 * cs + ce[:, 2:] + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vx, axis=0), hx, axis=1)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c`` ``ycc_rgb_convert`` with its tables."""
    half = 1 << (_SCALEBITS - 1)
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + half) >> _SCALEBITS
    cb_b = (_fix(1.77200) * x + half) >> _SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + half
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> _SCALEBITS)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → [H, W, 3] uint8 RGB (a grayscale file replicated to
    three channels), equal to ``cv2.imdecode(..., IMREAD_COLOR)`` with
    its channels reversed."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValidationError("not a JPEG (no SOI marker)")
    qts: dict[int, np.ndarray] = {}
    dc_tabs: dict[int, tuple] = {}
    ac_tabs: dict[int, tuple] = {}
    comps: list[_Component] = []
    restart, jfif, adobe = 0, False, None
    pos, scans = 2, 0
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1                              # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            if scans:
                break                             # EOI missing: libjpeg warns
            raise ValidationError("corrupt JPEG marker stream")
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            pos += 2
            continue
        if pos + 4 > len(data):
            raise ValidationError("truncated JPEG segment")
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + length]
        if length < 2 or len(seg) != length - 2:
            raise ValidationError("truncated JPEG segment")
        pos += 2 + length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                if raw.size != 64:
                    raise ValidationError("truncated JPEG quantisation table")
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = raw
                qts[tq] = q
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = seg[i + 1:i + 17]
                n = sum(bits)
                vals = seg[i + 17:i + 17 + n]
                if len(bits) != 16 or len(vals) != n:
                    raise ValidationError("truncated JPEG Huffman table")
                (ac_tabs if tc else dc_tabs)[th] = (bytes(bits), bytes(vals))
                i += 17 + n
        elif marker == 0xDD:
            restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker in _SOF_NAMES:
            raise ValidationError(
                f"{_SOF_NAMES[marker]} JPEG (SOF{marker - 0xC0}) is not "
                "supported: the port decodes baseline and extended "
                "sequential Huffman JPEG only")
        elif marker in (0xC0, 0xC1):
            if seg[0] != 8:
                raise ValidationError(
                    f"{seg[0]}-bit JPEG (SOF{marker - 0xC0}) is not "
                    "supported: 8-bit samples only")
            H = int.from_bytes(seg[1:3], "big")
            W = int.from_bytes(seg[3:5], "big")
            n = seg[5]
            if n not in (1, 3) or H == 0 or W == 0:
                raise ValidationError(
                    f"JPEG with {n} components at {W}x{H} is not supported")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                                seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(n)]
            if any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in comps):
                raise ValidationError("JPEG sampling factors out of range")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcus = (-(-H // (8 * vmax)), -(-W // (8 * hmax)))
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    raise ValidationError("JPEG sampling factors are not integer ratios")
                c.dw, c.dh = -(-W * c.h // hmax), -(-H * c.v // vmax)
                c.bw, c.bh = mcus[1] * c.h, mcus[0] * c.v
                c.coefs = [0] * (c.bw * c.bh * 64)
        elif marker == 0xDA:
            if not comps:
                raise ValidationError("JPEG scan before its frame header")
            ns = seg[0]
            by_id = {c.cid: c for c in comps}
            in_scan = []
            for i in range(ns):
                c = by_id.get(seg[1 + 2 * i])
                if c is None:
                    raise ValidationError("JPEG scan names an unknown component")
                c.tq_dc, c.ta = seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15
                in_scan.append(c)
            for i in (0, 1):                      # Motion-JPEG: no DHT
                dc_tabs.setdefault(i, _STD_DC[i])
                ac_tabs.setdefault(i, _STD_AC[i])
            segs, pos = _entropy_segments(data, pos)
            _decode_scan(in_scan, segs, restart, dc_tabs, ac_tabs, mcus)
            scans += 1
    if not comps:
        raise ValidationError("JPEG has no frame header")
    if not scans:
        raise ValidationError("JPEG has no scan")
    planes = []
    for c in comps:
        if c.tq not in qts:
            raise ValidationError(f"JPEG quantisation table {c.tq} is undefined")
        coefs = np.array(c.coefs, np.int64).reshape(-1, 64) * qts[c.tq]
        samples = inverse_dct(coefs.reshape(-1, 8, 8))
        plane = samples.reshape(c.bh, c.bw, 8, 8).swapaxes(1, 2).reshape(
            c.bh * 8, c.bw * 8)[:c.dh, :c.dw]
        full = _upsample(plane, hmax // c.h, vmax // c.v)
        planes.append(full[:H, :W])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    ids = tuple(c.cid for c in comps)
    is_rgb = (not jfif) and (adobe == 0 if adobe is not None
                             else ids == (82, 71, 66))
    if is_rgb:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)
