"""The port's baseline JPEG codec (``utils/jpeg.py``) against OpenCV, the
codec the JAX package calls for the MJPG frames of its AVI files: the
encoder's bytes equal ``cv2.imencode``'s at the same quality, and the
decoder's pixels equal ``cv2.imdecode``'s, byte for byte and bit for bit
(no tolerance: both follow libjpeg's integer arithmetic)."""

import numpy as np
import pytest

from comfyui_distributed_tpu_torch.utils import jpeg
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError

cv2 = pytest.importorskip("cv2")

SIZES = [(1, 1), (17, 33), (64, 96)]


def image(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """[h, w, 3] uint8 RGB: seeded noise, or smooth gradients."""
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    y = np.linspace(0, 255, h)[:, None]
    x = np.linspace(0, 255, w)[None, :]
    return np.stack([np.broadcast_to(y, (h, w)), np.broadcast_to(x, (h, w)),
                     np.broadcast_to((x + y) / 2, (h, w))], -1).astype(np.uint8)


def cv2_jpeg(rgb: np.ndarray, params=()) -> bytes:
    src = rgb if rgb.ndim == 2 else rgb[..., ::-1]
    ok, buf = cv2.imencode(".jpg", src, list(params))
    assert ok
    return buf.tobytes()


def cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


def header(data: bytes) -> dict:
    """The sampling factors (h, v) of each component and the restart
    interval the markers before the first scan give."""
    i, out = 2, {"factors": [], "restart": 0}
    while data[i + 1] != 0xDA:
        length = int.from_bytes(data[i + 2:i + 4], "big")
        seg = data[i + 4:i + 2 + length]
        if data[i + 1] == 0xC0:
            out["factors"] = [(seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15)
                              for c in range(seg[5])]
        elif data[i + 1] == 0xDD:
            out["restart"] = int.from_bytes(seg[:2], "big")
        i += 2 + length
    return out


def strip_dht(data: bytes) -> bytes:
    """The same JPEG without its DHT segments (a Motion-JPEG frame)."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        length = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + length]
        i += 2 + length
    return bytes(out + data[i:])


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95, 100])
def test_encoder_bytes_equal_cv2(quality, size, kind):
    rgb = image(kind, *size)
    ours = jpeg.encode_jpeg(rgb, quality)
    assert ours == cv2_jpeg(rgb, [cv2.IMWRITE_JPEG_QUALITY, quality])
    # and our decoder reads it as OpenCV does
    np.testing.assert_array_equal(jpeg.decode_jpeg(ours), cv2_rgb(ours))


SAMPLINGS = {
    "420": (),
    "444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
    "440": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
    "411": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
}


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("size", SIZES + [(3, 2), (33, 47)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_decoder_equals_cv2(sampling, size, kind):
    data = cv2_jpeg(image(kind, *size, seed=1),
                    [cv2.IMWRITE_JPEG_QUALITY, 90, *SAMPLINGS[sampling]])
    factors = set(header(data)["factors"])
    assert factors == {"420": {(2, 2), (1, 1)}, "444": {(1, 1)},
                       "422": {(2, 1), (1, 1)}, "440": {(1, 2), (1, 1)},
                       "411": {(4, 1), (1, 1)}}[sampling]
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), cv2_rgb(data))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decoder_grayscale(size):
    data = cv2_jpeg(image("noise", *size, seed=2)[..., 0],
                    [cv2.IMWRITE_JPEG_QUALITY, 85])
    assert len(header(data)["factors"]) == 1
    out = jpeg.decode_jpeg(data)
    assert out.shape == (*size, 3)
    np.testing.assert_array_equal(out, cv2_rgb(data))


@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_decoder_restart_intervals(interval, sampling):
    data = cv2_jpeg(image("noise", 40, 72, seed=3),
                    [cv2.IMWRITE_JPEG_QUALITY, 80,
                     cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                     *SAMPLINGS[sampling]])
    assert header(data)["restart"] == interval
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), cv2_rgb(data))


@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_decoder_inserts_the_standard_tables_without_a_dht(kind):
    data = strip_dht(cv2_jpeg(image(kind, 24, 40, seed=4),
                              [cv2.IMWRITE_JPEG_QUALITY, 75]))
    assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), cv2_rgb(data))


def test_progressive_is_refused_by_name():
    data = cv2_jpeg(image("gradient", 16, 16), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValidationError, match=r"progressive JPEG \(SOF2\)"):
        jpeg.decode_jpeg(data)


@pytest.mark.parametrize("cut", [2, 100, -40])
def test_corrupt_data_raises_validation_error(cut):
    data = cv2_jpeg(image("noise", 32, 32, seed=5), [cv2.IMWRITE_JPEG_QUALITY, 90])
    with pytest.raises(ValidationError):
        jpeg.decode_jpeg(data[:cut] if cut > 0 else data[:cut - 300])
    with pytest.raises(ValidationError):
        jpeg.decode_jpeg(b"not a jpeg")


def test_encoder_refuses_what_baseline_cannot_hold():
    with pytest.raises(ValidationError):
        jpeg.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValidationError):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValidationError):
        jpeg.encode_jpeg(np.zeros((0, 4, 3), np.uint8))


def test_quant_tables_follow_libjpegs_quality_rule():
    for quality in (1, 25, 50, 75, 95, 100):
        data = cv2_jpeg(image("gradient", 8, 8), [cv2.IMWRITE_JPEG_QUALITY, quality])
        i, tables = 2, []
        while data[i + 1] != 0xDA:
            length = int.from_bytes(data[i + 2:i + 4], "big")
            if data[i + 1] == 0xDB:
                tables.append(np.frombuffer(data[i + 5:i + 69], np.uint8))
            i += 2 + length
        for ours, theirs in zip(jpeg.quant_tables(quality), tables):
            np.testing.assert_array_equal(ours[jpeg.ZIGZAG], theirs)
