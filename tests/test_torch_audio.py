"""AUDIO in the port against the JAX package: the collector's envelope
and the WAV files byte for byte (``utils/audio_payload.py``), the same
validation errors, the byte cap knob, the dividers' chunks
(``AudioBatchDivider``, ``ImageBatchDivider``) and the collector's join
of clips (``CollectorBridge._combine_audio``)."""

import io
import json
import wave

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.cluster.collector_bridge import (
    CollectorBridge as TBridge)
from comfyui_distributed_tpu_torch.graph.node import get_node
from comfyui_distributed_tpu_torch.utils import audio_payload as tap
from comfyui_distributed_tpu_torch.utils import constants
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError

jap = pytest.importorskip("comfyui_distributed_tpu.utils.audio_payload")
JValidationError = pytest.importorskip(
    "comfyui_distributed_tpu.utils.exceptions").ValidationError


def clip(shape, seed=0, scale=0.6) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 1, 0), (1, 2, 777), (3, 1, 50)])
def test_envelope_equals_jax(shape):
    wf = clip(shape)
    want = jap.encode_audio({"waveform": wf, "sample_rate": 22050})
    for given in (wf, torch.from_numpy(wf)):
        env = tap.encode_audio({"waveform": given, "sample_rate": 22050})
        assert json.dumps(env) == json.dumps(want)
    back = tap.decode_audio(want)
    assert isinstance(back["waveform"], torch.Tensor)
    assert back["sample_rate"] == 22050
    np.testing.assert_array_equal(back["waveform"].numpy(),
                                  jap.decode_audio(want)["waveform"])
    # no rate given: both default to 44100
    assert tap.encode_audio({"waveform": wf})["sample_rate"] == 44100


def _bad_envelopes():
    good = jap.encode_audio({"waveform": clip((1, 1, 8)), "sample_rate": 8000})
    yield {k: v for k, v in good.items() if k != "data"}
    yield {k: v for k, v in good.items() if k != "shape"}
    yield {k: v for k, v in good.items() if k != "sample_rate"}
    yield {**good, "dtype": "int16"}
    yield {**good, "shape": [1, 8]}
    yield {**good, "shape": [1, -1, 8]}
    yield {**good, "shape": [1, 1, 9]}
    yield {**good, "data": "@@not base64@@"}


@pytest.mark.parametrize("envelope", list(_bad_envelopes()))
def test_decode_refuses_what_jax_refuses(envelope):
    with pytest.raises(JValidationError) as theirs:
        jap.decode_audio(envelope)
    with pytest.raises(ValidationError) as ours:
        tap.decode_audio(envelope)
    assert str(ours.value).split(":")[0] == str(theirs.value).split(":")[0]


def test_encode_refuses_a_waveform_that_is_not_3d():
    with pytest.raises(ValidationError, match=r"waveform must be \[B,C,S\]"):
        tap.encode_audio({"waveform": np.zeros((2, 5), np.float32)})


def test_byte_cap_knob(monkeypatch):
    assert constants.max_audio_payload_bytes() == 256 * 1024 * 1024
    monkeypatch.setenv("CDT_MAX_AUDIO_PAYLOAD_BYTES", "100")
    assert constants.max_audio_payload_bytes() == 100
    with pytest.raises(ValidationError, match="exceeds cap 100"):
        tap.encode_audio({"waveform": np.zeros((1, 1, 26), np.float32)})
    env = jap.encode_audio({"waveform": np.zeros((1, 1, 26), np.float32)})
    with pytest.raises(ValidationError, match="exceeds byte cap"):
        tap.decode_audio(env)
    monkeypatch.setenv("CDT_MAX_AUDIO_PAYLOAD_BYTES", "lots")
    with pytest.raises(constants.KnobError):
        constants.max_audio_payload_bytes()


@pytest.mark.parametrize("shape", [(5,), (1, 300), (2, 301)])
def test_wav_bytes_equal_jax(shape):
    wf = clip(shape, seed=1, scale=0.9)            # some samples past ±1: clipped
    assert tap.wav_bytes(wf, 16000) == jap.wav_bytes(wf, 16000)
    assert tap.wav_bytes(torch.from_numpy(wf), 16000) == jap.wav_bytes(wf, 16000)


def _pcm_wav(width: int, channels: int, frames: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    dtype = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(np.dtype(dtype))
    pcm = rng.integers(info.min, info.max, frames * channels, endpoint=True,
                       dtype=np.int64).astype(dtype)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(11025)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [1, 2, 4], ids=["8bit", "16bit", "32bit"])
def test_wav_decode_equals_jax(width, channels):
    data = _pcm_wav(width, channels, 257, seed=width)
    ours, theirs = tap.wav_decode(data), jap.wav_decode(data)
    assert ours["sample_rate"] == theirs["sample_rate"] == 11025
    assert ours["waveform"].dtype == torch.float32
    np.testing.assert_array_equal(ours["waveform"].numpy(), theirs["waveform"])
    assert ours["waveform"].shape == (1, channels, 257)


def test_wav_decode_refuses_garbage_and_24_bit():
    with pytest.raises(ValidationError, match="invalid WAV"):
        tap.wav_decode(b"RIFF0000WAVEjunk")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(8000)
        w.writeframes(b"\x00" * 30)
    with pytest.raises(ValidationError, match="sample width 3"):
        tap.wav_decode(buf.getvalue())


def _jax_node(name):
    return pytest.importorskip(
        "comfyui_distributed_tpu.graph.nodes_builtin").NODE_REGISTRY[name]


@pytest.mark.parametrize("divide_by", range(1, 11))
def test_audio_divider_equals_jax(divide_by):
    wf = clip((1, 2, 23), seed=divide_by)
    audio = {"waveform": wf, "sample_rate": 8000}
    theirs = _jax_node("AudioBatchDivider")().execute(audio, divide_by=divide_by)
    ours = get_node("AudioBatchDivider")().execute(
        {"waveform": torch.from_numpy(wf), "sample_rate": 8000},
        divide_by=divide_by)
    assert len(ours) == len(theirs) == 10
    for o, t in zip(ours, theirs):
        assert o["sample_rate"] == t["sample_rate"] == 8000
        np.testing.assert_array_equal(o["waveform"].numpy(),
                                      np.asarray(t["waveform"]))


@pytest.mark.parametrize("divide_by", [0, *range(1, 11), 12])
def test_image_divider_equals_jax(divide_by):
    images = np.random.default_rng(divide_by).random((7, 3, 2, 3)).astype(np.float32)
    theirs = _jax_node("ImageBatchDivider")().execute(images, divide_by=divide_by)
    ours = get_node("ImageBatchDivider")().execute(
        torch.from_numpy(images), divide_by=divide_by, model_registry=_cpu())
    assert len(ours) == len(theirs) == 10
    for o, t in zip(ours, theirs):
        assert o.device.type == "cpu"
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))


def _cpu():
    class Registry:
        device = torch.device("cpu")
    return Registry()


@pytest.mark.parametrize("case", ["both", "master only", "workers only",
                                  "fewer channels", "none"])
def test_combine_audio_equals_jax(case):
    JBridge = pytest.importorskip(
        "comfyui_distributed_tpu.cluster.collector_bridge").CollectorBridge
    local = {"waveform": clip((1, 2, 5), seed=1), "sample_rate": 8000}
    parts = {"w1": {"waveform": clip((1, 2, 3), seed=2), "sample_rate": 8000},
             "w0": {"waveform": clip((1, 1, 4), seed=3), "sample_rate": 8000}}
    expected = ("w0", "w1", "w2")
    if case == "master only":
        parts = {}
    elif case == "workers only":
        local = None
    elif case == "both":
        parts["w0"] = {"waveform": clip((1, 2, 4), seed=3), "sample_rate": 8000}
    elif case == "none":
        local, parts = None, {}
    theirs = JBridge._combine_audio(local, parts, expected)
    torch_parts = {w: {**p, "waveform": torch.from_numpy(p["waveform"])}
                   for w, p in parts.items()}
    ours = TBridge._combine_audio(
        None if local is None else {**local,
                                    "waveform": torch.from_numpy(local["waveform"])},
        torch_parts, expected)
    if theirs is None:
        assert ours is None
        return
    assert ours["sample_rate"] == theirs["sample_rate"]
    np.testing.assert_array_equal(ours["waveform"].numpy(), theirs["waveform"])
