"""AUDIO on the wire and on disk (the port's copy of the JAX package's
``utils/audio_payload.py``, byte for byte the same envelopes and WAV
files).

AUDIO is ComfyUI's own type, ``{"waveform": float32 [B,C,S],
"sample_rate": int}``. The waveform stays on the CPU: no model of the
port consumes audio, and every consumer of a waveform (the collector's
envelope, the WAV and AVI writers, the dividers' slices) works on host
bytes, so moving it to the card would only add two copies. The codecs
take a tensor or a numpy array and give back CPU tensors.

- ``encode_audio``/``decode_audio``: the collector's envelope, base64
  float32 with its shape and rate, capped at
  ``CDT_MAX_AUDIO_PAYLOAD_BYTES``;
- ``wav_bytes``/``wav_decode``: 16-bit PCM WAV out, 8/16/32-bit PCM in,
  through the standard library's ``wave``.
"""

from __future__ import annotations

import base64
import io
import wave
from typing import Any

import numpy as np
import torch

from . import constants
from .exceptions import ValidationError


def host_array(waveform: Any) -> np.ndarray:
    """A waveform (tensor on any device, or array-like) as numpy."""
    if hasattr(waveform, "detach"):
        waveform = waveform.detach().cpu().numpy()
    return np.asarray(waveform)


def encode_audio(audio: dict[str, Any]) -> dict[str, Any]:
    wf = host_array(audio.get("waveform"))
    if wf.ndim != 3:
        raise ValidationError(f"waveform must be [B,C,S], got shape {wf.shape}")
    wf = np.ascontiguousarray(wf.astype(np.float32))
    cap = constants.max_audio_payload_bytes()
    if wf.nbytes > cap:
        raise ValidationError(
            f"audio payload {wf.nbytes} bytes exceeds cap {cap}")
    return {
        "data": base64.b64encode(wf.tobytes()).decode("ascii"),
        "dtype": "float32",
        "shape": list(wf.shape),
        "sample_rate": int(audio.get("sample_rate", 44100)),
    }


def decode_audio(envelope: dict[str, Any]) -> dict[str, Any]:
    for field in ("data", "shape", "sample_rate"):
        if field not in envelope:
            raise ValidationError(f"audio envelope missing {field!r}", field=field)
    if envelope.get("dtype", "float32") != "float32":
        raise ValidationError(f"unsupported audio dtype {envelope['dtype']!r}")
    shape = tuple(int(s) for s in envelope["shape"])
    if len(shape) != 3 or any(s < 0 for s in shape):
        raise ValidationError(f"invalid audio shape {shape}")
    expected = int(np.prod(shape)) * 4
    if expected > constants.max_audio_payload_bytes():
        raise ValidationError("audio envelope exceeds byte cap")
    try:
        raw = base64.b64decode(envelope["data"])
    except Exception as e:
        raise ValidationError(f"invalid base64 audio payload: {e}") from e
    if len(raw) != expected:
        raise ValidationError(
            f"audio payload size {len(raw)} != expected {expected} for shape {shape}")
    wf = np.frombuffer(raw, dtype=np.float32).reshape(shape).copy()
    return {"waveform": torch.from_numpy(wf),
            "sample_rate": int(envelope["sample_rate"])}


def wav_bytes(waveform: Any, sample_rate: int) -> bytes:
    """Encode one clip ``[C, S]`` (float32, [-1, 1]) as 16-bit PCM WAV."""
    wf = host_array(waveform).astype(np.float32)
    if wf.ndim == 1:
        wf = wf[None]
    if wf.ndim != 2:
        raise ValidationError(f"wav clip must be [C,S], got shape {wf.shape}")
    pcm = (np.clip(wf, -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(np.ascontiguousarray(pcm.T).tobytes())  # interleaved
    return buf.getvalue()


def wav_decode(data: bytes) -> dict[str, Any]:
    """Decode a PCM WAV (8/16/32-bit int) into an AUDIO dict
    ``{"waveform": [1, C, S] float32 tensor, "sample_rate": int}``."""
    try:
        with wave.open(io.BytesIO(data), "rb") as w:
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            rate = w.getframerate()
            frames = w.readframes(w.getnframes())
    except (wave.Error, EOFError) as e:
        raise ValidationError(f"invalid WAV data: {e}") from e
    if width == 2:
        pcm = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        pcm = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:                          # 8-bit WAV is unsigned
        pcm = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValidationError(f"unsupported WAV sample width {width}")
    if n_ch > 0 and pcm.size % n_ch:
        pcm = pcm[: pcm.size - pcm.size % n_ch]
    wf = pcm.reshape(-1, max(1, n_ch)).T[None]          # [1, C, S]
    return {"waveform": torch.from_numpy(np.ascontiguousarray(wf)),
            "sample_rate": int(rate)}
