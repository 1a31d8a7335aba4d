"""Video container I/O (the port's copy of the JAX package's
``utils/video_io.py``: the same files, the same frames, the same audio).

- **avi**: a RIFF muxer/demuxer of MJPG video and 16-bit PCM audio,
  interleaved one audio slice per frame. The JPEG frames go through the
  port's own codec (``utils/jpeg.py``), which writes the bytes OpenCV
  writes, so an AVI of the port equals the JAX package's byte for byte.
  This path needs nothing but numpy.
- **mp4 / webm**: OpenCV's ``VideoWriter``/``VideoCapture``, imported
  inside that branch only; without OpenCV it raises the JAX package's
  ``ValidationError``. OpenCV cannot mux audio, so a track is written as
  a sidecar ``<name>.wav`` beside the container and ``load_video``
  attaches it again.

Frames are IMAGE batches ``[T, H, W, C]`` float32 in [0, 1] (a tensor on
any device, or an array); ``load_video`` gives them back as a float32
numpy array. AUDIO is the ``{"waveform": [B, C, S], "sample_rate"}``
dict of ``utils/audio_payload.py``.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .audio_payload import host_array, wav_bytes, wav_decode
from .exceptions import ValidationError
from .image import to_uint8
from .jpeg import decode_jpeg, encode_jpeg
from .logging import log

# containers written through OpenCV; reading is extension-agnostic
_FOURCC = {".mp4": "mp4v", ".webm": "VP80"}
ENCODE_THREADS = 4


def _require_cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ValidationError(
            "video container I/O needs OpenCV (cv2), which is not "
            "importable in this environment") from exc
    return cv2


def _to_uint8_frames(frames: Any) -> np.ndarray:
    """IMAGE batch → [T, H, W, 3] uint8 (grayscale replicated, alpha
    stripped), quantised by ``utils.image.to_uint8`` as PNGs are."""
    if isinstance(frames, torch.Tensor):
        frames = frames.detach()
        frames = (frames if frames.dtype == torch.uint8 else frames.float()
                  ).cpu().numpy()
    arr = np.asarray(frames)
    if arr.ndim == 3 and arr.shape[-1] > 4:      # [T,H,W] grayscale
        arr = arr[..., None]
    arr = to_uint8(arr)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    elif arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr


def _first_clip(audio: dict[str, Any]) -> tuple[np.ndarray, int]:
    """AUDIO dict → ([C, S] float32 of clip 0, sample_rate): a container
    carries one track, so a batch keeps clip 0 and logs the rest
    (``SaveAudio`` writes one file per clip)."""
    wf = host_array(audio["waveform"]).astype(np.float32)
    if wf.ndim == 2:
        wf = wf[None]
    if wf.ndim != 3:
        raise ValidationError(
            f"audio waveform must be [B,C,S], got shape {wf.shape}")
    if wf.shape[0] > 1:
        log(f"video audio track: batch of {wf.shape[0]} clips, writing "
            f"clip 0 only (use SaveAudio for one file per clip)")
    return wf[0], int(audio.get("sample_rate", 44100))


def _audio_pcm16(audio: dict[str, Any]) -> tuple[np.ndarray, int]:
    """AUDIO dict → ([S, C] int16 of clip 0, sample_rate)."""
    clip, sr = _first_clip(audio)
    pcm = (np.clip(clip, -1.0, 1.0) * 32767.0).astype(np.int16)
    return pcm.T.copy(), sr


# --- AVI (RIFF): MJPG video + PCM audio, interleaved ----------------------------


def _chunk(ckid: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return ckid + struct.pack("<I", len(payload)) + payload + pad


def _list_chunk(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def write_avi_mjpg(path: Path, frames: np.ndarray, fps: float,
                   pcm: Optional[np.ndarray] = None,
                   sample_rate: int = 44100, quality: int = 95) -> None:
    """Write an AVI: MJPG frames and optional interleaved 16-bit PCM.
    ``frames`` [T,H,W,3] uint8 RGB; ``pcm`` [S, C] int16."""
    T, H, W, _ = frames.shape
    # the encoder is numpy throughout, which releases the GIL: frames in
    # parallel (about 3x on 4 cores at 1080p)
    with ThreadPoolExecutor(max(1, min(ENCODE_THREADS, T))) as pool:
        jpegs = list(pool.map(lambda f: encode_jpeg(f, quality), frames))

    has_audio = pcm is not None and pcm.size > 0
    n_ch = int(pcm.shape[1]) if has_audio else 0
    block_align = 2 * n_ch
    byte_rate = sample_rate * block_align

    # stream headers; fps as the rational rate/scale at ms precision
    scale, rate = 1000, int(round(fps * 1000))
    strh_v = struct.pack(
        "<4s4sIHHIIIIIIII4H", b"vids", b"MJPG", 0, 0, 0, 0,
        scale, rate, 0, T, max(len(j) for j in jpegs), 0xFFFFFFFF, 0,
        0, 0, W, H)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG",
                         W * H * 3, 0, 0, 0, 0)          # BITMAPINFOHEADER
    streams = [_list_chunk(b"strl",
                           _chunk(b"strh", strh_v) + _chunk(b"strf", strf_v))]
    if has_audio:
        n_samples = pcm.shape[0]
        strh_a = struct.pack(
            "<4s4sIHHIIIIIIII4H", b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0,
            block_align, byte_rate, 0,
            n_samples * block_align // max(block_align, 1),
            byte_rate, 0xFFFFFFFF, block_align, 0, 0, 0, 0)
        strf_a = struct.pack("<HHIIHHH", 1, n_ch, sample_rate, byte_rate,
                             block_align, 16, 0)         # WAVEFORMATEX (PCM)
        streams.append(_list_chunk(
            b"strl", _chunk(b"strh", strh_a) + _chunk(b"strf", strf_a)))

    usec_per_frame = int(round(1_000_000 / max(fps, 1e-6)))
    avih = struct.pack(
        "<IIIIIIIIIIIIII", usec_per_frame,
        int(byte_rate + np.mean([len(j) for j in jpegs]) * fps),
        0, 0x10,                                         # AVIF_HASINDEX
        T, 0, len(streams), max(len(j) for j in jpegs), W, H, 0, 0, 0, 0)
    hdrl = _list_chunk(b"hdrl", _chunk(b"avih", avih) + b"".join(streams))

    # movi: one audio slice after each frame
    movi_parts: list[bytes] = []
    index: list[tuple[bytes, int, int]] = []             # (ckid, offset, size)
    offset = 4                                           # past the 'movi' tag
    spf = sample_rate / max(fps, 1e-6)                   # samples per frame
    for i in range(T):
        data = jpegs[i]
        movi_parts.append(_chunk(b"00dc", data))
        index.append((b"00dc", offset, len(data)))
        offset += 8 + len(data) + (len(data) % 2)
        if has_audio:
            lo, hi = int(round(i * spf)), int(round((i + 1) * spf))
            chunk_pcm = pcm[lo:min(hi, pcm.shape[0])]
            if i == T - 1:                               # tail: rest of track
                chunk_pcm = pcm[lo:]
            if chunk_pcm.size:
                data = chunk_pcm.tobytes()
                movi_parts.append(_chunk(b"01wb", data))
                index.append((b"01wb", offset, len(data)))
                offset += 8 + len(data) + (len(data) % 2)
    movi = _list_chunk(b"movi", b"".join(movi_parts))
    idx1 = _chunk(b"idx1", b"".join(
        struct.pack("<4sIII", ckid, 0x10, off, size)
        for ckid, off, size in index))

    riff_payload = b"AVI " + hdrl + movi + idx1
    path.write_bytes(b"RIFF" + struct.pack("<I", len(riff_payload))
                     + riff_payload)


def _iter_riff_chunks(buf: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        ckid = buf[pos:pos + 4]
        size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        yield ckid, pos + 8, size
        pos += 8 + size + (size % 2)


def read_avi_mjpg(path: Path, skip: int = 0, nth: int = 1,
                  cap: int = 0) -> Optional[dict[str, Any]]:
    """Demux an MJPG (+ PCM) AVI: ``{"frames", "fps", "audio",
    "truncated"}``, or None when the file is not one. ``skip``/``nth``/
    ``cap`` select frames before any is decoded; ``fps`` is the source's
    rate and ``audio`` its whole track (``load_video`` rescales and trims
    them together)."""
    buf = path.read_bytes()
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        return None

    fps = 30.0
    audio_fmt: Optional[tuple[int, int]] = None      # (channels, rate)
    jpegs: list[bytes] = []
    pcm_parts: list[bytes] = []
    saw_mjpg = False

    def walk(start: int, end: int):
        nonlocal fps, audio_fmt, saw_mjpg
        pending_stream = [None]                      # fccType of the last strh
        for ckid, data_off, size in _iter_riff_chunks(buf, start, end):
            body = buf[data_off:data_off + size]
            if ckid == b"LIST":
                walk(data_off + 4, data_off + size)
            elif ckid == b"strh" and size >= 32:
                fcc_type, handler = body[:4], body[4:8]
                pending_stream[0] = fcc_type
                if fcc_type == b"vids":
                    if handler not in (b"MJPG", b"mjpg"):
                        return
                    saw_mjpg = True
                    scale, rate = struct.unpack("<II", body[20:28])
                    if scale:
                        fps = rate / scale
            elif ckid == b"strf" and pending_stream[0] == b"auds" \
                    and size >= 16:
                fmt, n_ch, sr = struct.unpack("<HHI", body[:8])
                if fmt == 1:                         # PCM
                    audio_fmt = (n_ch, sr)
            elif ckid[2:] == b"dc":
                jpegs.append(body)
            elif ckid[2:] == b"wb":
                pcm_parts.append(body)

    walk(12, len(buf))
    if not saw_mjpg or not jpegs:
        return None

    selected = jpegs[max(0, skip)::max(1, nth)]
    truncated = bool(cap and cap > 0 and len(selected) > cap)
    if truncated:
        selected = selected[:cap]
    frames = [decode_jpeg(j) for j in selected]
    out: dict[str, Any] = {
        "frames": (np.stack(frames).astype(np.float32) / 255.0 if frames
                   else np.zeros((0, 1, 1, 3), np.float32)),
        "fps": float(fps), "audio": None, "truncated": truncated,
    }
    if audio_fmt and pcm_parts:
        n_ch, sr = audio_fmt
        pcm = np.frombuffer(b"".join(pcm_parts), np.int16)
        if n_ch and pcm.size % n_ch == 0:
            wf = (pcm.reshape(-1, n_ch).T.astype(np.float32)
                  / 32768.0)[None]                   # [1, C, S]
            out["audio"] = {"waveform": torch.from_numpy(wf),
                            "sample_rate": sr}
    return out


# --- public API ------------------------------------------------------------------


def save_video(path, frames, fps: float = 8.0,
               audio: Optional[dict[str, Any]] = None,
               quality: int = 95) -> list[str]:
    """Write an IMAGE batch as a video container, the format from the
    suffix (.mp4 / .webm / .avi). Returns the paths written: the
    container, and for the OpenCV formats with audio the sidecar
    ``.wav``."""
    path = Path(path)
    ext = path.suffix.lower()
    arr = _to_uint8_frames(frames)
    if arr.shape[0] == 0:
        raise ValidationError("cannot write a video with 0 frames")
    if audio is not None and host_array(audio["waveform"]).size == 0:
        audio = None                     # empty track (a silent source)
    path.parent.mkdir(parents=True, exist_ok=True)
    written = [str(path)]

    if ext == ".avi":
        pcm, sr = _audio_pcm16(audio) if audio is not None else (None, 44100)
        write_avi_mjpg(path, arr, fps, pcm=pcm, sample_rate=sr,
                       quality=quality)
        return written

    if ext not in _FOURCC:
        raise ValidationError(
            f"unsupported video format {ext!r} (supported: "
            f"{sorted(_FOURCC) + ['.avi']})")
    cv2 = _require_cv2()
    T, H, W, _ = arr.shape
    writer = cv2.VideoWriter(str(path),
                             cv2.VideoWriter_fourcc(*_FOURCC[ext]),
                             float(fps), (W, H))
    if not writer.isOpened():
        raise ValidationError(
            f"OpenCV cannot open a {ext} writer in this environment")
    try:
        for i in range(T):
            writer.write(cv2.cvtColor(arr[i], cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    if audio is not None:
        clip, sr = _first_clip(audio)
        sidecar = path.with_suffix(".wav")
        sidecar.write_bytes(wav_bytes(clip, sr))
        written.append(str(sidecar))
    return written


def load_video(path, frame_load_cap: int = 0, skip_first_frames: int = 0,
               select_every_nth: int = 1) -> dict[str, Any]:
    """A video container → ``{"frames" [T,H,W,3] float32 in [0, 1],
    "fps", "audio" (dict or None), "frame_count"}``. Frame selection
    (cap / skip / stride, VHS_LoadVideo's knobs) happens before decode.
    When it changes the frame set, ``fps`` is divided by the stride and
    the audio cut to the source time the selected frames cover. Audio:
    the muxed track of an AVI, else a sidecar ``.wav`` beside the file."""
    path = Path(path)
    if not path.exists():
        raise ValidationError(f"video file not found: {path}")
    nth = max(1, int(select_every_nth))
    skip = max(0, int(skip_first_frames))
    cap_n = int(frame_load_cap) if frame_load_cap else 0

    result = (read_avi_mjpg(path, skip=skip, nth=nth, cap=cap_n)
              if path.suffix.lower() == ".avi" else None)
    if result is None:
        cv2 = _require_cv2()
        cap = cv2.VideoCapture(str(path))
        if not cap.isOpened():
            raise ValidationError(f"cannot decode video: {path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = []
        truncated = False
        i = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if i >= skip and (i - skip) % nth == 0:
                    if cap_n > 0 and len(frames) >= cap_n:
                        truncated = True         # more frames were there
                        break
                    frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                i += 1
        finally:
            cap.release()
        result = {
            "frames": (np.stack(frames).astype(np.float32) / 255.0
                       if frames else np.zeros((0, 1, 1, 3), np.float32)),
            "fps": float(fps), "audio": None, "truncated": truncated,
        }

    if result["frames"].shape[0] == 0:
        raise ValidationError(
            f"no decodable frames after selection (cap/skip/stride): {path}")

    if result["audio"] is None:
        sidecar = path.with_suffix(".wav")
        if sidecar.exists():
            result["audio"] = wav_decode(sidecar.read_bytes())

    n_sel = int(result["frames"].shape[0])
    src_fps = result["fps"]
    truncated = result.pop("truncated", False)
    if skip > 0 or nth > 1 or truncated:
        result["fps"] = src_fps / nth
        if result["audio"] is not None:
            sr = int(result["audio"].get("sample_rate", 44100))
            lo = int(round(skip / src_fps * sr))
            hi = int(round((skip + (n_sel - 1) * nth + 1) / src_fps * sr))
            result["audio"] = {
                "waveform": result["audio"]["waveform"][..., lo:hi],
                "sample_rate": sr,
            }

    result["frames"] = np.ascontiguousarray(result["frames"])
    result["frame_count"] = n_sel
    return result
