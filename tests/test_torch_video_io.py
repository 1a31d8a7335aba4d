"""Video container I/O of the port (``utils/video_io.py``) against the JAX
package's: an AVI the port writes is byte for byte the JAX package's (its
JPEG frames through the port's codec, the JAX package's through OpenCV),
each package reads the other's file identically, ``load_video``'s frame
selection, fps and audio trim are the JAX package's, mp4/webm go through
OpenCV with the sidecar ``.wav``, and without OpenCV the AVI path still
works while mp4 raises the JAX package's error."""

import sys

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.utils import video_io as tvio
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError

pytest.importorskip("cv2")
jvio = pytest.importorskip("comfyui_distributed_tpu.utils.video_io")
JValidationError = pytest.importorskip(
    "comfyui_distributed_tpu.utils.exceptions").ValidationError


def frames_u8(t=6, h=20, w=36, seed=0) -> np.ndarray:
    """Gradients with a little seeded noise, brighter frame by frame, so
    that the order survives a round trip."""
    y = np.linspace(0.0, 0.6, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0.0, 0.3, w, dtype=np.float32)[None, :, None]
    rng = np.random.default_rng(seed)
    out = [np.clip(y + x + 0.05 * i + 0.02 * rng.standard_normal((h, w, 3)), 0, 1)
           for i in range(t)]
    return (np.stack(out) * 255 + 0.5).astype(np.uint8)


def audio(seconds=0.75, sr=16000, channels=2, seed=1) -> dict:
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float32) / sr
    wf = 0.5 * np.sin(2 * np.pi * 440.0 * t)[None, None] + 0.01 * \
        np.random.default_rng(seed).standard_normal((1, channels, n))
    return {"waveform": wf.astype(np.float32), "sample_rate": sr}


def pcm16(a: dict) -> np.ndarray:
    return (np.clip(a["waveform"][0], -1, 1) * 32767).astype(np.int16).T.copy()


def same_clip(ours: dict, theirs: dict) -> None:
    assert ours.keys() == theirs.keys()
    np.testing.assert_array_equal(ours["frames"], theirs["frames"])
    assert ours["fps"] == theirs["fps"]
    for key in set(ours) - {"frames", "fps", "audio"}:
        assert ours[key] == theirs[key]
    if theirs["audio"] is None:
        assert ours["audio"] is None
        return
    assert ours["audio"]["sample_rate"] == theirs["audio"]["sample_rate"]
    np.testing.assert_array_equal(np.asarray(ours["audio"]["waveform"]),
                                  np.asarray(theirs["audio"]["waveform"]))


@pytest.mark.parametrize("fps,quality,with_audio", [
    (8.0, 95, False), (8.0, 95, True), (23.976, 60, True), (30.0, 100, True)])
def test_avi_bytes_equal_jax(tmp_path, fps, quality, with_audio):
    frames = frames_u8()
    pcm = pcm16(audio(seconds=0.4)) if with_audio else None
    tvio.write_avi_mjpg(tmp_path / "ours.avi", frames, fps, pcm=pcm,
                        sample_rate=16000, quality=quality)
    jvio.write_avi_mjpg(tmp_path / "theirs.avi", frames, fps, pcm=pcm,
                        sample_rate=16000, quality=quality)
    assert (tmp_path / "ours.avi").read_bytes() == (tmp_path / "theirs.avi").read_bytes()


@pytest.mark.parametrize("skip,nth,cap", [(0, 1, 0), (1, 2, 0), (0, 1, 3),
                                          (2, 3, 1), (7, 1, 0)])
def test_each_reads_the_others_avi(tmp_path, skip, nth, cap):
    a = audio()
    jvio.save_video(tmp_path / "jax.avi", frames_u8(seed=2), fps=8.0, audio=a)
    tvio.save_video(tmp_path / "port.avi", torch.from_numpy(frames_u8(seed=2)),
                    fps=8.0, audio={**a, "waveform": torch.from_numpy(a["waveform"])})
    assert (tmp_path / "jax.avi").read_bytes() == (tmp_path / "port.avi").read_bytes()
    for name in ("jax.avi", "port.avi"):
        ours = tvio.read_avi_mjpg(tmp_path / name, skip=skip, nth=nth, cap=cap)
        theirs = jvio.read_avi_mjpg(tmp_path / name, skip=skip, nth=nth, cap=cap)
        same_clip(ours, theirs)
        assert isinstance(ours["audio"]["waveform"], torch.Tensor)


@pytest.mark.parametrize("cap,skip,nth", [(0, 0, 1), (0, 2, 1), (0, 0, 2),
                                          (3, 0, 1), (2, 1, 2), (6, 0, 1)])
def test_load_video_selection_equals_jax(tmp_path, cap, skip, nth):
    tvio.save_video(tmp_path / "clip.avi", frames_u8(t=6), fps=12.0,
                    audio=audio(seconds=0.5))
    ours = tvio.load_video(tmp_path / "clip.avi", cap, skip, nth)
    theirs = jvio.load_video(tmp_path / "clip.avi", cap, skip, nth)
    same_clip(ours, theirs)
    assert ours["frames"].dtype == np.float32


def test_non_avi_and_non_mjpg_read_as_none(tmp_path):
    (tmp_path / "x.avi").write_bytes(b"RIFF\x00\x00\x00\x00WAVEfmt ")
    assert tvio.read_avi_mjpg(tmp_path / "x.avi") is None
    assert jvio.read_avi_mjpg(tmp_path / "x.avi") is None


@pytest.mark.parametrize("ext", [".mp4", ".webm"])
def test_cv2_formats_carry_audio_as_a_sidecar(tmp_path, ext):
    a = audio(seconds=0.5)
    written = tvio.save_video(tmp_path / f"ours{ext}", frames_u8(), fps=8.0,
                              audio=a)
    jvio.save_video(tmp_path / f"theirs{ext}", frames_u8(), fps=8.0, audio=a)
    assert written == [str(tmp_path / f"ours{ext}"), str(tmp_path / "ours.wav")]
    assert (tmp_path / "ours.wav").read_bytes() == (tmp_path / "theirs.wav").read_bytes()
    for name in (f"ours{ext}", f"theirs{ext}"):
        same_clip(tvio.load_video(tmp_path / name, 4, 1, 1),
                  jvio.load_video(tmp_path / name, 4, 1, 1))


def test_without_cv2_avi_works_and_mp4_raises_jaxs_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 fails
    tvio.save_video(tmp_path / "clip.avi", frames_u8(), fps=8.0, audio=audio())
    clip = tvio.load_video(tmp_path / "clip.avi")
    assert clip["frames"].shape == (6, 20, 36, 3) and clip["audio"] is not None
    with pytest.raises(ValidationError, match=r"video container I/O needs OpenCV \(cv2\)"):
        tvio.save_video(tmp_path / "clip.mp4", frames_u8(), fps=8.0)
    monkeypatch.delitem(sys.modules, "cv2")
    jvio.save_video(tmp_path / "clip.mp4", frames_u8(), fps=8.0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValidationError, match="needs OpenCV"):
        tvio.load_video(tmp_path / "clip.mp4")


def test_validation_errors_match_jax(tmp_path):
    cases = [
        lambda m: m.save_video(tmp_path / "a.avi", np.zeros((0, 4, 4, 3), np.float32)),
        lambda m: m.save_video(tmp_path / "a.mkv", frames_u8()),
        lambda m: m.load_video(tmp_path / "missing.avi"),
    ]
    for case in cases:
        with pytest.raises(JValidationError) as theirs:
            case(jvio)
        with pytest.raises(ValidationError) as ours:
            case(tvio)
        assert str(ours.value) == str(theirs.value)


def test_frames_of_any_layout_quantise_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    for frames in (rng.random((2, 8, 8)).astype(np.float32),           # gray
                   rng.random((2, 8, 8, 1)).astype(np.float32),
                   rng.random((2, 8, 8, 4)).astype(np.float32)):       # RGBA
        np.testing.assert_array_equal(tvio._to_uint8_frames(torch.from_numpy(frames)),
                                      jvio._to_uint8_frames(frames))
    # an empty track writes no audio stream, as in the JAX package
    silent = {"waveform": torch.zeros((1, 1, 0)), "sample_rate": 44100}
    tvio.save_video(tmp_path / "s.avi", frames_u8(t=2), fps=4.0, audio=silent)
    assert tvio.load_video(tmp_path / "s.avi")["audio"] is None
