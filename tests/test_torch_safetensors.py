"""The port's ``.safetensors`` reader and writer
(``comfyui_distributed_tpu_torch.utils.safetensors``) against the
``safetensors`` package: F16, BF16, F32, F64, I64 and I32 tensors read
bitwise as the package writes them and written as it reads them; bad
headers raise ``SafetensorsError``. The fp8 formats, I16, I8, U8 and
BOOL (published FLUX and T5 files) read as the JAX package's
``load_safetensors`` reads them, and the writer writes F8_E4M3."""

import json
import struct

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu_torch.utils.safetensors import (
    SafetensorsError, SafetensorsFile, load_file, save_file)

st_numpy = pytest.importorskip("safetensors.numpy")
st_torch = pytest.importorskip("safetensors.torch")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f16": rng.standard_normal((3, 5)).astype(np.float16),
        "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "f64": rng.standard_normal((7,)).astype(np.float64),
        "i64": rng.integers(-2**40, 2**40, (1, 77)),
        "i32": rng.integers(-2**20, 2**20, (4,)).astype(np.int32),
        "scalar": np.array(4.6052, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_reader_matches_safetensors_numpy(tmp_path, seed):
    arrays = _arrays(seed)
    path = tmp_path / "a.safetensors"
    st_numpy.save_file(arrays, str(path))
    with SafetensorsFile(path) as f:
        assert sorted(f) == sorted(arrays) and len(f) == len(arrays)
        for k, a in arrays.items():
            t = f[k]
            assert tuple(t.shape) == a.shape
            np.testing.assert_array_equal(t.numpy(), a)
            assert t.numpy().dtype == a.dtype


def test_reader_matches_safetensors_torch_bf16(tmp_path):
    gen = torch.Generator().manual_seed(3)
    tensors = {"bf16": torch.randn(6, 10, generator=gen).to(torch.bfloat16),
               "odd": torch.randn(3, generator=gen).to(torch.bfloat16),
               "f32": torch.randn(5, generator=gen)}
    path = tmp_path / "b.safetensors"
    st_torch.save_file(tensors, str(path))
    loaded = load_file(path)
    for k, t in tensors.items():
        assert loaded[k].dtype == t.dtype and torch.equal(loaded[k], t)


_PUBLISHED = {
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def _published_tensor(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(5, 7, generator=gen) * 3).to(dtype)
    if dtype == torch.bool:
        return torch.randn(4, 9, generator=gen) > 0
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, (3, 11), generator=gen,
                         dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("name", sorted(_PUBLISHED))
def test_published_dtypes_read_as_jax_reads_them(name, tmp_path):
    """A file written by ``safetensors.torch`` in each dtype: the port
    reads it bitwise, in that dtype, and equal to the JAX package's
    ``load_safetensors`` (which widens what numpy lacks to fp32)."""
    pytest.importorskip("flax")
    from comfyui_distributed_tpu.models.convert import load_safetensors

    t = _published_tensor(_PUBLISHED[name])
    path = tmp_path / f"{name}.safetensors"
    st_torch.save_file({"x": t, "y": t[:1].clone()}, str(path))
    header = json.loads(path.read_bytes()[8:8 + struct.unpack(
        "<Q", path.read_bytes()[:8])[0]])
    assert header["x"]["dtype"] == name
    with SafetensorsFile(path) as f:
        got = f["x"]
        assert got.dtype == t.dtype and tuple(got.shape) == tuple(t.shape)
        assert torch.equal(got.view(torch.uint8), t.view(torch.uint8))
        ref = np.asarray(load_safetensors(path)["x"])
        np.testing.assert_array_equal(got.float().numpy(),
                                      ref.astype(np.float32))


def test_writer_writes_f8_e4m3(tmp_path):
    gen = torch.Generator().manual_seed(4)
    src = torch.randn(6, 5, generator=gen) * 2
    path = tmp_path / "fp8.safetensors"
    save_file({"w": src, "ids": torch.arange(3)}, path,
              dtype=torch.float8_e4m3fn)
    back = st_torch.load_file(str(path))
    assert back["w"].dtype == torch.float8_e4m3fn and back["ids"].dtype == torch.int64
    assert torch.equal(back["w"].view(torch.uint8),
                       src.to(torch.float8_e4m3fn).view(torch.uint8))
    # read back into an fp32 parameter by copy_, as the converters do
    param = torch.empty(6, 5)
    with SafetensorsFile(path) as f:
        param.copy_(f["w"])
    assert torch.equal(param, src.to(torch.float8_e4m3fn).float())


def test_writer_is_read_by_safetensors(tmp_path):
    arrays = _arrays(2)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
    tensors["bf16"] = torch.linspace(-3, 3, 11).to(torch.bfloat16)
    path = tmp_path / "w.safetensors"
    n = save_file(tensors, path)
    assert n == path.stat().st_size
    theirs = st_torch.load_file(str(path))
    assert sorted(theirs) == sorted(tensors)
    for k, t in tensors.items():
        assert theirs[k].dtype == t.dtype and torch.equal(theirs[k], t)
    # the header is padded so that the data starts 8-aligned
    (hlen,) = struct.unpack("<Q", path.read_bytes()[:8])
    assert (8 + hlen) % 8 == 0


def test_writer_casts_floating_tensors_only(tmp_path):
    t = {"w": torch.randn(4, 4, dtype=torch.float32),
         "ids": torch.arange(77)[None]}
    path = tmp_path / "c.safetensors"
    save_file(t, path, dtype=torch.float16)
    with SafetensorsFile(path) as f:
        assert f["w"].dtype == torch.float16 and f["ids"].dtype == torch.int64
        assert torch.equal(f["w"], t["w"].half())
        assert torch.equal(f["ids"], t["ids"])


def test_misaligned_data_is_copied_once(tmp_path):
    """A writer that does not pad its header leaves tensors at offsets
    that are not multiples of their element size: the reader copies
    those, and the values stay right."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(3, dtype=np.int64)
    header = {"a": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]},
              "b": {"dtype": "I64", "shape": [3], "data_offsets": [24, 48]}}
    raw = json.dumps(header).encode()
    raw += b" " * ((-(8 + len(raw)) % 8) + 3)      # start at 3 mod 8
    path = tmp_path / "m.safetensors"
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + a.tobytes() + b.tobytes())
    with SafetensorsFile(path) as f:
        np.testing.assert_array_equal(f["a"].numpy(), a)
        np.testing.assert_array_equal(f["b"].numpy(), b)
        assert f["a"].data_ptr() % 4 == 0 and f["b"].data_ptr() % 8 == 0


def _write_raw(path, header, data=b""):
    raw = header if isinstance(header, bytes) else json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case,match", [
    ("short", "no header"),
    ("length", "does not fit"),
    ("json", "not JSON"),
    ("dtype", "dtype"),
    ("offsets", "outside"),
    ("size", "needs"),
    ("fields", "lacks"),
])
def test_corrupt_files_raise_named_errors(tmp_path, case, match):
    path = tmp_path / f"{case}.safetensors"
    ok = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    if case == "short":
        path.write_bytes(b"\x01\x00")
    elif case == "length":
        path.write_bytes(struct.pack("<Q", 10**6) + b"{}")
    elif case == "json":
        _write_raw(path, b"{not json", b"\0" * 8)
    elif case == "dtype":
        _write_raw(path, {"x": {**ok, "dtype": "C64"}}, b"\0" * 8)
    elif case == "offsets":
        _write_raw(path, {"x": {**ok, "data_offsets": [0, 16]}}, b"\0" * 8)
    elif case == "size":
        _write_raw(path, {"x": {**ok, "shape": [3]}}, b"\0" * 8)
    else:
        _write_raw(path, {"x": {"dtype": "F32"}}, b"\0" * 8)
    with pytest.raises(SafetensorsError, match=match):
        SafetensorsFile(path)


def test_metadata_is_skipped(tmp_path):
    path = tmp_path / "meta.safetensors"
    st_numpy.save_file({"x": np.ones(2, np.float32)}, str(path),
                       metadata={"modelspec": "sdxl"})
    with SafetensorsFile(path) as f:
        assert list(f) == ["x"]
