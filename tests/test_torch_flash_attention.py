"""The port's attention kernels (``comfyui_distributed_tpu_torch.ops``)
against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode. Inputs come from a numpy
seed and reach both sides as numpy. fp32 throughout, at the repo's kernel
tolerance (2e-5, as ``tests/test_flash_attention.py``). The CUDA kernels
themselves are tested on a card by ``tests/test_torch_cuda.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.ops import flash_attention as jfa
from comfyui_distributed_tpu_torch.ops import attention as tattn
from comfyui_distributed_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5


def _qkv(seed, B, Nq, Nk, H, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Nq, H, D), (B, Nk, H, D), (B, Nk, H, D)))


def _fused_inputs(seed, B, N, C, H, D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    ws = [(rng.standard_normal((C, H * D)) * C ** -0.5).astype(np.float32)
          for _ in range(3)]
    return x, ws


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("layout", ["packed", "bh"])
@pytest.mark.parametrize("B,Nq,Nk,H,D", [
    (1, 100, 77, 2, 64),       # ragged q, cross-attention context length
    (2, 64, 77, 1, 128),       # FLUX head width
    (1, 130, 300, 2, 64),      # K spans several kernel tiles
    (2, 100, 128, 2, 64),      # the short-key kernel's widest key tile
])
def test_flash_attention_matches_pallas(layout, B, Nq, Nk, H, D):
    q, k, v = _qkv(0, B, Nq, Nk, H, D)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), layout=layout,
                                         interpret=True))
    out = tfa.flash_attention(_t(q), _t(k), _t(v), layout=layout)
    assert out.shape == (B, Nq, H, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,N,C,H,D", [
    (1, 100, 96, 2, 64),       # ragged N, C not a multiple of the chunk
    (2, 77, 64, 1, 128),
])
def test_fused_qkv_attention_matches_pallas(B, N, C, H, D):
    x, (wq, wk, wv) = _fused_inputs(1, B, N, C, H, D)
    ref = np.asarray(jfa.fused_qkv_attention(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv),
        H, interpret=True))
    # the port takes weights in nn.Linear layout [H·D, C]
    out = tfa.fused_qkv_attention(_t(x), _t(wq.T), _t(wk.T), _t(wv.T), H)
    assert out.shape == (B, N, H, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("block_k", [32, 64, 128])
def test_streamed_emulation_matches_jax_emulation(block_k):
    """The port's streamed schedule and the JAX ``_flash_emulated``: the
    same K tiling, tail masking and fp32 running statistics."""
    q, k, v = _qkv(2, 1, 100, 77, 2, 64)

    def to_bh(a):
        return a.transpose(0, 2, 1, 3).reshape(2, a.shape[1], 64)

    ref = np.asarray(jfa._flash_emulated(
        jnp.asarray(to_bh(q)), jnp.asarray(to_bh(k)), jnp.asarray(to_bh(v)),
        block_q=64, block_k=block_k))
    out = tfa.flash_attention_emulated(_t(to_bh(q)), _t(to_bh(k)),
                                       _t(to_bh(v)), 64, block_k)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_fused_emulation_matches_jax_emulation():
    """Also at the CUDA core's 128-key tile: 150 tokens make a full tile
    and a 22-key tail."""
    for N, block_k in ((90, 64), (150, 128)):
        x, (wq, wk, wv) = _fused_inputs(3, 2, N, 64, 2, 64)
        ref = np.asarray(jfa._fused_emulated(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wk),
            jnp.asarray(wv), 2, block_q=64, block_k=block_k))
        out = tfa.fused_qkv_attention_emulated(_t(x), _t(wq.T), _t(wk.T),
                                               _t(wv.T), 2, 64, block_k)
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("nk", [1, 17, 77, 128])
def test_short_kv_emulation_matches_jax_emulation(nk):
    """The short-key kernel's one-tile schedule (keys padded to its key
    tile, NEG_INF masks, one-pass softmax) against the JAX
    ``_flash_emulated`` with one K block holding every key."""
    q, k, v = _qkv(8, 2, 130, nk, 2, 64)

    def to_bh(a):
        return a.transpose(0, 2, 1, 3).reshape(4, a.shape[1], 64)

    ref = np.asarray(jfa._flash_emulated(
        jnp.asarray(to_bh(q)), jnp.asarray(to_bh(k)), jnp.asarray(to_bh(v)),
        block_q=64, block_k=tfa.short_kv_tile(nk)))
    out = tfa.short_kv_attention_emulated(_t(to_bh(q)), _t(to_bh(k)),
                                          _t(to_bh(v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_short_kv_emulation_rounds_p_to_the_operand_dtype():
    """In bf16 the probabilities are rounded before P·V, as the streamed
    schedule rounds them: one tile of 77 keys gives the same numbers."""
    q, k, v = (_t(a[0].transpose(1, 0, 2)).to(torch.bfloat16)
               for a in _qkv(9, 1, 70, 77, 2, 64))
    assert torch.equal(tfa.short_kv_attention_emulated(q, k, v),
                       tfa.flash_attention_emulated(q, k, v))


def test_short_kv_tiles():
    assert [tfa.short_kv_tile(n) for n in (1, 16, 17, 77, 80, 81,
                                           128)] == [80] * 5 + [128] * 2
    assert tfa.SHORT_KV_TILES[-1] == tfa.SHORT_KV_MAX_KEYS == tfa.BLOCK_K
    for nk in (0, 129):
        with pytest.raises(ValueError, match="1 to 128 keys"):
            tfa.short_kv_tile(nk)


def test_emulation_defaults_follow_the_kernel_tiles():
    q, k, v = (_t(a[0].transpose(1, 0, 2)) for a in _qkv(5, 1, 200, 150, 2, 64))
    assert torch.equal(tfa.flash_attention_emulated(q, k, v),
                       tfa.flash_attention_emulated(q, k, v, tfa.BLOCK_Q,
                                                    tfa.BLOCK_K))
    assert (tfa.BLOCK_Q, tfa.BLOCK_K) == (128, 128)


@pytest.mark.parametrize("B,N,C,HD", [(2, 77, 192, 192), (1, 130, 96, 256)])
def test_qkv_projection_plain_matches_jax_projection(B, N, C, HD):
    """The projection the CUDA GEMM is held against, and the JAX fused
    tier's projection numerics: fp32 accumulation cast back to the operand
    dtype (fp32 here, at the kernel tolerance)."""
    x, ws = _fused_inputs(6, B, N, C, 1, HD)
    ref = np.stack([np.asarray(jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jnp.float32)) for w in ws])
    out = tfa.qkv_projection_plain(_t(x), *(_t(w.T) for w in ws))
    assert out.shape == (3, B, N, HD)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    cpu = tfa.qkv_projection(_t(x), *(_t(w.T) for w in ws))
    assert torch.equal(cpu, out)


def test_qkv_projection_plain_rounds_once_in_bf16():
    """In bf16 both sides accumulate in fp32 and round once: they agree to
    one bf16 rounding step (2^-8 relative; the fp32 sums are taken in
    different orders)."""
    x, ws = _fused_inputs(7, 1, 40, 128, 2, 64)
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    ref = np.stack([np.asarray(jax.lax.dot_general(
        xb, jnp.asarray(w, dtype=jnp.bfloat16), (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jnp.bfloat16),
        dtype=np.float32) for w in ws])
    out = tfa.qkv_projection_plain(
        _t(x).to(torch.bfloat16),
        *(_t(w.T).to(torch.bfloat16) for w in ws))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -8,
                               atol=1e-6)


def _strided_operand(layout, B, N=5, H=3, D=8):
    """A [B, N, H, D] view in the memory order of one of the port's
    call sites."""
    n = B * N * H * D
    if layout == "packed":            # projection output / cross-attention
        return torch.arange(n).reshape(B, N, H * D).view(B, N, H, D)
    if layout == "bh":                # heads outermost, [B·H, N, D] order
        return torch.arange(n).reshape(B, H, N, D).transpose(1, 2)
    # FLUX's single-block v: one slice of a [B, N, 3, H, D] projection
    return torch.arange(3 * n).reshape(B, N, 3, H, D).unbind(2)[2]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("layout", ["packed", "bh", "qkv_slice"])
def test_core_strides_address_the_same_elements(layout, B):
    """The (batch, head, row) strides the tensor maps are built from
    address exactly the elements torch indexing gives."""
    t = _strided_operand(layout, B)
    B_, N, H, D = t.shape
    bs, hs, rs = tfa.core_strides(t)
    seen = t.as_strided((B_, H, N, D), (bs, hs, rs, 1), t.storage_offset())
    assert torch.equal(seen, t.permute(0, 2, 1, 3))
    assert all(s % tfa.STRIDE_MULTIPLE == 0 for s in (bs, hs, rs))


def test_core_strides_of_size_one_dimensions_are_legal():
    """A dimension of size 1 is never stepped; its stride is replaced by
    one TMA takes (torch may report any stride there)."""
    t = torch.zeros(1, 1, 4, 8).as_strided((1, 1, 4, 8), (3, 5, 8, 1))
    assert tfa.core_strides(t) == (tfa.STRIDE_MULTIPLE, 8, tfa.STRIDE_MULTIPLE)


class _FakeLibrary:
    """Stands in for the compiled library: records each C call."""

    def __init__(self):
        self.calls = []

    def cdt_qkv_projection(self, *args):
        self.calls.append(("projection", args))
        return 0

    def cdt_flash_attention(self, *args):
        self.calls.append(("attention", args))
        return 0

    def cdt_short_kv_attention(self, *args):
        self.calls.append(("short_kv", args))
        return 0


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA path of the wrappers on CPU tensors, down to the C call."""
    lib = _FakeLibrary()
    monkeypatch.setattr(tfa, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(tfa.KERNELS, "load", lambda: lib)
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    monkeypatch.setattr(tfa.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return lib


def test_fused_wrapper_projects_once_then_reads_packed_rows(fake_cuda):
    """K1 is two launches: the GEMM writes [3, B, N, H·D], then the core
    reads q, k and v from it with packed (batch, head, row) strides."""
    B, N, C, H, D = 2, 100, 192, 3, 64
    x = torch.zeros(B, N, C, dtype=torch.bfloat16)
    w = torch.zeros(H * D, C, dtype=torch.bfloat16)
    before = dict(tfa.LAUNCHES)
    out = tfa.fused_qkv_attention(x, w, w.clone(), w.clone(), H)
    assert out.shape == (B, N, H, D) and out.is_contiguous()
    assert tfa.LAUNCHES["fused_qkv_attention"] == before["fused_qkv_attention"] + 1
    (kind1, proj), (kind2, attn) = fake_cuda.calls
    # 100 keys: the core launch takes the short-key kernel
    assert (kind1, kind2) == ("projection", "short_kv")
    assert proj[0] == x.data_ptr() and proj[5:8] == (B * N, C, H * D)
    qkv = proj[4]
    step = B * N * H * D * 2                       # bytes per q/k/v buffer
    assert attn[:3] == (qkv, qkv + step, qkv + 2 * step)
    assert attn[3] == out.data_ptr()
    assert attn[4:9] == (B, H, N, N, D)
    packed = (N * H * D, D, H * D)
    assert attn[9:21] == packed * 4
    assert attn[21] == pytest.approx(D ** -0.5)


@pytest.mark.parametrize("layout", ["packed", "bh"])
def test_core_wrapper_passes_operands_in_place(fake_cuda, layout):
    """The core reads each operand where it lies: FLUX's single-block v
    (a slice of the [B, N, 3, H, D] projection) is not copied."""
    B, N, H, D = 2, 70, 3, 64
    qkv = torch.zeros(B, N, 3, H, D, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = tfa.flash_attention(q, k, v, layout=layout)
    ((_, args),) = fake_cuda.calls
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[9:18] == (N * 3 * H * D, D, 3 * H * D) * 3
    assert args[18:21] == (N * H * D, D, H * D)
    assert out.shape == (B, N, H, D)
    assert tfa.LAUNCHES[f"flash_attention_{layout}"] >= 1


@pytest.mark.parametrize("layout", ["packed", "bh"])
@pytest.mark.parametrize("nk,entry", [(1, "short_kv"), (77, "short_kv"),
                                      (128, "short_kv"), (129, "attention")])
def test_core_wrapper_chooses_the_kernel_by_key_count(fake_cuda, layout, nk,
                                                      entry):
    """At most 128 keys take the short-key kernel, more the streamed core,
    in either layout, with the same arguments: operands in place, their
    (batch, head, row) strides, the 1/√D scale. Each launch counts once
    for its wrapper and once for the CUDA kernel it took."""
    B, Nq, H, D = 2, 70, 3, 64
    q = torch.zeros(B, Nq, H, D, dtype=torch.bfloat16)
    kv = torch.zeros(B, nk, 2, H, D, dtype=torch.bfloat16)
    k, v = kv.unbind(2)
    before = dict(tfa.LAUNCHES)
    cuda_before = dict(tfa.CUDA_LAUNCHES)
    out = tfa.flash_attention(q, k, v, layout=layout)
    ((kind, args),) = fake_cuda.calls
    assert kind == entry
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert args[4:9] == (B, H, Nq, nk, D)
    assert args[9:12] == (Nq * H * D, D, H * D)
    row = 2 * H * D if nk > 1 else tfa.STRIDE_MULTIPLE   # never stepped
    assert args[12:18] == (nk * 2 * H * D, D, row) * 2
    assert args[18:21] == (Nq * H * D, D, H * D)
    assert args[21] == pytest.approx(D ** -0.5)
    key = f"flash_attention_{layout}"
    assert tfa.LAUNCHES[key] == before[key] + 1
    cuda = "short_kv_attention" if entry == "short_kv" else "flash_attention_core"
    assert tfa.CUDA_LAUNCHES == {**cuda_before, cuda: cuda_before[cuda] + 1}


def test_reset_launches_clears_both_counters(fake_cuda):
    x = torch.zeros(1, 200, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    tfa.fused_qkv_attention(x, w, w, w, 1)
    assert tfa.CUDA_LAUNCHES["qkv_projection"] >= 1
    assert tfa.CUDA_LAUNCHES["flash_attention_core"] >= 1
    tfa.reset_launches()
    assert set(tfa.LAUNCHES.values()) == set(tfa.CUDA_LAUNCHES.values()) == {0}


def test_core_wrapper_refuses_strides_tma_cannot_take(fake_cuda):
    q = torch.zeros(1, 16, 2, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_attention(q, q, q, layout="bh")
    k = torch.zeros(1, 0, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at least one key"):
        tfa.flash_attention(torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16),
                            k, k, layout="bh")
    assert fake_cuda.calls == []


def test_fully_masked_rows_write_zero():
    """A row whose every logit is NEG_INF has a zero denominator and
    writes 0, as the Pallas kernels do; a row of equal logits averages."""
    q = torch.zeros(1, 1, 8)
    k = torch.zeros(1, 0, 8)
    v = torch.zeros(1, 0, 8)
    assert torch.equal(tfa.flash_attention_emulated(q, k, v),
                       torch.zeros(1, 1, 8))
    v = torch.arange(16.0).reshape(1, 2, 8)
    out = tfa.flash_attention_emulated(q, torch.zeros(1, 2, 8), v)
    assert torch.allclose(out, v.mean(dim=1, keepdim=True))


def test_cpu_dispatch_takes_plain_versions():
    assert tattn.select_kernel(torch.device("cpu"), True, 10, 64) == "plain"
    assert tattn.select_kernel(torch.device("cpu"), False, 24, 128) == "plain"
    assert tattn.select_kernel(torch.device("cuda"), True, 10, 64) == "fused"
    assert tattn.select_kernel(torch.device("cuda"), False, 10, 64) == "packed"
    q, k, v = (_t(a) for a in _qkv(4, 1, 20, 9, 2, 64))
    before = dict(tfa.LAUNCHES)
    assert torch.equal(tattn.full_attention(q, k, v),
                       tfa.flash_attention_plain(q, k, v))
    assert tfa.LAUNCHES == before          # no kernel ran


@pytest.mark.parametrize("H,D,layout", [
    (10, 64, "packed"),        # SDXL cross-attention, level 1
    (20, 64, "packed"),        # SDXL cross-attention, level 2
    (24, 128, "bh"),           # FLUX joint attention: H·D = 3072 > 2048
    (16, 128, "packed"),       # H·D = 2048, the widest packed row
    (17, 128, "bh"),
    (3, 64, "bh"),             # H·D = 192, not a multiple of 128
    (4, 32, "bh"),             # D not a multiple of 64
])
def test_layout_choice_matches_jax_packed_legal(H, D, layout):
    """Sites over projected q/k/v take the packed kernel exactly where the
    JAX package's geometric rule allows the packed layout, the one-head
    kernel everywhere else."""
    assert jfa._packed_legal(H, D) == (layout == "packed")
    assert tattn.packed_legal(H, D) == (layout == "packed")
    assert tattn.select_kernel(torch.device("cuda"), False, H, D) == layout


def test_wrappers_reject_devices_without_a_kernel():
    q = torch.zeros(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(q, q, q)
    x = torch.zeros(1, 8, 64, device="meta")
    w = torch.zeros(64, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.fused_qkv_attention(x, w, w, w, 1)
    with pytest.raises(ValueError, match="no attention kernel"):
        tattn.select_kernel(torch.device("meta"), True, 1, 64)


@pytest.mark.parametrize("nvcc", ["missing", "/nonexistent/nvcc", "/bin/false"])
def test_cuda_path_build_failure_raises(nvcc, tmp_path, monkeypatch):
    """A CUDA-path call whose kernels cannot be built raises; it never
    falls back to the plain version."""
    lib = tfa.KernelLibrary(build_dir=tmp_path,
                            nvcc=None if nvcc == "missing" else nvcc)
    monkeypatch.setattr(tfa, "find_nvcc", lambda: None)
    monkeypatch.setattr(tfa, "KERNELS", lib)
    monkeypatch.setattr(tfa, "_on_cuda", lambda *tensors: True)
    x = torch.zeros(1, 16, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    q = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16)
    before = dict(tfa.LAUNCHES)
    with pytest.raises(tfa.KernelBuildError):
        tfa.fused_qkv_attention(x, w, w, w, 1)
    with pytest.raises(tfa.KernelBuildError):
        tfa.flash_attention(q, q, q, layout="packed")
    assert tfa.LAUNCHES == before


def test_kernel_operand_checks(monkeypatch):
    """On the CUDA path the wrapper refuses what the kernel cannot take
    before it loads anything."""
    monkeypatch.setattr(tfa, "_on_cuda", lambda *tensors: True)
    monkeypatch.setattr(tfa.KERNELS, "load", lambda: pytest.fail("loaded"))
    x = torch.zeros(1, 16, 64)
    w = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.fused_qkv_attention(x, w, w, w, 1)
    with pytest.raises(ValueError, match="head_dim"):
        q = torch.zeros(1, 16, 2, 32, dtype=torch.bfloat16)
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="side by side"):
        q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16).transpose(1, 2)
        tfa.flash_attention(q, q, q, layout="packed")


# --- head widths 40, 80 and 160 (SD 1.5's 8 heads) ---------------------------

SD15_WIDTHS = [40, 80, 160]


@pytest.mark.parametrize("D", SD15_WIDTHS)
@pytest.mark.parametrize("B,Nq,Nk,H", [
    (2, 300, 300, 2),          # self-attention over several key tiles
    (1, 100, 77, 3),           # cross-attention over 77 text tokens
    (2, 130, 129, 1),          # ragged: one key past a 128-key tile
    (1, 1, 1, 2),              # one row, one key
])
def test_new_widths_match_pallas_bh(D, B, Nq, Nk, H):
    """The one-head tier at SD 1.5's head widths against the JAX
    ``_flash_mha`` in interpret mode (the bh call every SD 1.5 site
    takes): the plain version, and the kernels' padded tilings."""
    q, k, v = _qkv(10, B, Nq, Nk, H, D)

    def to_bh(a):
        return a.transpose(0, 2, 1, 3).reshape(B * H, a.shape[1], D)

    ref = np.asarray(jfa._flash_mha(
        jnp.asarray(to_bh(q)), jnp.asarray(to_bh(k)), jnp.asarray(to_bh(v)),
        block_q=128, block_k=128, interpret=True))
    out = tfa.flash_attention(_t(q), _t(k), _t(v), layout="bh")
    assert out.shape == (B, Nq, H, D)
    np.testing.assert_allclose(to_bh(out.numpy()), ref, atol=TOL, rtol=TOL)
    tq, tk, tv = _t(to_bh(q)), _t(to_bh(k)), _t(to_bh(v))
    streamed = tfa.flash_attention_emulated(tq, tk, tv)
    assert streamed.shape == (B * H, Nq, D)
    np.testing.assert_allclose(streamed.numpy(), ref, atol=TOL, rtol=TOL)
    if Nk <= tfa.short_kv_max_keys(D):
        short = tfa.short_kv_attention_emulated(tq, tk, tv)
        np.testing.assert_allclose(short.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D", SD15_WIDTHS)
def test_padded_tilings_match_jax_emulation(D):
    """The streamed schedule at the core's key tile for D and the
    short-key schedule, each over rows zero-padded to whole 64-column
    boxes, against the JAX ``_flash_emulated`` over the true D: the
    padding adds nothing and the scale is the true D's."""
    q, k, v = _qkv(11, 1, 150, 200, 2, D)

    def to_bh(a):
        return a.transpose(0, 2, 1, 3).reshape(2, a.shape[1], D)

    ref = np.asarray(jfa._flash_emulated(
        jnp.asarray(to_bh(q)), jnp.asarray(to_bh(k)), jnp.asarray(to_bh(v)),
        block_q=128, block_k=tfa.core_key_tile(D)))
    out = tfa.flash_attention_emulated(_t(to_bh(q)), _t(to_bh(k)),
                                       _t(to_bh(v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    short_k, short_v = to_bh(k)[:, :77], to_bh(v)[:, :77]
    ref = np.asarray(jfa._flash_emulated(
        jnp.asarray(to_bh(q)), jnp.asarray(short_k), jnp.asarray(short_v),
        block_q=128, block_k=tfa.short_kv_tile(77, D)))
    out = tfa.short_kv_attention_emulated(_t(to_bh(q)), _t(short_k),
                                          _t(short_v))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_padded_widths_and_tiles():
    assert [tfa.padded_width(d) for d in (40, 64, 80, 128, 160)] == \
        [64, 64, 128, 128, 192]
    assert [tfa.core_key_tile(d) for d in (40, 64, 80, 128, 160)] == \
        [128, 128, 128, 128, 64]
    assert [tfa.short_kv_max_keys(d) for d in (40, 64, 80, 128, 160)] == \
        [128, 128, 128, 128, 80]
    assert tfa.short_kv_tile(81, 80) == 128
    with pytest.raises(ValueError, match="1 to 80 keys at D=160"):
        tfa.short_kv_tile(81, 160)
    assert tfa.HEAD_DIMS == (40, 64, 80, 128, 160)
    assert tfa.PACKED_HEAD_DIMS == (64, 128)


@pytest.mark.parametrize("D,nk,entry", [
    (40, 77, "short_kv"), (40, 129, "attention"), (80, 128, "short_kv"),
    (160, 77, "short_kv"), (160, 80, "short_kv"), (160, 81, "attention")])
def test_new_widths_go_by_key_count_with_the_true_scale(fake_cuda, D, nk,
                                                        entry):
    """The wrapper hands the kernels the true D and its 1/√D; at D = 160
    the short-key kernel takes at most 80 keys."""
    B, Nq, H = 2, 70, 8
    q = torch.zeros(B, Nq, H * D, dtype=torch.bfloat16).view(B, Nq, H, D)
    kv = torch.zeros(2, B, nk, H * D, dtype=torch.bfloat16)
    k, v = (t.view(B, nk, H, D) for t in kv)
    tfa.flash_attention(q, k, v, layout="bh")
    ((kind, args),) = fake_cuda.calls
    assert kind == entry
    assert args[4:9] == (B, H, Nq, nk, D)
    assert args[9:12] == (Nq * H * D, D, H * D)
    assert args[21] == pytest.approx(D ** -0.5)


def test_packed_and_fused_tiers_stay_at_64_and_128(fake_cuda):
    q = torch.zeros(1, 16, 8, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="packed layout takes head_dim"):
        tfa.flash_attention(q, q, q, layout="packed")
    x = torch.zeros(1, 16, 320, dtype=torch.bfloat16)
    w = torch.zeros(320, 320, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fused kernel takes D"):
        tfa.fused_qkv_attention(x, w, w, w, 8)
    q = torch.zeros(1, 16, 2, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim in"):
        tfa.flash_attention(q, q, q, layout="bh")
    assert fake_cuda.calls == []


# --- the tier predicate -------------------------------------------------------

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@settings(max_examples=300, deadline=None)
@given(C=st.integers(1, 4096), H=st.integers(1, 160),
       D=st.sampled_from([8, 16, 32, 40, 48, 64, 80, 96, 128, 160, 192, 256]))
def test_tier_predicate_matches_jax_geometry(C, H, D):
    """``fused_feasible`` is the JAX ``_fused_feasible`` without its VMEM
    budget (it returns blocks or None; the budget only shrinks blocks
    here, so None means the geometry failed), and ``select_kernel``
    sends a CUDA self-attention site to the fused tier only there, every
    other site by ``_packed_legal``."""
    jax_fused = jfa._fused_feasible(C, H, D, 128, 128, 2)
    geometric = (H * D % 128 == 0 and H <= 128 and D % 64 == 0
                 and C % 128 == 0)
    assert tattn.fused_feasible(C, H, D) == geometric
    if jax_fused is not None:
        assert geometric
    packed = jfa._packed_legal(H, D)
    assert tattn.packed_legal(H, D) == packed
    cuda = torch.device("cuda")
    kind = tattn.select_kernel(cuda, True, H, D, C)
    assert kind == ("fused" if geometric else "packed" if packed else "bh")
    assert tattn.select_kernel(cuda, False, H, D, C) == (
        "packed" if packed else "bh")


@pytest.mark.parametrize("C,H,D,kind", [
    (320, 8, 40, "bh"),        # SD 1.5, level 1
    (640, 8, 80, "bh"),        # SD 1.5, level 2
    (1280, 8, 160, "bh"),      # SD 1.5, level 3
    (640, 10, 64, "fused"),    # SDXL, level 2
    (1280, 20, 64, "fused"),   # SDXL, level 3
    (768, 12, 64, "fused"),    # the text encoder
    (32, 2, 16, "bh"),         # the tiny preset
])
def test_self_attention_sites_of_the_presets(C, H, D, kind):
    jax_fused = jfa._fused_feasible(C, H, D, 128, 128, 2) is not None
    assert tattn.fused_feasible(C, H, D) == (kind == "fused")
    if kind == "fused":
        assert jax_fused
    assert tattn.select_kernel(torch.device("cuda"), True, H, D, C) == kind


def test_unfusable_self_attention_projects_and_takes_full_attention(
        monkeypatch):
    """An SD 1.5 self-attention site projects q/k/v with its own Linears
    and calls ``full_attention`` (as the JAX ``Attention`` takes ``Dense``
    then ``full_attention``); a fusable one hands the weights over."""
    from comfyui_distributed_tpu_torch.models import layers

    calls = []
    monkeypatch.setattr(layers, "full_attention",
                        lambda q, k, v: calls.append(("full", q.shape)) or
                        tfa.flash_attention_plain(q, k, v))
    monkeypatch.setattr(layers, "self_attention",
                        lambda x, wq, wk, wv, h: calls.append(("fused", x.shape))
                        or tfa.fused_qkv_attention_plain(x, wq, wk, wv, h))
    x = torch.randn(1, 6, 320)
    attn = layers.Attention(320, 8, 40, torch.float32)
    out = attn(x)
    assert calls == [("full", (1, 6, 8, 40))]
    ref = tfa.flash_attention_plain(*(lin(x).view(1, 6, 8, 40) for lin in (
        attn.to_q, attn.to_k, attn.to_v)))
    assert torch.allclose(out, attn.to_out(ref.reshape(1, 6, 320)), atol=1e-6)
    calls.clear()
    layers.Attention(640, 10, 64, torch.float32)(torch.randn(1, 6, 640))
    assert calls == [("fused", (1, 6, 640))]
