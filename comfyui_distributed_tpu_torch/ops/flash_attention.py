"""Attention kernels for Hopper, their plain PyTorch versions, and the
loader that builds them.

Counterpart of ``comfyui_distributed_tpu/ops/flash_attention.py``. The
three Pallas kernels there map onto three CUDA kernels in
``csrc/flash_attention.cu`` (TMA loads through mbarrier rings, ``wgmma``
products, warp-specialised producer and consumers):

- ``fused_qkv_attention`` (``_flash_kernel_fused``): self-attention from
  the block input ``x`` and the three projection weights, as two launches:
  the projection GEMM writes q/k/v once as ``[B, N, H·D]`` bf16 buffers,
  then an attention kernel reads them in place. The TPU kernel projected
  each head's K/V again for every q block, which bought it a way around
  XLA's custom-call boundary; eager PyTorch on the card has no such
  boundary, and the recompute was 4.4× the work the function needs. q/k/v
  of a level-2 SDXL site are 31.5 MB, which the card's 50 MB L2 largely
  holds between the two launches.
- ``flash_attention(layout="packed")`` (``_flash_kernel_packed``):
  attention over q/k/v in the projection's own ``[B, N, H·D]`` layout
  (SDXL's cross-attention over 77 text tokens).
- ``flash_attention(layout="bh")`` (``_flash_kernel``): the same with
  each (batch, head) pair addressed through its own strides, so any
  ``[B, N, H, D]`` view with unit stride along D is read in place (FLUX's
  joint attention, whose H·D = 3072 the packed layout does not take, and
  every SD 1.5 site; ``ops/attention.py`` chooses).

Every attention launch goes by key count, whatever the layout or the
caller: at most ``SHORT_KV_MAX_KEYS`` (128; 80 at D = 160) keys take the
short-key kernel, more the streamed core. Attention over 77 keys is bound by bytes
(reading q, writing out) and, at these sizes, by latency: the short-key
kernel is persistent, keeps each head's K/V resident in shared memory
while it streams that head's q tiles, sizes its key tile to the keys (80
for 77), takes a one-pass softmax and writes its output through TMA
stores that overlap the next tile. The streamed core (K/V tiles of 128
keys, online softmax) is bound by tensor-core operations at
self-attention lengths, the projection GEMM by operations. ``PERF.md``
holds their times against the bound at the shapes of the main paths.

Each wrapper runs its kernel's plain version for a tensor on the CPU and
launches the kernel for a tensor on a CUDA device; anything else raises.
There is no fallback from a CUDA tensor to the plain version. Weights use
the ``nn.Linear`` layout ``[H·D, C]`` (the transpose of the JAX
function's ``[C, H·D]``); activations keep the JAX layouts.
``LAUNCHES`` counts launches per wrapper (one per TPU kernel),
``CUDA_LAUNCHES`` per CUDA kernel.

Head widths: the attention kernels take D in ``HEAD_DIMS`` (40, 80 and
160 are SD 1.5's 8 heads at 320, 640 and 1280 channels). A row is read as
``padded_width(D)`` columns (whole 64-column boxes) in shared memory
only: the tensor maps carry the true D, so TMA fills the padding with
zeros and clips the stores at D, and the 1/√D scale comes from the true D.
At D = 160 the streamed core takes 64-key tiles and the short-key kernel
at most 80 keys (``core_key_tile``, ``short_kv_max_keys``), for shared
memory. The fused tier and the packed layout stay at D = 64 and 128.

The library is compiled with ``nvcc`` at first use into
``build/torch_kernels/`` at the repository root and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e30      # large-but-finite: -inf breaks the running max
BLOCK_Q = 128        # q rows per CTA of the core
BLOCK_K = 128        # keys per K/V tile of the core
SHORT_KV_MAX_KEYS = 128          # at most this many keys: the short-key kernel
SHORT_KV_TILES = (80, 128)       # its key tiles (80 holds 77 text tokens)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (40, 64, 80, 128, 160)   # the attention kernels
PACKED_HEAD_DIMS = (64, 128)         # the fused tier and the packed layout
BOX = 64             # columns of a TMA box: a row is read as whole boxes
STRIDE_MULTIPLE = 8  # elements: TMA takes strides in multiples of 16 bytes

# launches per wrapper (one per TPU kernel it replaces), counted where each
# kernel is launched (fused_qkv_attention counts once per call: projection
# and core together)
LAUNCHES = {"fused_qkv_attention": 0, "flash_attention_packed": 0,
            "flash_attention_bh": 0}
# launches per CUDA kernel of csrc/flash_attention.cu, counted where each
# is launched: which kernel each wrapper call took
CUDA_LAUNCHES = {"qkv_projection": 0, "flash_attention_core": 0,
                 "short_kv_attention": 0}
# several threads launch (the stage pools' encode workers run the text
# encoder while the denoise worker runs the UNet): a bare `+= 1` is a
# read and a write, and a lost increment would miscount a run
_COUNT_LOCK = threading.Lock()


def _count(counts: dict, name: str) -> None:
    with _COUNT_LOCK:
        counts[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, CUDA_LAUNCHES):
            for name in counts:
                counts[name] = 0


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel source."""


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a launch, or a tensor map could not be
    encoded."""


def find_nvcc() -> Optional[str]:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


class KernelLibrary:
    """The compiled kernel library: built once per source content, loaded
    once per process. ``build_log`` keeps nvcc's ``-Xptxas -v`` report of
    the build this process made (empty when an existing build was
    loaded)."""

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR,
                 nvcc: Optional[str] = None):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.nvcc = nvcc
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return self.build_dir / f"libcdt_attention_{digest[:16]}.so"

    def build(self) -> Path:
        out = self.path()
        if out.is_file():
            return out
        nvcc = self.nvcc or find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
                "and PATH): the CUDA kernels cannot be built")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except OSError as e:
            raise KernelBuildError(f"cannot run {nvcc}: {e}") from e
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0 or not tmp.is_file():
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{self.build_log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(self.build_log)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                p, i, ll, f = (ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_float)
                for attention in (lib.cdt_flash_attention,
                                  lib.cdt_short_kv_attention):
                    attention.argtypes = [p, p, p, p, i, i, i, i, i,
                                          *([ll] * 12), f, p]
                    attention.restype = i
                lib.cdt_short_kv_layout.argtypes = [i, i, p]
                lib.cdt_short_kv_layout.restype = i
                lib.cdt_qkv_projection.argtypes = [
                    p, p, p, p, p, i, i, i, p]
                lib.cdt_qkv_projection.restype = i
                lib.cdt_error_string.argtypes = [i]
                lib.cdt_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def short_kv_layout(self, head_dim: int, nk: int) -> tuple[int, int]:
        """The short-key kernel that ``nk`` keys select at ``head_dim``:
        its dynamic shared memory in bytes and its number of Q stages."""
        stages = ctypes.c_int()
        smem = self.load().cdt_short_kv_layout(head_dim, nk,
                                               ctypes.byref(stages))
        return smem, stages.value

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.load().cdt_error_string(code).decode()
            raise KernelLaunchError(f"{what}: CUDA error {code} ({msg})")


KERNELS = KernelLibrary()


# --- plain versions ----------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Exact attention over ``[B, N, H, D]`` in fp32: softmax(q·kᵀ/√D)·v,
    the 1/√D scale applied to the fp32 logits. Returns ``q.dtype``."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (D ** -0.5)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x · wᵀ`` accumulated in fp32 and rounded to the operand dtype —
    the projection epilogue of the fused tier (``w`` in nn.Linear
    layout)."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def qkv_projection_plain(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                         wv: torch.Tensor) -> torch.Tensor:
    """The three projections of ``x`` ``[B, N, C]``: ``[3, B, N, H·D]``."""
    return torch.stack([project(x, w) for w in (wq, wk, wv)])


def fused_qkv_attention_plain(x: torch.Tensor, wq: torch.Tensor,
                              wk: torch.Tensor, wv: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Projection then exact attention; ``[B, N, C]`` → ``[B, N, H, D]``."""
    B, N, _ = x.shape
    D = wq.shape[0] // num_heads

    def heads(w):
        return project(x, w).reshape(B, N, num_heads, D)

    return flash_attention_plain(heads(wq), heads(wk), heads(wv))


def padded_width(head_dim: int) -> int:
    """The columns a row of ``head_dim`` takes in the kernels' shared
    memory: whole 64-column boxes."""
    return -(-head_dim // BOX) * BOX


def core_key_tile(head_dim: int) -> int:
    """The streamed core's key tile: 128 keys, 64 past two boxes a row
    (D = 160), where two 128-key K/V stages beside the Q tile do not fit
    in shared memory."""
    return BLOCK_K if padded_width(head_dim) <= 2 * BOX else BLOCK_K // 2


def short_kv_max_keys(head_dim: int) -> int:
    """The most keys the short-key kernel takes at ``head_dim``: 128, or
    80 past two boxes a row (its 128-key tile does not fit beside two Q
    stages and the output tile)."""
    return (SHORT_KV_MAX_KEYS if padded_width(head_dim) <= 2 * BOX
            else SHORT_KV_TILES[0])


def _pad_head(t: torch.Tensor) -> torch.Tensor:
    """``[.., D]`` zero-padded to ``padded_width(D)``, as TMA fills a
    box past the tensor's D."""
    D = t.shape[-1]
    return torch.nn.functional.pad(t, (0, padded_width(D) - D))


def flash_attention_emulated(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, block_q: int = BLOCK_Q,
                             block_k: Optional[int] = None) -> torch.Tensor:
    """The kernels' streamed schedule in plain ops over ``[B·H, N, D]``
    (the counterpart of the JAX ``_flash_emulated``): rows zero-padded to
    ``padded_width(D)``, K tiles of ``block_k`` keys (default: the
    core's, ``core_key_tile``), NEG_INF tail masking, fp32 running
    max/denominator/accumulator, probabilities rounded to the operand
    dtype before P·V, rows with a zero denominator written as 0, the
    padding columns dropped. The scale is the true D's."""
    BH, Nq, D = q.shape
    Nk = k.shape[1]
    scale = D ** -0.5
    if block_k is None:
        block_k = core_key_tile(D)
    q, k, v = _pad_head(q), _pad_head(k), _pad_head(v)
    DP = q.shape[-1]
    out = torch.empty_like(q)
    for q0 in range(0, Nq, block_q):
        qb = q[:, q0:q0 + block_q]
        m = torch.full((BH, qb.shape[1], 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((BH, qb.shape[1], DP), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Nk, block_k):
            kb = k[:, k0:k0 + block_k].float()
            vb = v[:, k0:k0 + block_k]
            s = torch.matmul(qb.float(), kb.transpose(1, 2)) * scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, q0:q0 + block_q] = (acc / l).to(q.dtype)
    return out[..., :D]


def short_kv_tile(nk: int, head_dim: int = 64) -> int:
    """The short-key kernel's key tile for ``nk`` keys at ``head_dim``."""
    most = short_kv_max_keys(head_dim)
    for width in SHORT_KV_TILES:
        if 1 <= nk <= min(width, most):
            return width
    raise ValueError(f"the short-key kernel takes 1 to {most} keys at "
                     f"D={head_dim}, got {nk}")


def short_kv_attention_emulated(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """The short-key kernel's schedule in plain ops over ``[B·H, N, D]``:
    rows zero-padded to ``padded_width(D)``, keys zero-padded to its key
    tile (``short_kv_tile``), keys at or past ``Nk`` set to NEG_INF, a
    one-pass softmax in fp32 (row max, exponentials, sum: no running
    statistics), probabilities rounded to the operand dtype before P·V,
    rows with a zero denominator written as 0, the padding columns
    dropped. The scale is the true D's."""
    D = q.shape[-1]
    Nk = k.shape[1]
    pad = short_kv_tile(Nk, D) - Nk
    kp = torch.nn.functional.pad(_pad_head(k), (0, 0, 0, pad)).float()
    vp = torch.nn.functional.pad(_pad_head(v), (0, 0, 0, pad))
    s = torch.matmul(_pad_head(q).float(), kp.transpose(1, 2)) * D ** -0.5
    keys = torch.arange(s.shape[-1], device=q.device)
    s = s.masked_fill(keys >= Nk, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vp.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)[..., :D]


def fused_qkv_attention_emulated(x: torch.Tensor, wq: torch.Tensor,
                                 wk: torch.Tensor, wv: torch.Tensor,
                                 num_heads: int, block_q: int = BLOCK_Q,
                                 block_k: Optional[int] = None) -> torch.Tensor:
    """Fused tier's schedule in plain ops (counterpart of the JAX
    ``_fused_emulated``): projections rounded to the operand dtype, then
    the streamed schedule per head."""
    B, N, _ = x.shape
    D = wq.shape[0] // num_heads

    def to_bh(w):
        return (project(x, w).reshape(B, N, num_heads, D)
                .transpose(1, 2).reshape(B * num_heads, N, D))

    out = flash_attention_emulated(to_bh(wq), to_bh(wk), to_bh(wv),
                                   block_q, block_k)
    return out.reshape(B, num_heads, N, D).transpose(1, 2)


# --- wrappers ----------------------------------------------------------------


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on anything
    else or on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"attention kernels take tensors on one CUDA device (or the CPU "
            f"for the plain version); got {sorted(str(t.device) for t in tensors)}")
    return True


def _check_kernel_operand(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def core_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, row) strides in elements of a ``[B, N, H, D]`` view:
    the addressing of the core's tensor maps ``{D, rows, heads, batch}``
    (D has unit stride). A dimension of size 1 is never stepped, so its
    stride is replaced by ``STRIDE_MULTIPLE``, which TMA always takes."""
    B, N, H, _ = t.shape
    bs, rs, hs, _ = t.stride()
    return (bs if B > 1 else STRIDE_MULTIPLE, hs if H > 1 else STRIDE_MULTIPLE,
            rs if N > 1 else STRIDE_MULTIPLE)


def _check_projection(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                      wv: torch.Tensor) -> None:
    C = x.shape[-1]
    HD = wq.shape[0]
    if any(tuple(w.shape) != (HD, C) for w in (wq, wk, wv)):
        raise ValueError(
            f"qkv projection needs three [H·D, C] weights with C={C}; got "
            f"{tuple(wq.shape)}, {tuple(wk.shape)}, {tuple(wv.shape)}")


def _launch_projection(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                       wv: torch.Tensor) -> torch.Tensor:
    """K1's first launch: ``[3, B, N, H·D]`` from the projection GEMM."""
    B, N, C = x.shape
    HD = wq.shape[0]
    if C % STRIDE_MULTIPLE or HD % STRIDE_MULTIPLE:
        raise ValueError(f"projection kernel takes C and H·D in multiples of "
                         f"{STRIDE_MULTIPLE}; got C={C}, H·D={HD}")
    for name, t in (("x", x), ("wq", wq), ("wk", wk), ("wv", wv)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_kernel_operand(name, t)
    lib = KERNELS.load()
    out = torch.empty((3, B, N, HD), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.cdt_qkv_projection(
            x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            out.data_ptr(), B * N, C, HD, _stream(x))
    KERNELS.check(rc, "qkv_projection")
    _count(CUDA_LAUNCHES, "qkv_projection")
    return out


def _launch_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 what: str) -> torch.Tensor:
    """Attention over ``[B, N, H, D]`` views with unit stride along D;
    returns ``[B, Nq, H, D]`` (contiguous). At most
    ``short_kv_max_keys(D)`` keys take the short-key kernel (K/V
    resident, q tiles streamed), more the streamed core; both read the
    same strides."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if Nk == 0:
        raise ValueError(f"{what}: the kernel needs at least one key")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_kernel_operand(name, t)
        s = core_strides(t)
        if (t.stride(3) != 1 or s[0] % STRIDE_MULTIPLE or s[1] % STRIDE_MULTIPLE
                or s[2] % STRIDE_MULTIPLE):
            raise ValueError(
                f"{name}: rows must be contiguous with strides a multiple of "
                f"{STRIDE_MULTIPLE} elements; got strides {t.stride()}")
        strides += s
    lib = KERNELS.load()
    short = Nk <= short_kv_max_keys(D)
    entry = lib.cdt_short_kv_attention if short else lib.cdt_flash_attention
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, H, Nq, Nk, D, *strides, D ** -0.5, _stream(q))
    KERNELS.check(rc, what)
    _count(CUDA_LAUNCHES,
           "short_kv_attention" if short else "flash_attention_core")
    return out


def qkv_projection(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor) -> torch.Tensor:
    """``x`` ``[B, N, C]`` times each bias-free ``[H·D, C]`` weight:
    ``[3, B, N, H·D]``, fp32 accumulation rounded to the operand dtype.
    The first launch of ``fused_qkv_attention`` (which counts it in
    ``LAUNCHES``); a direct call counts in ``CUDA_LAUNCHES`` only."""
    _check_projection(x, wq, wk, wv)
    if not _on_cuda(x, wq, wk, wv):
        return qkv_projection_plain(x, wq, wk, wv)
    return _launch_projection(x, wq, wk, wv)


def fused_qkv_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                        wv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention from ``x`` ``[B, N, C]`` and bias-free projection
    weights ``[H·D, C]``; returns ``[B, N, H, D]``."""
    B, N, C = x.shape
    _check_projection(x, wq, wk, wv)
    HD = wq.shape[0]
    if HD % num_heads:
        raise ValueError(f"width {HD} not divisible by num_heads={num_heads}")
    D = HD // num_heads
    if not _on_cuda(x, wq, wk, wv):
        return fused_qkv_attention_plain(x, wq, wk, wv, num_heads)
    if D not in PACKED_HEAD_DIMS:
        raise ValueError(f"fused kernel takes D in {PACKED_HEAD_DIMS}; "
                         f"got D={D}")
    q, k, v = _launch_projection(x, wq, wk, wv).view(3, B, N, num_heads, D)
    out = _launch_core(q, k, v, "fused_qkv_attention")
    _count(LAUNCHES, "fused_qkv_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    layout: str = "packed") -> torch.Tensor:
    """Exact attention over ``[B, N, H, D]`` (q ``[B, Nq, H, D]``, k/v
    ``[B, Nk, H, D]``). ``layout="packed"`` takes the ``[B, N, H·D]`` rows
    with each row's heads side by side; ``"bh"`` takes any per-head
    strides (one attention problem per batch and head). Both read the
    operands in place and return ``[B, Nq, H, D]``."""
    if layout not in ("packed", "bh"):
        raise ValueError(f"layout must be 'packed' or 'bh', got {layout!r}")
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    if tuple(k.shape) != (B, Nk, H, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not _on_cuda(q, k, v):
        return flash_attention_plain(q, k, v)
    if layout == "packed":
        if D not in PACKED_HEAD_DIMS:
            raise ValueError(f"packed layout takes head_dim in "
                             f"{PACKED_HEAD_DIMS}, got {D}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1 or t.stride(2) != D:
                raise ValueError(f"{name}: packed layout needs each row's heads "
                                 f"side by side; got strides {t.stride()}")
    counter = f"flash_attention_{layout}"
    out = _launch_core(q, k, v, counter)
    _count(LAUNCHES, counter)
    return out
