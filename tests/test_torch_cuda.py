"""The port's CUDA kernels on a card, against their plain PyTorch versions
in bf16 (max-abs error ≤ 1e-2·max|plain|: bf16 in and out, fp32
accumulation in a different order), and the UNet's and the DiT's
attention sites going through them.

Every test here is marked ``cuda`` and skips without a card; the card's
presence is decided in a fixture. Run on the card with
``python -m pytest -m cuda tests/test_torch_*.py``. This file imports no
JAX, so it runs where only PyTorch is installed.
"""

from unittest import mock

import pytest
import torch

from comfyui_distributed_tpu_torch.models import dit, layers
from comfyui_distributed_tpu_torch.models.dit import DiT, DiTConfig
from comfyui_distributed_tpu_torch.models.layers import flax_init_
from comfyui_distributed_tpu_torch.models.unet import UNet2D, UNetConfig
from comfyui_distributed_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bf16(seed, *shape, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(
        torch.bfloat16)


def _close(out, ref, tol=1e-2):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.parametrize("layout", ["packed", "bh"])
@pytest.mark.parametrize("B,Nq,Nk,H,D", [(2, 200, 77, 3, 64),
                                         (1, 130, 300, 2, 128)])
def test_flash_kernel_matches_plain(cuda_device, layout, B, Nq, Nk, H, D):
    q = _bf16(0, B, Nq, H, D)
    k = _bf16(1, B, Nk, H, D)
    v = _bf16(2, B, Nk, H, D)
    key = f"flash_attention_{layout}"
    before = tfa.LAUNCHES[key]
    out = tfa.flash_attention(q, k, v, layout=layout)
    assert tfa.LAUNCHES[key] == before + 1
    _close(out, tfa.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("B,N,C,H,D", [(2, 200, 192, 3, 64),
                                       (1, 77, 256, 2, 128)])
def test_fused_kernel_matches_plain(cuda_device, B, N, C, H, D):
    x = _bf16(3, B, N, C)
    wq, wk, wv = (_bf16(4 + i, H * D, C, scale=C ** -0.5) for i in range(3))
    before = tfa.LAUNCHES["fused_qkv_attention"]
    out = tfa.fused_qkv_attention(x, wq, wk, wv, H)
    assert tfa.LAUNCHES["fused_qkv_attention"] == before + 1
    _close(out, tfa.fused_qkv_attention_plain(x, wq, wk, wv, H))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Nq", [1, 64, 4173])
@pytest.mark.parametrize("Nk", [1, 77, 128, 129])
@pytest.mark.parametrize("layout", ["packed", "bh"])
def test_flash_kernel_at_tile_edges(cuda_device, layout, Nk, Nq, D):
    """The core's 128-row q and 128-key tiles: a lone key, the 77-key
    cross-attention tile, one full tile and one key past it; one q row,
    half a q tile, and FLUX's 32·128 + 77 rows. Two batches, so the bh
    layout's per-head strides cross a batch."""
    q = _bf16(10, 2, Nq, 2, D)
    k = _bf16(11, 2, Nk, 2, D)
    v = _bf16(12, 2, Nk, 2, D)
    _close(tfa.flash_attention(q, k, v, layout=layout),
           tfa.flash_attention_plain(q, k, v))


def _poisoned_then_compared(layout, B, Nq, Nk, H, D, seed):
    """Run the kernel once at the shape on other inputs and drop the
    result, so that the compared call's ``torch.empty`` output reuses that
    block: a tile the schedule skipped then holds stale numbers."""
    q = _bf16(seed, B, Nq, H, D)
    k = _bf16(seed + 1, B, Nk, H, D)
    v = _bf16(seed + 2, B, Nk, H, D)
    poison = (_bf16(seed + 3, B, Nq, H, D, scale=4.0),
              _bf16(seed + 4, B, Nk, H, D), _bf16(seed + 5, B, Nk, H, D, scale=8.0))
    tfa.flash_attention(*poison, layout=layout)
    _close(tfa.flash_attention(q, k, v, layout=layout),
           tfa.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Nq", [1, 64, 128, 129, 4173])
@pytest.mark.parametrize("Nk", [1, 16, 17, 77, 80, 128])
@pytest.mark.parametrize("layout", ["packed", "bh"])
def test_short_kv_kernel_at_its_edges(cuda_device, layout, Nk, Nq, D, B):
    """The short-key kernel's key tiles (80, 128) at their edges, q
    tiles of 128 rows stored as two 64-row boxes, both layouts, one and
    two batches; each compared call follows a poisoning call."""
    before = tfa.CUDA_LAUNCHES["short_kv_attention"]
    _poisoned_then_compared(layout, B, Nq, Nk, 2, D, seed=30)
    assert tfa.CUDA_LAUNCHES["short_kv_attention"] == before + 2


@pytest.mark.parametrize("layout", ["packed", "bh"])
@pytest.mark.parametrize("B,Nq,Nk,H,D", [
    (1, 64, 77, 1, 64),        # one work item: fewer than the SMs
    (1, 1000, 77, 37, 64),     # 296 items: 3 a CTA on 132 SMs, the last 2
    (2, 4096, 77, 10, 64),     # SDXL cross-attention, level 2
    (2, 1024, 77, 20, 64),     # SDXL cross-attention, level 3
])
def test_short_kv_kernel_schedules(cuda_device, layout, B, Nq, Nk, H, D):
    _poisoned_then_compared(layout, B, Nq, Nk, H, D, seed=40)


def test_key_count_picks_the_cuda_kernel(cuda_device):
    q = _bf16(50, 1, 200, 2, 64)
    for nk, kernel in ((128, "short_kv_attention"), (129, "flash_attention_core")):
        k = _bf16(51, 1, nk, 2, 64)
        tfa.reset_launches()
        _close(tfa.flash_attention(q, k, k, layout="bh"),
               tfa.flash_attention_plain(q, k, k))
        assert tfa.CUDA_LAUNCHES == {"qkv_projection": 0,
                                     "flash_attention_core": 0,
                                     "short_kv_attention": 0, kernel: 1}


def test_flash_kernel_reads_strided_heads_in_place(cuda_device):
    """FLUX's single-block v is a slice of the [B, N, 3, H, D] projection:
    the one-head kernel reads it with its own row stride."""
    qkv = _bf16(13, 2, 300, 3, 3, 128)
    q, k, v = qkv.unbind(2)
    _close(tfa.flash_attention(q, k, v, layout="bh"),
           tfa.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("B,N,C,HD", [(1, 77, 192, 192), (2, 200, 192, 192),
                                      (1, 77, 768, 768), (2, 130, 256, 256),
                                      (1, 300, 1280, 1280)])
def test_projection_kernel_matches_plain(cuda_device, B, N, C, HD):
    """The GEMM of K1's first launch: 77 rows (the text encoder), C not a
    multiple of its 64-channel tile's ring depth, H·D = 192 (a 128-column
    tile that is half outside the weight)."""
    x = _bf16(14, B, N, C)
    wq, wk, wv = (_bf16(15 + i, HD, C, scale=C ** -0.5) for i in range(3))
    _close(tfa.qkv_projection(x, wq, wk, wv),
           tfa.qkv_projection_plain(x, wq, wk, wv))


def test_fused_kernel_at_text_encoder_edge(cuda_device):
    """M = 77 rows and C = 192 through both of K1's launches."""
    x = _bf16(18, 1, 77, 192)
    wq, wk, wv = (_bf16(19 + i, 192, 192, scale=192 ** -0.5) for i in range(3))
    _close(tfa.fused_qkv_attention(x, wq, wk, wv, 3),
           tfa.fused_qkv_attention_plain(x, wq, wk, wv, 3))


def test_kernel_refuses_fp32_on_card(cuda_device):
    q = torch.zeros(1, 16, 1, 64, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention(q, q, q)


def test_unet_attention_sites_take_the_kernels(cuda_device):
    """A small UNet with 64-wide heads on the card: every self-attention
    site launches the fused kernel, every cross-attention site the packed
    one, and the eps prediction agrees with the same UNet on the plain
    versions (5e-2·max|plain|: bf16 rounding compounds over the blocks)."""
    cfg = UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                     transformer_depth=(0, 1), context_dim=64, head_dim=64,
                     adm_in_channels=8)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    with torch.device("meta"):
        unet = UNet2D(cfg)
    unet = flax_init_(unet.to_empty(device=cuda_device), gen).eval()
    x = torch.randn(2, 16, 16, 4, generator=gen, device=cuda_device)
    t = torch.tensor([10.0, 500.0], device=cuda_device)
    ctx = torch.randn(2, 77, 64, generator=gen, device=cuda_device)
    y = torch.randn(2, 8, generator=gen, device=cuda_device)
    tfa.reset_launches()
    with torch.no_grad():
        eps = unet(x, t, ctx, y)
        sites = sum(1 for n, _ in unet.named_modules() if n.endswith("attn1"))
        assert tfa.LAUNCHES == {"fused_qkv_attention": sites,
                                "flash_attention_packed": sites,
                                "flash_attention_bh": 0}
        with mock.patch.object(layers, "self_attention",
                               tfa.fused_qkv_attention_plain), \
                mock.patch.object(layers, "full_attention",
                                  tfa.flash_attention_plain):
            ref = unet(x, t, ctx, y)
    _close(eps, ref, tol=5e-2)


def test_unet_forward_takes_each_cuda_kernel(cuda_device):
    """One forward of a small UNet whose attention level holds 256 tokens:
    each self-attention site launches the projection and the streamed core
    (256 keys), each cross-attention site the short-key kernel (77)."""
    cfg = UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                     transformer_depth=(0, 1), context_dim=64, head_dim=64,
                     adm_in_channels=8)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    with torch.device("meta"):
        unet = UNet2D(cfg)
    unet = flax_init_(unet.to_empty(device=cuda_device), gen).eval()
    x = torch.randn(2, 32, 32, 4, generator=gen, device=cuda_device)
    t = torch.tensor([10.0, 500.0], device=cuda_device)
    ctx = torch.randn(2, 77, 64, generator=gen, device=cuda_device)
    y = torch.randn(2, 8, generator=gen, device=cuda_device)
    sites = sum(1 for n, _ in unet.named_modules() if n.endswith("attn1"))
    tfa.reset_launches()
    with torch.no_grad():
        eps = unet(x, t, ctx, y)
    torch.cuda.synchronize()
    assert torch.isfinite(eps).all()
    assert tfa.CUDA_LAUNCHES == {"qkv_projection": sites,
                                 "flash_attention_core": sites,
                                 "short_kv_attention": sites}


@pytest.mark.parametrize("D", [40, 80, 160])
@pytest.mark.parametrize("Nq", [1, 64, 4173])
@pytest.mark.parametrize("Nk", [1, 77, 80, 81, 128, 129])
def test_one_head_kernel_at_sd15_widths(cuda_device, Nk, Nq, D):
    """SD 1.5's head widths on the one-head kernel, heads side by side as
    the projections write them: rows read as whole 64-column boxes with
    zeros past D, stores clipped at D; at D = 160 the short-key kernel
    takes at most 80 keys. Each compared call follows a poisoning one."""
    _poisoned_then_compared("bh", 2, Nq, Nk, 8, D, seed=60)


def test_sd15_shaped_unet_sites_take_the_one_head_kernel(cuda_device):
    """A narrow SD 1.5-shaped UNet (4 heads at 160/320/640 channels: head
    widths 40, 80, 160) on the card: no site is fusable, so each block
    launches the one-head kernel twice, over 1024, 256 and 64 keys and
    over 77; the eps agrees with the plain versions (5e-2·max|plain|)."""
    import dataclasses

    cfg = dataclasses.replace(UNetConfig.sd15(), model_channels=160,
                              num_heads=4, num_res_blocks=1, context_dim=64)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    with torch.device("meta"):
        unet = UNet2D(cfg)
    unet = flax_init_(unet.to_empty(device=cuda_device), gen).eval()
    x = torch.randn(2, 32, 32, 4, generator=gen, device=cuda_device)
    t = torch.tensor([10.0, 500.0], device=cuda_device)
    ctx = torch.randn(2, 77, 64, generator=gen, device=cuda_device)
    sites = sum(1 for n, _ in unet.named_modules() if n.endswith("attn1"))
    tfa.reset_launches()
    with torch.no_grad():
        eps = unet(x, t, ctx)
        assert tfa.LAUNCHES == {"fused_qkv_attention": 0,
                                "flash_attention_packed": 0,
                                "flash_attention_bh": 2 * sites}
        # every cross-attention and the self-attention over 64 keys at
        # D = 160 (a third of the blocks) take the short-key kernel
        short = sites + sites // 3
        assert tfa.CUDA_LAUNCHES["short_kv_attention"] == short
        assert tfa.CUDA_LAUNCHES["flash_attention_core"] == 2 * sites - short
        with mock.patch.object(layers, "full_attention",
                               tfa.flash_attention_plain):
            ref = unet(x, t, ctx)
    _close(eps, ref, tol=5e-2)


def test_dit_attention_sites_take_the_one_head_kernel(cuda_device):
    """A small rope DiT with 128-wide heads on the card. 17 heads make
    H·D = 2176, past the packed layout's widest row (2048), so every
    joint-attention site takes the one-head ``[B·H, N, D]`` kernel, as
    FLUX's 24 heads do; the velocity agrees with the same DiT on the
    plain version (5e-2·max|plain|)."""
    cfg = DiTConfig.tiny(pos_embed="rope", hidden=17 * 128, heads=17,
                         in_channels=16, context_dim=64, pooled_dim=32,
                         depth_double=1, depth_single=1)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    with torch.device("meta"):
        model = DiT(cfg)
    model = flax_init_(model.to_empty(device=cuda_device), gen).eval()
    x = torch.randn(1, 16, 20, 16, generator=gen, device=cuda_device)
    t = torch.tensor([0.7], device=cuda_device)
    ctx = torch.randn(1, 13, 64, generator=gen, device=cuda_device)
    pooled = torch.randn(1, 32, generator=gen, device=cuda_device)
    tfa.reset_launches()
    with torch.no_grad():
        v = model(x, t, ctx, pooled)
        assert tfa.LAUNCHES == {"fused_qkv_attention": 0,
                                "flash_attention_packed": 0,
                                "flash_attention_bh": 2}
        with mock.patch.object(dit, "full_attention", tfa.flash_attention_plain):
            ref = model(x, t, ctx, pooled)
    assert v.abs().max() > 1e-2
    _close(v, ref, tol=5e-2)


def test_cuda_device_computes_fp32_in_full_fp32(cuda_device, monkeypatch,
                                                 tmp_path):
    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device() == cuda_device
    assert torch.backends.cudnn.allow_tf32        # resolving sets nothing
    # the controller, which owns the process's models, sets the precision
    Controller(tmp_path / "config.json", device="cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# --- the upscale workflow's tile shapes -------------------------------------------
# SDXL tile img2img of 1088² crops (latents 136²), 4 tiles a chunk, CFG:
# batch 8 at 4624 tokens × 640 (10 heads) and 1156 × 1280 (20 heads)

TILE_FUSED = [(8, 4624, 640, 10), (8, 1156, 1280, 20)]


@pytest.mark.parametrize("B,N,C,H", TILE_FUSED)
def test_fused_kernel_at_tile_shapes(cuda_device, B, N, C, H):
    """Token counts that are not multiples of the 128-row q tile, at the
    largest batch the kernels run; a call on other inputs first, so a
    skipped tile would show stale numbers."""
    wq, wk, wv = (_bf16(40 + i, H * 64, C, scale=C ** -0.5) for i in range(3))
    tfa.fused_qkv_attention(_bf16(39, B, N, C), wq, wk, wv, H)
    x = _bf16(38, B, N, C)
    _close(tfa.fused_qkv_attention(x, wq, wk, wv, H),
           tfa.fused_qkv_attention_plain(x, wq, wk, wv, H))


@pytest.mark.parametrize("layout", ["packed", "bh"])
@pytest.mark.parametrize("B,Nq,H", [(8, 4624, 10), (8, 1156, 20)])
def test_short_kv_kernel_at_tile_shapes(cuda_device, layout, B, Nq, H):
    k, v = _bf16(51, B, 77, H, 64), _bf16(52, B, 77, H, 64)
    tfa.flash_attention(_bf16(53, B, Nq, H, 64), k, v, layout=layout)
    q = _bf16(50, B, Nq, H, 64)
    _close(tfa.flash_attention(q, k, v, layout=layout),
           tfa.flash_attention_plain(q, k, v))


def test_tile_engine_chunk_on_the_card(cuda_device):
    """A tile chunk through a small UNet with 64-wide heads and a small
    bf16 VAE on the card: every UNet forward takes the kernels, a chunk
    run twice is bitwise equal, and a tile's pixels do not depend on the
    chunk that carried it (the noise follows the global tile index;
    5e-2 for the batch shape's round-off in bf16, compounded over the
    steps, as the whole-model reference phases allow)."""
    from comfyui_distributed_tpu_torch.diffusion.pipeline import Txt2ImgPipeline
    from comfyui_distributed_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from comfyui_distributed_tpu_torch.tiles.engine import TileUpscaler, UpscaleSpec

    cfg = UNetConfig(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                     transformer_depth=(0, 1), context_dim=64, head_dim=64,
                     adm_in_channels=8)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    with torch.device("meta"):
        unet, vae = UNet2D(cfg), AutoencoderKL(VAEConfig.tiny(), encoder=True)
    unet = flax_init_(unet.to_empty(device=cuda_device), gen).eval()
    vae = flax_init_(vae.to_empty(device=cuda_device), gen).eval()
    ups = TileUpscaler(Txt2ImgPipeline(unet, vae))
    image = torch.rand(64, 48, 3, generator=gen, device=cuda_device)
    ctx = torch.randn(1, 77, 64, generator=gen, device=cuda_device)
    spec = UpscaleSpec(scale=1.0, tile_w=32, tile_h=32, padding=8, steps=4,
                       denoise=0.5, guidance_scale=6.0)
    plan = ups.range_plan(image, spec, 3, ctx, ctx, tiles_per_device=4)
    assert plan.num_tiles == 4 and plan.chunk == 4
    sites = sum(1 for n, _ in unet.named_modules() if n.endswith("attn1"))
    tfa.reset_launches()
    a = plan.run_range(0, 4)
    steps = 2                                # denoise 0.5 of 4 steps
    assert tfa.LAUNCHES["fused_qkv_attention"] == steps * sites
    assert tfa.LAUNCHES["flash_attention_packed"] == steps * sites
    b = plan.run_range(0, 4)
    assert (a == b).all()
    narrow = ups.range_plan(image, spec, 3, ctx, ctx, tiles_per_device=1)
    c = narrow.run_range(0, 4)
    assert abs(c - a).max() <= 5e-2
