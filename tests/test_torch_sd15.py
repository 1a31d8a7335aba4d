"""The port's ``sd15`` against the JAX package's: the preset at its
published widths (shape only), and a narrow SD 1.5-shaped UNet and
ControlNet in fp32 with the weights carried by ``from_jax``: 4 heads at
160/320/640 channels keep SD 1.5's head widths 40, 80 and 160, the conv-
only fourth level and the middle block without a transformer. (Narrower
is not possible: GroupNorm's 32 groups must divide every width.)

Then ``workflows/controlnet-tile-upscale.json`` through the port's
graph executor with ``sd15`` patched to that narrow stack (the tiny VAE
and text encoder, 24² tiles with padding 4, 4 steps, ``upscale_by``
2.0) against the JAX nodes on the same weights, with JAX's tile and
sampler noise handed over; and a farmed run against a direct one,
bitwise, with a stochastic sampler. Tolerance 2e-4 (module and pipeline level).
"""

import dataclasses
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.graph import nodes_builtin as jnodes  # noqa: E402
from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.models import controlnet as jcn  # noqa: E402
from comfyui_distributed_tpu.models import registry as jreg  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.ops import resize as jresize  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.graph import GraphExecutor  # noqa: E402
from comfyui_distributed_tpu_torch.graph.executor import strip_meta  # noqa: E402
from comfyui_distributed_tpu_torch.graph.node import get_node  # noqa: E402
from comfyui_distributed_tpu_torch.models import controlnet as tcn  # noqa: E402
from comfyui_distributed_tpu_torch.models import layers as tlayers  # noqa: E402
from comfyui_distributed_tpu_torch.models import registry as treg  # noqa: E402
from comfyui_distributed_tpu_torch.models import text as ttext  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import carry_plan, load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.ops import resize as tresize  # noqa: E402
from comfyui_distributed_tpu_torch.tiles import engine as tengine  # noqa: E402
from comfyui_distributed_tpu_torch.utils.image import encode_png  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]
WORKFLOW = ROOT / "workflows" / "controlnet-tile-upscale.json"
NARROW = dict(model_channels=160, num_heads=4, num_res_blocks=1,
              context_dim=32, dtype="float32")
HEAD_WIDTHS = (40, 80, 160)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed=5, scale=0.05):
    """Flax's zero convs and ``mid_out`` drawn from seeded noise (flax
    leaves them zero, and every residual would be 0)."""
    rng = np.random.default_rng(seed)

    def walk(tree, zero=False):
        out = {}
        for k, v in tree.items():
            z = zero or k.startswith("zero_") or k == "mid_out"
            if hasattr(v, "items"):
                out[k] = walk(v, z)
            else:
                out[k] = ((rng.standard_normal(v.shape) * scale).astype(np.float32)
                          if z else np.asarray(v))
        return out

    return walk(_np(params))


def _fields(cfg) -> dict:
    """The config's fields, less JAX's ``remat`` and the port's
    ``middle_depth``, which must be -1: JAX's rule, the last level's
    transformer depth."""
    if hasattr(cfg, "middle_depth"):
        assert cfg.middle_depth == -1 and cfg.mid_depth == cfg.transformer_depth[-1]
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("remat", "middle_depth")}


# --- the preset -----------------------------------------------------------------


def test_sd15_config_and_preset_match_jax():
    assert _fields(tunet.UNetConfig.sd15()) == _fields(junet.UNetConfig.sd15())
    jp, tp = jreg.PRESETS["sd15"], treg.PRESETS["sd15"]
    assert _fields(tp.unet) == _fields(jp.unet)
    assert tp.vae.scaling_factor == jp.vae.scaling_factor == 0.18215
    assert dataclasses.asdict(tp.vae) == dataclasses.asdict(jp.vae)
    assert dataclasses.asdict(tp.text) == dataclasses.asdict(jp.text)
    assert tp.unet.adm_in_channels == 0 and tp.kind == "unet"
    assert tcn.PRESETS["sd15"] == tunet.UNetConfig.sd15()


def test_sd15_at_full_width_has_the_jax_parameter_tree():
    """The port's full-width UNet and ControlNet, built on the meta
    device, take the JAX package's parameter trees (shape only) leaf for
    leaf; heads are 40, 80 and 160 wide; 15 transformer blocks in the
    UNet (6 down, 9 up, none in the middle), 6 in the ControlNet."""
    cfg = tunet.UNetConfig.sd15()
    _, jtree = junet.init_unet(junet.UNetConfig.sd15(), jax.random.key(0),
                               sample_shape=(64, 64, 4), abstract=True)
    with torch.device("meta"):
        unet = tunet.UNet2D(cfg)
        cnet = tcn.ControlNet(cfg)
    # raises on a leaf it cannot place and on a parameter left unset
    assert len(carry_plan(jtree, unet)) == len(list(unet.parameters()))
    assert not hasattr(unet, "mid_attn")
    n = sum(p.numel() for p in unet.parameters())
    assert n == sum(int(np.prod(leaf.shape)) for leaf in
                    jax.tree_util.tree_leaves(jtree))
    blocks = [m for m in unet.modules() if isinstance(m, tlayers.TransformerBlock)]
    assert len(blocks) == 15
    widths = sorted({b.attn1.head_dim for b in blocks})
    assert widths == list(HEAD_WIDTHS)
    assert {b.attn1.num_heads for b in blocks} == {8}
    cblocks = [m for m in cnet.modules() if isinstance(m, tlayers.TransformerBlock)]
    assert len(cblocks) == 6 and not hasattr(cnet, "mid_attn")


# --- a narrow SD 1.5-shaped stack ------------------------------------------------


@pytest.fixture(scope="module")
def narrow():
    jcfg = dataclasses.replace(junet.UNetConfig.sd15(), **NARROW)
    tcfg = dataclasses.replace(tunet.UNetConfig.sd15(), **NARROW)
    model, uparams = junet.init_unet(jcfg, jax.random.key(0),
                                     sample_shape=(16, 16, 4), context_len=16)
    jb = jcn.init_controlnet(jcfg, jax.random.key(2), sample_shape=(16, 16, 4),
                             context_len=16)
    jb.params = _perturbed(jb.params)
    unet = load_from_jax(tunet.UNet2D(tcfg), _np(uparams)).eval()
    cnet = load_from_jax(tcn.ControlNet(tcfg), jb.params).eval()
    rng = np.random.default_rng(0)
    f32 = np.float32
    inputs = dict(x=rng.standard_normal((2, 16, 16, 4)).astype(f32),
                  t=np.array([20.0, 600.0], f32),
                  ctx=rng.standard_normal((2, 16, 32)).astype(f32),
                  hint=rng.random((2, 128, 128, 3)).astype(f32))
    return dict(jcfg=jcfg, tcfg=tcfg, model=model, uparams=uparams, jb=jb,
                unet=unet, cnet=cnet, inputs=inputs)


def test_narrow_config_keeps_the_head_widths(narrow):
    blocks = [m for m in narrow["unet"].modules()
              if isinstance(m, tlayers.TransformerBlock)]
    assert sorted({b.attn1.head_dim for b in blocks}) == list(HEAD_WIDTHS)
    assert not hasattr(narrow["unet"], "mid_attn")
    assert narrow["tcfg"].transformer_depth == (1, 1, 1, 0)


def test_narrow_sd15_unet_matches_flax(narrow, monkeypatch):
    """Every attention site of the SD 1.5 geometry takes ``full_attention``
    (the fused tier's predicate refuses D % 64 ≠ 0): 9 blocks at one res
    block a level, 18 sites."""
    i = narrow["inputs"]
    ref = np.asarray(narrow["model"].apply(
        narrow["uparams"], *(jnp.asarray(i[k]) for k in ("x", "t", "ctx"))))
    sites = []
    full = tlayers.full_attention
    monkeypatch.setattr(tlayers, "full_attention",
                        lambda q, k, v: sites.append(q.shape[-1]) or full(q, k, v))
    monkeypatch.setattr(tlayers, "self_attention", None)   # never reached
    with torch.no_grad():
        out = narrow["unet"](*(torch.from_numpy(i[k]) for k in ("x", "t", "ctx")))
    assert out.shape == ref.shape == (2, 16, 16, 4)
    assert float(np.abs(ref).max()) > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert len(sites) == 18 and sorted(set(sites)) == list(HEAD_WIDTHS)


def test_narrow_sd15_controlnet_matches_flax(narrow):
    i = narrow["inputs"]
    jdown, jmid = narrow["jb"].apply(
        *(jnp.asarray(i[k]) for k in ("x", "t", "ctx")), None,
        jnp.asarray(i["hint"]))
    with torch.no_grad():
        down, mid = narrow["cnet"](
            *(torch.from_numpy(i[k]) for k in ("x", "t", "ctx")), None,
            torch.from_numpy(i["hint"]))
    assert len(down) == len(jdown)
    for d, jd in zip(down + [mid], list(jdown) + [jmid]):
        ref = np.asarray(jd).transpose(0, 3, 1, 2)
        assert float(np.abs(ref).max()) > 1e-3
        np.testing.assert_allclose(d.numpy(), ref, atol=TOL, rtol=TOL)


def test_upscale_by_two_resizes_as_the_jax_node():
    """USDU without an upscale model resizes by ``upscale_by`` with the
    spec's lanczos3 before tiling, as the JAX engine does."""
    img = np.random.default_rng(3).random((1, 20, 24, 3)).astype(np.float32)
    spec = tengine.UpscaleSpec(scale=2.0)
    ref = np.asarray(jresize.upscale_image(jnp.asarray(img), 2.0,
                                           spec.resize_method))
    out = tresize.upscale_image(torch.from_numpy(img), 2.0, spec.resize_method)
    assert out.shape == (1, 40, 48, 3) and spec.resize_method == "lanczos3"
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


# --- the workflow ------------------------------------------------------------------

TILE, PADDING = 24, 4           # 32² crops: 16² latents on the 2× VAE
STEPS = 10                      # 4 steps at the workflow's denoise 0.4


def _workflow(sampler: str) -> dict:
    prompt = strip_meta(json.loads(WORKFLOW.read_text()))
    prompt["5"]["inputs"].update(tile_width=TILE, tile_height=TILE,
                                 tile_padding=PADDING, steps=STEPS,
                                 sampler_name=sampler)
    return prompt


@pytest.fixture(scope="module")
def stack(narrow, tmp_path_factory):
    """The narrow stack in both packages: the JAX pipeline and ControlNet,
    and a port registry whose ``sd15`` bundle and ControlNet carry the
    same weights; the workflow's input image."""
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(32, 32))
    enc = jtext.TextEncoder(dataclasses.replace(jtext.TextEncoderConfig.tiny(),
                                                dtype="float32")).init(
        jax.random.key(3))
    jp = jpipe.Txt2ImgPipeline(narrow["model"], narrow["uparams"], vae)
    preset = treg.ModelPreset(
        "sd15", narrow["tcfg"], tvae.VAEConfig.tiny(dtype="float32"),
        dataclasses.replace(ttext.TextEncoderConfig.tiny(), dtype="float32"))
    tmp = tmp_path_factory.mktemp("sd15")
    (tmp / "in").mkdir()
    img = np.random.default_rng(4).random((20, 24, 3)).astype(np.float32)
    (tmp / "in" / "input.png").write_bytes(encode_png(img))
    return dict(jp=jp, vae=vae, enc=enc, preset=preset, tmp=tmp)


@pytest.fixture(scope="module")
def registry(stack, narrow):
    """A registry whose ``sd15`` bundle and ControlNet are the narrow
    stack with the JAX weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(treg.PRESETS, "sd15", stack["preset"])
        mp.setitem(tcn.PRESETS, "sd15", narrow["tcfg"])
        reg = treg.ModelRegistry("cpu", seed=0)
        reg.get("sd15").load_from_jax(
            narrow["uparams"], _np(stack["vae"].dec_params),
            _np(stack["enc"].params), _np(stack["vae"].enc_params))
        load_from_jax(reg.get_controlnet("sd15").model, narrow["jb"].params)
        yield reg


def jax_noise_in_port(monkeypatch, seed: int):
    """The port's tile plans take JAX's per-tile noise
    (``fold_in(key(seed), tile)``) and its one-chunk sampler draws
    (``fold_in(fold_in(key(seed), 0xFFFFFFFF), j)`` over all tiles)."""
    range_plan = tengine.TileUpscaler.range_plan
    key = jax.random.key(seed)
    sampler_key = jax.random.fold_in(key, jnp.uint32(0xFFFFFFFF))

    def plan(self, image, spec, seed_, *args, **kw):
        grid = self.grid_for(image.shape[0], image.shape[1], spec)
        T = grid.num_tiles
        shape = (grid.crop_h // 2, grid.crop_w // 2, 4)
        kw["noise"] = torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), shape, jnp.float32)) for i in range(T)]))
        kw["step_noise"] = lambda j: torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(sampler_key, j), (T, *shape),
                              jnp.float32)))
        return range_plan(self, image, spec, seed_, *args, **kw)

    monkeypatch.setattr(tengine.TileUpscaler, "range_plan", plan)


def test_workflow_matches_the_jax_nodes(stack, narrow, registry, monkeypatch):
    """With a stochastic sampler, so that JAX's chunk draws are handed
    over too."""
    sampler = "dpmpp_2m_sde"
    prompt = _workflow(sampler)
    usdu = prompt["5"]["inputs"]
    jax_noise_in_port(monkeypatch, usdu["seed"])
    out_dir = stack["tmp"] / f"out_{sampler}"
    result = GraphExecutor({"model_registry": registry,
                            "input_dir": str(stack["tmp"] / "in"),
                            "output_dir": str(out_dir)}).execute(prompt)
    image = result["4"][0]
    out = result["5"][0]
    assert tuple(out.shape) == (1, 40, 48, 3)
    assert (out_dir / "cn_upscaled_00000.png").is_file()
    # the JAX nodes on the same weights, text and image
    enc = stack["enc"]
    conds = []
    for node in ("2", "3"):
        ctx, pooled = enc.encode([prompt[node]["inputs"]["text"]])
        conds.append({"context": np.asarray(ctx), "pooled": np.asarray(pooled)})
    (jpos,) = jnodes.ControlNetApply().execute(
        conds[0], narrow["jb"], image.numpy(),
        strength=prompt["9"]["inputs"]["strength"])
    jm = types.SimpleNamespace(pipeline=stack["jp"])
    (ref,) = jnodes.UltimateSDUpscaleDistributed().execute(
        image.numpy(), jm, jpos, conds[1], usdu["seed"], usdu["steps"],
        usdu["denoise"], usdu["upscale_by"], tile_width=TILE, tile_height=TILE,
        tile_padding=PADDING, cfg=usdu["cfg"], sampler_name=sampler,
        mesh=build_mesh({"dp": 1}))
    ref = np.asarray(ref)
    assert ref.shape == (1, 40, 48, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    # the ControlNet moved the tiles
    (plain,) = jnodes.UltimateSDUpscaleDistributed().execute(
        image.numpy(), jm, conds[0], conds[1], usdu["seed"], usdu["steps"],
        usdu["denoise"], usdu["upscale_by"], tile_width=TILE, tile_height=TILE,
        tile_padding=PADDING, cfg=usdu["cfg"], sampler_name=sampler,
        mesh=build_mesh({"dp": 1}))
    assert float(np.abs(np.asarray(plain) - ref).max()) > 1e-3


class ReversedFarm:
    """The farm's master role run locally, its tasks in reverse order."""

    def __init__(self):
        self.tasks = 0

    def master_run(self, job_id, total, process_fn, chunk=1, **_):
        n = -(-total // chunk)
        self.tasks = n
        return {t: process_fn(t * chunk, min((t + 1) * chunk, total))
                for t in reversed(range(n))}


@pytest.mark.parametrize("tiles_per_device", ["1", "3"])
def test_farmed_run_equals_direct_run_with_a_stochastic_sampler(
        registry, stack, monkeypatch, tiles_per_device):
    """Each tile's noise and each of its sampler draws come from (seed,
    global tile index): a farm that runs the chunks in another order
    gives the direct image bit for bit, hint and all."""
    monkeypatch.setenv("CDT_TILES_PER_DEVICE", tiles_per_device)
    prompt = _workflow("dpmpp_2m_sde")
    ex = GraphExecutor({"model_registry": registry,
                        "input_dir": str(stack["tmp"] / "in"),
                        "output_dir": str(stack["tmp"] / "farm")})
    result = ex.execute(prompt)
    direct = result["5"][0]
    usdu = prompt["5"]["inputs"]
    farm = ReversedFarm()
    node = get_node("UltimateSDUpscaleDistributed")()
    (farmed,) = node.execute(
        result["4"][0], registry.get("sd15"), result["9"][0], result["3"][0],
        usdu["seed"], usdu["steps"], usdu["denoise"], usdu["upscale_by"],
        tile_width=TILE, tile_height=TILE, tile_padding=PADDING,
        cfg=usdu["cfg"], sampler_name="dpmpp_2m_sde", tile_farm=farm,
        multi_job_id="job", enabled_worker_ids=["w0"])
    assert farm.tasks == -(-4 // int(tiles_per_device))
    assert torch.equal(farmed, direct)
