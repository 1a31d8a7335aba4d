"""The port's offload (``diffusion/offload.py``) against the JAX package's
on tiny presets:

- the packed layout: the set of quantised leaves and every leaf's fp8
  bytes and scales bitwise JAX's ``_flatten_block`` after the layout
  mapping (a port ``Linear`` weight is JAX's kernel transposed), the
  dequantised weights bitwise its ``_unflatten_block``;
- ``plan_offload``: JAX's resident and streamed names and bytes on the
  tiny presets and on ``meta``-device ``flux`` and ``wan`` at 13 and 13.5
  GiB (JAX's ``TestFullScalePlans`` figures);
- ``OffloadedFlux``/``OffloadedWan`` forwards (CFG too) and
  ``generate_offloaded`` (flow, t2v, the two-expert swap, i2v) within
  2e-4 of JAX's executors, JAX's noise handed over; ``native`` offloaded
  runs equal to the port's ``dp`` runs; streamed equal to resident bit
  for bit;
- an offload bundle's drawn blocks equal to the resident bundle's; the
  refusals, the knobs, interrupts, ``release_store``, a residency
  eviction, the quant cache and the nodes through ``GraphExecutor``."""

import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch import nn

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import offload as joff  # noqa: E402
from comfyui_distributed_tpu.diffusion import pipeline_flow as jflow  # noqa: E402
from comfyui_distributed_tpu.diffusion import pipeline_video as jpv  # noqa: E402
from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.models import wan as jwan  # noqa: E402
from comfyui_distributed_tpu.models import wan_vae as jwv  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import offload as toff  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_flow as tflow  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_video as tpv  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models import wan as twan  # noqa: E402
from comfyui_distributed_tpu_torch.models import wan_vae as twv  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import (  # noqa: E402
    carry_plan, load_from_jax)
from comfyui_distributed_tpu_torch.models.registry import (  # noqa: E402
    PRESETS, ModelBundle, ModelRegistry)
from comfyui_distributed_tpu_torch.utils.constants import KnobError  # noqa: E402
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError  # noqa: E402

from test_torch_dit import break_zero_init  # noqa: E402
from torch_ckpt_fixtures import perturbed  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
F8 = "float8_e4m3fn"
HUGE = 1 << 40
KNOBS = ("CDT_OFFLOAD", "CDT_OFFLOAD_RESIDENT_GB", "CDT_OFFLOAD_STREAM_DTYPE",
         "CDT_OFFLOAD_LADDER", "CDT_OFFLOAD_CACHE_DIR")


@pytest.fixture(autouse=True)
def clean_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- the JAX layout of a port module ------------------------------------------


def _jax_value(t: torch.Tensor):
    a = t.detach().float().numpy()
    return a.astype(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else a


def jax_tree(module: nn.Module, abstract: bool = False) -> dict:
    """``module``'s parameters as a JAX tree (the inverse of
    ``models/from_jax``'s carry): Linear kernels [in, out], convolution
    kernels channel-last, norm scales ``scale``; values in the port's
    dtypes (bf16 as ``ml_dtypes.bfloat16``), or ``ShapeDtypeStruct``s."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        owner = module.get_submodule(".".join(mods)) if mods else module
        perm, key = None, leaf
        if leaf == "weight" and isinstance(owner, nn.Linear):
            perm, key = (1, 0), "kernel"
        elif leaf == "weight" and isinstance(owner, nn.Conv3d):
            perm, key = (2, 3, 4, 1, 0), "kernel"
        elif leaf == "weight" and isinstance(owner, nn.Conv2d):
            perm, key = (2, 3, 1, 0), "kernel"
        elif leaf == "weight" and isinstance(owner, (nn.LayerNorm,
                                                     nn.GroupNorm)):
            key = "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        if abstract:
            shape = tuple(p.shape) if perm is None else tuple(
                p.shape[i] for i in perm)
            dt = jnp.bfloat16 if p.dtype == torch.bfloat16 else \
                np.dtype(str(p.dtype).removeprefix("torch."))
            node[key] = jax.ShapeDtypeStruct(shape, dt)
        else:
            v = _jax_value(p)
            node[key] = v if perm is None else np.ascontiguousarray(
                v.transpose(perm))
    return tree


def _jax_path_to_port(block: nn.Module, jtree: dict) -> dict:
    """JAX leaf path → (port parameter name, transform)."""
    return {path: (name, transform)
            for name, (path, transform) in carry_plan(jtree, block).items()}


# --- the packed layout, bitwise against JAX --------------------------------------


@pytest.fixture(scope="module")
def tiny_bundles():
    return {name: ModelBundle(PRESETS[name], device="cpu", seed=0)
            for name in ("flux-tiny", "wan-tiny")}


BLOCKS = [("flux-tiny", "double_0"), ("flux-tiny", "double_1"),
          ("flux-tiny", "single_0"), ("flux-tiny", "single_1"),
          ("wan-tiny", "block_0"), ("wan-tiny", "block_1")]


@pytest.mark.parametrize("name,block", BLOCKS)
def test_fp8_bytes_and_scales_are_jax(tiny_bundles, name, block):
    """Every quantised leaf of the tiny presets' blocks (bf16 FLUX, fp32
    WAN): the same set as JAX's, each leaf's e4m3 bytes and its scales
    bitwise JAX's ``_flatten_block``, and the dequantised weights bitwise
    its ``_unflatten_block``."""
    blk = getattr(tiny_bundles[name].core, block)
    jblk = jax_tree(blk)
    bufs, treedef, metas = joff._flatten_block(jblk, quantize=True)
    layout = toff.block_layout(blk, True)
    ours = toff.pack_block(dict(blk.named_parameters()), layout)
    by_name = {l.name: l for l in layout.leaves}
    mapping = _jax_path_to_port(blk, jblk)
    paths = [tuple(str(getattr(k, "key", k)) for k in kp)
             for kp, _ in jax.tree_util.tree_flatten_with_path(jblk)[0]]
    j_quant = {mapping[p][0] for p, m in zip(paths, metas) if m[3] >= 0}
    assert j_quant == {l.name for l in layout.leaves if l.scale_offset >= 0}
    assert j_quant, "the tiny block quantises nothing"
    for path, (bk, off, shape, s_off, _) in zip(paths, metas):
        port_name, transform = mapping[path]
        leaf = by_name[port_name]
        if s_off < 0:
            continue
        n = int(np.prod(shape))
        jq = np.asarray(bufs[bk]).view(np.uint8)[off:off + n].reshape(shape)
        if transform == "t":
            jq = jq.T
        ours_q = ours[toff.F8][leaf.offset:leaf.offset + n].numpy().reshape(
            leaf.shape)
        np.testing.assert_array_equal(ours_q, jq)
        width = shape[-1]
        np.testing.assert_array_equal(
            ours[toff.SCALE][leaf.scale_offset:leaf.scale_offset + width]
            .numpy(), np.asarray(bufs["scale"])[s_off:s_off + width])
    jout = joff._unflatten_block({k: jnp.asarray(v) for k, v in bufs.items()},
                                 treedef, metas)
    jleaves = jax.tree_util.tree_leaves(jout)
    mine = toff.unpack_block(ours, layout)
    for path, jl in zip(paths, jleaves):
        port_name, transform = mapping[path]
        ref = np.asarray(jl).astype(np.float32)
        if transform == "t":
            ref = ref.T
        np.testing.assert_array_equal(mine[port_name].float().numpy(), ref)


def test_quantisation_edges():
    """Biases and norm scales stay exact, a zero output channel stays zero
    and finite, and a leaf under 4096 elements is not quantised."""
    w = torch.randn(64, 128)
    w[7] = 0.0
    lin = nn.Linear(128, 64)
    with torch.no_grad():
        lin.weight.copy_(w)
    small = nn.Linear(32, 16)
    block = nn.ModuleDict({"lin": lin, "small": small, "norm": nn.LayerNorm(8)})
    layout = toff.block_layout(block, True)
    out = toff.unpack_block(toff.pack_block(dict(block.named_parameters()),
                                            layout), layout)
    assert {l.name for l in layout.leaves if l.scale_offset >= 0} == \
        {"lin.weight"}
    assert torch.equal(out["lin.weight"][7], torch.zeros(128))
    assert torch.isfinite(out["lin.weight"]).all()
    for name in ("lin.bias", "small.weight", "small.bias", "norm.weight"):
        assert torch.equal(out[name], dict(block.named_parameters())[name])
    rel = (out["lin.weight"] - w).abs() / w.abs().clamp_min(1e-8)
    assert float(rel[w != 0].mean()) < 0.03


# --- plans ---------------------------------------------------------------------


def _jax_plan(module, budget, sd, prefixes, glue):
    return joff.plan_offload(jax_tree(module, abstract=True), budget, sd,
                             block_prefixes=prefixes, glue_keys=glue)


def _same_plan(ours, ref):
    for key in ("order", "resident", "streamed", "resident_bytes",
                "streamed_bytes", "fully_resident"):
        assert ours[key] == ref[key], key


@pytest.mark.parametrize("name", ["flux-tiny", "wan-tiny", "wan-2.2-tiny",
                                  "wan-i2v-tiny"])
@pytest.mark.parametrize("sd", ["native", F8])
def test_tiny_plans_are_jax(name, sd):
    preset = PRESETS[name]
    with torch.device("meta"):
        core = (twan.WanModel(preset.video) if preset.kind == "video"
                else tdit.DiT(preset.dit))
    wan = isinstance(core, twan.WanModel)
    prefixes = ("block",) if wan else ("double", "single")
    glue = toff.WAN_GLUE_KEYS if wan else toff.GLUE_KEYS
    block = toff.block_packed_bytes(getattr(core, prefixes[0] + "_0"),
                                    sd == F8)
    for budget in (0, block, int(2.5 * block), 2 ** 20, HUGE):
        _same_plan(toff.plan_offload(core, budget, sd, prefixes, glue),
                   _jax_plan(core, budget, sd, prefixes, glue))


def test_full_scale_flux_plan():
    """FLUX.1 [dev] on ``meta``: its fp8 blocks fully resident at 13 GiB,
    between 11e9 bytes and 13 GiB (JAX's figures), JAX's plan of the same
    leaves."""
    with torch.device("meta"):
        core = tdit.DiT(tdit.DiTConfig.flux())
    budget = int(13 * (1 << 30))
    plan = toff.plan_offload(core, budget, F8)
    assert plan["fully_resident"], plan["streamed"]
    assert 11e9 < plan["resident_bytes"] < 13 * (1 << 30)
    assert len(plan["order"]) == 57
    _same_plan(plan, _jax_plan(core, budget, F8, ("double", "single"),
                               toff.GLUE_KEYS))


def test_full_scale_wan_plan():
    """A WAN 14B expert on ``meta``: over 26e9 bytes in bf16; at 13.5 GiB
    of fp8 over 90% resident and under 2.5e9 bytes streamed a forward
    (JAX's figures), JAX's plan of the same leaves; its leaves carry from
    JAX's own abstract tree."""
    with torch.device("meta"):
        core = twan.WanModel(twan.WanConfig.wan_14b())
    total = sum(p.numel() * p.element_size() for p in core.parameters())
    assert total > 26e9
    budget = int(13.5 * (1 << 30))
    plan = toff.plan_offload(core, budget, F8, ("block",),
                             toff.WAN_GLUE_KEYS)
    assert len(plan["order"]) == 40
    frac = plan["resident_bytes"] / (plan["resident_bytes"]
                                     + plan["streamed_bytes"])
    assert frac > 0.90 and plan["streamed_bytes"] < 2.5e9
    _same_plan(plan, _jax_plan(core, budget, F8, ("block",),
                               toff.WAN_GLUE_KEYS))
    jcfg = jwan.WanConfig.wan_14b()
    block = jax.eval_shape(lambda: jwan.WanBlock(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 8, jcfg.dim)),
        jnp.zeros((1, 6, jcfg.dim)), jnp.zeros((1, 4, jcfg.dim)),
        (jnp.zeros((8, 64)), jnp.zeros((8, 64))), None))
    assert carry_plan(block, core.block_0)


# --- executors against JAX's -------------------------------------------------------


@pytest.fixture(scope="module")
def flux_pair():
    """The fp32 tiny DiT in both packages with the same weights (zero-init
    gates replaced), its VAE, and inputs."""
    jcfg = jdit.DiTConfig.tiny(dtype="float32", pos_embed="rope")
    model, params = jdit.init_dit(jcfg, jax.random.key(0), sample_hw=(8, 8),
                                  context_len=6)
    params = break_zero_init(params, 1)
    dit = load_from_jax(tdit.DiT(tdit.DiTConfig.tiny(dtype="float32",
                                                    pos_embed="rope")),
                        params).eval().requires_grad_(False)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(16, 16))
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, _np(vae.dec_params))
    rng = np.random.default_rng(2)
    inputs = (rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
              np.array([0.6], np.float32),
              rng.standard_normal((1, 6, 32)).astype(np.float32),
              rng.standard_normal((1, 16)).astype(np.float32),
              np.array([3.5], np.float32))
    return (model, params, vae, jflow.FlowPipeline(model, params, vae),
            dit, tflow.FlowPipeline(dit, tv.eval()), inputs)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("sd", ["native", F8])
def test_flux_forward_matches_jax(flux_pair, sd):
    model, params, _, _, dit, _, inputs = flux_pair
    ref = np.asarray(joff.OffloadedFlux(model, params, resident_bytes=HUGE,
                                        stream_dtype=sd).forward(
        *[jnp.asarray(a) for a in inputs]))
    off = toff.OffloadedFlux(dit, resident_bytes=HUGE, stream_dtype=sd)
    assert off.stacked and not off.streamed
    out = off.forward(*_t(*inputs)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    if sd == "native":
        assert torch.equal(torch.from_numpy(out), dit(*_t(*inputs)))


@pytest.fixture(scope="module")
def wan_pair():
    jcfg = jwan.WanConfig.tiny()
    model, params = jwan.init_wan(jcfg, jax.random.key(0),
                                  sample_fhw=(3, 4, 4), context_len=5)
    params = perturbed(_np(params), 10)
    port = load_from_jax(twan.WanModel(twan.WanConfig.tiny()),
                         params).eval().requires_grad_(False)
    rng = np.random.default_rng(3)
    inputs = (rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32),
              np.array([0.6], np.float32),
              rng.standard_normal((1, 5, 32)).astype(np.float32))
    return model, params, port, inputs


@pytest.mark.parametrize("sd", ["native", F8])
def test_wan_forward_and_cfg_match_jax(wan_pair, sd):
    model, params, port, (x, t, ctx) = wan_pair
    joffw = joff.OffloadedWan(model, params, resident_bytes=HUGE,
                              stream_dtype=sd)
    off = toff.OffloadedWan(port, resident_bytes=HUGE, stream_dtype=sd)
    np.testing.assert_allclose(
        off.forward(*_t(x, t, ctx)).numpy(),
        np.asarray(joffw.forward(jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(ctx))), atol=TOL, rtol=TOL)
    ref = np.asarray(joffw.denoiser(jnp.asarray(ctx), 4.5)(
        jnp.asarray(x), jnp.float32(0.6)))
    out = off.denoiser(torch.from_numpy(ctx), 4.5)(
        torch.from_numpy(x), torch.tensor(0.6)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["flux", "wan"])
@pytest.mark.parametrize("sd", ["native", F8])
def test_streamed_equals_resident_bitwise(flux_pair, wan_pair, kind, sd):
    """All streamed (0), a prefix resident (1.5 blocks) and fully resident:
    the same bytes through the same block code."""
    if kind == "flux":
        module, inputs, cls = flux_pair[4], flux_pair[6], toff.OffloadedFlux
        first = "double_0"
    else:
        module, inputs, cls = wan_pair[2], wan_pair[3], toff.OffloadedWan
        first = "block_0"
    block = toff.block_packed_bytes(getattr(module, first), sd == F8)
    glue = toff.plan_offload(module, 0, sd, cls.prefixes,
                             cls.glue_keys)["glue_bytes"]
    outs = []
    for budget in (0, glue + int(1.5 * block), HUGE):
        off = cls(module, resident_bytes=budget, stream_dtype=sd)
        assert bool(off.streamed) == (budget != HUGE)
        assert bool(off.resident) == (0 < budget < HUGE)
        outs.append(off.forward(*_t(*inputs)))
        outs.append(off.forward(*_t(*inputs)))      # the slots reused
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_expected_blocks_and_learned_positions_refused(flux_pair):
    dit = flux_pair[4]
    twin = tdit.DiT(tdit.DiTConfig.tiny(dtype="float32", pos_embed="rope"))
    del twin.single_1
    with pytest.raises(ValueError, match="holds 3 transformer blocks"):
        toff.OffloadedFlux(twin, resident_bytes=HUGE)
    sd3 = tdit.DiT(tdit.DiTConfig.sd3_tiny(dtype="float32"))
    with pytest.raises(ValueError, match="learned position table"):
        toff.OffloadedFlux(sd3)
    with pytest.raises(ValueError, match="STREAM_DTYPE"):
        toff.OffloadedFlux(dit, stream_dtype="int4")


# --- generate_offloaded against JAX's ------------------------------------------------


def _flow_noise(seed, shape):
    key = jax.random.fold_in(jax.random.key(seed), 0)
    return np.array(jax.random.normal(key, shape, jnp.float32))


def test_flow_generate_offloaded_matches_jax_and_dp(flux_pair):
    """fp8 against JAX's fp8 executor (its one-program ladder), JAX's
    noise handed over; ``native`` offloaded equal to the port's ``dp``."""
    _, _, _, jp, _, tp, (_, _, ctx, pooled, _) = flux_pair
    spec = dict(height=16, width=16, steps=3)
    ref = np.asarray(jp.generate_offloaded(
        jflow.FlowSpec(**spec), 7, jnp.asarray(ctx), jnp.asarray(pooled),
        resident_bytes=HUGE, stream_dtype=F8))
    noise = torch.from_numpy(_flow_noise(7, (1, 8, 8, 4)))
    out = tp.generate_offloaded(tflow.FlowSpec(**spec), 7, *_t(ctx, pooled),
                                resident_bytes=HUGE, stream_dtype=F8,
                                noise=noise)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    tspec = tflow.FlowSpec(**spec)
    dp = tp.generate(tspec, 7, *_t(ctx, pooled))
    native = tp.generate_offloaded(tspec, 7, *_t(ctx, pooled),
                                   stream_dtype="native")
    torch.testing.assert_close(native, dp, atol=TOL, rtol=TOL)
    streamed = tp.generate_offloaded(tspec, 7, *_t(ctx, pooled),
                                     resident_bytes=0, stream_dtype="native")
    assert torch.equal(streamed, native)


@pytest.fixture(scope="module")
def video_pair():
    """Tiny fp32 WAN experts (high, low, i2v) in both packages with the
    same weights, and the 3D VAE."""
    def expert(seed, base=None, **kw):
        if base is None:
            model, params = jwan.init_wan(jwan.WanConfig.tiny(**kw),
                                          jax.random.key(seed),
                                          sample_fhw=(2, 8, 8), context_len=6)
        else:
            model, params = base[:2]
        params = perturbed(_np(params), seed + 10)
        port = load_from_jax(twan.WanModel(twan.WanConfig.tiny(**kw)),
                             params).eval().requires_grad_(False)
        return model, params, port

    jv = jwv.WanVAE3D(jwv.WanVAEConfig.tiny()).init(
        jax.random.key(5), frames=5, image_hw=(16, 16))
    tv = twv.WanVAE3D(twv.WanVAEConfig.tiny())
    load_from_jax(tv.encoder, _np(jv.enc_params))
    load_from_jax(tv.decoder, _np(jv.dec_params))
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    hi = expert(0)
    return {"hi": hi, "lo": expert(1, hi), "i2v": expert(2, in_channels=10),
            "vae": (jv, tv.eval()), "ctx": ctx}


VIDEO_CASES = {
    "t2v": dict(frames=5, height=16, width=16, steps=3, shift=3.0,
                guidance_scale=4.0),
    "moe": dict(frames=5, height=16, width=16, steps=4, shift=1.0,
                guidance_scale=3.0),
    "i2v": dict(frames=5, height=16, width=16, steps=2, shift=3.0,
                guidance_scale=4.0),
}


def _video_pipes(video_pair, case):
    jv, tv = video_pair["vae"]
    name = "i2v" if case == "i2v" else "hi"
    jm, jparams, port = video_pair[name]
    kw, tkw = {}, {}
    if case == "moe":
        _, lo_params, lo_port = video_pair["lo"]
        kw = dict(dit_params_low=lo_params, expert_boundary=0.875)
        tkw = dict(dit_low=lo_port, expert_boundary=0.875)
    return (jpv.VideoPipeline(jm, jparams, jv, **kw),
            tpv.VideoPipeline(port, tv, **tkw))


@pytest.mark.parametrize("case", ["t2v", "moe", "i2v"])
def test_video_generate_offloaded_matches_jax_and_dp(video_pair, case):
    """fp8 against JAX's executors (the swap: high released, low kept),
    JAX's noise handed over; ``native`` offloaded equal to the port's
    ``dp`` run; streamed equal to resident."""
    jp, tp = _video_pipes(video_pair, case)
    spec = VIDEO_CASES[case]
    ctx = video_pair["ctx"]
    tspec = tpv.VideoSpec(**spec)
    image = np.full((1, 16, 16, 3), 0.3, np.float32)
    if case == "i2v":
        ref = jp.generate_offloaded_i2v(jpv.VideoSpec(**spec), 6,
                                        jnp.asarray(image), jnp.asarray(ctx),
                                        resident_bytes=HUGE, stream_dtype=F8)
    else:
        ref = jp.generate_offloaded(jpv.VideoSpec(**spec), 6,
                                    jnp.asarray(ctx), resident_bytes=HUGE,
                                    stream_dtype=F8)
    noise = torch.from_numpy(_flow_noise(6, tp.latent_shape(tspec)))

    def offloaded(**kw):
        if case == "i2v":
            return tp.generate_offloaded_i2v(tspec, 6, torch.from_numpy(image),
                                             torch.from_numpy(ctx), **kw)
        return tp.generate_offloaded(tspec, 6, torch.from_numpy(ctx), **kw)

    out = offloaded(resident_bytes=HUGE, stream_dtype=F8, noise=noise)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    if case == "moe":
        assert 0 < tp._expert_split(torch.tensor(
            np.asarray(jpv.sigmas_flow(4, 1.0)))) < 4
        assert tp._offload.experts() == {"low"}
        assert tp.timings["calls"] == {"high": 2, "low": 6}
    pooled = torch.zeros(1, 16)
    if case == "i2v":
        dp = tp.generate_i2v(tspec, 6, torch.from_numpy(image),
                             torch.from_numpy(ctx), pooled)
    else:
        dp = tp.generate(tspec, 6, torch.from_numpy(ctx), pooled)
    native = offloaded(stream_dtype="native")
    torch.testing.assert_close(native, dp, atol=TOL, rtol=TOL)
    assert torch.equal(offloaded(stream_dtype="native", resident_bytes=0),
                       native)


# --- refusals, knobs, interrupts, release -----------------------------------------------


@pytest.fixture(scope="module")
def offload_registry():
    return ModelRegistry("cpu", seed=0, offload=True)


def test_refusals_come_before_any_build(flux_pair, video_pair, monkeypatch):
    _, _, _, _, _, tp, (_, _, ctx, pooled, _) = flux_pair
    _, vp = _video_pipes(video_pair, "t2v")
    built = []
    for cls in (toff.OffloadedFlux, toff.OffloadedWan):
        monkeypatch.setattr(cls, "_build", lambda *a, **k: built.append(1))
    c, p = _t(ctx, pooled)
    with pytest.raises(ValueError, match="batch 1"):
        tp.generate_offloaded(tflow.FlowSpec(height=16, width=16,
                                             per_device_batch=2), 0, c, p)
    with pytest.raises(ValueError, match="batch 1"):
        tp.generate_offloaded(tflow.FlowSpec(height=16, width=16), 0,
                              c.expand(2, -1, -1), p)
    with pytest.raises(ValueError, match="true CFG"):
        tp.generate_offloaded(tflow.FlowSpec(height=16, width=16, cfg=4.0),
                              0, c, p)
    vctx = torch.from_numpy(video_pair["ctx"])
    with pytest.raises(ValueError, match="batch 1"):
        vp.generate_offloaded(tpv.VideoSpec(frames=5, height=16, width=16),
                              0, vctx.expand(2, -1, -1))
    with pytest.raises(ValueError, match="batch 1"):
        vp.generate_offloaded_i2v(tpv.VideoSpec(frames=5, height=16, width=16),
                                  0, torch.zeros(2, 16, 16, 3), vctx)
    monkeypatch.setenv("CDT_OFFLOAD_LADDER", "step")
    with pytest.raises(ValueError, match="euler only"):
        tp.generate_offloaded(tflow.FlowSpec(height=16, width=16,
                                             sampler="dpmpp_2m"), 0, c, p)
    with pytest.raises(ValueError, match="euler only"):
        vp.generate_offloaded(tpv.VideoSpec(frames=5, height=16, width=16,
                                            sampler="dpmpp_2m"), 0, vctx)
    assert not built


def test_streamed_ladder_is_euler_only_and_resident_runs_any(flux_pair):
    _, _, _, _, _, tp, (_, _, ctx, pooled, _) = flux_pair
    spec = tflow.FlowSpec(height=16, width=16, steps=2, sampler="dpmpp_2m")
    with pytest.raises(ValueError, match="euler only"):
        tp.generate_offloaded(spec, 1, *_t(ctx, pooled), resident_bytes=0,
                              stream_dtype="native")
    out = tp.generate_offloaded(spec, 1, *_t(ctx, pooled),
                                stream_dtype="native")
    torch.testing.assert_close(out, tp.generate(spec, 1, *_t(ctx, pooled)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,want", [
    ("CDT_OFFLOAD", None), ("CDT_OFFLOAD_RESIDENT_GB", 13 * (1 << 30)),
    ("CDT_OFFLOAD_STREAM_DTYPE", F8), ("CDT_OFFLOAD_LADDER", "jit"),
    ("CDT_OFFLOAD_CACHE_DIR", None)])
def test_knob_defaults_and_garbage(monkeypatch, name, want):
    read = {"CDT_OFFLOAD": lambda: toff.constants.offload(),
            "CDT_OFFLOAD_RESIDENT_GB": toff.resident_budget_bytes,
            "CDT_OFFLOAD_STREAM_DTYPE": toff.stream_dtype_default,
            "CDT_OFFLOAD_LADDER": toff.ladder_mode,
            "CDT_OFFLOAD_CACHE_DIR": toff.quant_cache_dir}[name]
    assert read() == want
    if name == "CDT_OFFLOAD_CACHE_DIR":
        monkeypatch.setenv(name, "/some/dir")
        assert read() == "/some/dir"
        return
    monkeypatch.setenv(name, "int4-bogus")
    with pytest.raises(KnobError, match=name):
        read()


@pytest.mark.parametrize("spelling", ["fp8", "f8", "float8", F8, "native",
                                      "bfloat16", "bf16", "exact"])
def test_stream_dtype_spellings_are_jax(monkeypatch, spelling):
    assert toff.normalize_stream_dtype(spelling) == \
        joff.normalize_stream_dtype(spelling)
    monkeypatch.setenv("CDT_OFFLOAD_STREAM_DTYPE", spelling)
    assert toff.stream_dtype_default() == joff.normalize_stream_dtype(spelling)
    monkeypatch.setenv("CDT_OFFLOAD", "1")
    assert toff.offload_enabled() is True


def test_interrupt_between_steps():
    calls = []

    def den(x, s):
        calls.append(1)
        return x * 0.5

    with pytest.raises(InterruptedError, match="interrupted at step 2/6"):
        toff.sample_ladder("euler", den, torch.ones(1, 4, 4, 2),
                           tflow.sigmas_flow(6, 1.0),
                           should_stop=lambda: len(calls) >= 2)
    assert len(calls) == 2


@pytest.mark.parametrize("sampler", ["euler", "euler_ancestral", "dpmpp_2m",
                                     "dpmpp_2m_sde"])
def test_one_ladder_is_samplers_sample_bitwise(sampler):
    """``sample_ladder``, a step at a time with a stop check, equals
    ``samplers.sample`` bit for bit, the ancestral draws included."""
    from comfyui_distributed_tpu_torch.diffusion.samplers import sample
    from comfyui_distributed_tpu_torch.parallel.rng import step_noise

    sig = tflow.sigmas_flow(6, 1.0)
    x = torch.randn(1, 4, 4, 2, generator=torch.Generator().manual_seed(2))

    def den(a, s):
        return a * 0.6 + s * 0.1

    want = sample(sampler, den, x, sig, step_noise(4, torch.device("cpu")))
    got = toff.sample_ladder(sampler, den, x, sig,
                             step_noise(4, torch.device("cpu")),
                             should_stop=lambda: False)
    assert torch.equal(got, want)


def test_interrupt_at_the_expert_boundary(video_pair):
    """A stop set during the high segment's last step raises at the
    boundary, before the low expert is built; the high store is not
    released by the stop."""
    _, tp = _video_pipes(video_pair, "moe")
    with pytest.raises(InterruptedError, match="expert boundary"):
        tp.generate_offloaded(tpv.VideoSpec(**VIDEO_CASES["moe"]), 3,
                              torch.from_numpy(video_pair["ctx"]),
                              should_stop=lambda: tp.timings["calls"].get(
                                  "high", 0) >= 2)
    assert tp._offload.experts() == {"high"}
    assert tp.timings["calls"] == {"high": 2}


def test_release_store(wan_pair):
    port = wan_pair[2]
    for budget in (HUGE, 0):
        off = toff.OffloadedWan(port, resident_bytes=budget)
        assert off.store_bytes() > 0 or off.streamed
        off.forward(*_t(*wan_pair[3]))
        off.release()
        assert off.released and not (off.stacked or off.resident
                                      or off.streamed)
        assert off.store_bytes() == 0
        with pytest.raises(RuntimeError, match="released"):
            off.forward(*_t(*wan_pair[3]))


def test_drawn_blocks_equal_the_resident_bundle():
    """An offload bundle's blocks, drawn again from their generator
    states, its glue and its VAE equal the resident bundle's of the same
    preset and seed; its blocks sit on ``meta``."""
    for name in ("flux-tiny", "wan-2.2-tiny", "wan-i2v-tiny"):
        res = ModelBundle(PRESETS[name], device="cpu", seed=3)
        off = ModelBundle(PRESETS[name], device="cpu", seed=3, offload=True)
        assert off.offload and not res.offload
        pipe = off.pipeline
        sources = ({"high": pipe.offload_source}
                   if isinstance(pipe, tflow.FlowPipeline)
                   else pipe.offload_sources)
        cores = {"high": res.core, "low": getattr(res.pipeline, "dit_low",
                                                  None)}
        for which, src in sources.items():
            want = dict(cores[which].named_parameters())
            for block in src.states:
                assert next(getattr(src.core, block).parameters()).is_meta
                got = src.block_params(block, "cpu")
                for k, v in got.items():
                    assert torch.equal(v, want[f"{block}.{k}"]), (name, k)
                src.done(block)
            for k, v in src.core.named_parameters():
                if not v.is_meta:
                    assert torch.equal(v, want[k]), (name, k)
        for a, b in zip(off.pipeline.vae.parameters(),
                        res.pipeline.vae.parameters()):
            assert torch.equal(a, b)
    assert not ModelBundle(PRESETS["sd3-tiny"], device="cpu",
                           offload=True).offload


def test_file_backed_offload_bundle_reads_its_core_from_the_host(tmp_path):
    """A converted bundle loaded by an offload registry keeps its
    transformer on the host (``core_home``) and runs offloaded from its
    parameters: ``native`` gives the resident bundle's image."""
    ModelBundle(PRESETS["flux-tiny"], device="cpu", seed=5).save_checkpoint(
        tmp_path / "flux-tiny")
    res = ModelRegistry("cpu", seed=0, checkpoint_root=tmp_path).get(
        "flux-tiny")
    off = ModelRegistry("cpu", seed=0, checkpoint_root=tmp_path,
                        offload=True).get("flux-tiny")
    pipe = off.pipeline
    assert off.offload and pipe.offload_source is None
    assert pipe.offload_device == torch.device("cpu")
    ctx, pooled = res.text_encoder.encode(["from a file"])
    spec = tflow.FlowSpec(height=16, width=16, steps=2)
    got = pipe.generate_offloaded(spec, 3, ctx, pooled, stream_dtype="native")
    assert torch.equal(got, res.pipeline.generate(spec, 3, ctx, pooled))


@pytest.mark.filterwarnings("ignore:.*to a meta parameter")
@pytest.mark.parametrize("name", ["flux-tiny", "wan-2.2-tiny"])
def test_file_backed_offload_core_never_lands_on_the_bundle_device(
        tmp_path, monkeypatch, name):
    """``core_home`` is host memory for a checkpoint-backed offload
    bundle and the bundle's device otherwise; the registry allocates and
    loads the transformer(s) there and never moves them. Here the home is
    swapped for ``meta`` to tell it from the CPU bundle's device."""
    from comfyui_distributed_tpu_torch.models import registry as treg

    cuda = torch.device("cuda")
    assert treg.core_home(cuda, True, True) == torch.device("cpu")
    assert treg.core_home(cuda, False, True) == cuda
    assert treg.core_home(cuda, True, False) == cuda
    ModelBundle(PRESETS[name], device="cpu", seed=5).save_checkpoint(
        tmp_path / name)
    monkeypatch.setattr(treg, "core_home", lambda device, offload, empty:
                        torch.device("meta") if offload and empty else device)
    bundle = ModelRegistry("cpu", seed=0, checkpoint_root=tmp_path,
                           offload=True).get(name)
    cores = [bundle.core, getattr(bundle.pipeline, "dit_low", None)]
    assert all(p.is_meta for core in cores if core is not None
               for p in core.parameters())
    assert bundle.pipeline.offload_device == torch.device("cpu")
    assert not any(p.is_meta for p in bundle.pipeline.vae.parameters())


def test_residency_counts_and_eviction_releases_the_store(offload_registry):
    from comfyui_distributed_tpu_torch.cluster.residency import (
        BundleResidency, bundle_bytes)

    registry = ModelRegistry("cpu", seed=0, offload=True)
    bundle = registry.get("flux-tiny")
    params = sum(p.numel() * p.element_size()
                 for m in bundle.device_modules() for p in m.parameters()
                 if not p.is_meta)
    planned = bundle.offload_planned_bytes()
    assert planned > 0 and bundle_bytes(bundle) == params + planned
    ctx, pooled = bundle.text_encoder.encode(["a"])
    bundle.pipeline.generate_offloaded(tflow.FlowSpec(height=16, width=16,
                                                      steps=1), 0, ctx, pooled)
    store = bundle.pipeline.offload_stores()[0]
    assert store.store_bytes() == planned
    registry.residency = BundleResidency(registry, bundle_bytes(bundle) + 1)
    registry.residency.note_use("flux-tiny", bundle)
    registry.get("wan-tiny")             # over the budget: flux-tiny goes
    assert store.released and bundle.released
    assert "flux-tiny" not in registry._cache


# --- the quant cache ----------------------------------------------------------------


@pytest.fixture
def counted_packs(monkeypatch):
    calls = []
    real = toff.pack_block
    monkeypatch.setattr(toff, "pack_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_quant_cache_cold_then_warm(flux_pair, tmp_path, monkeypatch,
                                    counted_packs):
    dit, inputs = flux_pair[4], flux_pair[6]
    monkeypatch.setenv("CDT_OFFLOAD_CACHE_DIR", str(tmp_path))
    cold = toff.OffloadedFlux(dit, resident_bytes=HUGE)
    assert len(counted_packs) == 4
    assert list(tmp_path.glob("torch/*/manifest.json"))
    assert list(tmp_path.glob("torch/*/double_0.float8_e4m3fn.npy"))
    warm = toff.OffloadedFlux(dit, resident_bytes=0)
    assert len(counted_packs) == 4, "a warm build quantised again"
    assert torch.equal(warm.forward(*_t(*inputs)), cold.forward(*_t(*inputs)))


def test_quant_cache_stale_corrupt_garbled(flux_pair, tmp_path, monkeypatch,
                                          counted_packs):
    dit, inputs = flux_pair[4], flux_pair[6]
    monkeypatch.setenv("CDT_OFFLOAD_CACHE_DIR", str(tmp_path))
    want = toff.OffloadedFlux(dit, resident_bytes=HUGE).forward(*_t(*inputs))
    # other weights of the same shapes: another fingerprint, another dir
    other = tdit.DiT(dit.config).eval().requires_grad_(False)
    other.load_state_dict({k: v * 1.5 if v.ndim >= 2 else v
                           for k, v in dit.state_dict().items()})
    toff.OffloadedFlux(other, resident_bytes=HUGE)
    assert len(list(tmp_path.glob("torch/*/manifest.json"))) == 2
    assert len(counted_packs) == 8
    for entry in tmp_path.glob("torch/*/single_1.scale.npy"):
        entry.write_bytes(b"not an array")
    got = toff.OffloadedFlux(dit, resident_bytes=HUGE).forward(*_t(*inputs))
    assert torch.equal(got, want)
    assert len(counted_packs) == 9          # only the unreadable block
    for m in tmp_path.glob("torch/*/manifest.json"):
        m.write_text(json.dumps({"fingerprint": "x", "layouts": [1, 2]}))
    got = toff.OffloadedFlux(dit, resident_bytes=HUGE).forward(*_t(*inputs))
    assert torch.equal(got, want)
    assert len(counted_packs) == 13         # quantised again, rewritten


def test_quant_cache_unwritable_or_off(flux_pair, tmp_path, monkeypatch,
                                       counted_packs):
    """Without ``CDT_OFFLOAD_CACHE_DIR`` no cache is opened; a directory
    that cannot be made opens none and the build goes on, quantising."""
    dit, inputs = flux_pair[4], flux_pair[6]
    opened = []
    real = toff._open_quant_cache
    monkeypatch.setattr(toff, "_open_quant_cache",
                        lambda *a: opened.append(real(*a)) or opened[-1])
    want = toff.OffloadedFlux(dit, resident_bytes=HUGE).forward(*_t(*inputs))
    assert opened == [] and len(counted_packs) == 4
    blocker = tmp_path / "a-file"
    blocker.write_text("x")
    monkeypatch.setenv("CDT_OFFLOAD_CACHE_DIR", str(blocker / "cache"))
    got = toff.OffloadedFlux(dit, resident_bytes=HUGE).forward(*_t(*inputs))
    assert opened == [None] and len(counted_packs) == 8
    assert torch.equal(got, want)


# --- the nodes through GraphExecutor ----------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _flux_prompt(**sampler):
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    prompt = strip_meta(json.loads((ROOT / "workflows" / "flux-txt2img.json")
                                   .read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "flux-tiny"
    prompt["4"]["inputs"].update(width=16, height=16, steps=3, **sampler)
    return prompt


@pytest.mark.parametrize("how", ["mode", "knob"])
def test_flux_node_offloaded_with_progress(tmp_path, monkeypatch, how,
                                           offload_registry):
    from comfyui_distributed_tpu_torch.cluster.progress import ProgressTracker
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    tracker = ProgressTracker()
    reg = ModelRegistry("cpu", seed=0)
    ctx = {"model_registry": reg, "output_dir": str(tmp_path),
           "progress_tracker": tracker, "prompt_id": "p1"}
    dp = GraphExecutor(dict(ctx, prompt_id="p0")).execute(
        _flux_prompt())["5"][0]
    if how == "knob":
        monkeypatch.setenv("CDT_OFFLOAD", "1")
        prompt = _flux_prompt()
    else:
        prompt = _flux_prompt(mode="offload")
    monkeypatch.setenv("CDT_OFFLOAD_STREAM_DTYPE", "native")
    out = GraphExecutor(ctx).execute(prompt)["5"][0]
    torch.testing.assert_close(out, dp, atol=TOL, rtol=TOL)
    state = tracker.snapshot("p1")
    assert (state["step"], state["total"], state["done"]) == (3, 3, True)
    assert reg.get("flux-tiny").pipeline.offload_stores()


def test_offload_registry_serves_dp_requests_offloaded(tmp_path,
                                                        offload_registry):
    """A bundle built for offload runs a ``dp`` request offloaded (its
    bf16 blocks never exist whole), fp8 by default."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    out = GraphExecutor({"model_registry": offload_registry,
                         "output_dir": str(tmp_path)}).execute(
        _flux_prompt())["5"][0]
    bundle = offload_registry.get("flux-tiny")
    assert bundle.offload
    (store,) = bundle.pipeline.offload_stores()
    assert store.stream_dtype == F8 and store.stacked
    dp = GraphExecutor({"model_registry": ModelRegistry("cpu", seed=0),
                        "output_dir": str(tmp_path)}).execute(
        _flux_prompt())["5"][0]
    assert out.shape == dp.shape and (out - dp).abs().max() < 0.25


@pytest.mark.parametrize("ladder", ["step", "jit"])
def test_node_interrupt_mid_offload(monkeypatch, ladder):
    """The interrupt stops the offloaded ladder between steps in either
    ``CDT_OFFLOAD_LADDER`` mode."""
    from comfyui_distributed_tpu_torch.graph.nodes_builtin import TPUFlowTxt2Img

    monkeypatch.setenv("CDT_OFFLOAD_LADDER", ladder)
    bundle = ModelBundle(PRESETS["flux-tiny"], device="cpu")
    ctx, pooled = bundle.text_encoder.encode(["stop me"])
    ev = threading.Event()
    ev.set()
    with pytest.raises(InterruptedError, match="at step 0/3"):
        TPUFlowTxt2Img().execute(bundle, {"context": ctx, "pooled": pooled},
                                 seed=1, steps=3, width=16, height=16,
                                 mode="offload", interrupt_event=ev)


@pytest.mark.parametrize("workflow,name", [("wan-t2v.json", "wan-2.2-tiny"),
                                           ("wan-i2v.json", "wan-i2v-tiny")])
def test_video_workflows_offloaded_through_the_executor(tmp_path, monkeypatch,
                                                        workflow, name):
    """The WAN workflows under ``CDT_OFFLOAD=1`` on an offload registry:
    progress to n/n, and with ``native`` blocks the frames of the resident
    registry's ``dp`` run."""
    from comfyui_distributed_tpu_torch.cluster.progress import ProgressTracker
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.utils.image import encode_png

    prompt = strip_meta(json.loads((ROOT / "workflows" / workflow)
                                   .read_text()))
    sampler = next(n for n in prompt.values()
                   if n["class_type"] in ("TPUTxt2Video", "TPUImg2Video"))
    sampler["inputs"].update(frames=5, steps=2)
    if "width" in sampler["inputs"]:
        sampler["inputs"].update(width=16, height=16)
    for node in prompt.values():
        if node["class_type"] == "CheckpointLoader":
            node["inputs"]["ckpt_name"] = name
    keep = {nid for nid, n in prompt.items()
            if n["class_type"] in ("CheckpointLoader", "CLIPTextEncode",
                                   "LoadImage", "DistributedSeed",
                                   "TPUTxt2Video", "TPUImg2Video")}
    prompt = {k: v for k, v in prompt.items() if k in keep}
    sid = next(k for k, n in prompt.items()
               if n["class_type"] in ("TPUTxt2Video", "TPUImg2Video"))
    inputs = tmp_path / "in"
    inputs.mkdir()
    (inputs / "start_frame.png").write_bytes(encode_png(
        np.full((16, 16, 3), 90, np.uint8)))
    base = {"output_dir": str(tmp_path), "input_dir": str(inputs)}
    dp = GraphExecutor(dict(base, model_registry=ModelRegistry(
        "cpu", seed=0))).execute(prompt)[sid][0]
    monkeypatch.setenv("CDT_OFFLOAD", "1")
    monkeypatch.setenv("CDT_OFFLOAD_STREAM_DTYPE", "native")
    tracker = ProgressTracker()
    reg = ModelRegistry("cpu", seed=0)
    assert reg.offload
    out = GraphExecutor(dict(base, model_registry=reg, prompt_id="v",
                             progress_tracker=tracker)).execute(prompt)[sid][0]
    torch.testing.assert_close(out, dp, atol=TOL, rtol=TOL)
    state = tracker.snapshot("v")
    assert (state["step"], state["total"], state["done"]) == (2, 2, True)
    with pytest.raises(ValidationError, match="A.6"):
        prompt[sid]["inputs"]["mode"] = "sp"
        GraphExecutor(dict(base, model_registry=reg)).execute(prompt)
