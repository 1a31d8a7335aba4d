"""The port's ControlNet against the JAX package's, on the tiny preset in
fp32 with the weights carried by ``from_jax``: the residuals, the UNet's
control hook, the ``with_control`` denoiser under CFG with its hint
batch rule, a whole generation with a hint (JAX's noise handed over),
and the ControlNet nodes. Flax draws the zero convs and ``mid_out`` as
zeros, so the JAX trees get them perturbed with seeded noise first;
otherwise every comparison would be of zeros."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.diffusion.guidance import cfg_denoiser as jcfg  # noqa: E402
from comfyui_distributed_tpu.graph import nodes_builtin as jnodes  # noqa: E402
from comfyui_distributed_tpu.models import controlnet as jcn  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion.guidance import cfg_denoiser as tcfg  # noqa: E402
from comfyui_distributed_tpu_torch.graph import nodes_builtin as tnodes  # noqa: E402
from comfyui_distributed_tpu_torch.graph.node import get_node  # noqa: E402
from comfyui_distributed_tpu_torch.models import controlnet as tcn  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import carry_plan, load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry  # noqa: E402

TOL = 2e-4
CFG = dict(dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb_zero_convs(params, seed: int = 5, scale: float = 0.05):
    """The JAX ControlNet tree with its zero-initialised convs drawn from
    seeded numpy noise (flax leaves them zero)."""
    rng = np.random.default_rng(seed)

    def walk(tree, zero=False):
        out = {}
        for k, v in tree.items():
            z = zero or k.startswith("zero_") or k == "mid_out"
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, z)
            elif z:
                out[k] = (rng.standard_normal(v.shape) * scale).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(_np(params))


def to_nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def stacks():
    """JAX and port UNet, VAE and ControlNet (perturbed) with the same
    weights, the pipelines, and seeded inputs."""
    cfg = junet.UNetConfig.tiny(**CFG)
    model, uparams = junet.init_unet(cfg, jax.random.key(0),
                                     sample_shape=(8, 8, 4), context_len=16)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(**CFG)).init(
        jax.random.key(1), image_hw=(16, 16))
    jbundle = jcn.init_controlnet(cfg, jax.random.key(2), sample_shape=(8, 8, 4),
                                  context_len=16)
    jbundle.params = perturb_zero_convs(jbundle.params)
    jp = jpipe.Txt2ImgPipeline(model, uparams, vae)

    tcfg_ = tunet.UNetConfig.tiny(**CFG)
    unet = load_from_jax(tunet.UNet2D(tcfg_), _np(uparams)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(**CFG), encoder=True).eval()
    load_from_jax(tv.decoder, _np(vae.dec_params))
    load_from_jax(tv.encoder, _np(vae.enc_params))
    tcnet = load_from_jax(tcn.ControlNet(tcfg_), jbundle.params).eval()
    tbundle = tcn.ControlNetBundle(tcnet, name="tiny")
    tp = tpipe.Txt2ImgPipeline(unet, tv)

    rng = np.random.default_rng(0)
    f32 = np.float32
    inputs = dict(
        x=rng.standard_normal((2, 8, 8, 4)).astype(f32),
        t=np.array([10.0, 700.0], f32),
        ctx=rng.standard_normal((2, 16, 32)).astype(f32),
        y=rng.standard_normal((2, 8)).astype(f32),
        hint=rng.random((2, 64, 64, 3)).astype(f32))
    return dict(jp=jp, tp=tp, jbundle=jbundle, tbundle=tbundle, model=model,
                uparams=uparams, unet=unet, inputs=inputs)


def test_controlnet_residuals_match_jax(stacks):
    i = stacks["inputs"]
    jdown, jmid = stacks["jbundle"].apply(*(jnp.asarray(i[k]) for k in
                                            ("x", "t", "ctx", "y", "hint")))
    with torch.no_grad():
        down, mid = stacks["tbundle"].model(*(torch.from_numpy(i[k]) for k in
                                              ("x", "t", "ctx", "y", "hint")))
    assert len(down) == len(jdown) == 4
    for d, jd in zip(down + [mid], list(jdown) + [jmid]):
        assert d.dtype == torch.float32
        ref = to_nchw(jd)
        assert float(ref.abs().max()) > 1e-3            # not zeros
        np.testing.assert_allclose(d.numpy(), ref.numpy(), atol=TOL, rtol=TOL)


def test_controlnet_rejects_a_hint_of_other_channels(stacks):
    i = stacks["inputs"]
    with pytest.raises(ValueError, match="channels"):
        stacks["tbundle"].model(torch.from_numpy(i["x"]),
                                torch.from_numpy(i["t"]),
                                torch.from_numpy(i["ctx"]),
                                torch.from_numpy(i["y"]),
                                torch.zeros(2, 64, 64, 1))


def test_unet_control_hook_matches_jax(stacks):
    """The same residuals, NHWC to JAX and NCHW to the port."""
    i = stacks["inputs"]
    rng = np.random.default_rng(1)
    shapes = [(2, 8, 8, 32), (2, 8, 8, 32), (2, 4, 4, 32), (2, 4, 4, 64)]
    jdown = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jmid = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    args = [i[k] for k in ("x", "t", "ctx", "y")]
    ref = np.asarray(stacks["model"].apply(
        stacks["uparams"], *map(jnp.asarray, args),
        control=([jnp.asarray(d) for d in jdown], jnp.asarray(jmid))))
    plain = np.asarray(stacks["model"].apply(stacks["uparams"],
                                             *map(jnp.asarray, args)))
    with torch.no_grad():
        targs = [torch.from_numpy(a) for a in args]
        out = stacks["unet"](*targs, control=([to_nchw(d) for d in jdown],
                                              to_nchw(jmid)))
        # without control: exactly the forward it ran before the hook
        base = stacks["unet"](*targs)
        assert torch.equal(base, stacks["unet"](*targs, control=None))
    assert np.abs(ref - plain).max() > 1e-3
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(base.numpy(), plain, atol=TOL, rtol=TOL)
    with pytest.raises(AssertionError, match="skip residuals"):
        stacks["unet"](*targs, control=([to_nchw(d) for d in jdown[:3]],
                                        to_nchw(jmid)))


def test_with_control_denoiser_under_cfg_matches_jax(stacks):
    """The hint [1,...] is tiled to CFG's doubled batch, so it conditions
    both passes; residuals are scaled by the strength."""
    i = stacks["inputs"]
    jp = stacks["jp"].with_control(stacks["jbundle"], 0.7)
    tp = stacks["tp"].with_control(stacks["tbundle"], 0.7)
    hint = i["hint"][:1]
    x, ctx, y = i["x"][:1], i["ctx"][:1], i["y"][:1]
    unc, uy = i["ctx"][1:], i["y"][1:]
    jd = jcfg(lambda c, yy: jp._denoiser(c, yy, hint=jnp.asarray(hint)),
              *map(jnp.asarray, (ctx, unc)), 4.0, jnp.asarray(y), jnp.asarray(uy))
    ref = np.asarray(jd(jnp.asarray(x), jnp.asarray(2.5)))
    td = tcfg(lambda c, yy: tp._denoiser(c, yy, hint=torch.from_numpy(hint)),
              *map(torch.from_numpy, (ctx, unc)), 4.0, torch.from_numpy(y),
              torch.from_numpy(uy))
    with torch.no_grad():
        out = td(torch.from_numpy(x), torch.tensor(2.5))
        base = tcfg(stacks["tp"]._denoiser, *map(torch.from_numpy, (ctx, unc)),
                    4.0, torch.from_numpy(y), torch.from_numpy(uy))(
            torch.from_numpy(x), torch.tensor(2.5))
    assert (out - base).abs().max() > 1e-4          # control changed it
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_hint_batch_rule(stacks):
    i = stacks["inputs"]
    tp = stacks["tp"].with_control(stacks["tbundle"], 1.0)
    x = torch.from_numpy(np.concatenate([i["x"], i["x"][:1]]))     # batch 3
    ctx = torch.from_numpy(np.concatenate([i["ctx"], i["ctx"][:1]]))
    y = torch.from_numpy(np.concatenate([i["y"], i["y"][:1]]))
    with pytest.raises(ValueError, match="does not divide"):
        tp._denoiser(ctx, y, hint=torch.from_numpy(i["hint"]))(x, torch.tensor(1.0))
    with torch.no_grad():
        one = tp._denoiser(ctx, y, hint=torch.from_numpy(i["hint"][:1]))(
            x, torch.tensor(1.0))
        three = tp._denoiser(ctx, y, hint=torch.from_numpy(
            np.concatenate([i["hint"][:1]] * 3)))(x, torch.tensor(1.0))
    assert torch.equal(one, three)


def test_with_control_clones_are_memoized(stacks):
    tp, b = stacks["tp"], stacks["tbundle"]
    clone = tp.with_control(b, 0.5)
    assert tp.with_control(b, 0.5) is clone and tp._control is None
    assert clone._control == (b, 0.5) and clone.unet is tp.unet
    others = [tp.with_control(b, s) for s in (0.1, 0.2, 0.3, 0.4)]
    assert len(tp._control_clones) == 4 and tp.with_control(b, 0.5) is not clone
    assert all(o._control[1] in (0.1, 0.2, 0.3, 0.4) for o in others)


def test_control_pipeline_without_hint_raises(stacks):
    clone = stacks["tp"].with_control(stacks["tbundle"], 1.0)
    spec = tpipe.GenerationSpec(height=16, width=16, steps=1)
    z = torch.zeros(1, 16, 32)
    with pytest.raises(ValueError, match="no hint"):
        clone.generate(spec, 0, z, z)
    with pytest.raises(ValueError, match="no hint"):
        clone.img2img(spec, 0, torch.zeros(1, 16, 16, 3), z, z)


def test_generate_with_hint_matches_jax(stacks):
    i = stacks["inputs"]
    spec = dict(height=16, width=16, steps=3, guidance_scale=5.0)
    seed = 4
    hint = i["hint"][:1]
    ctx, unc, y, uy = i["ctx"][:1], i["ctx"][1:], i["y"][:1], i["y"][1:]
    ref = np.asarray(stacks["jp"].with_control(stacks["jbundle"], 0.8).generate(
        build_mesh({"dp": 1}), jpipe.GenerationSpec(**spec), seed,
        *map(jnp.asarray, (ctx, unc, y, uy)), hint=jnp.asarray(hint)))
    k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 0))
    noise = np.array(jax.random.normal(k_noise, (1, 8, 8, 4), jnp.float32))
    out = stacks["tp"].with_control(stacks["tbundle"], 0.8).sample_and_decode(
        torch.from_numpy(noise), tpipe.GenerationSpec(**spec),
        *map(torch.from_numpy, (ctx, unc, y, uy)), hint=torch.from_numpy(hint))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


# --- nodes ---------------------------------------------------------------------


def test_control_from_cond_matches_jax(stacks):
    """The hint resized bilinear to latent resolution × 8."""
    rng = np.random.default_rng(3)
    hint = rng.random((1, 20, 28, 3)).astype(np.float32)
    jpipe_, jh = jnodes._control_from_cond(
        stacks["jp"], {"control": {"model": stacks["jbundle"], "hint": hint,
                                   "strength": 0.6}}, 16, 24)
    tpipe_, th = tnodes._control_from_cond(
        stacks["tp"], {"control": {"model": stacks["tbundle"],
                                   "hint": torch.from_numpy(hint),
                                   "strength": 0.6}}, 16, 24)
    assert tuple(th.shape) == (1, 64, 96, 3) == tuple(jh.shape)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)
    assert tpipe_._control == (stacks["tbundle"], 0.6)
    assert jpipe_._control[1] == 0.6
    assert tnodes._control_from_cond(stacks["tp"], {}, 16, 16) == (stacks["tp"], None)


def test_controlnet_apply_matches_jax(stacks):
    img = np.random.default_rng(4).random((16, 16, 3)).astype(np.float32)
    cond = {"context": np.zeros((1, 16, 32), np.float32)}
    (jc,) = jnodes.ControlNetApply().execute(cond, stacks["jbundle"], img,
                                             strength=0.3)
    (tc,) = get_node("ControlNetApply")().execute(cond, stacks["tbundle"],
                                                  torch.from_numpy(img),
                                                  strength=0.3)
    assert tc["context"] is cond["context"]
    assert tc["control"]["strength"] == jc["control"]["strength"] == 0.3
    assert tc["control"]["model"] is stacks["tbundle"]
    np.testing.assert_array_equal(tc["control"]["hint"].numpy(),
                                  jc["control"]["hint"])
    assert tuple(tc["control"]["hint"].shape) == (1, 16, 16, 3)


def test_controlnet_loader_presets(tmp_path, monkeypatch):
    registry = ModelRegistry("cpu", seed=0)
    node = get_node("ControlNetLoader")()
    (a,) = node.execute("tiny", model_registry=registry)
    (b,) = node.execute("tiny", model_registry=registry)
    assert a is b and a.name == "tiny" and a.device == torch.device("cpu")
    assert isinstance(a.model, tcn.ControlNet)
    # a random-init port ControlNet is not the identity: its zero convs
    # are drawn at ZERO_CONV_SCALE of lecun-normal
    w = a.model.zero_0.weight
    assert w.dtype == torch.float32 and float(w.abs().max()) > 0
    std = float(w.float().std()) * (w[0].numel() ** 0.5)
    assert 0.5 * tcn.ZERO_CONV_SCALE < std < 1.5 * tcn.ZERO_CONV_SCALE
    (sd,) = node.execute("sd15", model_registry=registry)
    assert sd.name == "sd15" and sd.model.config == tunet.UNetConfig.sd15()
    with pytest.raises(Exception, match="unknown control net"):
        node.execute("nope", model_registry=registry)
    # a file found under CDT_CONTROLNET_DIR is loaded (a broken one
    # raises), never silently replaced by the random-init preset
    from comfyui_distributed_tpu_torch.utils.safetensors import SafetensorsError

    monkeypatch.setenv("CDT_CONTROLNET_DIR", str(tmp_path))
    (tmp_path / "tiny.safetensors").write_bytes(b"\0")
    with pytest.raises(SafetensorsError):
        node.execute("tiny", model_registry=registry)


def test_controlnet_cache_keeps_four(monkeypatch):
    monkeypatch.setitem(tcn.PRESETS, "t2", tunet.UNetConfig.tiny())
    monkeypatch.setitem(tcn.PRESETS, "t3", tunet.UNetConfig.tiny())
    monkeypatch.setitem(tcn.PRESETS, "t4", tunet.UNetConfig.tiny())
    registry = ModelRegistry("cpu", seed=0)
    first = registry.get_controlnet("tiny")
    for name in ("t2", "t3", "t4"):
        registry.get_controlnet(name)
    assert registry.get_controlnet("tiny") is first
    monkeypatch.setitem(tcn.PRESETS, "t5", tunet.UNetConfig.tiny())
    registry.get_controlnet("t5")
    assert len(registry._controlnets) == 4
    assert registry.get_controlnet("tiny") is not first


def test_sdxl_controlnet_tree_carries():
    """The full-width SDXL ControlNet: every JAX leaf (shapes only, from
    ``eval_shape``) maps onto one port parameter by path, with no rule
    beyond the UNet's."""
    cfg = junet.UNetConfig.sdxl()
    template = jnodes.ControlNetLoader._template(cfg)
    with torch.device("meta"):
        module = tcn.ControlNet(tunet.UNetConfig.sdxl())
    plan = carry_plan(template, module)
    n = sum(p.numel() for p in module.parameters())
    assert len(plan) == len(list(module.parameters()))
    assert n == sum(int(np.prod(leaf.shape)) for leaf in
                    jax.tree_util.tree_leaves(template))
    assert 1.2e9 < n < 1.3e9
    assert sum(1 for m in module.modules()
               if type(m).__name__ == "TransformerBlock") == 34


def test_txt2img_node_feeds_the_hint(stacks, monkeypatch):
    """``TPUTxt2Img`` with a ControlNetApply'd positive runs the clone with
    the resized hint; without it, the base pipeline with no hint."""
    seen = []

    def generate(self, spec, seed, ctx, unc, y=None, uy=None,
                 progress_token=None, hint=None):
        seen.append((self._control, None if hint is None else tuple(hint.shape)))
        return torch.zeros(1, spec.height, spec.width, 3)

    monkeypatch.setattr(tpipe.Txt2ImgPipeline, "generate", generate)
    model = types.SimpleNamespace(pipeline=stacks["tp"])
    cond = {"context": torch.zeros(1, 16, 32), "pooled": torch.zeros(1, 8)}
    (pos,) = get_node("ControlNetApply")().execute(
        cond, stacks["tbundle"], torch.rand(1, 10, 10, 3), strength=0.5)
    node = get_node("TPUTxt2Img")()
    node.execute(model, pos, cond, 1, 2, 5.0, width=24, height=16)
    node.execute(model, cond, cond, 1, 2, 5.0, width=24, height=16)
    (control, hint), plain = seen
    assert control[0] is stacks["tbundle"] and control[1] == 0.5
    assert hint == (1, 64, 96, 3) and plain == (None, None)
