"""The port's WAN transformer (``models/wan.py``), its converter
(``convert.convert_wan``), ``VideoDiT`` (``models/video_dit.py``) and
``UMT5Conditioner`` against the JAX package's, on tiny fp32 modules with
seeded weights carried by ``models/from_jax.py``: the RoPE axes and token
ids exactly, each model's output within 2e-4; ``convert_wan`` on
official-layout dicts written by the port's exporter (bare and under
``model.diffusion_model.``) against JAX ``convert_wan`` (equal trees),
and the i2v-key and unconsumed-key refusals of both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.models import t5 as jt5  # noqa: E402
from comfyui_distributed_tpu.models import video_dit as jvd  # noqa: E402
from comfyui_distributed_tpu.models import wan as jwan  # noqa: E402
from comfyui_distributed_tpu_torch.models import convert as tconvert  # noqa: E402
from comfyui_distributed_tpu_torch.models import t5 as tt5  # noqa: E402
from comfyui_distributed_tpu_torch.models import video_dit as tvd  # noqa: E402
from comfyui_distributed_tpu_torch.models import wan as twan  # noqa: E402
from comfyui_distributed_tpu_torch.models.convert import ConversionError  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from test_torch_dit import break_zero_init  # noqa: E402
from torch_ckpt_fixtures import perturbed  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def wan_pair():
    """A tiny JAX WanModel (weights moved off their init) and the port's
    carrying them."""
    cfg = jwan.WanConfig.tiny()
    model, params = jwan.init_wan(cfg, jax.random.key(0), sample_fhw=(3, 4, 4),
                                  context_len=6)
    params = perturbed(_np(params), 1)
    port = load_from_jax(twan.WanModel(twan.WanConfig.tiny()), params).eval()
    return model, params, port


def _inputs(seed: int, in_channels: int = 4, text_dim: int = 32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 4, 6, in_channels)).astype(np.float32)
    t = np.array([0.9, 0.3], np.float32)
    ctx = rng.standard_normal((2, 5, text_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    return x, t, ctx, pooled


@pytest.mark.parametrize("cfg", ["tiny", "wan_14b", "wan_1_3b"])
def test_config_axes_and_ids_match_jax(cfg):
    jc, tc = getattr(jwan.WanConfig, cfg)(), getattr(twan.WanConfig, cfg)()
    ref = dataclasses.asdict(jc)
    assert {k: ref[k] for k in dataclasses.asdict(tc)} == dataclasses.asdict(tc)
    assert tc.axes_dim == jc.axes_dim and tc.head_dim == jc.head_dim
    if cfg == "wan_14b":
        assert tc.axes_dim == (44, 42, 42)
    for off in (0, 3):
        np.testing.assert_array_equal(
            twan.video_ids(3, 4, 5, frame_offset=off).numpy(),
            np.asarray(jwan.video_ids(3, 4, 5, frame_offset=off)))


def test_wan_model_matches_jax(wan_pair):
    model, params, port = wan_pair
    x, t, ctx, pooled = _inputs(2)
    ref = np.asarray(jax.jit(model.apply)(params, x, t, ctx, pooled))
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (x, t, ctx, pooled)))
    assert out.shape == ref.shape == (2, 3, 4, 6, 4) and out.dtype == torch.float32
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("prefix", ["", jwan.WAN_PREFIXED],
                         ids=["bare", "prefixed"])
def test_convert_wan_matches_jax(wan_pair, prefix):
    """The port's exporter writes the official layout; JAX's converter
    reads it back into exactly the source tree, and the port's converter
    into exactly the source module."""
    model, params, port = wan_pair
    sd = tconvert.export_wan(port, prefix)
    assert tconvert.detect_layout(sd) == "wan" and tconvert.wan_prefix_of(sd) == prefix
    jsd = {k: v.numpy() for k, v in sd.items()}
    _, template = jwan.init_wan(jwan.WanConfig.tiny(), jax.random.key(9),
                                sample_fhw=(3, 4, 4), context_len=6)
    back = jwan.convert_wan(jsd, template, jwan.WanConfig.tiny(), prefix)
    leaves = jax.tree_util.tree_leaves_with_path(back)
    src = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(leaves) == len(src)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(leaf), src[path], err_msg=str(path))
    fresh = twan.WanModel(twan.WanConfig.tiny())
    tconvert.convert_wan(sd, fresh, prefix)
    for (name, p), q in zip(port.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("extra,match", [
    ("blocks.0.cross_attn.k_img.weight", "i2v"),
    ("img_emb.proj.0.weight", "i2v"),
    ("blocks.0.extra.weight", "unconsumed"),
])
def test_convert_wan_refusals_match_jax(wan_pair, extra, match):
    _, _, port = wan_pair
    sd = dict(tconvert.export_wan(port))
    sd[extra] = torch.zeros(2)
    with pytest.raises(ConversionError, match=match):
        tconvert.convert_wan(sd, twan.WanModel(twan.WanConfig.tiny()))
    _, template = jwan.init_wan(jwan.WanConfig.tiny(), jax.random.key(9),
                                sample_fhw=(3, 4, 4), context_len=6)
    with pytest.raises(Exception, match=match):
        jwan.convert_wan({k: v.numpy() for k, v in sd.items()}, template,
                         jwan.WanConfig.tiny())


def test_wan_depth_is_read_from_a_file(wan_pair):
    _, _, port = wan_pair
    sd = tconvert.export_wan(port, jwan.WAN_PREFIXED)
    cut = {k: v for k, v in sd.items() if ".blocks.1." not in k}
    cfg = twan.WanConfig.tiny()
    assert tconvert.with_wan_depth_of(cfg, sd, jwan.WAN_PREFIXED) is cfg
    assert tconvert.with_wan_depth_of(cfg, cut, jwan.WAN_PREFIXED).num_layers == 1


def test_video_dit_matches_jax():
    cfg = dataclasses.replace(jvd.VideoDiTConfig.tiny(), dtype="float32")
    model, params = jvd.init_video_dit(cfg, jax.random.key(1), sample_fhw=(3, 4, 4),
                                       context_len=6)
    params = break_zero_init(_np(params), 2)
    tcfg = dataclasses.replace(tvd.VideoDiTConfig.tiny(), dtype="float32")
    port = load_from_jax(tvd.VideoDiT(tcfg), params).eval()
    x, t, ctx, pooled = _inputs(3)
    ref = np.asarray(jax.jit(model.apply)(params, x, t, ctx, pooled))
    with torch.no_grad():
        out = port(*(torch.from_numpy(a) for a in (x, t, ctx, pooled)))
    assert out.shape == ref.shape and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tvd.sincos_3d(3, 4, 5, 64).numpy(),
                               np.asarray(jvd.sincos_3d(3, 4, 5, 64)),
                               atol=1e-6, rtol=1e-6)
    tok = tvd.patchify_video(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jvd.patchify_video(x, 2)))
    assert torch.equal(tvd.unpatchify_video(tok, (3, 4, 6), 2, 4),
                       torch.from_numpy(x))


@pytest.mark.parametrize("name", ["wan", "wan-tiny", "wan-tiny-3d", "wan-i2v",
                                  "wan-i2v-tiny", "wan-2.2-t2v",
                                  "wan-2.2-tiny", "video-mmdit"])
def test_video_presets_match_jax(name):
    from comfyui_distributed_tpu.models import registry as jreg
    from comfyui_distributed_tpu_torch.models.registry import PRESETS

    jp, tp = jreg.PRESETS[name], PRESETS[name]
    assert tp.kind == jp.kind == "video"
    assert (tp.clip, tp.moe_boundary) == (jp.clip, jp.moe_boundary)
    assert type(tp.vae).__name__ == type(jp.vae).__name__
    for field in ("video", "vae", "text"):
        port = dataclasses.asdict(getattr(tp, field))
        ref = dataclasses.asdict(getattr(jp, field))
        assert {k: ref[k] for k in port} == port, field


@pytest.mark.parametrize("frames", [0, 1, 2, 5, 6, 17, 33, 34])
def test_frame_rule_matches_jax(frames):
    assert tvd.pad_frames_4n1(frames) == jvd.pad_frames_4n1(frames)
    assert tvd.validate_frames_4n1(frames) == jvd.validate_frames_4n1(frames)


def test_umt5_conditioner_matches_jax():
    cfg = jt5.T5Config.tiny(per_layer_rel_bias=True)
    jcond = jt5.UMT5Conditioner(jt5.T5Model(cfg).init(jax.random.key(3)), tok=None)
    jcond.t5.params = perturbed(_np(jcond.t5.params), 4)
    tcfg = tt5.UMT5Conditioner.config(tiny=True)
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(cfg).items()
                                        if k in dataclasses.asdict(tcfg)}
    cond = tt5.UMT5Conditioner(load_from_jax(tt5.T5Encoder(tcfg), jcond.t5.params)
                               .eval())
    texts = ["a red fox running through fresh snow", ""]
    ctx, pooled = cond.encode(texts)
    jctx, jpooled = jcond.encode(texts)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=TOL, rtol=TOL)
    assert pooled.shape == (2, 768) and not pooled.any()
    assert np.asarray(jpooled).shape == (2, 768)
    sig, mode = cond.token_signature(texts)
    jsig, jmode = jcond.token_signature(texts)
    assert sig == jsig and mode == jmode == "t5=hash"
    assert cond.tokenization_mode == jcond.tokenization_mode == "hash"
