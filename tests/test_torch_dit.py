"""The port's FLUX-class DiT (``comfyui_distributed_tpu_torch.models.dit``)
against the JAX package's: the position helpers, the qk-norm, one double
and one single block, and the whole tiny DiT with RoPE and with sincos
positions; fp32 at 2e-4.

Flax zero-initialises every adaLN ``mod`` kernel and ``img_out``, which
makes each gate 0, each block the identity and the velocity exactly 0:
fed such weights, a comparison passes whatever the port computes. Every
test here therefore replaces those kernels with seeded normals (and
moves the biases and qk-norm scales off their init) before handing the
same numpy tree to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's models need flax. Where it is missing (the card's
# machine), only the card tests of tests/test_torch_cuda.py run.
pytest.importorskip("flax")

from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402

TOL = 2e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def break_zero_init(tree, seed):
    """Numpy copy of a DiT (or block) tree with every ``mod`` and
    ``img_out`` kernel drawn from normal(0, 0.02) and every bias and
    qk-norm scale moved by the same noise."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        names = [str(getattr(k, "key", k)) for k in path]
        a = np.asarray(a, np.float32)
        noise = 0.02 * rng.standard_normal(a.shape).astype(np.float32)
        if names[-1] == "kernel" and names[-2] in ("mod", "img_out"):
            return noise
        if names[-1] in ("bias", "q_scale", "k_scale"):
            return a + noise
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _configs(**kw):
    return (jdit.DiTConfig.tiny(dtype="float32", **kw),
            tdit.DiTConfig.tiny(dtype="float32", **kw))


def test_dit_configs_match_jax():
    for jcfg, tcfg in [(jdit.DiTConfig.flux(), tdit.DiTConfig.flux()),
                       _configs(), _configs(pos_embed="rope")]:
        jfields = dataclasses.asdict(jcfg)
        assert {k: jfields[k] for k in dataclasses.asdict(tcfg)} \
            == dataclasses.asdict(tcfg)
        assert (tcfg.head_dim, tcfg.axes_dim) == (jcfg.head_dim, jcfg.axes_dim)
    flux = tdit.DiTConfig.flux()
    assert (flux.hidden, flux.heads, flux.head_dim, sum(flux.axes_dim)) \
        == (3072, 24, 128, 128)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tdit.DiTConfig.tiny(pos_embed="learned")


@pytest.mark.parametrize("h,w,dim", [(4, 6, 64), (3, 5, 30)])
def test_sincos_2d_matches_jax(h, w, dim):
    ref = np.asarray(jdit.sincos_2d(h, w, dim))
    out = tdit.sincos_2d(h, w, dim).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_image_ids_and_rope_match_jax():
    ids = tdit.image_ids(3, 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jdit.image_ids(3, 5)))
    ids = torch.cat([torch.zeros(4, 3, dtype=torch.long), ids])
    axes = tdit.DiTConfig.flux().axes_dim
    cos_ref, sin_ref = jdit.rope_freqs(jnp.asarray(ids.numpy()), axes, 10000.0)
    cos, sin = tdit.rope_freqs(ids, axes, 10000.0)
    assert cos.shape == (19, 64)
    np.testing.assert_allclose(cos.numpy(), np.asarray(cos_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(sin_ref), atol=TOL, rtol=TOL)
    x = _rand(np.random.default_rng(0), 2, 19, 3, 128)
    ref = np.asarray(jdit.apply_rope(jnp.asarray(x), (cos_ref, sin_ref)))
    out = tdit.apply_rope(_t(x), (cos, sin)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_rms_matches_jax():
    x = _rand(np.random.default_rng(1), 2, 7, 3, 16) * 3.0
    np.testing.assert_allclose(tdit._rms(_t(x)).numpy(),
                               np.asarray(jdit._rms(jnp.asarray(x))),
                               atol=TOL, rtol=TOL)


def test_patchify_and_unpatchify_match_jax():
    x = _rand(np.random.default_rng(2), 2, 8, 6, 4)
    tokens = np.asarray(jdit.patchify(jnp.asarray(x), 2))
    out = tdit.patchify(_t(x), 2)
    np.testing.assert_array_equal(out.numpy(), tokens)
    back = tdit.unpatchify(out, (8, 6), 2, 4)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jdit.unpatchify(jnp.asarray(tokens), (8, 6), 2, 4)))
    np.testing.assert_array_equal(back.numpy(), x)


def _rope_tables(cfg, h, w, T):
    ids_img = jdit.image_ids(h, w)
    pe_img = jdit.rope_freqs(ids_img, cfg.axes_dim, cfg.rope_theta)
    pe_txt = jdit.rope_freqs(jnp.zeros((T, 3), jnp.int32), cfg.axes_dim,
                             cfg.rope_theta)
    pe_full = tuple(jnp.concatenate([a, b]) for a, b in zip(pe_txt, pe_img))
    as_t = lambda pe: tuple(_t(np.asarray(a)) for a in pe)  # noqa: E731
    return (pe_img, pe_txt, pe_full), tuple(map(as_t, (pe_img, pe_txt, pe_full)))


def test_double_block_matches_jax():
    jcfg, tcfg = _configs(pos_embed="rope")
    rng = np.random.default_rng(3)
    img, txt, vec = _rand(rng, 2, 12, 64), _rand(rng, 2, 5, 64), _rand(rng, 2, 64)
    (pe_img, pe_txt, _), (tpe_img, tpe_txt, _) = _rope_tables(jcfg, 3, 4, 5)
    block = jdit.DoubleBlock(jcfg)
    params = break_zero_init(
        block.init(jax.random.key(0), img, txt, vec, None, pe_img, pe_txt), 4)
    ref_img, ref_txt = block.apply(params, img, txt, vec, None, pe_img, pe_txt)
    port = load_from_jax(tdit.DoubleBlock(tcfg), params)
    with torch.no_grad():
        out_img, out_txt = port(_t(img), _t(txt), _t(vec), tpe_img, tpe_txt)
    # the block must move both streams, or the comparison proves nothing
    assert np.abs(np.asarray(ref_img) - img).max() > 1e-2
    np.testing.assert_allclose(out_img.numpy(), np.asarray(ref_img), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out_txt.numpy(), np.asarray(ref_txt), atol=TOL, rtol=TOL)


def test_single_block_matches_jax():
    jcfg, tcfg = _configs(pos_embed="rope")
    rng = np.random.default_rng(5)
    x, vec = _rand(rng, 2, 17, 64), _rand(rng, 2, 64)
    (_, _, pe_full), (_, _, tpe_full) = _rope_tables(jcfg, 3, 4, 5)
    block = jdit.SingleBlock(jcfg)
    params = break_zero_init(
        block.init(jax.random.key(1), x, vec, 5, None, pe_full), 6)
    ref = np.asarray(block.apply(params, x, vec, 5, None, pe_full))
    port = load_from_jax(tdit.SingleBlock(tcfg), params)
    with torch.no_grad():
        out = port(_t(x), _t(vec), tpe_full)
    assert np.abs(ref - x).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def _tiny_pair(pos_embed, seed=0):
    jcfg, tcfg = _configs(pos_embed=pos_embed)
    model, params = jdit.init_dit(jcfg, jax.random.key(seed), sample_hw=(8, 8),
                                  context_len=16)
    params = break_zero_init(params, seed + 10)
    return model, params, load_from_jax(tdit.DiT(tcfg), params).eval()


def _dit_inputs(seed, B=2, h=8, w=6, T=16):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, h, w, 4), np.array([0.93, 0.21], np.float32)[:B],
            _rand(rng, B, T, 32), _rand(rng, B, 16),
            np.array([3.5, 1.0], np.float32)[:B])


@pytest.mark.parametrize("pos_embed", ["rope", "sincos"])
def test_tiny_dit_matches_jax(pos_embed):
    model, params, port = _tiny_pair(pos_embed)
    args = _dit_inputs(7)
    ref = np.asarray(model.apply(params, *args))
    with torch.no_grad():
        out = port(*map(_t, args))
    assert out.shape == (2, 8, 6, 4) and out.dtype == torch.float32
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_jax_random_init_velocity_is_zero():
    """The trap the tests above avoid: flax's own init gives v ≡ 0."""
    jcfg, _ = _configs()
    model, params = jdit.init_dit(jcfg, jax.random.key(0), sample_hw=(8, 8),
                                  context_len=16)
    assert np.abs(np.asarray(model.apply(params, *_dit_inputs(8)))).max() == 0.0


def test_port_random_init_velocity_is_nonzero():
    """The port draws ``mod`` and ``img_out`` lecun-normal (on purpose,
    unlike flax), so a random-init DiT moves the latent and depends on
    every block."""
    from comfyui_distributed_tpu_torch.models.registry import PRESETS, ModelBundle

    preset = dataclasses.replace(PRESETS["flux-tiny"],
                                 dit=tdit.DiTConfig.tiny(dtype="float32"))
    dit = ModelBundle(preset, device="cpu", seed=0).pipeline.dit
    args = [_t(a) for a in _dit_inputs(9)]
    with torch.no_grad():
        v = dit(*args)
        dit.single_1.out.weight.mul_(2.0)
        v2 = dit(*args)
    assert torch.isfinite(v).all() and v.abs().max() > 1e-2
    assert (v - v2).abs().max() > 1e-4
    assert torch.equal(dit.double_0.img_qkv.q_scale, torch.ones(16))
