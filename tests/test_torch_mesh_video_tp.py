"""Video tensor parallelism: the port's ``video_tp`` program on CPU ranks
over gloo against the JAX package's ``generate_tp_fn`` on its virtual
devices, JAX's noise handed over (2e-4, JAX's contract): ``wan-tiny``,
``wan-2.2-tiny`` (both experts split) and the tiny video-MMDiT (the image
DiT's rules) on ``{"dp": 1, "tp": 2}``, and
one ``{"dp": 2, "tp": 2}`` case on four ranks; the WAN units' plan
against JAX's ``spec_for_param``; the qk-norm over the full width with
tp-summed statistics (ranks as threads of this process over gloo)
against the whole-width norm, and the whole sharded forward against the
unsharded one; a follower's drawn two-expert shard equal to the slices
of the whole bundle, one ``ShardBundle``, the whole bundle dropped
first; the shard's bytes against the planner's."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline_video as jpv  # noqa: E402
from comfyui_distributed_tpu.models import vae as jimg  # noqa: E402
from comfyui_distributed_tpu.models import wan as jwan  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh as jbuild_mesh  # noqa: E402
from comfyui_distributed_tpu.parallel import tensor as jtensor  # noqa: E402
from comfyui_distributed_tpu_torch.cluster import residency as tres  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_video as tpv  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as timg  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import carry_plan, load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry, ShardBundle  # noqa: E402
from comfyui_distributed_tpu_torch.models.wan import WanModel, WanRMSNorm  # noqa: E402
from comfyui_distributed_tpu_torch.parallel import tensor as ttensor  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.bootstrap import MeshRuntime  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.programs import param_digest_of  # noqa: E402

from test_torch_mesh_video import _mmdit, _t, spmd  # noqa: E402
from test_torch_video_pipeline import _conditioning, _np, _wan  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
CPU = torch.device("cpu")
SPEC = dict(frames=5, height=16, width=16, shift=3.0, guidance_scale=4.0)


def _runtime(axes: dict, tmp_path_factory):
    import os

    os.environ["CDT_LOG_DIR"] = str(tmp_path_factory.mktemp("tp_logs"))
    m = build_mesh(axes, int(np.prod(list(axes.values()))), CPU)
    m.runtime = MeshRuntime(m, seed=0)
    return m


@pytest.fixture(scope="module")
def mesh(cpu_share, tmp_path_factory):
    """Rank 0's ``{"dp": 1, "tp": 2}`` mesh over two CPU ranks."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    m = _runtime({"dp": 1, "tp": 2}, tmp_path_factory)
    yield m
    m.runtime.stop()
    if old is None:
        os.environ.pop("CDT_LOG_DIR", None)
    else:
        os.environ["CDT_LOG_DIR"] = old


def _image_vae():
    jv = jimg.AutoencoderKL(jimg.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(4), image_hw=(16, 16))
    tv = timg.AutoencoderKL(timg.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, _np(jv.dec_params))
    return jv, tv.eval()


def _pair(two: bool, mmdit: bool = False):
    """(JAX pipeline, port pipeline): ``wan-tiny``'s shape, or
    ``wan-2.2-tiny``'s two experts split at 0.875, or the tiny
    video-MMDiT (split by the image DiT's rules), the image VAE."""
    jv, tv = _image_vae()
    model, params, hi = _mmdit(2) if mmdit else _wan(2)
    if not two:
        return (jpv.VideoPipeline(model, params, jv),
                tpv.VideoPipeline(hi, tv))
    _, lo_params, lo = _wan(3)
    return (jpv.VideoPipeline(model, params, jv, dit_params_low=lo_params,
                              expert_boundary=0.875),
            tpv.VideoPipeline(hi, tv, lo, 0.875))


# --- the plan -------------------------------------------------------------------


def test_wan_units_and_plan_as_jax_specs():
    """Every parameter JAX's WAN rules split is split on the same dim (the
    ``[out, in]`` transpose); the plan adds the column biases and the
    qk-norm scales, which JAX's GSPMD layout leaves whole."""
    _, jtree = jwan.init_wan(jwan.WanConfig.tiny(), jax.random.key(0),
                             abstract=True)
    core = ModelRegistry("cpu", seed=0).get("wan-tiny").core
    leaves = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    jleaf = {jtensor._path_str(path).removeprefix("params/"): leaf
             for path, leaf in leaves.items()}
    cplan = carry_plan(jtree, core)
    plan = ttensor.shard_plan(core, 2)
    split = set()
    for name, p in core.named_parameters():
        jpath = "/".join(cplan[name][0])
        jspec = tuple(jtensor.spec_for_param(jpath, jleaf[jpath].shape,
                                             jtensor.WAN_TP_RULES, "tp", 2))
        if jspec:
            split.add(name)
            assert plan[name][0] == 1 - jspec.index("tp"), name
    extra = set(plan) - split
    assert extra == {n for n in dict(core.named_parameters())
                     if n.endswith(("norm_q.weight", "norm_k.weight"))
                     or (n.endswith(".bias") and n[:-5] + ".weight" in plan
                         and plan[n[:-5] + ".weight"][0] == 0)}
    layers = core.config.num_layers
    assert len(split) == layers * 10
    units = [n for n, _ in ttensor.tp_units(core)]
    assert units == [u for i in range(layers) for u in (
        f"block_{i}", f"block_{i}.self_attn", f"block_{i}.cross_attn")]
    # at 3 ranks the 4 heads do not divide: the attention sites stay
    # whole, the feed-forward splits
    assert {n.split(".", 1)[1] for n in ttensor.shard_plan(core, 3)} == {
        "ffn_0.weight", "ffn_0.bias", "ffn_2.weight"}


def test_qk_norm_sums_its_statistics_over_the_tp_axis():
    """A rank's columns normalised by the full width's RMS (the fp32 sums
    of squares summed over the axis) are the whole norm's columns; by
    their own RMS they are not."""
    rng = np.random.default_rng(0)
    norm = WanRMSNorm(48, 1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(
            rng.uniform(0.5, 1.5, 48).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 5, 48)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        with torch.no_grad():
            whole = norm(xd)

        def rank(r):
            shard = WanRMSNorm(48, 1e-6)
            shard.weight = torch.nn.Parameter(norm.weight[24 * r:24 * (r + 1)])
            shard.tp_axis = "tp"
            return shard(xd[..., 24 * r:24 * (r + 1)])

        got = torch.cat(spmd({"tp": 2}, rank), dim=-1)
        assert got.dtype == dtype
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got, whole, atol=tol, rtol=tol)
    own = WanRMSNorm(24, 1e-6)
    with torch.no_grad():
        own.weight.copy_(norm.weight[:24])
        assert not torch.allclose(own(x[..., :24]), norm(x)[..., :24],
                                  atol=1e-3)


def test_the_sharded_forward_is_the_whole_forward():
    """Each rank's shard (its heads, its feed-forward slice, the norm's
    statistics summed, the row-parallel biases once, the gates after
    the sum) computes the whole model's velocity."""
    _, _, core = _wan(5)
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32))
    t = _t(np.array([0.3, 0.7], np.float32))
    ctx = _t(rng.standard_normal((2, 5, 32)).astype(np.float32))
    with torch.no_grad():
        whole = core(x, t, ctx)
    shards = [ttensor.shard_module(core, r, 2) for r in range(2)]
    outs = spmd({"tp": 2}, lambda r: shards[r](x, t, ctx))
    for out in outs:
        torch.testing.assert_close(out, whole, atol=TOL, rtol=TOL)
    assert shards[1].block_0.self_attn.heads == 2
    assert shards[1].block_0.self_attn.norm_q.weight.shape == (24,)


# --- video_tp against JAX ---------------------------------------------------------


@pytest.mark.parametrize("two,mmdit", [(False, False), (True, False),
                                       (False, True)],
                         ids=["wan-tiny", "wan-2.2-tiny", "video-mmdit"])
def test_video_tp_matches_jax(mesh, two, mmdit):
    jp, tp = _pair(two, mmdit)
    steps = 4 if two else 2
    spec = dict(SPEC, steps=steps)
    seed = 17
    ctx, pooled = _conditioning(3)
    jm = jbuild_mesh({"dp": 1, "tp": 2}, jax.devices()[:2])
    ref = np.asarray(jp.generate_tp_fn(jm, jpv.VideoSpec(**spec))(
        jax.random.key(seed), ctx, pooled))
    shape = tp.latent_shape(tpv.VideoSpec(**spec))[1:]
    noise = jax.random.normal(jax.random.fold_in(jax.random.key(seed), 0),
                              shape, jnp.float32)[None]
    out = mesh.runtime.run("video_tp", types.SimpleNamespace(pipeline=tp),
                           tpv.VideoSpec(**spec), seed, _t(ctx), _t(pooled),
                           noises=[_t(noise)])
    assert out.shape == ref.shape == (1, 5, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    ranks = mesh.runtime.last_call["ranks"]
    assert [r["program"] for r in ranks] == ["video_tp"] * 2
    want = {"high": 2, "low": 2} if two else {"high": 2}
    assert [r["calls"] for r in ranks] == [want] * 2
    assert ranks[0]["shard_bytes"] == ranks[1]["shard_bytes"] > 0
    held = tp._tp_shards[(0, 2, "tp")]
    assert (held.dit_low is not None) == two
    # the one-rank run of the same noise
    one = tp.sample_and_decode(_t(noise), tpv.VideoSpec(**spec), _t(ctx),
                               _t(pooled))
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=TOL, rtol=TOL)


def test_video_tp_on_four_ranks_matches_jax(tmp_path_factory):
    """``{"dp": 2, "tp": 2}``: two participants, each over its own tp
    pair; the tp-index-0 ranks decode and gather."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    mesh4 = _runtime({"dp": 2, "tp": 2}, tmp_path_factory)
    try:
        jp, tp = _pair(False)
        spec = dict(SPEC, steps=2)
        seed = 19
        ctx, pooled = _conditioning(4)
        jm = jbuild_mesh({"dp": 2, "tp": 2}, jax.devices()[:4])
        ref = np.asarray(jp.generate_tp_fn(jm, jpv.VideoSpec(**spec))(
            jax.random.key(seed), ctx, pooled))
        shape = tp.latent_shape(tpv.VideoSpec(**spec))[1:]
        noises = [_t(jax.random.normal(
            jax.random.fold_in(jax.random.key(seed), i), shape,
            jnp.float32)[None]) for i in range(2)]
        out = mesh4.runtime.run("video_tp",
                                types.SimpleNamespace(pipeline=tp),
                                tpv.VideoSpec(**spec), seed, _t(ctx),
                                _t(pooled), noises=noises)
        assert out.shape == ref.shape == (2, 5, 16, 16, 3)
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    finally:
        mesh4.runtime.stop()
        if old is None:
            os.environ.pop("CDT_LOG_DIR", None)
        else:
            os.environ["CDT_LOG_DIR"] = old


# --- a follower's shard ---------------------------------------------------------------


def test_a_drawn_two_expert_shard_is_the_slices_of_the_whole():
    """A follower draws both experts' shards from the seed, part by part,
    into one ``ShardBundle``; every parameter is the slice of the whole
    bundle's, the VAE the whole one's; a follower holding the whole
    bundle (an earlier ``dp`` call's) drops it before it draws."""
    name = "wan-2.2-tiny"
    whole = ModelRegistry("cpu", seed=0).get(name)
    for index in range(2):
        registry = ModelRegistry("cpu", seed=0)
        drawn = registry.get_shard(name, index, 2)
        assert isinstance(drawn, ShardBundle) and drawn.shard == (index, 2)
        assert list(registry._shards) == [(name, index, 2, "tp")]
        mine = ttensor.cores_of(drawn.pipeline)
        assert len(mine) == 2
        for got, core in zip(mine, ttensor.cores_of(whole.pipeline)):
            want = dict(ttensor.shard_params(core, index, 2))
            assert list(dict(got.named_parameters())) == list(want)
            assert param_digest_of(got.named_parameters()) == \
                param_digest_of(want)
        assert param_digest_of(drawn.pipeline.vae.named_parameters()) == \
            param_digest_of(whole.pipeline.vae.named_parameters())
    registry = ModelRegistry("cpu", seed=0)
    held = registry.get(name)
    registry.get_shard(name, 1, 2)
    assert held.released and name not in registry._cache


@pytest.mark.parametrize("name", ["wan-tiny", "wan-2.2-tiny"])
def test_a_ranks_shard_bytes_against_the_plan(name):
    """Rank 1 holds its shard of each expert within 10% of JAX's per-chip
    arithmetic (``tp_shard_bytes``: the split weights halved; the port
    also halves their column biases and the qk-norm scales); rank 0's
    slices are views of its bundle, as planned before they are cut."""
    bundle = ModelRegistry("cpu", seed=0).get(name)
    rules = tres._tp_rules_for(bundle)
    plan = sum(tres.tp_shard_bytes(c, rules, 2) for c in tres._cores(bundle))
    drawn = ModelRegistry("cpu", seed=0).get_shard(name, 1, 2)
    held = ttensor.shard_bytes(ttensor.cores_of(drawn.pipeline))
    assert plan * 0.9 <= held <= plan
    assert tres.shard_extra_bytes(bundle, 2) == 0
    ttensor.shard_pipeline(bundle.pipeline, 0, 2)
    assert tres.shard_extra_bytes(bundle, 2) == 0
    assert isinstance(bundle.core, WanModel)
