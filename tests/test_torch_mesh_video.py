"""Video over a mesh: the port's ``video_dp``, ``video_i2v_dp``,
``video_sp`` and ``video_i2v_sp`` programs on two CPU ranks over gloo
(``parallel/bootstrap.MeshRuntime``) against the JAX package's
``generate_fn``, ``generate_i2v_fn``, ``generate_frames_fn`` and
``generate_i2v_frames_fn`` on two of its eight virtual devices, JAX's
noise handed over (2e-4, JAX's contract); the WAN transformer's and the
video-MMDiT's forward with ``sp_axis`` on ``{"sp": 2}`` (two ranks run as
threads of this process over gloo) against JAX's ``shard_map``ped
forward (JAX's own tolerance for it: 2e-4 absolute, 2e-3 relative); the
video nodes on a mesh of three ranks with the registry's presets: ``dp``
(participant 0 bitwise the one-rank run), ``sp`` (JAX's refusal of
latent frames that do not divide), ``tp`` and ``sp`` on an offload
bundle refused.

The pipelines run the WAN 3D causal VAE cut to 4× in time (as the
published one), so that 5 frames give 2 latent frames, one a rank; the
tiny presets' VAEs give an odd count (2× in time, or none), which the
node cases divide over three ranks."""

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline_video as jpv  # noqa: E402
from comfyui_distributed_tpu.models import video_dit as jvd  # noqa: E402
from comfyui_distributed_tpu.models import wan_vae as jwv  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh as jbuild_mesh  # noqa: E402
from comfyui_distributed_tpu.utils.jax_compat import shard_map  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_video as tpv  # noqa: E402
from comfyui_distributed_tpu_torch.models import video_dit as tvd  # noqa: E402
from comfyui_distributed_tpu_torch.models import wan_vae as twv  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.bootstrap import (MeshRuntime,  # noqa: E402
                                                              connect)
from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh, use_mesh  # noqa: E402

from test_torch_video_pipeline import _conditioning, _np, _wan  # noqa: E402
from torch_ckpt_fixtures import perturbed  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
CPU = torch.device("cpu")
# the tiny 3D VAE at 4× in time and space: 5 frames of 16² → 2 × 4²
VAE_KW = dict(dim_mult=(1, 2, 2), temporal_downsample=(True, True))
SPEC = dict(frames=5, height=16, width=16, steps=2, shift=3.0,
            guidance_scale=4.0)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def spmd(axes: dict, fn) -> list:
    """``fn(rank)`` on every rank of a mesh of ``axes``, the ranks threads
    of this process over gloo, each under its own mesh; the results by
    rank."""
    import torch.distributed as dist

    n = int(np.prod(list(axes.values())))
    store = dist.TCPStore("127.0.0.1", 0, n, True, wait_for_workers=False)
    meshes, out, errors = [None] * n, [None] * n, []

    def each(target):
        def body(r):
            try:
                target(r)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def join(r):
        st = store if r == 0 else dist.TCPStore("127.0.0.1", store.port, n,
                                                False)
        meshes[r] = connect(axes, st, r, CPU, "gloo")

    def call(r):
        with use_mesh(meshes[r]), torch.no_grad():
            out[r] = fn(r)

    each(join)
    each(call)
    return out


@pytest.fixture(scope="module")
def mesh(cpu_share, tmp_path_factory):
    """Rank 0's ``{"dp": 2}`` mesh over two CPU ranks; the ``sp`` calls
    re-lay the same ranks."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    os.environ["CDT_LOG_DIR"] = str(tmp_path_factory.mktemp("mesh_logs"))
    m = build_mesh({"dp": 2}, 2, CPU)
    m.runtime = MeshRuntime(m, seed=0)
    yield m
    m.runtime.stop()
    if old is None:
        os.environ.pop("CDT_LOG_DIR", None)
    else:
        os.environ["CDT_LOG_DIR"] = old


def jmesh(axis: str, n: int = 2):
    return jbuild_mesh({axis: n}, jax.devices()[:n])


def _vae():
    jv = jwv.WanVAE3D(jwv.WanVAEConfig.tiny(**VAE_KW)).init(
        jax.random.key(5), frames=5, image_hw=(16, 16))
    tv = twv.WanVAE3D(twv.WanVAEConfig.tiny(**VAE_KW))
    load_from_jax(tv.encoder, _np(jv.enc_params))
    load_from_jax(tv.decoder, _np(jv.dec_params))
    return jv, tv.eval()


def _mmdit(seed: int):
    """(JAX VideoDiT and params, the port's) of the tiny video-MMDiT in
    fp32, every parameter perturbed (flax draws its gates at zero)."""
    jcfg = dataclasses.replace(jvd.VideoDiTConfig.tiny(), dtype="float32")
    model, params = jvd.init_video_dit(jcfg, jax.random.key(seed),
                                       sample_fhw=(2, 4, 4), context_len=5)
    params = perturbed(_np(params), seed + 10)
    tcfg = dataclasses.replace(tvd.VideoDiTConfig.tiny(), dtype="float32")
    return model, params, load_from_jax(tvd.VideoDiT(tcfg), params).eval()


@pytest.fixture(scope="module")
def stacks():
    """(JAX pipeline, port pipeline) by name: WAN t2v, WAN i2v (4 + 4
    mask + 4 conditioning channels) and the video-MMDiT, each over the
    4×-in-time VAE."""
    jv, tv = _vae()
    out = {}
    for name, (model, params, port) in {
            "wan": _wan(0), "wan-i2v": _wan(1, in_channels=12),
            "mmdit": _mmdit(2)}.items():
        out[name] = (jpv.VideoPipeline(model, params, jv),
                     tpv.VideoPipeline(port, tv))
    return out


def _image():
    return np.random.default_rng(3).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)


def _latent(tp, spec) -> tuple:
    return tp.latent_shape(tpv.VideoSpec(**spec))


# --- the transformers' sp forward ---------------------------------------------


@pytest.mark.parametrize("family", ["wan", "mmdit"])
def test_sp_forward_matches_jax_sharded_forward(family):
    """A forward over frame blocks on ``{"sp": 2}``: ring attention, RoPE
    ids offset by the shard's frames (WAN), the position table's rows of
    the whole clip (MMDiT), the cross-attention local."""
    model, params, port = _wan(4) if family == "wan" else _mmdit(5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 4, 4, 4, 4)).astype(np.float32)
    t = np.array([0.4], np.float32)
    ctx, pooled = _conditioning(7)
    body = (lambda xs, tt, c, pl: model.apply(params, xs, tt, c, pl,
                                              sp_axis="sp"))
    ref = jax.jit(shard_map(body, mesh=jmesh("sp"),
                            in_specs=(P(None, "sp"), P(), P(), P()),
                            out_specs=P(None, "sp"), check_vma=False))(
        x, t, ctx, pooled)
    outs = spmd({"sp": 2}, lambda r: port(
        _t(x[:, 2 * r:2 * r + 2]), _t(t), _t(ctx), _t(pooled), sp_axis="sp"))
    got = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=2e-3)
    with torch.no_grad():
        whole = port(_t(x), _t(t), _t(ctx), _t(pooled)).numpy()
    np.testing.assert_allclose(got, whole, atol=2e-4, rtol=2e-3)
    assert np.abs(whole).max() > 1e-2


# --- sp -------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["wan", "mmdit", "wan-i2v"])
def test_video_sp_matches_jax(mesh, stacks, name):
    jp, tp = stacks[name]
    seed = 11
    ctx, pooled = _conditioning(8)
    jspec = jpv.VideoSpec(**SPEC)
    # JAX's sp noise: the whole latent from the seed's key, frame-sliced
    noise = np.array(jax.random.normal(jax.random.key(seed),
                                       _latent(tp, SPEC), jnp.float32))
    ns = types.SimpleNamespace(pipeline=tp)
    if name == "wan-i2v":
        image = _image()
        y, mask = jp.i2v_condition(jnp.asarray(image), jspec)
        ref = jp.generate_i2v_frames_fn(jmesh("sp"), jspec)(
            jax.random.key(seed), ctx, pooled, y, mask)
        out = mesh.runtime.run("video_i2v_sp", ns, tpv.VideoSpec(**SPEC),
                               seed, _t(image), _t(ctx), _t(pooled),
                               noise=_t(noise), layout="sp")
    else:
        ref = jp.generate_frames_fn(jmesh("sp"), jspec)(
            jax.random.key(seed), ctx, pooled)
        out = mesh.runtime.run("video_sp", ns, tpv.VideoSpec(**SPEC), seed,
                               _t(ctx), _t(pooled), noise=_t(noise),
                               layout="sp")
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (1, 5, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    ranks = mesh.runtime.last_call["ranks"]
    assert [r["program"] for r in ranks] == [
        "video_i2v_sp" if name == "wan-i2v" else "video_sp"] * 2
    # the one-rank run of the same noise
    cond = (tp.i2v_condition(_t(_image()), tpv.VideoSpec(**SPEC))
            if name == "wan-i2v" else None)
    one = tp.sample_and_decode(_t(noise), tpv.VideoSpec(**SPEC), _t(ctx),
                               _t(pooled), cond=cond)
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=TOL, rtol=TOL)


def test_sp_stochastic_draws_are_the_one_rank_runs_rows(mesh, stacks):
    """A stochastic sampler's draws are the one-rank draws' frames on each
    rank (JAX folds the shard index into its key instead), so an sp run
    is the one-rank run of the same seed."""
    _, tp = stacks["wan"]
    ctx, pooled = _conditioning(9)
    spec = tpv.VideoSpec(**{**SPEC, "steps": 3, "sampler": "euler_ancestral"})
    out = mesh.runtime.run("video_sp", types.SimpleNamespace(pipeline=tp),
                           spec, 4, _t(ctx), _t(pooled), layout="sp")
    one = tp.generate(spec, 4, _t(ctx), _t(pooled))
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=TOL, rtol=TOL)


def test_odd_latent_frames_are_refused_with_jax_message(stacks):
    """9 frames are 3 latent frames: not over 2 shards (JAX's t2v and i2v
    messages, raised before any rank runs)."""
    for name, i2v in (("wan", False), ("wan-i2v", True)):
        jp, tp = stacks[name]
        jspec = jpv.VideoSpec(**{**SPEC, "frames": 9})
        builder = (jp.generate_i2v_frames_fn if i2v
                   else jp.generate_frames_fn)
        with pytest.raises(ValueError) as ref:
            builder(jmesh("sp"), jspec)
        with pytest.raises(ValueError) as mine:
            tp.require_sp_frames(tpv.VideoSpec(**{**SPEC, "frames": 9}), 2,
                                 i2v=i2v)
        assert str(mine.value) == str(ref.value)
        assert "latent frame count 3 must divide over 2 shards" in str(
            mine.value)


# --- dp -------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["wan", "wan-i2v"])
def test_video_dp_matches_jax(mesh, stacks, name):
    jp, tp = stacks[name]
    seed = 13
    ctx, pooled = _conditioning(10)
    jspec = jpv.VideoSpec(**SPEC)
    shape = _latent(tp, SPEC)
    noises = [_t(jax.random.normal(jax.random.fold_in(jax.random.key(seed), i),
                                   shape, jnp.float32)) for i in range(2)]
    ns = types.SimpleNamespace(pipeline=tp)
    if name == "wan-i2v":
        image = _image()
        ref = jp.generate_i2v(jmesh("dp"), jspec, seed, jnp.asarray(image),
                              ctx, pooled)
        out = mesh.runtime.run("video_i2v_dp", ns, tpv.VideoSpec(**SPEC),
                               seed, _t(image), _t(ctx), _t(pooled),
                               noises=noises)
    else:
        ref = jp.generate(jmesh("dp"), jspec, seed, ctx, pooled)
        out = mesh.runtime.run("video_dp", ns, tpv.VideoSpec(**SPEC), seed,
                               _t(ctx), _t(pooled), noises=noises)
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 5, 16, 16, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert not np.allclose(out[0].numpy(), out[1].numpy(), atol=1e-3)


# --- the nodes on a mesh ---------------------------------------------------------


@pytest.fixture(scope="module")
def mesh3(cpu_share, tmp_path_factory):
    """Rank 0's ``{"dp": 3}`` mesh over three CPU ranks whose followers
    build the registry's presets from seed 0."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    os.environ["CDT_LOG_DIR"] = str(tmp_path_factory.mktemp("mesh3_logs"))
    m = build_mesh({"dp": 3}, 3, CPU)
    m.runtime = MeshRuntime(m, seed=0)
    yield m
    m.runtime.stop()
    if old is None:
        os.environ.pop("CDT_LOG_DIR", None)
    else:
        os.environ["CDT_LOG_DIR"] = old


def _node_run(node, registry, name, mode, mesh, frames=5, **kw):
    from comfyui_distributed_tpu_torch.graph import nodes_builtin as nb

    bundle = registry.get(name)
    ctx = torch.from_numpy(_conditioning(12)[0])
    args = dict(model=bundle, positive={"context": ctx}, seed=21,
                frames=frames, steps=2, cfg=4.0, mode=mode, mesh=mesh,
                model_registry=registry, **kw)
    if node == "t2v":
        return nb.TPUTxt2Video().execute(width=16, height=16, **args)[0]
    return nb.TPUImg2Video().execute(image=torch.from_numpy(_image()),
                                     **args)[0]


@pytest.mark.parametrize("node,name", [("t2v", "wan-tiny-3d"),
                                       ("i2v", "wan-i2v-tiny")])
def test_the_video_nodes_run_dp_and_sp_on_a_mesh(mesh3, node, name):
    """``dp``: three videos, participant 0's bitwise the one-rank run;
    ``sp`` over the ranks re-laid as ``{"sp": 3}`` (5 frames: 3 latent
    frames, one a rank) within the tolerance of the one-rank run."""
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    registry = ModelRegistry("cpu", seed=0)
    one = _node_run(node, registry, name, "dp", None)
    assert one.shape == (5, 16, 16, 3)
    dp = _node_run(node, registry, name, "dp", mesh3)
    call = mesh3.runtime.last_call
    assert call["program"] == ("video_dp" if node == "t2v" else "video_i2v_dp")
    assert dp.shape == (15, 16, 16, 3)
    assert torch.equal(dp[:5], one)
    assert not torch.equal(dp[5:10], dp[:5])
    assert not torch.equal(dp[10:], dp[5:10])
    sp = _node_run(node, registry, name, "sp", mesh3)
    assert mesh3.runtime.last_call["program"] == (
        "video_sp" if node == "t2v" else "video_i2v_sp")
    assert sp.shape == (5, 16, 16, 3)
    np.testing.assert_allclose(sp.numpy(), one.numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="latent frame count 5 must divide "
                                         "over 3 shards"):
        _node_run(node, registry, name, "sp", mesh3, frames=9)


def test_the_video_nodes_refuse_tp_and_sp_on_an_offload_bundle(mesh3):
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError

    registry = ModelRegistry("cpu", seed=0)
    for node, name in (("t2v", "wan-tiny-3d"), ("i2v", "wan-i2v-tiny")):
        with pytest.raises(ValidationError, match="video_tp") as err:
            _node_run(node, registry, name, "tp", mesh3)
        assert err.value.field == "mode"
    offload = ModelRegistry("cpu", seed=0, offload=True)
    assert offload.get("wan-tiny-3d").offload
    with pytest.raises(ValidationError, match="no bf16 blocks") as err:
        _node_run("t2v", offload, "wan-tiny-3d", "sp", mesh3)
    assert err.value.field == "mode"
