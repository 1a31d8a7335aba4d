"""Groups over a mesh (``Txt2ImgPipeline.generate_microbatch`` /
``generate_latents`` with ``mesh=``, the front door's ``execute_group``)
on two CPU ranks over gloo: the tensor-parallel group program
``txt2img_tp`` (fused, and staged: latents to rank 0) against JAX's
``generate_microbatch`` / ``generate_latents`` on its ``{"dp": 1, "tp":
2}`` mesh, JAX's noise handed over (2e-4); a ``dp`` group on ``{"dp":
2}`` bitwise its solo mesh runs; a group on ``{"dp": 2, "tp": 2}`` (four
ranks) within 2e-4 of the ``dp`` one; ``CDT_MESH_TIER=0`` on a tp mesh
bitwise the one-rank run (JAX's kill switch); the flow node's ``dp`` on
a tp mesh bitwise the one-rank run; a lone request on a tp mesh solo;
the execution signature of a one-rank, a ``{"dp": 2}`` and a tp mesh
all different, so a tp group's result is never served to a one-rank
controller."""

import types

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh as jbuild_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.cache import (CacheManager,  # noqa: E402
                                                         execution_signature)
from comfyui_distributed_tpu_torch.cluster.frontdoor import microbatch as tmb  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.runtime import PromptJob  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.cache.keys import request_fingerprint  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe  # noqa: E402
from comfyui_distributed_tpu_torch.graph import GraphExecutor  # noqa: E402
from comfyui_distributed_tpu_torch.graph.executor import strip_meta  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.bootstrap import MeshRuntime  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh  # noqa: E402

from test_torch_frontdoor import batchable  # noqa: E402
from test_torch_mesh_dp import HW, TOL, _graph, _t, encoder  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

CPU = torch.device("cpu")
SPEC = dict(height=HW, width=HW, steps=2, sampler="euler", scheduler="karras",
            guidance_scale=5.0)


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    """The followers' logs in a directory of this module's own."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    os.environ["CDT_LOG_DIR"] = str(tmp_path_factory.mktemp("mesh_logs"))
    yield
    if old is None:
        os.environ.pop("CDT_LOG_DIR", None)
    else:
        os.environ["CDT_LOG_DIR"] = old


def _runtime(shape):
    m = build_mesh(shape, 2, CPU)
    m.runtime = MeshRuntime(m, seed=0)
    return m


@pytest.fixture(scope="module")
def tp_mesh(cpu_share, log_dir):
    m = _runtime({"dp": 1, "tp": 2})
    yield m
    m.runtime.stop()


@pytest.fixture(scope="module")
def dp_mesh(cpu_share, log_dir):
    m = _runtime({"dp": 2})
    yield m
    m.runtime.stop()


@pytest.fixture(scope="module")
def unet_pair():
    """(JAX pipeline, port pipeline, conditioning) of the tiny UNet, fp32."""
    model, params = junet.init_unet(junet.UNetConfig.tiny(dtype="float32"),
                                    jax.random.key(0), sample_shape=(8, 8, 4),
                                    context_len=16)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(HW, HW))
    jp = jpipe.Txt2ImgPipeline(model, params, vae)
    unet = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         jax.tree_util.tree_map(np.asarray, params)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray,
                                                     vae.dec_params))
    tp = tpipe.Txt2ImgPipeline(unet, tv.eval())
    enc = encoder()
    conds = []
    for text in ("a cat", "a dog"):
        ctx, pooled = enc.encode([text])
        conds.append((np.array(ctx), np.array(pooled)[:, :8]))
    unc, upooled = enc.encode([""])
    return jp, tp, conds, (np.array(unc), np.array(upooled)[:, :8])


def _jax_noise(seed):
    k, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 0))
    return _t(jax.random.normal(k, (1, 8, 8, 4), np.float32))


@pytest.mark.parametrize("latent", [False, True], ids=["fused", "staged"])
def test_tp_group_matches_jax(tp_mesh, unet_pair, latent):
    jp, tp, conds, (unc, uy) = unet_pair
    seeds = [11, 12]
    # JAX's group program at one request (its bucket of one): each
    # request of a group is one such program, unrolled
    jm = jbuild_mesh({"dp": 1, "tp": 2}, jax.devices()[:2])
    call = jp.generate_latents if latent else jp.generate_microbatch
    ref = call(jm, jpipe.GenerationSpec(**SPEC), seeds[:1], [conds[0][0]],
               [unc], [conds[0][1]], [uy])[0]
    spec = tpipe.GenerationSpec(**SPEC)
    bundle = types.SimpleNamespace(pipeline=tp)
    out = tp_mesh.runtime.run(
        "txt2img_tp", bundle, spec, seeds[0], _t(conds[0][0]), _t(unc),
        _t(conds[0][1]), _t(uy), noises=[_jax_noise(seeds[0])],
        decode=not latent)
    want = np.asarray(ref)
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    ranks = tp_mesh.runtime.last_call["ranks"]
    assert [r["program"] for r in ranks] == ["txt2img_tp"] * 2
    assert all(r["launches"] is not None for r in ranks)
    # the group entry point routes a tp mesh to the same program
    args = ([_t(c) for c, _ in conds], [_t(unc)] * 2,
            [_t(y) for _, y in conds], [_t(uy)] * 2)
    entry = tp.generate_latents if latent else tp.generate_microbatch
    outs = entry(spec, seeds, *args, mesh=tp_mesh)
    assert tp_mesh.runtime.last_call["program"] == "txt2img_tp"
    for r, seed in enumerate(seeds):
        one = (tp.generate_latents(spec, [seed], *(a[r:r + 1] for a in args))
               if latent else
               tp.generate_microbatch(spec, [seed],
                                      *(a[r:r + 1] for a in args)))[0]
        np.testing.assert_allclose(outs[r].numpy(), one.numpy(), atol=TOL,
                                   rtol=TOL)


def test_the_kill_switch_is_the_one_rank_run(tp_mesh, unet_pair,
                                             monkeypatch):
    """``CDT_MESH_TIER=0`` on a tp mesh: the ``dp`` program, weights
    whole on the tp-index-0 rank, bitwise the one-rank run; the other
    rank sits the call out."""
    _, tp, conds, (unc, uy) = unet_pair
    monkeypatch.setenv("CDT_MESH_TIER", "0")
    spec = tpipe.GenerationSpec(**SPEC)
    args = ([_t(conds[0][0])] * 2, [_t(unc)] * 2, [_t(conds[0][1])] * 2,
            [_t(uy)] * 2)
    outs = tp.generate_microbatch(spec, [31, 32], *args, mesh=tp_mesh)
    call = tp_mesh.runtime.last_call
    assert call["program"] == "txt2img_dp" and call["ranks"][1]["idle"]
    solo = tp.generate_microbatch(spec, [31, 32], *args)
    for got, want in zip(outs, solo):
        assert torch.equal(got, want)


@pytest.mark.parametrize("latent", [False, True], ids=["fused", "staged"])
def test_a_dp_group_is_bitwise_its_solo_mesh_runs(dp_mesh, unet_pair,
                                                  latent):
    _, tp, conds, (unc, uy) = unet_pair
    spec = tpipe.GenerationSpec(**SPEC)
    seeds = [41, 42]
    args = ([_t(c) for c, _ in conds], [_t(unc)] * 2,
            [_t(y) for _, y in conds], [_t(uy)] * 2)
    bundle = types.SimpleNamespace(pipeline=tp)
    if latent:
        lats = tp.generate_latents(spec, seeds, *args, mesh=dp_mesh,
                                   bundle=bundle)
        outs = tp.decode_latents(lats, rows=spec.per_device_batch)
    else:
        outs = tp.generate_microbatch(spec, seeds, *args, mesh=dp_mesh,
                                      bundle=bundle)
    for r, seed in enumerate(seeds):
        solo = dp_mesh.runtime.run("txt2img_dp", bundle, spec, seed,
                                   *(a[r] for a in args))
        assert outs[r].shape == (2, HW, HW, 3)
        assert torch.equal(outs[r], solo)


def test_a_dp_by_tp_group_gathers_its_participants(dp_mesh, unet_pair,
                                                   log_dir):
    """On ``{"dp": 2, "tp": 2}`` (four CPU ranks) a group's request runs
    ``txt2img_tp`` in each tp pair, participant i from its own seed, the
    tp-index-0 ranks gathering the images: within 2e-4 of the ``dp``
    program's on ``{"dp": 2}``."""
    _, tp, conds, (unc, uy) = unet_pair
    spec = tpipe.GenerationSpec(**SPEC)
    args = ([_t(conds[0][0])], [_t(unc)], [_t(conds[0][1])], [_t(uy)])
    mesh = build_mesh({"dp": 2, "tp": 2}, 4, CPU)
    mesh.runtime = MeshRuntime(mesh, seed=0)
    try:
        (out,) = tp.generate_microbatch(spec, [61], *args, mesh=mesh)
        ranks = mesh.runtime.last_call["ranks"]
    finally:
        mesh.runtime.stop()
    assert [r["program"] for r in ranks] == ["txt2img_tp"] * 4
    (want,) = tp.generate_microbatch(spec, [61], *args, mesh=dp_mesh)
    assert out.shape == want.shape == (2, HW, HW, 3)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_the_flow_node_dp_on_a_tp_mesh_is_the_one_rank_run(tp_mesh,
                                                           tmp_path):
    registry = ModelRegistry("cpu", seed=0)
    prompt = _graph("flux-tiny", 23)
    base = {"model_registry": registry, "output_dir": str(tmp_path)}
    one = GraphExecutor(base).execute(prompt)["4"][0]
    both = GraphExecutor(dict(base, mesh=tp_mesh)).execute(prompt)["4"][0]
    assert torch.equal(both, one)
    call = tp_mesh.runtime.last_call
    assert call["program"] == "flow_dp" and call["ranks"][1]["idle"]


def test_the_signature_carries_the_mesh_axes():
    """The repair: one rank (with or without a mesh) keys as ``{"dp":
    1}``, ``{"dp": 2}`` and ``{"dp": 1, "tp": 2}`` each apart; no
    process starts."""
    sigs = [execution_signature(CPU)] + [
        execution_signature(CPU, build_mesh(axes, 2, CPU))
        for axes in ({"dp": 1}, {"dp": 2}, {"dp": 1, "tp": 2},
                     {"dp": 2, "tp": 1})]
    assert sigs[0] == sigs[1]
    # every axis counts, as in JAX's key ({"dp": 2, "tp": 1} too)
    assert len({sigs[0], sigs[2], sigs[3], sigs[4]}) == 4


def _members(seeds, prefix):
    out = []
    for s in seeds:
        prompt = strip_meta(batchable(seed=s, wh=HW, steps=2))
        out.append(PromptJob(prompt_id=f"{prefix}{s}", prompt=prompt,
                             fingerprint=request_fingerprint(prompt)))
    return out


def test_a_tp_group_is_keyed_by_its_mesh(tp_mesh, dp_mesh, tmp_path):
    """The execution signature carries the mesh's axes: a one-rank, a
    ``{"dp": 2}`` and a tp mesh key apart, so a tp group's result fills
    the tier under its own key, a repeat on the tp mesh hits it, and a
    one-rank controller with the same cache computes its own. A lone
    request on the tp mesh runs solo, bitwise the one-rank run."""
    one_rank = build_mesh({"dp": 1}, 1, CPU)
    sigs = {execution_signature(CPU), execution_signature(CPU, one_rank),
            execution_signature(CPU, dp_mesh),
            execution_signature(CPU, tp_mesh)}
    assert len(sigs) == 3
    assert execution_signature(CPU) == execution_signature(CPU, one_rank)
    registry = ModelRegistry("cpu", seed=0)
    cache = CacheManager(tmp_path / "cache")
    base = {"model_registry": registry, "output_dir": str(tmp_path),
            "content_cache": cache}
    tp_ctx = dict(base, mesh=tp_mesh)
    members = _members([51, 52], "tp")
    ids = {m.prompt_id: "4" for m in members}
    res = tmb.execute_group(members, ids, tp_ctx)
    assert tp_mesh.runtime.last_call["program"] == "txt2img_tp"
    ex = GraphExecutor({"model_registry": registry,
                        "output_dir": str(tmp_path)})
    solos = [ex.execute(m.prompt)["4"][0] for m in members]
    for m, solo in zip(members, solos):
        entry = res[m.prompt_id]
        assert entry["status"] == "success" and entry["batch_size"] == 2
        img = entry["outputs"]["4"][0]
        assert img.shape == solo.shape == (1, HW, HW, 3)
        assert float((img.float() - solo.float()).abs().max()) < 0.05
    again = tmb.execute_group(_members([51, 52], "re"),
                              {f"re{s}": "4" for s in (51, 52)}, tp_ctx)
    assert all(e.get("cache") == "hit" for e in again.values())
    mine = tmb.execute_group(_members([51, 52], "one"),
                             {f"one{s}": "4" for s in (51, 52)}, base)
    for s, solo in zip((51, 52), solos):
        entry = mine[f"one{s}"]
        assert entry.get("cache") != "hit" and entry["batch_size"] == 2
        assert torch.equal(entry["outputs"]["4"][0], solo)
    lone = tmb.execute_group(_members([53], "lone"), {"lone53": "4"},
                             dict(base, mesh=tp_mesh))
    assert lone["lone53"]["batch_size"] == 1
    assert tp_mesh.runtime.last_call["program"] == "txt2img_dp"
    assert torch.equal(lone["lone53"]["outputs"]["4"][0],
                       ex.execute(_members([53], "x")[0].prompt)["4"][0])
