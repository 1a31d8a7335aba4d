"""The port's tensor parallelism (``parallel/tensor.py``) against the JAX
package's on the same inputs: the rule tables' per-parameter specs and
summaries for the tiny presets of the four families, the fallback of a
dim that does not divide, ``require_tp_match``'s error; FLUX's
``flow_tp`` on two CPU ranks over gloo (``{"dp": 1, "tp": 2}``) against
``generate_tp_fn`` on two of JAX's eight virtual devices, JAX's noise
handed over (2e-4, JAX's tp contract); a follower's drawn shard equal to
the slice of the whole bundle; ``cfg != 1`` refused."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from comfyui_distributed_tpu.diffusion import pipeline_flow as jflow  # noqa: E402
from comfyui_distributed_tpu.models.registry import ModelRegistry as JRegistry  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh as jbuild_mesh  # noqa: E402
from comfyui_distributed_tpu.parallel import tensor as jtensor  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_flow as tflow  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import carry_plan  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry  # noqa: E402
from comfyui_distributed_tpu_torch.parallel import tensor as ttensor  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.bootstrap import MeshRuntime  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.parallel.programs import param_digest_of  # noqa: E402

from test_torch_mesh_dp import HW, TOL, _t, conditioning, flow_pair  # noqa: E402,F401
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

CPU = torch.device("cpu")
FAMILIES = {"tiny": "UNET", "flux-tiny": "DIT", "sd3-tiny": "DIT",
            "wan-tiny": "WAN"}


@pytest.fixture(scope="module")
def mesh(cpu_share, tmp_path_factory):
    """Rank 0's ``{"dp": 1, "tp": 2}`` mesh over two CPU ranks."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    os.environ["CDT_LOG_DIR"] = str(tmp_path_factory.mktemp("tp_logs"))
    m = build_mesh({"dp": 1, "tp": 2}, 2, CPU)
    m.runtime = MeshRuntime(m, seed=0)
    yield m
    m.runtime.stop()
    if old is None:
        os.environ.pop("CDT_LOG_DIR", None)
    else:
        os.environ["CDT_LOG_DIR"] = old


@pytest.fixture(scope="module")
def bundles():
    """(JAX bundle, port core) of each tiny family, random-init; the port's
    core in JAX's fp32, so that bytes compare."""
    out = {}
    for name in FAMILIES:
        jb = JRegistry().get(name)
        out[name] = (jb, ModelRegistry("cpu", seed=0).get(name).core.float())
    return out


def _jax_core(jb):
    return jb._core_params()


def _jpath(path: tuple) -> str:
    return "/".join(path)


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("tp", [2, 4])
def test_specs_and_summary_as_jax(bundles, name, tp):
    """Every parameter's spec is JAX's, transposed to ``[out, in]``; the
    summaries agree leaf for leaf and byte for byte."""
    jb, core = bundles[name]
    jtree = _jax_core(jb)
    jrules = getattr(jtensor, f"{FAMILIES[name]}_TP_RULES")
    trules = getattr(ttensor, f"{FAMILIES[name]}_TP_RULES")
    leaves = dict(jax.tree_util.tree_flatten_with_path(jtree)[0])
    jleaf = {jtensor._path_str(path).removeprefix("params/"): leaf
             for path, leaf in leaves.items()}
    plan = carry_plan(jtree, core)
    sharded = 0
    for tname, p in core.named_parameters():
        jp, _ = plan[tname]
        leaf = jleaf[_jpath(jp)]
        jspec = tuple(jtensor.spec_for_param(_jpath(jp), leaf.shape, jrules,
                                             "tp", tp))
        tspec = ttensor.spec_for_param(tname, tuple(p.shape), trules, "tp",
                                       tp)
        want = tuple(reversed(jspec)) if len(jspec) == 2 else jspec
        assert tspec == want, tname
        sharded += bool(tspec)
    assert sharded > 0
    jmesh = jbuild_mesh({"dp": 8 // tp, "tp": tp}, jax.devices()[:8])
    jsum = jtensor.tp_sharding_summary(jtree, jmesh, jrules)
    tsum = ttensor.tp_sharding_summary(core, trules, tp)
    assert tsum == jsum


def test_a_dim_that_does_not_divide_is_replicated():
    rules = ttensor.DIT_TP_RULES
    assert ttensor.spec_for_param("single_0.out.weight", (64, 320), rules,
                                  "tp", 2) == (None, "tp")
    assert ttensor.spec_for_param("single_0.out.weight", (64, 322), rules,
                                  "tp", 4) == ()
    assert jtensor.spec_for_param("single_0/out/kernel", (322, 64),
                                  jtensor.DIT_TP_RULES, "tp", 4) == \
        jax.sharding.PartitionSpec()
    # a unit whose heads do not divide stays whole on every rank
    from comfyui_distributed_tpu_torch.models.dit import DiT, DiTConfig

    with torch.device("meta"):
        core = DiT(dataclasses.replace(DiTConfig.tiny(dtype="float32"),
                                       heads=2))
    plan = ttensor.shard_plan(core, 4)
    assert not any(n.startswith(("double_", "single_")) for n in plan)
    assert ttensor.shard_plan(core, 2)


def test_require_tp_match_error_as_jax():
    from torch import nn

    mlp = nn.Sequential(nn.Linear(8, 8))
    with pytest.raises(ValueError, match="no parameters matched") as mine:
        ttensor.require_tp_match(mlp, ttensor.DIT_TP_RULES, 2, "dit")
    jmesh = jbuild_mesh({"dp": 4, "tp": 2}, jax.devices()[:8])
    with pytest.raises(ValueError, match="no parameters matched") as ref:
        jtensor.require_tp_match({"w": {"kernel": np.zeros((8, 8))}}, jmesh,
                                 jtensor.DIT_TP_RULES, "tp", "dit")
    assert str(mine.value) == str(ref.value)
    ttensor.require_tp_match(mlp, ttensor.DIT_TP_RULES, 1, "dit")


@pytest.mark.parametrize("name", ["tiny", "flux-tiny"])
def test_a_drawn_shard_is_the_slice_of_the_whole(name):
    """A follower's shard drawn part by part from the seed holds, for every
    parameter, the slice of the whole bundle's (``shard_params``), and
    the two shards' split parameters tile the whole."""
    whole = ModelRegistry("cpu", seed=0).get(name).core
    for index in range(2):
        drawn = ModelRegistry("cpu", seed=0).get_shard(name, index, 2)
        core = ttensor.core_of(drawn.pipeline)
        mine = dict(core.named_parameters())
        want = dict(ttensor.shard_params(whole, index, 2))
        assert list(mine) == list(want)
        for n, p in want.items():
            assert torch.equal(mine[n], p), n
        assert param_digest_of(core.named_parameters()) == param_digest_of(
            ttensor.shard_params(whole, index, 2))
    plan = ttensor.shard_plan(whole, 2)
    assert plan and all(whole.get_parameter(n).shape[d] % 2 == 0
                        for n, (d, _) in plan.items())


def test_flow_tp_matches_jax(mesh, conditioning):
    ctx, pooled, _, _ = conditioning
    jp, tp = flow_pair({"pos_embed": "rope"})
    spec = dict(height=HW, width=HW, steps=2, shift=3.0)
    seed = 5
    jm = jbuild_mesh({"dp": 1, "tp": 2}, jax.devices()[:2])
    fn = jp.generate_tp_fn(jm, jflow.FlowSpec(**spec))
    ref = np.asarray(fn(jax.random.key(seed), ctx, pooled))
    noise = jax.random.normal(jax.random.fold_in(jax.random.key(seed), 0),
                              (8, 8, 4), jnp.float32)[None]
    out = mesh.runtime.run("flow_tp", types.SimpleNamespace(pipeline=tp),
                           tflow.FlowSpec(**spec), seed, _t(ctx), _t(pooled),
                           noises=[_t(noise)])
    assert out.shape == ref.shape == (1, HW, HW, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    ranks = mesh.runtime.last_call["ranks"]
    assert [r["program"] for r in ranks] == ["flow_tp", "flow_tp"]
    assert ranks[0]["shard_bytes"] == ranks[1]["shard_bytes"] > 0
    # the one-device run of the same noise: not bitwise, within the tol
    one = tp.sample_and_decode(_t(noise), tflow.FlowSpec(**spec), _t(ctx),
                               _t(pooled))
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=TOL, rtol=TOL)


def test_generate_tp_refuses_true_cfg(mesh, conditioning):
    ctx, pooled, uctx, upooled = conditioning
    _, tp = flow_pair({"pos_embed": "rope"})
    with pytest.raises(Exception, match="true CFG"):
        mesh.runtime.run("flow_tp", types.SimpleNamespace(pipeline=tp),
                         tflow.FlowSpec(height=HW, width=HW, steps=1,
                                        cfg=2.0), 1, _t(ctx), _t(pooled))


def test_the_warm_pass_builds_the_ranks_shards(mesh, monkeypatch):
    """A controller mesh of two ranks warms the catalog's mesh tier: the
    flow_sp key builds every rank's bundle, the flow_tp key every rank's
    shard under its ``{"dp": 1, "tp": 2}`` strategy mesh, and stops."""
    from comfyui_distributed_tpu_torch.cluster.shape_catalog import ProgramKey
    from comfyui_distributed_tpu_torch.diffusion import warmup as twarm

    monkeypatch.setenv("CDT_MESH_TP", "2")
    keys = [ProgramKey("flow_dp", "flux-tiny", 32, 32, 2)]
    tier = twarm.mesh_tier_keys(keys, mesh)
    assert [k.pipeline for k in tier] == ["flow_sp", "flow_tp"]
    registry = ModelRegistry("cpu", seed=0)
    report = twarm.run_warmup(registry, keys + tier, models=["flux-tiny"],
                              mesh=mesh)
    outcomes = {e.key.pipeline: e.outcome for e in report}
    assert outcomes == {"flow_dp": "compiled", "flow_sp": "cache_hit",
                        "flow_tp": "compiled"}
    ranks = mesh.runtime.last_call["ranks"]
    assert [r["program"] for r in ranks] == ["warm", "warm"]
    held = registry.get("flux-tiny").pipeline._tp_shards
    assert list(held) == [(0, 2, "tp")]
    # one rank's shard: its slices besides the replicated glue
    assert ranks[1]["allocated_bytes"] == 0       # the CPU
    again = twarm.run_warmup(registry, tier[1:], models=["flux-tiny"],
                             mesh=mesh)
    assert again[0].outcome == "cache_hit"
