"""The port's mesh placement against the JAX package's on the same
inputs (``MeshSpec``, ``build_mesh``/``describe_mesh``, ``mesh_from_config``,
``plan_placement``, ``derive_tp``), the multi-host flags with an injected
``initialize_fn`` (the counterpart of JAX's bootstrap tests), the backend
choice, ``CDT_VIRTUAL_DEVICES``, ``CDT_MESH_DEVICES`` into a launched
worker's environment and into a controller's mesh, and a ``tp`` axis
(built, innermost; ``CDT_MESH_TP`` where no shape is configured). No
follower process starts here."""

import jax
import pytest
import torch

from comfyui_distributed_tpu.parallel import mesh as jmesh
from comfyui_distributed_tpu.parallel import rng as jrng
from comfyui_distributed_tpu.parallel import serving as jserving
from comfyui_distributed_tpu.utils.exceptions import ShardingError as JShardingError
from comfyui_distributed_tpu.workers import launch_builder as jlaunch
from comfyui_distributed_tpu_torch.parallel import bootstrap
from comfyui_distributed_tpu_torch.parallel import mesh as tmesh
from comfyui_distributed_tpu_torch.parallel import rng as trng
from comfyui_distributed_tpu_torch.parallel import serving as tserving
from comfyui_distributed_tpu_torch.utils.exceptions import ShardingError
from comfyui_distributed_tpu_torch.workers import launch_builder as tlaunch

CPU = torch.device("cpu")

SHAPES = [{"dp": -1}, {"dp": 2}, {"sp": 4}, {"dp": 2, "sp": 2},
          {"dp": -1, "sp": 2}, {"dp": 3}, {"dp": 8}, {"x": 1}, {},
          {"dp": 0}, {"dp": -2}, {"dp": -1, "sp": -1}]


def outcome(fn):
    try:
        return ("ok", fn())
    except (ShardingError, JShardingError) as e:
        return ("error", type(e).__name__)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_spec_resolves_as_jax(shape, n):
    mine = outcome(lambda: tmesh.MeshSpec.from_mapping(shape).resolve(n))
    ref = outcome(lambda: jmesh.MeshSpec.from_mapping(shape).resolve(n))
    assert mine == ref


@pytest.mark.parametrize("shape", SHAPES[:8], ids=str)
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_build_and_describe_mesh_as_jax(shape, n):
    mine = outcome(lambda: tmesh.build_mesh(shape, n, CPU))
    ref = outcome(lambda: jmesh.build_mesh(shape, jax.devices()[:n]))
    assert mine[0] == ref[0]
    if mine[0] == "ok":
        m, j = mine[1], ref[1]
        assert m.shape == dict(j.shape) and m.axis_names == j.axis_names
        d, jd = tmesh.describe_mesh(m), jmesh.describe_mesh(j)
        for key in ("axes", "n_devices", "platform", "process_indices"):
            assert d[key] == jd[key], key
        assert d["backend"] == "none" and d["devices"] == ["cpu"] * m.size
        assert m.coords(m.size - 1) == {a: s - 1 for a, s in m.shape.items()}


@pytest.mark.parametrize("config", [
    {}, {"mesh": {}}, {"mesh": {"shape": {"dp": -1}}},
    {"mesh": {"shape": {"sp": 2}}}, {"mesh": {"shape": {"dp": 2, "sp": -1}}}],
    ids=str)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_from_config_as_jax(config, n):
    mine = outcome(lambda: tmesh.mesh_from_config(config, n, CPU).shape)
    ref = outcome(lambda: dict(jmesh.mesh_from_config(
        config, jax.devices()[:n]).shape))
    assert mine == ref


PLANS = [
    dict(n_devices=1), dict(n_devices=4), dict(n_devices=4, batch=1,
                                                supports_sp=True),
    dict(n_devices=8, batch=2, supports_sp=True),
    dict(n_devices=8, param_bytes=24e9, budget_bytes=14e9),
    dict(n_devices=8, param_bytes=24e9, budget_bytes=4e9),
    dict(n_devices=6, param_bytes=24e9, budget_bytes=4e9),
    dict(n_devices=8, param_bytes=24e9, budget_bytes=4e9, supports_tp=False,
         supports_sp=True),
]


@pytest.mark.parametrize("plan", PLANS, ids=str)
@pytest.mark.parametrize("env", [{}, {"CDT_MESH_TP": "2"},
                                 {"CDT_MESH_TIER": "0"}], ids=str)
def test_plan_placement_as_jax(plan, env, monkeypatch):
    for k in ("CDT_MESH_TP", "CDT_MESH_TIER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    n = plan["n_devices"]
    kw = {k: v for k, v in plan.items() if k != "n_devices"}
    mine = tserving.plan_placement(n, **kw)
    ref = jserving.plan_placement(n, **kw)
    assert mine.to_dict() == ref.to_dict()
    assert tserving.derive_tp(n, plan.get("param_bytes"),
                              plan.get("budget_bytes")) == \
        jserving.derive_tp(n, plan.get("param_bytes"),
                           plan.get("budget_bytes"))


def test_a_tp_axis_is_refused_naming_its_item(monkeypatch):
    """Refused until tensor parallelism was ported (ROADMAP A.6b ii): a
    tp axis now builds, innermost, as JAX's does; with no config shape
    a pinned ``CDT_MESH_TP`` gives ``{"dp": n/tp, "tp": tp}``, and an
    explicit shape (the default config's ``{"dp": -1}`` too) wins, as in
    JAX's ``mesh_from_config``."""
    m = tmesh.build_mesh({"dp": 2, "tp": 2}, 4, CPU)
    j = jmesh.build_mesh({"dp": 2, "tp": 2}, jax.devices()[:4])
    assert m.shape == dict(j.shape) == {"dp": 2, "tp": 2}
    assert m.coords(1) == {"dp": 0, "tp": 1}
    assert tmesh.describe_mesh(m)["tp"] == 2
    assert tserving.mesh_for(tserving.PlacementPlan("dp_tp", 4, 2),
                             device=CPU).shape == {"dp": 2, "tp": 2}
    assert tmesh.build_mesh({"dp": 4, "tp": 1}, 4, CPU).size == 4
    monkeypatch.setenv("CDT_MESH_TP", "2")
    for config, want in (({}, {"dp": 1, "tp": 2}),
                         ({"mesh": {"shape": {"dp": -1}}}, {"dp": 2}),
                         ({"mesh": {"shape": {"sp": 2}}}, {"sp": 2})):
        assert tmesh.mesh_from_config(config, 2, CPU).shape == want
        assert dict(jmesh.mesh_from_config(config, jax.devices()[:2])
                    .shape) == want


def test_participant_seeds():
    assert trng.participant_seeds(100, 4) == jrng.participant_seeds(100, 4)
    assert trng.participant_seed(7, 0) == 7
    seeds = {trng.participant_seed(7, i) for i in range(1, 8)}
    assert len(seeds) == 7 and 7 not in seeds


def test_backend_choice():
    cuda = torch.device("cuda", 0)
    assert bootstrap.choose_backend(CPU, 4) == "gloo"
    assert bootstrap.choose_backend(cuda, 2, cards=1) == "gloo"   # shared
    assert bootstrap.choose_backend(cuda, 2, cards=2) == "nccl"
    assert bootstrap.choose_backend(cuda, 4, cards=1, hosts=4) == "nccl"


def test_virtual_devices(monkeypatch):
    monkeypatch.delenv("CDT_VIRTUAL_DEVICES", raising=False)
    assert bootstrap.ensure_virtual_devices() is None
    assert tmesh.local_device_count(CPU) == 1
    with pytest.raises(ValueError, match="at least 2"):
        bootstrap.ensure_virtual_devices(1)
    monkeypatch.setenv("CDT_VIRTUAL_DEVICES", "3")
    assert bootstrap.ensure_virtual_devices() == 3
    assert tmesh.local_device_count(CPU) == 3
    census = tmesh.device_census(CPU)
    assert [d["id"] for d in census] == [0, 1, 2]
    assert {d["platform"] for d in census} == {"cpu"}


class TestMultihostBootstrap:
    """The JAX package's bootstrap tests, on the port's ``init_multihost``
    with an injected ``initialize_fn``."""

    @pytest.fixture(autouse=True)
    def _reset(self, monkeypatch):
        monkeypatch.setattr(bootstrap, "_initialized", False)
        for k in ("CDT_COORDINATOR", "CDT_NUM_HOSTS", "CDT_HOST_INDEX"):
            monkeypatch.delenv(k, raising=False)

    def test_noop_without_coordinator(self):
        calls = []
        assert bootstrap.init_multihost(
            initialize_fn=lambda **kw: calls.append(kw)) is False
        assert calls == []

    def test_explicit_args_forwarded_once(self):
        calls = []
        assert bootstrap.init_multihost(
            "10.0.0.1:9911", 4, 2, initialize_fn=lambda **kw: calls.append(kw))
        assert calls == [{"coordinator_address": "10.0.0.1:9911",
                          "num_processes": 4, "process_id": 2}]
        assert bootstrap.init_multihost(
            "10.0.0.1:9911", 4, 2, initialize_fn=lambda **kw: calls.append(kw))
        assert len(calls) == 1

    def test_env_fallbacks(self, monkeypatch):
        monkeypatch.setenv("CDT_COORDINATOR", "c:1")
        monkeypatch.setenv("CDT_NUM_HOSTS", "2")
        monkeypatch.setenv("CDT_HOST_INDEX", "1")
        calls = []
        assert bootstrap.init_multihost(
            initialize_fn=lambda **kw: calls.append(kw))
        assert calls[0]["num_processes"] == 2 and calls[0]["process_id"] == 1

    def test_incomplete_config_raises(self):
        with pytest.raises(ValueError):
            bootstrap.init_multihost("c:1", initialize_fn=lambda **kw: None)
        with pytest.raises(ValueError):
            bootstrap.init_multihost("c:1", 4, 7,
                                     initialize_fn=lambda **kw: None)

    def test_serve_flags_reach_the_bootstrap(self, monkeypatch):
        """``serve --coordinator --num-hosts --host-index`` joins the hosts;
        a host index > 0 serves host 0's mesh calls, not HTTP."""
        from comfyui_distributed_tpu_torch import __main__ as cli

        seen = {}

        def fake_init(**kw):
            seen["init"] = kw
            monkeypatch.setattr(bootstrap, "_MULTIHOST",
                                {"rank": kw["process_id"],
                                 "world": kw["num_processes"]})
            return True

        monkeypatch.setattr(bootstrap, "init_multihost", fake_init)
        monkeypatch.setattr(bootstrap, "serve_follower",
                            lambda device, seed, root: seen.setdefault(
                                "follower", (str(device), seed)) and 0)
        code = cli.main(["serve", "--device", "cpu", "--coordinator",
                         "10.0.0.1:9911", "--num-hosts", "2",
                         "--host-index", "1"])
        assert code == 0
        assert seen["init"] == {"coordinator_address": "10.0.0.1:9911",
                                "num_processes": 2, "process_id": 1}
        assert seen["follower"] == ("cpu", 0)


def test_a_launched_worker_gets_its_mesh_devices():
    """The host entry's ``mesh_devices`` reaches the worker's environment
    as ``CDT_MESH_DEVICES``, as in the JAX launch builder."""
    for entry in ({"id": "w0", "port": 8190, "mesh_devices": 2},
                  {"id": "w1", "port": 8191, "mesh_devices": -1},
                  {"id": "w2", "port": 8192}):
        _, env = tlaunch.build_launch_command(entry, 8188, device="cpu")
        _, jenv = jlaunch.build_launch_command(entry, 8188)
        assert env.get("CDT_MESH_DEVICES") == jenv.get("CDT_MESH_DEVICES")
    _, env = tlaunch.build_launch_command(
        {"id": "w0", "port": 8190, "mesh_devices": 2}, 8188, device="cpu")
    assert env["CDT_MESH_DEVICES"] == "2"


@pytest.mark.parametrize("env,shape,backend", [
    ({}, {"dp": 1}, "none"),
    ({"CDT_VIRTUAL_DEVICES": "2"}, {"dp": 2}, "gloo"),
    ({"CDT_VIRTUAL_DEVICES": "4", "CDT_MESH_DEVICES": "2"}, {"dp": 2}, "gloo"),
])
def test_controller_mesh(tmp_path, monkeypatch, env, shape, backend):
    """``CDT_MESH_DEVICES`` wins over the config's shape; the mesh is built
    once and starts no follower until its first call; ``reset_mesh``
    drops it."""
    from comfyui_distributed_tpu_torch.cluster.controller import Controller

    for k in ("CDT_VIRTUAL_DEVICES", "CDT_MESH_DEVICES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    c = Controller(tmp_path / "cfg.json", device="cpu")
    mesh = c.mesh
    assert mesh.shape == shape and c.mesh is mesh
    info = c.system_info()["mesh"]
    assert info["axes"] == shape and info["backend"] == backend
    if mesh.size > 1:
        assert mesh.runtime is not None and not mesh.runtime.procs
    c.reset_mesh()
    assert c.mesh is not mesh


def test_a_mesh_larger_than_the_ranks_is_refused(tmp_path, monkeypatch):
    import json

    from comfyui_distributed_tpu_torch.cluster.controller import Controller

    monkeypatch.delenv("CDT_VIRTUAL_DEVICES", raising=False)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"mesh": {"shape": {"dp": 2}}}))
    c = Controller(tmp_path / "cfg.json", device="cpu")
    with pytest.raises(ShardingError, match="needs 2 devices, have 1"):
        c.mesh
    assert "needs 2 devices" in c.system_info()["mesh"]["error"]


def test_a_many_card_host_serves_on_one_rank_unless_asked(tmp_path,
                                                          monkeypatch):
    """On a host with four cards (the count patched) and no mesh setting
    the controller's mesh has one rank (the local workers hold the other
    cards): img2img, the model upscale and USDU run on the master as on
    one card (the default shape ``{"dp": -1}`` asks for no more). A
    config's shape that names an axis of more ranks asks for the cards."""
    import json
    from pathlib import Path

    import numpy as np

    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.utils.image import encode_png

    for k in ("CDT_VIRTUAL_DEVICES", "CDT_MESH_DEVICES", "CDT_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tmesh, "local_device_count", lambda device=None: 4)
    registry = ModelRegistry("cpu", seed=0)
    c = Controller(tmp_path / "cfg.json", device="cpu",
                   model_registry=registry)
    assert c.mesh.shape == {"dp": 1} and c.mesh.runtime is None
    (tmp_path / "in").mkdir()
    img = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    (tmp_path / "in" / "input.png").write_bytes(encode_png(img))
    upscale = strip_meta(json.loads(
        (Path(__file__).resolve().parents[1] / "workflows" /
         "distributed-upscale.json").read_text()))
    upscale["1"]["inputs"]["ckpt_name"] = "tiny"
    upscale["8"]["inputs"]["model_name"] = "tiny-x2"
    upscale["9"]["inputs"].update(tile=16, tile_padding=4)
    upscale["5"]["inputs"].update(tile_width=16, tile_height=16,
                                  tile_padding=4, steps=2)
    img2img = {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": "tiny"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lighthouse", "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["1", 1]}},
        "5": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
        "4": {"class_type": "TPUImg2Img", "inputs": dict(
            model=["1", 0], image=["5", 0], positive=["2", 0],
            negative=["3", 0], seed=3, steps=2, cfg=5.0, denoise=0.5)},
    }
    ctx = dict(c._execution_context(), input_dir=str(tmp_path / "in"),
               output_dir=str(tmp_path / "out"))
    assert ctx["mesh"] is c.mesh
    out = GraphExecutor(ctx).execute(upscale)
    assert out["5"][0].shape[0] == 1 and torch.isfinite(out["5"][0]).all()
    out = GraphExecutor(ctx).execute(img2img)
    assert out["4"][0].shape == (1, 16, 16, 3)
    for shape, want in (({"dp": 2}, {"dp": 2}),
                        ({"dp": -1, "sp": 2}, {"dp": 2, "sp": 2})):
        (tmp_path / "asked.json").write_text(json.dumps(
            {"mesh": {"shape": shape}}))
        asked = Controller(tmp_path / "asked.json", device="cpu",
                           model_registry=registry)
        assert asked.mesh.shape == want
        assert asked.mesh.runtime is not None
        assert not asked.mesh.runtime.procs
