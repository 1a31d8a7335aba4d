"""The port's warm pass (``diffusion/warmup.py``) on the CPU: the state
machine (``cold → warming → ready | error``) and its outcomes under the
JAX package's labels, what a pass builds and skips, the boot pass under
``CDT_WARMUP=1`` reported by ``health()``, the warmup routes, the
dispatcher's preference for hot hosts beside the JAX dispatcher's, and a
request after a warm pass: it builds no bundle and is bitwise the same
request on a cold controller."""

import asyncio
import json
from pathlib import Path

import pytest

from comfyui_distributed_tpu.cluster import dispatch as jdisp
from comfyui_distributed_tpu_torch import telemetry as ptel
from comfyui_distributed_tpu_torch.api.app import App, Request
from comfyui_distributed_tpu_torch.cluster import dispatch as tdisp
from comfyui_distributed_tpu_torch.cluster import shape_catalog as tcat
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.diffusion import warmup as twarm
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

HW, STEPS = 32, 2


def txt2img(prefix="warm", seed=3):
    return {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": "tiny"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "a lake", "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": STEPS, "cfg": 5.0, "width": HW,
            "height": HW, "sampler_name": "euler"}},
        "5": {"class_type": "SaveImage",
              "inputs": {"images": ["4", 0], "filename_prefix": prefix}},
    }


@pytest.fixture
def workflows(tmp_path, monkeypatch):
    """A workflows directory with one tiny txt2img workflow, an empty
    catalog file of the test's own."""
    d = tmp_path / "workflows"
    d.mkdir()
    (d / "tiny.json").write_text(json.dumps(txt2img()))
    monkeypatch.setenv("CDT_WORKFLOWS_DIR", str(d))
    monkeypatch.setenv("CDT_SHAPE_CATALOG", str(tmp_path / "catalog.json"))
    tcat.reset_default_catalog()
    yield d
    tcat.reset_default_catalog()


KEY = tcat.ProgramKey("txt2img", "tiny", HW, HW, STEPS)


def test_a_pass_builds_once_then_hits_and_reports(workflows, tmp_path):
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    registry = ModelRegistry("cpu", seed=0)
    extra = [tcat.ProgramKey("flow_dp", "sdxl", 64, 64, 2),     # filtered
             tcat.ProgramKey("flow_sp", "tiny", 64, 64, 2,
                             mesh=(("sp", 2),))]                  # multi-card
    wm = twarm.WarmupManager(lambda: registry,
                             catalog=tcat.ShapeCatalog(tmp_path / "c.json"))
    assert wm.state == twarm.COLD and wm.status()["bundle_builds"] == 0
    first = wm.run(models=["tiny"], extra_keys=extra)
    assert first["state"] == twarm.READY == wm.state
    assert first["outcomes"] == {"compiled": 1, "skipped": 2}
    assert first["bundle_builds"] == 1 and first["catalog_size"] == 1
    second = wm.run(models=["tiny"])
    assert second["outcomes"] == {"cache_hit": 1}
    assert second["bundle_builds"] == 1
    assert [r["program"] for r in second["report"]] == [KEY.to_dict()]
    # the catalog seeded from the workflows was saved
    assert tcat.ShapeCatalog(tmp_path / "c.json").entries() == [KEY]
    snap = ptel.REGISTRY.snapshot()
    outcomes = {s["labels"]["outcome"]: s["value"]
                for s in snap["cdt_warmup_programs_total"]["series"]}
    assert outcomes == {"compiled": 1, "skipped": 2, "cache_hit": 1}
    assert snap["cdt_warmup_state"]["series"][0]["value"] == 2.0
    assert snap["cdt_warmup_seconds"]["series"][0]["count"] == 2


def test_a_failed_program_ends_the_pass_in_error(workflows, tmp_path):
    registry = ModelRegistry("cpu", seed=0)
    wm = twarm.WarmupManager(lambda: registry,
                             catalog=tcat.ShapeCatalog(tmp_path / "c.json"))
    bad = tcat.ProgramKey("txt2img", "no-such-model", HW, HW, STEPS)
    status = wm.run(models=["tiny", "no-such-model"], extra_keys=[bad])
    assert status["state"] == twarm.ERROR and status["error"]
    assert status["outcomes"] == {"compiled": 1, "error": 1}
    assert "no-such-model" in next(r["detail"] for r in status["report"]
                                   if r["outcome"] == "error")


def test_the_default_filter_warms_loaded_and_tiny_models(workflows,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.delenv("CDT_WARMUP_MODELS", raising=False)
    registry = ModelRegistry("cpu", seed=0)
    wm = twarm.WarmupManager(lambda: registry,
                             catalog=tcat.ShapeCatalog(tmp_path / "c.json"))
    status = wm.run(extra_keys=[tcat.ProgramKey("txt2img", "sdxl", 64, 64, 2)])
    assert status["outcomes"] == {"compiled": 1, "skipped": 1}
    monkeypatch.setenv("CDT_WARMUP_MODELS", "sdxl")
    assert wm.run()["outcomes"] == {"skipped": 1}
    assert twarm._allowed_models(registry, ["all"]) is None


def test_a_pass_running_answers_a_second_caller_with_its_status(
        workflows, tmp_path):
    registry = ModelRegistry("cpu", seed=0)
    wm = twarm.WarmupManager(lambda: registry,
                             catalog=tcat.ShapeCatalog(tmp_path / "c.json"))
    wm._lock.acquire()
    try:
        assert wm.run()["state"] == twarm.COLD
    finally:
        wm._lock.release()


@pytest.mark.parametrize("states", [
    ("ready", "warming", None), ("warming", "warming"), ("cold", "warming"),
    ("warming", "error", "ready"), ("warming",)])
def test_hot_hosts_are_preferred_as_jax_prefers_them(states):
    def hosts(queue):
        return [{"id": f"w{i}", "_probe": (
            {"queue_remaining": queue[i]} if s is None
            else {"queue_remaining": queue[i], "warmup": s})}
            for i, s in enumerate(states)]

    for queue in ([0] * len(states), [1 + i for i in range(len(states))],
                  [len(states) - i for i in range(len(states))]):
        hs = hosts(queue)
        assert [tdisp.is_hot(h) for h in hs] == [jdisp.is_hot(h) for h in hs]
        for _ in range(len(states) + 1):
            ours = tdisp.select_least_busy_host(hs)
            ref = jdisp.select_least_busy_host(hs)
            assert tdisp.is_hot(ours) == jdisp.is_hot(ref)
            if queue[0] != 0:
                assert ours["id"] == ref["id"]


@pytest.fixture(scope="module")
def cold_png(tmp_path_factory):
    """The request on a cold registry (no warm pass)."""
    out = tmp_path_factory.mktemp("cold")
    GraphExecutor({"model_registry": ModelRegistry("cpu", seed=0),
                   "output_dir": str(out)}).execute(txt2img())
    return (out / "warm_00000.png").read_bytes()


def req(method, path, payload=None):
    body = json.dumps(payload).encode() if payload is not None else b""
    return Request(method, path, {"content-type": "application/json"}, body)


def test_the_routes_and_a_warmed_request_bitwise_a_cold_one(
        workflows, tmp_path, monkeypatch, cold_png):
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("CDT_CACHE", "0")
    (tmp_path / "m.json").write_text("{}")

    async def body():
        c = Controller(tmp_path / "m.json", device="cpu",
                       model_registry=ModelRegistry("cpu", seed=0))
        app = App(c)
        await c.startup()
        try:
            before = (await app.dispatch(req("GET", "/distributed/warmup"))
                      ).payload
            health0 = c.health()["warmup"]
            bad = await app.dispatch(req("POST", "/distributed/warmup",
                                         {"models": "tiny"}))
            done = (await app.dispatch(req("POST", "/distributed/warmup", {
                "models": ["tiny"], "wait": True}))).payload
            health = (await app.dispatch(req("GET", "/distributed/health"))
                      ).payload
            q = (await app.dispatch(req("POST", "/distributed/queue",
                                        {"prompt": txt2img()}))).payload
            for _ in range(3000):
                if c.queue.history.get(q["prompt_id"]):
                    break
                await asyncio.sleep(0.01)
            after = (await app.dispatch(req("GET", "/distributed/warmup"))
                     ).payload
            return (before, health0, bad, done, health,
                    c.queue.history[q["prompt_id"]], after)
        finally:
            await c.shutdown()

    before, health0, bad, done, health, entry, after = asyncio.run(body())
    assert before["state"] == health0 == "cold"
    assert bad.status == 400
    assert done["state"] == "ready" and done["outcomes"] == {"compiled": 1}
    assert health["warmup"] == "ready"
    assert entry["status"] == "success"
    assert after["bundle_builds"] == done["bundle_builds"] == 1
    assert (tmp_path / "out" / "warm_00000.png").read_bytes() == cold_png


def test_a_controller_warms_at_boot_under_cdt_warmup(workflows, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("CDT_WARMUP", "1")
    monkeypatch.setenv("CDT_WARMUP_MODELS", "tiny")
    (tmp_path / "m.json").write_text("{}")

    async def body():
        c = Controller(tmp_path / "m.json", device="cpu",
                       model_registry=ModelRegistry("cpu", seed=0))
        await c.startup()
        try:
            states = {c.health()["warmup"]}
            await c._warmup_task
            states.add(c.health()["warmup"])
            return states, c.warmup.status()
        finally:
            await c.shutdown()

    states, status = asyncio.run(body())
    assert "ready" in states and states <= {"warming", "ready"}
    assert status["outcomes"] == {"compiled": 1}


def test_the_warm_call_runs_at_the_keys_geometry(monkeypatch):
    """One CFG-doubled denoiser call at the key's latent and one decode
    of one latent."""
    registry = ModelRegistry("cpu", seed=0)
    pipeline = registry.get("tiny").pipeline
    seen = []
    forward, decode = pipeline.unet.forward, pipeline.vae.decode
    monkeypatch.setattr(pipeline.unet, "forward", lambda x, *a, **k: (
        seen.append(("unet", tuple(x.shape))), forward(x, *a, **k))[1])
    monkeypatch.setattr(pipeline.vae, "decode", lambda z: (
        seen.append(("vae", tuple(z.shape))), decode(z))[1])
    twarm.warm_txt2img(registry.get("tiny"),
                       tcat.ProgramKey("txt2img", "tiny", 48, 32, 3, batch=2))
    ds = pipeline.vae.config.downscale
    c = pipeline.latent_channels
    assert seen == [("unet", (4, 48 // ds, 32 // ds, c)),
                    ("vae", (1, 48 // ds, 32 // ds, c))]
    assert Path(twarm.__file__).name == "warmup.py"


def test_the_registry_is_built_once_under_concurrent_first_use(
        tmp_path, monkeypatch):
    """The warm pass's thread and the warmup route (or a request) may ask
    a fresh controller for its registry at once: both get the same one,
    so the bundle the pass built is the one the request finds."""
    import threading
    import time

    from comfyui_distributed_tpu_torch.models import registry as treg

    made = []

    class Slow(treg.ModelRegistry):
        def __init__(self, *a, **k):
            time.sleep(0.05)
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(treg, "ModelRegistry", Slow)
    (tmp_path / "m.json").write_text("{}")
    c = Controller(tmp_path / "m.json", device="cpu")
    got = []
    threads = [threading.Thread(target=lambda: got.append(c.model_registry))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(made) == 1 and all(r is made[0] for r in got)
    assert c.warmup.status()["bundle_builds"] == 0
