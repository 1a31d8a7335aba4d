"""The port's shape catalog (``cluster/shape_catalog.py``) against the JAX
package's, on the CPU: the same keys from every shipped workflow, one
file format that each package reads from the other, union loads and
merged saves, observation with its cap and its kill switch, the knobs'
defaults, and the request path's observation: the sampler node, the
front door's staged and fused groups (each at JAX's batch)."""

import asyncio
import dataclasses
import json
from pathlib import Path

import pytest

from comfyui_distributed_tpu.cluster import shape_catalog as jcat
from comfyui_distributed_tpu.utils import constants as jconst
from comfyui_distributed_tpu_torch.api.app import App, Request
from comfyui_distributed_tpu_torch.cluster import shape_catalog as tcat
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.frontdoor import classifier as tcls
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.utils import constants as tconst
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
WORKFLOWS = sorted((ROOT / "workflows").glob("*.json"))


@pytest.fixture(autouse=True)
def fresh_catalog(tmp_path, monkeypatch):
    """Each test's own catalog file, the process catalogs dropped."""
    monkeypatch.setenv("CDT_SHAPE_CATALOG", str(tmp_path / "catalog.json"))
    for mod in (jcat, tcat):
        mod.reset_default_catalog()
    yield tmp_path / "catalog.json"
    for mod in (jcat, tcat):
        mod.reset_default_catalog()


def as_dicts(keys) -> list:
    return [k.to_dict() for k in keys]


@pytest.mark.parametrize("path", WORKFLOWS, ids=[p.stem for p in WORKFLOWS])
def test_keys_from_every_shipped_workflow_are_jaxs(path):
    prompt = json.loads(path.read_text())
    assert as_dicts(tcat.keys_from_prompt(prompt)) == \
        as_dicts(jcat.keys_from_prompt(prompt))


def _sampler(cls="TPUTxt2Img", **inputs):
    base = {"model": ["1", 0], "width": 64, "height": 48, "steps": 3}
    return {"1": {"class_type": "CheckpointLoader",
                  "inputs": {"ckpt_name": "tiny"}},
            "4": {"class_type": cls, "inputs": {**base, **inputs}}}


PROMPTS = [
    _sampler(), _sampler(batch_per_device=2), _sampler(width=["9", 0]),
    _sampler(steps=True), _sampler(model="literal"),
    _sampler("TPUFlowTxt2Img"), _sampler("TPUTxt2Video", frames=9),
    _sampler("TPUTxt2Video"), _sampler("TPUImg2Img"),
    {**_sampler(), "1": {"class_type": "LoraLoader", "inputs": {}}},
    {**_sampler(), "x": "not a node"},
]


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_keys_from_prompts_match_jax(prompt):
    assert as_dicts(tcat.keys_from_prompt(prompt)) == \
        as_dicts(jcat.keys_from_prompt(prompt))


def test_the_program_key_is_jaxs():
    assert [f.name for f in dataclasses.fields(tcat.ProgramKey)] == \
        [f.name for f in dataclasses.fields(jcat.ProgramKey)]
    assert tcat.PIPELINES == jcat.PIPELINES
    key = {"pipeline": "flow_tp", "model": "flux", "height": 1024,
           "width": 768, "steps": 28, "batch": 2, "frames": 0,
           "mesh": [["dp", 2], ["tp", 4]]}
    assert tcat.ProgramKey.from_dict(key).to_dict() == \
        jcat.ProgramKey.from_dict(key).to_dict() == key
    with pytest.raises(ValueError):
        tcat.ProgramKey("nope", "tiny", 8, 8, 1)
    # the classifier's group key names the catalog's program
    assert tcls.ProgramKey is tcat.ProgramKey
    assert not tcat.ProgramKey.from_dict(key).single_card
    assert tcat.ProgramKey("video_dp", "wan", 480, 832, 20, frames=33).single_card


def test_catalog_files_read_across_the_packages(tmp_path):
    ours = tcat.ShapeCatalog(tmp_path / "a.json")
    assert ours.seed_from_workflows(ROOT / "workflows") == 3
    ours.add(tcat.ProgramKey("txt2img", "tiny", 32, 32, 2, batch=2))
    assert ours.save()
    theirs = jcat.ShapeCatalog(tmp_path / "a.json")
    assert as_dicts(theirs.entries()) == as_dicts(ours.entries())
    theirs.add(jcat.ProgramKey("flow_sp", "flux", 512, 512, 4,
                               mesh=(("sp", 4),)))
    assert theirs.save()
    back = tcat.ShapeCatalog(tmp_path / "a.json")
    assert as_dicts(back.entries()) == as_dicts(theirs.entries())
    assert json.loads((tmp_path / "a.json").read_text())["version"] == \
        jcat.CATALOG_VERSION == tcat.CATALOG_VERSION


def test_load_is_a_union_and_save_merges(tmp_path):
    path = tmp_path / "c.json"
    a, b = tcat.ShapeCatalog(path), tcat.ShapeCatalog(path)
    a.add(tcat.ProgramKey("txt2img", "tiny", 16, 16, 1))
    a.save()
    b.add(tcat.ProgramKey("txt2img", "tiny", 32, 32, 1))
    b.save()                                  # merges a's entry first
    assert len(tcat.ShapeCatalog(path)) == 2
    path.write_text("{not json")
    assert len(tcat.ShapeCatalog(path)) == 0
    path.write_text(json.dumps({"entries": [{"pipeline": "bad"}, 3]}))
    assert len(tcat.ShapeCatalog(path)) == 0


def test_observe_persists_and_stops_at_the_cap(fresh_catalog, monkeypatch):
    tcat.observe("txt2img", "tiny", 16, 16, 2)
    tcat.observe("txt2img", "tiny", 16, 16, 2)
    assert len(tcat.ShapeCatalog(fresh_catalog)) == 1
    monkeypatch.setenv("CDT_SHAPE_CATALOG_MAX", "2")
    tcat.observe("txt2img", "tiny", 24, 24, 2)
    tcat.observe("txt2img", "tiny", 32, 32, 2)        # at the cap: dropped
    assert len(tcat.ShapeCatalog(fresh_catalog)) == 2
    monkeypatch.setenv("CDT_SHAPE_CATALOG_MAX", "")   # empty: uncapped
    tcat.observe("txt2img", "tiny", 32, 32, 2)
    assert len(tcat.ShapeCatalog(fresh_catalog)) == 3
    monkeypatch.setenv("CDT_SHAPE_OBSERVE", "0")
    tcat.observe("txt2img", "tiny", 40, 40, 2)
    assert len(tcat.ShapeCatalog(fresh_catalog)) == 3
    monkeypatch.setenv("CDT_SHAPE_OBSERVE", "1")
    tcat.observe("nope", "tiny", 40, 40, 2)           # never raises
    monkeypatch.setenv("CDT_SHAPE_CATALOG_MAX", "many")
    tcat.observe("txt2img", "tiny", 48, 48, 2)        # never raises
    assert len(tcat.ShapeCatalog(fresh_catalog)) == 3


def test_the_default_path_is_under_the_output_directory(monkeypatch,
                                                        tmp_path):
    monkeypatch.delenv("CDT_SHAPE_CATALOG")
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    assert tcat.default_catalog().path == \
        tmp_path / "out" / "shape_catalog_torch.json"


KNOBS = [("shape_observe", "SHAPE_OBSERVE", "CDT_SHAPE_OBSERVE"),
         ("shape_catalog_max", "SHAPE_CATALOG_MAX", "CDT_SHAPE_CATALOG_MAX"),
         ("warmup", "WARMUP", "CDT_WARMUP"),
         ("warmup_models", "WARMUP_MODELS", "CDT_WARMUP_MODELS"),
         ("preempt", "PREEMPT", "CDT_PREEMPT"),
         ("preempt_segment_steps", "PREEMPT_SEGMENT_STEPS",
          "CDT_PREEMPT_SEGMENT_STEPS"),
         ("preempt_max", "PREEMPT_MAX", "CDT_PREEMPT_MAX"),
         ("preempt_resume_retries", "PREEMPT_RESUME_RETRIES",
          "CDT_PREEMPT_RESUME_RETRIES"),
         ("preempt_sweep_s", "PREEMPT_SWEEP_S", "CDT_PREEMPT_SWEEP_S"),
         ("ckpt_mem_bytes", "CKPT_MEM_BYTES", "CDT_CKPT_MEM_BYTES"),
         ("ckpt_dir", "CKPT_DIR", "CDT_CKPT_DIR")]


@pytest.mark.parametrize("ours,theirs,env", KNOBS, ids=[k[2] for k in KNOBS])
def test_the_knobs_default_as_jaxs_and_refuse_garbage(ours, theirs, env,
                                                      monkeypatch):
    monkeypatch.delenv(env, raising=False)
    assert getattr(tconst, ours)() == getattr(jconst, theirs).get()
    if isinstance(getattr(tconst, ours)(), (bool, int, float)):
        monkeypatch.setenv(env, "garbage")
        with pytest.raises(tconst.KnobError):
            getattr(tconst, ours)()


# --- the request path observes ---------------------------------------------------


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry("cpu", seed=0)


def batchable(seed, hw=16, steps=1):
    return {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": "tiny"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "x", "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": steps, "cfg": 2.0, "width": hw,
            "height": hw, "sampler_name": "euler"}},
    }


def test_the_sampler_node_observes_its_program(fresh_catalog, registry):
    GraphExecutor({"model_registry": registry}).execute(batchable(1, 24, 2))
    assert as_dicts(tcat.ShapeCatalog(fresh_catalog).entries()) == [
        tcat.ProgramKey("txt2img", "tiny", 24, 24, 2).to_dict()]


@pytest.mark.parametrize("stages", ["1", "0"])
def test_a_front_door_group_observes_its_program(stages, fresh_catalog,
                                                 registry, tmp_path,
                                                 monkeypatch):
    """Two requests as one stacked group (staged, then fused): the group
    call observes the key at the spec's batch, as JAX's
    ``_observe_group_shape``; the node, which a stacked group never
    calls, observes nothing."""
    from comfyui_distributed_tpu_torch.graph import nodes_builtin

    monkeypatch.setenv("CDT_STAGES", stages)
    monkeypatch.setenv("CDT_CACHE", "0")
    monkeypatch.setenv("CDT_FD_WINDOW_MS", "2000")
    monkeypatch.setenv("CDT_FD_MAX_BATCH", "2")
    monkeypatch.setenv("CDT_STAGE_DECODE_BATCH", "2")
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(nodes_builtin, "_observe_shape",
                        lambda *a, **k: None)
    (tmp_path / "m.json").write_text("{}")

    async def body():
        c = Controller(tmp_path / "m.json", device="cpu",
                       model_registry=registry)
        app = App(c)
        await c.startup()
        try:
            answers = await asyncio.gather(*[app.dispatch(Request(
                "POST", "/distributed/queue",
                {"content-type": "application/json"},
                json.dumps({"prompt": batchable(s, 16, 3)}).encode()))
                for s in (1, 2)])
            ids = [a.payload["prompt_id"] for a in answers]
            for _ in range(3000):
                if all(c.queue.history.get(i, {}).get("status") == "success"
                       for i in ids):
                    break
                await asyncio.sleep(0.01)
            return [c.queue.history[i] for i in ids]
        finally:
            await c.shutdown()

    entries = asyncio.run(body())
    assert [e.get("batch_size") for e in entries] == [2, 2]
    assert as_dicts(tcat.ShapeCatalog(fresh_catalog).entries()) == [
        tcat.ProgramKey("txt2img", "tiny", 16, 16, 3, batch=1).to_dict()]
