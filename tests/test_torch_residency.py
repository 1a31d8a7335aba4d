"""The port's card-memory residency planner (``cluster/residency.py``)
against the JAX package's, on the CPU: one seeded random trace of
acquire, touch, pin, unpin, release and plan gives the same victims, in
the same order, the same refusals and the same resident sets from both
planners; then the planner bound to a ``ModelRegistry``: a second bundle
over the budget evicts the first, whose parameters leave the device
although the caller still holds it, and the next ``get`` builds it
again; a pinned bundle is never evicted (the acquire raises); a request
pins its bundle; the knob turns the planner on and off; an encode on
a pool thread holds its bundle against a concurrent ``get``, and a pin
refuses a bundle already evicted. Tensor parallelism:
``tp_shard_bytes`` equal to JAX's for the four tiny families at tp 1, 2
and 4; rank 0's planned and held shard bytes; the degree from the
mesh under ``CDT_MESH_TIER``."""

import threading

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.cluster import residency as jres
from comfyui_distributed_tpu_torch import telemetry as ptel
from comfyui_distributed_tpu_torch.cluster import residency as tres
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

NAMES = ("sdxl", "flux", "wan", "sd15", "sd3")


def replay(mod, ops, budget):
    """Apply ``ops`` to a fresh planner of ``mod``; every outcome, with the
    evictions ``on_evict`` saw, in order."""
    evicted = []
    planner = mod.ResidencyPlanner(budget, on_evict=evicted.append)
    log = []
    for op, name, nbytes, prio in ops:
        try:
            if op == "acquire":
                out = planner.acquire(name, nbytes, priority=prio)
            elif op == "plan":
                out = planner.plan(name, nbytes)
            else:
                out = getattr(planner, op)(name)
            result = ("ok", out)
        except mod.ResidencyError as e:
            result = ("refused", str(e))
        log.append((op, name, result, planner.resident(),
                    planner.resident_bytes(), list(evicted)))
    return log


def random_trace(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        op = rng.choice(["acquire"] * 4 + ["touch", "pin", "unpin",
                                           "release", "plan"])
        ops.append((str(op), str(rng.choice(NAMES)),
                    int(rng.integers(1, 45)), int(rng.integers(0, 3))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_seeded_trace_evicts_alike_in_both_packages(seed):
    ops = random_trace(seed)
    got = replay(tres, ops, budget=100)
    want = replay(jres, ops, budget=100)
    assert got == want
    outcomes = {r[2][0] for r in got}
    assert outcomes == {"ok", "refused"}       # the trace reaches both
    assert got[-1][5], "the trace evicted nothing"


def test_an_unlimited_planner_never_evicts_and_pins_hold():
    for mod in (tres, jres):
        p = mod.ResidencyPlanner(0)
        for i, name in enumerate(NAMES):
            assert p.acquire(name, 10 ** 12) == []
        assert p.resident() == list(NAMES)
        with pytest.raises(mod.ResidencyError, match="non-resident"):
            p.pin("nope")
    p = tres.ResidencyPlanner(10)
    p.acquire("a", 6)
    with p.pinned("a"):
        with pytest.raises(tres.ResidencyError, match="pinned"):
            p.acquire("b", 6)
        with pytest.raises(tres.ResidencyError, match="in-flight"):
            p.release("a")
    assert p.acquire("b", 6) == ["a"]
    with pytest.raises(tres.ResidencyError, match="never be resident"):
        p.acquire("c", 11)


# --- the planner bound to a registry -----------------------------------------


def sizes():
    r = ModelRegistry("cpu", seed=0)
    return {n: tres.bundle_bytes(r.get(n)) for n in ("flux-tiny", "sd3-tiny")}


def on_device(bundle) -> int:
    return sum(p.numel() for m in bundle.device_modules()
               for p in m.parameters() if p.device == bundle.device)


def test_a_bundle_over_the_budget_evicts_the_last_used():
    s = sizes()
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    r = ModelRegistry("cpu", seed=0,
                      hbm_budget_bytes=s["flux-tiny"] + s["sd3-tiny"] - 1)
    planner = r.residency.planner
    flux = r.get("flux-tiny")
    assert r.get("flux-tiny") is flux and planner.resident() == ["flux-tiny"]
    assert planner.resident_bytes() == s["flux-tiny"] > 0
    sd3 = r.get("sd3-tiny")
    # the evicted bundle gave its device memory back, though held here
    assert planner.resident() == ["sd3-tiny"]
    assert flux.released and on_device(flux) == 0
    assert tres.bundle_bytes(flux) == 0
    assert "flux-tiny" not in r._cache and not getattr(sd3, "released", False)
    snap = ptel.REGISTRY.snapshot()
    ev = snap["cdt_residency_evictions_total"]["series"]
    assert [(e["labels"], e["value"]) for e in ev] == [({"reason": "budget"},
                                                        1.0)]
    assert snap["cdt_resident_bytes"]["series"][0]["value"] == s["sd3-tiny"]
    assert snap["cdt_resident_models"]["series"][0]["value"] == 1
    # the next get builds it again, bit for bit the same random init
    again = r.get("flux-tiny")
    assert again is not flux and on_device(again) > 0
    assert planner.resident() == ["flux-tiny"] and sd3.released
    ref = ModelRegistry("cpu", seed=0).get("flux-tiny")
    for a, b in zip(again.core.parameters(), ref.core.parameters()):
        assert torch.equal(a, b)


def test_a_pinned_bundle_is_never_evicted():
    s = sizes()
    r = ModelRegistry("cpu", seed=0,
                      hbm_budget_bytes=s["flux-tiny"] + s["sd3-tiny"] - 1)
    planner = r.residency.planner
    sd3 = r.get("sd3-tiny")
    with tres.pinned_bundle(sd3):
        with pytest.raises(tres.ResidencyError, match="pinned"):
            r.get("flux-tiny")
        # the bundle that could not be placed did not stay
        assert "flux-tiny" not in r._cache
        assert planner.resident() == ["sd3-tiny"] and on_device(sd3) > 0
    with r.residency.request("flux-tiny") as flux:
        assert sd3.released and planner.resident() == ["flux-tiny"]
        with pytest.raises(tres.ResidencyError, match="pinned"):
            planner.release("flux-tiny")
        with pytest.raises(tres.ResidencyError):
            r.get("sd3-tiny")
        assert on_device(flux) > 0
    assert planner.release("flux-tiny") and flux.released
    assert planner.resident() == [] and r._cache == {}
    # without a planner a pin is nothing
    plain = ModelRegistry("cpu", seed=0, hbm_budget_bytes=0)
    assert plain.residency is None
    with tres.pinned_bundle(plain.get("sd3-tiny")):
        pass


def test_bundle_bytes_count_a_device_without_an_index():
    """A bundle on ``cuda`` holds tensors on ``cuda:0``: the count reads
    the device's type and, when it names one, its index."""
    p = torch.nn.Parameter(torch.ones(4))
    cuda, cuda0, cuda1 = (torch.device(d) for d in ("cuda", "cuda:0",
                                                    "cuda:1"))
    fake = type("T", (), {"device": cuda0})()
    assert tres._on(fake, cuda) and tres._on(fake, cuda0)
    assert not tres._on(fake, cuda1) and not tres._on(fake, torch.device(
        "cpu"))
    assert tres._on(p, torch.device("cpu"))


def test_the_budget_knob(monkeypatch):
    monkeypatch.setenv("CDT_HBM_BUDGET_GB", "0.5")
    assert tres.hbm_budget_bytes() == jres.hbm_budget_bytes() == 1 << 29
    r = ModelRegistry("cpu", seed=0)
    assert r.residency.planner.budget == 1 << 29
    # no mesh: whole-bundle planning (tp 1)
    assert r.residency.measure(r.get("sd3-tiny")) == tres.bundle_bytes(
        r.get("sd3-tiny"))
    monkeypatch.setenv("CDT_HBM_BUDGET_GB", "0")
    assert tres.hbm_budget_bytes() == 0
    assert ModelRegistry("cpu", seed=0).residency is None
    monkeypatch.delenv("CDT_HBM_BUDGET_GB")
    assert ModelRegistry("cpu", seed=0).residency is None


def test_an_encode_pins_its_bundle_against_a_concurrent_get(monkeypatch):
    """A staged encode (``CLIPTextEncode`` on an encode-pool thread) holds
    its bundle: another thread's ``get`` of a model that does not fit
    beside it is refused while the encode runs, the encode's bits are
    the unbudgeted encode's, and once it is done the same ``get``
    evicts the bundle."""
    from comfyui_distributed_tpu_torch.cluster.stages.pool import StagePool
    from comfyui_distributed_tpu_torch.graph.nodes_builtin import (
        CLIPTextEncode)

    s = sizes()
    r = ModelRegistry("cpu", seed=0,
                      hbm_budget_bytes=s["flux-tiny"] + s["sd3-tiny"] - 1)
    flux = r.get("flux-tiny")
    te = flux.text_encoder
    real, entered, release = te.encode, threading.Event(), threading.Event()

    def held(texts):
        entered.set()
        assert release.wait(60)
        return real(texts)

    monkeypatch.setattr(te, "encode", held)
    out, done = [], threading.Event()

    def run(items):
        out.append(CLIPTextEncode().execute(text=items[0], clip=te)[0])
        done.set()

    pool = StagePool("encode", 1, run)
    try:
        pool.put("a lighthouse")
        assert entered.wait(60)
        with pytest.raises(tres.ResidencyError, match="pinned"):
            r.get("sd3-tiny")
        assert not flux.released and "sd3-tiny" not in r._cache
        release.set()
        assert done.wait(60)
    finally:
        release.set()
        pool.stop()
    ref = ModelRegistry("cpu", seed=0).get("flux-tiny").text_encoder.encode(
        ["a lighthouse"])
    assert torch.equal(out[0]["context"], ref[0])
    assert torch.equal(out[0]["pooled"], ref[1])
    r.get("sd3-tiny")
    assert flux.released and r.residency.planner.resident() == ["sd3-tiny"]
    # the evicted bundle cannot be pinned: its encode is refused, not run
    # on parameters that left the device
    with pytest.raises(tres.ResidencyError, match="evicted"):
        CLIPTextEncode().execute(text="a lighthouse", clip=te)


def test_a_pin_refuses_an_evicted_bundle_even_after_its_rebuild(monkeypatch):
    """``pinned_bundle`` of a released bundle raises, also once the name
    is registered again by a rebuild (the pin would land on the new
    bundle), and leaves no pin behind; ``request`` and
    ``registry_bundle`` fetch again past a released bundle."""
    s = sizes()
    r = ModelRegistry("cpu", seed=0,
                      hbm_budget_bytes=s["flux-tiny"] + s["sd3-tiny"] - 1)
    planner = r.residency.planner
    old = r.get("flux-tiny")
    r.get("sd3-tiny")
    with pytest.raises(tres.ResidencyError, match="evicted"):
        with tres.pinned_bundle(old):
            pass
    new = r.get("flux-tiny")
    assert new is not old and old.released
    with pytest.raises(tres.ResidencyError, match="evicted"):
        with tres.pinned_bundle(old):
            pass
    assert planner._entries["flux-tiny"].pins == 0
    real, stale = r.get, [old]

    def racy(name):
        # an eviction and a rebuild land between the fetch and the pin
        return stale.pop() if stale else real(name)

    monkeypatch.setattr(r, "get", racy)
    with r.residency.request("flux-tiny") as held:
        assert held is new and planner._entries["flux-tiny"].pins == 1
    stale.append(old)
    with tres.registry_bundle(r, "flux-tiny") as held:
        assert held is new
    assert planner._entries["flux-tiny"].pins == 0
    plain = ModelRegistry("cpu", seed=0)
    with tres.registry_bundle(plain, "flux-tiny") as b:
        assert b is plain.get("flux-tiny")


FAMILIES = ("tiny", "flux-tiny", "sd3-tiny", "wan-tiny")


@pytest.fixture(scope="module")
def jax_cores():
    from comfyui_distributed_tpu.models.registry import ModelRegistry as JReg

    return {n: JReg().get(n)._core_params() for n in FAMILIES}


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_shard_bytes_as_jax(jax_cores, name, tp):
    """JAX's per-chip arithmetic, leaf for leaf (the port's core in JAX's
    fp32); the planned rank-0 extra is what rank 0's shard holds besides
    its bundle once it is cut (the slices of several parts: copies)."""
    bundle = ModelRegistry("cpu", seed=0).get(name)
    core = bundle.core.float()
    rules = tres._tp_rules_for(bundle)
    from comfyui_distributed_tpu.parallel import tensor as jt

    jrules = {"tiny": jt.UNET_TP_RULES,
              "wan-tiny": jt.WAN_TP_RULES}.get(name, jt.DIT_TP_RULES)
    mine = tres.tp_shard_bytes(core, rules, tp)
    assert mine == jres.tp_shard_bytes(jax_cores[name], jrules, tp)
    whole = tres.tp_shard_bytes(core, rules, 1)
    if tp > 1:
        from comfyui_distributed_tpu_torch.parallel import tensor as ttensor

        assert mine < whole
        planned = tres.shard_extra_bytes(bundle, tp)
        assert planned < whole - mine
        ttensor.shard_pipeline(bundle.pipeline, 0, tp)
        assert tres.shard_extra_bytes(bundle, tp) == planned
        # WAN's splits are each one part: views only
        assert (planned > 0) == (name != "wan-tiny")


def test_rank0_counts_its_held_shard_and_the_mesh_degree(monkeypatch):
    """Rank 0 holds its whole bundle and its shard's slices that are not
    views of it (GEGLU's two halves: copies; to_q/to_out: views); the
    planner reads the degree from the mesh, none under CDT_MESH_TIER=0."""
    from comfyui_distributed_tpu_torch.parallel import tensor as ttensor

    monkeypatch.setenv("CDT_HBM_BUDGET_GB", "4")
    r = ModelRegistry("cpu", seed=0)
    bundle = r.get("tiny")
    whole = tres.bundle_bytes(bundle)
    shard = ttensor.shard_pipeline(bundle.pipeline, 0, 2)
    plan = ttensor.shard_plan(bundle.core, 2)
    copies = sum(p.numel() * p.element_size()
                 for n, p in ttensor.core_of(shard).named_parameters()
                 if n in plan and ".ff.proj_in." in n)
    assert copies > 0
    assert tres.bundle_bytes(bundle, tp_shards=2) == whole + copies
    res = r.residency
    assert res.measure(bundle) == whole
    res.tp_shards_fn = lambda: 2
    assert res.measure(bundle) == whole + copies
    monkeypatch.setenv("CDT_MESH_TIER", "0")
    assert res.measure(bundle) == whole


def test_rank0_drops_its_shards_with_the_mesh_and_on_eviction(tmp_path):
    """Rank 0's shards go when the mesh they were cut for is dropped
    (``update_mesh`` away from tp runs the controller's ``reset_mesh``)
    and when the planner evicts their bundle: the pipeline keeps none,
    and at tp 1 the planner counts the whole bundle alone again."""
    import asyncio
    import json

    from comfyui_distributed_tpu_torch.api.app import App, Request
    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.parallel import tensor as ttensor

    s = sizes()
    r = ModelRegistry("cpu", seed=0,
                      hbm_budget_bytes=s["flux-tiny"] + s["sd3-tiny"] - 1)
    flux = r.get("flux-tiny")
    whole = tres.bundle_bytes(flux)
    ttensor.shard_pipeline(flux.pipeline, 0, 2)
    assert flux.pipeline._tp_shards
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"mesh": {"shape": {"dp": 1, "tp": 2}}}))
    app = App(Controller(path, device="cpu", model_registry=r))
    body = json.dumps({"shape": {"dp": 1}}).encode()
    resp = asyncio.run(app.dispatch(Request(
        "POST", "/distributed/config/update_mesh",
        {"content-type": "application/json"}, body, query={})))
    assert resp.status == 200
    assert "_tp_shards" not in flux.pipeline.__dict__
    assert tres.shard_extra_bytes(flux, 1) == 0
    r.residency.tp_shards_fn = lambda: 1
    assert r.residency.measure(flux) == tres.bundle_bytes(flux, 2) - (
        tres.shard_extra_bytes(flux, 2)) == whole
    # the eviction: the next bundle over the budget releases the sharded one
    ttensor.shard_pipeline(flux.pipeline, 0, 2)
    r.get("sd3-tiny")
    assert flux.released and "_tp_shards" not in flux.pipeline.__dict__
