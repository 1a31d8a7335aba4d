"""The port's serving front door (``cluster/frontdoor``) against the JAX
package's, on the CPU: the classifier gives JAX's reasons and group keys,
admission JAX's decisions and ``Retry-After`` under one injected clock,
the batcher JAX's flushes; ``generate_microbatch`` gives each request
its solo run's bits and JAX's images within the repo's 2e-4 when handed
JAX's noise; a failed group falls back to solo runs. Then the whole door
through the port's ``App`` on a ``tiny`` controller: a group of four,
each PNG bitwise its solo run, a coalesced twin, a result-tier repeat,
``cache: "bypass"``, a deadline, the conditioning tier, a 429, the
orchestration path for a graph that cannot batch, the stats routes, and
``CDT_FRONTDOOR=0``/``CDT_CACHE=0`` answering as before the door."""

import asyncio
import dataclasses
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.cluster.frontdoor import admission as jadm
from comfyui_distributed_tpu.cluster.frontdoor import batcher as jbat
from comfyui_distributed_tpu.cluster.frontdoor import classifier as jcls
from comfyui_distributed_tpu_torch import telemetry as ptel
from comfyui_distributed_tpu_torch.api.app import App, Request
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.frontdoor import admission as tadm
from comfyui_distributed_tpu_torch.cluster.frontdoor import batcher as tbat
from comfyui_distributed_tpu_torch.cluster.frontdoor import classifier as tcls
from comfyui_distributed_tpu_torch.cluster.frontdoor import microbatch as tmb
from comfyui_distributed_tpu_torch.cluster.runtime import PromptJob
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.graph.executor import strip_meta
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
HW = 32


def batchable(seed=1, wh=16, steps=2, cfg=2.0, sampler="euler",
              model="tiny", pos="x", neg="", prefix=None):
    p = {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": model}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": pos, "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": neg, "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": steps, "cfg": cfg,
            "width": wh, "height": wh, "sampler_name": sampler}},
    }
    if prefix is not None:
        p["5"] = {"class_type": "SaveImage",
                  "inputs": {"images": ["4", 0], "filename_prefix": prefix}}
    return p


# --- the classifier ----------------------------------------------------------


def _mutated(mutate):
    p = batchable()
    mutate(p)
    return p


CLASSIFY_TABLE = [
    batchable(), batchable(wh=24, cfg=1.0, sampler="heun"),
    batchable(sampler="dpmpp_2m", steps=7), batchable(sampler="ddim"),
    _mutated(lambda p: p["4"]["inputs"].update(sampler_name="euler_ancestral")),
    _mutated(lambda p: p["4"]["inputs"].update(width=["2", 0])),
    _mutated(lambda p: p["4"]["inputs"].update(cfg=True)),
    _mutated(lambda p: p["4"]["inputs"].update(steps=None)),
    _mutated(lambda p: p["4"]["inputs"].update(sampler_name=3)),
    _mutated(lambda p: p["4"]["inputs"].update(batch_per_device=1.5)),
    _mutated(lambda p: p["4"]["inputs"].update(batch_per_device=2)),
    _mutated(lambda p: p["4"]["inputs"].update(model="literal-not-a-link")),
    _mutated(lambda p: p["4"]["inputs"].update(model=["1", 1])),
    _mutated(lambda p: p["4"]["inputs"].update(model=["9", 0])),
    _mutated(lambda p: p["1"]["inputs"].update(ckpt_name="")),
    _mutated(lambda p: p["4"]["inputs"].pop("scheduler", None)),
    _mutated(lambda p: p.update({"9": {"class_type": "DistributedCollector",
                                       "inputs": {"images": ["4", 0]}}})),
    _mutated(lambda p: p.update({"9": {"class_type": "LoraLoader",
                                       "inputs": {}}})),
    _mutated(lambda p: p.update({"9": dict(p["4"])})),
    _mutated(lambda p: p.update({"5": {"class_type": "DistributedSeed",
                                       "inputs": {"seed": 9}}})
             or p["4"]["inputs"].update(seed=["5", 0])),
    _mutated(lambda p: p.update({"9": "not a node"})),
    _mutated(lambda p: p.update({"9": {"inputs": {}}})),
    {}, {"1": {"class_type": "SaveImage", "inputs": {}}}, [], None,
]


def _classified(mod, prompt):
    c = mod.classify(prompt)
    key = None if c.group_key is None else (
        dataclasses.astuple(c.group_key), c.group_key.label(),
        dataclasses.astuple(c.group_key.program_key()))
    return c.batchable, c.reason, key, c.sampler_node_id


@pytest.mark.parametrize("prompt", CLASSIFY_TABLE)
def test_classify_matches_jax_on_a_table(prompt):
    assert _classified(tcls, prompt) == _classified(jcls, prompt)


def test_classify_matches_jax_on_the_shipped_workflows():
    seen = set()
    for path in sorted((ROOT / "workflows").glob("*.json")):
        prompt = strip_meta(json.loads(path.read_text()))
        got = _classified(tcls, prompt)
        assert got == _classified(jcls, prompt), path.name
        seen.add(got[1].split(":")[0])
        # the same workflow stripped of its collector and seed nodes
        if "5" in prompt and prompt["5"]["class_type"] == "TPUTxt2Img":
            cut = {k: v for k, v in prompt.items()
                   if v["class_type"] not in ("DistributedCollector",
                                              "DistributedSeed")}
            cut["5"] = dict(cut["5"], inputs=dict(cut["5"]["inputs"], seed=3))
            got = _classified(tcls, cut)
            assert got == _classified(jcls, cut)
            seen.add(got[1].split(":")[0])
    assert {"node_outside_allowlist", "no_batchable_sampler",
            "dynamic_geometry"} <= seen
    assert tcls.BATCHABLE_NODE_ALLOWLIST == jcls.BATCHABLE_NODE_ALLOWLIST
    assert tpipe.DETERMINISTIC_SAMPLERS == jcls.DETERMINISTIC_SAMPLERS
    assert tcls.fingerprint(batchable()) == jcls.fingerprint(batchable())


# --- admission ---------------------------------------------------------------


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


ADMIT_SCRIPT = [
    # (advance s, depth, healthy fraction, tenant, priority)
    (0.0, 0, 1.0, "a", "interactive"), (0.0, 3, 1.0, "a", "interactive"),
    (0.0, 4, 1.0, "a", "interactive"), (0.0, 5, 1.0, "a", "batch"),
    (0.0, 7, 1.0, "a", "interactive"), (0.0, 12, 1.0, "a", "interactive"),
    (0.0, 40, 1.0, "b", "batch"), (0.0, 2, 0.5, "b", "interactive"),
    (0.0, 4, 0.5, "b", "interactive"), (0.0, 1, 0.1, "c", "batch"),
    (0.0, 0, 0.1, "c", "interactive"), (0.0, 0, 1.0, "a", "interactive"),
    (0.0, 0, 1.0, "a", "interactive"), (0.0, 0, 1.0, "a", "interactive"),
    (0.1, 0, 1.0, "a", "interactive"), (0.6, 0, 1.0, "a", "interactive"),
    (0.0, 9, 1.0, "a", "interactive"), (2.0, 0, 1.0, "d", "batch"),
    (0.0, 0, 1.0, "e", "interactive"), (0.0, 0, 1.0, "f", "interactive"),
    (0.0, 0, 1.0, "b", "interactive"),
]


def _admit_trace(mod):
    clock = Clock()
    state = {"depth": 0, "frac": 1.0}
    ctl = mod.AdmissionController(
        lambda: state["depth"], soft_depth=3, shed_depth=8, tenant_rate=2.0,
        tenant_burst=4.0, healthy_fraction=lambda: state["frac"],
        clock=clock)
    out = []
    for dt, depth, frac, tenant, prio in ADMIT_SCRIPT:
        clock.t += dt
        state.update(depth=depth, frac=frac)
        d = ctl.admit(tenant, prio)
        out.append((d.outcome, d.reason, d.retry_after_s, d.depth,
                    ctl.shed_threshold(prio)))
    return out, ctl.summary()


def test_admission_decides_as_jax_under_one_clock(monkeypatch):
    monkeypatch.setenv("CDT_FD_MAX_TENANTS", "4")
    monkeypatch.setattr(jadm.constants, "FD_MAX_TENANTS", 4)
    jtrace, jsum = _admit_trace(jadm)
    ttrace, tsum = _admit_trace(tadm)
    assert ttrace == jtrace
    assert tsum == jsum
    outcomes = {o for o, *_ in ttrace}
    reasons = {r for _, r, *_ in ttrace}
    assert outcomes == {"admitted", "queued", "shed"}
    assert reasons == {"ok", "busy", "overload", "tenant_rate"}
    assert max(r for _, _, r, *_ in ttrace) == 20.0     # 2 s × 40 / 4
    # Retry-After is capped at 30 s however deep the overload
    ctl = tadm.AdmissionController(lambda: 10_000, shed_depth=8,
                                   healthy_fraction=lambda: 1.0)
    assert ctl.admit("t", "interactive").retry_after_s == 30.0
    for a, b in ((3.0, 1.0), (1.0, 0.5)):
        jb, tb = (m.TokenBucket(a, b, clock=Clock()) for m in (jadm, tadm))
        assert ([jb.take(), jb.seconds_until_token()]
                == [tb.take(), tb.seconds_until_token()])


def test_breaker_health_scales_the_threshold():
    from comfyui_distributed_tpu_torch.cluster import resilience

    resilience.BREAKERS.reset()
    try:
        assert tadm.breaker_healthy_fraction() == 1.0
        resilience.BREAKERS.get("w0")
        resilience.BREAKERS.trip("w1")
        assert tadm.breaker_healthy_fraction() == 0.5
        ctl = tadm.AdmissionController(lambda: 0, shed_depth=100)
        assert ctl.shed_threshold("interactive") == 50
        assert ctl.shed_threshold("batch") == 25
    finally:
        resilience.BREAKERS.reset()


# --- the batcher -------------------------------------------------------------


@dataclasses.dataclass
class Member:
    prompt_id: str
    priority: str = "interactive"
    enqueued_at: float = 0.0


BATCH_SCRIPT = [
    ("submit", 16, "p1", "interactive"), ("submit", 16, "p2", "batch"),
    ("flush",), ("advance", 0.03), ("flush",),
    *[("submit", 16, f"q{i}", "interactive") for i in range(6)],
    ("flush",), ("advance", 0.03), ("flush",),
    ("submit", 16, "bg", "batch"), ("advance", 0.001),
    ("submit", 24, "fg", "interactive"), ("advance", 0.03), ("flush",),
    ("cap", False), ("submit", 16, "h1", "interactive"), ("advance", 0.03),
    ("flush",), ("submit", 16, "h2", "batch"), ("advance", 0.03), ("flush",),
    ("submit", 24, "h3", "interactive"), ("advance", 0.5), ("flush",),
    ("wait", "80"), ("submit", 32, "w1", "batch"), ("advance", 0.2),
    ("submit", 40, "w2", "interactive"), ("advance", 0.05), ("flush",),
    ("cap", True), ("advance", 0.05), ("flush",),
]


def _batch_trace(mod, cls_mod, monkeypatch):
    monkeypatch.delenv("CDT_FD_MAX_WAIT_MS", raising=False)
    flushed, clock, gate = [], Clock(), {"open": True}
    b = mod.CoalescingBatcher(
        lambda members, ids: flushed.append(
            ([m.prompt_id for m in members], ids)),
        window_ms=25, max_batch=4, capacity=lambda: gate["open"],
        clock=clock)
    trace = []
    for op, *args in BATCH_SCRIPT:
        if op == "submit":
            wh, pid, prio = args
            b.submit(cls_mod.classify(batchable(wh=wh)).group_key,
                     Member(pid, prio, clock.t), "4")
        elif op == "advance":
            clock.t += args[0]
        elif op == "cap":
            gate["open"] = args[0]
        elif op == "wait":
            monkeypatch.setenv("CDT_FD_MAX_WAIT_MS", args[0])
        else:
            n = b.flush_ready()
            deadline = b._next_deadline()
            trace.append((n, b.pending_count, b.pending_by_priority(),
                          b.group_summary(),
                          None if deadline is None
                          else round(deadline - clock.t, 9)))
    return flushed, trace


def test_the_batcher_flushes_as_jax_does(monkeypatch):
    jflushed, jtrace = _batch_trace(jbat, jcls, monkeypatch)
    tflushed, ttrace = _batch_trace(tbat, tcls, monkeypatch)
    assert tflushed == jflushed
    assert ttrace == jtrace
    sizes = [len(ids) for ids, _ in tflushed]
    assert max(sizes) == 4 and ["fg"] in [ids for ids, _ in tflushed]


# --- the microbatch ----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny fp32 stack in both packages with the same weights."""
    from comfyui_distributed_tpu.diffusion import pipeline as jpipe
    from comfyui_distributed_tpu.models import text as jtext
    from comfyui_distributed_tpu.models import unet as junet
    from comfyui_distributed_tpu.models import vae as jvae
    from comfyui_distributed_tpu_torch.models import unet as tunet
    from comfyui_distributed_tpu_torch.models import vae as tvae
    from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax

    model, params = junet.init_unet(junet.UNetConfig.tiny(dtype="float32"),
                                    jax.random.key(0), sample_shape=(8, 8, 4),
                                    context_len=16)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(16, 16))
    jp = jpipe.Txt2ImgPipeline(model, params, vae)
    unet = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         jax.tree_util.tree_map(np.asarray, params)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray,
                                                     vae.dec_params))
    tp = tpipe.Txt2ImgPipeline(unet, tv.eval())
    enc = jtext.TextEncoder(dataclasses.replace(
        jtext.TextEncoderConfig.tiny(), dtype="float32")).init(
            jax.random.key(2))
    conds = []
    for text in ("a cat", "a dog"):
        ctx, pooled = enc.encode([text])
        unc, upooled = enc.encode([""])
        conds.append([np.array(a) for a in (
            ctx, unc, np.asarray(pooled)[:, :8], np.asarray(upooled)[:, :8])])
    return jpipe, jp, tp, conds


def test_generate_microbatch_is_bitwise_solo_and_jax_within_tol(
        tiny_pair, monkeypatch):
    from comfyui_distributed_tpu.parallel import build_mesh

    jpipe, jp, tp, conds = tiny_pair
    spec = dict(height=64, width=64, steps=2, sampler="euler",
                scheduler="karras", guidance_scale=5.0)
    seeds = [11, 12]
    args = [[torch.from_numpy(a) for a in c] for c in conds]
    solo = [tp.generate(tpipe.GenerationSpec(**spec), s, *a)
            for s, a in zip(seeds, args)]
    group = tp.generate_microbatch(
        tpipe.GenerationSpec(**spec), seeds, [a[0] for a in args],
        [a[1] for a in args], [a[2] for a in args], [a[3] for a in args])
    assert len(group) == 2
    for g, s in zip(group, solo):
        assert g.shape == (1, 64, 64, 3) and torch.equal(g, s)
    # JAX's microbatch against the port's, each request given JAX's noise
    ref = jp.generate_microbatch(
        build_mesh({"dp": 1}), jpipe.GenerationSpec(**spec), seeds,
        [jnp.asarray(c[0]) for c in conds], [jnp.asarray(c[1]) for c in conds],
        [jnp.asarray(c[2]) for c in conds], [jnp.asarray(c[3]) for c in conds])
    noise = {}
    for s in seeds:
        k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(s), 0))
        noise[s] = torch.from_numpy(np.array(
            jax.random.normal(k_noise, (1, 32, 32, 4), jnp.float32)))
    monkeypatch.setattr(tpipe, "seed_generator", lambda seed, device: seed)
    monkeypatch.setattr(tp, "initial_noise", lambda spec, seed: noise[seed])
    out = tp.generate_microbatch(
        tpipe.GenerationSpec(**spec), seeds, [a[0] for a in args],
        [a[1] for a in args], [a[2] for a in args], [a[3] for a in args])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL,
                                   rtol=TOL)
    # the demux of a stacked output, as JAX's on one device
    stacked = torch.arange(24.0).reshape(6, 4)
    jparts = jpipe.demux_microbatch(jnp.asarray(stacked.numpy()),
                                    build_mesh({"dp": 1}), 3, 2)
    for t, j in zip(tpipe.demux_microbatch(stacked, 3, 2), jparts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match=r"n_dp\(1\)"):
        tpipe.demux_microbatch(stacked, 4, 2)


def test_microbatch_refuses_as_jax_does(tiny_pair):
    from comfyui_distributed_tpu.parallel import build_mesh

    jpipe, jp, tp, conds = tiny_pair
    c = conds[0]
    for sampler in ("euler_ancestral", "dpmpp_sde"):
        with pytest.raises(ValueError) as jerr:
            jp.generate_microbatch(build_mesh({"dp": 1}),
                                   jpipe.GenerationSpec(sampler=sampler),
                                   [1], [c[0]], [c[1]])
        with pytest.raises(ValueError) as terr:
            tp.generate_microbatch(tpipe.GenerationSpec(sampler=sampler), [1],
                                   [torch.from_numpy(c[0])],
                                   [torch.from_numpy(c[1])])
        assert str(terr.value) == str(jerr.value)
    clone = tp.with_control(types.SimpleNamespace(uid="cn"), 1.0)
    with pytest.raises(ValueError, match="does not support ControlNet"):
        clone.generate_microbatch(tpipe.GenerationSpec(), [1],
                                  [torch.from_numpy(c[0])],
                                  [torch.from_numpy(c[1])])
    with pytest.raises(ValueError, match="length mismatch"):
        tp.generate_microbatch(tpipe.GenerationSpec(), [1, 2],
                               [torch.from_numpy(c[0])],
                               [torch.from_numpy(c[1])])


def _member(prompt, pid, cache_mode="use", fingerprint=None):
    return PromptJob(prompt_id=pid, prompt=strip_meta(prompt),
                     fingerprint=fingerprint, cache_mode=cache_mode)


def test_a_failed_group_falls_back_to_solo_and_loses_no_member(
        tmp_path, monkeypatch):
    registry = ModelRegistry("cpu", seed=0)
    prompts = [batchable(seed=s, wh=HW, steps=1) for s in (3, 4, 5)]
    prompts[2]["3"]["inputs"]["clip"] = ["9", 1]       # its prefix fails
    members = [_member(p, f"m{i}") for i, p in enumerate(prompts)]

    def boom(*a, **k):
        raise RuntimeError("group call failed")

    monkeypatch.setattr(tpipe.Txt2ImgPipeline, "generate_microbatch", boom)
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    ctx = {"model_registry": registry, "output_dir": str(tmp_path)}
    results = tmb.execute_group(members, {m.prompt_id: "4" for m in members},
                                ctx)
    assert results["m2"]["status"] == "error"
    ex = GraphExecutor(ctx)
    for m, p in zip(members[:2], prompts[:2]):
        entry = results[m.prompt_id]
        assert entry["status"] == "success" and entry["batch_size"] == 1
        assert torch.equal(entry["outputs"]["4"][0], ex.execute(p)["4"][0])
    snap = ptel.REGISTRY.snapshot()
    assert snap["cdt_batch_fallbacks_total"]["series"][0]["value"] == 1.0
    # the same members with the group call working: one call of two
    monkeypatch.undo()
    results = tmb.execute_group(members[:2],
                                {m.prompt_id: "4" for m in members}, ctx)
    for m, p in zip(members[:2], prompts[:2]):
        assert results[m.prompt_id]["batch_size"] == 2
        assert torch.equal(results[m.prompt_id]["outputs"]["4"][0],
                           ex.execute(p)["4"][0])


# --- the door, served --------------------------------------------------------


def post(app, path, payload):
    return app.dispatch(Request("POST", path,
                                {"content-type": "application/json"},
                                json.dumps(payload).encode()))


def get(app, path):
    return app.dispatch(Request("GET", path, {}, b""))


async def final(controller, pid, timeout=60.0):
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while loop.time() < end:
        entry = controller.queue.history.get(pid)
        if entry is not None:
            return entry
        await asyncio.sleep(0.02)
    raise TimeoutError(pid)


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry("cpu", seed=0)


@pytest.fixture
def served(tmp_path, monkeypatch, registry):
    """A master controller on the CPU with the ``tiny`` registry, a wide
    coalescing window and its own cache directory."""
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("CDT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("CDT_FD_WINDOW_MS", "400")
    (tmp_path / "m.json").write_text("{}")

    def make():
        return Controller(tmp_path / "m.json", device="cpu",
                          model_registry=registry)

    return make


def png(path: Path) -> bytes:
    return path.read_bytes()


def test_a_group_of_four_is_each_members_solo_run(served, tmp_path, registry):
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    out = tmp_path / "out"

    async def run():
        c = served()
        app = App(c)
        await c.startup()
        try:
            answers = await asyncio.gather(*[
                post(app, "/distributed/queue", {"prompt": batchable(
                    seed=s, wh=HW, pos="a red fox", neg="blurry",
                    prefix=f"fd{s}")}) for s in range(4)])
            # a byte-identical twin of member 0 while the group runs
            twin = await post(app, "/distributed/queue", {"prompt": batchable(
                seed=0, wh=HW, pos="a red fox", neg="blurry", prefix="fd0")})
            ids = [a.payload["prompt_id"] for a in answers]
            entries = [await final(c, i) for i in ids]
            twin_entry = await final(c, twin.payload["prompt_id"])
            # the same request again: the result tier answers
            again = await post(app, "/distributed/queue", {"prompt": batchable(
                seed=1, wh=HW, pos="a red fox", neg="blurry", prefix="fd1")})
            again_entry = await final(c, again.payload["prompt_id"])
            hist = await get(app, f"/distributed/history/"
                                  f"{again.payload['prompt_id']}")
            bypass = await post(app, "/distributed/queue", {
                "cache": "bypass", "prompt": batchable(
                    seed=2, wh=HW, pos="a red fox", neg="blurry",
                    prefix="fd2")})
            bypass_entry = await final(c, bypass.payload["prompt_id"])
            late = await post(app, "/distributed/queue", {
                "deadline_ms": 1, "prompt": batchable(
                    seed=9, wh=HW, pos="late", prefix="late")})
            late_entry = await final(c, late.payload["prompt_id"])
            stats = (await get(app, "/distributed/cache")).payload
            fd = (await get(app, "/distributed/frontdoor")).payload
            return (answers, twin, entries, twin_entry, again_entry, hist,
                    bypass_entry, late_entry, stats, fd)
        finally:
            await c.shutdown()

    (answers, twin, entries, twin_entry, again_entry, hist, bypass_entry,
     late_entry, stats, fd) = asyncio.run(run())
    for a in answers:
        assert a.status == 200
        assert a.payload["batched"] and not a.payload["coalesced"]
        assert a.payload["outcome"] == "admitted"
    assert [e["status"] for e in entries] == ["success"] * 4
    assert [e["batch_size"] for e in entries] == [4] * 4
    assert twin.payload["coalesced"] and twin.payload["batched"]
    assert twin_entry["coalesced_with"] == answers[0].payload["prompt_id"]
    assert twin_entry["status"] == "success"
    assert again_entry["cache"] == "hit" and again_entry["batch_size"] == 0
    assert hist.payload["cache"] == "hit"
    assert bypass_entry["batch_size"] == 1 and "cache" not in bypass_entry
    assert late_entry["status"] == "expired"
    assert (tmp_path / "out" / "late_00000.png").exists() is False
    # every PNG is bitwise the solo run's (content_cache absent)
    solo_dir = tmp_path / "solo"
    ex = GraphExecutor({"model_registry": registry,
                        "output_dir": str(solo_dir)})
    for s in range(4):
        ex.execute(batchable(seed=s, wh=HW, pos="a red fox", neg="blurry",
                             prefix=f"fd{s}"))
        ref = png(solo_dir / f"fd{s}_00000.png")
        files = sorted(out.glob(f"fd{s}_*.png"))
        assert files and all(png(f) == ref for f in files), s
    # the shared texts encoded once; the result tier served one repeat
    # (the expired request never ran its encodes)
    assert stats["conditioning"]["miss"] == 2
    assert stats["conditioning"]["hit"] == 2 * 4 + 2 * 2 - 2
    assert stats["result"]["hit"] == 1 and stats["result"]["put"] == 5
    assert stats["coalescer"]["coalesced_waiters"] == 1
    assert fd["classified"] == {"batchable": 8}
    assert fd["admission"]["outcomes"] == {"admitted": 8}
    snap = ptel.REGISTRY.snapshot()
    sizes = snap["cdt_batch_size"]["series"]
    assert sizes and sizes[0]["count"] >= 2
    assert any(s["labels"] == {"status": "expired"}
               for s in snap["cdt_prompts_total"]["series"])


def test_shedding_answers_429_and_every_admitted_prompt_ends(
        served, monkeypatch):
    monkeypatch.setenv("CDT_FD_SHED_DEPTH", "3")

    async def run():
        c = served()
        app = App(c)
        await c.startup()
        try:
            answers = await asyncio.gather(*[
                post(app, "/distributed/queue", {"prompt": batchable(
                    seed=s, wh=16, steps=1, pos="shed")}) for s in range(6)])
            admitted = [a.payload["prompt_id"] for a in answers
                        if a.status == 200]
            return answers, [await final(c, p) for p in admitted]
        finally:
            await c.shutdown()

    answers, entries = asyncio.run(run())
    shed = [a for a in answers if a.status == 429]
    assert len(shed) == 3 and len(entries) == 3
    for a in shed:
        assert a.headers["Retry-After"] == str(int(a.payload["retry_after_s"]))
        assert a.payload["error"] == "overloaded"
        assert a.payload["outcome"] == "shed"
        assert a.payload["reason"] == "overload"
    assert all(e["status"] == "success" for e in entries)


def test_a_graph_that_cannot_batch_is_orchestrated(served):
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "distributed-txt2img.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "tiny"
    prompt["5"]["inputs"].update(width=16, height=16, steps=1)

    async def run():
        c = served()
        app = App(c)
        await c.startup()
        try:
            res = await post(app, "/distributed/queue",
                             {"prompt": prompt, "priority": "batch",
                              "tenant": "t1"})
            # queued behind it (its class: the queue orders by priority)
            # with a deadline of 1 ms: expired, not run
            late = await post(app, "/distributed/queue",
                              {"prompt": prompt, "deadline_ms": 1,
                               "priority": "batch"})
            return (res, await final(c, res.payload["prompt_id"]),
                    await final(c, late.payload["prompt_id"]),
                    (await get(app, "/distributed/frontdoor")).payload)
        finally:
            await c.shutdown()

    res, entry, late, fd = asyncio.run(run())
    assert res.status == 200 and res.payload["batched"] is False
    assert res.payload["outcome"] == "admitted"
    assert entry["status"] == "success" and "batch_size" not in entry
    assert late["status"] == "expired"
    assert fd["classified"] == {"node_outside_allowlist:DistributedCollector": 2}


def test_an_interrupt_drops_batch_members_and_settles_their_waiters():
    """Each member of a pending batch job ends ``interrupted``, and a
    waiter coalesced on one of them settles with it (the job-done
    callbacks run for the dropped jobs too)."""
    from comfyui_distributed_tpu_torch.cluster.cache.coalesce import (
        InflightCoalescer)
    from comfyui_distributed_tpu_torch.cluster.runtime import PromptQueue

    async def run():
        q = PromptQueue()
        co = InflightCoalescer()
        q.add_job_done_callback(lambda: co.resolve(q.history))
        members = [PromptJob(f"m{i}", {}, priority=p)
                   for i, p in enumerate(("batch", "interactive"))]
        co.lead("fp", "m0")
        co.join("fp", PromptJob("w", {}))
        assert q.enqueue_batch(members, {"m0": "4", "m1": "4"}) == ["m0", "m1"]
        assert q.queue_remaining == 1
        dropped = q.interrupt()
        await q.stop()
        return dropped, q.history, co.stats()

    dropped, history, stats = asyncio.run(run())
    assert dropped == 2
    assert history["m0"] == history["m1"] == {"status": "interrupted",
                                              "duration": 0.0}
    assert history["w"]["status"] == "interrupted"
    assert history["w"]["coalesced_with"] == "m0"
    assert stats["inflight"] == 0


def test_the_knobs_off_answer_as_before_the_door(served, monkeypatch):
    monkeypatch.setenv("CDT_FRONTDOOR", "0")
    monkeypatch.setenv("CDT_CACHE", "0")

    async def run():
        c = served()
        assert c.frontdoor is None and c.cache is None
        app = App(c)
        await c.startup()
        try:
            res = await post(app, "/distributed/queue", {
                "prompt": batchable(seed=1, wh=16, steps=1), "tenant": "x",
                "priority": "batch", "deadline_ms": 1, "cache": "bypass"})
            entry = await final(c, res.payload["prompt_id"])
            hist = await get(app, f"/distributed/history/"
                                  f"{res.payload['prompt_id']}")
            stats = [(await get(app, p)).payload
                     for p in ("/distributed/frontdoor", "/distributed/cache")]
            clear = await post(app, "/distributed/cache/clear", {})
            return res, entry, hist, stats, clear
        finally:
            await c.shutdown()

    res, entry, hist, stats, clear = asyncio.run(run())
    assert set(res.payload) == {"prompt_id", "number", "node_errors",
                                "worker_count", "trace_id"}
    assert entry["status"] == "success"       # fields validated, not acted on
    assert set(hist.payload) == {"prompt_id", "status", "error", "duration",
                                 "outputs"}
    assert stats == [{"enabled": False}, {"enabled": False}]
    assert clear.payload == {"enabled": False}


def test_cache_routes_answer_and_clear_both_memory_tiers(served):
    async def run():
        c = served()
        app = App(c)
        await c.startup()
        try:
            c.cache.conditioning.put("a", {"x": torch.ones(2)})
            c.cache.results.put("b", {"x": torch.ones(3)})
            before = (await get(app, "/distributed/cache")).payload
            cleared = await post(app, "/distributed/cache/clear", {})
            after = (await get(app, "/distributed/cache")).payload
            cors = await get(app, "/distributed/frontdoor")
            return before, cleared, after, cors
        finally:
            await c.shutdown()

    before, cleared, after, cors = asyncio.run(run())
    assert before["enabled"] and before["conditioning"]["entries"] == 1
    assert cleared.payload == {"status": "cleared", "dropped": 2}
    assert after["conditioning"]["entries"] == after["result"]["entries"] == 0
    assert cors.headers.get("Access-Control-Allow-Origin") == "*"
