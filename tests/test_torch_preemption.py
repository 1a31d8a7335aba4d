"""Step-granular preemption in the port (``cluster/preemption.py``,
``diffusion/checkpoint.py``, the prompt queue's order and sweep,
``Txt2ImgPipeline.generate_preemptible``) against the JAX package's, on
the CPU: the dequeue order and the deadline sweep on the same job lists,
the controller's policy, every sampler run in segments bitwise its
uncut run, a ``tiny`` request preempted by priority through the queue
and resumed (here, and on a second controller through the wire form)
bitwise its uninterrupted run, the checkpoint wire form read across the
packages (a JAX checkpoint refused for its backend), and ``euler``
segments at JAX's initial noise within 2e-4 of JAX's
``generate_preemptible`` interrupted at the same step."""

import asyncio
import base64
import json
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.cluster import preemption as jpre
from comfyui_distributed_tpu.cluster import runtime as jrt
from comfyui_distributed_tpu.diffusion import checkpoint as jck
from comfyui_distributed_tpu_torch import telemetry as ptel
from comfyui_distributed_tpu_torch.api.app import App, Request
from comfyui_distributed_tpu_torch.cluster import preemption as tpre
from comfyui_distributed_tpu_torch.cluster import runtime as trt
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.diffusion import checkpoint as tck
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe
from comfyui_distributed_tpu_torch.diffusion import samplers as tsamp
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.utils.exceptions import ValidationError
from test_torch_frontdoor import tiny_pair  # noqa: F401  (a fixture)
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
HW = 32
STEPS = 6
SEGMENT = 2


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def prim_prompt(v=1):
    return {"1": {"class_type": "PrimitiveInt", "inputs": {"value": v}}}


def txt2img(seed=5, sampler="dpmpp_2m_sde", steps=STEPS, pos="a red fox",
            prefix=None, hw=HW):
    p = {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": "tiny"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": pos, "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "blurry", "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": steps, "cfg": 5.0, "width": hw,
            "height": hw, "sampler_name": sampler, "scheduler": "karras"}},
    }
    if prefix is not None:
        p["5"] = {"class_type": "SaveImage",
                  "inputs": {"images": ["4", 0], "filename_prefix": prefix}}
    return p


# --- the dequeue order and the sweep, beside the JAX queue's -------------------

# (priority, parked resume, seq, group member priorities)
JOB_LISTS = [
    [("batch", False, 1, None), ("batch", False, 2, None),
     ("interactive", False, 3, None), ("interactive", False, 4, None)],
    [("batch", True, 9, None), ("batch", False, 2, None),
     ("interactive", True, 7, None), ("interactive", False, 1, None)],
    [("batch", False, 1, ("batch", "interactive")),
     ("interactive", False, 2, None), ("batch", True, 3, None),
     ("nonsense", False, 0, None)],
]


def _jobs(mod, specs):
    jobs = []
    for i, (prio, parked, seq, group) in enumerate(specs):
        job = mod.PromptJob(f"j{i}", {}, priority=prio, seq=seq,
                            checkpoint_id="ck" if parked else None)
        if group:
            job.group = [mod.PromptJob(f"j{i}m{k}", {}, priority=p)
                         for k, p in enumerate(group)]
        jobs.append(job)
    return jobs


@pytest.mark.parametrize("specs", JOB_LISTS, ids=range(len(JOB_LISTS)))
def test_dequeue_order_is_the_jax_queues(specs):
    def order(mod):
        return [j.prompt_id for j in sorted(_jobs(mod, specs),
                                            key=mod._dequeue_key)]

    assert order(trt) == order(jrt)
    assert [trt._dequeue_key(j) for j in _jobs(trt, specs)] == \
        [jrt._dequeue_key(j) for j in _jobs(jrt, specs)]


def test_the_queue_pops_by_priority_then_resume_then_arrival():
    async def body(mod):
        q = mod.PromptQueue()
        b1, _ = q.enqueue(prim_prompt(1), priority="batch")
        b2, _ = q.enqueue(prim_prompt(2), priority="batch")
        i1, _ = q.enqueue(prim_prompt(3), priority="interactive")
        i2, _ = q.enqueue(prim_prompt(4), priority="interactive")
        next(j for j in q._pending if j.prompt_id == b2).checkpoint_id = "ck"
        best = q.pending_best_rank()
        got = []
        while (job := q._pop_next()) is not None:
            got.append([b1, b2, i1, i2].index(job.prompt_id))
        await q.stop()
        return got, best

    assert run(body(trt)) == run(body(jrt)) == ([2, 3, 1, 0], 0)


def test_expire_stale_on_a_fake_clock_matches_jax():
    async def body(mod):
        q = mod.PromptQueue()
        fired = []
        q.add_job_done_callback(lambda: fired.append(1))
        stale, _ = q.enqueue(prim_prompt(1), priority="batch",
                             deadline_at=100.0)
        fresh, _ = q.enqueue(prim_prompt(2), priority="batch",
                             deadline_at=500.0)
        m1 = mod.PromptJob("g1", prim_prompt(), priority="batch",
                           deadline_at=100.0)
        m2 = mod.PromptJob("g2", prim_prompt(), priority="batch",
                           deadline_at=900.0)
        q.enqueue_batch([m1, m2], {})
        first = q.expire_stale(now=200.0)
        again = q.expire_stale(now=200.0)
        left = q.queue_remaining
        last = q.expire_stale(now=1000.0)
        statuses = [q.history.get(p, {}).get("status")
                    for p in (stale, fresh, "g1", "g2")]
        error = q.history[stale]["error"]
        await q.stop()
        return first, again, left, last, statuses, error, fired

    ours, ref = run(body(trt)), run(body(jrt))
    assert ours == ref
    assert ours[:4] == (1, 0, 2, 3)


def test_the_sweep_timer_expires_a_waiting_job(monkeypatch):
    monkeypatch.setenv("CDT_PREEMPT_SWEEP_S", "0.02")

    async def body():
        import time

        q = trt.PromptQueue()
        pid, _ = q.enqueue(prim_prompt(), priority="batch",
                           deadline_at=time.monotonic() - 0.01)
        q._wake.get_nowait()            # only the sweep may act
        for _ in range(100):
            if q.history.get(pid):
                break
            await asyncio.sleep(0.02)
        status = q.history[pid]["status"]
        await q.stop()
        return status

    assert run(body()) == "expired"


# --- the controller's policy, beside JAX's ---------------------------------------


def _fake_queue(executing=None, best_rank=None):
    return types.SimpleNamespace(executing_job=executing,
                                 pending_best_rank=lambda: best_rank)


def _policy_job(mod, priority="batch", group=None, preempt_count=0,
                checkpoint_id=None):
    job = mod.PromptJob("p1", {}, priority=priority,
                        checkpoint_id=checkpoint_id)
    job.group = group
    job.preempt_count = preempt_count
    return job


def _controller(pre_mod, ck_mod, queue, **kw):
    kw.setdefault("max_bytes", 1 << 20)
    return pre_mod.PreemptionController(
        queue, store=ck_mod.CheckpointStore(directory="", **kw))


BOTH = [(jpre, jck, jrt), (tpre, tck, trt)]


def _policy(mods, monkeypatch) -> dict:
    pre_mod, ck_mod, rt = mods
    out = {}
    for prio, best in (("batch", 0), ("interactive", 0), ("batch", 1),
                       ("batch", None)):
        job = _policy_job(rt, prio)
        pre = _controller(pre_mod, ck_mod, _fake_queue(job, best))
        pre.reevaluate()
        out[f"{prio}/{best}"] = pre.requested_reason("p1")
    grp = _policy_job(rt, group=[_policy_job(rt)])
    pre = _controller(pre_mod, ck_mod, _fake_queue(grp, 0))
    pre.reevaluate()
    out["group"] = (pre.requested_reason("p1"), pre.preempt_executing("drain"),
                    pre.begin(grp))
    job = _policy_job(rt)
    pre = _controller(pre_mod, ck_mod, _fake_queue(job, 0))
    pre.preempt_executing("drain")
    pre.reevaluate()
    out["drain"] = pre.requested_reason("p1")
    monkeypatch.setenv("CDT_PREEMPT_MAX", "2")
    for count in (1, 2):
        job = _policy_job(rt, preempt_count=count)
        pre = _controller(pre_mod, ck_mod, _fake_queue(job, 0))
        token = pre.begin(job)
        pre._request("p1", "priority")
        verdicts = [token.preemptible, token.should_preempt()]
        pre._requests["p1"] = "drain"
        out[f"guard/{count}"] = verdicts + [token.should_preempt()]
    monkeypatch.delenv("CDT_PREEMPT_MAX")
    job = _policy_job(rt)
    pre = _controller(pre_mod, ck_mod, _fake_queue(), resume_retries=2)
    ck = ck_mod.LatentCheckpoint("euler", 2, 8,
                                 (np.zeros((1, 2, 2, 4), np.float32),))
    cid = pre.park(job, ck, "priority")
    out["park"] = (job.preempt_count, pre.store.get(cid) is not None,
                   ck.meta["prompt_id"])
    out["retries"] = [pre.restore_failed(job, "mismatch"),
                      job.checkpoint_id is not None,
                      pre.restore_failed(job, "mismatch"),
                      job.checkpoint_id, pre.counts["dead_lettered"],
                      len(pre.store.stats()["dead_letter"])]
    job = _policy_job(rt)
    pre = _controller(pre_mod, ck_mod, _fake_queue())
    pre.park(job, ck, "manual")
    pre.resolve_success(job)
    out["resolve"] = (job.checkpoint_id, pre.counts["resumed"],
                      pre.store.counts["restored"],
                      pre.stats()["parked_jobs"])
    return out


def test_the_preemption_policy_is_the_jax_controllers(monkeypatch):
    ref = _policy(BOTH[0], monkeypatch)
    ours = _policy(BOTH[1], monkeypatch)
    assert ours == ref
    assert ours["batch/0"] == "priority" and ours["interactive/0"] is None
    assert ours["drain"] == "drain"
    assert ours["guard/2"] == [False, None, "drain"]
    assert ours["retries"][:4] == ["retry", True, "scratch", None]


def test_a_lost_checkpoint_runs_from_scratch_and_is_flagged():
    job = _policy_job(trt, checkpoint_id="ck_gone")
    pre = _controller(tpre, tck, _fake_queue())
    token = pre.begin(job)
    assert token.resume is None and job.checkpoint_id is None
    assert job.resume_lost == "ck_gone"


def test_interrupt_and_expiry_release_a_parked_checkpoint():
    async def body(drop):
        q = trt.PromptQueue()
        q.preemption = _controller(tpre, tck, q)
        q.enqueue(prim_prompt(), priority="batch", deadline_at=100.0)
        job = q._pending[0]
        ck = tck.LatentCheckpoint("euler", 2, 8,
                                  (np.zeros((1, 2, 2, 4), np.float32),))
        cid = q.preemption.park(job, ck, "priority")
        drop(q)
        gone = q.preemption.store.get(cid) is None
        parked = q.preemption.stats()["parked_jobs"]
        await q.stop()
        return gone, parked

    assert run(body(lambda q: q.interrupt())) == (True, [])
    assert run(body(lambda q: q.expire_stale(now=200.0))) == (True, [])


# --- the checkpoint store ------------------------------------------------------


def _ckpt(step=2, fill=0.0):
    return tck.LatentCheckpoint(
        "dpmpp_2m_sde", step, 8,
        (np.full((1, 2, 2, 4), fill, np.float32), np.asarray(0.25),
         np.asarray(True)), meta={"backend": "torch"})


def test_the_store_evicts_by_lru_but_never_the_pinned_entry(tmp_path):
    one = len(_ckpt().to_bytes())
    store = tck.CheckpointStore(max_bytes=2 * one + 10, directory="")
    a = store.park(_ckpt(1, 1.0))
    store.pin(a)
    b = store.park(_ckpt(2, 2.0))
    c = store.park(_ckpt(3, 3.0))
    assert a in store and c in store and b not in store
    assert store.counts["evicted"] == 1
    store.unpin(a)
    store.park(_ckpt(4, 4.0))
    assert a not in store


def test_the_persisted_tier_checksums_and_survives_a_new_store(tmp_path):
    store = tck.CheckpointStore(max_bytes=0, directory=tmp_path / "ck")
    cid = store.park(_ckpt(3, 7.0))
    fresh = tck.CheckpointStore(directory=tmp_path / "ck")
    back = fresh.get(cid)
    assert back.step == 3 and np.array_equal(back.carry[0], _ckpt(3, 7.0).carry[0])
    assert fresh.export_payload(cid)["sha256"] == tck.checksum(
        _ckpt(3, 7.0).to_bytes())
    # a flipped byte on disk is refused and deleted, never resumed
    path = tmp_path / "ck" / f"{cid}.ckpt"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    path.write_bytes(bytes(raw))
    assert tck.CheckpointStore(directory=tmp_path / "ck").get(cid) is None
    assert not path.exists()


def test_wire_refusals():
    payload = _ckpt().to_payload()
    bad = dict(payload)
    raw = bytearray(base64.b64decode(payload["data"]))
    raw[40] ^= 0x01
    bad["data"] = base64.b64encode(bytes(raw)).decode()
    for obj in (bad, {**payload, "sha256": ""}, {"sha256": "x"},
                {**payload, "data": "!!"}):
        with pytest.raises(tck.CheckpointError):
            tck.LatentCheckpoint.from_payload(obj)
    assert tck.LatentCheckpoint.from_payload(
        {**payload, "checkpoint_id": "../x"}).checkpoint_id == ""
    assert not tck.valid_checkpoint_id("a/b")
    # checksummed but malformed npz: a header that is no object, one
    # without its fields, another version, no header at all
    import io

    for header in (b"[]", b'{"version": 1, "n_leaves": 0}',
                   b'{"version": 2, "n_leaves": 0, "sampler": "e", '
                   b'"step": 0, "total_steps": 1}', None):
        buf = io.BytesIO()
        arrays = {"carry_0": np.zeros(2, np.float32)}
        if header is not None:
            arrays["header"] = np.frombuffer(header, np.uint8)
        np.savez(buf, **arrays)
        raw = buf.getvalue()
        with pytest.raises(tck.CheckpointError):
            tck.LatentCheckpoint.from_payload({
                "data": base64.b64encode(raw).decode(),
                "sha256": tck.checksum(raw)})


# --- every sampler in segments -------------------------------------------------


def _toy_denoiser():
    w = torch.linspace(0.5, 1.5, 4)

    def denoise(x, sigma):
        return torch.tanh(x * w) * 0.8 / (1.0 + sigma * 0.1)

    return denoise


@pytest.mark.parametrize("name", tsamp.SAMPLERS)
def test_every_sampler_in_segments_is_bitwise_its_uncut_run(name):
    """Segments of 1, 2 and 3 steps with the state through host numpy
    (the checkpoint's wire form) between them: bitwise the uncut run."""
    from comfyui_distributed_tpu_torch.parallel.rng import step_noise

    spec = tpipe.GenerationSpec(steps=7, sampler=name)
    sigmas = tpipe.make_sigma_ladder(spec, tpipe.vp_schedule())
    x = torch.randn(1, 4, 4, 4, generator=torch.Generator().manual_seed(3))
    noise = step_noise(11, torch.device("cpu"))
    uncut = tsamp.sample(name, _toy_denoiser(), x * sigmas[0], sigmas, noise)
    for seg in (1, 2, 3):
        program = tsamp.make_program(name, _toy_denoiser(), sigmas, noise)
        init, _, extract = program
        state, start, n = init(x * sigmas[0]), 0, len(sigmas) - 1
        while start < n:
            length = min(seg, n - start)
            state = tsamp.run_segment(program, state, start, length)
            start += length
            ck = tck.LatentCheckpoint(name, start, n,
                                      tck.state_to_leaves(state))
            back = tck.LatentCheckpoint.from_bytes(ck.to_bytes())
            state = tck.leaves_to_state(back.carry, torch.device("cpu"))
        assert torch.equal(extract(state), uncut), (name, seg)


# --- a tiny request through the queue ------------------------------------------


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry("cpu", seed=0)


@pytest.fixture(scope="module")
def reference(registry, tmp_path_factory):
    """The uninterrupted runs' PNGs (an executor without a token)."""
    out = tmp_path_factory.mktemp("ref")
    ex = GraphExecutor({"model_registry": registry, "output_dir": str(out)})
    ex.execute(txt2img(prefix="batch"))
    ex.execute(txt2img(seed=6, sampler="euler_ancestral", pos="a cat",
                       prefix="inter"))
    return {k: (out / f"{k}_00000.png").read_bytes()
            for k in ("batch", "inter")}


def post(app, path, payload):
    return app.dispatch(Request("POST", path,
                                {"content-type": "application/json"},
                                json.dumps(payload).encode()))


def get(app, path):
    return app.dispatch(Request("GET", path, {}, b""))


TERMINAL = ("success", "error", "interrupted", "expired")


async def final(controller, pid, timeout=60.0):
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while loop.time() < end:
        entry = controller.queue.history.get(pid)
        if entry is not None and entry["status"] in TERMINAL:
            return entry
        await asyncio.sleep(0.01)
    raise TimeoutError(pid)


@pytest.fixture
def make_controller(tmp_path, monkeypatch, registry):
    monkeypatch.setenv("CDT_CACHE_DIR", "")
    monkeypatch.setenv("CDT_PREEMPT_SEGMENT_STEPS", str(SEGMENT))
    monkeypatch.setenv("CDT_SHAPE_OBSERVE", "0")

    def make(name):
        monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / name))
        (tmp_path / f"{name}.json").write_text("{}")
        return Controller(tmp_path / f"{name}.json", device="cpu",
                          model_registry=registry)

    return make


class _Gate:
    """Counts the UNet calls; each call whose number is in ``holds``
    waits until the test releases it."""

    def __init__(self, unet, holds=()):
        self.unet, self.calls = unet, 0
        self.reached = {n: threading.Event() for n in holds}
        self.release = {n: threading.Event() for n in holds}
        self._forward = unet.forward

    def __enter__(self):
        def forward(*a, **k):
            self.calls += 1
            n = self.calls
            if n in self.reached:
                self.reached[n].set()
                assert self.release[n].wait(30)
            return self._forward(*a, **k)

        self.unet.forward = forward
        return self

    def __exit__(self, *exc):
        del self.unet.forward
        for ev in self.release.values():
            ev.set()

    async def wait(self, n):
        while not self.reached[n].is_set():
            await asyncio.sleep(0.005)


def test_a_batch_request_is_preempted_by_an_interactive_one_and_resumes_bitwise(
        make_controller, registry, reference, tmp_path):
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    unet = registry.get("tiny").pipeline.unet

    async def body():
        c = make_controller("one")
        app = App(c)
        await c.startup()
        done = []
        c.queue.add_job_done_callback(
            lambda: done.extend(p for p, e in c.queue.history.items()
                                if e["status"] == "success"
                                and p not in done))
        try:
            # call 1: the batch run's first; call 3: the interactive
            # run's first, after the batch run yielded at step 2
            with _Gate(unet, holds=(1, SEGMENT + 1)) as gate:
                b = (await post(app, "/distributed/queue", {
                    "prompt": txt2img(prefix="batch"),
                    "priority": "batch"})).payload
                await gate.wait(1)
                i = (await post(app, "/distributed/queue", {
                    "prompt": txt2img(seed=6, sampler="euler_ancestral",
                                      pos="a cat", prefix="inter"),
                    "priority": "interactive"})).payload
                gate.release[1].set()
                await gate.wait(SEGMENT + 1)
                parked = dict(c.queue.history[b["prompt_id"]])
                status = (await app.dispatch(Request(
                    "GET", "/distributed/job_status", {}, b"",
                    query={"job_id": b["prompt_id"]}))).payload
                gate.release[SEGMENT + 1].set()
                be = await final(c, b["prompt_id"])
                ie = await final(c, i["prompt_id"])
            hist = (await get(app, f"/distributed/history/"
                                   f"{b['prompt_id']}")).payload
            stats = (await get(app, "/distributed/preemption")).payload
            return (b, i, parked, status, be, ie, hist, stats, done,
                    gate.calls)
        finally:
            await c.shutdown()

    b, i, parked, status, be, ie, hist, stats, done, calls = run(body())
    assert b["batched"] is False and i["batched"] is False
    assert parked["preempted_at_step"] == SEGMENT
    assert parked["reason"] == "priority" and parked["total_steps"] == STEPS
    assert status["preempted"] == f"preempted@{SEGMENT}/{STEPS}"
    assert be["status"] == ie["status"] == "success"
    assert be["preemptions"] == 1 and hist["preemptions"] == 1
    # the interactive request finished first; no step ran twice
    assert done.index(i["prompt_id"]) < done.index(b["prompt_id"])
    assert calls == 2 * STEPS
    out = tmp_path / "one"
    assert (out / "batch_00000.png").read_bytes() == reference["batch"]
    assert (out / "inter_00000.png").read_bytes() == reference["inter"]
    assert stats["preempted"] == 1 and stats["resumed"] == 1
    assert stats["parked_jobs"] == [] and stats["store"]["bytes"] == 0
    snap = ptel.REGISTRY.snapshot()
    assert [s["value"] for s in snap["cdt_preemptions_total"]["series"]
            if s["labels"] == {"reason": "priority"}] == [1]
    assert snap["cdt_jobs_preempted"]["series"][0]["value"] == 0
    assert snap["cdt_resume_seconds"]["series"][0]["count"] == 1


class _Once:
    """A preemption token that yields once, at the first boundary."""

    def __init__(self):
        self.resume, self.segment_steps = None, SEGMENT
        self.resume_consumed, self.asked = False, 0

    def should_preempt(self):
        self.asked += 1
        return "manual" if self.asked == 1 else None


def test_a_checkpoint_resumes_bitwise_on_a_second_controller(
        make_controller, registry, reference, tmp_path):
    """Preempted in one process's executor, parked on another controller
    through ``POST /distributed/checkpoint`` (and inline), resumed there:
    bitwise the uninterrupted run, with the remaining steps' UNet calls
    only; a flipped byte and a foreign backend are refused."""
    ex = GraphExecutor({"model_registry": registry,
                        "output_dir": str(tmp_path / "x"),
                        "preemption": _Once()})
    with pytest.raises(tck.PreemptedError) as err:
        ex.execute(txt2img(prefix="batch"))
    ckpt = err.value.checkpoint
    assert ckpt.step == SEGMENT and ckpt.meta["backend"] == "torch"
    wire = ckpt.to_payload()
    unet = registry.get("tiny").pipeline.unet

    async def body():
        c = make_controller("two")
        app = App(c)
        await c.startup()
        try:
            parked = await post(app, "/distributed/checkpoint", wire)
            cid = parked.payload["checkpoint_id"]
            with _Gate(unet) as gate:
                q = (await post(app, "/distributed/queue", {
                    "prompt": txt2img(prefix="batch"),
                    "checkpoint_id": cid})).payload
                entry = await final(c, q["prompt_id"])
                calls = gate.calls
                inline = (await post(app, "/distributed/queue", {
                    "prompt": txt2img(prefix="inline"),
                    "checkpoint": wire})).payload
                inline_entry = await final(c, inline["prompt_id"])
            raw = bytearray(base64.b64decode(wire["data"]))
            raw[len(raw) // 3] ^= 0x01
            flipped = await post(app, "/distributed/checkpoint", {
                **wire, "data": base64.b64encode(bytes(raw)).decode()})
            foreign = tck.LatentCheckpoint(
                ckpt.sampler, ckpt.step, ckpt.total_steps, ckpt.carry,
                meta={**ckpt.meta, "backend": "jax"})
            refused = await post(app, "/distributed/checkpoint",
                                 foreign.to_payload())
            unknown = await post(app, "/distributed/queue", {
                "prompt": txt2img(), "checkpoint_id": "ck_nowhere"})
            stats = (await get(app, "/distributed/preemption")).payload
            return (parked, q, entry, calls, inline, inline_entry, flipped,
                    refused, unknown, stats)
        finally:
            await c.shutdown()

    (parked, q, entry, calls, inline, inline_entry, flipped, refused,
     unknown, stats) = run(body())
    assert parked.status == 200 and parked.payload["step"] == SEGMENT
    assert entry["status"] == "success" and q["batched"] is False
    assert calls == STEPS - SEGMENT
    out = tmp_path / "two"
    assert (out / "batch_00000.png").read_bytes() == reference["batch"]
    assert inline_entry["status"] == "success"
    assert (out / "inline_00000.png").read_bytes() == reference["batch"]
    assert flipped.status == 400 and "CHECKSUM" in flipped.payload["error"]
    assert refused.status == 400 and "backend" in refused.payload["error"]
    assert unknown.status == 400 and "not parked" in unknown.payload["error"]
    assert stats["resumed"] == 2 and stats["store"]["bytes"] == 0


def test_a_mismatched_checkpoint_is_retried_then_dead_lettered(
        make_controller, registry, monkeypatch):
    """A checkpoint of another prompt fails its identity check: retried
    ``CDT_PREEMPT_RESUME_RETRIES`` times, dead-lettered, then the job
    runs from scratch and says so."""
    ex = GraphExecutor({"model_registry": registry, "output_dir": "",
                        "preemption": _Once()})
    with pytest.raises(tck.PreemptedError) as err:
        ex.execute(txt2img(pos="another prompt"))
    wire = err.value.checkpoint.to_payload()

    async def body():
        c = make_controller("three")
        app = App(c)
        await c.startup()
        try:
            q = (await post(app, "/distributed/queue", {
                "prompt": txt2img(), "checkpoint": wire})).payload
            entry = await final(c, q["prompt_id"])
            return entry, c.preemption.stats()
        finally:
            await c.shutdown()

    entry, stats = run(body())
    assert entry["status"] == "success" and entry["resume_lost"]
    assert stats["restore_failed"] == 2 and stats["dead_lettered"] == 1
    assert stats["store"]["dead_letter"][0]["attempts"] == 2


def test_resume_is_refused_without_preemption(monkeypatch, tmp_path,
                                              registry):
    monkeypatch.setenv("CDT_PREEMPT", "0")
    (tmp_path / "c.json").write_text("{}")
    c = Controller(tmp_path / "c.json", device="cpu", model_registry=registry)
    assert c.preemption is None and c.queue.preemption is None
    with pytest.raises(ValidationError, match="preemption disabled"):
        tpre.resolve_resume(None, "ck_1", None)


# --- the wire form across the packages, and JAX's segments ----------------------


@pytest.fixture(scope="module")
def jax_interrupted(tiny_pair):
    """The tiny fp32 pair (``tests/test_torch_frontdoor.py``), JAX's
    ``euler`` run interrupted after its first segment and resumed."""
    from comfyui_distributed_tpu.parallel import build_mesh

    jpipe, jp, tp, conds = tiny_pair

    spec = dict(height=HW, width=HW, steps=4, sampler="euler",
                scheduler="karras", guidance_scale=5.0)
    mesh = build_mesh({"dp": 1})
    args = [jnp.asarray(a) for a in conds[0]]
    asked = []

    def once():
        asked.append(1)
        return "manual" if len(asked) == 1 else None

    cut = jp.generate_preemptible(mesh, jpipe.GenerationSpec(**spec), 9,
                                  *args, segment_steps=SEGMENT,
                                  should_preempt=once)
    done = jp.generate_preemptible(mesh, jpipe.GenerationSpec(**spec), 9,
                                   *args, resume=cut["checkpoint"])
    return tp, conds[0], spec, cut["checkpoint"], np.asarray(done["images"])


def test_a_jax_checkpoint_parses_alike_and_is_refused_for_its_backend(
        jax_interrupted):
    _, conds, spec, jckpt, _ = jax_interrupted
    raw = jckpt.to_bytes()
    ours = tck.LatentCheckpoint.from_bytes(raw)
    assert (ours.sampler, ours.step, ours.total_steps, ours.meta) == (
        jckpt.sampler, jckpt.step, jckpt.total_steps, jckpt.meta)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(ours.carry, jckpt.carry))
    assert ours.to_bytes() == raw
    assert tck.checksum(raw) == jck.checksum(raw)
    assert ours.to_payload()["sha256"] == jckpt.to_payload()["sha256"]
    back = jck.LatentCheckpoint.from_payload(ours.to_payload())
    assert back.step == jckpt.step
    tp = jax_interrupted[0]
    identity = tp.checkpoint_identity(
        tpipe.GenerationSpec(**spec), 9,
        conditioning=tuple(torch.from_numpy(a) for a in conds))
    with pytest.raises(tck.CheckpointRestoreError, match="backend"):
        ours.validate_meta(identity)
    with pytest.raises(tck.CheckpointError, match="backend"):
        tck.require_torch_backend(ours)


def test_euler_segments_agree_with_jax_generate_preemptible(jax_interrupted):
    """JAX's initial noise handed to the port: the state at the cut and
    the finished image within 2e-4 of JAX's."""
    tp, conds, spec, jckpt, jimages = jax_interrupted
    spec_t = tpipe.GenerationSpec(**spec)
    k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(9), 0))
    ds = tp.vae.config.downscale
    noise = torch.from_numpy(np.array(jax.random.normal(
        k_noise, (1, HW // ds, HW // ds, tp.latent_channels), jnp.float32)))
    ctx, unc, y, uy = (torch.from_numpy(a) for a in conds)
    with torch.no_grad():
        denoise, x, sigmas, ladder = tp._prepare_sampling(
            noise, spec_t, ctx, unc, y, uy, None, None, None, None)
        program = tsamp.make_program("euler", denoise, sigmas, ladder=ladder)
        state = tsamp.run_segment(program, program[0](x), 0, jckpt.step)
        ref = np.asarray(jckpt.carry[0])
        err = np.abs(state[0].numpy() - ref).max()
        assert err <= TOL * max(1.0, np.abs(ref).max()), err
        state = tsamp.run_segment(program, state, jckpt.step,
                                  len(ladder) - 1 - jckpt.step)
        images = tp._decode_latent(program[2](state)).numpy()
    assert np.abs(images - jimages).max() <= TOL
