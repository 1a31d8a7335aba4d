"""The port's stage-split serving (``cluster/stages``) against the JAX
package's, on the CPU: ``generate_latents`` followed by
``decode_latents`` is bitwise the port's ``generate`` and
``generate_microbatch`` and within the repo's 2e-4 of JAX's pair when
handed JAX's noise; a latent handoff written by either package parses in
the other; ``StagePool`` buckets, steals, re-dispatches and survives a
worker's death under an injected clock; a manager stopped while its
denoise call runs ends every member ``interrupted`` and keeps no item or
latent; a staged group through a
``tiny`` controller gives each member its solo run's PNG, history
entries shaped as the fused path's, a coalesced twin, result-tier hits
answered in the encode pool, the wire round trip, the remote-decode
route, a dead decode worker's latents decoded bitwise by a survivor, and
``CDT_STAGES=0`` back on the fused path; the conditioning fill is
single-flight; the launch counters count exactly across threads; the
new Prometheus families render JAX's text. Nothing waits on a wall-clock
window: groups flush full, decode buckets fill, threads meet on
``threading.Event``s."""

import asyncio
import base64
import dataclasses
import gc
import json
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.cluster.stages import latents as jlat
from comfyui_distributed_tpu_torch import telemetry as ptel
from comfyui_distributed_tpu_torch.api.app import App, Request
from comfyui_distributed_tpu_torch.cluster.cache import CacheManager
from comfyui_distributed_tpu_torch.cluster.cache import conditioning as tcond
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.stages import (StageManager,
                                                          StageWorkerDeath,
                                                          build_stages)
from comfyui_distributed_tpu_torch.cluster.stages import latents as tlat
from comfyui_distributed_tpu_torch.cluster.stages.pool import StagePool
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.ops import flash_attention as fa
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
HW = 32


# --- the pipeline's two halves ----------------------------------------------


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


def test_latents_then_decode_is_generate_bitwise_and_jax_within_tol(
        tiny_pair, monkeypatch):
    from comfyui_distributed_tpu.parallel import build_mesh

    jpipe, jp, tp, conds = tiny_pair
    spec = dict(height=64, width=64, steps=2, sampler="euler",
                scheduler="karras", guidance_scale=5.0)
    seeds = [11, 12]
    args = [[torch.from_numpy(a) for a in c] for c in conds]
    cols = [[a[i] for a in args] for i in range(4)]
    solo = [tp.generate(tpipe.GenerationSpec(**spec), s, *a)
            for s, a in zip(seeds, args)]
    group = tp.generate_microbatch(tpipe.GenerationSpec(**spec), seeds, *cols)
    lats = tp.generate_latents(tpipe.GenerationSpec(**spec), seeds, *cols)
    assert [tuple(lat.shape) for lat in lats] == [(1, 32, 32, 4)] * 2
    assert all(lat.dtype == torch.float32 for lat in lats)
    # decoded together, one at a time, and in the other order
    both = tp.decode_latents(lats)
    alone = [tp.decode_latents([lat])[0] for lat in lats]
    swapped = tp.decode_latents(lats[::-1])[::-1]
    for outs in (both, alone, swapped):
        for o, s, g in zip(outs, solo, group):
            assert o.shape == (1, 64, 64, 3)
            assert torch.equal(o, s) and torch.equal(o, g)
    with pytest.raises(ValueError, match="bucket by shape"):
        tp.decode_latents([lats[0], lats[0][..., :16, :]])
    assert tp.decode_latents([]) == []
    # JAX's staged pair against the port's, each request given JAX's noise
    mesh = build_mesh({"dp": 1})
    jlats = jp.generate_latents(
        mesh, jpipe.GenerationSpec(**spec), seeds,
        *[[jnp.asarray(c[i]) for c in conds] for i in range(4)])
    jimgs = jp.decode_latents(mesh, jlats)
    noise = {}
    for s in seeds:
        k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(s), 0))
        noise[s] = torch.from_numpy(np.array(
            jax.random.normal(k_noise, (1, 32, 32, 4), jnp.float32)))
    monkeypatch.setattr(tpipe, "seed_generator", lambda seed, device: seed)
    monkeypatch.setattr(tp, "initial_noise", lambda spec, seed: noise[seed])
    lats = tp.generate_latents(tpipe.GenerationSpec(**spec), seeds, *cols)
    for t, j in zip(lats, jlats):
        # latents are not in [0, 1] (|x0| reaches ~20 here): the repo's
        # 2e-4 applies to them relative to their scale
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=TOL * np.abs(j).max())
    for t, j in zip(tp.decode_latents(lats), jimgs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL)


def test_generate_latents_refuses_as_generate_microbatch_does(tiny_pair):
    _, _, tp, conds = tiny_pair
    c = [torch.from_numpy(a) for a in conds[0]]
    for spec, seeds in ((tpipe.GenerationSpec(sampler="euler_ancestral"), [1]),
                        (tpipe.GenerationSpec(), [1, 2])):
        with pytest.raises(ValueError) as a:
            tp.generate_microbatch(spec, seeds, [c[0]], [c[1]])
        with pytest.raises(ValueError) as b:
            tp.generate_latents(spec, seeds, [c[0]], [c[1]])
        assert str(a.value) == str(b.value)


# --- the latent wire ---------------------------------------------------------


def _handoff(mod):
    lat = np.random.default_rng(3).standard_normal((1, 4, 6, 4)).astype(
        np.float32)
    return mod.LatentHandoff(prompt_id="p1", latents=lat,
                             meta={"model": "tiny", "seed": 7,
                                   "fingerprint": None})


def _flip(payload: dict, at: int) -> dict:
    raw = bytearray(base64.b64decode(payload["data"]))
    raw[at] ^= 0x01
    return dict(payload, data=base64.b64encode(bytes(raw)).decode("ascii"))


@pytest.mark.parametrize("writer,reader", [(tlat, jlat), (jlat, tlat),
                                           (tlat, tlat)])
def test_a_handoff_from_either_package_parses_in_the_other(writer, reader):
    h = _handoff(writer)
    payload = json.loads(json.dumps(h.to_payload()))
    back = reader.LatentHandoff.from_payload(payload)
    assert back.prompt_id == "p1" and back.meta == h.meta
    assert back.latents.dtype == np.float32
    assert np.array_equal(back.latents, h.latents)
    assert back.bucket_key() == h.bucket_key()
    assert h.to_bytes() == _handoff(reader).to_bytes()
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    assert np.array_equal(reader.decode_array_payload(
        writer.encode_array_payload(arr)), arr)
    for at in (0, len(base64.b64decode(payload["data"])) // 2):
        with pytest.raises(reader.LatentWireError, match="CHECKSUM"):
            reader.LatentHandoff.from_payload(_flip(payload, at))
    with pytest.raises(reader.LatentWireError, match="no sha256"):
        reader.LatentHandoff.from_payload(
            {k: v for k, v in payload.items() if k != "sha256"})
    with pytest.raises(reader.LatentWireError):
        reader.LatentHandoff.from_payload("not a dict")
    bad = writer.encode_array_payload(arr)
    with pytest.raises(reader.LatentWireError):
        reader.decode_array_payload(_flip(bad, 5))
    skew = _handoff(writer)
    skew.version = 99
    with pytest.raises(reader.LatentWireError, match="version"):
        reader.LatentHandoff.from_payload(skew.to_payload())
    assert tlat.checksum(b"abc") == jlat.checksum(b"abc")


# --- the stage pool ----------------------------------------------------------


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Item:
    def __init__(self, key="k", name=""):
        self.key, self.name = key, name
        self.redispatch = 0
        self.done = False

    def bucket_key(self):
        return self.key


def recorder(n_items: int):
    """A runner that records its batches and sets ``done`` at n items."""
    batches, done = [], threading.Event()
    lock = threading.Lock()

    def runner(items):
        with lock:
            batches.append([it.name for it in items])
            if sum(len(b) for b in batches) >= n_items:
                done.set()
    return runner, batches, done


def test_the_fifo_pool_runs_in_arrival_order():
    runner, batches, done = recorder(3)
    pool = StagePool("encode", 1, runner)
    for i in range(3):
        pool.put(Item(name=str(i)))
    assert done.wait(30)
    pool.stop()                 # joined: its counts are final
    assert batches == [["0"], ["1"], ["2"]]
    assert pool.stats()["done"] == 3 and pool.depth() == 0


def test_buckets_flush_when_full_or_past_their_window():
    clock = Clock()
    runner, batches, done = recorder(3)
    pool = StagePool("decode", 0, runner, batch_key=lambda it: it.key,
                     max_batch=3, window_s=1.0, clock=clock)
    pool.put(Item("b", "b0"))
    clock.t += 0.5
    for i in range(4):
        pool.put(Item("a", f"a{i}"))
    # only the full 'a' bucket is ready; 'b' and the fourth 'a' wait
    assert [it.name for it in pool.take_now()] == ["a0", "a1", "a2"]
    assert pool.take_now() is None and pool.depth() == 2
    clock.t += 1.0          # both windows pass: the older bucket first
    pool.put(Item("c", "c0"))   # a bucket opened now is not ready yet
    assert [it.name for it in pool.take_now()] == ["b0"]
    assert [it.name for it in pool.take_now()] == ["a3"]
    assert pool.take_now() is None
    pool.put(Item("c", "c1"))
    pool.put(Item("c", "c2"))   # full: a worker takes it whole
    pool.resize(1)
    assert done.wait(60)
    pool.stop()
    assert batches == [["c0", "c1", "c2"]]


def test_an_idle_worker_steals_from_the_deeper_sibling():
    runner, batches, done = recorder(2)
    victim = StagePool("decode", 0, runner)            # no workers of its own
    victim.put(Item(name="x"))
    victim.put(Item(name="y"))
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    thief = StagePool("encode", 1, lambda items: None,
                      steal=lambda pool: victim if victim.depth() else None)
    thief.resize(1)
    assert done.wait(30), "the thief never served the victim's queue"
    thief.stop()
    victim.stop()
    assert sorted(sum(batches, [])) == ["x", "y"]
    steals = ptel.REGISTRY.snapshot()["cdt_stage_steals_total"]["series"]
    assert steals[0]["labels"] == {"src": "decode", "dst": "encode"}
    assert steals[0]["value"] == 2.0


def test_a_dead_worker_redispatches_and_stop_returns_the_queue():
    attempts, finished = [], threading.Event()
    holder = {}

    def runner(items):
        attempts.append([it.name for it in items])
        if len(attempts) == 1:
            raise StageWorkerDeath("killed holding its items")
        finished.set()

    pool = StagePool("decode", 0, runner, batch_key=lambda it: it.key,
                     max_batch=2, window_s=1e9,
                     redispatch=lambda items: [holder["p"].put(it)
                                               for it in items])
    holder["p"] = pool
    pool.put(Item("a", "a0"))
    pool.put(Item("a", "a1"))
    pool.resize(1)
    assert finished.wait(60)
    assert pool.stop() == []
    # the dead thread's items ran whole on the thread that replaced it
    assert attempts == [["a0", "a1"], ["a0", "a1"]]
    stats = pool.stats()
    assert (stats["done"], stats["errors"], stats["alive"]) == (2, 0, 0)
    # a runner that raises anything else keeps its thread
    seen, both = [], threading.Event()

    def flaky(items):
        seen.append(items[0].name)
        if len(seen) == 1:
            raise RuntimeError("one bad batch")
        both.set()

    pool = StagePool("encode", 1, flaky)
    pool.put(Item(name="bad"))
    pool.put(Item(name="good"))
    assert both.wait(60)
    pool.stop()
    stats = pool.stats()
    assert seen == ["bad", "good"] and (stats["done"], stats["errors"]) == (2, 1)
    # stopped with work queued: the items come back to the caller
    pool = StagePool("decode", 0, runner, batch_key=lambda it: it.key)
    pool.put(Item("x", "x0"))
    pool.put(Item("y", "y0"))
    assert sorted(it.name for it in pool.stop()) == ["x0", "y0"]
    # a stopped pool refuses an item (it would never run) and starts nothing
    assert pool.put(Item("z", "late")) is False
    assert pool.depth() == 0 and pool.alive_workers() == 0


def test_resize_and_rebalance_grow_each_pool_on_its_own_depth(monkeypatch):
    monkeypatch.setenv("CDT_STAGE_SCALE_DEPTH", "2")
    monkeypatch.setenv("CDT_STAGE_MAX_WORKERS", "3")
    monkeypatch.setenv("CDT_STAGE_ENCODE_WORKERS", "1")
    monkeypatch.setenv("CDT_STAGE_DECODE_WORKERS", "1")
    mgr = StageManager()
    try:
        mgr.decode.runner = mgr.encode.runner = lambda items: None
        mgr.decode.resize(0)
        mgr.encode.resize(0)
        for i in range(5):
            mgr.decode.put(Item(f"k{i}"))
        mgr.rebalance()
        assert (mgr.decode.workers, mgr.encode.workers) == (1, 0)
        mgr.decode.resize(2)
        mgr.decode.stop()
        assert mgr.depths() == {"encode": 0, "denoise": 0, "decode": 0}
        mgr.rebalance()
        assert mgr.decode.workers == 1      # idle: back to its base
    finally:
        mgr.stop()


def test_an_item_past_the_redispatch_bound_fails_and_resolves_its_group(
        monkeypatch):
    monkeypatch.setenv("CDT_STAGE_MAX_REDISPATCH", "1")
    mgr = StageManager()
    mgr.encode.resize(0)

    class Member:
        prompt_id = "r0"
        fingerprint = None
        cache_mode = "use"

    async def body():
        loop = asyncio.get_running_loop()
        denoise_done = loop.create_future()
        entries = {}
        mgr.submit_group(None, [Member()], {"r0": "4"}, {}, loop,
                         denoise_done,
                         lambda m, e, last: entries.update({m.prompt_id:
                                                            (e, last)}))
        first = mgr.encode.take_now()
        mgr._redispatch_encode(first)            # 1: back in the queue
        second = mgr.encode.take_now()
        assert second == first
        mgr._redispatch_encode(second)           # 2: past the bound
        await asyncio.wait_for(denoise_done, 30)
        await asyncio.sleep(0)
        return entries

    try:
        entries = asyncio.run(body())
    finally:
        mgr.stop()
    entry, last = entries["r0"]
    assert entry["status"] == "error" and "redispatch bound" in entry["error"]
    assert last is True
    assert mgr.stats()["redispatched"] == 1


class FakeLatents:
    """``generate_latents`` of a fake pipeline that blocks on ``release``
    after setting ``entered``: a denoise call in flight."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()
        self.made = []

    def generate_latents(self, spec, seeds, **_):
        self.entered.set()
        assert self.release.wait(60)
        out = [torch.full((1, 4, 4, 4), float(s)) for s in seeds]
        self.made.extend(weakref.ref(t) for t in out)
        return out

    def decode_latents(self, latents):
        raise AssertionError("a stopped manager decodes nothing")


def test_stop_with_a_denoise_call_in_flight_ends_every_member(monkeypatch):
    """Shutdown while the denoise worker is inside its call (longer than
    the join waits): the latents it hands on afterwards go to a stopped
    decode pool, which refuses them, so every member ends
    ``interrupted`` and no pool keeps an item or a latent."""
    monkeypatch.setenv("CDT_STAGE_ENCODE_WORKERS", "2")
    mgr = StageManager()
    mgr.denoise.JOIN_S = 0.0           # stop returns with the call held
    pipe = FakeLatents()

    class Member:
        fingerprint = None
        cache_mode = "use"

        def __init__(self, pid):
            self.prompt_id = pid

    class Prepared:
        stackable = True
        model = None
        pipeline = pipe
        spec = None
        context = uncond = y = uy = None

        def __init__(self, member, seed):
            self.member, self.seed = member, seed

        def signature(self):
            return ("fake",)

    def encode(w):
        # the encode pool's member work, without a graph prefix
        w.ticket.add_ready(Prepared(w.member, len(w.ticket.ready)))
        mgr._after_encode(w.ticket)

    monkeypatch.setattr(mgr, "_encode_member", encode)
    members = [Member(f"r{i}") for i in range(3)]

    async def body():
        loop = asyncio.get_running_loop()
        denoise_done, all_done = loop.create_future(), loop.create_future()
        entries = {}

        def record(m, e, last):
            entries[m.prompt_id] = e
            if last:
                all_done.set_result(None)

        mgr.submit_group(None, members, {m.prompt_id: "4" for m in members},
                         {}, loop, denoise_done, record)
        assert await loop.run_in_executor(None, pipe.entered.wait, 60)
        await loop.run_in_executor(None, mgr.stop)
        assert entries == {} and not denoise_done.done()
        pipe.release.set()
        await asyncio.wait_for(all_done, 60)
        await asyncio.wait_for(denoise_done, 60)
        return entries

    try:
        entries = asyncio.run(body())
    finally:
        pipe.release.set()
        mgr.stop()
    assert entries == {m.prompt_id: {"status": "interrupted"}
                       for m in members}
    for pool in (mgr.encode, mgr.denoise, mgr.decode):
        for t in list(pool._threads):
            t.join(60)
        assert pool.depth() == 0 and pool.alive_workers() == 0
    gc.collect()
    assert len(pipe.made) == 3 and all(r() is None for r in pipe.made)


# --- a staged group on a tiny controller -------------------------------------


def batchable(seed, pos=None, neg="blurry", prefix=None, steps=2):
    pos = f"a red fox, variant {seed}" if pos is None else pos
    p = {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": "tiny"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": pos, "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": neg, "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": steps, "cfg": 2.0, "width": HW,
            "height": HW, "sampler_name": "euler"}},
    }
    if prefix is not None:
        p["5"] = {"class_type": "SaveImage",
                  "inputs": {"images": ["4", 0], "filename_prefix": prefix}}
    return p


def post(app, path, payload):
    return app.dispatch(Request("POST", path,
                                {"content-type": "application/json"},
                                json.dumps(payload).encode()))


def get(app, path):
    return app.dispatch(Request("GET", path, {}, b""))


async def final(controller, pid, timeout=120.0):
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


@pytest.fixture(scope="module")
def solo_pngs(registry, tmp_path_factory):
    """Each member alone through ``GraphExecutor`` (no content cache)."""
    out = tmp_path_factory.mktemp("solo")
    ex = GraphExecutor({"model_registry": registry, "output_dir": str(out)})
    pngs = {}
    for s in range(4):
        ex.execute(batchable(s, prefix=f"m{s}"))
        pngs[s] = (out / f"m{s}_00000.png").read_bytes()
    return pngs


@pytest.fixture
def controller(tmp_path, monkeypatch, registry):
    """A CPU master whose front door flushes a group when it is full (a
    window it never reaches) and whose decode pool takes a bucket when it
    is full: every group and decode batch forms without a clock."""
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("CDT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("CDT_FD_WINDOW_MS", "600000")
    monkeypatch.setenv("CDT_STAGE_DECODE_WINDOW_MS", "600000")
    (tmp_path / "m.json").write_text("{}")

    def make(members: int):
        monkeypatch.setenv("CDT_FD_MAX_BATCH", str(members))
        monkeypatch.setenv("CDT_STAGE_DECODE_BATCH", str(members))
        return Controller(tmp_path / "m.json", device="cpu",
                          model_registry=registry)

    return make


def gate_denoise(monkeypatch):
    """Hold the denoise stage until the returned event is set."""
    gate = threading.Event()
    real = tpipe.Txt2ImgPipeline.generate_latents

    def held(self, *a, **kw):
        assert gate.wait(120)
        return real(self, *a, **kw)

    monkeypatch.setattr(tpipe.Txt2ImgPipeline, "generate_latents", held)
    return gate


def test_a_staged_group_is_each_members_solo_run(controller, solo_pngs,
                                                 tmp_path, monkeypatch):
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    out = tmp_path / "out"
    gate = gate_denoise(monkeypatch)

    async def run():
        c = controller(4)
        app = App(c)
        await c.startup()
        try:
            answers = await asyncio.gather(*[
                post(app, "/distributed/queue",
                     {"prompt": batchable(s, prefix=f"m{s}")})
                for s in range(4)])
            # member 0's twin while the group waits for the card
            twin = await post(app, "/distributed/queue",
                              {"prompt": batchable(0, prefix="m0")})
            fd_during = (await get(app, "/distributed/frontdoor")).payload
            gate.set()
            ids = [a.payload["prompt_id"] for a in answers]
            entries = [await final(c, i) for i in ids]
            twin_entry = await final(c, twin.payload["prompt_id"])
            stages = (await get(app, "/distributed/stages")).payload
            health = c.health()
            cond = c.cache.conditioning.stats()
            # the same four again: the result tier answers in the encode pool
            again = await asyncio.gather(*[
                post(app, "/distributed/queue",
                     {"prompt": batchable(s, prefix=f"m{s}")})
                for s in range(4)])
            hits = [await final(c, a.payload["prompt_id"]) for a in again]
            cache = (await get(app, "/distributed/cache")).payload
            return (c, answers, twin, entries, twin_entry, stages, health,
                    cond, hits, cache, fd_during)
        finally:
            await c.shutdown()

    (c, answers, twin, entries, twin_entry, stages, health, cond, hits, cache,
     fd_during) = asyncio.run(run())
    # the pools' own counts, read once shutdown has joined their threads
    after = c.stages.stats()
    assert all(p.alive_workers() == 0 for p in
               (c.stages.encode, c.stages.denoise, c.stages.decode))
    assert all(a.status == 200 and a.payload["batched"] for a in answers)
    assert twin.payload["coalesced"] is True
    assert set(fd_during["stages"]) == {"encode", "denoise", "decode"}
    for e in entries:
        assert e["status"] == "success"
        assert set(e) == {"status", "duration", "batch_size",
                          "decode_batch", "outputs"}
        assert (e["batch_size"], e["decode_batch"]) == (4, 4)
        assert set(e["outputs"]) == {"5"}
    assert twin_entry["coalesced_with"] == answers[0].payload["prompt_id"]
    assert twin_entry["outputs"] == entries[0]["outputs"]
    for s in range(4):
        # written by the staged run, then again by its result-tier repeat
        files = sorted(out.glob(f"m{s}_*.png"))
        assert [f.name for f in files] == [f"m{s}_00000.png"]
        assert files[0].read_bytes() == solo_pngs[s], s
    assert stages["enabled"] is True
    assert {k: stages[k] for k in ("groups", "members", "cache_hits",
                                   "fallbacks", "redispatched")} == {
        "groups": 1, "members": 4, "cache_hits": 0, "fallbacks": 0,
        "redispatched": 0}
    assert health["stages"] == {"encode": 0, "denoise": 0, "decode": 0}
    # the shared negative encoded once, though two encode threads met it
    assert (cond["miss"], cond["hit"]) == (5, 3)
    assert all(h["cache"] == "hit" and h["batch_size"] == 0 for h in hits)
    assert after["cache_hits"] == 4 and after["groups"] == 2
    # an idle worker of either host pool may take the other's items (the
    # steal): the pools' own counts vary, their sum and the denoise
    # pool's do not (cdt_stage_jobs_total below counts by stage)
    done = [after["pools"][p]["done"] for p in ("encode", "denoise",
                                                 "decode")]
    assert sum(done) == 8 + 1 + 4 and done[1] == 1
    assert cache["conditioning"]["miss"] == 5
    snap = ptel.REGISTRY.snapshot()
    assert snap["cdt_decode_batch_size"]["series"][0]["count"] == 1
    assert snap["cdt_decode_batch_size"]["series"][0]["sum"] == 4.0
    assert snap["cdt_batch_size"]["series"][0]["sum"] == 4.0
    jobs = {(s["labels"]["stage"], s["labels"]["outcome"]): s["value"]
            for s in snap["cdt_stage_jobs_total"]["series"]}
    assert jobs == {("encode", "ok"): 8.0, ("denoise", "ok"): 1.0,
                    ("decode", "ok"): 4.0}
    prompts = {s["labels"]["status"]: s["value"]
               for s in snap["cdt_prompts_total"]["series"]}
    assert prompts == {"success": 8.0}


def test_stages_off_is_the_fused_path(controller, solo_pngs, tmp_path,
                                      monkeypatch):
    monkeypatch.setenv("CDT_STAGES", "0")
    assert build_stages() is None

    async def run():
        c = controller(2)
        assert c.stages is None and c.queue.stages is None
        app = App(c)
        await c.startup()
        try:
            answers = await asyncio.gather(*[
                post(app, "/distributed/queue",
                     {"prompt": batchable(s, prefix=f"m{s}")})
                for s in range(2)])
            entries = [await final(c, a.payload["prompt_id"])
                       for a in answers]
            stages = (await get(app, "/distributed/stages")).payload
            return entries, stages, c.health(), c.frontdoor.stats()
        finally:
            await c.shutdown()

    entries, stages, health, fd = asyncio.run(run())
    for s, e in enumerate(entries):
        assert set(e) == {"status", "duration", "batch_size", "outputs"}
        assert e["batch_size"] == 2
        assert (tmp_path / "out" / f"m{s}_00000.png").read_bytes() == \
            solo_pngs[s]
    assert stages == {"enabled": False}
    assert health["stages"] is None and fd["stages"] is None


def test_the_wire_round_trip_keeps_the_bits(controller, solo_pngs, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("CDT_STAGE_WIRE", "1")
    ptel.set_enabled(True)
    ptel.REGISTRY.reset()
    calls = []
    real = tlat.LatentHandoff.from_payload.__func__

    def spied(cls, obj):
        calls.append(obj["prompt_id"])
        return real(cls, obj)

    monkeypatch.setattr(tlat.LatentHandoff, "from_payload",
                        classmethod(spied))

    async def run():
        c = controller(2)
        app = App(c)
        await c.startup()
        try:
            answers = await asyncio.gather(*[
                post(app, "/distributed/queue",
                     {"prompt": batchable(s, prefix=f"m{s}")})
                for s in (2, 3)])
            return [await final(c, a.payload["prompt_id"]) for a in answers]
        finally:
            await c.shutdown()

    entries = asyncio.run(run())
    assert [e["status"] for e in entries] == ["success"] * 2
    assert len(calls) == 2
    for s in (2, 3):
        assert (tmp_path / "out" / f"m{s}_00000.png").read_bytes() == \
            solo_pngs[s]
    sizes = ptel.REGISTRY.snapshot()["cdt_latent_transfer_bytes"]["series"]
    lat = HW // 2
    assert sizes[0]["count"] == 2
    assert sizes[0]["sum"] == 2 * lat * lat * 4 * 4


def test_a_dead_decode_worker_hands_its_latents_to_a_survivor(
        controller, solo_pngs, tmp_path):
    async def run():
        c = controller(2)
        deaths = []

        def hook(items):
            if not deaths:
                deaths.append(len(items))
                raise StageWorkerDeath("killed holding two latents")

        c.stages._death_hook = hook
        app = App(c)
        await c.startup()
        try:
            answers = await asyncio.gather(*[
                post(app, "/distributed/queue",
                     {"prompt": batchable(s, prefix=f"d{s}")})
                for s in (0, 1)])
            entries = [await final(c, a.payload["prompt_id"])
                       for a in answers]
            return c, entries, deaths
        finally:
            await c.shutdown()

    c, entries, deaths = asyncio.run(run())
    stats = c.stages.stats()
    assert deaths == [2]
    assert [e["status"] for e in entries] == ["success"] * 2
    assert stats["redispatched"] == 2 and stats["fallbacks"] == 0
    # (an idle encode worker may be the one that decodes: a steal)
    assert all(p["errors"] == 0 for p in stats["pools"].values())
    for s in (0, 1):
        assert (tmp_path / "out" / f"d{s}_00000.png").read_bytes() == \
            solo_pngs[s]


def test_the_decode_route_answers_the_local_decode_bitwise(
        controller, registry):
    bundle = registry.get("tiny")
    enc = bundle.text_encoder
    ctx, _ = enc.encode(["remote decode"])
    unc, _ = enc.encode([""])
    spec = tpipe.GenerationSpec(height=HW, width=HW, steps=2,
                                guidance_scale=2.0)
    lat = bundle.pipeline.generate_latents(spec, [5], [ctx], [unc])[0]
    local = bundle.pipeline.decode_latents([lat])[0].numpy()

    async def run():
        c = controller(1)
        app = App(c)
        await c.startup()
        try:
            answers = []
            for mod in (tlat, jlat):        # a handoff from either package
                h = mod.LatentHandoff(prompt_id="r1",
                                      latents=lat.numpy(),
                                      meta={"model": "tiny"})
                answers.append(await post(app, "/distributed/stages/decode",
                                          h.to_payload()))
            h = tlat.LatentHandoff(prompt_id="r1", latents=lat.numpy(),
                                   meta={"model": "tiny"})
            flipped = await post(app, "/distributed/stages/decode",
                                 _flip(h.to_payload(), 40))
            nameless = await post(
                app, "/distributed/stages/decode",
                tlat.LatentHandoff(prompt_id="r2",
                                   latents=lat.numpy()).to_payload())
            cors = await get(app, "/distributed/stages")
            return answers, flipped, nameless, cors
        finally:
            await c.shutdown()

    answers, flipped, nameless, cors = asyncio.run(run())
    for a in answers:
        assert a.status == 200 and a.payload["prompt_id"] == "r1"
        remote = tlat.decode_array_payload(a.payload["images"])
        assert remote.shape == (1, HW, HW, 3)
        assert np.array_equal(remote, local)
        assert np.array_equal(jlat.decode_array_payload(a.payload["images"]),
                              local)
    assert flipped.status == 400 and "CHECKSUM" in flipped.payload["error"]
    assert nameless.status == 400 and "names no model" in \
        nameless.payload["error"]
    assert cors.headers.get("Access-Control-Allow-Origin") == "*"


# --- repairs: the single-flight fill and the launch counters ----------------


class BlockingEncoder:
    """A stamped encoder whose first encode blocks until released."""

    _cdt_encoder_id = "fake/text/seed0"
    device = torch.device("cpu")

    def __init__(self):
        self.calls = 0
        self.started = threading.Event()
        self.release = threading.Event()

    def encode(self, texts):
        self.calls += 1
        if self.calls == 1:
            self.started.set()
            assert self.release.wait(60)
        n = len(texts[0])
        return (torch.full((1, 4, 8), float(n)), torch.full((1, 8), 1.0))


def test_two_threads_missing_one_key_encode_once():
    manager = CacheManager()
    enc = BlockingEncoder()
    results = {}

    def call(name):
        results[name] = tcond.cached_encode(manager, enc, ["blurry"])

    first = threading.Thread(target=call, args=("first",))
    first.start()
    assert enc.started.wait(60)             # the leader is inside its encode
    second = threading.Thread(target=call, args=("second",))
    second.start()
    assert manager.conditioning_flights.wait_for_waiters(1, timeout=60)
    enc.release.set()
    first.join(60)
    second.join(60)
    assert enc.calls == 1
    for a, b in zip(results["first"], results["second"]):
        assert torch.equal(a, b)
    stats = manager.conditioning.stats()
    assert (stats["miss"], stats["hit"]) == (1, 1)
    # another key is not held up behind a flight
    assert torch.equal(tcond.cached_encode(manager, enc, ["other"])[0],
                       torch.full((1, 4, 8), 5.0))
    assert enc.calls == 2


def test_launch_counts_are_exact_across_threads():
    before = dict(fa.LAUNCHES)
    go = threading.Event()

    def hammer():
        assert go.wait(60)
        for _ in range(20000):
            fa._count(fa.LAUNCHES, "flash_attention_bh")

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    go.set()
    for t in threads:
        t.join(120)
    assert fa.LAUNCHES["flash_attention_bh"] - before[
        "flash_attention_bh"] == 8 * 20000
    fa.LAUNCHES["flash_attention_bh"] = before["flash_attention_bh"]


# --- telemetry ---------------------------------------------------------------

STAGE_FAMILIES = ("cdt_stage_queue_depth", "cdt_stage_occupancy",
                  "cdt_stage_jobs_total", "cdt_stage_steals_total",
                  "cdt_decode_batch_size", "cdt_latent_transfer_bytes",
                  "cdt_latent_transfer_seconds", "cdt_residency_evictions_total",
                  "cdt_resident_models", "cdt_resident_bytes")


def test_the_new_families_render_the_jax_text():
    import comfyui_distributed_tpu.telemetry as jtel
    from comfyui_distributed_tpu.telemetry import export as jexport
    from comfyui_distributed_tpu.telemetry import metrics as jm
    from comfyui_distributed_tpu_torch.telemetry import export as pexport
    from comfyui_distributed_tpu_torch.telemetry import metrics as pm

    def drive(tel, m):
        tel.set_enabled(True)
        tel.REGISTRY.reset()
        m.STAGE_QUEUE_DEPTH.labels(stage="decode").set(3)
        m.STAGE_OCCUPANCY.labels(stage="encode").set(0.5)
        m.STAGE_JOBS.labels(stage="decode", outcome="ok").inc(4)
        m.STAGE_JOBS.labels(stage="encode", outcome="redispatch").inc()
        m.STAGE_STEALS.labels(src="decode", dst="encode").inc()
        m.DECODE_BATCH_SIZE.observe(4)
        m.LATENT_TRANSFER_BYTES.observe(524288)
        m.LATENT_TRANSFER_SECONDS.observe(0.0021)
        m.RESIDENCY_EVICTIONS.labels(reason="budget").inc()
        m.RESIDENT_MODELS.set(2)
        m.RESIDENT_BYTES.set(5.5e9)
        snap = tel.REGISTRY.snapshot()
        return {name: snap[name] for name in STAGE_FAMILIES}

    jsnap, psnap = drive(jtel, jm), drive(ptel, pm)
    # one HELP differs: JAX's names its own history, the port's the farm
    jhelp = jsnap["cdt_stage_steals_total"]["help"]
    phelp = psnap["cdt_stage_steals_total"]["help"]
    assert phelp.split(" (the ")[0] == jhelp.split(" (the ")[0]
    psnap["cdt_stage_steals_total"] = dict(psnap["cdt_stage_steals_total"],
                                           help=jhelp)
    assert (pexport.render_prometheus(psnap).encode()
            == jexport.render_prometheus(jsnap).encode())
    assert pexport.render_json(psnap) == jexport.render_json(jsnap)
    ptel.REGISTRY.reset()
