"""The port's fleet cache (``cluster/cache/fleet.py``) against the JAX
package's, on the CPU at the ``tiny`` preset.

Parity: the hash ring gives JAX's owners for the same (members, vnodes,
seed), the near keys JAX's hex digests, the entry wire decodes in either
package bitwise, ``generate_near`` matches JAX's within the repo's 2e-4
with JAX's noise handed in, and both packages build the same rings from
the same master and worker configs (a worker's ring lacks its master in
both). Behaviour, after the JAX package's ``tests/test_fleet_cache.py``
with an injected transport: the near tier, the kill switches, the drain
feed, the probe ladder, the fill, the handback and the entry routes.
End to end, two port controllers over HTTP: a duplicate served by its
ring owner with no sampler call, a recompute once the owner is gone,
and a near round."""

import asyncio
import contextlib
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.cluster.cache import fleet as jfleet
from comfyui_distributed_tpu.cluster.cache import keys as jkeys
from comfyui_distributed_tpu.cluster.stages import latents as jlatents
from comfyui_distributed_tpu_torch.api.app import App, Request, ServerThread
from comfyui_distributed_tpu_torch.cluster import faults
from comfyui_distributed_tpu_torch.cluster.cache import CacheManager
from comfyui_distributed_tpu_torch.cluster.cache import fleet as tfleet
from comfyui_distributed_tpu_torch.cluster.cache import keys as tkeys
from comfyui_distributed_tpu_torch.cluster.cache.conditioning import \
    encoder_mode
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.elastic.states import DRAIN
from comfyui_distributed_tpu_torch.cluster.frontdoor import microbatch as tmb
from comfyui_distributed_tpu_torch.cluster.resilience import BREAKERS
from comfyui_distributed_tpu_torch.cluster.stages import latents as tlatents
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe
from comfyui_distributed_tpu_torch.diffusion.checkpoint import \
    LatentCheckpoint
from comfyui_distributed_tpu_torch.graph import GraphExecutor
from comfyui_distributed_tpu_torch.graph.executor import strip_meta
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
from comfyui_distributed_tpu_torch.utils.network import http_request
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
HW, STEPS = 32, 4


@pytest.fixture(autouse=True)
def _fresh_registries():
    """The breakers and the drain registry are process-global."""
    for reset in (BREAKERS.reset, DRAIN.reset, faults.deactivate):
        reset()
    yield
    for reset in (BREAKERS.reset, DRAIN.reset, faults.deactivate):
        reset()


def hex_keys(n, salt="k"):
    return [tkeys.digest("fleet-test", salt, str(i)) for i in range(n)]


# --- parity: the ring, the near keys, the wire ----------------------------------


@pytest.mark.parametrize("members", [(), ("a",), ("a", "b"),
                                     ("master", "w0", "w1", "w2", "w3")])
@pytest.mark.parametrize("seed", ["cdt-fleet-ring-v1", "other-seed"])
@pytest.mark.parametrize("vnodes", [64, 7])
def test_ring_owners_are_jax_owners(members, seed, vnodes):
    keys = hex_keys(200, salt=seed) + [str(i) for i in range(20)]
    ours = tfleet.HashRing(members, vnodes=vnodes, seed=seed)
    theirs = jfleet.HashRing(members, vnodes=vnodes, seed=seed)
    assert [ours.owner(k) for k in keys] == [theirs.owner(k) for k in keys]
    assert ours.members() == theirs.members() == sorted(members)
    assert len(ours) == len(members)


def test_ring_defaults_are_the_knobs(monkeypatch):
    ring = tfleet.HashRing(("a", "b"))
    assert (ring.vnodes, ring.seed) == (64, "cdt-fleet-ring-v1")
    monkeypatch.setenv("CDT_FLEET_CACHE_VNODES", "9")
    monkeypatch.setenv("CDT_FLEET_CACHE_SEED", "s9")
    ring = tfleet.HashRing(("a", "b"))
    assert (ring.vnodes, ring.seed) == (9, "s9")
    jring = jfleet.HashRing(("a", "b"), vnodes=9, seed="s9")
    assert all(ring.owner(k) == jring.owner(k) for k in hex_keys(50))


@pytest.mark.parametrize("change", ["add", "remove"])
def test_a_member_joining_or_leaving_remaps_only_its_own_arcs(change):
    keys = hex_keys(400)
    small = tfleet.HashRing(("a", "b", "c"), vnodes=64, seed="s")
    big = tfleet.HashRing(("a", "b", "c", "d"), vnodes=64, seed="s")
    before, after = (small, big) if change == "add" else (big, small)
    moved = [(before.owner(k), after.owner(k)) for k in keys
             if before.owner(k) != after.owner(k)]
    assert moved and len(moved) < len(keys)
    if change == "add":
        assert all(new == "d" for _, new in moved)
    else:
        assert all(old == "d" for old, _ in moved)
    owners = [big.owner(k) for k in keys]
    assert all(owners.count(m) > 40 for m in "abcd")
    assert tfleet.HashRing((), vnodes=8, seed="s").owner("k") is None


NEAR_PROMPTS = [
    {"1": {"class_type": "TPUTxt2Img", "inputs": {"seed": 41, "steps": 8}},
     "2": {"class_type": "CLIPTextEncode", "inputs": {"text": "a cat"}}},
    {"1": {"class_type": "TPUTxt2Img", "inputs": {"seed": 9, "steps": 8}},
     "2": {"class_type": "CLIPTextEncode", "inputs": {"text": "a cat"}}},
    {"1": {"class_type": "TPUTxt2Img", "inputs": {"seed": ["3", 0]}},
     "3": {"class_type": "DistributedSeed", "inputs": {"seed": 5}}},
    {"1": {"class_type": "TPUTxt2Img", "inputs": {"seed": 1.5}},
     "9": "not a node", "8": {"inputs": "not a dict"}},
]


@pytest.mark.parametrize("prompt", NEAR_PROMPTS)
def test_near_keys_are_jax_digests(prompt):
    fp = tkeys.near_fingerprint(prompt)
    assert fp == jkeys.near_fingerprint(prompt)
    for args in [(fp, "sig"), (fp, "sig", "bpe", "w1")]:
        assert tkeys.near_key(*args) == jkeys.near_key(*args)
    assert tkeys.near_key(fp, "sig") != tkeys.result_key(fp, "sig")
    # the caller's prompt is untouched
    assert tkeys.near_fingerprint(prompt) == fp


def test_the_near_fingerprint_masks_integer_seeds_only():
    a, b, wired, _ = NEAR_PROMPTS
    assert tkeys.near_fingerprint(a) == tkeys.near_fingerprint(b)
    assert tkeys.request_fingerprint(a) != tkeys.request_fingerprint(b)
    # a seed wired from another node is graph structure: it stays
    rewired = json.loads(json.dumps(wired))
    rewired["1"]["inputs"]["seed"] = ["4", 0]
    assert tkeys.near_fingerprint(wired) != tkeys.near_fingerprint(rewired)
    # another text is other work
    c = json.loads(json.dumps(a))
    c["2"]["inputs"]["text"] = "a dog"
    assert tkeys.near_fingerprint(c) != tkeys.near_fingerprint(a)


def test_an_entry_crosses_between_the_packages_bitwise():
    rng = np.random.default_rng(3)
    images = rng.random((1, 8, 12, 3), dtype=np.float32)
    images[0, 0, 0, 0] = np.float32(np.nextafter(np.float32(0.5), 1))
    key = hex_keys(1)[0]
    ours = json.loads(json.dumps(tfleet.encode_entry(
        key, {"images": torch.from_numpy(images)})))
    assert ours["key"] == key
    back = jlatents.decode_array_payload(ours["arrays"]["images"])
    assert back.dtype == np.float32 and back.tobytes() == images.tobytes()
    # a JAX PUT body (the fill of its FleetCache) decodes here bitwise
    theirs = {"key": key, "arrays": {"images": jlatents.encode_array_payload(
        images)}}
    got = tfleet.decode_entry(json.dumps(theirs).encode())
    assert got["images"].tobytes() == images.tobytes()
    assert tfleet.decode_entry(b'{"arrays": {}}') is None
    bad = {"arrays": {"images": dict(theirs["arrays"]["images"],
                                     sha256="0" * 64)}}
    with pytest.raises(tlatents.LatentWireError):
        tfleet.decode_entry(json.dumps(bad).encode())


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
    ctx, pooled = enc.encode(["a cat"])
    unc, upooled = enc.encode([""])
    cond = [np.array(a) for a in (ctx, unc, np.asarray(pooled)[:, :8],
                                  np.asarray(upooled)[:, :8])]
    return jpipe, jp, tp, cond


def jax_noise(seed: int, shape) -> torch.Tensor:
    """The JAX pipeline's noise at the ladder's head for participant 0."""
    k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 0))
    return torch.from_numpy(np.array(jax.random.normal(k_noise, shape,
                                                       jnp.float32)))


@pytest.mark.parametrize("adm", [True, False])
def test_generate_near_matches_jax(tiny_pair, adm):
    from comfyui_distributed_tpu.parallel import build_mesh

    jpipe, jp, tp, cond = tiny_pair
    spec = dict(height=32, width=32, steps=4, denoise=0.5, sampler="euler",
                scheduler="karras", guidance_scale=3.0)
    donor = np.random.default_rng(7).standard_normal(
        (1, 16, 16, 4)).astype(np.float32)
    y = [cond[2], cond[3]] if adm else [None, None]
    ref = jp.generate_near(build_mesh({"dp": 1}), jpipe.GenerationSpec(**spec),
                           5, jnp.asarray(donor), jnp.asarray(cond[0]),
                           jnp.asarray(cond[1]),
                           *[None if a is None else jnp.asarray(a) for a in y])
    out = tp.generate_near(
        tpipe.GenerationSpec(**spec), 5, torch.from_numpy(donor),
        torch.from_numpy(cond[0]), torch.from_numpy(cond[1]),
        *[None if a is None else torch.from_numpy(a) for a in y],
        noise=jax_noise(5, donor.shape))
    assert out.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    # its own noise: a function of the seed, and another image
    a = tp.generate_near(tpipe.GenerationSpec(**spec), 5,
                         torch.from_numpy(donor), torch.from_numpy(cond[0]),
                         torch.from_numpy(cond[1]))
    b = tp.generate_near(tpipe.GenerationSpec(**spec), 5,
                         torch.from_numpy(donor), torch.from_numpy(cond[0]),
                         torch.from_numpy(cond[1]))
    assert torch.equal(a, b) and not torch.equal(a, out)


@pytest.mark.parametrize("role", ["master", "worker"])
def test_both_packages_build_the_same_ring_from_one_config(
        tmp_path, monkeypatch, role):
    """Membership is each host's config plus itself: a worker's config
    lists hosts, not its master, so its ring lacks the master in both
    packages (only the master → worker direction shares entries)."""
    from comfyui_distributed_tpu.cluster.controller import (
        Controller as JController)

    cfg = tmp_path / "c.json"
    hosts = [{"id": "w0", "address": "http://127.0.0.1:9101",
              "type": "remote", "enabled": True},
             {"id": "w1", "address": "127.0.0.1:9102", "type": "local",
              "enabled": True}]
    cfg.write_text(json.dumps({"hosts": hosts} if role == "master" else {}))
    if role == "worker":
        monkeypatch.setenv("CDT_IS_WORKER", "1")
        monkeypatch.setenv("CDT_WORKER_ID", "w0")
    jc = JController(cfg)
    tc = Controller(cfg, device="cpu")
    try:
        want = jc._fleet_membership()
        assert tc._fleet_membership() == want
        jring, _ = jc.cache.fleet.ring()
        tring, _ = tc.cache.fleet.ring()
        assert tring.members() == jring.members()
        keys = hex_keys(100)
        assert [tring.owner(k) for k in keys] == [jring.owner(k) for k in keys]
    finally:
        jc.cache.fleet.close()
        tc.cache.fleet.close()
    if role == "master":
        assert want == {"master": None, "w0": "http://127.0.0.1:9101",
                        "w1": "http://127.0.0.1:9102"}
    else:
        assert want == {"w0": None}


# --- the near tier ---------------------------------------------------------------


def ckpt(step=1, total=4, tag="x"):
    return LatentCheckpoint(
        sampler="euler", step=step, total_steps=total,
        carry=(np.full((1, 4, 2, 2), step, np.float32),),
        meta={"sampler": "euler", "conditioning": tag, "steps": total})


def test_near_tier_offer_lookup_and_meta_mismatch():
    tier = tfleet.NearTier(max_entries=8)
    nk = tkeys.digest("near-test", "a")
    assert tier.offer(nk, ckpt(step=2, tag="cond-a"))
    hit = tier.lookup(nk, {"conditioning": "cond-a", "steps": 4})
    assert hit is not None and hit.step == 2
    assert np.array_equal(hit.carry[0], np.full((1, 4, 2, 2), 2, np.float32))
    # a mismatch is a counted miss and drops the donor: never a wrong init
    assert tier.lookup(nk, {"conditioning": "cond-OTHER"}) is None
    assert tier.counts["mismatch"] == 1
    assert tier.lookup(nk, {"conditioning": "cond-a"}) is None
    assert tier.stats()["entries"] == 0
    assert tier.lookup(tkeys.digest("never"), {}) is None


def test_near_tier_latest_donor_wins_and_lru_cap(monkeypatch):
    tier = tfleet.NearTier(max_entries=2)
    nks = [tkeys.digest("near-lru", str(i)) for i in range(3)]
    tier.offer(nks[0], ckpt(step=1))
    tier.offer(nks[0], ckpt(step=3))      # a new donor replaces the old
    assert tier.lookup(nks[0], {}).step == 3
    assert tier.counts["donor"] == 2
    tier.offer(nks[1], ckpt(step=1))
    tier.offer(nks[2], ckpt(step=2))      # past the cap: the oldest goes
    assert tier.lookup(nks[0], {}) is None
    assert tier.lookup(nks[1], {}) is not None
    assert tier.lookup(nks[2], {}) is not None
    assert tier.stats() == {"entries": 2, "max_entries": 2, "donor": 4,
                            "reuse": 0, "steps_saved": 0, "mismatch": 0}
    tier.record_reuse(2)
    assert tier.counts["reuse"] == 1 and tier.counts["steps_saved"] == 2
    assert tfleet.NearTier(max_entries=0).offer(nks[0], ckpt()) is None
    monkeypatch.setenv("CDT_FLEET_CACHE_NEAR_MAX", "3")
    assert tfleet.NearTier().max_entries == 3


# --- construction and the kill switches -----------------------------------------


def test_the_kill_switches(tmp_path, monkeypatch):
    monkeypatch.setenv("CDT_FLEET_CACHE", "0")
    assert tfleet.build_fleet_cache(CacheManager(), "w0", dict) is None
    (tmp_path / "c.json").write_text("{}")
    off = Controller(tmp_path / "c.json", device="cpu")
    assert off.cache is not None and off.cache.fleet is None
    assert off.cache.stats()["fleet"] is None
    monkeypatch.setenv("CDT_FLEET_CACHE", "1")
    assert tfleet.build_fleet_cache(None, "w0", dict) is None
    fleet = tfleet.build_fleet_cache(CacheManager(), "w0", dict)
    try:
        assert fleet is not None and fleet.self_id == "w0"
    finally:
        fleet.close()
    monkeypatch.setenv("CDT_CACHE", "0")
    assert Controller(tmp_path / "c.json", device="cpu").cache is None
    # no fleet tier: a near member keeps the per-host path
    p = type("P", (), {"stackable": True})()
    assert tmb._near_key_for(p, off.cache) is None


def test_the_ring_leaves_out_leaving_workers_through_the_drain_feed():
    fleet = tfleet.FleetCache(
        CacheManager(), "w0",
        lambda: {"w0": None, "w1": "http://b", "w2": "http://c"})
    try:
        ring, _ = fleet.ring()
        assert ring.members() == ["w0", "w1", "w2"]
        assert fleet.ring()[0] is ring           # rebuilt only on a change
        DRAIN.mark_draining("w1")
        ring, members = fleet.ring()
        assert ring.members() == ["w0", "w2"] and "w1" not in members
        DRAIN.mark_decommissioned("w1")
        assert fleet.ring()[0].members() == ["w0", "w2"]
        DRAIN.reactivate("w1")
        assert fleet.ring()[0].members() == ["w0", "w1", "w2"]
        stats = fleet.stats()
        assert stats["ring_size"] == 3 and stats["self"] == "w0"
        assert stats["vnodes"] == 64 and stats["near"]["entries"] == 0
    finally:
        fleet.close()
    # closed: off the feed
    DRAIN.mark_draining("w2")
    assert fleet._ring_cache is not None


# --- the probe ladder, the fill, the handback -------------------------------------


@contextlib.contextmanager
def bg_loop():
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    try:
        yield loop
    finally:
        loop.call_soon_threadsafe(loop.stop)
        t.join(2)
        loop.close()


def key_owned_by(fleet, member, n=400):
    for i in range(n):
        k = tkeys.digest("owned", member, str(i))
        if fleet.owner_of(k)[0] == member:
            return k
    raise AssertionError(f"no key owned by {member} in {n} tries")


def two_members(transport, manager=None):
    return tfleet.FleetCache(manager or CacheManager(), "w0",
                             lambda: {"w0": None, "w1": "http://b"},
                             transport=transport)


def test_the_probe_ladder_hit_miss_and_skip():
    entries, calls = {}, []

    async def transport(op, owner, url, key, arrays):
        calls.append((op, owner, key))
        if op == "get":
            return entries.get(key)
        entries[key] = arrays

    fleet = two_members(transport)
    try:
        key = key_owned_by(fleet, "w1")
        # no loop yet: a skipped miss
        assert fleet.probe(key) is None
        assert fleet.counts["remote_skipped"] == 1 and not calls
        with bg_loop() as loop:
            fleet.attach_loop(loop)
            assert fleet.probe(key) is None
            assert fleet.counts["remote_miss"] == 1
            entries[key] = {"images": np.arange(4.0, dtype=np.float32)}
            hit = fleet.probe(key)
            assert isinstance(hit["images"], torch.Tensor)
            assert torch.equal(hit["images"], torch.arange(4.0))
            assert fleet.counts["remote_hit"] == 1
            # a key this host owns is never asked of another
            before = len(calls)
            assert fleet.probe(key_owned_by(fleet, "w0")) is None
            assert len(calls) == before
            # on the loop's own thread: a miss, never a deadlock
            on_loop = asyncio.run_coroutine_threadsafe(
                _probe_async(fleet, key), loop).result(5)
            assert on_loop is None
            assert fleet.counts["remote_skipped"] == 2
    finally:
        fleet.close()
    assert BREAKERS.state("w1") == "closed"


async def _probe_async(fleet, key):
    return fleet.probe(key)


@pytest.mark.parametrize("failure", ["error", "slow"])
def test_a_dead_or_slow_owner_is_a_miss_and_no_breaker_failure(
        monkeypatch, failure):
    monkeypatch.setenv("CDT_FLEET_CACHE_TIMEOUT_S", "0.2")

    async def transport(op, owner, url, key, arrays):
        if failure == "slow":
            await asyncio.sleep(2)
        raise RuntimeError("owner is dead")

    fleet = two_members(transport)
    try:
        key = key_owned_by(fleet, "w1")
        with bg_loop() as loop:
            fleet.attach_loop(loop)
            for _ in range(5 if failure == "error" else 2):
                t0 = time.monotonic()
                assert fleet.probe(key) is None
                assert time.monotonic() - t0 < 1.5
        assert fleet.counts["remote_error"] == (5 if failure == "error"
                                                else 2)
        assert BREAKERS.state("w1") == "closed"
    finally:
        fleet.close()


def test_an_open_breaker_is_skipped():
    async def transport(op, owner, url, key, arrays):
        return {"images": np.zeros(2, np.float32)}

    fleet = two_members(transport)
    try:
        key = key_owned_by(fleet, "w1")
        BREAKERS.trip("w1")
        with bg_loop() as loop:
            fleet.attach_loop(loop)
            assert fleet.probe(key) is None
            fleet.fill(key, {"images": torch.ones(2)})
        assert fleet.counts["remote_hit"] == 0
        assert fleet.counts["remote_skipped"] == 1
        assert fleet.counts["fill"] == 0
    finally:
        fleet.close()


def test_fill_is_fire_and_forget():
    stored, release = {}, threading.Event()

    async def transport(op, owner, url, key, arrays):
        await asyncio.get_running_loop().run_in_executor(None, release.wait,
                                                         5)
        stored[key] = arrays

    fleet = two_members(transport)
    try:
        key = key_owned_by(fleet, "w1")
        with bg_loop() as loop:
            fleet.attach_loop(loop)
            t0 = time.monotonic()
            fleet.fill(key, {"images": torch.ones(3)})
            assert time.monotonic() - t0 < 1.0 and key not in stored
            assert fleet._pending                     # held while in flight
            release.set()
            deadline = time.monotonic() + 5
            while fleet._pending and time.monotonic() < deadline:
                time.sleep(0.01)
        assert np.array_equal(stored[key]["images"], np.ones(3, np.float32))
        assert fleet.counts["fill"] == 1 and not fleet._pending
        # a key this host owns never leaves it
        own = key_owned_by(fleet, "w0")
        fleet.fill(own, {"images": torch.ones(3)})
        assert own not in stored
    finally:
        fleet.close()


def test_the_drain_handback_moves_each_key_exactly_once():
    manager, received = CacheManager(), []

    async def transport(op, owner, url, key, arrays):
        received.append((op, owner, key))

    fleet = two_members(transport, manager)
    try:
        pre = tfleet.HashRing(("w0", "w1"))
        mine, theirs = [], []
        for k in hex_keys(40, salt="hb"):
            (mine if pre.owner(k) == "w0" else theirs).append(k)
            manager.results.put(k, {"images": torch.full((2,), len(mine))})
        assert mine and theirs
        hits = manager.results.stats()["hit"]
        DRAIN.mark_draining("w0")
        moved = asyncio.run(fleet.handback())
        assert sorted(moved) == sorted(mine)
        assert sorted(k for _, _, k in received) == sorted(mine)
        # a handback is a PUT to the new owner (the transport's op, as in
        # the JAX package), counted as a handback
        assert {(op, o) for op, o, _ in received} == {("put", "w1")}
        assert fleet.counts["handback"] == len(mine)
        assert all(manager.results.peek(k) is None for k in mine)
        assert all(manager.results.peek(k) is not None for k in theirs)
        assert manager.results.stats()["hit"] == hits   # peek counts nothing
        # a second drain signal sends nothing again
        assert asyncio.run(fleet.handback()) == []
        assert len(received) == len(mine)
    finally:
        fleet.close()


def test_the_drain_feed_starts_the_handback_on_the_loop():
    manager, received = CacheManager(), []

    async def transport(op, owner, url, key, arrays):
        received.append(key)

    fleet = two_members(transport, manager)
    try:
        key = key_owned_by(fleet, "w0")
        manager.results.put(key, {"images": torch.zeros(2)})
        with bg_loop() as loop:
            fleet.attach_loop(loop)
            DRAIN.mark_draining("w0")
            deadline = time.monotonic() + 5
            while not received and time.monotonic() < deadline:
                time.sleep(0.01)
        assert received == [key]
    finally:
        fleet.close()


def test_a_handback_without_a_successor_moves_nothing():
    manager = CacheManager()

    async def transport(op, owner, url, key, arrays):
        raise AssertionError("no successor to send to")

    fleet = tfleet.FleetCache(manager, "w0", lambda: {"w0": None},
                              transport=transport)
    try:
        keys = hex_keys(5, salt="solo")
        for k in keys:
            manager.results.put(k, {"images": torch.zeros(1)})
        DRAIN.mark_draining("w0")
        assert asyncio.run(fleet.handback()) == []
        assert all(manager.results.peek(k) is not None for k in keys)
    finally:
        fleet.close()


# --- the entry routes -------------------------------------------------------------


def call(app, method, path, payload=None, headers=None):
    body = b"" if payload is None else json.dumps(payload).encode()
    h = {"content-type": "application/json", **(headers or {})}
    return asyncio.run(app.dispatch(Request(method, path, h, body)))


def payload_of(response):
    p = response.payload
    return json.loads(p) if isinstance(p, bytes) else p


@pytest.mark.parametrize("fleet_on", ["1", "0"])
def test_the_entry_routes_round_trip_and_refuse(tmp_path, monkeypatch,
                                                fleet_on):
    monkeypatch.setenv("CDT_FLEET_CACHE", fleet_on)
    (tmp_path / "c.json").write_text("{}")
    c = Controller(tmp_path / "c.json", device="cpu")
    assert (c.cache.fleet is None) == (fleet_on == "0")
    app = App(c)
    key = tkeys.digest("route", "entry")
    path = f"/distributed/cache/entry/{key}"
    assert call(app, "GET", path).status == 404
    for bad in ("not-a-key", "AB" * 32, "0" * 63, "0" * 65):
        assert call(app, "GET", f"/distributed/cache/entry/{bad}").status \
            == 400, bad
        assert call(app, "PUT", f"/distributed/cache/entry/{bad}",
                    {"arrays": {}}).status == 400, bad
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    r = call(app, "PUT", path, {"arrays": {
        "images": jlatents.encode_array_payload(arr)}})
    assert r.status == 200 and r.payload == {"status": "stored", "key": key,
                                             "arrays": 1}
    stored = c.cache.results.peek(key)["images"]
    assert isinstance(stored, torch.Tensor) and stored.numpy().tobytes() \
        == arr.tobytes()
    r = call(app, "GET", path)
    assert r.status == 200
    back = jlatents.decode_array_payload(payload_of(r)["arrays"]["images"])
    assert back.tobytes() == arr.tobytes()
    # a payload that does not verify is refused and never stored
    k2 = tkeys.digest("route", "corrupt")
    corrupt = {"arrays": {"images": dict(
        jlatents.encode_array_payload(arr), sha256="0" * 64)}}
    assert call(app, "PUT", f"/distributed/cache/entry/{k2}",
                corrupt).status == 400
    assert call(app, "GET", f"/distributed/cache/entry/{k2}").status == 404
    for body in ({}, {"arrays": []}, {"arrays": {}}):
        assert call(app, "PUT", path, body).status == 400
    # with a token, both routes need it
    monkeypatch.setenv("CDT_AUTH_TOKEN", "t1")
    assert call(app, "GET", path).status == 401
    assert call(app, "PUT", path, {"arrays": {}}).status == 401
    assert call(app, "GET", path, headers={"X-CDT-Auth": "t1"}).status == 200
    assert call(app, "GET", "/distributed/health").status == 200


# --- end to end: two controllers over HTTP ------------------------------------------


@pytest.fixture(scope="module")
def registry():
    return ModelRegistry("cpu", seed=0)


def prompt(seed, text="a fleet cat", prefix="fc"):
    return {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": "tiny"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": text, "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": "", "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": STEPS, "cfg": 2.0, "width": HW,
            "height": HW, "sampler_name": "euler", "scheduler": "karras"}},
        "5": {"class_type": "SaveImage",
              "inputs": {"images": ["4", 0], "filename_prefix": prefix}},
    }


def result_key_of(p, bundle):
    """The key the group executor gives ``p`` on the CPU."""
    return tkeys.result_key(tkeys.request_fingerprint(strip_meta(p)),
                            tkeys.execution_signature("cpu"),
                            encoder_mode(bundle.text_encoder),
                            bundle.weights_identity())


def post(base, payload):
    status, body = http_request(base + "/distributed/queue",
                                json.dumps(payload).encode(),
                                {"Content-Type": "application/json"},
                                timeout=30)
    assert status == 200, body
    return json.loads(body)


def final(controller, pid, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        entry = controller.queue.history.get(pid)
        if entry is not None and entry.get("status") in (
                "success", "error", "interrupted", "expired"):
            return dict(entry, prompt_id=pid)
        time.sleep(0.02)
    raise TimeoutError(pid)


@contextlib.contextmanager
def unet_calls(bundle):
    """Counts the UNet's forwards while the block runs."""
    unet = bundle.pipeline.unet
    calls = [0]
    real = unet.forward

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    unet.forward = counted
    try:
        yield calls
    finally:
        del unet.forward


@contextlib.contextmanager
def controller_env(**env):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        yield


@pytest.fixture
def served_images(monkeypatch, tmp_path):
    """prompt id → the sampler output each served member's suffix got
    (history keeps only the output nodes); the shape catalog in
    ``tmp_path``."""
    from comfyui_distributed_tpu_torch.cluster import shape_catalog

    monkeypatch.setenv("CDT_SHAPE_CATALOG", str(tmp_path / "catalog.json"))
    shape_catalog.reset_default_catalog()
    seen = {}
    real = tmb._finish

    def finish(prep, images):
        seen[prep.member.prompt_id] = images.detach().cpu().clone()
        return real(prep, images)

    monkeypatch.setattr(tmb, "_finish", finish)
    yield seen
    shape_catalog.reset_default_catalog()


def test_a_duplicate_is_served_by_its_ring_owner_then_recomputed_without_it(
        tmp_path, registry, served_images):
    bundle = registry.get("tiny")
    (tmp_path / "w.json").write_text("{}")
    with controller_env(CDT_IS_WORKER="1", CDT_WORKER_ID="w0",
                        CDT_OUTPUT_DIR=str(tmp_path / "w_out"),
                        CDT_CACHE_DIR=str(tmp_path / "w_cache")):
        owner = Controller(tmp_path / "w.json", device="cpu",
                           model_registry=ModelRegistry("cpu", seed=0))
    owner_server = ServerThread(owner)
    owner_url = f"http://127.0.0.1:{owner_server.port}"
    (tmp_path / "m.json").write_text(json.dumps({"hosts": [
        {"id": "w0", "address": owner_url, "type": "remote",
         "enabled": True}]}))
    out = tmp_path / "m_out"
    with controller_env(CDT_OUTPUT_DIR=str(out), CDT_CACHE_DIR=""):
        master = Controller(tmp_path / "m.json", device="cpu",
                            model_registry=registry)
    server = ServerThread(master)
    base = f"http://127.0.0.1:{server.port}"
    fleet = master.cache.fleet
    try:
        assert master.cache.dir is None                    # memory only
        stats = json.loads(http_request(base + "/distributed/cache")[1])
        assert stats["fleet"]["members"] == ["master", "w0"]
        health = json.loads(http_request(base + "/distributed/health")[1])
        assert health["cache"]["fleet_ring"] == 2
        # a seed whose result the master's ring gives to w0
        seed = next(s for s in range(41, 200) if fleet.owner_of(
            result_key_of(prompt(s), bundle))[0] == "w0")
        key = result_key_of(prompt(seed), bundle)
        with unet_calls(bundle) as calls:
            first = final(master, post(base, {"prompt": prompt(seed)})
                          ["prompt_id"])
        ref = served_images[first["prompt_id"]]
        assert first["status"] == "success" and "cache" not in first
        assert calls[0] > 0
        assert master.cache.results.keys() == [key]
        png = (out / "fc_00000.png").read_bytes()
        deadline = time.monotonic() + 10
        while fleet.counts["fill"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fleet.counts["remote_miss"] == 1 and fleet.counts["fill"] == 1
        # w0 holds the master's bytes
        status, body = http_request(
            f"{owner_url}/distributed/cache/entry/{key}")
        assert status == 200
        held = tfleet.decode_entry(body)["images"]
        assert held.tobytes() == \
            master.cache.results.peek(key)["images"].numpy().tobytes()
        # the local tiers cleared: only the ring can answer
        http_request(base + "/distributed/cache/clear", b"{}",
                     {"Content-Type": "application/json"})
        with unet_calls(bundle) as calls:
            again = final(master, post(base, {"prompt": prompt(seed)})
                          ["prompt_id"])
        assert again["status"] == "success" and again["cache"] == "hit"
        assert calls[0] == 0
        assert torch.equal(served_images[again["prompt_id"]], ref)
        assert (out / "fc_00000.png").read_bytes() == png
        assert fleet.counts["remote_hit"] == 1
        assert master.cache.hit_rate() > 0
        # the owner gone: the survivor recomputes the same bytes
        owner_server.stop()
        owner_server = None
        master.cache.results.clear_memory()
        with unet_calls(bundle) as calls:
            third = final(master, post(base, {"prompt": prompt(seed)})
                          ["prompt_id"])
        assert third["status"] == "success" and "cache" not in third
        assert calls[0] > 0
        assert torch.equal(served_images[third["prompt_id"]], ref)
        assert fleet.counts["remote_error"] >= 1
        assert BREAKERS.state("w0") == "closed"
    finally:
        server.stop()
        if owner_server is not None:
            owner_server.stop()


def test_the_near_round(tmp_path, registry, served_images):
    bundle = registry.get("tiny")
    (tmp_path / "m.json").write_text("{}")
    out = tmp_path / "out"
    with controller_env(CDT_OUTPUT_DIR=str(out),
                        CDT_CACHE_DIR=str(tmp_path / "cache")):
        master = Controller(tmp_path / "m.json", device="cpu",
                            model_registry=registry)
    server = ServerThread(master)
    base = f"http://127.0.0.1:{server.port}"
    near = master.cache.fleet.near
    try:
        text = "a near cat"
        donor = final(master, post(base, {
            "prompt": prompt(21, text, "near"), "cache": "near"})
            ["prompt_id"])
        assert donor["status"] == "success" and "cache" not in donor
        assert near.counts["donor"] == 1 and near.counts["reuse"] == 0
        # the donor path is bitwise its plain run
        plain = final(master, post(base, {
            "prompt": prompt(21, text, "near"), "cache": "bypass"})
            ["prompt_id"])
        donor_img = served_images[donor["prompt_id"]]
        assert torch.equal(served_images[plain["prompt_id"]], donor_img)
        # a re-roll under another seed resumes the donor's midpoint
        with unet_calls(bundle) as calls:
            reroll = final(master, post(base, {
                "prompt": prompt(99, text, "near"), "cache": "near"})
                ["prompt_id"])
        assert reroll["status"] == "success" and reroll["cache"] == "near"
        assert reroll["batch_size"] == 0
        assert near.counts["reuse"] == 1
        assert near.counts["steps_saved"] == STEPS // 2
        assert calls[0] == STEPS // 2            # euler: one call a step
        img = served_images[reroll["prompt_id"]]
        assert torch.isfinite(img).all() and 0 <= img.min() <= img.max() <= 1
        assert not torch.equal(img, donor_img)
        # the graph modulo its seed, its SaveImage prefix included
        assert (out / "near_00000.png").is_file()
        # ... and not that seed's run from scratch
        full = GraphExecutor({"model_registry": registry,
                              "output_dir": str(tmp_path / "solo")}).execute(
            prompt(99, text, "full"))["4"][0]
        assert not torch.equal(img, full)
        # bitwise generate_near on the donor's latent and the same seed
        (cid,) = near._map.values()
        parked = near.store.get(cid)
        assert parked.step == STEPS // 2
        ex = GraphExecutor({"model_registry": registry,
                            "output_dir": str(tmp_path / "solo")})
        cache = ex.execute({k: v for k, v in prompt(99, text).items()
                            if k in ("1", "2", "3")})
        from comfyui_distributed_tpu_torch.graph import nodes_builtin as nb

        pos, neg = cache["2"][0], cache["3"][0]
        adm = bundle.pipeline.unet.config.adm_in_channels
        spec = tpipe.GenerationSpec(height=HW, width=HW, steps=STEPS,
                                    guidance_scale=2.0, denoise=0.5)
        direct = bundle.pipeline.generate_near(
            spec, 99, torch.from_numpy(np.array(parked.carry[0])),
            pos["context"], neg["context"], nb._adm_from_cond(pos, adm, "cpu"),
            nb._adm_from_cond(neg, adm, "cpu"))
        assert torch.equal(direct, img)
        # the result tier still counts a near serve as a miss, and holds
        # no near image
        assert master.cache.results.stats()["put"] == 2
        # a request that did not opt in never touches the near tier
        exact = final(master, post(base, {"prompt": prompt(7, text, "near")})
                      ["prompt_id"])
        assert exact["status"] == "success" and "cache" not in exact
        assert near.counts["reuse"] == 1 and near.counts["donor"] == 1
    finally:
        server.stop()
