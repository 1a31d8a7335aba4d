"""The port's content cache (``cluster/cache``) against the JAX package's:
the keys give JAX's hex digests for the same inputs (the execution
signature is the port's own and never JAX's), the store evicts within
its byte bounds and never serves a corrupt persisted entry, the
coalescer settles its waiters however the leader ends, and the
conditioning tier hands back a fresh encode's bits on the encoder's
device. Standard library, numpy and torch only on the port's side; the
JAX modules compared here are its pure-Python ones."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.cluster.cache import coalesce as jcoalesce
from comfyui_distributed_tpu.cluster.cache import keys as jkeys
from comfyui_distributed_tpu.utils import jsonio as jjsonio
from comfyui_distributed_tpu_torch.cluster import cache as tcache
from comfyui_distributed_tpu_torch.cluster.cache import coalesce as tcoalesce
from comfyui_distributed_tpu_torch.cluster.cache import conditioning as tcond
from comfyui_distributed_tpu_torch.cluster.cache import keys as tkeys
from comfyui_distributed_tpu_torch.cluster.cache.store import CacheTier
from comfyui_distributed_tpu_torch.models.text import (TextEncoder,
                                                       TextEncoderConfig,
                                                       TextTransformer)
from comfyui_distributed_tpu_torch.utils import jsonio as tjsonio
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

PROMPT = {
    "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": "sdxl"}},
    "2": {"class_type": "CLIPTextEncode",
          "inputs": {"text": "a red fox, ünïcode", "clip": ["1", 1]}},
    "4": {"class_type": "TPUTxt2Img",
          "inputs": {"model": ["1", 0], "positive": ["2", 0],
                     "negative": ["2", 0], "seed": 12, "steps": 30,
                     "cfg": 5.0, "width": 1024, "height": 1024}},
}


# --- keys --------------------------------------------------------------------


@pytest.mark.parametrize("obj", [
    PROMPT, {"b": [1, 2.5, None, True], "a": "x"}, [], 0, "s",
    {"nested": {"z": 1, "y": [{"q": object}]}}])
def test_canonical_bytes_and_fingerprints_are_jax_digests(obj):
    assert tkeys.canonical_bytes(obj) == jkeys.canonical_bytes(obj)
    if isinstance(obj, dict):
        assert (tkeys.request_fingerprint(obj)
                == jkeys.request_fingerprint(obj))


@pytest.mark.parametrize("parts", [("ab", "c"), ("a", "bc"), (b"\x00", ""),
                                   ("exec", b"bytes", "ünï")])
def test_digest_and_checksum_are_jax_digests(parts):
    assert tkeys.digest(*parts) == jkeys.digest(*parts)
    blobs = [p.encode() if isinstance(p, str) else p for p in parts]
    assert tkeys.checksum(blobs) == jkeys.checksum(blobs)
    assert tkeys.checksum(b"".join(blobs)) == jkeys.checksum(b"".join(blobs))


def test_conditioning_and_result_keys_are_jax_digests():
    ids = np.arange(12, dtype=np.int32).reshape(2, 6)
    sig = tkeys.token_array_signature(ids)
    assert sig == jkeys.token_array_signature(ids)
    for mode in ("hash-native", "l=bpe,g=hash", "text"):
        assert (tkeys.conditioning_key("sdxl/text/seed0", sig, mode)
                == jkeys.conditioning_key("sdxl/text/seed0", sig, mode))
    fp = tkeys.request_fingerprint(PROMPT)
    for args in [(fp, "sig"), (fp, "sig", "bpe"), (fp, "sig", "bpe", "w1")]:
        assert tkeys.result_key(*args) == jkeys.result_key(*args)
    assert tkeys.result_key(fp, "a", "b") != tkeys.result_key(fp, "ab", "")


def test_execution_signature_is_the_ports_own():
    ours = tkeys.execution_signature("cpu")
    assert ours == tkeys.execution_signature(torch.device("cpu"))
    assert ours != jkeys.execution_signature()
    # TF32 is part of it: a controller on the card turns it off
    old = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = not old
        assert tkeys.execution_signature("cpu") != ours
    finally:
        torch.backends.cudnn.allow_tf32 = old


def test_jsonio_round_trips_like_jax(tmp_path):
    payload = {"entries": {"k": {"bytes": 3}}, "v": [1, 2]}
    assert tjsonio.atomic_write_json(tmp_path / "a" / "t.json", payload)
    assert jjsonio.atomic_write_json(tmp_path / "b" / "t.json", payload)
    assert ((tmp_path / "a" / "t.json").read_bytes()
            == (tmp_path / "b" / "t.json").read_bytes())
    assert tjsonio.read_json(tmp_path / "a" / "t.json") == payload
    (tmp_path / "bad.json").write_text("{not json")
    assert tjsonio.read_json(tmp_path / "bad.json") is None
    assert tjsonio.read_json(tmp_path / "missing.json") is None
    # a parent that is a file: the write fails quietly
    assert not tjsonio.atomic_write_json(tmp_path / "bad.json" / "x", {})


# --- the store ---------------------------------------------------------------


def arrays(seed: int, n: int = 256, dtype=torch.float32) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"images": torch.randn(n, generator=g).to(dtype)}


def test_lru_evicts_within_its_byte_bound():
    tier = CacheTier("result", max_bytes=3 * 1024)      # three 1 KiB entries
    for i in range(3):
        tier.put(f"k{i}", arrays(i))
    assert tier.stats()["bytes"] == 3 * 1024
    tier.get("k0")                                      # k1 is now oldest
    tier.put("k3", arrays(3))
    assert tier.keys() == ["k2", "k0", "k3"]            # k1 went
    assert tier.stats()["bytes"] <= tier.max_bytes
    tier.put("k4", arrays(4))
    assert tier.keys() == ["k0", "k3", "k4"] and tier.counts["evicted"] == 2
    assert tier.get("k1") is None and tier.counts["miss"] == 1
    # a hit is the stored tensor's bits; a caller's later write cannot
    # reach the cache
    src = arrays(9)
    tier.put("k9", src)
    src["images"].zero_()
    assert torch.equal(tier.get("k9")["images"], arrays(9)["images"])
    n = tier.entry_count
    assert n and tier.clear_memory() == n and tier.entry_count == 0
    # a zero budget keeps nothing in memory
    off = CacheTier("result", max_bytes=0)
    off.put("k", arrays(0))
    assert off.get("k") is None


def test_persisted_entries_round_trip_bitwise_across_instances(tmp_path):
    a = CacheTier("result", 1 << 20, directory=tmp_path,
                  disk_max_bytes=1 << 20)
    src = {"images": arrays(1)["images"].reshape(16, 16),
           "ids": torch.arange(5, dtype=torch.int64)}
    a.put("key1", src)
    assert a.counts["persisted"] == 1
    b = CacheTier("result", 1 << 20, directory=tmp_path)
    got = b.get("key1")
    assert b.counts["disk_hit"] == 1 and b.entry_count == 1
    for name in src:
        assert got[name].dtype == src[name].dtype
        assert torch.equal(got[name], src[name])
    # bf16 does not round-trip through numpy: memory only
    a.put("bf16", arrays(2, dtype=torch.bfloat16))
    assert not (tmp_path / "result" / "bf16.npz").exists()
    assert a.get("bf16")["images"].dtype == torch.bfloat16
    # persist=False (degraded tokenization) stays in memory too
    a.put("mem", arrays(3), persist=False)
    assert not (tmp_path / "result" / "mem.npz").exists()


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_a_corrupt_persisted_entry_is_never_served(tmp_path, damage):
    CacheTier("result", 1 << 20, directory=tmp_path).put("key", arrays(5))
    path = tmp_path / "result" / "key.npz"
    blob = bytearray(path.read_bytes())
    if damage == "flip":
        blob[len(blob) // 2] ^= 0x01
    else:
        blob = blob[:40]
    path.write_bytes(bytes(blob))
    fresh = CacheTier("result", 1 << 20, directory=tmp_path)
    assert fresh.get("key") is None
    assert fresh.counts["corrupt"] == 1 and fresh.counts["miss"] == 1
    assert not path.exists()
    index = json.loads((tmp_path / "result_index.json").read_text())
    assert "key" not in index["entries"]
    # the next reader finds nothing at all rather than the bad bytes
    assert CacheTier("result", 1 << 20, directory=tmp_path).get("key") is None


def test_an_unreadable_entry_with_a_good_checksum_is_rejected(tmp_path):
    """A sidecar whose index row matches its bytes but which is not an
    ``.npz`` (a writer's bug) is counted corrupt and deleted."""
    tier = CacheTier("result", 1 << 20, directory=tmp_path)
    tier.put("key", arrays(6))
    path = tmp_path / "result" / "key.npz"
    path.write_bytes(b"not an npz")
    tier._write_index(lambda e: e["key"].update(
        sha256=tkeys.checksum(b"not an npz")))
    fresh = CacheTier("result", 1 << 20, directory=tmp_path)
    assert fresh.get("key") is None and fresh.counts["corrupt"] == 1
    assert not path.exists()


def test_the_disk_tier_evicts_oldest_first_within_its_cap(tmp_path):
    one = len(_npz_bytes(arrays(0)))
    tier = CacheTier("result", 1 << 20, directory=tmp_path,
                     disk_max_bytes=2 * one)
    for i in range(3):
        tier.put(f"k{i}", arrays(i))
    left = json.loads((tmp_path / "result_index.json").read_text())["entries"]
    assert sorted(left) == ["k1", "k2"]
    assert not (tmp_path / "result" / "k0.npz").exists()
    assert sum(r["bytes"] for r in left.values()) <= 2 * one


def _npz_bytes(arrs: dict) -> bytes:
    import io

    buf = io.BytesIO()
    np.savez(buf, **{n: t.numpy() for n, t in arrs.items()})
    return buf.getvalue()


def test_manager_and_its_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("CDT_CACHE", "0")
    assert tcache.build_cache_manager() is None
    monkeypatch.setenv("CDT_CACHE", "1")
    monkeypatch.setenv("CDT_CACHE_DIR", "")
    assert tcache.cache_dir() is None
    mgr = tcache.build_cache_manager()
    assert mgr.dir is None and mgr.stats()["result"]["persist_dir"] is None
    monkeypatch.setenv("CDT_CACHE_DIR", str(tmp_path / "shared"))
    # never the JAX package's directory, even under one CDT_CACHE_DIR
    assert tcache.cache_dir() == tmp_path / "shared" / "torch"
    monkeypatch.delenv("CDT_CACHE_DIR")
    monkeypatch.setenv("CDT_OUTPUT_DIR", str(tmp_path / "out"))
    assert tcache.cache_dir() == tmp_path / "out" / "content_cache_torch"
    monkeypatch.setenv("CDT_CACHE_RESULT_MAX_BYTES", "4096")
    mgr = tcache.build_cache_manager()
    assert mgr.results.max_bytes == 4096 and mgr.dir.is_dir()
    for hit in (True, False, False, True):
        mgr.record_request(hit)
    assert mgr.hit_rate() == 0.5
    stats = mgr.stats()
    assert set(stats) == {"enabled", "dir", "hit_rate", "conditioning",
                          "result", "coalescer", "fleet"}
    # the controller sets the fleet tier; a bare manager has none
    assert stats["fleet"] is None
    monkeypatch.setenv("CDT_CACHE_RESULT_MAX_BYTES", "lots")
    from comfyui_distributed_tpu_torch.utils.constants import KnobError

    with pytest.raises(KnobError):
        tcache.build_cache_manager()


# --- the coalescer -----------------------------------------------------------


@dataclasses.dataclass
class Member:
    prompt_id: str
    deadline_at: float | None = None
    fingerprint: str | None = "fp"

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now >= self.deadline_at


@pytest.mark.parametrize("leader", [
    {"status": "success", "duration": 1.5, "outputs": {}},
    {"status": "error", "duration": 0.2, "error": "boom"},
    {"status": "interrupted", "duration": 0.1},
    {"status": "expired", "duration": 0.0, "error": "late"}])
def test_waiters_settle_as_jax_settles_them(leader):
    """The same flights in both coalescers: the same history rows, the
    same redispatches; a waiter whose own deadline passed is expired."""
    outcomes = []
    for mod in (jcoalesce, tcoalesce):
        clock = types.SimpleNamespace(t=10.0)
        co = mod.InflightCoalescer(clock=lambda: clock.t)
        co.lead("fp", "lead")
        assert not co.join("other", Member("x"))
        assert co.join("fp", Member("w1"), group_key="g", sampler_node_id="4")
        assert co.join("fp", Member("w2", deadline_at=5.0))
        history = {}
        assert co.resolve(history) == 0                # leader still running
        assert co.pending_waiters == 2
        history["lead"] = dict(leader)
        redispatched = []
        settled = co.resolve(history, redispatch=lambda *a: redispatched.append(
            (a[0].prompt_id, a[1], a[2])))
        outcomes.append((settled, history, redispatched, co.stats()))
    assert outcomes[0] == outcomes[1]
    settled, history, redispatched, stats = outcomes[1]
    assert history["w2"]["status"] == "expired"
    if leader["status"] == "expired":
        assert redispatched == [("w1", "g", "4")] and "w1" not in history
    else:
        assert history["w1"] == {**leader, "coalesced_with": "lead"}
    assert stats["inflight"] == 0 and stats["coalesced_waiters"] == 2


def test_a_waiter_of_an_expired_leader_without_a_hook_errors():
    co = tcoalesce.InflightCoalescer()
    co.lead("fp", "lead")
    co.join("fp", Member("w"))
    history = {"lead": {"status": "expired"}}
    assert co.resolve(history) == 1
    assert history["w"]["status"] == "error"


# --- the conditioning tier ---------------------------------------------------


def tiny_encoder(seed: int = 0, ident: str | None = "tiny/text/seed0"):
    torch.manual_seed(seed)
    cfg = TextEncoderConfig.tiny(dtype="float32")
    enc = TextEncoder(TextTransformer(cfg).eval())
    if ident is not None:
        enc._cdt_encoder_id = ident
    return enc


def test_token_signature_and_key_match_the_jax_encoder():
    from comfyui_distributed_tpu.models import text as jtext

    texts = ["a red fox", "", "blurry, low quality"]
    enc = tiny_encoder()
    jenc = jtext.TextEncoder(jtext.TextEncoderConfig.tiny())
    sig, mode = tcond.token_signature(enc, texts)
    assert (sig, mode) == jenc.token_signature(texts)
    assert mode == "hash-native" and not tcond.degraded(mode)
    assert tcond.encoder_mode(enc) == "hash-native"
    assert (tkeys.conditioning_key("id", sig, mode)
            == jkeys.conditioning_key("id", sig, mode))
    # the JAX helpers agree on modes and degradation
    from comfyui_distributed_tpu.cluster.cache import conditioning as jcond

    for m in ("l=bpe,g=hash", "hash", "bpe", "hash-native", "t5=hash/l=bpe"):
        assert tcond.degraded(m) == jcond.degraded(m)
    plain = types.SimpleNamespace(encode=None)
    assert tcond.token_signature(plain, ["x"]) == jcond.token_signature(
        plain, ["x"])
    assert tcond.encoder_mode(plain) == jcond.encoder_mode(plain)


def test_cached_encode_hits_are_a_fresh_encodes_bits(tmp_path):
    mgr = tcache.CacheManager(directory=tmp_path)
    enc = tiny_encoder()
    calls = []
    real = enc.encode
    enc.encode = lambda texts: calls.append(list(texts)) or real(texts)
    fresh = real(["a red fox"])
    first = tcond.cached_encode(mgr, enc, ["a red fox"])
    again = tcond.cached_encode(mgr, enc, ["a red fox"])
    assert calls == [["a red fox"]]
    for a, b, c in zip(fresh, first, again):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert c.device == enc.device and c.dtype == a.dtype
    # a hit is a copy: writing to it leaves the tier's entry alone
    again[0].zero_()
    assert torch.equal(tcond.cached_encode(mgr, enc, ["a red fox"])[0],
                       fresh[0])
    assert mgr.conditioning.counts["hit"] == 2
    # persisted: a new manager over the same directory serves it
    other = tcache.CacheManager(directory=tmp_path)
    enc2 = tiny_encoder()
    enc2.encode = lambda texts: pytest.fail("encoded despite a disk entry")
    assert torch.equal(tcond.cached_encode(other, enc2, ["a red fox"])[1],
                       fresh[1])
    # another identity is another entry; without a manager or a stamp
    # nothing is cached
    puts = mgr.conditioning.counts["put"]
    tcond.cached_encode(mgr, tiny_encoder(ident="tiny/text/seed1"), ["a red fox"])
    assert mgr.conditioning.counts["put"] == puts + 1
    for manager, e in ((None, tiny_encoder()), (mgr, tiny_encoder(ident=None))):
        out = tcond.cached_encode(manager, e, ["a red fox"])
        assert torch.equal(out[0], fresh[0])
    assert mgr.conditioning.counts["put"] == puts + 1


def test_degraded_conditioning_stays_in_memory(tmp_path):
    mgr = tcache.CacheManager(directory=tmp_path)
    enc = tiny_encoder()
    enc.token_signature = lambda texts: ([[1, 2]], "l=bpe,g=hash")
    tcond.cached_encode(mgr, enc, ["x"])
    assert mgr.conditioning.entry_count == 1
    assert mgr.conditioning.counts["persisted"] == 0
    assert not list((tmp_path).glob("conditioning/*.npz"))


def published_stack(kind: str):
    """A test-size published text stack of ``kind``, stamped as the
    registry stamps it."""
    from comfyui_distributed_tpu_torch.models.clip import (CLIPConditioner,
                                                           CLIPTextTransformer,
                                                           SDXLTextStack)
    from comfyui_distributed_tpu_torch.models.t5 import (FluxTextStack,
                                                         SD3TextStack,
                                                         T5Encoder,
                                                         UMT5Conditioner)

    torch.manual_seed(0)
    if kind == "sdxl":
        cfg_l, cfg_g = SDXLTextStack.configs(tiny=True)
        enc = CLIPConditioner(SDXLTextStack(CLIPTextTransformer(cfg_l),
                                            CLIPTextTransformer(cfg_g)).eval())
    elif kind == "flux":
        cfg_t5, cfg_l = FluxTextStack.configs(tiny=True)
        enc = FluxTextStack(T5Encoder(cfg_t5), CLIPTextTransformer(cfg_l)).eval()
    elif kind == "sd3":
        cfg_l, cfg_g, cfg_t5 = SD3TextStack.configs(tiny=True)
        enc = SD3TextStack(CLIPTextTransformer(cfg_l), CLIPTextTransformer(cfg_g),
                           T5Encoder(cfg_t5)).eval()
    else:
        enc = UMT5Conditioner(T5Encoder(UMT5Conditioner.config(tiny=True))).eval()
    enc._cdt_encoder_id = f"{kind}-tiny/{kind}/seed0"
    return enc


@pytest.mark.parametrize("kind", ["sdxl", "flux", "sd3", "umt5"])
def test_published_stacks_hit_their_own_bits(tmp_path, kind):
    """The conditioning tier on each published text stack (not only the
    hash encoder): a hit is the fresh encode's bits, dtype and device,
    keyed on the stack's own token signature; a degraded tokenization
    stays in memory."""
    mgr = tcache.CacheManager(directory=tmp_path)
    enc = published_stack(kind)
    texts = ["blurry, low quality"]
    with torch.no_grad():
        fresh = enc.encode(texts)
    assert tcond.encoder_device(enc) == torch.device("cpu")
    first = tcond.cached_encode(mgr, enc, texts)
    enc.encode = lambda texts: pytest.fail("encoded despite a hit")
    again = tcond.cached_encode(mgr, enc, texts)
    for a, b, c in zip(fresh, first, again):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert c.dtype == a.dtype and c.device == a.device
    assert mgr.conditioning.counts["hit"] == 1
    _, mode = tcond.token_signature(enc, texts)
    assert mgr.conditioning.counts["persisted"] == (
        0 if tcond.degraded(mode) else 1)
