"""The port's control plane against the JAX package's, on the CPU: the
same inputs through both (the JAX package as it runs with
``CDT_FRONTDOOR=0``, ``CDT_CACHE=0``, ``CDT_PREEMPT=0``, ``CDT_STAGES=0``
and telemetry off). Prompt transforms, worker payloads and CDTF bytes
must be exactly equal."""

import asyncio
import dataclasses
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

# The JAX half needs what the card's machine is not promised.
for _module in ("flax", "aiohttp", "PIL"):
    pytest.importorskip(_module)

from comfyui_distributed_tpu import native as jnative  # noqa: E402
from comfyui_distributed_tpu.api import queue_request as jqueue  # noqa: E402
from comfyui_distributed_tpu.cluster import dispatch as jdispatch  # noqa: E402
from comfyui_distributed_tpu.cluster import orchestration as jorch  # noqa: E402
from comfyui_distributed_tpu.cluster.collector_bridge import \
    CollectorBridge as JBridge  # noqa: E402
from comfyui_distributed_tpu.cluster.job_store import JobStore as JStore  # noqa: E402
from comfyui_distributed_tpu.graph import transform as jtransform  # noqa: E402
from comfyui_distributed_tpu.utils import exceptions as jexc  # noqa: E402
from comfyui_distributed_tpu.utils import image as jimage  # noqa: E402
from comfyui_distributed_tpu_torch.api import queue_request as tqueue  # noqa: E402
from comfyui_distributed_tpu_torch.cluster import dispatch as tdispatch  # noqa: E402
from comfyui_distributed_tpu_torch.cluster import orchestration as torch_orch  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.collector_bridge import \
    CollectorBridge as TBridge  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.job_store import JobStore as TStore  # noqa: E402
from comfyui_distributed_tpu_torch.graph import transform as ttransform  # noqa: E402
from comfyui_distributed_tpu_torch.graph.executor import strip_meta  # noqa: E402
from comfyui_distributed_tpu_torch.utils import exceptions as texc  # noqa: E402
from comfyui_distributed_tpu_torch.utils import frames as tframes  # noqa: E402
from comfyui_distributed_tpu_torch.utils import image as timage  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKFLOWS = sorted((ROOT / "workflows").glob("*.json"))
TRACE = "exec_1700000000000_abc123"
MASTER_URL = "http://127.0.0.1:8288"


@pytest.fixture(autouse=True)
def _fresh_resilience():
    """The port's breakers and fault plan are process-global: a worker id
    another test failed must not start quarantined here."""
    from comfyui_distributed_tpu_torch.cluster import faults, resilience

    resilience.BREAKERS.reset()
    faults.deactivate()
    yield
    resilience.BREAKERS.reset()
    faults.deactivate()


@pytest.fixture(autouse=True)
def jax_settings(monkeypatch):
    for knob in ("CDT_FRONTDOOR", "CDT_CACHE", "CDT_PREEMPT", "CDT_STAGES"):
        monkeypatch.setenv(knob, "0")
    monkeypatch.setenv("CDT_TELEMETRY", "")


# --- graph/transform.py --------------------------------------------------------


def transforms(mod, prompt: dict) -> dict:
    """Every transform of one package on one prompt, with the overrides of
    a master, workers at index 0 and 2 and a delegate-only master."""
    job_ids = mod.generate_job_id_map(prompt, TRACE)
    workers = ("w0", "w2")
    pruned = mod.prune_prompt_for_worker(prompt)
    delegate = mod.prepare_delegate_master_prompt(prompt)
    return {
        "job_ids": job_ids,
        "pruned": pruned,
        "delegate": delegate,
        "master": mod.apply_participant_overrides(
            prompt, "master", job_ids, enabled_worker_ids=workers),
        "worker0": mod.apply_participant_overrides(
            pruned, "w0", job_ids, master_url=MASTER_URL,
            enabled_worker_ids=workers, worker_index=0),
        "worker2": mod.apply_participant_overrides(
            pruned, "w2", job_ids, master_url=MASTER_URL,
            enabled_worker_ids=workers, worker_index=2),
        "delegate_master": mod.apply_participant_overrides(
            delegate, "master", job_ids, enabled_worker_ids=workers,
            delegate_only=True),
    }


@pytest.mark.parametrize("workflow", WORKFLOWS, ids=lambda p: p.stem)
def test_transforms_match_on_shipped_workflows(workflow):
    prompt = strip_meta(json.loads(workflow.read_text()))
    ours = transforms(ttransform, prompt)
    assert ours == transforms(jtransform, prompt)
    assert prompt == strip_meta(json.loads(workflow.read_text()))  # untouched


def test_class_sets_match():
    for name in ("COLLECTOR_CLASSES", "USDU_CLASSES", "DISTRIBUTED_CLASSES",
                 "PARTICIPANT_CLASSES", "SAFE_SCALAR_CLASSES", "PREVIEW_CLASS",
                 "EMPTY_IMAGE_CLASS"):
        assert getattr(ttransform, name) == getattr(jtransform, name), name


CLASSES = sorted(jtransform.DISTRIBUTED_CLASSES | jtransform.PARTICIPANT_CLASSES
                 | jtransform.SAFE_SCALAR_CLASSES
                 | {"CheckpointLoader", "TPUTxt2Img", "SaveImage", "VAEDecode"})


@st.composite
def dags(draw):
    """Prompts over the transform's class sets: links mostly point at
    earlier nodes, sometimes at later ones (cycles) or at missing ids."""
    n = draw(st.integers(1, 10))
    prompt = {}
    for i in range(n):
        inputs = {}
        for j in range(draw(st.integers(0, 3))):
            kind = draw(st.sampled_from(["early", "early", "any", "missing",
                                         "int", "str"]))
            if kind == "early" and i:
                inputs[f"in{j}"] = [str(draw(st.integers(0, i - 1))),
                                    draw(st.integers(0, 1))]
            elif kind == "any":
                inputs[f"in{j}"] = [str(draw(st.integers(0, n - 1))), 0]
            elif kind == "missing":
                inputs[f"in{j}"] = ["99", 0]
            elif kind == "str":
                inputs[f"in{j}"] = draw(st.sampled_from(["a.png", "text", ""]))
            else:
                inputs[f"in{j}"] = draw(st.integers(-3, 3))
        prompt[str(i)] = {"class_type": draw(st.sampled_from(CLASSES)),
                          "inputs": inputs}
    return prompt


@settings(max_examples=80, deadline=None)
@given(dags())
def test_transforms_match_on_generated_dags(prompt):
    assert transforms(ttransform, prompt) == transforms(jtransform, prompt)


# --- api/queue_request.py ------------------------------------------------------

VALID_PAYLOADS = [
    {"prompt": {"1": {}}},
    {"prompt": {"1": {}}, "client_id": "c", "workers": ["a", "b"],
     "delegate_master": True, "load_balance": 1, "trace_id": "t"},
    {"prompt": {"1": {}}, "enabled_worker_ids": ["x"], "workers": ["ignored"],
     "delegate_master": False, "trace_id": ""},
    {"prompt": {"1": {}}, "tenant": "team", "priority": "batch",
     "deadline_ms": 5, "cache": "bypass"},
    {"prompt": {"1": {}}, "cache": "near", "enabled_worker_ids": []},
    {"prompt": {"1": {}}, "checkpoint_id": "ck_0008_ab12",
     "checkpoint": {"data": "", "sha256": "x", "checkpoint_id": "c"}},
]
INVALID_PAYLOADS = [
    [], "prompt", {}, {"prompt": {}}, {"prompt": []},
    {"prompt": {"1": {}}, "workers": "w0"},
    {"prompt": {"1": {}}, "enabled_worker_ids": [1]},
    {"prompt": {"1": {}}, "delegate_master": "yes"},
    {"prompt": {"1": {}}, "client_id": 3},
    {"prompt": {"1": {}}, "tenant": ""},
    {"prompt": {"1": {}}, "tenant": "x" * 65},
    {"prompt": {"1": {}}, "priority": "urgent"},
    {"prompt": {"1": {}}, "deadline_ms": 0},
    {"prompt": {"1": {}}, "deadline_ms": True},
    {"prompt": {"1": {}}, "deadline_ms": 1.5},
    {"prompt": {"1": {}}, "cache": "sometimes"},
    {"prompt": {"1": {}}, "checkpoint_id": "../up"},
    {"prompt": {"1": {}}, "checkpoint_id": ""},
    {"prompt": {"1": {}}, "checkpoint_id": 7},
    {"prompt": {"1": {}}, "checkpoint": {"data": 1, "sha256": "x"}},
    {"prompt": {"1": {}}, "checkpoint": {"data": "", "sha256": ""}},
    {"prompt": {"1": {}}, "checkpoint": "inline"},
]


@pytest.mark.parametrize("payload", VALID_PAYLOADS)
def test_queue_payload_fields_match(payload):
    ours = tqueue.parse_queue_request_payload(payload)
    ref = jqueue.parse_queue_request_payload(payload)
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(ref, field.name), field.name
    # every field of the JAX payload, the resume fields included
    assert {f.name for f in dataclasses.fields(ours)} == \
        {f.name for f in dataclasses.fields(ref)}


@pytest.mark.parametrize("payload", INVALID_PAYLOADS, ids=range(len(INVALID_PAYLOADS)))
def test_queue_payload_rejections_match(payload):
    with pytest.raises(jexc.ValidationError) as ref:
        jqueue.parse_queue_request_payload(payload)
    with pytest.raises(texc.ValidationError) as ours:
        tqueue.parse_queue_request_payload(payload)
    assert ours.value.field == ref.value.field


@pytest.mark.parametrize("field,value", [
    ("checkpoint_id", "ckpt-1"), ("checkpoint", {"data": "", "sha256": "x"})])
def test_queue_payload_rejects_resume_naming_preemption(field, value):
    """The resume fields parse as the JAX package parses them; a resume
    against a controller without preemption is refused, naming it, as
    JAX's ``resolve_resume`` refuses it."""
    from comfyui_distributed_tpu.cluster.preemption import \
        resolve_resume as jresolve
    from comfyui_distributed_tpu_torch.cluster.preemption import \
        resolve_resume as tresolve

    payload = {"prompt": {"1": {}}, field: value}
    ref = jqueue.parse_queue_request_payload(payload)
    ours = tqueue.parse_queue_request_payload(payload)
    assert getattr(ours, field) == getattr(ref, field) == value
    args = (ours.checkpoint_id, ours.checkpoint)
    with pytest.raises(jexc.ValidationError, match="preemption disabled"):
        jresolve(None, *args)
    with pytest.raises(texc.ValidationError,
                       match="preemption disabled") as err:
        tresolve(None, *args)
    assert err.value.field == "checkpoint_id"


# --- CDTF frames ---------------------------------------------------------------


def frame_arrays():
    rng = np.random.default_rng(0)
    return [
        rng.integers(0, 256, (3, 17, 5, 3), dtype=np.uint8),
        np.zeros((64, 64, 3), np.uint8),                 # compresses
        rng.standard_normal((4, 9)).astype(np.float32),
        rng.standard_normal(7).astype(np.float16),
        rng.integers(-9, 9, (2, 3), dtype=np.int32),
        rng.integers(0, 60000, 5, dtype=np.uint16),
        rng.integers(-9, 9, (1, 1, 2), dtype=np.int64),
        rng.standard_normal(3),
        rng.integers(0, 2, 6).astype(bool),
        np.array(3.5, np.float32),                       # 0-d
        np.zeros((0, 4), np.uint8),                      # empty
        rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)[:, ::2],  # strided
    ]


@pytest.mark.parametrize("level", [0, 1])
def test_frames_byte_identical_and_cross_readable(level, monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)   # pure-Python codec
    for arr in frame_arrays():
        ours = tframes.pack_frame(arr, level=level)
        ref = jnative.pack_frame(arr, level=level)
        assert ours == ref, arr.dtype
        # both codecs frame a 0-d array as one element (ascontiguousarray)
        expected = np.ascontiguousarray(arr)
        for blob in (ours, ref):
            back = tframes.unpack_frame(blob)
            np.testing.assert_array_equal(back, expected)
            assert back.dtype == arr.dtype and back.shape == expected.shape
            np.testing.assert_array_equal(jnative.unpack_frame(blob), expected)


def test_frames_hostile_headers_rejected_by_both(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)
    good = tframes.pack_frame(np.arange(12, dtype=np.uint8).reshape(3, 4), level=0)
    ndim_end = 8 + 2 * 8
    bad = {
        "magic": b"XDTF" + good[4:],
        "version": good[:4] + b"\x02" + good[5:],
        "dtype": good[:5] + b"\x63" + good[6:],
        "ndim": good[:6] + b"\x09" + good[7:],
        "truncated": good[:-1],
        "crc": good[:-1] + bytes([good[-1] ^ 1]),
        # a shape claiming 2^40 rows: raw size disagrees with the header
        "shape": good[:8] + (1 << 40).to_bytes(8, "little") + good[16:],
        # a raw length claiming more than the shape holds
        "raw_len": good[:ndim_end + 12] + (99).to_bytes(8, "little")
        + good[ndim_end + 20:],
    }
    for name, blob in bad.items():
        with pytest.raises(ValueError):
            jnative.unpack_frame(blob)
        with pytest.raises(ValueError):
            tframes.unpack_frame(blob)
    # a frame over the decoded-size cap is refused before inflating
    monkeypatch.setenv("CDT_MAX_FRAME_RAW_BYTES", "11")
    with pytest.raises(ValueError, match="exceeds cap"):
        tframes.unpack_frame(good)


def test_frames_refuse_unsupported_dtype():
    with pytest.raises(ValueError, match="unsupported frame dtype"):
        tframes.pack_frame(np.zeros(3, np.complex64))


# --- utils/image.py ------------------------------------------------------------


def filtered_png(arr: np.ndarray, filters) -> bytes:
    """An 8-bit PNG whose rows use the given filter types in turn (a
    straightforward encoder, independent of the port's decoder)."""
    h, w, c = arr.shape
    rows, prior = [], np.zeros(w * c, np.int64)
    for y in range(h):
        cur = arr[y].reshape(-1).astype(np.int64)
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    color = {3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 6))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_png_on_every_filter(channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (10, 13, channels), dtype=np.uint8)
    blob = filtered_png(arr, [0, 1, 2, 3, 4])
    ours = timage.decode_png(blob)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jimage.decode_png(blob))
    np.testing.assert_array_equal(timage.to_uint8(ours)[0], arr)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("level", [0, 6, 9])
def test_decode_png_of_both_encoders(channels, level):
    rng = np.random.default_rng(level)
    img = rng.random((21, 17, channels), dtype=np.float32)
    ref_png = jimage.encode_png(img, compress_level=level)     # PIL
    ours_png = timage.encode_png(img, compress_level=level)
    np.testing.assert_array_equal(timage.decode_png(ref_png),
                                  jimage.decode_png(ref_png))
    np.testing.assert_array_equal(timage.decode_png(ours_png),
                                  jimage.decode_png(ours_png))
    np.testing.assert_array_equal(timage.to_uint8(timage.decode_png(ours_png)),
                                  jimage.to_uint8(img))
    b64 = jimage.encode_image_b64(img)
    np.testing.assert_array_equal(timage.decode_image_b64(b64),
                                  jimage.decode_image_b64(b64))
    np.testing.assert_array_equal(
        jimage.decode_image_b64(timage.encode_image_b64(img)),
        timage.decode_png(ours_png))


def test_decode_png_refuses_what_it_does_not_read():
    # grayscale is read now, as Pillow reads it: replicated to RGB
    gray = timage.encode_png(np.full((4, 4, 1), 0.5, np.float32))
    np.testing.assert_array_equal(timage.decode_png(gray),
                                  np.full((4, 4, 3), 128 / 255, np.float32))
    # a bit depth the color type does not allow (RGB at 4 bits) is not
    header = struct.pack(">IIBBBBB", 4, 4, 4, 2, 0, 0, 0)
    bad = (gray[:12] + b"IHDR" + header
           + struct.pack(">I", zlib.crc32(b"IHDR" + header) & 0xFFFFFFFF)
           + gray[33:])
    with pytest.raises(texc.ValidationError, match="not supported"):
        timage.decode_png(bad)
    good = timage.encode_png(np.zeros((4, 4, 3), np.float32))
    for blob in (b"nope", good[:-5], good[:20] + b"\1" + good[21:]):
        with pytest.raises(texc.ValidationError):
            timage.decode_png(blob)
    with pytest.raises(texc.ValidationError, match="base64"):
        timage.decode_image_b64("abc")


def test_from_uint8_matches():
    arr = np.arange(256, dtype=np.uint8).reshape(4, 4, 16)
    np.testing.assert_array_equal(timage.from_uint8(arr), jimage.from_uint8(arr))


# --- collector _combine_images -------------------------------------------------


def combine_cases():
    rng = np.random.default_rng(3)

    def img(h=8, w=8):
        return rng.random((h, w, 3), dtype=np.float32)

    local = rng.random((2, 8, 8, 3), dtype=np.float32)
    per_worker = {"w1": {1: img(), 0: img()}, "w0": {0: img()},
                  "w2": {0: img(4, 8)}, "w3": {}}
    return [
        (local, per_worker, ("w0", "w1", "w2", "w3"), False),
        (local, per_worker, ("w1", "w0"), True),
        (np.zeros((0, 8, 8, 3), np.float32), per_worker, ("w2", "w1"), False),
        (img(4, 8)[None], per_worker, ("w0", "w1", "w2"), False),
        (local, {}, (), False),
        (None, per_worker, ("w0",), False),
    ]


@pytest.mark.parametrize("case", range(6))
def test_combine_images_order_and_size_rule(case):
    local, per_worker, expected, delegate = combine_cases()[case]
    ref = JBridge._combine_images(local, per_worker, expected, delegate)
    ours = TBridge._combine_images(local, per_worker, expected, delegate)
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_combine_images_stays_on_the_masters_device():
    local = torch.rand(1, 8, 8, 3, dtype=torch.float32)
    out = TBridge._combine_images(local, {"w0": {0: np.ones((8, 8, 3), np.float32)}},
                                  ("w0",), False)
    assert out.device == local.device and out.shape == (2, 8, 8, 3)
    torch.testing.assert_close(out[0], local[0], rtol=0, atol=0)


# --- cluster/orchestration.py --------------------------------------------------


class SpyQueue:
    def __init__(self):
        self.enqueued = []

    def enqueue(self, prompt, client_id="", trace_id=None, **_):
        self.enqueued.append(prompt)
        return "p_spy", []


CONFIG = {
    "master": {"host": "", "port": 8288},
    "hosts": [
        {"id": "w0", "address": "http://127.0.0.1:9", "type": "local",
         "enabled": True},
        {"id": "w1", "address": "http://127.0.0.1:10", "type": "local",
         "enabled": False},
        {"id": "w2", "address": "http://127.0.0.1:11", "type": "local",
         "enabled": True},
    ],
    "settings": {},
}
ONLINE = {"w0", "w1"}


def orchestrate(pkg, monkeypatch, prompt, **kwargs):
    """One package's orchestration with stubbed probes (``ONLINE``
    answer) and a captured dispatch → (result, master prompt, sent)."""
    dispatch_mod, orch_mod, store = pkg
    sent = {}

    async def fake_probe(host, timeout=None):
        return {"queue_remaining": 0} if host["id"] in ONLINE else None

    async def fake_dispatch(host, wprompt, client_id="", extra=None,
                            trace_id=None, via_ws=False):
        sent[host["id"]] = (wprompt, client_id, extra)
        return {"prompt_id": "remote"}

    monkeypatch.setattr(dispatch_mod, "probe_host", fake_probe)
    monkeypatch.setattr(orch_mod, "dispatch_prompt", fake_dispatch)
    queue = SpyQueue()
    orch = orch_mod.Orchestrator(store(), queue, config_loader=lambda: CONFIG)
    result = asyncio.run(orch.orchestrate(prompt, trace_id=TRACE, **kwargs))
    return result, queue.enqueued[0], sent


@pytest.mark.parametrize("kwargs", [
    {}, {"delegate_master": True}, {"enabled_ids": ["w2", "w1", "w0"]},
    {"load_balance": True}, {"client_id": "c7"}], ids=str)
def test_orchestration_matches(kwargs, monkeypatch):
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "distributed-txt2img.json").read_text()))
    if kwargs.get("load_balance"):
        # one idle host: the round-robin cursors of the two packages
        # then agree whatever their state
        monkeypatch.setattr(jdispatch, "_rr_counter", iter([0]))
        monkeypatch.setattr(tdispatch, "_rr_counter", iter([0]))
    ref = orchestrate((jdispatch, jorch, JStore), monkeypatch, prompt, **kwargs)
    ours = orchestrate((tdispatch, torch_orch, TStore), monkeypatch, prompt, **kwargs)
    assert ours[1] == ref[1]                       # master prompt
    assert ours[2] == ref[2]                       # every worker payload
    assert ours[0].worker_count == ref[0].worker_count
    assert ours[0].dispatched_to == ref[0].dispatched_to
    assert ours[0].trace_id == ref[0].trace_id == TRACE
    for wid, (wprompt, _, _) in ours[2].items():
        # worker_index is the position in the full config host list
        index = [h["id"] for h in CONFIG["hosts"]].index(wid)
        assert wprompt["4"]["inputs"]["worker_index"] == index


def test_failed_dispatch_drops_the_worker_everywhere(monkeypatch):
    """A worker whose dispatch failed leaves the collector's expected set
    and the master prompt's enabled list (the JAX package's master
    prompt keeps it, so its collector waits for it until the timeout)."""
    from comfyui_distributed_tpu_torch.utils.exceptions import WorkerError

    async def probe(host, timeout=None):
        return {"queue_remaining": 0}

    async def dispatch(host, wprompt, client_id="", extra=None, trace_id=None,
                       via_ws=False):
        if host["id"] == "w2":
            raise WorkerError("refused", worker_id="w2")
        return {}

    monkeypatch.setattr(tdispatch, "probe_host", probe)
    monkeypatch.setattr(torch_orch, "dispatch_prompt", dispatch)
    prompt = {"1": {"class_type": "DistributedEmptyImage",
                    "inputs": {"height": 8, "width": 8}},
              "2": {"class_type": "DistributedCollector",
                    "inputs": {"images": ["1", 0]}}}
    store, queue = TStore(), SpyQueue()
    orch = torch_orch.Orchestrator(store, queue, config_loader=lambda: CONFIG)
    result = asyncio.run(orch.orchestrate(prompt, trace_id=TRACE))
    assert result.dispatched_to == ["w0"] and result.worker_count == 1
    jid = f"{TRACE}_2"
    assert store.collector_jobs[jid].expected_workers == ("w0",)
    assert queue.enqueued[0]["2"]["inputs"]["enabled_worker_ids"] == ["w0"]


def test_remote_host_with_media_is_a_failed_dispatch(monkeypatch):
    """The JAX package's semantics: a remote host's media are synced
    before its dispatch; a failed upload fails that host's dispatch (the
    collector no longer waits on it), a file missing here still
    dispatches, with the prompt the sync returned."""
    from comfyui_distributed_tpu_torch.cluster.media_sync import SyncReport

    async def probe(host, timeout=None):
        return {"queue_remaining": 0}

    sent = []

    async def dispatch(host, wprompt, client_id="", extra=None, trace_id=None,
                       via_ws=False):
        sent.append((host["id"], wprompt["1"]["inputs"]["image"]))
        return {}

    synced = []

    def syncing(report):
        async def sync(host, wprompt, input_dir=None, concurrency=None,
                       timeout=None, trace_id=""):
            synced.append((host["id"], concurrency, timeout))
            out = json.loads(json.dumps(wprompt))
            out["1"]["inputs"]["image"] = "converted.png"
            return out, report
        return sync

    monkeypatch.setattr(tdispatch, "probe_host", probe)
    monkeypatch.setattr(torch_orch, "dispatch_prompt", dispatch)
    config = {"master": {"port": 8288},
              "hosts": [{"id": "r0", "address": "http://127.0.0.1:9",
                         "type": "remote", "enabled": True},
                        {"id": "l0", "address": "http://127.0.0.1:10",
                         "type": "local", "enabled": True}],
              "settings": {"media_sync_concurrency": 2}}
    prompt = {"1": {"class_type": "LoadImage", "inputs": {"image": "cat.png"}},
              "2": {"class_type": "DistributedCollector",
                    "inputs": {"images": ["1", 0]}}}
    for report, dispatched in ((SyncReport(checked=1, failed=["cat.png"]),
                                [("l0", "cat.png")]),
                               (SyncReport(checked=1, missing=1),
                                [("r0", "converted.png"), ("l0", "cat.png")])):
        sent.clear()
        synced.clear()
        monkeypatch.setattr(torch_orch, "sync_host_media", syncing(report))
        queue, store = SpyQueue(), TStore()
        orch = torch_orch.Orchestrator(store, queue, config_loader=lambda: config)
        result = asyncio.run(orch.orchestrate(prompt, trace_id=TRACE))
        assert sorted(sent) == sorted(dispatched)
        assert synced == [("r0", 2, 120)]            # local hosts share files
        assert result.worker_count == len(dispatched)
        assert sorted(queue.enqueued[0]["2"]["inputs"]["enabled_worker_ids"]) == \
            sorted(h for h, _ in dispatched)


def test_dispatch_retries_only_a_refused_connection(monkeypatch):
    import urllib.error

    from comfyui_distributed_tpu_torch.utils.exceptions import WorkerError

    monkeypatch.setenv("CDT_SEND_BACKOFF_BASE", "0.001")
    calls = []

    def failing(error):
        async def request(url, data=None, headers=None, timeout=None):
            calls.append(url)
            raise error
        return request

    host = {"id": "w0", "address": "http://127.0.0.1:9"}
    for error, attempts in (
            (urllib.error.URLError(ConnectionRefusedError()), 3),
            (urllib.error.URLError(TimeoutError("timed out")), 1),
            (ConnectionResetError(), 1)):
        calls.clear()
        monkeypatch.setattr(tdispatch, "http_request_async", failing(error))
        with pytest.raises(WorkerError, match="unreachable"):
            asyncio.run(tdispatch.dispatch_prompt(host, {"1": {}}))
        assert len(calls) == attempts, error


# --- utils/config.py and the job store -----------------------------------------


def test_config_load_save_match(tmp_path):
    from comfyui_distributed_tpu.utils import config as jconfig
    from comfyui_distributed_tpu_torch.utils import config as tconfig

    path = tmp_path / "cfg.json"
    assert tconfig.load_config(path) == jconfig.load_config(path)  # defaults
    path.write_text(json.dumps({
        "master": {"port": 9000, "extra": 1},
        "hosts": [{"id": "w0", "address": "127.0.0.1:9001"}, {"enabled": True}],
        "settings": {"master_delegate_only": True}, "custom": [1, 2]}))
    ours = tconfig.load_config(path)
    assert ours == jconfig.load_config(path)
    assert tconfig.is_master_delegate_only(path) is True
    ours["settings"]["debug"] = True
    tconfig.save_config(ours, path)
    assert tconfig.load_config(path) == jconfig.load_config(path) == ours
    assert tconfig.peek_setting("debug", path=path) is True
    fresh = tmp_path / "new" / "cfg.json"
    assert tconfig.ensure_config_exists(fresh) == fresh
    assert json.loads(fresh.read_text()) == jconfig.DEFAULT_CONFIG
    tconfig.update_config(
        lambda c: c["hosts"].append({"id": "w9", "enabled": True}), fresh)
    assert tconfig.enabled_hosts(tconfig.load_config(fresh)) == \
        jconfig.enabled_hosts(jconfig.load_config(fresh))
    assert tconfig.get_setting("worker_prep_concurrency", path=fresh) == 4
    assert tconfig.get_worker_timeout_seconds(fresh) == 60.0

    async def transaction():
        async with tconfig.config_transaction(fresh) as c:
            c["settings"]["debug"] = True
    asyncio.run(transaction())
    tconfig.invalidate_cache()
    assert jconfig.load_config(fresh)["settings"]["debug"] is True


def test_job_store_collector_half():
    from comfyui_distributed_tpu_torch.utils.exceptions import JobQueueError

    async def body():
        store = TStore()
        # a result may arrive before its job exists, within the grace
        put = asyncio.ensure_future(store.put_collector_result(
            "j1", {"worker_id": "w0", "is_last": True}, grace=5.0))
        await asyncio.sleep(0.05)
        job = await store.prepare_collector_job("j1", ("w0", "w1"))
        await put
        assert job.completed_workers == {"w0": True}
        assert (await store.prepare_collector_job("j1")).expected_workers == ("w0", "w1")
        await store.set_expected_workers("j1", ())
        assert (await store.get_collector_job("j1")).expected_workers == ()
        with pytest.raises(JobQueueError, match="never initialized"):
            await store.put_collector_result("nope", {}, grace=0.0)
        job.created_at -= 7200
        await store.prepare_collector_job("j2")
        assert await store.prune_stale(3600.0) == ["j1"]
        await store.cleanup_job("j2")
        assert store.collector_jobs == {}

    asyncio.run(body())


# --- interrupt ---------------------------------------------------------------------


def _held_graph(monkeypatch):
    """A two-node prompt whose first node blocks until released; returns
    (prompt, started, release, ran)."""
    import threading

    from comfyui_distributed_tpu_torch.graph import nodes_builtin

    started, release, ran = threading.Event(), threading.Event(), []

    def held(self, height=64, width=64, channels=3, **_):
        ran.append("empty")
        started.set()
        release.wait(60)
        return (torch.zeros((0, int(height), int(width), int(channels))),)

    def preview(self, images, **_):
        ran.append("preview")
        return ()

    monkeypatch.setattr(nodes_builtin.DistributedEmptyImage, "execute", held)
    monkeypatch.setattr(nodes_builtin.PreviewImage, "execute", preview)
    prompt = {"1": {"class_type": "DistributedEmptyImage",
                    "inputs": {"height": 8, "width": 8}},
              "2": {"class_type": "PreviewImage", "inputs": {"images": ["1", 0]}}}
    return prompt, started, release, ran


def test_interrupt_drops_pending_and_stops_the_running_prompt(tmp_path,
                                                               monkeypatch):
    """``POST /distributed/interrupt``: the pending prompts go to history as
    interrupted, the running one stops before its next node, and the
    answer counts the dropped jobs (the JAX ``PromptQueue.interrupt``)."""
    import time
    import urllib.request

    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster.controller import Controller

    prompt, started, release, ran = _held_graph(monkeypatch)
    (tmp_path / "config.json").write_text("{}")
    controller = Controller(tmp_path / "config.json", device="cpu")
    server = ServerThread(controller)

    def post(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        ids = [post("/prompt", {"prompt": prompt})["prompt_id"] for _ in range(3)]
        assert started.wait(60)
        answer = post("/distributed/interrupt", {})
        assert answer == {"status": "interrupted", "dropped": 2}
        release.set()
        deadline = time.monotonic() + 60
        while ids[0] not in controller.queue.history and time.monotonic() < deadline:
            time.sleep(0.02)
        history = controller.queue.history
        assert history[ids[0]]["status"] == "interrupted"
        assert [history[i] for i in ids[1:]] == \
            [{"status": "interrupted", "duration": 0.0}] * 2
        assert ran == ["empty"]                  # no node after the flag
        # nothing left to drop or stop; the next prompt runs whole
        assert post("/distributed/interrupt", {})["dropped"] == 0
        pid = post("/prompt", {"prompt": prompt})["prompt_id"]
        deadline = time.monotonic() + 60
        while pid not in controller.queue.history and time.monotonic() < deadline:
            time.sleep(0.02)
        assert controller.queue.history[pid]["status"] == "success"
        assert ran == ["empty", "empty", "preview"]
    finally:
        release.set()
        server.stop()


def test_executor_checks_the_interrupt_between_nodes():
    import threading
    import types

    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    flag = threading.Event()
    prompt = {"1": {"class_type": "DistributedEmptyImage",
                    "inputs": {"height": 8, "width": 8}}}
    ctx = {"interrupt_event": flag,
           "model_registry": types.SimpleNamespace(device=torch.device("cpu"))}
    assert GraphExecutor(ctx).execute(prompt)["1"][0].shape == (0, 8, 8, 3)
    flag.set()
    with pytest.raises(InterruptedError, match="before 1"):
        GraphExecutor(ctx).execute(prompt)


# --- breakers in host selection and dispatch --------------------------------------


def selection(pkg, monkeypatch, hosts, trip=()):
    """One package's probe round with its breakers tripped for ``trip``:
    → (online ids, offline ids with their breaker mark, probed ids)."""
    dispatch_mod, breakers = pkg
    probed = []

    async def probe(host, timeout=None):
        probed.append(host["id"])
        return {"queue_remaining": 0}

    monkeypatch.setattr(dispatch_mod, "probe_host", probe)
    for wid in trip:
        breakers.trip(wid)
    online, offline = asyncio.run(dispatch_mod.select_active_hosts(hosts))
    return ([h["id"] for h in online],
            [(h["id"], h.get("_breaker")) for h in offline], sorted(probed))


def test_an_open_breaker_quarantines_a_host_without_a_probe(monkeypatch):
    from comfyui_distributed_tpu.cluster import resilience as jres
    from comfyui_distributed_tpu_torch.cluster import resilience as tres

    hosts = CONFIG["hosts"]
    ours = selection((tdispatch, tres.BREAKERS), monkeypatch, hosts, ["w1"])
    theirs = selection((jdispatch, jres.BREAKERS), monkeypatch, hosts, ["w1"])
    assert ours == theirs == (["w0", "w2"], [("w1", "open")], ["w0", "w2"])


def test_probe_failures_open_the_breaker_and_a_trial_closes_it(monkeypatch):
    from comfyui_distributed_tpu_torch.cluster import resilience as tres

    answers = {"w0": None}

    async def probe(host, timeout=None):
        answers.setdefault("probed", []).append(host["id"])
        return answers["w0"]

    monkeypatch.setattr(tdispatch, "probe_host", probe)
    host = [{"id": "w0", "address": "http://127.0.0.1:9"}]
    for _ in range(tres.BREAKERS.get("w0").failure_threshold):
        asyncio.run(tdispatch.select_active_hosts(host))
    assert tres.BREAKERS.state("w0") == tres.OPEN
    online, offline = asyncio.run(tdispatch.select_active_hosts(host))
    assert offline[0]["_breaker"] == "open" and len(answers["probed"]) == 3
    # after the recovery window one half-open trial decides
    tres.BREAKERS.get("w0").recovery_s = 0.0
    answers["w0"] = {"queue_remaining": 0}
    online, _ = asyncio.run(tdispatch.select_active_hosts(host))
    assert [h["id"] for h in online] == ["w0"]
    assert tres.BREAKERS.state("w0") == tres.CLOSED


@pytest.mark.parametrize("status,closed", [(400, True), (404, True),
                                           (500, False), (503, False)])
def test_a_4xx_feeds_the_breaker_as_success(status, closed, monkeypatch):
    """A validation rejection is the worker healthily answering; a 5xx is
    the worker failing. Neither is sent twice."""
    from comfyui_distributed_tpu_torch.cluster import resilience as tres
    from comfyui_distributed_tpu_torch.utils.exceptions import WorkerError

    calls = []

    async def answer(url, data=None, headers=None, timeout=None):
        calls.append(url)
        return status, b'{"error": "x"}'

    monkeypatch.setattr(tdispatch, "http_request_async", answer)
    host = {"id": "w0", "address": "http://127.0.0.1:9"}
    threshold = tres.BREAKERS.get("w0").failure_threshold
    for _ in range(threshold):
        with pytest.raises(WorkerError, match=str(status)) as info:
            asyncio.run(tdispatch.dispatch_prompt(host, {"1": {}}))
        assert info.value.client_rejected is closed
    assert len(calls) == threshold
    assert tres.BREAKERS.state("w0") == (tres.CLOSED if closed else tres.OPEN)
