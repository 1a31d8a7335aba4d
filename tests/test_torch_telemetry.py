"""The port's telemetry against the JAX package's (both standard library
only, so both import here without JAX): the same metric operations render
the same Prometheus text and JSON, the same span nesting gives the same
tree, the same headers parse alike; then the port's instrumentation
sites: prompts, pipeline calls, attention selections, dispatch with its
trace header, and a trace that crosses the prompt queue's thread."""

import asyncio
import json
import math

import pytest
import torch

import comfyui_distributed_tpu.telemetry as jtel
import comfyui_distributed_tpu_torch.telemetry as ptel
from comfyui_distributed_tpu.telemetry import export as jexport
from comfyui_distributed_tpu.telemetry import registry as jreg
from comfyui_distributed_tpu_torch.telemetry import export as pexport
from comfyui_distributed_tpu_torch.telemetry import registry as preg

BOTH = [(jreg, jexport), (preg, pexport)]


@pytest.fixture(autouse=True)
def _telemetry_on():
    for pkg in (jtel, ptel):
        pkg.set_enabled(True)
        pkg.REGISTRY.reset()
        pkg.SPAN_STORE.reset()
    yield
    for pkg in (jtel, ptel):
        pkg.set_enabled(True)
        pkg.SPAN_STORE.reset()


def drive(reg_mod, enabled: bool = True):
    """One fixed sequence of operations on a fresh registry."""
    r = reg_mod.MetricRegistry()
    reg_mod.set_enabled(enabled)
    try:
        c = r.counter("cdt_things_total", 'Things "done".\nSecond line',
                      ("kind", "outcome"))
        c.labels(kind="a", outcome="ok").inc()
        c.labels(kind="a", outcome="ok").inc(2.5)
        c.labels(kind='q"uo\\te\n', outcome="error").inc()
        plain = r.counter("cdt_plain_total", "No labels.")
        plain.inc(3)
        g = r.gauge("cdt_depth", "A depth.", ("stage",))
        g.labels(stage="x").set(7)
        g.labels(stage="x").inc(0.25)
        g.labels(stage="y").dec(2)
        h = r.histogram("cdt_seconds", "Durations.", ("pipeline",))
        for v in (0.0004, 0.003, 0.2, 1.0, 7.5, 99.0, 1e4):
            h.labels(pipeline="txt2img").observe(v)
        hb = r.histogram("cdt_bytes", "Sizes.",
                         buckets=reg_mod.BYTES_BUCKETS)
        for v in (10, 5000, 3e8):
            hb.observe(v)
        capped = r.counter("cdt_capped_total", "Capped.", ("id",))
        for i in range(reg_mod.MAX_SERIES + 5):
            capped.labels(id=str(i)).inc()
        with pytest.raises(ValueError, match="only go up"):
            if enabled:
                c.labels(kind="a", outcome="ok").inc(-1)
            else:
                raise ValueError("counters only go up")
        with pytest.raises(ValueError, match="expected labels"):
            c.labels(kind="a")
        with pytest.raises(ValueError, match="re-declared"):
            r.gauge("cdt_things_total", "", ("kind", "outcome"))
        return r.snapshot()
    finally:
        reg_mod.set_enabled(True)


@pytest.mark.parametrize("enabled", [True, False])
def test_same_operations_render_the_same_text_and_json(enabled):
    (jsnap, psnap) = [drive(reg, enabled) for reg, _ in BOTH]
    jtext = jexport.render_prometheus(jsnap)
    ptext = pexport.render_prometheus(psnap)
    assert ptext.encode() == jtext.encode()
    assert pexport.render_json(psnap) == jexport.render_json(jsnap)
    assert pexport.PROMETHEUS_CONTENT_TYPE == jexport.PROMETHEUS_CONTENT_TYPE
    if enabled:
        assert 'cdt_seconds_bucket{le="+Inf",pipeline="txt2img"} 7' in ptext
        assert "cdt_telemetry_series_dropped_total 5" in ptext
    else:
        assert "cdt_plain_total 0" in ptext


def test_the_shared_bucket_ladders_match():
    for name in ("DURATION_BUCKETS", "COMPILE_BUCKETS", "BYTES_BUCKETS",
                 "MAX_SERIES"):
        assert getattr(preg, name) == getattr(jreg, name)


def test_families_share_the_jax_names_types_and_labels():
    jsnap, psnap = jtel.REGISTRY.snapshot(), ptel.REGISTRY.snapshot()
    assert set(psnap) < set(jsnap)
    for name, fam in psnap.items():
        assert (fam["type"], fam["labelnames"]) == (
            jsnap[name]["type"], jsnap[name]["labelnames"]), name


def span_shape(roots):
    return [(s["name"], s["attrs"], "error" in s, span_shape(s["children"]))
            for s in roots]


def nest(tel):
    with tel.span("orchestrate", trace_id="exec_1", job_id="exec_1"):
        with tel.span("dispatch", host="w0"):
            hdr = tel.trace_headers()[tel.TRACE_HEADER]
        with tel.span("dispatch", host="w1"):
            pass
    tid, parent = tel.parse_trace_header(hdr)
    with tel.use_trace(tid, parent):
        with tel.span("prompt.execute", prompt_id="p_1"):
            with tel.span("pipeline_call", pipeline="txt2img"):
                pass
    with pytest.raises(RuntimeError):
        with tel.span("failing", trace_id="exec_1"):
            raise RuntimeError("boom")
    return tel.SPAN_STORE.tree(tel.SPAN_STORE.resolve("p_1"))


def test_same_span_nesting_gives_the_same_tree():
    jtree, ptree = nest(jtel), nest(ptel)
    assert span_shape(ptree) == span_shape(jtree)
    assert [s["name"] for s in ptree] == ["orchestrate", "failing"]
    dispatch = ptree[0]["children"][0]
    assert dispatch["children"][0]["name"] == "prompt.execute"
    assert ptel.SPAN_STORE.resolve("exec_1") == "exec_1"
    # the free span_tree of the port nests the same list the same way
    assert ptel.span_tree(ptel.SPAN_STORE.spans("exec_1")) == ptree


@pytest.mark.parametrize("value", [
    "exec_1:abcd", "exec_1", " exec_1 : abcd ", "exec_1:", ":abcd", "", None,
    42, "x" * 201, "a:b:c", "trace_9_ab:"])
def test_trace_header_parses_alike(value):
    assert ptel.parse_trace_header(value) == jtel.parse_trace_header(value)


def test_disabled_spans_record_nothing():
    ptel.set_enabled(False)
    with ptel.span("orchestrate", trace_id="exec_off") as s:
        assert s is None and ptel.trace_headers() == {}
    assert ptel.SPAN_STORE.resolve("exec_off") is None


def test_telemetry_knob_reads_an_empty_value_as_off(monkeypatch):
    from comfyui_distributed_tpu_torch.utils.constants import telemetry

    monkeypatch.delenv("CDT_TELEMETRY", raising=False)
    assert telemetry() is True
    for raw, want in (("", False), ("0", False), ("1", True), ("off", False)):
        monkeypatch.setenv("CDT_TELEMETRY", raw)
        assert telemetry() is want


def series(name, **labels):
    fam = ptel.REGISTRY.snapshot()[name]
    return [s for s in fam["series"]
            if all(s["labels"].get(k) == v for k, v in labels.items())]


def test_attention_selection_counts_once_per_geometry_and_tier():
    from comfyui_distributed_tpu_torch.ops import attention

    attention.reset_selections()
    cuda = torch.device("cuda")
    for _ in range(3):
        assert attention.select_kernel(cuda, True, 10, 64, 640,
                                       q_len=4096) == "fused"
        assert attention.select_kernel(cuda, False, 10, 64, q_len=4096,
                                       kv_len=77) == "packed"
        # another length in the same bucket is the same geometry
        attention.select_kernel(cuda, False, 10, 64, q_len=4000, kv_len=77)
    assert attention.select_kernel(torch.device("cpu"), False, 10, 64,
                                   q_len=4096) == "plain"
    got = {s["labels"]["geometry"]: (s["labels"]["tier"], s["value"])
           for s in series("cdt_attn_kernel_selected")}
    assert got == {"h10.d64.q4096.kv4096.bf16": ("fused", 1.0),
                   "h10.d64.q4096.kv128.bf16": ("packed", 1.0)}
    assert attention.selection_summary() == (
        "h10.d64.q4096.kv128.bf16=packed,h10.d64.q4096.kv4096.bf16=fused")
    attention.reset_selections()


def test_pipeline_call_records_step_time_under_a_span():
    from comfyui_distributed_tpu_torch.diffusion.pipeline import pipeline_call

    class Owner:
        timings = {}

    owner = Owner()
    for i in range(3):
        with ptel.span("prompt.execute", trace_id="exec_p", prompt_id="p_p"):
            with pipeline_call(owner, "txt2img", lambda: owner.timings):
                owner.timings = {"sample_s": 0.3, "steps": 30}
    first = series("cdt_pipeline_compile_seconds", pipeline="txt2img")
    later = series("cdt_pipeline_execute_seconds", pipeline="txt2img")
    steps = series("cdt_sampler_step_seconds", pipeline="txt2img")
    assert (first[0]["count"], later[0]["count"], steps[0]["count"]) == (1, 2, 3)
    assert math.isclose(steps[0]["sum"], 3 * 0.01)
    spans = ptel.SPAN_STORE.spans("exec_p")
    calls = [s for s in spans if s["name"] == "pipeline_call"]
    parents = {s["span_id"] for s in spans if s["name"] == "prompt.execute"}
    assert len(calls) == 3 and all(c["parent_id"] in parents for c in calls)
    assert calls[0]["attrs"]["pipeline"] == "txt2img"
    ptel.set_enabled(False)
    with pipeline_call(owner, "txt2img", lambda: owner.timings):
        pass
    ptel.set_enabled(True)
    assert series("cdt_sampler_step_seconds", pipeline="txt2img")[0]["count"] == 3


def test_prompt_queue_traces_into_its_thread_and_counts(tmp_path):
    """The graph runs in the queue's pool thread: a span a node opens
    there joins the prompt's trace, under ``prompt.execute``."""
    from comfyui_distributed_tpu_torch.cluster.runtime import PromptQueue
    from comfyui_distributed_tpu_torch.graph import node as gnode

    class Spanning(gnode.NodeDef):
        RETURNS = ("INT",)

        def execute(self, **_):
            with ptel.span("node.inside"):
                pass
            return (1,)

    gnode.NODE_REGISTRY["_TelemetrySpanning"] = Spanning
    try:
        async def run():
            q = PromptQueue()
            pid, errors = q.enqueue(
                {"1": {"class_type": "_TelemetrySpanning", "inputs": {}}},
                trace_id="exec_q", parent_span_id="feedbeef")
            assert not errors
            bad, errors = q.enqueue({"1": {"class_type": "Nope", "inputs": {}}})
            assert errors and not bad
            while q.history.get(pid, {}).get("status") != "success":
                await asyncio.sleep(0.01)
            await q.stop()
            return pid

        pid = asyncio.run(run())
    finally:
        del gnode.NODE_REGISTRY["_TelemetrySpanning"]
    assert ptel.SPAN_STORE.resolve(pid) == "exec_q"
    (root,) = ptel.SPAN_STORE.tree("exec_q")
    assert (root["name"], root["parent_id"]) == ("prompt.execute", "feedbeef")
    assert [c["name"] for c in root["children"]] == ["node.inside"]
    assert series("cdt_prompts_total", status="success")[0]["value"] == 1
    assert ptel.REGISTRY.snapshot()["cdt_prompt_duration_seconds"][
        "series"][0]["count"] == 1
    assert series("cdt_prompt_queue_depth")[0]["value"] == 0


def test_http_dispatch_carries_the_trace_header_and_records(monkeypatch):
    from comfyui_distributed_tpu_torch.cluster import dispatch, resilience

    resilience.BREAKERS.reset()
    seen = []

    async def answer(url, data=None, headers=None, timeout=None):
        seen.append(headers)
        return 200, b'{"prompt_id": "p_w"}'

    monkeypatch.setattr(dispatch, "http_request_async", answer)

    async def run():
        with ptel.span("orchestrate", trace_id="exec_d"):
            return await dispatch.dispatch_prompt(
                {"id": "w0", "address": "http://127.0.0.1:9"}, {"1": {}},
                trace_id="exec_d")

    assert asyncio.run(run()) == {"prompt_id": "p_w"}
    (span,) = [s for s in ptel.SPAN_STORE.spans("exec_d")
               if s["name"] == "dispatch"]
    assert seen[0][ptel.TRACE_HEADER] == f"exec_d:{span['span_id']}"
    assert series("cdt_dispatch_seconds", transport="http",
                  outcome="ok")[0]["count"] == 1
    assert series("cdt_dispatch_payload_bytes", transport="http")[0]["count"] == 1
    assert series("cdt_worker_breaker_state", worker="w0")[0]["value"] == 0
    resilience.BREAKERS.reset()


def test_breaker_faults_retries_tiles_and_hash_tokens_are_counted():
    from comfyui_distributed_tpu_torch.cluster import faults, resilience
    from comfyui_distributed_tpu_torch.cluster.job_store import JobStore
    from comfyui_distributed_tpu_torch.models.text import (TextEncoder,
                                                           TextEncoderConfig,
                                                           TextTransformer)

    reg = resilience.BreakerRegistry(failure_threshold=1)
    reg.record("w9", False)
    assert series("cdt_worker_breaker_transitions_total", to="open")[0]["value"] == 1
    assert series("cdt_worker_breaker_state", worker="w9")[0]["value"] == 2

    plan = faults.FaultPlan.parse("dispatch@0:http500")
    assert plan.next_fault("dispatch").kind == "http500"
    assert series("cdt_faults_injected_total", op="dispatch",
                  kind="http500")[0]["value"] == 1

    async def flaky_then_ok():
        calls = []

        async def fn():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("x")
            return "ok"

        async def no_sleep(_):
            pass

        return await resilience.RetryPolicy(max_attempts=5).run(
            fn, op="submit", sleep=no_sleep)

    assert asyncio.run(flaky_then_ok()) == "ok"
    assert series("cdt_retry_attempts_total", op="submit")[0]["value"] == 2

    async def tiles():
        store = JobStore()
        await store.init_tile_job("j", 3)
        t = await store.request_work("j", "w0")
        await store.submit_result("j", "w0", t["task_id"], b"x")
        await store.request_work("j", "w1")
        await store.requeue_worker_tasks("j", "w1")

    asyncio.run(tiles())
    events = {s["labels"]["event"]: s["value"]
              for s in series("cdt_tile_tasks_total")}
    assert events == {"seeded": 3, "assigned": 2, "completed": 1, "requeued": 1}
    assert series("cdt_tile_queue_depth")[0]["value"] == 2

    enc = TextEncoder(TextTransformer(TextEncoderConfig.tiny("float32")))
    enc.encode(["a cat"])
    assert series("cdt_hash_tokenization_total", tower="text")[0]["value"] == 1


def test_histogram_json_matches_prometheus_counts():
    h = ptel.REGISTRY.histogram("cdt_test_roundtrip_seconds", "x")
    for v in (0.002, 0.3, 3.0):
        h.observe(v)
    text = pexport.render_prometheus(ptel.REGISTRY.snapshot())
    doc = json.loads(json.dumps(pexport.render_json(ptel.REGISTRY.snapshot())))
    fam = doc["metrics"]["cdt_test_roundtrip_seconds"]["series"][0]
    assert fam["count"] == 3 and 'cdt_test_roundtrip_seconds_count 3' in text
