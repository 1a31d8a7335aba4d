"""The port's sampling progress against the JAX package's, on the CPU:
``latent_to_rgb`` and the call totals bit for bit, the tracker's
ordering and counting, the pipelines' per-step x0 previews against the
JAX pipeline's callback payloads (the port handed JAX's noise), a run
with a progress token bitwise equal to one without, and the progress
and preview routes of the port's control plane."""

import dataclasses
import json
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX package's models need flax. Where it is missing (the card's
# machine), only the card tests of tests/test_torch_cuda.py run.
pytest.importorskip("flax")

from comfyui_distributed_tpu.cluster import progress as jtracker  # noqa: E402
from comfyui_distributed_tpu.diffusion import pipeline as jpipe  # noqa: E402
from comfyui_distributed_tpu.diffusion import pipeline_flow as jflow  # noqa: E402
from comfyui_distributed_tpu.diffusion import progress as jevents  # noqa: E402
from comfyui_distributed_tpu.diffusion.samplers import SAMPLERS  # noqa: E402
from comfyui_distributed_tpu.models import dit as jdit  # noqa: E402
from comfyui_distributed_tpu.models import text as jtext  # noqa: E402
from comfyui_distributed_tpu.models import unet as junet  # noqa: E402
from comfyui_distributed_tpu.models import vae as jvae  # noqa: E402
from comfyui_distributed_tpu.parallel import build_mesh  # noqa: E402
from comfyui_distributed_tpu_torch.api.app import ServerThread  # noqa: E402
from comfyui_distributed_tpu_torch.cluster import progress as ttracker  # noqa: E402
from comfyui_distributed_tpu_torch.cluster.controller import Controller  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline as tpipe  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import pipeline_flow as tflow  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion import progress as tevents  # noqa: E402
from comfyui_distributed_tpu_torch.diffusion.progress import StepEvent  # noqa: E402
from comfyui_distributed_tpu_torch.graph import GraphExecutor  # noqa: E402
from comfyui_distributed_tpu_torch.graph.executor import strip_meta  # noqa: E402
from comfyui_distributed_tpu_torch.models import dit as tdit  # noqa: E402
from comfyui_distributed_tpu_torch.models import unet as tunet  # noqa: E402
from comfyui_distributed_tpu_torch.models import vae as tvae  # noqa: E402
from comfyui_distributed_tpu_torch.models.from_jax import load_from_jax  # noqa: E402
from comfyui_distributed_tpu_torch.models.registry import ModelRegistry  # noqa: E402
from comfyui_distributed_tpu_torch.utils.image import decode_png  # noqa: E402
from test_torch_dit import break_zero_init  # noqa: E402
from torch_cpu_share import cpu_share  # noqa: E402,F401  (autouse)

TOL = 2e-4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def tracker():
    t = ttracker.ProgressTracker()
    yield t
    t.close()


class Captured:
    """A sink of one package's events, as (sigma, x0[:1]) per model call."""

    def __init__(self):
        self.events = []

    def torch_sink(self, event):
        self.events.append(event)

    def jax_sink(self, token, shard, sigma, x0):
        self.events.append((token, shard, sigma, x0))


@pytest.fixture
def captured():
    cap = Captured()
    t_handle = tevents.add_sink(cap.torch_sink)
    j_handle = jevents.add_sink(cap.jax_sink)
    yield cap
    tevents.remove_sink(t_handle)
    jevents.remove_sink(j_handle)


# --- the preview map and the call totals ---------------------------------------


@pytest.mark.parametrize("shape", [(8, 8, 4), (8, 6, 16), (5, 8, 8, 4),
                                   (4, 4, 3)], ids=str)
def test_latent_to_rgb_bit_for_bit(shape):
    lat = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3
    ours = ttracker.latent_to_rgb(lat)
    ref = jtracker.latent_to_rgb(lat)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert np.array_equal(ttracker._RGB_4CH, jtracker._RGB_4CH)


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_call_totals_match_jax(sampler):
    for steps in (1, 2, 28, 30):
        assert tevents.total_calls(sampler, steps) == \
            jevents.total_calls(sampler, steps)


# --- the tracker ----------------------------------------------------------------


def event(token, sigma, value, shard=0, shape=(1, 4, 4, 4)):
    return StepEvent(token, shard, sigma, torch.full(shape, float(value)))


class PendingEvent:
    """A step event whose host copy has not landed (a card still busy)."""

    def __init__(self, token, sigma, value):
        self.token, self.shard, self._sigma = token, 0, sigma
        self._x0 = np.full((1, 2, 2, 4), value, np.float32)
        self.landed = False
        self.waited = False

    def ready(self):
        return self.landed

    def wait(self):
        self.waited = self.landed = True

    @property
    def sigma(self):
        assert self.landed, "read before its copy landed"
        return self._sigma

    @property
    def x0(self):
        assert self.landed, "read before its copy landed"
        return self._x0


def test_tracker_orders_by_sigma_and_counts_shard_zero(tracker):
    token = tracker.start("p1", tevents.total_calls("euler", 4))
    tracker._on_event(event(token, 2.0, 1.0))       # the later step first
    tracker._on_event(event(token, 14.0, 7.0))
    snap = tracker.snapshot("p1")
    assert snap["step"] == 2 and snap["total"] == 4 and snap["fraction"] == 0.5
    assert tracker._jobs[token].previews[0][0, 0, 0] == 1.0   # lowest sigma
    tracker._on_event(event(token, 5.0, 3.0, shard=1))
    snap = tracker.snapshot("p1")
    assert snap["step"] == 2 and snap["shards_reporting"] == 2
    # the JAX tracker, given the same events, says the same
    ref = jtracker.ProgressTracker()
    try:
        jt = ref.start("p1", 4)
        for sigma, value, shard in ((2.0, 1.0, 0), (14.0, 7.0, 0), (5.0, 3.0, 1)):
            ref._on_event(jt, shard, sigma, np.full((1, 4, 4, 4), value, np.float32))
        theirs = ref.snapshot("p1")
        for key in ("step", "total", "fraction", "done", "failed",
                    "shards_reporting"):
            assert snap[key] == theirs[key], key
        for shard in (0, 1):          # the same pixels (the encoders differ)
            assert np.array_equal(decode_png(ref.preview_png("p1", shard)),
                                  decode_png(tracker.preview_png("p1", shard)))
    finally:
        ref.close()


def test_pending_events_are_read_only_once_landed(tracker):
    token = tracker.start("p2", 3)
    first, second = PendingEvent(token, 9.0, 1.0), PendingEvent(token, 4.0, 2.0)
    tracker._on_event(first)
    tracker._on_event(second)
    assert tracker.snapshot("p2")["step"] == 0
    assert tracker.preview_png("p2") is None        # 404 until the first step
    first.landed = True
    assert tracker.snapshot("p2")["step"] == 1
    tracker.complete(token)                         # waits for the rest
    assert second.waited and tracker.snapshot("p2")["step"] == 2
    assert tracker._jobs[token].previews[0][0, 0, 0] == 2.0


def test_finish_clamps_fails_freeze_and_late_events_drop(tracker):
    token = tracker.start("p3", 10)
    tracker._on_event(event(token, 5.0, 0.0))
    tracker.finish("p3")
    snap = tracker.snapshot("p3")
    assert snap["done"] and snap["fraction"] == 1.0 and snap["step"] == 10
    tracker._on_event(event(token, 1.0, 1.0))
    assert tracker.snapshot("p3")["step"] == 10
    token = tracker.start("p4", 10)
    tracker._on_event(event(token, 5.0, 0.0))
    tracker.finish("p4", failed=True)
    snap = tracker.snapshot("p4")
    assert snap["failed"] and snap["step"] == 1


def test_preview_png_and_eviction(tracker):
    token = tracker.start("p5", 2)
    tracker._on_event(StepEvent(token, 0, 3.0, torch.randn(1, 8, 6, 16)))
    assert decode_png(tracker.preview_png("p5")).shape == (8, 6, 3)
    assert tracker.snapshot("nope") is None and tracker.preview_png("nope") is None
    small = ttracker.ProgressTracker(keep=2)
    try:
        for pid in ("a", "b", "c"):
            small.start(pid, 1)
        assert small.snapshot("a") is None and small.snapshot("c") is not None
    finally:
        small.close()


def test_two_trackers_route_by_token():
    a, b = ttracker.ProgressTracker(), ttracker.ProgressTracker()
    try:
        ta, tb = a.start("pa", 2), b.start("pb", 2)
        den = tevents.wrap_denoiser(lambda x, s: x * 0.5, ta)
        den(torch.ones(1, 2, 2, 4), torch.tensor(3.0))
        assert a.snapshot("pa")["step"] == 1
        assert b.snapshot("pb")["step"] == 0 and tb != ta
    finally:
        a.close()
        b.close()


# --- the pipelines against the JAX package's -----------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny fp32 txt2img stack in both packages with the same weights,
    and JAX-encoded conditioning (as tests/test_torch_pipeline.py)."""
    model, params = junet.init_unet(junet.UNetConfig.tiny(dtype="float32"),
                                    jax.random.key(0), sample_shape=(8, 8, 4),
                                    context_len=16)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(16, 16))
    jp = jpipe.Txt2ImgPipeline(model, params, vae)
    unet = load_from_jax(tunet.UNet2D(tunet.UNetConfig.tiny(dtype="float32")),
                         jax.tree_util.tree_map(np.asarray, params)).eval()
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray, vae.dec_params))
    tp = tpipe.Txt2ImgPipeline(unet, tv.eval())
    enc = jtext.TextEncoder(dataclasses.replace(jtext.TextEncoderConfig.tiny(),
                                                dtype="float32")).init(jax.random.key(2))
    ctx, pooled = enc.encode(["a cat"])
    unc, upooled = enc.encode([""])
    y, uy = np.asarray(pooled)[:, :8], np.asarray(upooled)[:, :8]
    return jp, tp, [np.array(a) for a in (ctx, unc, y, uy)]


def compare_payloads(cap: Captured, jtoken: int, ttoken: int, steps: int):
    jax.effects_barrier()
    ours = [e for e in cap.events if isinstance(e, StepEvent) and e.token == ttoken]
    theirs = sorted((e for e in cap.events
                     if isinstance(e, tuple) and e[0] == jtoken),
                    key=lambda e: -e[2])            # unordered: by sigma
    assert len(ours) == len(theirs) == steps
    for ev, (_, shard, sigma, x0) in zip(ours, theirs):
        assert ev.ready() and ev.shard == shard == 0
        np.testing.assert_allclose(ev.sigma, sigma, rtol=1e-6)
        assert ev.x0.shape == np.asarray(x0).shape
        np.testing.assert_allclose(ev.x0, np.asarray(x0), atol=TOL, rtol=TOL)


def test_txt2img_previews_match_the_jax_callbacks(tiny_pair, captured):
    jp, tp, (ctx, unc, y, uy) = tiny_pair
    spec = dict(height=16, width=16, steps=3, sampler="euler",
                scheduler="karras", guidance_scale=5.0)
    seed, jtoken, ttoken = 11, jevents.next_token(), tevents.next_token()
    ref = np.asarray(jp.generate(build_mesh({"dp": 1}), jpipe.GenerationSpec(**spec),
                                 seed, ctx, unc, y, uy, progress_token=jtoken))
    k_noise, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), 0))
    noise = torch.from_numpy(np.array(
        jax.random.normal(k_noise, (1, 8, 8, 4), jnp.float32)))
    args = [torch.from_numpy(a) for a in (ctx, unc, y, uy)]
    out = tp.sample_and_decode(noise, tpipe.GenerationSpec(**spec), *args,
                               progress_token=ttoken)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    compare_payloads(captured, jtoken, ttoken, 3)
    # the token changes nothing the sampler computes
    plain = tp.sample_and_decode(noise, tpipe.GenerationSpec(**spec), *args)
    assert torch.equal(out, plain)


@pytest.fixture(scope="module")
def flux_pair():
    """flux-tiny in both packages with the same weights (the zero-drawn
    gates replaced, as tests/test_torch_flow.py does)."""
    model, params = jdit.init_dit(jdit.DiTConfig.tiny(dtype="float32"),
                                  jax.random.key(0), sample_hw=(8, 8),
                                  context_len=16)
    params = break_zero_init(params, 1)
    vae = jvae.AutoencoderKL(jvae.VAEConfig.tiny(dtype="float32")).init(
        jax.random.key(1), image_hw=(16, 16))
    jp = jflow.FlowPipeline(model, params, vae)
    dit = load_from_jax(tdit.DiT(tdit.DiTConfig.tiny(dtype="float32")), params)
    tv = tvae.AutoencoderKL(tvae.VAEConfig.tiny(dtype="float32"))
    load_from_jax(tv.decoder, jax.tree_util.tree_map(np.asarray, vae.dec_params))
    tp = tflow.FlowPipeline(dit.eval(), tv.eval())
    enc = jtext.TextEncoder(dataclasses.replace(jtext.TextEncoderConfig.tiny(),
                                                dtype="float32")).init(jax.random.key(2))
    ctx, pooled = enc.encode(["an isometric papercraft city"])
    return jp, tp, np.array(ctx), np.array(pooled)


def test_flow_previews_match_the_jax_callbacks(flux_pair, captured):
    jp, tp, ctx, pooled = flux_pair
    seed, jtoken, ttoken = 5, jevents.next_token(), tevents.next_token()
    spec = dict(height=16, width=16, steps=3, shift=3.0)
    ref = np.asarray(jp.generate(build_mesh({"dp": 1}), jflow.FlowSpec(**spec),
                                 seed, ctx, pooled, progress_token=jtoken))
    key = jax.random.fold_in(jax.random.key(seed), 0)
    c = tp.dit.config.in_channels
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, (1, 8, 8, c), jnp.float32)))
    args = (torch.from_numpy(ctx), torch.from_numpy(pooled))
    out = tp.sample_and_decode(noise, tflow.FlowSpec(**spec), *args,
                               progress_token=ttoken)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    compare_payloads(captured, jtoken, ttoken, 3)
    plain = tp.sample_and_decode(noise, tflow.FlowSpec(**spec), *args)
    assert torch.equal(out, plain)


# --- the nodes and the routes ----------------------------------------------------


def flux_prompt(steps: int = 3) -> dict:
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / "flux-txt2img.json").read_text()))
    prompt["1"]["inputs"]["ckpt_name"] = "flux-tiny"
    prompt["4"]["inputs"].update(width=16, height=16, steps=steps)
    return prompt


def test_workflow_with_a_tracker_is_bitwise_the_workflow_without(tmp_path, tracker):
    registry = ModelRegistry("cpu", seed=0)
    plain = GraphExecutor({"model_registry": registry,
                           "output_dir": str(tmp_path)}).execute(flux_prompt())
    tracked = GraphExecutor({"model_registry": registry,
                             "output_dir": str(tmp_path), "prompt_id": "wf1",
                             "progress_tracker": tracker}).execute(flux_prompt())
    assert torch.equal(plain["4"][0], tracked["4"][0])
    snap = tracker.snapshot("wf1")
    assert snap["step"] == snap["total"] == 3 and snap["done"]
    assert not snap["failed"]


def test_progress_and_preview_routes(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    controller = Controller(tmp_path / "config.json", device="cpu")
    server = ServerThread(controller)
    try:
        base = f"http://127.0.0.1:{server.port}"

        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=30) as resp:
                    return resp.status, resp.headers["Content-Type"], resp.read()
            except urllib.error.HTTPError as e:
                with e:
                    return e.code, e.headers["Content-Type"], e.read()

        token = controller.progress.start("pr1", 4)
        assert get("/distributed/progress/pr1")[0] == 200
        assert get("/distributed/preview/pr1")[0] == 404     # no step yet
        controller.progress._on_event(
            StepEvent(token, 0, 3.0, torch.randn(1, 8, 8, 4)))
        status, ctype, body = get("/distributed/progress/pr1")
        snap = json.loads(body)
        assert status == 200 and snap["step"] == 1 and snap["total"] == 4
        status, ctype, png = get("/distributed/preview/pr1?shard=0")
        assert status == 200 and ctype == "image/png"
        assert decode_png(png).shape == (8, 8, 3)
        assert get("/distributed/preview/pr1?shard=x")[0] == 200   # shard 0
        assert get("/distributed/progress/none")[0] == 404
        assert get("/distributed/preview/none")[0] == 404
    finally:
        server.stop()
    assert controller.progress._sink_handle not in tevents._SINKS


def test_no_token_no_events(tiny_pair, captured):
    _, tp, (ctx, unc, y, uy) = tiny_pair
    spec = tpipe.GenerationSpec(height=16, width=16, steps=2)
    tp.generate(spec, 3, *(torch.from_numpy(a) for a in (ctx, unc, y, uy)))
    assert not [e for e in captured.events if isinstance(e, StepEvent)]
