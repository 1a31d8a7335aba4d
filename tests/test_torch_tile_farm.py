"""The port's tile farm control plane on the CPU: the retry policy and
circuit breakers (``cluster/resilience.py``), the store's tile jobs, the
heartbeat-timeout requeue, the journal, and the pull queue between a
master controller served on a loopback port and a worker farm talking
to it over HTTP (a share of tiles for the worker, a worker that dies
holding tasks, a frame larger than one POST). Process functions encode
the global tile index in their pixels, so whoever computed a tile must
give the same numbers. The cases follow the JAX package's
``tests/test_resilience.py`` and ``tests/test_tile_farm.py``."""

import asyncio
import json
import random
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.job_store import JobStore
from comfyui_distributed_tpu_torch.cluster.job_timeout import (
    check_and_requeue_timed_out_workers)
from comfyui_distributed_tpu_torch.cluster.resilience import (
    BREAKERS, CLOSED, HALF_OPEN, OPEN, BreakerRegistry, CircuitBreaker,
    RetryPolicy, is_retryable, send_policy, work_request_policy)
from comfyui_distributed_tpu_torch.cluster.tile_farm import (
    TileFarm, TileJournal, assemble_tiles)
from comfyui_distributed_tpu_torch.utils.exceptions import (
    JobQueueError, TileCollectionError)
from comfyui_distributed_tpu_torch.utils.multipart import Part, build_multipart


def run(coro):
    return asyncio.run(coro)


def make_proc(delay=0.0, calls=None):
    """process_fn whose tile i is filled with i."""
    def proc(start, end):
        if calls is not None:
            calls.append(start)
        if delay:
            time.sleep(delay)
        return np.stack([np.full((4, 4, 3), float(i), np.float32)
                         for i in range(start, end)])
    return proc


@pytest.fixture(autouse=True)
def _fresh_breakers():
    BREAKERS.reset()
    yield
    BREAKERS.reset()


# --- retry policy ---------------------------------------------------------------


class TestRetryPolicy:
    def test_needs_some_bound(self):
        with pytest.raises(ValueError):
            RetryPolicy(max_attempts=None, budget_s=None)

    def test_full_jitter_bounds_and_determinism(self):
        p = RetryPolicy(base=0.5, cap=4.0)
        a = [p.delay(n, random.Random(1)) for n in range(6)]
        b = [p.delay(n, random.Random(1)) for n in range(6)]
        assert a == b
        for n, d in enumerate(a):
            assert 0.0 <= d <= min(4.0, 0.5 * 2 ** n)

    def test_no_jitter_is_the_fixed_ladder(self):
        p = RetryPolicy(base=0.5, cap=2.0, jitter=False)
        assert [p.delay(n) for n in range(4)] == [0.5, 1.0, 2.0, 2.0]

    def test_retries_then_succeeds_and_attempt_bound(self):
        calls = []

        async def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        async def nosleep(_):
            pass

        p = RetryPolicy(max_attempts=5, base=0.01)
        assert run(p.run(flaky, sleep=nosleep)) == "ok" and len(calls) == 3
        calls.clear()
        with pytest.raises(OSError):
            run(RetryPolicy(max_attempts=2).run(flaky, sleep=nosleep))
        assert len(calls) == 2

    def test_budget_bound(self):
        async def always():
            raise OSError("down")

        t0 = time.monotonic()
        with pytest.raises(OSError):
            run(RetryPolicy(max_attempts=None, base=0.05, cap=0.05,
                            budget_s=0.3, jitter=False).run(always))
        assert time.monotonic() - t0 < 2.0

    def test_idempotency_marker_and_predicate(self):
        calls = []

        async def unsafe():
            calls.append(1)
            err = OSError("sent, maybe received")
            err.retry_safe = False
            raise err

        with pytest.raises(OSError):
            run(RetryPolicy(max_attempts=5, base=0.0).run(unsafe))
        assert len(calls) == 1
        safe = ValueError("marked")
        safe.retry_safe = True
        assert is_retryable(safe) and not is_retryable(ValueError("plain"))
        assert is_retryable(OSError()) and is_retryable(asyncio.TimeoutError())

    def test_cancellation_propagates(self):
        async def body():
            async def cancelled():
                raise asyncio.CancelledError

            with pytest.raises(asyncio.CancelledError):
                await RetryPolicy(max_attempts=5).run(cancelled)
        run(body())

    def test_named_policies_read_live_knobs(self, monkeypatch):
        monkeypatch.setenv("CDT_SEND_MAX_RETRIES", "7")
        monkeypatch.setenv("CDT_WORK_REQUEST_BUDGET", "12.5")
        assert send_policy().max_attempts == 7
        wp = work_request_policy()
        assert wp.max_attempts is None and wp.budget_s == 12.5


# --- circuit breakers ---------------------------------------------------------------


class TestCircuitBreaker:
    def test_closed_open_halfopen_closed_cycle(self):
        now = [0.0]
        b = CircuitBreaker(failure_threshold=2, recovery_s=10.0,
                           clock=lambda: now[0])
        b.record_failure()
        assert b.state == CLOSED and b.allow()
        b.record_failure()
        assert b.state == OPEN and not b.allow()
        now[0] = 10.0
        assert b.state == HALF_OPEN
        assert b.allow() and not b.allow()        # one trial at a time
        b.record_success()
        assert b.state == CLOSED and b.failures == 0

    def test_halfopen_failure_reopens_and_trip(self):
        now = [0.0]
        b = CircuitBreaker(failure_threshold=1, recovery_s=5.0,
                           clock=lambda: now[0])
        b.record_failure()
        now[0] = 5.0
        assert b.allow()
        b.record_failure()
        assert b.state == OPEN
        now[0] = 9.0
        assert not b.allow()                      # recovery clock re-armed
        c = CircuitBreaker(failure_threshold=9)
        c.trip()
        assert c.state == OPEN

    def test_registry_states_and_reset(self, monkeypatch):
        monkeypatch.setenv("CDT_BREAKER_FAIL_THRESHOLD", "2")
        reg = BreakerRegistry()
        reg.record("w0", ok=False)
        reg.record("w0", ok=False)
        reg.record("w1", ok=True)
        assert reg.states() == {"w0": OPEN, "w1": CLOSED}
        assert not reg.allow("w0")
        reg.trip("w1")
        assert reg.state("w1") == OPEN
        reg.reset()
        assert reg.states() == {}


# --- the store's tile jobs and the timeout requeue ----------------------------------


class TestTileStore:
    def test_tasks_pull_submit_and_status(self):
        async def body():
            store = JobStore()
            job = await store.init_tile_job("j", 5, chunk=2)
            assert [(t.start, t.end) for t in job.tasks.values()] == \
                [(0, 2), (2, 4), (4, 5)]
            with pytest.raises(JobQueueError):
                await store.init_tile_job("j", 5)
            t = await store.request_work("j", "w0")
            assert (t["task_id"], t["job_id"], t["estimated_remaining"]) == (0, "j", 2)
            assert await store.submit_result("j", "w0", 0, {"image": 1})
            assert not await store.submit_result("j", "w0", 0, {"image": 2})
            with pytest.raises(JobQueueError):
                await store.submit_result("j", "w0", 9, {"image": 1})
            assert await store.restore_completed("j", 2, {"image": 3})
            status = await store.job_status("j")
            assert (status["kind"], status["completed"], status["pending"],
                    status["total"]) == ("tile", 2, 1, 3)
            assert await store.request_work("nope", "w0") is None
            await store.cleanup_job("j")
            done = await store.job_status("j")
            assert done["exists"] is False and done["finished"]
            assert done["completed_by"] == {"0": "w0", "2": "journal"}
        run(body())

    def test_requeue_bound_dead_letters_poison_task(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("p", 2, chunk=1)
            for _ in range(3):
                t = await store.request_work("p", "wbad")
                assert t["task_id"] == 0
                await store.requeue_worker_tasks("p", "wbad", max_requeues=2)
            job = store.tile_jobs["p"]
            assert 0 in job.dead_letter and job.remaining() == 1
            # a late real result still wins over the dead letter
            assert await store.submit_result("p", "wbad", 0, {"image": 0})
            assert 0 not in job.dead_letter
            # a handback requeues without counting
            t = await store.request_work("p", "w1")
            assert await store.requeue_worker_tasks(
                "p", "w1", count_requeue=False) == [t["task_id"]]
            assert job.requeue_counts.get(t["task_id"], 0) == 0
            # master-side processing failures: bounded as well
            assert await store.record_task_failure("p", "master", 1, "boom",
                                                   max_requeues=1)
            assert not await store.record_task_failure("p", "master", 1, "boom",
                                                       max_requeues=1)
            assert job.is_complete()
        run(body())

    def test_busy_worker_spared_by_probe_grace(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("g", 4, chunk=2)
            task = await store.request_work("g", "wslow")

            async def busy(worker_id):
                return {"queue_remaining": 3}

            evicted = await check_and_requeue_timed_out_workers(
                store, "g", timeout=0.0, probe_fn=busy,
                now=time.monotonic() + 10)
            assert evicted == {}
            assert store.tile_jobs["g"].assigned[task["task_id"]] == "wslow"
            assert BREAKERS.state("wslow") == CLOSED
        run(body())

    def test_eviction_requeues_and_trips_breaker(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("e", 4, chunk=2)
            task = await store.request_work("e", "wdead")

            async def silent(worker_id):
                return None

            evicted = await check_and_requeue_timed_out_workers(
                store, "e", timeout=0.0, probe_fn=silent,
                now=time.monotonic() + 10)
            assert evicted == {"wdead": [task["task_id"]]}
            job = store.tile_jobs["e"]
            assert job.pending[0].task_id == task["task_id"]   # at the front
            assert BREAKERS.state("wdead") == OPEN
        run(body())


# --- assemble, master alone, holdback, journal --------------------------------------


class TestAssemble:
    def test_orders_and_shortage(self):
        out = assemble_tiles({1: np.full((2, 4, 4, 3), 9.0),
                              0: np.zeros((2, 4, 4, 3))}, total=3, chunk=2)
        assert out.shape == (3, 4, 4, 3) and out[2].max() == 9.0
        with pytest.raises(TileCollectionError, match=r"tasks \[1\] missing"):
            assemble_tiles({0: np.zeros((2, 4, 4, 3))}, total=4, chunk=2)
        with pytest.raises(TileCollectionError, match=r"tasks \[0, 1\]"):
            assemble_tiles({}, total=4, chunk=2)

    def test_fallback_fills_dead_lettered_tasks(self):
        def fallback(start, end):
            return np.full((end - start, 4, 4, 3), -1.0, np.float32)

        out = assemble_tiles({0: np.zeros((2, 4, 4, 3)),
                              2: np.full((1, 4, 4, 3), 5.0)}, total=5, chunk=2,
                             fallback_fn=fallback)
        assert out[0].max() == 0.0 and out[2].min() == -1.0
        assert out[3].min() == -1.0 and out[4].max() == 5.0


class TestMasterAlone:
    def test_master_completes_alone(self):
        async def body():
            farm = TileFarm(JobStore(), asyncio.get_running_loop())
            results = await farm.master_run_async(
                "solo", total=5, process_fn=make_proc(), chunk=2,
                heartbeat_interval=0.2)
            np.testing.assert_array_equal(
                assemble_tiles(results, 5, 2)[:, 0, 0, 0], np.arange(5.0))
        run(body())

    def test_master_poison_task_dead_letters(self, monkeypatch):
        monkeypatch.setenv("CDT_MAX_TILE_REQUEUES", "1")

        def proc(start, end):
            if start == 2:
                raise RuntimeError("poison")
            return make_proc()(start, end)

        async def body():
            store = JobStore()
            farm = TileFarm(store, asyncio.get_running_loop())
            results = await farm.master_run_async("poison", 4, proc, chunk=2,
                                                  heartbeat_interval=0.2)
            assert sorted(results) == [0]
            assert (await store.job_status("poison"))["dead_letter"][0]["task_id"] == 1
        run(body())

    def test_holdback_leaves_queue_to_worker(self, monkeypatch):
        monkeypatch.setenv("CDT_TILE_MASTER_HOLDBACK_S", "30")

        async def body():
            store = JobStore()
            farm = TileFarm(store, asyncio.get_running_loop())
            master = asyncio.create_task(farm.master_run_async(
                "hb", total=6, process_fn=make_proc(), chunk=2,
                heartbeat_interval=0.2))
            await asyncio.sleep(0.5)
            job = store.tile_jobs["hb"]
            assert not job.completed and len(job.pending) == 3
            task = await store.request_work("hb", "w0")
            await store.submit_result("hb", "w0", task["task_id"], {
                "image": make_proc()(task["start"], task["end"])})
            results = await asyncio.wait_for(master, timeout=30)
            np.testing.assert_array_equal(
                assemble_tiles(results, 6, 2)[:, 0, 0, 0], np.arange(6.0))
        run(body())

    def test_holdback_window_expires_without_workers(self, monkeypatch):
        monkeypatch.setenv("CDT_TILE_MASTER_HOLDBACK_S", "0.4")

        async def body():
            farm = TileFarm(JobStore(), asyncio.get_running_loop())
            results = await asyncio.wait_for(farm.master_run_async(
                "hb2", 4, make_proc(), chunk=2, heartbeat_interval=0.2), 30)
            assert len(results) == 2
        run(body())


class TestJournal:
    def test_crash_resume_skips_journaled_tasks(self, tmp_path):
        calls = []
        proc = make_proc(delay=0.05, calls=calls)

        async def body():
            store = JobStore()
            farm = TileFarm(store, asyncio.get_running_loop())
            task = asyncio.create_task(farm.master_run_async(
                "jres", total=6, process_fn=proc, chunk=1,
                heartbeat_interval=0.2, journal_dir=tmp_path))
            while len(list((tmp_path / "jres").glob("task_*.cdtf"))) < 2:
                await asyncio.sleep(0.02)
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            await store.cleanup_job("jres")
            done_before = len(list((tmp_path / "jres").glob("task_*.cdtf")))
            calls.clear()
            farm2 = TileFarm(JobStore(), asyncio.get_running_loop())
            results = await farm2.master_run_async(
                "jres", total=6, process_fn=proc, chunk=1,
                heartbeat_interval=0.2, journal_dir=tmp_path)
            np.testing.assert_array_equal(
                assemble_tiles(results, 6, 1)[:, 0, 0, 0], np.arange(6.0))
            assert len(calls) == 6 - done_before
            assert not (tmp_path / "jres").exists()
        run(body())

    def test_journal_skips_corrupt_entries_and_sanitizes_key(self, tmp_path):
        j = TileJournal(tmp_path, "../evil key")
        assert j.dir.parent == tmp_path
        j.write(0, np.ones((1, 2, 2, 3), np.float32))
        (j.dir / "task_1.cdtf").write_bytes(b"garbage")
        assert list(j.load()) == [0]


# --- two controllers over HTTP ------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, path, payload=None, raw=None, headers=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def master(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("farm")
    (tmp / "master.json").write_text("{}")
    controller = Controller(tmp / "master.json", device="cpu")
    server = ServerThread(controller, port=_free_port())
    try:
        yield controller, server
    finally:
        server.stop()


def _on_master_loop(server, coro):
    return asyncio.run_coroutine_threadsafe(coro, server.loop)


class TestTwoControllersHTTP:
    def test_worker_processes_share_of_tiles(self, master, monkeypatch):
        controller, server = master
        monkeypatch.setenv("CDT_MAX_BATCH", "2")
        # the master leaves the queue to the worker until its first pull
        monkeypatch.setenv("CDT_TILE_MASTER_HOLDBACK_S", "30")
        fut = _on_master_loop(server, controller.tile_farm.master_run_async(
            "j2c", total=8, process_fn=make_proc(delay=0.05), chunk=2,
            heartbeat_interval=0.5))

        async def worker():
            farm = TileFarm(JobStore(), asyncio.get_running_loop())
            return await farm.worker_run_async(
                "j2c", "w0", f"http://127.0.0.1:{server.port}", make_proc())

        done = run(worker())
        results = fut.result(60)
        assert done > 0, "the worker never got work"
        np.testing.assert_array_equal(
            assemble_tiles(results, 8, 2)[:, 0, 0, 0], np.arange(8.0))
        status, summary = _get(server.port, "/distributed/queue_status/j2c")
        assert status == 200 and summary["finished"]
        assert "w0" in summary["completed_by"].values()

    def test_worker_leaves_a_finished_job_at_once(self, master):
        controller, server = master
        fut = _on_master_loop(server, controller.tile_farm.master_run_async(
            "jdone", total=2, process_fn=make_proc(), chunk=1,
            heartbeat_interval=0.2))
        fut.result(60)

        async def worker():
            farm = TileFarm(JobStore(), asyncio.get_running_loop())
            return await farm.worker_run_async(
                "jdone", "w0", f"http://127.0.0.1:{server.port}", make_proc())

        t0 = time.monotonic()
        assert run(worker()) == 0
        assert time.monotonic() - t0 < 5.0

    def test_worker_killed_mid_job_requeue(self, master):
        """A worker pulls two tasks over the wire and goes silent: the
        heartbeat monitor requeues them and the master completes them."""
        controller, server = master
        fut = _on_master_loop(server, controller.tile_farm.master_run_async(
            "jkill", total=8, process_fn=make_proc(delay=0.05), chunk=2,
            heartbeat_interval=0.2, worker_timeout=0.4))
        for _ in range(50):
            status, body = _get(server.port, "/distributed/job_status?job_id=jkill")
            if body.get("exists"):
                break
            time.sleep(0.02)
        for _ in range(2):
            status, body = _post(server.port, "/distributed/request_image",
                                 {"job_id": "jkill", "worker_id": "wdead"})
            assert status == 200 and body["task"] is not None
        results = fut.result(60)
        np.testing.assert_array_equal(
            assemble_tiles(results, 8, 2)[:, 0, 0, 0], np.arange(8.0))
        assert BREAKERS.state("wdead") == OPEN

    def test_frame_larger_than_a_post_is_split(self, master, monkeypatch):
        """With a 2 MiB payload cap a 4-tile task of 512² tiles travels in
        byte ranges and is joined on the master."""
        controller, server = master
        monkeypatch.setenv("CDT_MAX_PAYLOAD_SIZE", str(2 << 20))
        rng = np.random.default_rng(0)
        big = rng.random((4, 512, 512, 3)).astype(np.float32)

        async def master_side():
            store = controller.store
            await store.init_tile_job("jbig", 4, chunk=4)

        _on_master_loop(server, master_side()).result(30)

        async def worker():
            farm = TileFarm(JobStore(), asyncio.get_running_loop())
            return await farm.worker_run_async(
                "jbig", "w0", f"http://127.0.0.1:{server.port}",
                lambda s, e: big[s:e])

        assert run(worker()) == 1

        async def collect():
            job = controller.store.tile_jobs["jbig"]
            tid, payload = await asyncio.wait_for(job.results.get(), 30)
            await controller.store.cleanup_job("jbig")
            return payload["image"]

        np.testing.assert_array_equal(
            _on_master_loop(server, collect()).result(30), big)

    def test_route_validation(self, master):
        _, server = master
        # the steal pull: no open job, no task; a bad exclude list is a 400
        assert _post(server.port, "/distributed/request_image",
                     {"job_id": "*", "worker_id": "w0"}) == (200, {"task": None})
        status, body = _post(server.port, "/distributed/request_image",
                             {"job_id": "*", "worker_id": "w0",
                              "exclude_jobs": "jobA"})
        assert status == 400 and "exclude_jobs" in body["error"]
        status, _ = _post(server.port, "/distributed/request_image",
                          {"job_id": "x"})
        assert status == 400
        assert _post(server.port, "/distributed/request_image",
                     {"job_id": "none", "worker_id": "w0"}) == (200, {"task": None})
        assert _post(server.port, "/distributed/heartbeat",
                     {"job_id": "none", "worker_id": "w0"})[1]["status"] == "unknown_job"
        assert _get(server.port, "/distributed/job_status")[0] == 400
        assert _get(server.port, "/distributed/job_status?job_id=none") == \
            (200, {"exists": False})
        body, ctype = build_multipart([Part("other", b"{}")])
        status, _ = _post(server.port, "/distributed/submit_tiles", raw=body,
                          headers={"Content-Type": ctype, "X-CDT-Client": "1"})
        assert status == 400
        # a multipart POST without the peer header is refused
        status, _ = _post(server.port, "/distributed/submit_tiles", raw=body,
                          headers={"Content-Type": ctype})
        assert status == 415
        assert _post(server.port, "/distributed/handback",
                     {"job_id": "none", "worker_id": "w0"}) == \
            (200, {"status": "ok", "requeued": []})


def test_submit_png_and_image_routes(master):
    """Tiles may also arrive as PNG parts; ``submit_image`` takes one
    base64 PNG per task (dynamic mode)."""
    from comfyui_distributed_tpu_torch.utils.image import (
        encode_image_b64, encode_png)

    controller, server = master
    img = np.random.default_rng(1).random((4, 4, 3)).astype(np.float32)

    async def seed():
        await controller.store.init_tile_job("jpng", 2, chunk=1)

    _on_master_loop(server, seed()).result(30)
    meta = {"job_id": "jpng", "worker_id": "w0", "tiles": [{"task_id": 0}]}
    body, ctype = build_multipart([
        Part("tiles_metadata", json.dumps(meta).encode(),
             content_type="application/json"),
        Part("tile_0", encode_png(img), "tile_0.png", "image/png")])
    assert _post(server.port, "/distributed/submit_tiles", raw=body,
                 headers={"Content-Type": ctype, "X-CDT-Client": "1"}) == \
        (200, {"status": "ok", "accepted": 1})
    assert _post(server.port, "/distributed/submit_image",
                 {"job_id": "jpng", "worker_id": "w0", "task_id": 1,
                  "image": encode_image_b64(img)}) == \
        (200, {"status": "ok", "accepted": 1})

    async def check():
        job = controller.store.tile_jobs["jpng"]
        got = dict(job.completed)
        await controller.store.cleanup_job("jpng")
        return got

    got = _on_master_loop(server, check()).result(30)
    np.testing.assert_allclose(got[0]["image"], img, atol=1 / 255)
    assert got[1]["image"].shape == (1, 4, 4, 3)
