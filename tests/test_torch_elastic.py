"""The port's elastic fleet (``cluster/elastic``) on the CPU, held against
the JAX package's: the drain registry, the steal policy, the autoscaler's
decisions and the job store's grants and handbacks equal JAX's exactly on
the same inputs; then the drain coordinator, the routes over the port's
stdlib server, the steal worker's loop, and a tiny scale event (a
``tiny`` txt2img job and a ``tiny`` USDU job that scale up mid-run
through the real autoscaler, lose a drained worker and roll another)
bitwise the static-fleet run. The classes follow the JAX package's
``tests/test_elastic.py``."""

import asyncio
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from comfyui_distributed_tpu.cluster import job_store as jstore_mod
from comfyui_distributed_tpu.cluster.elastic import autoscaler as jauto
from comfyui_distributed_tpu.cluster.elastic import scheduler as jsched
from comfyui_distributed_tpu.cluster.elastic import states as jstates
from comfyui_distributed_tpu_torch import telemetry
from comfyui_distributed_tpu_torch.api.app import ServerThread
from comfyui_distributed_tpu_torch.cluster import faults
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.elastic import (
    ACTIVE, DECOMMISSIONED, DRAIN, DRAINING, AutoscalePolicy, Autoscaler,
    DrainCoordinator, DrainRegistry, FleetSignals, JobView,
    LocalProcessProvider, StealPolicy, _step_time_p50)
from comfyui_distributed_tpu_torch.cluster.job_store import JobStore
from comfyui_distributed_tpu_torch.cluster.job_timeout import (
    check_and_requeue_timed_out_workers)
from comfyui_distributed_tpu_torch.cluster.resilience import BREAKERS
from comfyui_distributed_tpu_torch.cluster.tile_farm import (
    TileFarm, assemble_tiles)
from comfyui_distributed_tpu_torch.telemetry import metrics as tmetrics
from torch_cpu_share import cpu_share  # noqa: F401  (autouse)

WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_fleet():
    """The breakers, the fault plan and the drain registry are global to
    the process: a worker another test drained or failed must not start
    leaving or quarantined here."""
    for reset in (BREAKERS.reset, DRAIN.reset, faults.deactivate):
        reset()
    yield
    for reset in (BREAKERS.reset, DRAIN.reset, faults.deactivate):
        reset()


def run(coro):
    return asyncio.run(coro)


def make_proc(value_scale=1.5, delay=0.0):
    """Tile i is filled with i × value_scale + 0.25: whoever computes a
    tile gives the same numbers."""
    def proc(start, end):
        if delay:
            time.sleep(delay)
        return np.stack([np.full((4, 4, 3), float(i) * value_scale + 0.25,
                                 np.float32) for i in range(start, end)])
    return proc


def counter_by_label(registry, name: str) -> dict:
    series = registry.snapshot()[name]["series"]
    return {tuple(sorted(s["labels"].items())): s["value"] for s in series}


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


# --- the lifecycle registry -----------------------------------------------------


class TestDrainRegistry:
    def test_unknown_workers_are_active(self):
        reg = DrainRegistry()
        assert reg.state("nobody") == ACTIVE
        assert not reg.is_leaving("nobody")

    def test_forward_transitions_and_reactivate(self):
        reg = DrainRegistry(clock=lambda: 100.0)
        assert reg.mark_draining("w0", deadline_s=5.0)
        assert reg.state("w0") == DRAINING
        assert reg.is_leaving("w0") and reg.is_draining("w0")
        assert reg.deadline("w0") == 105.0
        reg.mark_decommissioned("w0")
        assert reg.state("w0") == DECOMMISSIONED
        assert reg.is_leaving("w0") and not reg.is_draining("w0")
        assert reg.reactivate("w0")
        assert reg.state("w0") == ACTIVE

    def test_double_drain_is_idempotent(self):
        now = [0.0]
        reg = DrainRegistry(clock=lambda: now[0])
        assert reg.mark_draining("w0", deadline_s=10.0)
        now[0] = 5.0
        assert not reg.mark_draining("w0", deadline_s=10.0)
        assert reg.deadline("w0") == 10.0          # the first deadline

    def test_reset_clears_everything(self):
        reg = DrainRegistry()
        reg.mark_draining("a")
        reg.mark_decommissioned("b")
        reg.reset()
        assert reg.states() == {}
        assert reg.state("a") == ACTIVE

    def test_a_failing_listener_never_blocks_the_lifecycle(self):
        reg = DrainRegistry()
        calls = []
        reg.subscribe(lambda w, s: 1 / 0)
        reg.subscribe(lambda w, s: calls.append((w, s)))
        assert reg.mark_draining("w0")
        reg.unsubscribe(reg._listeners[0])
        reg.mark_decommissioned("w0")
        assert calls == [("w0", DRAINING), ("w0", DECOMMISSIONED)]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_script_same_states_and_calls_as_jax(self, seed):
        """A seeded script of transitions and clock steps gives the same
        returns, states, deadlines and listener calls in both packages."""
        rng = np.random.default_rng(seed)
        ops = ["drain", "decommission", "reactivate", "reset", "tick"]
        script = [(ops[rng.integers(len(ops))], f"w{rng.integers(3)}",
                   float(rng.integers(0, 4)) * 2.5) for _ in range(40)]

        def replay(cls):
            now = [0.0]
            reg = cls(clock=lambda: now[0])
            calls, trace = [], []
            reg.subscribe(lambda w, s: calls.append((w, s)))
            for op, wid, x in script:
                if op == "drain":
                    out = reg.mark_draining(wid, deadline_s=x or None)
                elif op == "decommission":
                    out = reg.mark_decommissioned(wid)
                elif op == "reactivate":
                    out = reg.reactivate(wid)
                elif op == "reset":
                    out = reg.reset()
                else:
                    now[0] += x
                    out = None
                trace.append((out, reg.states(),
                              {w: reg.deadline(w) for w in ("w0", "w1", "w2")},
                              {w: reg.is_leaving(w) for w in ("w0", "w1", "w2")}))
            return trace, calls

        assert replay(DrainRegistry) == replay(jstates.DrainRegistry)


# --- the steal policy -------------------------------------------------------------


class TestStealPolicy:
    VIEWS = [
        JobView("jobA", seq=1, pending=10, active_workers=2),
        JobView("jobB", seq=2, pending=3, active_workers=0),
        JobView("jobC", seq=3, pending=8, active_workers=0),
        JobView("done", seq=4, pending=0, active_workers=1),
    ]

    def test_most_starved_first(self):
        ranked = StealPolicy(seed=0).rank(self.VIEWS, "w0")
        assert [v.job_id for v in ranked] == ["jobC", "jobB", "jobA"]

    def test_deterministic_under_seed(self):
        a = StealPolicy(seed=7).rank(self.VIEWS, "w0")
        b = StealPolicy(seed=7).rank(self.VIEWS, "w0")
        assert [v.job_id for v in a] == [v.job_id for v in b]

    def test_exact_ties_settled_by_seeded_hash(self):
        views = [JobView("x", seq=1, pending=5, active_workers=0),
                 JobView("y", seq=2, pending=5, active_workers=0)]
        picks = {StealPolicy(seed=s).pick(views, "w0").job_id
                 for s in range(16)}
        assert picks == {"x", "y"}

    def test_empty_when_nothing_pending(self):
        assert StealPolicy().pick(
            [JobView("j", seq=1, pending=0, active_workers=0)], "w") is None

    @pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
    def test_pick_and_rank_equal_jax(self, seed, monkeypatch):
        """Seeded views with many exact ties: the same ranking and pick in
        both packages, under an explicit seed and under CDT_STEAL_SEED."""
        rng = np.random.default_rng(seed)
        monkeypatch.setenv("CDT_STEAL_SEED", str(seed))
        for _ in range(20):
            n = int(rng.integers(1, 12))
            rows = [(f"job{i}", i + 1, int(rng.integers(0, 4)),
                     int(rng.integers(0, 3))) for i in range(n)]
            ours = [JobView(*r) for r in rows]
            ref = [jsched.JobView(*r) for r in rows]
            for wid in ("w0", "w1", "w-steal", "a/b"):
                for mine, theirs in ((StealPolicy(seed), jsched.StealPolicy(seed)),
                                     (StealPolicy(), jsched.StealPolicy())):
                    assert mine.seed == theirs.seed == seed
                    assert [v.job_id for v in mine.rank(ours, wid)] == \
                        [v.job_id for v in theirs.rank(ref, wid)]
                    got, want = mine.pick(ours, wid), theirs.pick(ref, wid)
                    assert (got and got.job_id) == (want and want.job_id)


# --- the job store: the steal pull and the handback -------------------------------


class TestJobStoreSteal:
    def test_any_work_grants_across_jobs_with_job_id(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("a", 2)
            await store.init_tile_job("b", 3)
            seen = {"a": 0, "b": 0}
            for _ in range(5):
                task = await store.request_any_work("w0",
                                                    policy=StealPolicy(seed=1))
                assert task is not None and task["job_id"] in seen
                seen[task["job_id"]] += 1
            assert seen == {"a": 2, "b": 3}
            assert await store.request_any_work("w0") is None
        run(body())

    def test_any_work_prefers_the_starved_job(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("a", 4)
            await store.init_tile_job("b", 4)
            assert (await store.request_work("a", "w0")) is not None
            task = await store.request_any_work("w1", policy=StealPolicy(seed=0))
            assert task["job_id"] == "b"
            assert [store.tile_jobs[j].seq for j in ("a", "b")] == [1, 2]
        run(body())

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_grants_handbacks_and_events_equal_jax(self, seed):
        """A seeded sequence of pulls (named and ``*``, with exclusions),
        submissions, handbacks and requeues, counted and not: the same
        grants, returns, queues, requeue counts, dead letters and tile
        events in both stores."""
        rng = np.random.default_rng(seed)
        jobs = {"a": (7, 2), "b": (5, 1), "c": (9, 3)}
        workers = ["w0", "w1", "w2", "master"]
        script = []
        for _ in range(60):
            op = int(rng.integers(6))
            wid = workers[int(rng.integers(len(workers)))]
            jid = "abc"[int(rng.integers(3))]
            excl = sorted({"abc"[int(i)] for i in rng.integers(0, 3, 2)}
                          if rng.integers(2) else set())
            script.append((op, wid, jid, excl, int(rng.integers(1 << 16))))

        async def replay(store, policy_cls, events):
            before = events()
            out = []
            for jid, (total, chunk) in jobs.items():
                await store.init_tile_job(jid, total, chunk=chunk)
            for op, wid, jid, excl, pick in script:
                if op == 0:
                    res = await store.request_work(jid, wid)
                elif op == 1:
                    res = await store.request_any_work(
                        wid, policy=policy_cls(seed), exclude=excl)
                elif op == 2:
                    res = await store.handback_worker_tasks(wid)
                elif op == 3:
                    res = await store.requeue_worker_tasks(
                        jid, wid, count_requeue=False)
                elif op == 4:
                    res = await store.requeue_worker_tasks(
                        jid, wid, max_requeues=1)
                else:
                    held = await store.worker_held_tasks(wid)
                    res = held
                    if held.get(jid):
                        tid = held[jid][pick % len(held[jid])]
                        res = await store.submit_result(
                            jid, wid, tid, {"image": np.zeros((1, 1))})
                out.append(res)
            state = {jid: ([t.task_id for t in j.pending], dict(j.assigned),
                           dict(j.requeue_counts), sorted(j.dead_letter),
                           sorted(j.completed), j.seq)
                     for jid, j in store.tile_jobs.items()}
            return out, state, delta(events(), before)

        def ours_events():
            return counter_by_label(telemetry.REGISTRY, "cdt_tile_tasks_total")

        def jax_events():
            from comfyui_distributed_tpu.telemetry import REGISTRY
            return counter_by_label(REGISTRY, "cdt_tile_tasks_total")

        got = run(replay(JobStore(), StealPolicy, ours_events))
        want = run(replay(jstore_mod.JobStore(), jsched.StealPolicy,
                          jax_events))
        assert got[0] == want[0]
        assert got[1] == want[1]
        if telemetry.enabled():
            assert got[2] == want[2]
            assert any(k == (("event", "handed_back"),) for k in got[2])


class TestHandback:
    def test_handback_requeues_without_poison_count(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("j", 4)
            t0 = await store.request_work("j", "w0")
            t1 = await store.request_work("j", "w0")
            handed = await store.handback_worker_tasks("w0")
            assert handed == {"j": [t0["task_id"], t1["task_id"]]}
            job = store.tile_jobs["j"]
            assert [t.task_id for t in job.pending][:2] == \
                sorted([t0["task_id"], t1["task_id"]])
            assert len(job.pending) == 4
            assert job.requeue_counts == {} and job.assigned == {}
            assert await store.handback_worker_tasks("w0") == {}
        run(body())

    def test_handback_never_dead_letters(self, monkeypatch):
        monkeypatch.setenv("CDT_MAX_TILE_REQUEUES", "1")

        async def body():
            store = JobStore()
            await store.init_tile_job("j", 1)
            task = await store.request_work("j", "w0")
            store.tile_jobs["j"].requeue_counts[task["task_id"]] = 1
            handed = await store.handback_worker_tasks("w0")
            assert handed == {"j": [task["task_id"]]}
            assert store.tile_jobs["j"].dead_letter == {}
            assert store.tile_jobs["j"].requeue_counts == {task["task_id"]: 1}
        run(body())

    def test_eviction_of_draining_worker_spares_breaker_once(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("j", 3)
            await store.request_work("j", "w0")
            await store.request_work("j", "w0")
            DRAIN.mark_draining("w0")
            before = counter_by_label(telemetry.REGISTRY,
                                      "cdt_tile_worker_evictions_total")
            evicted = await check_and_requeue_timed_out_workers(
                store, "j", timeout=0.0, now=1e9)
            assert sorted(evicted["w0"]) == [0, 1]
            assert BREAKERS.state("w0") == "closed"
            job = store.tile_jobs["j"]
            assert job.requeue_counts == {} and len(job.pending) == 3
            assert await store.handback_worker_tasks("w0") == {}
            assert len(store.tile_jobs["j"].pending) == 3
            if telemetry.enabled():
                assert delta(counter_by_label(
                    telemetry.REGISTRY, "cdt_tile_worker_evictions_total"),
                    before) == {(("outcome", "draining"),): 1.0}
        run(body())

    def test_eviction_of_failed_worker_still_trips_breaker(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("j", 2)
            await store.request_work("j", "w1")
            evicted = await check_and_requeue_timed_out_workers(
                store, "j", timeout=0.0, now=1e9)
            assert evicted["w1"] == [0]
            assert BREAKERS.state("w1") == "open"
            assert store.tile_jobs["j"].requeue_counts == {0: 1}
        run(body())


class TestHealthyFraction:
    def test_draining_workers_leave_the_denominator(self):
        from comfyui_distributed_tpu_torch.cluster.frontdoor.admission import (
            breaker_healthy_fraction)

        BREAKERS.record("w0", True)
        BREAKERS.trip("w1")
        assert breaker_healthy_fraction() == 0.5
        DRAIN.mark_draining("w1")
        assert breaker_healthy_fraction() == 1.0
        DRAIN.mark_draining("w0")
        assert breaker_healthy_fraction() == 1.0


# --- the autoscaler -------------------------------------------------------------


class FakeProvider:
    def __init__(self, launchable=("w1", "w2", "w3")):
        self.pool = list(launchable)
        self.running: dict[str, str] = {}
        self.drained: list[str] = []

    def list_workers(self):
        return {w: {"state": s, "running": True}
                for w, s in self.running.items()}

    def scale_up(self):
        if not self.pool:
            return None
        wid = self.pool.pop(0)
        self.running[wid] = "active"
        return wid

    def scale_down(self, worker_id):
        self.running[worker_id] = "draining"
        self.drained.append(worker_id)


def make_scaler(signals_seq, provider=None, policy=None, t0=1000.0,
                cls=Autoscaler):
    now = {"t": t0}
    sig_iter = iter(signals_seq)
    last = {"s": None}

    def signals():
        try:
            last["s"] = next(sig_iter)
        except StopIteration:
            pass
        return last["s"]

    scaler = cls(signals, provider or FakeProvider(), policy=policy,
                 clock=lambda: now["t"])
    return scaler, now


class TestAutoscaler:
    POLICY = AutoscalePolicy(min_workers=0, max_workers=2,
                             scale_up_depth=4.0, scale_down_depth=0.5,
                             up_streak=2, down_streak=2,
                             up_cooldown_s=10.0, down_cooldown_s=10.0)

    def test_hysteresis_one_hot_tick_holds(self):
        provider = FakeProvider()
        scaler, _ = make_scaler([FleetSignals(20, 0), FleetSignals(0, 0)],
                                provider, self.POLICY)
        assert scaler.evaluate().direction == "hold"
        assert scaler.evaluate().direction == "hold"
        assert provider.running == {}

    def test_sustained_pressure_scales_up_then_cooldown(self):
        provider = FakeProvider()
        scaler, now = make_scaler([FleetSignals(20, 4)] * 10, provider,
                                  self.POLICY)
        assert scaler.evaluate().direction == "hold"
        d = scaler.evaluate()
        assert (d.direction, d.worker_id) == ("up", "w1")
        assert scaler.evaluate().direction == "hold"
        now["t"] += 11.0
        d2 = scaler.evaluate()
        assert (d2.direction, d2.worker_id) == ("up", "w2")

    def test_envelope_max_blocks(self):
        provider = FakeProvider()
        provider.running = {"w1": "active", "w2": "active"}
        scaler, _ = make_scaler([FleetSignals(50, 0, active_workers=2)] * 3,
                                provider, self.POLICY)
        scaler.evaluate()
        assert scaler.evaluate().reason == "envelope_max"

    def test_idle_fleet_drains_one_deterministically(self):
        provider = FakeProvider()
        provider.running = {"w1": "active", "w2": "active"}
        scaler, _ = make_scaler([FleetSignals(0, 0, active_workers=2)] * 3,
                                provider, self.POLICY)
        scaler.evaluate()
        d = scaler.evaluate()
        assert (d.direction, d.worker_id) == ("down", "w2")
        assert provider.drained == ["w2"]

    def test_envelope_min_blocks_drain(self):
        pol = dataclasses.replace(self.POLICY, min_workers=1,
                                  up_cooldown_s=0.0, down_cooldown_s=0.0)
        provider = FakeProvider()
        provider.running = {"w1": "active"}
        scaler, _ = make_scaler([FleetSignals(0, 0, active_workers=1)] * 3,
                                provider, pol)
        scaler.evaluate()
        assert scaler.evaluate().reason == "envelope_min"
        assert provider.drained == []

    def test_no_capacity_reported(self):
        scaler, _ = make_scaler([FleetSignals(50, 0)] * 3,
                                FakeProvider(launchable=()), self.POLICY)
        scaler.evaluate()
        assert scaler.evaluate().reason == "no_capacity"

    def test_cache_hits_discount_the_queue_not_the_tiles(self):
        sig = FleetSignals(queue_depth=8, tile_depth=3, cache_hit_rate=0.75)
        assert sig.work == 11 and sig.effective_work == 5.0
        assert FleetSignals(4, 0, cache_hit_rate=2.0).effective_work == 0.0

    def test_status_shape(self):
        scaler, _ = make_scaler([FleetSignals(2, 1, active_workers=1)],
                                FakeProvider(), self.POLICY)
        scaler.evaluate()
        st = scaler.status()
        assert st["pressure"] == 1.5
        assert st["policy"]["max_workers"] == 2
        assert st["recent_decisions"]

    def test_policy_and_knob_defaults_equal_jax(self):
        from comfyui_distributed_tpu.utils import constants as jconst
        from comfyui_distributed_tpu_torch.utils import constants as tconst

        assert dataclasses.asdict(AutoscalePolicy.from_env()) == \
            dataclasses.asdict(jauto.AutoscalePolicy.from_env())
        assert (tconst.autoscale(), tconst.scale_provider(),
                tconst.steal_seed(), tconst.drain_deadline_s(),
                tconst.autoscale_interval_s()) == (
            jconst.AUTOSCALE.get(), jconst.SCALE_PROVIDER.get(),
            jconst.STEAL_SEED.get(), jconst.DRAIN_DEADLINE_S,
            jconst.AUTOSCALE_INTERVAL_S)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
    def test_decisions_and_status_equal_jax(self, seed):
        """The same FleetSignals sequence under the same fake clock gives
        equal decisions and equal ``status()`` in both packages."""
        rng = np.random.default_rng(seed)
        policy = dict(
            min_workers=int(rng.integers(0, 2)),
            max_workers=int(rng.integers(1, 4)),
            scale_up_depth=float(rng.choice([1.0, 2.0, 4.0])),
            scale_down_depth=float(rng.choice([0.0, 0.5, 1.0])),
            up_streak=int(rng.integers(1, 3)),
            down_streak=int(rng.integers(1, 4)),
            up_cooldown_s=float(rng.choice([0.0, 5.0])),
            down_cooldown_s=float(rng.choice([0.0, 10.0])))
        sigs = [dict(queue_depth=int(rng.integers(0, 12)),
                     tile_depth=int(rng.integers(0, 6)),
                     active_workers=int(rng.integers(0, 4)),
                     draining_workers=int(rng.integers(0, 2)),
                     cache_hit_rate=float(rng.choice([0.0, 0.25, 0.9])),
                     step_time_p50=0.05)
                for _ in range(40)]
        steps = rng.choice([0.0, 1.0, 6.0], size=40)

        def replay(cls, sig_cls, pol_cls):
            scaler, now = make_scaler([sig_cls(**s) for s in sigs],
                                      FakeProvider(), pol_cls(**policy),
                                      cls=cls)
            out = []
            for dt in steps:
                out.append(dataclasses.asdict(scaler.evaluate()))
                now["t"] += float(dt)
            return out, scaler.status()

        assert replay(Autoscaler, FleetSignals, AutoscalePolicy) == \
            replay(jauto.Autoscaler, jauto.FleetSignals, jauto.AutoscalePolicy)

    def test_the_loop_survives_a_failing_tick(self):
        ticks = []

        def signals():
            ticks.append(1)
            if len(ticks) == 1:
                raise RuntimeError("config mid-write")
            return FleetSignals(0, 0)

        async def body():
            scaler = Autoscaler(signals, FakeProvider(), self.POLICY)
            task = asyncio.ensure_future(scaler.run(interval_s=0.01))
            await asyncio.sleep(0.1)
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            return scaler

        scaler = run(body())
        assert len(ticks) > 2 and scaler.decisions


class TestLocalProcessProvider:
    class Manager:
        def __init__(self, fail=()):
            self.managed, self.fail = {}, set(fail)

        def get_managed_workers(self):
            return dict(self.managed)

        def launch_worker(self, wid):
            if wid in self.fail:
                raise RuntimeError("cannot start")
            self.managed[wid] = {"pid": 1}

    def test_launches_the_first_idle_local_host_and_drains_on_down(self):
        cfg = {"hosts": [
            {"id": "r0", "type": "remote", "enabled": True},
            {"id": "w0", "type": "local", "enabled": True},
            {"id": "w1", "type": "local", "enabled": False},
            {"id": "w2", "type": "local", "enabled": True}]}
        manager = self.Manager(fail={"w0"})
        begun = []

        class Coordinator:
            def begin(self, wid):
                begun.append(wid)

        DRAIN.mark_decommissioned("w2")
        provider = LocalProcessProvider(lambda: cfg, lambda: manager,
                                        Coordinator())
        assert provider.scale_up() == "w2"          # w0 failed to start
        assert DRAIN.state("w2") == ACTIVE          # a rejoin starts clean
        assert provider.list_workers() == {
            "w0": {"state": ACTIVE, "running": False},
            "w2": {"state": ACTIVE, "running": True}}
        assert provider.scale_up() is None
        provider.scale_down("w2")
        assert begun == ["w2"]


class TestStepTimeSignal:
    def test_step_time_p50_reads_merged_histogram(self):
        for _ in range(64):
            tmetrics.SAMPLER_STEP_SECONDS.labels(pipeline="txt2img").observe(0.05)
        p50 = _step_time_p50()
        assert p50 is not None and 0.0 < p50 <= 1.0


# --- the drain coordinator ------------------------------------------------------


class TestDrainCoordinator:
    def test_clean_drain_waits_for_inflight_then_decommissions(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("j", 2)
            task = await store.request_work("j", "w0")
            stopped = []
            coord = DrainCoordinator(
                store, poll_interval=0.02,
                process_stopper=lambda w: stopped.append(w) or True,
                preempter=lambda: "p7")
            report = coord.begin("w0", deadline_s=5.0)
            assert report["phase"] == "draining" and DRAIN.is_draining("w0")
            await asyncio.sleep(0.05)
            await store.submit_result("j", "w0", task["task_id"],
                                      {"image": np.zeros((1, 4, 4, 3))})
            final = await coord.wait("w0")
            assert final["phase"] == "decommissioned"
            assert final["handed_back"] == {}
            assert final["held_at_start"] == {"j": [task["task_id"]]}
            assert final["preempted_prompt"] == "p7"
            assert final["process_stopped"] is True and stopped == ["w0"]
            assert DRAIN.state("w0") == DECOMMISSIONED
        run(body())

    def test_deadline_handback_returns_held_work(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("j", 3)
            t = await store.request_work("j", "w0")
            coord = DrainCoordinator(store, poll_interval=0.02,
                                     preempter=lambda: 1 / 0)
            coord.begin("w0", deadline_s=0.1)
            final = await coord.wait("w0")
            assert final["phase"] == "decommissioned"
            assert final["handed_back"] == {"j": [t["task_id"]]}
            assert "division" in final["preempt_error"]
            assert len(store.tile_jobs["j"].pending) == 3
            assert store.tile_jobs["j"].requeue_counts == {}
        run(body())

    def test_undrain_cancels_and_reactivates(self):
        async def body():
            store = JobStore()
            await store.init_tile_job("j", 2)
            await store.request_work("j", "w0")
            coord = DrainCoordinator(store, poll_interval=0.02)
            coord.begin("w0", deadline_s=30.0)
            await asyncio.sleep(0.05)
            assert coord.undrain("w0")
            await asyncio.sleep(0.05)
            assert DRAIN.state("w0") == ACTIVE
            assert store.tile_jobs["j"].assigned == {0: "w0"}
            assert coord.reports["w0"]["phase"] == "reactivated"
            await coord.close()
        run(body())

    def test_begin_is_idempotent_while_draining(self):
        async def body():
            coord = DrainCoordinator(JobStore(), poll_interval=0.02)
            r1 = coord.begin("w0", deadline_s=30.0)
            r2 = coord.begin("w0", deadline_s=1.0)
            assert r1["deadline_s"] == r2["deadline_s"] == 30.0
            coord.undrain("w0")
            await coord.close()
        run(body())


# --- the routes over the port's server --------------------------------------------


def _post(port, path, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
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
    tmp = tmp_path_factory.mktemp("elastic")
    (tmp / "master.json").write_text(json.dumps({"hosts": [
        {"id": "w7", "address": "http://127.0.0.1:1", "type": "local",
         "enabled": True}]}))
    controller = Controller(tmp / "master.json", device="cpu")
    server = ServerThread(controller)
    try:
        yield controller, server
    finally:
        server.stop()


def on_loop(server, coro):
    return asyncio.run_coroutine_threadsafe(coro, server.loop)


class TestDrainRoutes:
    def test_drain_route_stops_grants_and_probes(self, master):
        from comfyui_distributed_tpu_torch.cluster.dispatch import (
            select_active_hosts)

        controller, server = master
        store, port = controller.store, server.port
        on_loop(server, store.init_tile_job("j", 4)).result(WAIT_S)
        status, body = _post(port, "/distributed/request_image",
                             {"job_id": "*", "worker_id": "w0"})
        assert status == 200 and body["task"]["job_id"] == "j"
        handbacks = counter_by_label(telemetry.REGISTRY,
                                     "cdt_drain_handbacks_total")
        status, body = _post(port, "/distributed/worker/w0/drain",
                             {"deadline_s": 0.2, "stop_process": False})
        assert status == 200 and body["status"] == "draining"
        assert body["deadline_s"] == 0.2
        assert _post(port, "/distributed/request_image",
                     {"job_id": "*", "worker_id": "w0"}) == \
            (200, {"task": None, "draining": True})
        assert _post(port, "/distributed/request_image",
                     {"job_id": "j", "worker_id": "w0"}) == \
            (200, {"task": None, "draining": True})
        probes = counter_by_label(telemetry.REGISTRY, "cdt_worker_probe_total")
        online, offline = run(select_active_hosts(
            [{"id": "w0", "address": "http://127.0.0.1:1"}]))
        assert online == [] and offline[0]["_drain"] == DRAINING
        assert "w0" not in BREAKERS.states()        # no evidence recorded
        on_loop(server, controller.elastic.coordinator.wait("w0")).result(WAIT_S)
        status, st = _get(port, "/distributed/elastic")
        assert st["drain"]["states"]["w0"] == DECOMMISSIONED
        assert st["drain"]["reports"]["w0"]["handed_back"] == {"j": [0]}
        assert st["autoscale_enabled"] is False
        assert st["autoscaler"]["workers"] == {
            "w7": {"state": ACTIVE, "running": False}}
        assert len(store.tile_jobs["j"].pending) == 4
        if telemetry.enabled():
            assert delta(counter_by_label(
                telemetry.REGISTRY, "cdt_worker_probe_total"), probes) == \
                {(("outcome", "draining"),): 1.0}
            assert delta(counter_by_label(
                telemetry.REGISTRY, "cdt_drain_handbacks_total"),
                handbacks) == {(): 1.0}
            status, text = _get_text(port, "/distributed/metrics")
            assert 'cdt_worker_drain_state{worker="w0"} 2' in text
        status, body = _post(port, "/distributed/worker/w0/undrain", {})
        assert body == {"status": "active", "cleared": True}
        status, body = _post(port, "/distributed/request_image",
                             {"job_id": "*", "worker_id": "w0"})
        assert body["task"] is not None
        on_loop(server, store.cleanup_job("j")).result(WAIT_S)

    @pytest.mark.parametrize("payload", [{"deadline_s": "soon"},
                                         {"deadline_s": -1}, {"deadline_s": 0},
                                         [1]], ids=str)
    def test_drain_route_validates_deadline(self, master, payload):
        _, server = master
        status, body = _post(server.port, "/distributed/worker/w0/drain",
                             payload)
        assert status == 400, body
        assert DRAIN.state("w0") == ACTIVE

    @pytest.mark.parametrize("exclude", ["j", [1, 2], ["x"] * 257], ids=str)
    def test_steal_pull_validates_exclude_jobs(self, master, exclude):
        _, server = master
        status, body = _post(server.port, "/distributed/request_image",
                             {"job_id": "*", "worker_id": "w0",
                              "exclude_jobs": exclude})
        assert status == 400 and "exclude_jobs" in body["error"]

    def test_excluded_jobs_are_not_granted(self, master):
        controller, server = master
        on_loop(server, controller.store.init_tile_job("ex", 2)).result(WAIT_S)
        try:
            assert _post(server.port, "/distributed/request_image",
                         {"job_id": "*", "worker_id": "w0",
                          "exclude_jobs": ["ex"]}) == (200, {"task": None})
        finally:
            on_loop(server, controller.store.cleanup_job("ex")).result(WAIT_S)

    def test_local_worker_status_carries_drain_state(self, master):
        _, server = master
        DRAIN.mark_draining("w7")
        status, body = _get(server.port, "/distributed/local-worker-status")
        assert status == 200 and body["workers"]["w7"]["drain"] == DRAINING
        assert body["workers"]["w7"]["online"] is False

    @pytest.mark.parametrize("worker", [False, True])
    def test_the_autoscaler_loop_runs_on_a_master_only(self, tmp_path,
                                                       monkeypatch, worker):
        """Under CDT_AUTOSCALE=1 a master starts the loop; a worker (one its
        master launched inherits that environment) never does."""
        monkeypatch.setenv("CDT_AUTOSCALE", "1")
        monkeypatch.setenv("CDT_AUTOSCALE_INTERVAL_S", "0.05")
        if worker:
            monkeypatch.setenv("CDT_IS_WORKER", "1")
            monkeypatch.setenv("CDT_WORKER_ID", "w9")
        (tmp_path / "c.json").write_text("{}")
        controller = Controller(tmp_path / "c.json", device="cpu")
        server = ServerThread(controller)
        try:
            time.sleep(0.3)
            status, st = _get(server.port, "/distributed/elastic")
            assert st["autoscale_enabled"] is True
            assert st["autoscaler_running"] is (not worker)
            assert bool(controller.elastic.autoscaler.decisions) is (not worker)
        finally:
            server.stop()
        assert controller.elastic._task is None

    def test_elastic_routes_refuse_before_startup(self, tmp_path):
        from comfyui_distributed_tpu_torch.api.app import App, Request

        (tmp_path / "c.json").write_text("{}")
        app = App(Controller(tmp_path / "c.json", device="cpu"))
        resp = run(app.dispatch(Request("GET", "/distributed/elastic", {},
                                        b"", query={})))
        assert resp.status == 400 and "not started" in resp.payload["error"]


def _get_text(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, resp.read().decode()


# --- the steal worker's loop ------------------------------------------------------


def worker_farm():
    return TileFarm(JobStore(), asyncio.get_running_loop())


class TestStealWorkerLoop:
    def test_steal_loop_serves_both_jobs(self, master):
        controller, server = master
        base = f"http://127.0.0.1:{server.port}"
        proc_a, proc_b = make_proc(1.5), make_proc(-2.0)
        farm = controller.tile_farm
        fa = on_loop(server, farm.master_run_async(
            "jobA", total=6, process_fn=make_proc(1.5, delay=0.2), chunk=1,
            heartbeat_interval=0.2))
        fb = on_loop(server, farm.master_run_async(
            "jobB", total=6, process_fn=make_proc(-2.0, delay=0.2), chunk=1,
            heartbeat_interval=0.2))
        time.sleep(0.05)
        resolve = {"jobA": proc_a, "jobB": proc_b}.get
        done = run(_steal(base, "w0", resolve, idle_polls=2,
                          idle_interval=0.1))
        ra, rb = fa.result(WAIT_S), fb.result(WAIT_S)
        assert set(done) == {"jobA", "jobB"} and sum(done.values()) > 0
        np.testing.assert_array_equal(assemble_tiles(ra, 6, 1), np.concatenate(
            [proc_a(i, i + 1) for i in range(6)]))
        np.testing.assert_array_equal(assemble_tiles(rb, 6, 1), np.concatenate(
            [proc_b(i, i + 1) for i in range(6)]))
        status, summary = _get(server.port, "/distributed/queue_status/jobA")
        assert summary["finished"] and summary["requeue_counts"] == {}
        assert "w0" in summary["completed_by"].values()

    def test_unservable_grant_is_handed_back(self, master):
        controller, server = master
        store = controller.store
        on_loop(server, store.init_tile_job("alien", 2)).result(WAIT_S)
        try:
            done = run(_steal(f"http://127.0.0.1:{server.port}", "w0",
                              lambda jid: None, idle_polls=1,
                              idle_interval=0.05))
            assert done == {}
            job = store.tile_jobs["alien"]
            assert len(job.pending) == 2 and job.assigned == {}
            assert job.requeue_counts == {}
        finally:
            on_loop(server, store.cleanup_job("alien")).result(WAIT_S)

    def test_unservable_job_does_not_starve_servable_ones(self, master):
        controller, server = master
        store = controller.store
        on_loop(server, store.init_tile_job("A", 8)).result(WAIT_S)
        on_loop(server, store.init_tile_job("B", 3)).result(WAIT_S)
        try:
            done = run(_steal(f"http://127.0.0.1:{server.port}", "w0",
                              {"B": make_proc(2.0)}.get, idle_polls=2,
                              idle_interval=0.05))
            assert done == {"B": 3}
            assert len(store.tile_jobs["B"].completed) == 3
            job_a = store.tile_jobs["A"]
            assert len(job_a.pending) == 8
            assert job_a.assigned == {} and job_a.requeue_counts == {}
        finally:
            for jid in ("A", "B"):
                on_loop(server, store.cleanup_job(jid)).result(WAIT_S)

    def test_steal_loop_heartbeats_every_buffered_job(self, master,
                                                      monkeypatch):
        controller, server = master
        store = controller.store
        beats: list[str] = []

        async def spy_heartbeat(self, base, job_id, worker_id):
            beats.append(job_id)

        monkeypatch.setattr(TileFarm, "_heartbeat", spy_heartbeat)
        on_loop(server, store.init_tile_job("HA", 1)).result(WAIT_S)
        on_loop(server, store.init_tile_job("HB", 4)).result(WAIT_S)
        try:
            done = run(_steal(f"http://127.0.0.1:{server.port}", "w0",
                              {"HA": make_proc(1.0), "HB": make_proc(2.0)}.get,
                              max_batch=100, idle_polls=1, idle_interval=0.05))
            assert done == {"HA": 1, "HB": 4}
            assert beats.count("HA") >= 4, beats
        finally:
            for jid in ("HA", "HB"):
                on_loop(server, store.cleanup_job(jid)).result(WAIT_S)

    def test_drain_breaks_steal_loop_immediately(self, master):
        controller, server = master
        store = controller.store
        on_loop(server, store.init_tile_job("dj", 50)).result(WAIT_S)

        def proc(start, end):
            if start == 1:
                DRAIN.mark_draining("w0")
            return make_proc(1.0)(start, end)

        try:
            t0 = time.monotonic()
            done = run(asyncio.wait_for(_steal(
                f"http://127.0.0.1:{server.port}", "w0", lambda jid: proc,
                max_batch=100, idle_polls=100, idle_interval=2.0), 30))
            assert time.monotonic() - t0 < 10
            assert done == {"dj": 2}
            assert len(store.tile_jobs["dj"].completed) == 2
        finally:
            on_loop(server, store.cleanup_job("dj")).result(WAIT_S)

    def test_a_draining_pull_worker_flushes_and_leaves(self, master):
        """``worker_run`` (the dispatched worker's loop) stops pulling on
        ``draining: true`` and flushes what it holds."""
        controller, server = master
        store = controller.store
        on_loop(server, store.init_tile_job("pj", 20)).result(WAIT_S)

        def proc(start, end):
            if start == 1:
                DRAIN.mark_draining("wp")
            return make_proc(1.0)(start, end)

        async def pull():
            farm = worker_farm()
            return await farm.worker_run_async(
                "pj", "wp", f"http://127.0.0.1:{server.port}", proc)

        try:
            assert run(pull()) == 2
            job = store.tile_jobs["pj"]
            assert sorted(job.completed) == [0, 1] and job.assigned == {}
        finally:
            on_loop(server, store.cleanup_job("pj")).result(WAIT_S)


async def _steal(base, wid, resolve, **kw):
    return await worker_farm().worker_steal_run_async(wid, base, resolve, **kw)


# --- the scale event, tiny --------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_jobs():
    """Two real tile jobs on the ``tiny`` preset: a txt2img job (task i is
    one 32² image at seed 100 + i) and a USDU job (the tile engine's range
    plan over a 40×32 image). A lock runs one forward at a time, so where
    a task runs changes nothing; ``delay`` slows a host down outside it."""
    from comfyui_distributed_tpu_torch.diffusion.pipeline import GenerationSpec
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.tiles.engine import (
        TileUpscaler, UpscaleSpec)

    bundle = ModelRegistry("cpu", seed=0).get("tiny")
    ctx, _ = bundle.text_encoder.encode(["a lighthouse at dusk"])
    unc, _ = bundle.text_encoder.encode([""])
    img = torch.from_numpy(np.random.default_rng(3).random(
        (40, 32, 3)).astype(np.float32))
    ups = TileUpscaler(bundle.pipeline)
    plan = ups.range_plan(img, UpscaleSpec(scale=1.0, tile_w=16, tile_h=16,
                                           padding=4, steps=2, denoise=0.35,
                                           guidance_scale=6.0), 5, ctx, unc)
    lock = threading.Lock()
    spec = GenerationSpec(height=32, width=32, steps=2)

    def txt2img(start, end):
        return np.concatenate([bundle.pipeline.generate(
            spec, 100 + i, ctx, unc).numpy() for i in range(start, end)])

    def make(jid, delay=0.0):
        fn = txt2img if jid == "txt2img" else plan.run_range

        def proc(start, end):
            if delay:
                time.sleep(delay)
            with lock, torch.inference_mode():
                return np.asarray(fn(start, end), np.float32)
        return proc

    totals = {"txt2img": (8, 1), "usdu": (plan.num_tiles, 1)}

    async def static_fleet():
        out = {}
        for jid, (total, chunk) in totals.items():
            farm = TileFarm(JobStore(), asyncio.get_running_loop())
            res = await farm.master_run_async(f"ref-{jid}", total=total,
                                              process_fn=make(jid), chunk=chunk,
                                              heartbeat_interval=0.2)
            out[jid] = assemble_tiles(res, total, chunk)
        return out

    return {"make": make, "totals": totals, "ref": run(static_fleet())}


class TestChaosScaleEvent:
    def test_scale_event_is_lossless_and_bitwise(self, master, tiny_jobs):
        """A fleet that pulls and holds work (w1, w2), a steal worker (w0),
        a drain of w1 while it holds tiles, a rolling restart of w2 (drain,
        then undrain and rejoin) and a scale-up by the real autoscaler
        (w3, a steal worker) finish both jobs bitwise the static-fleet
        run, with nothing lost, nothing dead-lettered and no breaker open:
        every departure is planned."""
        controller, server = master
        base = f"http://127.0.0.1:{server.port}"
        make, totals = tiny_jobs["make"], tiny_jobs["totals"]
        resolve = {jid: make(jid, delay=0.05) for jid in totals}.get
        masters = {jid: on_loop(server, controller.tile_farm.master_run_async(
            jid, total=total, process_fn=make(jid, delay=0.2), chunk=chunk,
            heartbeat_interval=0.2, worker_timeout=30.0))
            for jid, (total, chunk) in totals.items()}
        coordinator = controller.elastic.coordinator

        async def post(path, payload):
            return await asyncio.to_thread(_post, server.port, path, payload)

        async def wait_drain(wid):
            return await asyncio.wrap_future(on_loop(server,
                                                     coordinator.wait(wid)))

        async def chaotic():
            for _ in range(200):
                if all(j in controller.store.tile_jobs for j in totals):
                    break
                await asyncio.sleep(0.01)

            async def hold(wid, n):
                held = []
                for _ in range(n):
                    _, body = await post("/distributed/request_image",
                                         {"job_id": "*", "worker_id": wid})
                    if body["task"]:
                        held.append((body["task"]["job_id"],
                                     body["task"]["task_id"]))
                return held

            held1, held2 = await hold("w1", 2), await hold("w2", 1)
            assert held1 and held2
            w0 = asyncio.ensure_future(_steal(base, "w0", resolve,
                                              idle_polls=3, idle_interval=0.1))
            # scale-down: drain w1 while it holds work; the deadline hands
            # its tiles back
            status, _ = await post("/distributed/worker/w1/drain",
                                   {"deadline_s": 0.2, "stop_process": False})
            assert status == 200
            report = await wait_drain("w1")
            assert sorted(t for ts in report["handed_back"].values()
                          for t in ts) == sorted(t for _, t in held1)
            # rolling restart, first half: w2 leaves
            status, _ = await post("/distributed/worker/w2/drain",
                                   {"deadline_s": 0.2, "stop_process": False})
            assert status == 200
            await wait_drain("w2")
            # scale-up: the autoscaler launches w3 off the tile backlog
            launched: dict[str, asyncio.Future] = {}

            class Provider:
                def list_workers(self):
                    return {w: {"state": DRAIN.state(w), "running": True}
                            for w in launched}

                def scale_up(self):
                    wid = f"w{3 + len(launched)}"
                    launched[wid] = asyncio.ensure_future(_steal(
                        base, wid, resolve, idle_polls=3, idle_interval=0.1))
                    return wid

                def scale_down(self, wid):
                    raise AssertionError("nothing scales down here")

            def signals():
                depth = sum(len(j.pending)
                            for j in controller.store.tile_jobs.values())
                return FleetSignals(queue_depth=0, tile_depth=depth,
                                    active_workers=len(launched))

            scaler = Autoscaler(signals, Provider(), policy=AutoscalePolicy(
                max_workers=1, up_streak=2, up_cooldown_s=0.0))
            decisions = [scaler.evaluate() for _ in range(3)]
            assert [d.direction for d in decisions].count("up") == 1
            assert decisions[1].reason == "queue_pressure"
            # rolling restart, second half: w2 rejoins under its id
            status, body = await post("/distributed/worker/w2/undrain", {})
            assert body["cleared"] is True
            w2 = asyncio.ensure_future(_steal(base, "w2", resolve,
                                              idle_polls=3, idle_interval=0.1))
            results = {jid: await asyncio.wrap_future(f)
                       for jid, f in masters.items()}
            done3 = await asyncio.wait_for(launched["w3"], WAIT_S)
            await asyncio.gather(w0, w2)
            return results, done3, report

        results, done3, report = run(chaotic())
        assert sum(done3.values()) > 0, "the scale-up worker stole nothing"
        for jid, (total, chunk) in totals.items():
            np.testing.assert_array_equal(
                assemble_tiles(results[jid], total, chunk),
                tiny_jobs["ref"][jid])
            status, summary = _get(server.port,
                                   f"/distributed/job_status?job_id={jid}")
            assert summary["finished"] and summary["dead_letter"] == []
            assert summary["completed"] == total
            assert summary["requeue_counts"] == {}
        assert all(s == "closed" for s in BREAKERS.states().values()), \
            BREAKERS.states()
        assert DRAIN.state("w1") == DECOMMISSIONED
        assert DRAIN.state("w2") == ACTIVE
