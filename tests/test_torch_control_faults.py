"""Two control-plane faults of the port, each held here: a stalled device
backend must not freeze ``/distributed/system_info`` (it answers the
host facts, ``environment`` included, and a degraded device list within
the deadline, as the JAX package's route does), and the probe and
preparation concurrencies are knobs (``CDT_PROBE_CONCURRENCY``,
``CDT_PREP_CONCURRENCY``) read at every site that bounds a semaphore."""

import asyncio
import json
import threading
import time

import pytest
import torch

from comfyui_distributed_tpu_torch.api.app import App, Request
from comfyui_distributed_tpu_torch.cluster import dispatch
from comfyui_distributed_tpu_torch.cluster.controller import Controller
from comfyui_distributed_tpu_torch.cluster.job_store import JobStore
from comfyui_distributed_tpu_torch.cluster.orchestration import Orchestrator
from comfyui_distributed_tpu_torch.utils import deadline
from comfyui_distributed_tpu_torch.utils.constants import KnobError
from comfyui_distributed_tpu_torch.workers import detection


def get(app, path):
    return asyncio.run(app.dispatch(Request("GET", path, {}, b"")))


@pytest.fixture
def controller(tmp_path):
    (tmp_path / "c.json").write_text("{}")
    return Controller(tmp_path / "c.json", device="cpu")


def test_system_info_carries_the_environment(controller, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    info = get(App(controller), "/distributed/system_info").payload
    env = info["environment"]
    assert env["machine_id"] == info["machine_id"]
    assert env["kubernetes"] is True
    assert env["cuda"]["cuda_visible_devices"] == "0"
    assert isinstance(env["docker"], bool) and env["docker"] == info["is_docker"]
    assert info["devices"] == []          # no card here
    assert json.dumps(info)               # JSON all the way down


def test_docker_is_also_read_from_the_init_cgroup(monkeypatch, tmp_path):
    cgroup = tmp_path / "cgroup"
    cgroup.write_text("0::/docker/abc123\n")
    real = detection.Path

    def fake_path(p):
        if str(p) == "/.dockerenv":
            return real(tmp_path / "absent")
        if str(p) == "/proc/1/cgroup":
            return real(cgroup)
        return real(p)

    monkeypatch.setattr(detection, "Path", fake_path)
    assert detection.is_docker()
    cgroup.write_text("0::/\n")
    assert not detection.is_docker()


def test_device_routes_degrade_when_backend_hangs(controller, monkeypatch):
    """A wedged driver makes the census block; the three device routes
    answer degraded within the deadline instead of freezing the loop."""
    deadline.reset_gate()
    release = threading.Event()
    monkeypatch.setattr(Controller, "system_info",
                        lambda self: release.wait(30))
    app = App(controller)
    try:
        t0 = time.monotonic()
        info = get(app, "/distributed/system_info").payload
        assert time.monotonic() - t0 < 10
        assert info["devices"][0]["error"]
        assert "machine_id" in info and "environment" in info
        t0 = time.monotonic()
        net = get(app, "/distributed/network_info").payload
        assert time.monotonic() - t0 < 2
        assert net["devices"][0]["error"]
        assert get(app, "/distributed/memory_stats").payload[
            "devices"][0]["error"]
    finally:
        release.set()
        deadline.reset_gate()


@pytest.mark.parametrize("stuck", ["is_available", "get_device_name"])
def test_a_stalled_driver_call_leaves_the_routes_answering(
        controller, monkeypatch, stuck):
    """The driver itself stalls (``torch.cuda.is_available``, or a card
    that is there and then does not name itself): the degraded payload
    makes no driver call, so the routes still answer within the
    deadline, and the card's name and driver wait for the census."""
    deadline.reset_gate()
    release = threading.Event()

    def blocked(*_):
        release.wait(30)
        return True

    monkeypatch.setattr(torch.cuda, "is_available",
                        blocked if stuck == "is_available" else lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", blocked)
    app = App(controller)
    try:
        t0 = time.monotonic()
        info = get(app, "/distributed/system_info").payload
        assert time.monotonic() - t0 < 10
        assert info["devices"][0]["error"]
        assert info["environment"]["cuda"].keys() <= {
            "cuda_visible_devices", "nvidia_visible_devices"}
        t0 = time.monotonic()
        for path in ("/distributed/network_info", "/distributed/memory_stats",
                     "/distributed/system_info"):
            assert get(app, path).payload["devices"][0]["error"]
        assert get(app, "/distributed/health").payload["status"] == "ok"
        assert time.monotonic() - t0 < 2
    finally:
        release.set()
        deadline.reset_gate()


@pytest.fixture
def semaphores(monkeypatch):
    """Every ``asyncio.Semaphore`` made meanwhile records its bound."""
    bounds = []
    real = asyncio.Semaphore

    class Recording(real):
        def __init__(self, value=1):
            bounds.append(value)
            super().__init__(value)

    monkeypatch.setattr(asyncio, "Semaphore", Recording)
    return bounds


@pytest.mark.parametrize("probe,prep", [("3", "2"), (None, None)])
def test_the_concurrency_knobs_bound_their_semaphores(
        semaphores, monkeypatch, controller, probe, prep):
    for var, value in (("CDT_PROBE_CONCURRENCY", probe),
                       ("CDT_PREP_CONCURRENCY", prep)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    want_probe = int(probe or 10)
    want_prep = int(prep or 4)

    asyncio.run(dispatch.select_active_hosts([]))
    assert semaphores[-1] == want_probe
    # orchestration's fallbacks, for a config without the settings
    orch = Orchestrator(JobStore(), controller.queue,
                        config_loader=lambda: {"hosts": []})
    semaphores.clear()
    asyncio.run(orch.orchestrate({"1": {"class_type": "PrimitiveInt",
                                        "inputs": {"value": 1}}}))
    assert semaphores == [want_probe, want_prep]
    # local-worker-status's fan-out cap
    semaphores.clear()
    get(App(controller), "/distributed/local-worker-status")
    assert semaphores == [want_probe]


@pytest.mark.parametrize("var", ["CDT_PROBE_CONCURRENCY",
                                 "CDT_PREP_CONCURRENCY"])
def test_a_garbage_concurrency_raises(monkeypatch, var):
    from comfyui_distributed_tpu_torch.utils import constants

    monkeypatch.setenv(var, "many")
    read = (constants.worker_probe_concurrency
            if var == "CDT_PROBE_CONCURRENCY"
            else constants.worker_prep_concurrency)
    with pytest.raises(KnobError, match=var):
        read()


def test_the_driver_version_comes_from_a_probe_that_nobody_waits_on(
        monkeypatch, tmp_path):
    """Without the driver in ``/proc``, ``nvidia-smi`` is asked once on a
    thread of its own; ``driver_version`` answers None until it has
    answered, and its answer after."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\nsleep 1\necho 550.54.15\n")
    smi.chmod(0o755)
    real = detection.Path
    monkeypatch.setattr(detection, "Path", lambda p: real(tmp_path / "absent")
                        if str(p) == "/proc/driver/nvidia/version" else real(p))
    monkeypatch.setattr(detection.shutil, "which",
                        lambda name: str(smi) if name == "nvidia-smi" else None)
    monkeypatch.setattr(detection, "_smi_answer", [])
    monkeypatch.setattr(detection, "_smi_started", threading.Event())
    t0 = time.monotonic()
    detection.start_driver_probe()
    detection.start_driver_probe()          # once a process
    assert detection.driver_version() is None
    assert time.monotonic() - t0 < 0.5
    while detection.driver_version() is None and time.monotonic() - t0 < 20:
        time.sleep(0.05)
    assert detection.driver_version() == "550.54.15"
    assert detection._smi_answer == ["550.54.15"]


def test_health_reports_the_front_door_and_the_cache_as_jax_does(
        tmp_path, monkeypatch):
    """``GET /distributed/health`` carries ``frontdoor`` (depth,
    coalescing) and ``cache`` (hit rate, fleet ring size) with the value
    types of a JAX ``Controller.health()``, each None with its subsystem
    off."""
    from comfyui_distributed_tpu.cluster.controller import (
        Controller as JController)
    from comfyui_distributed_tpu.utils import config as jconfig

    monkeypatch.setenv(jconfig.CONFIG_ENV, str(tmp_path / "j.json"))
    jconfig.invalidate_cache()
    jc = JController()
    try:
        want = jc.health()
    finally:
        if jc.cache is not None and jc.cache.fleet is not None:
            jc.cache.fleet.close()
        jconfig.invalidate_cache()
    (tmp_path / "c.json").write_text("{}")
    c = Controller(tmp_path / "c.json", device="cpu")
    health = get(App(c), "/distributed/health").payload
    for part in ("frontdoor", "cache"):
        assert sorted(health[part]) == sorted(want[part]), part
        for key, value in health[part].items():
            assert type(value) is type(want[part][key]), (part, key)
    assert health["cache"] == {"hit_rate": 0.0, "fleet_ring": 1}
    assert health["frontdoor"] == {"depth": 0, "coalescing": 0}
    monkeypatch.setenv("CDT_FRONTDOOR", "0")
    monkeypatch.setenv("CDT_CACHE", "0")
    off = get(App(Controller(tmp_path / "c.json", device="cpu")),
              "/distributed/health").payload
    assert off["frontdoor"] is None and off["cache"] is None
    monkeypatch.delenv("CDT_FRONTDOOR")
    monkeypatch.delenv("CDT_CACHE")
    monkeypatch.setenv("CDT_FLEET_CACHE", "0")
    alone = get(App(Controller(tmp_path / "c.json", device="cpu")),
                "/distributed/health").payload
    assert alone["cache"] == {"hit_rate": 0.0, "fleet_ring": 0}
