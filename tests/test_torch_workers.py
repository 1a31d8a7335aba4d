"""Managed worker processes of the port: the launch command against the
JAX package's (the same argv and env but for the module name and the
port's ``--device``), the metacharacter refusal, the process-tree kill,
the watchdog, persistence and reaping of ``managed_processes``, the
launching TTL and the first-launch host list. Children are
``sys.executable -c`` sleepers; no test here starts a controller."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from comfyui_distributed_tpu.utils.exceptions import ProcessError as JaxProcessError
from comfyui_distributed_tpu.workers import launch_builder as jlb
from comfyui_distributed_tpu_torch.utils import config as pconfig
from comfyui_distributed_tpu_torch.utils.exceptions import ProcessError
from comfyui_distributed_tpu_torch.utils.process import is_process_alive
from comfyui_distributed_tpu_torch.workers import detection
from comfyui_distributed_tpu_torch.workers import launch_builder as plb
from comfyui_distributed_tpu_torch.workers import lifecycle
from comfyui_distributed_tpu_torch.workers import process_manager as pm

MONITOR = Path(lifecycle.__file__).with_name("worker_monitor.py")
SLEEPER = [sys.executable, "-c", "import time; time.sleep(60)"]

WORKERS = [
    {"id": "w0", "address": "http://127.0.0.1:8189"},
    {"id": "w1", "address": "10.0.0.7:9001/", "extra_args": "--host 0.0.0.0"},
    {"id": "w2", "port": 8300, "address": "http://x:1", "mesh_devices": -1},
    {"id": "w3", "address": "https://w3.example:443",
     "extra_args": "--verbose 'two words'"},
]


@pytest.mark.parametrize("worker", WORKERS, ids=lambda w: w["id"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_launch_command_matches_jax_but_for_module_and_device(worker, device):
    jargv, jenv = jlb.build_launch_command(worker, 8288, "/cfg.json")
    pargv, penv = plb.build_launch_command(worker, 8288, "/cfg.json", device)
    assert jargv[:3] == [sys.executable, "-m", "comfyui_distributed_tpu"]
    assert pargv[:3] == [sys.executable, "-m", "comfyui_distributed_tpu_torch"]
    i = pargv.index("--device")
    assert pargv[i + 1] == device
    assert pargv[3:i] + pargv[i + 2:] == jargv[3:]
    assert penv == jenv
    assert set(penv) == {"CDT_IS_WORKER", "CDT_WORKER_ID", "CDT_MASTER_PID",
                         "CDT_MASTER_PORT", "CDT_CONFIG_PATH"}


def test_a_host_pinned_to_a_card_gets_cuda_visible_devices():
    _, env = plb.build_launch_command(
        {"id": "gpu1", "address": "http://127.0.0.1:8189", "cuda_device": 1},
        8288)
    assert env["CUDA_VISIBLE_DEVICES"] == "1" and "CDT_CONFIG_PATH" not in env


@pytest.mark.parametrize("bad", ["; rm -rf /", "a && b", "$(id)", "`id`",
                                 "x | y", "a > b", "~/x", "*"])
def test_shell_metacharacters_are_refused_by_both(bad):
    worker = {"id": "w", "address": "h:1", "extra_args": bad}
    with pytest.raises(JaxProcessError, match="metacharacters"):
        jlb.build_launch_command(worker, 8288)
    with pytest.raises(ProcessError, match="metacharacters"):
        plb.build_launch_command(worker, 8288)


def test_a_host_without_a_port_is_refused():
    with pytest.raises(ProcessError, match="no port"):
        plb.build_launch_command({"id": "w", "address": "host"}, 8288)


def test_kill_process_tree_terms_then_kills():
    gentle = subprocess.Popen(SLEEPER, start_new_session=True)
    stubborn = subprocess.Popen(
        [sys.executable, "-c",
         "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN);"
         " print('armed', flush=True); time.sleep(60)"],
        start_new_session=True, stdout=subprocess.PIPE)
    try:
        assert stubborn.stdout.readline().strip() == b"armed"
        assert lifecycle.kill_process_tree(gentle.pid, grace=5.0)
        t0 = time.monotonic()
        assert lifecycle.kill_process_tree(stubborn.pid, grace=0.3)
        assert time.monotonic() - t0 < 5.0
        assert gentle.wait(5) == -signal.SIGTERM
        assert stubborn.wait(5) == -signal.SIGKILL
    finally:
        for p in (gentle, stubborn):
            if p.poll() is None:
                p.kill()
        stubborn.stdout.close()


def _wait_pid_file(pid_file: Path) -> tuple[int, int]:
    for _ in range(300):
        if pid_file.exists() and "," in pid_file.read_text():
            return tuple(map(int, pid_file.read_text().split(",")))
        time.sleep(0.05)
    raise AssertionError("the monitor wrote no pid file")


def test_monitor_stops_its_worker_when_the_master_dies(tmp_path):
    master = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(1.5)"])
    pid_file = tmp_path / "pids"
    env = {**os.environ, "CDT_MASTER_PID": str(master.pid),
           "CDT_PID_FILE": str(pid_file), "CDT_MONITOR_POLL": "0.1"}
    mon = subprocess.Popen([sys.executable, str(MONITOR), *SLEEPER], env=env)
    try:
        monitor_pid, worker_pid = _wait_pid_file(pid_file)
        assert monitor_pid == mon.pid and is_process_alive(worker_pid)
        master.wait(30)
        assert mon.wait(30) == 0
        time.sleep(0.2)
        assert not is_process_alive(worker_pid)
    finally:
        for p in (master, mon):
            if p.poll() is None:
                p.kill()


def test_monitor_passes_sigterm_on_and_returns_the_worker_status(tmp_path):
    pid_file = tmp_path / "pids"
    env = {**os.environ, "CDT_MASTER_PID": str(os.getpid()),
           "CDT_PID_FILE": str(pid_file), "CDT_MONITOR_POLL": "0.1"}
    exits = subprocess.Popen([sys.executable, str(MONITOR), sys.executable,
                              "-c", "exit(3)"], env=env)
    mon = subprocess.Popen([sys.executable, str(MONITOR), *SLEEPER],
                           env={**env, "CDT_PID_FILE": str(tmp_path / "p2")},
                           start_new_session=True)
    try:
        assert exits.wait(30) == 3
        _, worker_pid = _wait_pid_file(tmp_path / "p2")
        assert lifecycle.kill_process_tree(mon.pid, grace=10.0)
        assert mon.wait(5) == 128 + signal.SIGTERM
        time.sleep(0.2)
        assert not is_process_alive(worker_pid)
    finally:
        if mon.poll() is None:
            mon.kill()


@pytest.fixture
def cfg_path(tmp_path):
    path = tmp_path / "cfg.json"
    pconfig.save_config({"master": {"port": 8288}, "hosts": [
        {"id": "w1", "address": "http://127.0.0.1:9001", "enabled": True,
         "type": "local"},
        {"id": "r1", "address": "http://10.0.0.9:9001", "enabled": True,
         "type": "remote"}]}, path)
    return path


@pytest.fixture
def fake_launch(monkeypatch):
    """``launch_worker_process`` spawning a sleeper; records its calls."""
    procs, calls = [], []

    def launch(worker, master_port, config_path=None, use_watchdog=True,
               log_dir=None, device="cuda"):
        calls.append((worker["id"], master_port, config_path, use_watchdog,
                      device))
        proc = subprocess.Popen(SLEEPER, start_new_session=True)
        procs.append(proc)
        return lifecycle.ManagedProcess(worker["id"], proc)

    monkeypatch.setattr(pm, "launch_worker_process", launch)
    yield calls
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_launch_persist_restore_reap_and_stop(cfg_path, fake_launch):
    mgr = pm.WorkerProcessManager(cfg_path, device="cpu")
    mp = mgr.launch_worker("w1")
    assert fake_launch == [("w1", 8288, str(cfg_path), True, "cpu")]
    assert mgr.get_managed_workers()["w1"]["launching"] is True
    assert pconfig.load_config(cfg_path)["managed_processes"]["w1"]["pid"] == mp.pid
    with pytest.raises(ProcessError, match="already running"):
        mgr.launch_worker("w1")
    with pytest.raises(ProcessError, match="no configured host"):
        mgr.launch_worker("nope")
    # a second manager on the same config restores the live pid
    again = pm.WorkerProcessManager(cfg_path, device="cpu")
    assert again.get_managed_workers()["w1"]["pid"] == mp.pid
    # a dead process is reaped, and the config follows
    mp.popen.kill()
    mp.popen.wait()
    assert mgr.reap_dead() == ["w1"]
    assert pconfig.load_config(cfg_path)["managed_processes"] == {}
    mgr.launch_worker("w1")
    assert mgr.clear_launching("w1") and not mgr.clear_launching("w1")
    assert mgr.get_managed_workers()["w1"]["launching"] is False
    assert mgr.stop_worker("w1") and not mgr.stop_worker("w1")
    assert mgr.get_managed_workers() == {}
    assert pconfig.load_config(cfg_path)["managed_processes"] == {}


def test_restore_drops_dead_pids(cfg_path):
    live = subprocess.Popen(SLEEPER)
    try:
        pconfig.update_config(lambda c: c.update(managed_processes={
            "alive": {"pid": live.pid, "log": "/x.log"},
            "dead": {"pid": 99999999, "log": ""}}), cfg_path)
        workers = pm.WorkerProcessManager(cfg_path).get_managed_workers()
        assert set(workers) == {"alive"} and workers["alive"]["log"] == "/x.log"
        assert set(pconfig.load_config(cfg_path)["managed_processes"]) == {"alive"}
    finally:
        live.kill()
        live.wait()


def test_the_launching_flag_expires(cfg_path, fake_launch, monkeypatch):
    mgr = pm.WorkerProcessManager(cfg_path, device="cpu")
    mgr.launch_worker("w1")
    assert mgr.is_launching("w1")
    assert pm.LAUNCHING_FLAG_TTL == 180.0
    monkeypatch.setattr(pm, "LAUNCHING_FLAG_TTL", 0.0)
    time.sleep(0.01)
    assert not mgr.is_launching("w1") and "w1" not in mgr._launching
    mgr.cleanup_all()
    assert mgr.get_managed_workers() == {}


def test_delayed_auto_launch_starts_the_enabled_local_hosts(cfg_path, fake_launch):
    mgr = pm.WorkerProcessManager(cfg_path, device="cpu")
    assert asyncio.run(pm.delayed_auto_launch(mgr, delay=0)) == []
    pconfig.update_config(
        lambda c: c["settings"].update(auto_launch_workers=True), cfg_path)
    assert asyncio.run(pm.delayed_auto_launch(mgr, delay=0)) == ["w1"]
    assert [c[0] for c in fake_launch] == ["w1"]
    mgr.cleanup_all()


def test_launch_writes_the_log_and_the_watchdog_argv(cfg_path, tmp_path,
                                                     monkeypatch):
    """``launch_worker_process`` itself, with ``Popen`` caught: the
    watchdog wraps the worker's argv, the env carries the log file."""
    seen = {}

    class FakePopen:
        pid = 4242

        def __init__(self, argv, **kw):
            seen.update(argv=argv, env=kw["env"],
                        session=kw.get("start_new_session"))

    monkeypatch.setattr(lifecycle.subprocess, "Popen", FakePopen)
    mp = lifecycle.launch_worker_process(
        {"id": "w1", "address": "http://127.0.0.1:9001"}, 8288,
        config_path=str(cfg_path), log_dir=tmp_path / "logs", device="cpu")
    assert seen["argv"][:2] == [sys.executable, str(MONITOR)]
    assert seen["argv"][2:] == plb.build_launch_command(
        {"id": "w1", "address": "http://127.0.0.1:9001"}, 8288,
        str(cfg_path), "cpu")[0]
    assert seen["session"] is True
    assert seen["env"]["CDT_LOG_FILE"] == str(mp.log_path)
    assert mp.log_path.parent == tmp_path / "logs"
    assert "launch w1" in mp.log_path.read_text()


def test_auto_populate_follows_the_cuda_rule():
    cfg = {"hosts": [{"id": "keep", "address": "http://127.0.0.1:8190"}]}
    assert detection.auto_populate_hosts(cfg, devices=[0, 1, 2, 3],
                                         master_device=1)
    added = cfg["hosts"][1:]
    assert [(h["id"], h["address"], h["cuda_device"]) for h in added] == [
        ("gpu0", "http://127.0.0.1:8189", 0), ("gpu3", "http://127.0.0.1:8191", 3)]
    assert all(h["type"] == "local" and h["enabled"] for h in added)
    assert cfg["settings"]["has_auto_populated_workers"] is True
    # the guard holds until forced
    assert not detection.auto_populate_hosts(cfg, devices=[0, 1, 4],
                                             master_device=1)
    assert detection.auto_populate_hosts(cfg, devices=[0, 1], master_device=1,
                                         force=True)
    assert len(cfg["hosts"]) == 3          # gpu0's address is taken


def test_auto_populate_on_one_card_or_none_adds_no_host(monkeypatch):
    from comfyui_distributed_tpu.workers.detection import \
        auto_populate_hosts as jax_populate

    for devices in ([], [0]):
        cfg = {"hosts": []}
        assert detection.auto_populate_hosts(cfg, devices=devices,
                                             master_device=0)
        assert cfg == {"hosts": [],
                       "settings": {"has_auto_populated_workers": True}}
    # without a card (this machine) the port's census gives what JAX's
    # rule gives without a TPU slice
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
    cfgs = [{"hosts": []}, {"hosts": []}]
    jax_populate(cfgs[0])
    detection.auto_populate_hosts(cfgs[1])
    assert json.dumps(cfgs[1]) == json.dumps(cfgs[0])
