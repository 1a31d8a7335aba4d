"""Mesh ranks: the follower processes, their call loop, the multi-host
bootstrap (counterpart of the JAX package's ``parallel/bootstrap.py``).

The JAX package runs one program over every device from one process; the
port runs SPMD over processes, one rank per device slot:

- **Rank 0 is the controller.** It builds the graph, encodes the
  conditioning and drives the request. Its :class:`MeshRuntime` starts
  ranks 1…R−1 as follower processes (``python -m
  comfyui_distributed_tpu_torch.parallel.bootstrap``) at the mesh's first
  call and stops them at shutdown. Under ``serve --coordinator`` the
  followers are the ``serve --host-index i > 0`` processes of the other
  hosts (:func:`init_multihost`), and rank 0 starts none.
- **A call** (:meth:`MeshRuntime.run`): rank 0 puts the call (program
  name from ``parallel/programs.PROGRAMS``, the bundle's preset name,
  the arguments with their tensors on the host) into the rendezvous
  store. Each follower resolves the bundle from its own ``ModelRegistry``
  (the same preset, seed or files give the same weights, bit for bit),
  or, for a tensor-parallel program, its shard of it
  (``ModelRegistry.get_shard``: the slice of rank 0's parameters), says
  so, and all ranks run the program, which talks over the mesh's
  process groups (``parallel/collectives.py``). A ``dp`` program on a
  mesh with a tp axis runs on the tp-index-0 ranks alone
  (``programs.idle``). Each follower then returns its status, its
  kernel launches, seconds, card bytes and the call's peak (and, for the
  programs that return one, its result) through the store.
- **Each rank's device** is ``cuda:(local_rank % cards)``, or the CPU
  when the caller asks for it, as the tests do.
- **Backend** (:func:`choose_backend`): NCCL where every rank has a card
  of its own; gloo where ranks share a card (NCCL refuses two ranks on
  one device) or run on the CPU. Gloo has no CUDA transport, so the
  collectives stage CUDA tensors through host memory. The choice is
  explicit and shown by ``describe_mesh``; nothing falls back from one to
  the other.
- **Failure does not hang.** Every process group has a fixed timeout
  (``GROUP_TIMEOUT_S``). A follower that raises reports its error and
  exits, which ends the other ranks' pending transfers; one that hangs
  runs into the timeout. Rank 0 then fails the request with a
  ``MeshError`` naming the rank, stops the followers and starts new ones
  at the next call. A joined host's follower does not exit: it aborts
  its groups and joins the mesh's next generation (``serve_follower``),
  and exits when host 0's store is gone.

``CDT_VIRTUAL_DEVICES=n`` (``ensure_virtual_devices``) asks for n ranks
over the devices there are: on one card, n ranks on ``cuda:0``.
"""

from __future__ import annotations

import argparse
import atexit
import datetime
import hashlib
import hmac
import json
import os
import pickle
import secrets
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from ..utils import constants
from ..utils.exceptions import MeshError
from ..utils.logging import log
from .mesh import (AxisGroup, DeviceMesh, axis_slices, rank_device,
                   use_mesh)

# one fixed timeout for every collective and for a call's stragglers
GROUP_TIMEOUT_S = 180.0
# a follower's bundle build at a call (full-width models on the card)
RESOLVE_TIMEOUT_S = 900.0
# a stopped follower's exit
STOP_TIMEOUT_S = 20.0
POLL_S = 0.02
PACKAGE_ROOT = Path(__file__).resolve().parents[2]

_initialized = False
_MULTIHOST: Optional[dict] = None


def ensure_virtual_devices(n: Optional[int] = None) -> Optional[int]:
    """The rank count ``CDT_VIRTUAL_DEVICES`` asks for (None: unset). A
    mesh of virtual ranks needs at least two."""
    n = n if n is not None else constants.virtual_devices()
    if not n:
        return None
    if n < 2:
        raise ValueError(f"CDT_VIRTUAL_DEVICES={n}: a virtual mesh needs "
                         "at least 2 devices")
    log(f"virtual mesh: {n} ranks over the devices there are")
    return n


def choose_backend(device: torch.device, world: int,
                   cards: Optional[int] = None,
                   hosts: int = 1) -> str:
    """``nccl`` when every rank has a card of its own (one rank per card
    of each host), ``gloo`` on the CPU or where ranks share a card."""
    if device.type != "cuda":
        return "gloo"
    if cards is None:
        cards = torch.cuda.device_count()
    return "nccl" if world <= cards * hosts else "gloo"


def multihost_env() -> dict:
    """The multi-host settings from the environment (flags override)."""
    return {"coordinator_address": constants.coordinator() or None,
            "num_processes": constants.num_hosts(),
            "process_id": constants.host_index()}


def _store_initialize(coordinator_address: str, num_processes: int,
                      process_id: int) -> None:
    """The default ``initialize_fn``: host 0 serves the rendezvous store
    at the coordinator's address, the others connect to it."""
    global _MULTIHOST
    host, port = coordinator_address.rsplit(":", 1)
    store = torch.distributed.TCPStore(
        host, int(port), num_processes, process_id == 0,
        timeout=datetime.timedelta(seconds=RESOLVE_TIMEOUT_S),
        wait_for_workers=False)
    _MULTIHOST = {"store": store, "world": num_processes, "rank": process_id,
                  "address": coordinator_address}


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   initialize_fn: Optional[Callable] = None) -> bool:
    """Join the hosts when a coordinator is given (arguments fall back to
    ``CDT_COORDINATOR`` / ``CDT_NUM_HOSTS`` / ``CDT_HOST_INDEX``). True when
    joined, False for the single-host no-op; a second call is a no-op.
    ``initialize_fn`` is the joining function (default: the rendezvous
    store; tests inject their own)."""
    global _initialized
    env = multihost_env()
    coordinator_address = coordinator_address or env["coordinator_address"]
    if not coordinator_address:
        return False
    if _initialized:
        log("multi-host runtime already initialized; skipping")
        return True
    if num_processes is None:
        num_processes = env["num_processes"]
    if process_id is None:
        process_id = env["process_id"]
    if num_processes is None or process_id is None:
        raise ValueError(
            "multi-host bootstrap needs --num-hosts and --host-index "
            "(or CDT_NUM_HOSTS / CDT_HOST_INDEX) alongside the coordinator")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"host index {process_id} out of range for {num_processes} hosts")
    if initialize_fn is None:
        initialize_fn = _store_initialize
    log(f"initializing multi-host runtime: coordinator={coordinator_address} "
        f"hosts={num_processes} index={process_id}")
    initialize_fn(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    _initialized = True
    return True


def multihost() -> Optional[dict]:
    """The joined hosts' store, world and this host's rank (None on one
    host)."""
    return _MULTIHOST


# --- process groups ----------------------------------------------------------


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=GROUP_TIMEOUT_S)


def _make_group(store, rank: int, size: int, backend: str,
                loopback: bool):
    if backend == "nccl":
        from torch.distributed import ProcessGroupNCCL

        opts = ProcessGroupNCCL.Options()
        opts._timeout = _timeout()
        return ProcessGroupNCCL(store, rank, size, opts)
    from torch.distributed import ProcessGroupGloo

    opts = ProcessGroupGloo._Options()
    opts._timeout = _timeout()
    opts._devices = [ProcessGroupGloo.create_device(hostname="127.0.0.1")
                     if loopback else
                     ProcessGroupGloo.create_default_device()]
    return ProcessGroupGloo(store, rank, size, opts)


def connect(axes: dict, store, rank: int, device: torch.device,
            backend: str, loopback: bool = True) -> DeviceMesh:
    """This rank's mesh with one process group per axis slice it is in,
    plus the whole-mesh group (``world``); every rank creates its groups
    in the same order (``axis_slices``)."""
    from torch.distributed import PrefixStore

    mesh = DeviceMesh(dict(axes), rank, device, backend)
    staged = backend == "gloo" and device.type == "cuda"
    world = mesh.size
    if world == 1:
        return mesh
    mesh.world_group = AxisGroup(
        "world", world, rank, tuple(range(world)),
        _make_group(PrefixStore("world/", store), rank, world, backend,
                    loopback), staged)
    for axis, size in axes.items():
        if size == 1:
            continue
        for ranks in axis_slices(axes, axis):
            if rank not in ranks:
                continue
            if size == world:
                pg = mesh.world_group.pg
            else:
                pg = _make_group(PrefixStore(f"{axis}/{ranks[0]}/", store),
                                 ranks.index(rank), size, backend, loopback)
            mesh.groups[axis] = AxisGroup(axis, size, ranks.index(rank),
                                          ranks, pg, staged)
    return mesh


def relaid(mesh: DeviceMesh, axis: str) -> DeviceMesh:
    """The same ranks as a one-axis mesh ``{axis: size}`` over the
    whole-mesh group (JAX's re-lay of a mesh's devices)."""
    if tuple(mesh.axes) == (axis,):
        return mesh
    out = DeviceMesh({axis: mesh.size}, mesh.rank, mesh.device,
                     mesh.backend, runtime=mesh.runtime)
    wg = getattr(mesh, "world_group", None)
    if wg is not None:
        out.groups[axis] = AxisGroup(axis, wg.size, wg.index, wg.ranks,
                                     wg.pg, wg.staged)
        out.world_group = wg
    return out


# --- the call protocol -------------------------------------------------------

# the store takes values up to 8 MiB: a larger message goes in chunks
CHUNK = 4 << 20
MAC_BYTES = 32

# how a follower's call loop ends
STOPPED = "stopped"     # rank 0's stop call
FAILED = "failed"       # a call failed (reported to rank 0) or was refused
GONE = "gone"           # rank 0, or its store, is gone
NEWER = "newer"         # host 0 started the mesh's next generation


def put(store, key: str, value: bytes) -> None:
    """``value`` under ``key`` in chunks; readable once ``ready``."""
    n = max(1, -(-len(value) // CHUNK))
    for i in range(n):
        store.set(f"{key}#{i}", value[i * CHUNK:(i + 1) * CHUNK])
    store.set(f"{key}#n", str(n))


def ready(store, key: str) -> bool:
    return store.check([f"{key}#n"])


def get(store, key: str) -> bytes:
    n = int(store.get(f"{key}#n"))
    return b"".join(store.get(f"{key}#{i}") for i in range(n))


class Channel:
    """The pickled messages of the call protocol (calls, reports) over a
    mesh's rendezvous store, each signed with HMAC-SHA256 under the mesh's
    secret, its generation (``scope``) and its key. A value without that
    signature is refused before it is unpickled, so whoever reaches the
    store's port cannot make a rank run code of theirs, nor replay one
    generation's call in another."""

    def __init__(self, store, secret: bytes, scope: str = ""):
        self.store = store
        self.secret = secret
        self.scope = scope

    def _mac(self, key: str, payload: bytes) -> bytes:
        return hmac.new(self.secret, f"{self.scope}/{key}\0".encode()
                        + payload, hashlib.sha256).digest()

    def send(self, key: str, message: Any) -> None:
        payload = pickle.dumps(message)
        put(self.store, key, self._mac(key, payload) + payload)

    def recv(self, key: str) -> Any:
        blob = get(self.store, key)
        mac, payload = blob[:MAC_BYTES], blob[MAC_BYTES:]
        if not hmac.compare_digest(mac, self._mac(key, payload)):
            raise MeshError(f"mesh message {key!r} is not signed with this "
                            "mesh's secret: refused")
        return pickle.loads(payload)


def shared_secret() -> bytes:
    """The joined hosts' ``CDT_MESH_SECRET`` (required: their store's port
    is open to the network)."""
    secret = constants.mesh_secret()
    if not secret:
        raise MeshError("a mesh over joined hosts needs CDT_MESH_SECRET, "
                        "the same on every host")
    return secret.encode()


def close(mesh: DeviceMesh) -> None:
    """Abort this rank's process groups, so that a peer blocked in a
    transfer with it fails at once rather than at the group's timeout."""
    groups = [*mesh.groups.values(), mesh.world_group]
    pgs = {id(g.pg): g.pg for g in groups if g is not None}
    for pg in pgs.values():
        try:
            pg.abort()
        except Exception:  # noqa: BLE001 — a group already down
            pass
    mesh.groups = {}
    mesh.world_group = None


def _host(tree: Any) -> Any:
    """``tree`` with every tensor on the host (what the store carries)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def launch_snapshot() -> dict:
    from ..ops import flash_attention as fa

    return dict(fa.LAUNCHES)


def cuda_snapshot() -> dict:
    from ..ops import flash_attention as fa

    return dict(fa.CUDA_LAUNCHES)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _peak(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _allocated(device: torch.device) -> int:
    return (torch.cuda.memory_allocated(device)
            if device.type == "cuda" else 0)


def run_local(mesh: DeviceMesh, program: str, bundle, args: tuple,
              kwargs: dict) -> tuple[Any, dict]:
    """Run ``program`` on this rank under ``mesh``: its result and a
    report (the program, launches by wrapper and by CUDA kernel, seconds,
    peak and allocated card bytes, the attention geometries this process
    has chosen tiers for, and, where the program runs on the rank's
    shard, the shard's bytes and its model calls by expert)."""
    from ..ops.attention import selection_summary
    from .programs import PROGRAMS, shard_coords, shard_of
    from .tensor import cores_of, shard_bytes

    before, cuda_before = launch_snapshot(), cuda_snapshot()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        result = PROGRAMS[program](bundle, *args, **kwargs)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    report = {"program": program,
              "launches": _delta(launch_snapshot(), before),
              "cuda_launches": _delta(cuda_snapshot(), cuda_before),
              "seconds": time.perf_counter() - t0,
              "peak_bytes": _peak(mesh.device),
              "allocated_bytes": _allocated(mesh.device),
              "attn_kernels": selection_summary(),
              "shard_bytes": None}
    coords = shard_coords(program, mesh, kwargs)
    if coords is not None:
        shard = shard_of(bundle, coords)
        report["shard_bytes"] = shard_bytes(cores_of(shard))
        report["calls"] = dict(getattr(shard, "timings", {}).get("calls")
                               or {})
    return result, report


def bundle_ref(bundle) -> Any:
    """What a call carries for its bundle: a registry bundle's preset
    name (each follower builds it), else the object itself, pickled
    whole (a test's pipeline with weights of its own)."""
    name = getattr(getattr(bundle, "preset", None), "name", None)
    return name if isinstance(name, str) else _host(bundle)


class MeshRuntime:
    """Rank 0's side of a mesh of more than one rank (module docstring).
    ``seed`` and ``checkpoint_root`` are rank 0's registry's: each
    follower builds its registry with them. ``last_call`` holds the last
    call's per-rank reports."""

    def __init__(self, mesh: DeviceMesh, seed: int = 0,
                 checkpoint_root: Optional[Path] = None):
        self.axes = dict(mesh.axes)
        self.world = mesh.size
        self.device = mesh.device
        self.seed = int(seed)
        self.checkpoint_root = checkpoint_root
        mh = multihost()
        # one rank a host when the hosts are joined
        self.backend = (choose_backend(self.device, self.world)
                        if mh is None else
                        choose_backend(self.device, self.world, cards=1,
                                       hosts=mh["world"]))
        self.mesh: Optional[DeviceMesh] = None
        self.procs: dict[int, subprocess.Popen] = {}
        self.logs: dict[int, Path] = {}
        self.store = None
        self.channel: Optional[Channel] = None
        self.seq = 0
        self.generation = 0
        self.last_call: Optional[dict] = None
        self._lock = threading.Lock()
        atexit.register(self.stop)

    # -- lifetime --

    def start(self) -> DeviceMesh:
        """Start (or join) the followers and connect the groups."""
        if self.mesh is not None:
            return self.mesh
        self.generation += 1
        self.seq = 0
        mh = multihost()
        t0 = time.perf_counter()
        if mh is not None:
            from torch.distributed import PrefixStore

            if mh["world"] != self.world:
                raise MeshError(f"mesh of {self.world} ranks over "
                                f"{mh['world']} hosts (one rank a host)")
            scope = f"mesh{self.generation}"
            store = PrefixStore(f"{scope}/", mh["store"])
            self.channel = Channel(store, shared_secret(), scope)
            put(store, "axes", json.dumps(self.axes).encode())
            loopback = False
        else:
            store = torch.distributed.TCPStore(
                "127.0.0.1", 0, self.world, True, timeout=_timeout(),
                wait_for_workers=False)
            # a fresh key for each set of followers, in their environment
            secret = secrets.token_hex(32)
            self.channel = Channel(store, secret.encode())
            self._spawn(store, secret)
            loopback = True
        self.store = store
        try:
            self._await([f"hello/{r}" for r in range(1, self.world)],
                        RESOLVE_TIMEOUT_S, "start")
            self.mesh = connect(self.axes, store, 0, self.device,
                                self.backend, loopback)
            self._await([f"ready/{r}" for r in range(1, self.world)],
                        GROUP_TIMEOUT_S, "connect")
        except BaseException:
            self._stop(kill=True)
            raise
        self.mesh.runtime = self
        log(f"mesh: {self.world} ranks {self.axes} on {self.device} over "
            f"{self.backend} up in {time.perf_counter() - t0:.2f} s")
        return self.mesh

    def _spawn(self, store, secret: str) -> None:
        from ..utils.constants import log_dir

        logs = Path(log_dir())
        logs.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(PACKAGE_ROOT)] + [p for p in env.get("PYTHONPATH", "")
                                   .split(os.pathsep) if p])
        env["CDT_MESH_SECRET"] = secret
        for r in range(1, self.world):
            dev = rank_device(self.device, r)
            argv = [sys.executable, "-m", __name__,
                    "--store", f"127.0.0.1:{store.port}",
                    "--rank", str(r), "--world", str(self.world),
                    "--axes", json.dumps(self.axes), "--device", str(dev),
                    "--backend", self.backend, "--seed", str(self.seed),
                    "--threads", str(torch.get_num_threads())]
            if self.checkpoint_root is not None:
                argv += ["--checkpoint-root", str(self.checkpoint_root)]
            path = logs / f"mesh_rank{r}_{os.getpid()}.log"
            with open(path, "ab") as fh:
                self.procs[r] = subprocess.Popen(
                    argv, stdout=fh, stderr=subprocess.STDOUT, env=env,
                    stdin=subprocess.DEVNULL)
            self.logs[r] = path

    def stop(self) -> None:
        """Stop the followers (a stop call, then a kill after
        ``STOP_TIMEOUT_S``) and drop the groups; the next call starts new
        ones."""
        with self._lock:
            self._stop()

    def _stop(self, kill: bool = False) -> None:
        """``kill``: after a failure, no stop call (a follower may be
        blocked in a transfer): its process is killed at once, and rank
        0's groups are aborted (a joined host's follower then leaves its
        transfer at once)."""
        if kill:
            for proc in self.procs.values():
                if proc.poll() is None:
                    proc.kill()
            if self.mesh is not None:
                close(self.mesh)
        elif self.channel is not None and self.mesh is not None:
            try:
                self.channel.send(f"call/{self.seq}",
                                  {"program": "__stop__"})
            except Exception:  # noqa: BLE001 — a dead store stops nothing
                pass
        deadline = time.monotonic() + STOP_TIMEOUT_S
        for proc in self.procs.values():
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.procs = {}
        self.mesh = None
        self.store = None
        self.channel = None

    def _tail(self, rank: int, chars: int = 2000) -> str:
        path = self.logs.get(rank)
        if path is None or not path.is_file():
            return ""
        return path.read_bytes()[-chars:].decode("utf-8", "replace")

    def _dead(self) -> Optional[int]:
        for r, proc in self.procs.items():
            if proc.poll() is not None:
                return r
        return None

    def _await(self, keys: list[str], timeout: float, what: str) -> None:
        """Wait for every key; a follower that exits meanwhile fails the
        wait at once, naming its rank."""
        deadline = time.monotonic() + timeout
        pending = list(keys)
        while pending:
            pending = [k for k in pending if not ready(self.store, k)]
            if not pending:
                return
            dead = self._dead()
            if dead is not None:
                raise MeshError(
                    f"mesh {what}: follower rank {dead} exited (code "
                    f"{self.procs[dead].returncode}): "
                    f"{self._report_error(dead) or self._tail(dead)}",
                    rank=dead)
            if time.monotonic() > deadline:
                rank = int(pending[0].rsplit("/", 1)[1])
                raise MeshError(f"mesh {what}: rank {rank} did not answer "
                                f"within {timeout:.0f} s", rank=rank)
            time.sleep(POLL_S)

    def _report(self, seq: int, rank: int) -> dict:
        """Rank ``rank``'s report of call ``seq``; a report that is not
        signed fails the call, naming the rank."""
        try:
            return self.channel.recv(f"done/{seq}/{rank}")
        except MeshError as e:
            raise MeshError(f"rank {rank}: {e}", rank=rank) from None

    def _report_error(self, rank: int) -> Optional[str]:
        """The error a follower reported for the call in flight."""
        key = f"done/{self.seq - 1}/{rank}"
        try:
            if ready(self.store, key):
                return self._report(self.seq - 1, rank).get("error")
        except Exception as e:  # noqa: BLE001
            return str(e) if isinstance(e, MeshError) else None
        return None

    # -- calls --

    def run(self, program: str, bundle=None, *args,
            local: Optional[dict] = None, layout: Optional[str] = None,
            **kwargs) -> Any:
        """Run ``program`` on every rank and return rank 0's result.
        ``local`` holds keyword arguments for rank 0 only (the progress
        token); ``layout`` re-lays the ranks as a one-axis mesh of that
        axis (the flow node's ``sp`` over a ``dp`` mesh)."""
        with self._lock:
            mesh = self.start()
            seq = self.seq
            self.channel.send(f"call/{seq}", {
                "program": program, "bundle": bundle_ref(bundle),
                "args": _host(args), "kwargs": _host(kwargs),
                "layout": layout})
            self.seq += 1
            followers = range(1, self.world)
            try:
                self._await([f"resolved/{seq}/{r}" for r in followers],
                            RESOLVE_TIMEOUT_S, f"call {program} (resolve)")
                view = relaid(mesh, layout) if layout else mesh
                try:
                    result, own = run_local(view, program, bundle, args,
                                            {**kwargs, **(local or {})})
                except Exception as e:
                    raise self._blame(program, e) from e
                self._await([f"done/{seq}/{r}" for r in followers],
                            GROUP_TIMEOUT_S, f"call {program}")
                reports = [own]
                for r in followers:
                    report = self._report(seq, r)
                    if not report["ok"]:
                        raise MeshError(f"mesh call {program} failed on "
                                        f"rank {r}: {report['error']}",
                                        rank=r)
                    reports.append(report)
            except BaseException:
                self._stop(kill=True)
                raise
            self.last_call = {
                "program": program, "seq": seq, "backend": self.backend,
                "ranks": [{k: v for k, v in r.items() if k != "result"}
                          for r in reports]}
            if program in _RETURNS:
                return [result] + [r.get("result") for r in reports[1:]]
            return result

    def _blame(self, program: str, error: Exception) -> MeshError:
        """Rank 0's part raised: name the follower that failed first (its
        report, or its exit), else rank 0 itself."""
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            for r in range(1, self.world):
                err = self._report_error(r)
                if err:
                    return MeshError(f"mesh call {program} failed on rank "
                                     f"{r}: {err}", rank=r)
            dead = self._dead()
            if dead is not None:
                return MeshError(
                    f"mesh call {program} failed on rank {dead} (exit "
                    f"{self.procs[dead].returncode}): {self._tail(dead)}",
                    rank=dead)
            time.sleep(0.1)
        return MeshError(f"mesh call {program} failed on rank 0: "
                         f"{type(error).__name__}: {error}", rank=0)


# programs whose followers send their result back with their report
_RETURNS = {"apply", "param_digest", "shard_digest"}


# --- the follower ------------------------------------------------------------


def resolver(device: torch.device, seed: int = 0,
             checkpoint_root: Optional[str] = None) -> Callable:
    """A follower's bundles: a preset name from its own registry (built at
    the first call, kept across calls and generations), or its shard
    ``coords`` (tp index, tp size) of it, else the object the call
    carried."""
    registry = None

    def resolve(bundle, coords: Optional[tuple] = None):
        nonlocal registry
        if not isinstance(bundle, str):
            return bundle
        if registry is None:
            from ..models.registry import ModelRegistry

            registry = ModelRegistry(device, seed=seed,
                                     checkpoint_root=checkpoint_root)
        if coords is not None:
            return registry.get_shard(bundle, *coords)
        return registry.get(bundle)

    return resolve


def _fail(channel: Channel, seq: int, rank: int, error: str) -> None:
    try:
        channel.send(f"done/{seq}/{rank}", {"ok": False, "error": error})
    finally:
        sys.stdout.flush()
        sys.stderr.flush()


def follower_loop(channel: Channel, mesh: DeviceMesh, resolve: Callable,
                  leave: Callable[[], Optional[str]]) -> str:
    """Serve rank 0's calls until a stop call (``STOPPED``), a failed or
    refused call (``FAILED``, reported to rank 0), rank 0's store going
    away (``GONE``) or what ``leave`` returns while no call is pending
    (rank 0's exit, a newer generation)."""
    rank = mesh.rank
    seq = 0
    while True:
        key = f"call/{seq}"
        try:
            while not ready(channel.store, key):
                why = leave()
                if why:
                    log(f"mesh rank {rank}: leaving ({why})")
                    return why
                time.sleep(POLL_S)
            call = channel.recv(key)
        except MeshError as e:
            log(f"mesh rank {rank}: {e}")
            _fail(channel, seq, rank, str(e))
            return FAILED
        except (RuntimeError, OSError) as e:
            log(f"mesh rank {rank}: rank 0's store is gone ({e})")
            return GONE
        if call["program"] == "__stop__":
            return STOPPED
        try:
            from .programs import idle, shard_coords

            view = relaid(mesh, call["layout"]) if call["layout"] else mesh
            if idle(call["program"], view, call["layout"]):
                put(channel.store, f"resolved/{seq}/{rank}", b"1")
                channel.send(f"done/{seq}/{rank}", {
                    "ok": True, "program": call["program"], "idle": True,
                    "launches": dict.fromkeys(launch_snapshot(), 0),
                    "cuda_launches": dict.fromkeys(cuda_snapshot(), 0),
                    "seconds": 0.0,
                    "peak_bytes": _peak(mesh.device),
                    "allocated_bytes": _allocated(mesh.device),
                    "shard_bytes": None})
                seq += 1
                continue
            if mesh.device.type == "cuda":
                # the report's peak is this call's, its resolve included
                torch.cuda.reset_peak_memory_stats(mesh.device)
            bundle = resolve(call["bundle"], shard_coords(
                call["program"], view, call["kwargs"]))
            put(channel.store, f"resolved/{seq}/{rank}", b"1")
            result, report = run_local(view, call["program"], bundle,
                                       call["args"], call["kwargs"])
            report["ok"] = True
            if call["program"] in _RETURNS:
                report["result"] = _host(result)
            channel.send(f"done/{seq}/{rank}", report)
        except BaseException as e:  # noqa: BLE001 — reported, then left
            import traceback

            traceback.print_exc()
            _fail(channel, seq, rank, f"{type(e).__name__}: {e}")
            return FAILED
        seq += 1


def follower_main(argv: Optional[list[str]] = None) -> int:
    """A local follower process: connect to rank 0's store and serve its
    calls (``MeshRuntime._spawn`` starts it, with the mesh's key in
    ``CDT_MESH_SECRET``). Exits 3 after a failed call, else 0."""
    p = argparse.ArgumentParser(prog="cdt-mesh-follower")
    p.add_argument("--store", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--axes", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--backend", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-root", default=None)
    p.add_argument("--threads", type=int, default=0)
    args = p.parse_args(argv)
    parent = os.getppid()
    if args.threads > 0:
        torch.set_num_threads(args.threads)
    device = torch.device(args.device)
    if device.type == "cuda":
        from ..utils.device import use_full_fp32

        torch.cuda.set_device(device)
        use_full_fp32()
    secret = constants.mesh_secret()
    if not secret:
        raise MeshError("a mesh follower needs its mesh's CDT_MESH_SECRET")
    host, port = args.store.rsplit(":", 1)
    store = torch.distributed.TCPStore(host, int(port), args.world, False,
                                       timeout=_timeout())
    put(store, f"hello/{args.rank}", b"1")
    mesh = connect(json.loads(args.axes), store, args.rank, device,
                   args.backend)
    put(store, f"ready/{args.rank}", b"1")
    log(f"mesh rank {args.rank}/{args.world} on {device} over "
        f"{args.backend}")
    outcome = follower_loop(
        Channel(store, secret.encode()), mesh,
        resolver(device, args.seed, args.checkpoint_root),
        leave=lambda: GONE if os.getppid() != parent else None)
    return 3 if outcome == FAILED else 0


def _published(base, generation: int) -> bool:
    from torch.distributed import PrefixStore

    return ready(PrefixStore(f"mesh{generation}/", base), "axes")


def serve_follower(device: torch.device, seed: int = 0,
                   checkpoint_root: Optional[str] = None) -> int:
    """``serve --host-index i > 0``: this host's rank of the joined
    hosts' mesh (``init_multihost`` first), serving host 0's calls. Each
    time host 0 starts the mesh (a generation) this rank joins it; after
    a stop, a failed call or a newer generation it waits for the next
    one. It returns 0 when host 0's store is gone."""
    from torch.distributed import PrefixStore

    mh = multihost()
    if mh is None or mh["rank"] == 0:
        raise MeshError("serve_follower needs init_multihost on a host "
                        "index > 0")
    secret = shared_secret()
    rank, world = mh["rank"], mh["world"]
    base = mh["store"]
    backend = choose_backend(device, world, cards=1, hosts=world)
    resolve = resolver(device, seed, checkpoint_root)
    generation = 1
    while True:
        mesh = None
        try:
            # host 0 publishes the mesh's axes when it starts the mesh;
            # join the newest generation it has started
            while not _published(base, generation):
                if _published(base, generation + 1):
                    generation += 1
                time.sleep(POLL_S)
            while _published(base, generation + 1):
                generation += 1
            scope = f"mesh{generation}"
            store = PrefixStore(f"{scope}/", base)
            axes = json.loads(get(store, "axes").decode())
            put(store, f"hello/{rank}", b"1")
            mesh = connect(axes, store, rank, device, backend,
                           loopback=False)
            put(store, f"ready/{rank}", b"1")
            outcome = follower_loop(
                Channel(store, secret, scope), mesh, resolve,
                leave=lambda g=generation: (NEWER if _published(base, g + 1)
                                            else None))
        except (RuntimeError, OSError) as e:
            try:
                base.check(["_"])
                outcome = FAILED
            except (RuntimeError, OSError):
                outcome = GONE
            log(f"mesh rank {rank}: generation {generation} ended ({e})")
        finally:
            if mesh is not None:
                close(mesh)
        if outcome == GONE:
            log(f"mesh rank {rank}: host 0's store is gone; exiting")
            return 0
        generation += 1


if __name__ == "__main__":
    sys.exit(follower_main())
