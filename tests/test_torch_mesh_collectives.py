"""The port's mesh collectives and mesh attentions on pools of 2 and 4
CPU ranks over gloo (``parallel/bootstrap.MeshRuntime``: this process
rank 0, the others follower processes started once for the file), held
against the JAX package's ``shard_map`` on 2 and 4 of the 8 virtual CPU
devices, on the same inputs. Integer results exact, the rest within
2e-5; the int8 wire within JAX's ``quant_error_bound``. A follower that
raises fails its call naming its rank, and the next call succeeds, also
for a joined host's follower (``serve --host-index 1``). A call message
that is not signed with the mesh's key is refused before it is
unpickled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from comfyui_distributed_tpu.ops import attention as jattn
from comfyui_distributed_tpu.parallel import build_mesh as jbuild_mesh
from comfyui_distributed_tpu.parallel import collectives as jcoll
from comfyui_distributed_tpu.parallel import overlap as joverlap
from comfyui_distributed_tpu.utils.jax_compat import shard_map
from comfyui_distributed_tpu_torch.parallel import bootstrap
from comfyui_distributed_tpu_torch.parallel import collectives as tcoll
from comfyui_distributed_tpu_torch.parallel.bootstrap import MeshRuntime
from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh
from comfyui_distributed_tpu_torch.utils.exceptions import MeshError

from torch_cpu_share import cpu_share  # noqa: F401  (autouse)

TOL = 2e-5
AXIS = "x"


@pytest.fixture(scope="module")
def pools(cpu_share, tmp_path_factory):
    """Rank 0's runtimes of a 2-rank and a 4-rank mesh, their followers
    started at the first call and stopped at the file's end."""
    import os

    old = os.environ.get("CDT_LOG_DIR")
    os.environ["CDT_LOG_DIR"] = str(tmp_path_factory.mktemp("mesh_logs"))
    made = {n: MeshRuntime(build_mesh({AXIS: n}, n, torch.device("cpu")))
            for n in (2, 4)}
    yield made
    for rt in made.values():
        rt.stop()
    if old is None:
        os.environ.pop("CDT_LOG_DIR", None)
    else:
        os.environ["CDT_LOG_DIR"] = old


def jmesh(n):
    return jbuild_mesh({AXIS: n}, jax.devices()[:n])


def smap(body, n, in_specs, out_specs):
    """The JAX reference, jitted (eager ``shard_map`` of the ring
    collectives takes seconds a call)."""
    return jax.jit(shard_map(body, mesh=jmesh(n), in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def run(pools, n, function, inputs, **kwargs):
    """Every rank's output of the port's ``function``, rank r on
    ``inputs[r]``."""
    outs = pools[n].run("apply", None, function,
                        [tuple(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (x if isinstance(x, tuple) else (x,)))
                         for x in inputs], {"axis": AXIS, **kwargs})
    return [o.numpy() for o in outs]


def shards(x, n, dim=0):
    return np.split(np.asarray(x), n, axis=dim)


def rng(seed):
    return np.random.default_rng(seed)


NS = [2, 4]


@pytest.mark.parametrize("n", NS)
def test_gather_batch_in_participant_order(pools, n):
    x = rng(0).integers(-50, 50, size=(2 * n, 3)).astype(np.int32)
    want = np.asarray(smap(lambda a: jcoll.gather_batch(a, AXIS), n,
                           (P(AXIS, None),), P(None, None))(x))
    for out in run(pools, n, "gather_batch", shards(x, n)):
        np.testing.assert_array_equal(out, want)
    for out in run(pools, n, "all_gather", shards(x, n), dim=0):
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("shift", [1, -1, 2])
def test_ring_shift_and_shard_index(pools, n, shift):
    x = rng(1).integers(0, 100, size=(n, 2)).astype(np.int32)
    want = np.asarray(smap(
        lambda a: jcoll.ring_shift(a + jcoll.shard_index(AXIS), AXIS, shift),
        n, (P(AXIS, None),), P(AXIS, None))(x))
    got = run(pools, n, "shard_index", shards(x, n))
    moved = [run(pools, n, "ring_shift", got, shift=shift)]
    np.testing.assert_array_equal(np.concatenate(moved[0]), want)


@pytest.mark.parametrize("scale", [0.01, 1.0, 300.0])
def test_int8_wire_within_its_bound(scale):
    """One quantisation round of the ring's wire errs by at most JAX's
    ``quant_error_bound`` of the payload's absmax."""
    x = (rng(5).standard_normal((16, 16)) * scale).astype(np.float32)
    back = tcoll.wire_dequantize(*tcoll.wire_quantize(torch.from_numpy(x)))
    bound = joverlap.quant_error_bound(float(np.abs(x).max()))
    err = float(np.abs(back.numpy() - x).max())
    assert 0 < err <= bound * (1 + 1e-5), (err, bound)


def test_wire_quantize_matches_jax():
    x = (rng(6).standard_normal(64) * 5.0).astype(np.float32)
    q, s = tcoll.wire_quantize(torch.from_numpy(x))
    jq, js = joverlap.wire_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    qz, sz = tcoll.wire_quantize(torch.zeros(4))
    assert float(sz) == 0.0 and not tcoll.wire_dequantize(qz, sz).any()


@pytest.mark.parametrize("n", NS)
def test_all_to_all_heads_matches_jax(pools, n):
    x = rng(7).integers(-9, 9, size=(1, 4 * n, 2 * n, 3)).astype(np.int32)
    want = np.asarray(smap(
        lambda a: jcoll.all_to_all_heads(a, AXIS, split_dim=2, concat_dim=1),
        n, (P(None, AXIS, None, None),), P(None, None, AXIS, None))(x))
    got = run(pools, n, "all_to_all_heads", shards(x, n, 1), split_dim=2,
              concat_dim=1)
    np.testing.assert_array_equal(np.concatenate(got, axis=2), want)


def qkv(seed, n, per=12, H=4, D=8, B=1):
    r = rng(seed)
    return tuple(r.standard_normal((B, per * n, H, D)).astype(np.float32)
                 for _ in range(3))


def jax_ring(fn, n, args, specs, monkeypatch, block, quant):
    monkeypatch.setenv("CDT_RING_BLOCK", str(block))
    monkeypatch.setenv("CDT_COLLECTIVE_QUANT", quant)
    out = smap(lambda *a: fn(*a, AXIS), n, specs, P(None, AXIS, None, None))
    return np.asarray(out(*args))


# per-shard keys 12: block 5 leaves a remainder, 0 the whole hop, 12 one
# full block
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("block,quant", [(5, "none"), (0, "none"),
                                         (12, "none"), (5, "int8")])
def test_ring_attention_matches_jax(pools, n, block, quant, monkeypatch):
    q, k, v = qkv(8, n)
    seq = P(None, AXIS, None, None)
    want = jax_ring(jattn.ring_attention, n, (q, k, v), (seq, seq, seq),
                    monkeypatch, block, quant)
    got = run(pools, n, "ring_attention",
              list(zip(*(shards(a, n, 1) for a in (q, k, v)))),
              quant=quant, block=block)
    np.testing.assert_allclose(np.concatenate(got, axis=1), want, rtol=TOL,
                               atol=TOL)
    dense = np.asarray(jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v)))
    err = np.abs(np.concatenate(got, axis=1) - dense).max()
    if quant == "none":
        assert err < 1e-4
    else:
        assert 0 < err < 0.1


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("block,quant", [(5, "none"), (5, "int8")])
def test_joint_ring_attention_matches_jax(pools, n, block, quant,
                                          monkeypatch):
    q, k, v = qkv(9, n)
    T = 5
    r = rng(10)
    tq, tk, tv = (r.standard_normal((1, T, 4, 8)).astype(np.float32)
                  for _ in range(3))
    # the text queries lead every shard's queries, as in the MMDiT
    qs = [np.concatenate([tq, s], axis=1) for s in shards(q, n, 1)]
    seq, rep = P(None, AXIS, None, None), P(None, None, None, None)

    def body(qq, tkk, tvv, ik, iv, axis):
        return jattn.joint_ring_attention(qq, tkk, tvv, ik, iv, axis)

    want = jax_ring(body, n, (np.concatenate(qs, axis=1), tk, tv, k, v),
                    (seq, rep, rep, seq, seq), monkeypatch, block, quant)
    got = run(pools, n, "joint_ring_attention",
              [(qs[i], tk, tv, shards(k, n, 1)[i], shards(v, n, 1)[i])
               for i in range(n)], quant=quant, block=block)
    np.testing.assert_allclose(np.concatenate(got, axis=1), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("n", NS)
def test_ulysses_attention_matches_jax(pools, n):
    q, k, v = qkv(11, n, H=2 * n)
    seq = P(None, AXIS, None, None)
    want = np.asarray(smap(lambda *a: jattn.ulysses_attention(*a, AXIS), n,
                           (seq, seq, seq), seq)(q, k, v))
    got = run(pools, n, "ulysses_attention",
              list(zip(*(shards(a, n, 1) for a in (q, k, v)))))
    np.testing.assert_allclose(np.concatenate(got, axis=1), want, rtol=TOL,
                               atol=TOL)


def test_a_raising_follower_fails_the_call_and_the_next_succeeds(pools):
    """Rank 1's input cannot split over the ranks: it raises before the
    all-to-all and exits, rank 0's pending transfer ends, the call fails
    naming rank 1 within the group's timeout, and the followers restart
    at the next call."""
    import time

    rt = pools[2]
    good = [np.zeros((1, 4, 2, 3), np.float32)] * 2
    run(pools, 2, "all_to_all_heads", good, split_dim=2, concat_dim=1)
    bad = [good[0], np.zeros((1, 4, 3, 3), np.float32)]
    t0 = time.perf_counter()
    with pytest.raises(MeshError, match="rank 1") as err:
        run(pools, 2, "all_to_all_heads", bad, split_dim=2, concat_dim=1)
    assert err.value.rank == 1
    from comfyui_distributed_tpu_torch.parallel.bootstrap import GROUP_TIMEOUT_S

    assert time.perf_counter() - t0 < GROUP_TIMEOUT_S
    assert rt.mesh is None and not rt.procs          # torn down
    out = run(pools, 2, "all_to_all_heads", good, split_dim=2, concat_dim=1)
    assert [o.shape for o in out] == [(1, 8, 1, 3)] * 2


@pytest.mark.parametrize("n", NS)
def test_followers_load_only_the_port(pools, n):
    """A follower is ``python -m …parallel.bootstrap``: it maps no JAX
    library (this test module imports JAX, so importing it would map
    jaxlib too)."""
    from pathlib import Path

    run(pools, n, "gather_batch", [np.zeros(2, np.float32)] * n)
    procs = pools[n].procs
    assert sorted(procs) == list(range(1, n))
    for proc in procs.values():
        argv = Path(f"/proc/{proc.pid}/cmdline").read_bytes().split(b"\0")
        assert b"comfyui_distributed_tpu_torch.parallel.bootstrap" in argv
        maps = Path(f"/proc/{proc.pid}/maps").read_text()
        assert "torch" in maps and "jax" not in maps


class _Opens:
    """Unpickling this opens (creates) ``path``: what a foreign call could
    do if a follower unpickled it."""

    def __init__(self, path):
        self.path = str(path)

    def __reduce__(self):
        return (open, (self.path, "w"))


def test_channel_refuses_what_its_key_did_not_sign():
    import pickle

    store = torch.distributed.HashStore()
    mine = bootstrap.Channel(store, b"k1", "mesh1")
    mine.send("call/0", {"program": "gather_batch"})
    assert mine.recv("call/0") == {"program": "gather_batch"}
    for other in (bootstrap.Channel(store, b"k2", "mesh1"),
                  bootstrap.Channel(store, b"k1", "mesh2")):
        with pytest.raises(MeshError, match="refused"):
            other.recv("call/0")
    bootstrap.put(store, "call/1", b"\0" * 32 + pickle.dumps({"x": 1}))
    with pytest.raises(MeshError, match="refused"):
        mine.recv("call/1")
    # a signed value moved to another key is refused too
    bootstrap.put(store, "call/2", bootstrap.get(store, "call/0"))
    with pytest.raises(MeshError, match="refused"):
        mine.recv("call/2")


def test_a_foreign_call_is_refused_before_it_is_unpickled(pools, tmp_path):
    """A call written into the mesh's store by anyone without the mesh's
    key: the follower refuses it unread (the payload would have created a
    file), reports the refusal and exits; rank 0's next call fails naming
    rank 1, and the one after succeeds."""
    import pickle
    import time

    rt = pools[2]
    good = [np.zeros((2, 2), np.float32)] * 2
    run(pools, 2, "gather_batch", good)
    marker = tmp_path / "pwned"
    bootstrap.put(rt.store, f"call/{rt.seq}",
                  b"\0" * 32 + pickle.dumps(_Opens(marker)))
    proc = rt.procs[1]
    deadline = time.monotonic() + 60
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert proc.returncode == 3 and not marker.exists()
    with pytest.raises(MeshError, match="rank 1.*refused") as err:
        run(pools, 2, "gather_batch", good)
    assert err.value.rank == 1 and not marker.exists()
    assert [o.shape for o in run(pools, 2, "gather_batch", good)] == \
        [(4, 2)] * 2


def test_a_joined_hosts_follower_survives_a_failed_call(tmp_path,
                                                        monkeypatch):
    """Two joined hosts: host 0 is this process (its store injected as
    ``initialize_fn``), host 1 a ``serve --host-index 1`` process. A call
    that raises on host 1 fails naming rank 1 well within the group's
    timeout; host 1 stays up, joins the mesh's next generation and the
    next call succeeds; it exits once host 0's store is gone."""
    import datetime
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    secret = "joined-hosts-test-key"
    monkeypatch.setenv("CDT_MESH_SECRET", secret)
    monkeypatch.setattr(bootstrap, "_initialized", False)
    monkeypatch.setattr(bootstrap, "_MULTIHOST", None)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root), CDT_MESH_SECRET=secret,
               CDT_LOG_DIR=str(tmp_path), OMP_NUM_THREADS="1")
    for k in ("CDT_VIRTUAL_DEVICES", "CDT_COORDINATOR", "CDT_NUM_HOSTS",
              "CDT_HOST_INDEX"):
        env.pop(k, None)
    # the rendezvous store's server in a process of its own, so that the
    # test can take it away as host 0's exit would
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, torch\n"
         "s = torch.distributed.TCPStore('127.0.0.1', 0, 3, True,"
         " wait_for_workers=False)\n"
         "print(s.port, flush=True)\nsys.stdin.read()\n"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
    host1 = None
    try:
        address = f"127.0.0.1:{int(holder.stdout.readline())}"

        def initialize(coordinator_address, num_processes, process_id):
            host, port = coordinator_address.rsplit(":", 1)
            bootstrap._MULTIHOST = {
                "store": torch.distributed.TCPStore(
                    host, int(port), 3, False,
                    timeout=datetime.timedelta(seconds=60)),
                "world": num_processes, "rank": process_id,
                "address": coordinator_address}

        assert bootstrap.init_multihost(address, 2, 0,
                                        initialize_fn=initialize)
        log_path = tmp_path / "host1.log"
        with open(log_path, "wb") as fh:
            host1 = subprocess.Popen(
                [sys.executable, "-m", "comfyui_distributed_tpu_torch",
                 "serve", "--device", "cpu", "--coordinator", address,
                 "--num-hosts", "2", "--host-index", "1"],
                stdout=fh, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, env=env, cwd=str(tmp_path))
        rt = MeshRuntime(build_mesh({AXIS: 2}, 2, torch.device("cpu")))
        good = [(torch.zeros(1, 4, 2, 3),)] * 2
        bad = [good[0], (torch.zeros(1, 4, 3, 3),)]
        kw = {"axis": AXIS, "split_dim": 2, "concat_dim": 1}
        out = rt.run("apply", None, "all_to_all_heads", good, kw)
        assert [o.shape for o in out] == [(1, 8, 1, 3)] * 2
        t0 = time.perf_counter()
        with pytest.raises(MeshError, match="rank 1") as err:
            rt.run("apply", None, "all_to_all_heads", bad, kw)
        assert err.value.rank == 1
        assert time.perf_counter() - t0 < bootstrap.GROUP_TIMEOUT_S / 2
        assert host1.poll() is None, log_path.read_text()
        out = rt.run("apply", None, "all_to_all_heads", good, kw)
        assert [o.shape for o in out] == [(1, 8, 1, 3)] * 2
        assert rt.generation == 2
        rt.stop()
        assert host1.poll() is None
        holder.kill()                   # host 0's store is gone
        assert host1.wait(60) == 0, log_path.read_text()
    finally:
        bootstrap._MULTIHOST = None
        for proc in (holder, host1):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
