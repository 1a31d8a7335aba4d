"""Device census and the device mesh (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package lays devices out as one ``jax.sharding.Mesh`` and runs
one SPMD program over it from one process. The port runs SPMD over
processes: one rank per device slot, rank 0 the controller, ranks 1…R−1
follower processes (``parallel/bootstrap.py``). A :class:`DeviceMesh` is
one rank's view: the axis names and sizes, this rank's coordinates, the
device it runs on, the backend and, once connected, one process group
per axis (:class:`AxisGroup`, the ranks that differ only along that
axis). Ranks are laid out in row-major order over the axes, the last
axis innermost, as ``numpy.reshape`` lays out JAX's device grid.

Rank count: ``CDT_VIRTUAL_DEVICES=n`` gives n ranks over the devices
there are (n ranks on one card, or n CPU ranks), the counterpart of
XLA's virtual host devices; without it one rank per card (one on the
CPU). A ``tp`` axis is the innermost (``{"dp": n/tp, "tp": tp}``), so
the ranks of one tensor-parallel group are neighbours; its group sums
the row-parallel products (``parallel/tensor.py``).

A program running on a rank reads the mesh through :func:`current_mesh`
(``use_mesh`` sets it), so that the collectives take an axis name, as
the JAX package's do inside ``shard_map``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Iterator, Mapping, Optional

import torch

from ..utils import constants
from ..utils.device import resolve_device
from ..utils.exceptions import ShardingError

def local_device_count(device: Optional[torch.device] = None) -> int:
    """Mesh ranks this host runs: ``CDT_VIRTUAL_DEVICES``, else one per
    card (one on the CPU)."""
    n = constants.virtual_devices()
    if n:
        return n
    if device is not None and device.type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """Rank ``local_rank``'s device: ``cuda:(local_rank % cards)``, or
    the CPU for a CPU mesh."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def device_census(device: Optional[torch.device] = None) -> list[dict]:
    """One entry per mesh rank of this host: its id, platform, kind,
    process index and device (the card unless ``device`` is the CPU)."""
    dev = resolve_device(device)
    out = []
    for i in range(local_device_count(dev)):
        d = rank_device(dev, i)
        out.append({"id": i, "platform": "gpu" if d.type == "cuda" else "cpu",
                    "kind": (torch.cuda.get_device_name(d) if d.type == "cuda"
                             else "cpu"),
                    "process_index": constants.host_index() or 0,
                    "device": str(d)})
    return out


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh shape as an ordered mapping of axis name → size; at most one
    axis may be ``-1`` ("all remaining devices")."""

    shape: tuple[tuple[str, int], ...]

    @classmethod
    def from_mapping(cls, mapping: Mapping[str, int]) -> "MeshSpec":
        items = tuple((str(k), int(v)) for k, v in mapping.items())
        if not items:
            raise ShardingError("mesh shape must have at least one axis")
        if sum(1 for _, v in items if v == -1) > 1:
            raise ShardingError("at most one mesh axis may be -1")
        for name, v in items:
            if v == 0 or v < -1:
                raise ShardingError(f"invalid size {v} for mesh axis {name!r}")
        return cls(items)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.shape)

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        """Concrete per-axis sizes for ``n_devices`` total devices."""
        sizes = [v for _, v in self.shape]
        known = math.prod(v for v in sizes if v != -1)
        if -1 in sizes:
            if n_devices % known:
                raise ShardingError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}")
            sizes[sizes.index(-1)] = n_devices // known
        elif known > n_devices:
            raise ShardingError(
                f"mesh {dict(self.shape)} needs {known} devices, have "
                f"{n_devices}")
        return tuple(sizes)


@dataclasses.dataclass
class AxisGroup:
    """The ranks of one mesh slice along ``name``: ``ranks`` in coordinate
    order, this rank at ``index``; ``pg`` their process group (None for a
    one-rank axis); ``staged``: CUDA tensors cross through host memory
    (gloo has no CUDA transport)."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    pg: Any = None
    staged: bool = False


@dataclasses.dataclass
class DeviceMesh:
    """One rank's view of the mesh (module docstring)."""

    axes: dict[str, int]
    rank: int = 0
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    backend: str = "none"
    groups: dict[str, AxisGroup] = dataclasses.field(default_factory=dict)
    # every rank of the mesh (a re-lay to one axis runs over it)
    world_group: Optional[AxisGroup] = None
    # rank 0 of a controller: the follower processes (parallel/bootstrap)
    runtime: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.axes.values())

    def coords(self, rank: Optional[int] = None) -> dict[str, int]:
        """The coordinates of ``rank`` (default this one), row-major."""
        return dict(zip(self.axes, _unravel(
            self.rank if rank is None else rank, tuple(self.axes.values()))))

    def group(self, axis: str) -> AxisGroup:
        if axis not in self.axes:
            raise ShardingError(
                f"mesh has no axis {axis!r}; axes: {self.axis_names}")
        g = self.groups.get(axis)
        if g is not None:
            return g
        if self.axes[axis] > 1:
            raise ShardingError(
                f"mesh axis {axis!r} spans {self.axes[axis]} ranks but this "
                "rank is not connected (run it through the mesh runtime)")
        return AxisGroup(axis, 1, 0, (self.rank,))


def _unravel(rank: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def axis_slices(axes: Mapping[str, int], axis: str) -> list[tuple[int, ...]]:
    """Every slice of the mesh along ``axis``: the ranks that share all
    other coordinates, in coordinate order; slices in rank order of their
    first member (the order every rank creates the groups in)."""
    names, sizes = list(axes), tuple(axes.values())
    slices: dict[tuple, list[int]] = {}
    for r in range(math.prod(sizes)):
        c = _unravel(r, sizes)
        key = tuple(v for n, v in zip(names, c) if n != axis)
        slices.setdefault(key, []).append(r)
    return [tuple(v) for v in slices.values()]


def build_mesh(spec: "MeshSpec | Mapping[str, int]",
               n_devices: Optional[int] = None,
               device: Optional[torch.device] = None) -> DeviceMesh:
    """Rank 0's mesh over ``n_devices`` ranks (default
    ``local_device_count``): the spec resolved, the ranks past its
    product unused, as JAX's ``build_mesh`` takes the first devices. It
    holds no process group yet: ``parallel/bootstrap.MeshRuntime``
    connects the ranks at the mesh's first call."""
    if not isinstance(spec, MeshSpec):
        spec = MeshSpec.from_mapping(spec)
    dev = resolve_device(device)
    n = n_devices if n_devices is not None else local_device_count(dev)
    sizes = spec.resolve(n)
    axes = dict(zip(spec.axis_names, sizes))
    return DeviceMesh(axes, 0, rank_device(dev, 0))


def mesh_from_config(config: dict, n_devices: Optional[int] = None,
                     device: Optional[torch.device] = None) -> DeviceMesh:
    """The mesh of the ``mesh.shape`` config section; with no shape the
    placement planner decides (``parallel/serving.plan_placement``:
    ``{"dp": n/tp, "tp": tp}``, tp innermost, under a pinned
    ``CDT_MESH_TP``, else the flat ``dp`` fan-out). An explicit shape
    always wins, as in the JAX package."""
    shape = (config.get("mesh") or {}).get("shape")
    dev = resolve_device(device)
    n = n_devices if n_devices is not None else local_device_count(dev)
    if not shape:
        from . import serving

        shape = serving.plan_placement(n, batch=2).mesh_shape
    return build_mesh(MeshSpec.from_mapping(shape), n, dev)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    try:
        return mesh.axes[axis]
    except KeyError:
        raise ShardingError(f"mesh has no axis {axis!r}; axes: "
                            f"{mesh.axis_names}") from None


def describe_mesh(mesh: DeviceMesh) -> dict[str, Any]:
    """JSON summary for ``system_info``: the JAX package's keys, plus the
    backend the ranks talk over, each rank's device and, on a mesh with a
    ``tp`` axis over more than one rank, its degree (``tp``)."""
    hosts = list(range(constants.num_hosts() or 1)
                 if constants.coordinator() else [0])
    return {
        "axes": dict(mesh.axes),
        "n_devices": mesh.size,
        "platform": "gpu" if mesh.device.type == "cuda" else "cpu",
        "process_indices": hosts,
        "backend": (mesh.runtime.backend if mesh.runtime is not None
                    else mesh.backend),
        "devices": [str(rank_device(mesh.device, r))
                    for r in range(mesh.size)],
        "tp": mesh.axes.get(constants.AXIS_TENSOR, 1),
    }


_CURRENT: contextvars.ContextVar[Optional[DeviceMesh]] = \
    contextvars.ContextVar("cdt_mesh", default=None)


def current_mesh() -> DeviceMesh:
    """The mesh of the program running on this rank."""
    mesh = _CURRENT.get()
    if mesh is None:
        raise ShardingError("no mesh program is running on this thread "
                            "(parallel/mesh.use_mesh)")
    return mesh


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def axis_group(axis: str) -> AxisGroup:
    """The current mesh's group along ``axis``."""
    return current_mesh().group(axis)
