"""The shape catalog: the set of program keys a worker should be hot for
(the port's copy of the JAX package's ``cluster/shape_catalog.py``).

A key names one (pipeline family, model, resolution, step count, batch,
frames, mesh) program. The JAX package compiles one XLA program per key;
eager PyTorch compiles nothing ahead of time but its CUDA kernels, yet a
cold worker still pays, on its first request of a key, the bundle's
build, the kernel library's load (and its ``nvcc`` build where the build
directory lacks it) and the first calls of cuDNN and cuBLAS at those
shapes. The warm pass (``diffusion/warmup.py``) walks the catalog off the
request path, so the first request of each key finds all of it done.

The catalog is:

- **seeded** from the shipped ``workflows/`` (the shapes the product
  serves; :func:`keys_from_prompt`),
- **grown** from the shapes the request path meets (the sampler nodes and
  the group executors call :func:`observe`), up to
  ``CDT_SHAPE_CATALOG_MAX`` entries,
- **persisted** as JSON (union on load, atomic tmp + rename on save), in
  the JAX package's file format, so one file reads in both packages.
  Default path: ``CDT_OUTPUT_DIR/shape_catalog_torch.json``
  (``CDT_SHAPE_CATALOG`` overrides it).

Keys with a ``mesh`` and the ``flow_sp`` / ``flow_tp`` families are kept
and listed; a controller mesh of more than one rank warms the mesh
tier's keys (``diffusion/warmup.mesh_tier_keys``), building every rank's
bundle or shard. ``CDT_SHAPE_OBSERVE=0`` turns observation off.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from typing import Iterable, Optional

from ..utils import constants
from ..utils.jsonio import atomic_write_json, read_json
from ..utils.logging import debug_log, log

CATALOG_VERSION = 1

# the telemetry ``pipeline`` label's vocabulary; flow_sp / flow_tp are the
# JAX package's sequence- and weight-sharded flow programs
PIPELINES = ("txt2img", "flow_dp", "video_dp", "flow_sp", "flow_tp")


@dataclasses.dataclass(frozen=True, order=True)
class ProgramKey:
    """One program's identity. ``mesh`` is a sorted tuple of (axis, size)
    pairs, () the host's default (one card here); ``frames`` is 0 for
    image pipelines."""

    pipeline: str
    model: str
    height: int
    width: int
    steps: int
    batch: int = 1
    frames: int = 0
    mesh: tuple = ()

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline family {self.pipeline!r}; "
                             f"have {PIPELINES}")

    def to_dict(self) -> dict:
        return {"pipeline": self.pipeline, "model": self.model,
                "height": self.height, "width": self.width,
                "steps": self.steps, "batch": self.batch,
                "frames": self.frames,
                "mesh": [list(ax) for ax in self.mesh]}

    @classmethod
    def from_dict(cls, d: dict) -> "ProgramKey":
        return cls(pipeline=str(d["pipeline"]), model=str(d["model"]),
                   height=int(d["height"]), width=int(d["width"]),
                   steps=int(d["steps"]), batch=int(d.get("batch", 1)),
                   frames=int(d.get("frames", 0)),
                   mesh=tuple((str(a), int(n))
                              for a, n in d.get("mesh", ())))

    @property
    def single_card(self) -> bool:
        """A program of one card (the mesh tier's keys need a controller
        mesh of more than one rank: ``diffusion/warmup._runnable``)."""
        return not self.mesh and self.pipeline in ("txt2img", "flow_dp",
                                                   "video_dp")


def default_catalog_path() -> Path:
    env = constants.shape_catalog()
    if env:
        return Path(env)
    return Path(constants.output_dir()) / "shape_catalog_torch.json"


class ShapeCatalog:
    """A deduplicated, persisted set of :class:`ProgramKey`. Thread-safe:
    the graph thread and the stage pools observe while a warm pass reads."""

    def __init__(self, path: "Path | str | None" = None,
                 autoload: bool = True):
        self.path = Path(path) if path is not None else default_catalog_path()
        self._keys: set[ProgramKey] = set()
        self._lock = threading.Lock()
        if autoload:
            self.load()

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: ProgramKey) -> bool:
        return key in self._keys

    def entries(self) -> list[ProgramKey]:
        """Sorted: every host walks the catalog in the same order."""
        with self._lock:
            return sorted(self._keys)

    def add(self, key: ProgramKey) -> bool:
        """Add one key; True when it was new."""
        with self._lock:
            if key in self._keys:
                return False
            self._keys.add(key)
            return True

    def update(self, keys: Iterable[ProgramKey]) -> int:
        return sum(self.add(k) for k in keys)

    def load(self) -> int:
        """Merge the file's entries in (a union: another process may have
        written since). A missing or garbled file loads nothing."""
        raw = read_json(self.path)
        try:
            entries = raw.get("entries", [])
        except AttributeError:
            return 0
        added = 0
        for d in entries:
            try:
                added += self.add(ProgramKey.from_dict(d))
            except (KeyError, TypeError, ValueError):
                debug_log(f"shape catalog: skipping malformed entry {d!r}")
        return added

    def save(self) -> bool:
        """Load first (concurrent writers union), then write atomically.
        Never raises."""
        self.load()
        with self._lock:
            payload = {"version": CATALOG_VERSION,
                       "entries": [k.to_dict() for k in sorted(self._keys)]}
        if atomic_write_json(self.path, payload):
            return True
        debug_log(f"shape catalog: save to {self.path} failed")
        return False

    def seed_from_workflows(self, workflows_dir: "Path | str | None" = None
                            ) -> int:
        """Add the keys of the shipped workflow files; returns how many
        were new."""
        if workflows_dir is None:
            env = constants.workflows_dir()
            workflows_dir = (Path(env) if env else
                             Path(__file__).resolve().parents[2] / "workflows")
        d = Path(workflows_dir)
        if not d.is_dir():
            return 0
        added = 0
        for path in sorted(d.glob("*.json")):
            try:
                prompt = json.loads(path.read_text())
            except (OSError, ValueError):
                debug_log(f"shape catalog: unreadable workflow {path}")
                continue
            added += self.update(keys_from_prompt(prompt))
        return added


# node class → (pipeline family, has frames). The img2img and tile nodes'
# shapes come from their inputs: observation covers those.
_SAMPLER_NODES = {
    "TPUTxt2Img": ("txt2img", False),
    "TPUFlowTxt2Img": ("flow_dp", False),
    "TPUTxt2Video": ("video_dp", True),
}


def _literal_int(v, default=None) -> Optional[int]:
    """Only literals are known statically (an input may be a link)."""
    if isinstance(v, bool):
        return default
    if isinstance(v, (int, float)):
        return int(v)
    return default


def keys_from_prompt(prompt: dict) -> list[ProgramKey]:
    """The program keys a workflow or prompt names statically; a sampler
    whose geometry rides a link is skipped."""
    out = []
    nodes = {k: v for k, v in prompt.items()
             if isinstance(v, dict) and "class_type" in v}
    for node in nodes.values():
        family = _SAMPLER_NODES.get(node.get("class_type", ""))
        if family is None:
            continue
        pipeline, has_frames = family
        inputs = node.get("inputs", {})
        model = _resolve_model_name(inputs.get("model"), nodes)
        h = _literal_int(inputs.get("height"))
        w = _literal_int(inputs.get("width"))
        steps = _literal_int(inputs.get("steps"))
        if not model or None in (h, w, steps):
            continue
        frames = _literal_int(inputs.get("frames"), 0) if has_frames else 0
        batch = _literal_int(inputs.get("batch_per_device"), 1) or 1
        out.append(ProgramKey(pipeline=pipeline, model=model, height=h,
                              width=w, steps=steps, batch=batch,
                              frames=frames or 0))
    return out


def _resolve_model_name(link, nodes: dict) -> Optional[str]:
    """A ``model`` link's ``CheckpointLoader`` ``ckpt_name`` (one hop)."""
    if not (isinstance(link, (list, tuple)) and len(link) == 2):
        return None
    src = nodes.get(str(link[0]))
    if src is None or src.get("class_type") != "CheckpointLoader":
        return None
    name = src.get("inputs", {}).get("ckpt_name")
    return name if isinstance(name, str) and name else None


# --- runtime observation -------------------------------------------------------

_default: Optional[ShapeCatalog] = None
_default_lock = threading.Lock()


def default_catalog() -> ShapeCatalog:
    """The process's catalog (its path resolved at first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ShapeCatalog()
        return _default


def reset_default_catalog() -> None:
    """Drop the process's catalog, so that the next use reads the path
    knobs again."""
    global _default
    with _default_lock:
        _default = None


def observe(pipeline: str, model: str, height: int, width: int,
            steps: int, batch: int = 1, frames: int = 0) -> None:
    """Record a shape the request path served. A new key is saved at
    once, so the next boot warms it; a known one is a set lookup. Growth
    stops at ``CDT_SHAPE_CATALOG_MAX`` (the first observed stay). Never
    raises; nothing under ``CDT_SHAPE_OBSERVE=0``."""
    try:
        if not constants.shape_observe():
            return
        cat = default_catalog()
        key = ProgramKey(pipeline=pipeline, model=model, height=int(height),
                         width=int(width), steps=int(steps),
                         batch=int(batch), frames=int(frames))
        if key in cat:
            return
        cap = constants.shape_catalog_max()
        if cap and len(cat) >= cap:
            debug_log(f"shape catalog: at its cap ({cap}); not observing "
                      f"{key}")
            return
        if cat.add(key):
            cat.save()
            log(f"shape catalog: observed new program ({pipeline}, {model}, "
                f"{height}x{width}, steps={steps}) → {cat.path}")
    except Exception as e:  # noqa: BLE001 — observation never sinks a job
        debug_log(f"shape catalog: observe failed: {e}")
