"""The warm pass: a worker hot the moment it joins (the port's counterpart
of the JAX package's ``diffusion/warmup.py``).

The JAX package compiles each shape-catalog program ahead of time
without running it. Eager PyTorch compiles nothing ahead of time but its
CUDA kernels, so the port's pass does, for each catalog key, in a thread
off the event loop:

1. build or fetch the key's bundle through the model registry (not
   pinned: the residency planner may still evict it under
   ``CDT_HBM_BUDGET_GB``);
2. on the card, load the attention kernel library, which builds it with
   ``nvcc`` when the build directory lacks it (the port's persistent
   compile cache);
3. for a ``txt2img`` key, one denoiser call at the key's latent geometry,
   CFG-doubled, and one VAE decode of one latent, under ``no_grad``, the
   outputs dropped, then a synchronisation: the first calls of cuDNN and
   cuBLAS at those shapes happen here, not in a request. ``flow_dp`` and
   ``video_dp`` keys stop after steps 1 and 2 (their context length
   depends on the text stack a request brings), and so do the mesh
   tier's keys (``mesh_tier_keys``: ``flow_sp`` and ``flow_tp``), whose
   recipe builds every rank's bundle, or for ``flow_tp`` every rank's
   shard under the key's strategy mesh (the ``warm`` mesh program), on
   a controller mesh of more than one rank;
4. record the outcome under the JAX package's labels: ``compiled`` when
   a bundle, a shard or the library had to be built, ``cache_hit`` when
   none did, ``error``, or ``skipped`` (a model outside
   ``CDT_WARMUP_MODELS``, or a key this host's mesh cannot run:
   ``_mesh_matches``).

:class:`WarmupManager` owns the state the health probe reports: ``cold
→ warming → ready | error``. Unlike the JAX package, where one program's
error still ends ``ready``, any entry that ends ``error`` ends the pass
in ``error``: a worker whose warm pass failed is not reported hot. The
pass changes no image: a request served after it is bitwise the same
request on a cold controller.

Knobs: ``CDT_WARMUP=1`` runs a pass when the controller boots;
``CDT_WARMUP_MODELS`` (comma list; ``all`` or ``*``; empty: the loaded
and the tiny presets) says which models it may build.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Optional

import torch

from .. import telemetry
from ..cluster.shape_catalog import ProgramKey, ShapeCatalog
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.logging import debug_log, log

COLD, WARMING, READY, ERROR = "cold", "warming", "ready", "error"
_STATE_GAUGE = {COLD: 0.0, WARMING: 1.0, READY: 2.0, ERROR: -1.0}
# the text encoders' context length (CLIP's 77 tokens)
CONTEXT_TOKENS = 77


@dataclasses.dataclass
class WarmupEntry:
    key: ProgramKey
    outcome: str          # cache_hit | compiled | error | skipped
    seconds: float = 0.0
    detail: str = ""

    def to_dict(self) -> dict:
        return {"program": self.key.to_dict(), "outcome": self.outcome,
                "seconds": round(self.seconds, 3), "detail": self.detail}


def _load_kernels(device: torch.device) -> bool:
    """Load the kernel library on the card; True when this built it."""
    if device.type != "cuda":
        return False
    from ..ops import flash_attention as fa

    built = fa.KERNELS._lib is None and not fa.KERNELS.path().is_file()
    fa.KERNELS.load()
    return built


@torch.no_grad()
def warm_txt2img(bundle, key: ProgramKey) -> None:
    """One CFG-doubled denoiser call at ``key``'s latent geometry and one
    VAE decode of one latent, outputs dropped, then a synchronisation."""
    from .guidance import cfg_denoiser
    from .pipeline import GenerationSpec, make_sigma_ladder

    pipeline = bundle.pipeline
    dev = pipeline.device
    cfg = pipeline.unet.config
    ds = pipeline.vae.config.downscale
    latent = torch.zeros((key.batch, key.height // ds, key.width // ds,
                          pipeline.latent_channels), device=dev)
    ctx = torch.zeros((key.batch, CONTEXT_TOKENS, cfg.context_dim), device=dev)
    y = (torch.zeros((key.batch, cfg.adm_in_channels), device=dev)
         if cfg.adm_in_channels else None)
    denoise = cfg_denoiser(lambda c, yy: pipeline._denoiser(c, yy), ctx, ctx,
                           5.0, y, y)
    sigma = make_sigma_ladder(GenerationSpec(steps=key.steps),
                              pipeline.schedule)[0].to(dev)
    denoise(latent, sigma)
    pipeline._decode_latent(latent[:1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_matches(key: ProgramKey, mesh) -> bool:
    """JAX's rule: an empty ``key.mesh`` is "whatever this host runs"; a
    concrete one must match exactly, or be a mesh-tier strategy layout
    (``flow_sp`` / ``flow_tp``) over no more ranks than the mesh has."""
    import math

    if not key.mesh:
        return True
    if tuple(sorted(key.mesh)) == tuple(
            sorted((str(a), int(n)) for a, n in mesh.axes.items())):
        return True
    return (key.pipeline in ("flow_sp", "flow_tp")
            and math.prod(n for _, n in key.mesh) <= mesh.size)


def mesh_tier_keys(keys: Iterable[ProgramKey], mesh) -> list[ProgramKey]:
    """The mesh-tier programs a catalog implies (JAX's rule): for every
    ``flow_dp`` key, a ``flow_sp`` key (single-image latency, when the
    latent rows divide) and, with a tp degree (``parallel/serving.
    derive_tp``: a pinned ``CDT_MESH_TP``), a ``flow_tp`` key over
    ``{"dp": n/tp, "tp": tp}``. None on one rank or under
    ``CDT_MESH_TIER=0``."""
    from ..parallel import serving

    n = int(mesh.size)
    if n < 2 or not serving.mesh_tier_enabled():
        return []
    tp = serving.derive_tp(n)
    while tp > 1 and n % tp:
        tp //= 2
    out: list[ProgramKey] = []
    for key in keys:
        if key.pipeline != "flow_dp":
            continue
        # sp needs the latent rows (h/8/patch, patch 2) to divide
        sp = n
        while sp > 1 and (key.height // 16) % sp:
            sp //= 2
        if sp > 1:
            out.append(dataclasses.replace(
                key, pipeline="flow_sp", mesh=(("sp", sp),)))
        if tp > 1:
            out.append(dataclasses.replace(
                key, pipeline="flow_tp",
                mesh=(("dp", n // tp), ("tp", tp))))
    return out


def _warm_mesh_tier(bundle, key: ProgramKey, mesh) -> bool:
    """The mesh tier's recipe: every rank builds its bundle (``flow_sp``)
    or its shard under the key's strategy mesh (``flow_tp``); True when
    rank 0 had to build its shard."""
    axes = dict(key.mesh) if key.pipeline == "flow_tp" else None
    tp = (axes or {}).get("tp", 1)
    # rank 0 is tp index 0 under any strategy mesh
    fresh = tp > 1 and (0, tp, "tp") not in getattr(
        bundle.pipeline, "_tp_shards", {})
    mesh.runtime.run("warm", bundle, axes=axes)
    return fresh


def _allowed_models(registry, models: Optional[Iterable[str]]):
    """The models a pass may build: None for all."""
    if models is None:
        env = constants.warmup_models()
        models = [m.strip() for m in env.split(",") if m.strip()] or None
    if models is not None:
        models = set(models)
        return None if models & {"all", "*"} else models
    # the safe default: what is loaded, and presets cheap anywhere
    allowed = set(getattr(registry, "_cache", {})) | {
        m for m in registry.available() if "tiny" in m}
    log("warmup: no model filter — warming only loaded/tiny presets "
        f"({sorted(allowed)}); set CDT_WARMUP_MODELS=all to warm "
        "everything in the catalog")
    return allowed


def _runnable(key: ProgramKey, mesh) -> bool:
    """A key this host warms: a one-card key, or a mesh-tier key that the
    controller's mesh of more than one rank matches."""
    if key.single_card:
        return True
    return (mesh is not None and mesh.size > 1
            and key.pipeline in ("flow_sp", "flow_tp")
            and _mesh_matches(key, mesh))


def run_warmup(registry, keys: Iterable[ProgramKey],
               models: Optional[Iterable[str]] = None,
               on_entry: Optional[Callable[[WarmupEntry], None]] = None,
               mesh=None) -> list[WarmupEntry]:
    """Warm every catalog key this host can run (steps 1–4 of the module
    docstring) on ``mesh`` (the controller's; None: one card). A key's
    failure is recorded, never raised."""
    allowed = _allowed_models(registry, models)
    report: list[WarmupEntry] = []
    for key in keys:
        if not _runnable(key, mesh) or (allowed is not None
                                        and key.model not in allowed):
            entry = WarmupEntry(key, "skipped",
                                detail="model filtered or mesh mismatch")
        else:
            t0 = time.perf_counter()
            try:
                builds = registry.builds
                bundle = registry.get(key.model)
                built = registry.builds != builds
                built |= _load_kernels(registry.device)
                if key.pipeline == "txt2img":
                    warm_txt2img(bundle, key)
                elif not key.single_card:
                    built |= _warm_mesh_tier(bundle, key, mesh)
                entry = WarmupEntry(key, "compiled" if built else "cache_hit",
                                    time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — one key's failure is its own
                entry = WarmupEntry(key, "error", time.perf_counter() - t0,
                                    detail=f"{type(e).__name__}: {e}")
                log(f"warmup: {key} failed: {e}")
        report.append(entry)
        if telemetry.enabled():
            _tm.WARMUP_PROGRAMS.labels(outcome=entry.outcome).inc()
            if entry.outcome in ("cache_hit", "compiled"):
                _tm.WARMUP_SECONDS.observe(entry.seconds)
        if on_entry is not None:
            on_entry(entry)
    return report


class WarmupManager:
    """The warm state machine and its pass. ``registry_fn`` returns the
    controller's model registry (resolved when a pass runs)."""

    def __init__(self, registry_fn: Callable,
                 catalog: Optional[ShapeCatalog] = None,
                 mesh_fn: Optional[Callable] = None):
        self._registry_fn = registry_fn
        # the controller's mesh (None: one card, no mesh tier)
        self._mesh_fn = mesh_fn
        self._catalog = catalog
        self._state = COLD
        self._lock = threading.Lock()
        self._report: list[WarmupEntry] = []
        self._error = ""
        self._started_at: Optional[float] = None
        self._finished_at: Optional[float] = None

    @property
    def state(self) -> str:
        return self._state

    @property
    def catalog(self) -> ShapeCatalog:
        if self._catalog is None:
            from ..cluster.shape_catalog import default_catalog

            self._catalog = default_catalog()
        return self._catalog

    def _set_state(self, state: str) -> None:
        self._state = state
        if telemetry.enabled():
            _tm.WARMUP_STATE.set(_STATE_GAUGE[state])

    def run(self, models: Optional[Iterable[str]] = None,
            seed_workflows: bool = True,
            extra_keys: Optional[Iterable[ProgramKey]] = None) -> dict:
        """One pass, synchronously (call it from a thread). A second
        caller while a pass runs gets the running pass's status."""
        if not self._lock.acquire(blocking=False):
            return self.status()
        try:
            self._set_state(WARMING)
            self._error = ""
            self._started_at = time.monotonic()
            self._finished_at = None
            cat = self.catalog
            if seed_workflows:
                cat.seed_from_workflows()
            keys = cat.entries()
            if extra_keys:
                keys += [k for k in extra_keys if k not in set(keys)]
            # the mesh tier's variants of the flow programs the catalog
            # serves (JAX's rule), so they are hot from boot
            mesh = self._mesh_fn() if self._mesh_fn is not None else None
            tier = ([k for k in mesh_tier_keys(keys, mesh)
                     if k not in set(keys)] if mesh is not None else [])
            keys += tier
            log(f"warmup: starting a pass over {len(keys)} catalog "
                f"program(s) ({len(tier)} mesh-tier)")
            self._report = run_warmup(self._registry_fn(), keys,
                                      models=models, mesh=mesh)
            cat.save()
            errors = [e for e in self._report if e.outcome == "error"]
            self._finished_at = time.monotonic()
            self._set_state(ERROR if errors else READY)
            if errors:
                self._error = f"{len(errors)} program(s) failed"
            counts = self.status()["outcomes"]
            log(f"warmup: {self._state} — {counts} in "
                f"{self._finished_at - self._started_at:.1f} s")
        except Exception as e:  # noqa: BLE001 — the boot survives its warmup
            self._finished_at = time.monotonic()
            self._error = f"{type(e).__name__}: {e}"
            self._set_state(ERROR)
            log(f"warmup: pass failed: {e}")
        finally:
            self._lock.release()
        return self.status()

    def status(self) -> dict:
        """The ``GET /distributed/warmup`` payload."""
        took = None
        if self._started_at is not None:
            took = (self._finished_at or time.monotonic()) - self._started_at
        counts: dict[str, int] = {}
        for e in self._report:
            counts[e.outcome] = counts.get(e.outcome, 0) + 1
        try:
            builds = self._registry_fn().builds
        except Exception as e:  # noqa: BLE001 — a status never raises
            debug_log(f"warmup: no registry for the status: {e}")
            builds = None
        return {
            "state": self._state,
            "catalog_size": (len(self._catalog)
                             if self._catalog is not None else None),
            "catalog_path": (str(self._catalog.path)
                             if self._catalog is not None else None),
            "outcomes": counts,
            "seconds": None if took is None else round(took, 3),
            "error": self._error or None,
            # bundles the registry has built (a request after a warm pass
            # of its key builds none)
            "bundle_builds": builds,
            "report": [e.to_dict() for e in self._report],
        }
