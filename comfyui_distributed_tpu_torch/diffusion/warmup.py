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
   depends on the text stack a request brings);
4. record the outcome under the JAX package's labels: ``compiled`` when
   the bundle or the library had to be built, ``cache_hit`` when neither
   did, ``error``, or ``skipped`` (a model outside ``CDT_WARMUP_MODELS``,
   or a multi-card key: the mesh tier's keys are ROADMAP A.6b ii).

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


def run_warmup(registry, keys: Iterable[ProgramKey],
               models: Optional[Iterable[str]] = None,
               on_entry: Optional[Callable[[WarmupEntry], None]] = None
               ) -> list[WarmupEntry]:
    """Warm every catalog key this host can run (steps 1–4 of the module
    docstring). A key's failure is recorded, never raised."""
    allowed = _allowed_models(registry, models)
    report: list[WarmupEntry] = []
    for key in keys:
        if not key.single_card or (allowed is not None
                                   and key.model not in allowed):
            entry = WarmupEntry(key, "skipped",
                                detail="model filtered or multi-card key")
        else:
            t0 = time.perf_counter()
            try:
                builds = registry.builds
                bundle = registry.get(key.model)
                built = registry.builds != builds
                built |= _load_kernels(registry.device)
                if key.pipeline == "txt2img":
                    warm_txt2img(bundle, key)
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
                 catalog: Optional[ShapeCatalog] = None):
        self._registry_fn = registry_fn
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
            log(f"warmup: starting a pass over {len(keys)} catalog "
                "program(s)")
            self._report = run_warmup(self._registry_fn(), keys,
                                      models=models)
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
