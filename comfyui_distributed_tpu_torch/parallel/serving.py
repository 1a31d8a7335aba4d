"""Placement planning for the mesh (the port's copy of the JAX package's
``parallel/serving.py``, which imports no JAX).

- :func:`derive_tp` — the tp degree a model needs: ``CDT_MESH_TP`` wins;
  otherwise the smallest power-of-two shard count whose per-device
  weight slice fits the memory budget.
- :func:`plan_placement` — one strategy per request class: ``dp_tp``
  when the weights need sharding (or a tp degree is pinned), ``sp`` for
  single-image latency on a model with a sequence-parallel path, ``dp``
  seed fan-out otherwise.
- :func:`mesh_for` — the mesh of a plan, tp the innermost axis.

``CDT_MESH_TIER=0`` collapses everything to the flat ``dp`` fan-out.
The port plans ``dp_tp`` as JAX does; a group on such a mesh runs the
tensor-parallel programs (``parallel/programs``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..utils import constants

STRATEGIES = ("dp", "dp_tp", "sp")


def mesh_tier_enabled() -> bool:
    return constants.mesh_tier()


def derive_tp(n_devices: int, param_bytes: Optional[int] = None,
              budget_bytes: Optional[int] = None) -> int:
    """``CDT_MESH_TP`` pins the degree (clamped to the device count);
    otherwise, with known weight bytes and a per-device budget, the
    smallest power of two whose slice fits; 1 when the weights fit
    replicated or nothing is known."""
    pinned = constants.mesh_tp()
    if pinned:
        return max(1, min(int(pinned), n_devices))
    if not param_bytes or not budget_bytes or budget_bytes <= 0:
        return 1
    tp = 1
    while tp * 2 <= n_devices and param_bytes / tp > budget_bytes:
        tp *= 2
    return tp


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One request class's resolved placement."""

    strategy: str                      # dp | dp_tp | sp
    n_devices: int
    tp: int = 1
    reason: str = ""

    @property
    def mesh_shape(self) -> dict:
        if self.strategy == "sp":
            return {constants.AXIS_SEQUENCE: self.n_devices}
        if self.strategy == "dp_tp":
            return {constants.AXIS_DATA: self.n_devices // self.tp,
                    constants.AXIS_TENSOR: self.tp}
        return {constants.AXIS_DATA: self.n_devices}

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "n_devices": self.n_devices,
                "tp": self.tp, "mesh": self.mesh_shape,
                "reason": self.reason}


def plan_placement(n_devices: int, *, batch: int = 1,
                   param_bytes: Optional[int] = None,
                   budget_bytes: Optional[int] = None,
                   supports_sp: bool = False,
                   supports_tp: bool = True) -> PlacementPlan:
    """Weights that do not fit replicated (or a pinned ``CDT_MESH_TP``)
    force ``dp_tp``; a single-image request on a model with a
    sequence-parallel path takes ``sp``; everything else fans seeds out
    over ``dp``. ``CDT_MESH_TIER=0`` or one device: flat ``dp``."""
    if n_devices <= 1 or not mesh_tier_enabled():
        return PlacementPlan("dp", max(n_devices, 1),
                             reason="mesh tier off or single device")
    tp = derive_tp(n_devices, param_bytes, budget_bytes) if supports_tp \
        else 1
    if tp > 1:
        while n_devices % tp:          # keep the mesh factorable
            tp //= 2
    if tp > 1:
        why = ("CDT_MESH_TP pinned" if constants.mesh_tp()
               else f"weights ({param_bytes / 1e9:.1f} GB) exceed the "
                    f"per-chip budget")
        return PlacementPlan("dp_tp", n_devices, tp, reason=why)
    if batch <= 1 and supports_sp:
        return PlacementPlan("sp", n_devices,
                             reason="single-image latency: shard the "
                                    "sequence, not the batch")
    return PlacementPlan("dp", n_devices, reason="seed fan-out")


def mesh_for(plan: PlacementPlan, n_devices: Optional[int] = None,
             device=None):
    """The mesh of a plan; tp last, so tp shards are neighbouring ranks."""
    from .mesh import build_mesh

    return build_mesh(plan.mesh_shape, n_devices or plan.n_devices, device)
