"""Request classification: which queue requests can ride one microbatch
(the port's copy of the JAX package's ``cluster/frontdoor/classifier.py``).

Two requests share a group exactly when they resolve to the same
:class:`GroupKey`: same model, geometry, step count, guidance, sampler
family and per-device batch. The key is derived statically from the
prompt graph, and conservatively: anything not proven batchable goes
down the orchestration path untouched. A wrong "not batchable" costs a
solo execution; a wrong "batchable" could corrupt a user's image, so the
allowlist names every node class known to be safe beside batching.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ...diffusion.pipeline import DETERMINISTIC_SAMPLERS
from ..shape_catalog import ProgramKey

# The one sampler node the microbatch executor knows how to group.
BATCHABLE_SAMPLER = "TPUTxt2Img"

# Node classes that may appear anywhere in a batchable prompt. Everything
# else (other samplers, tile and video machinery, the collector's fan-out,
# LoRA and ControlNet, which change the model or conditioning where the
# group key cannot see) goes down the orchestration path.
BATCHABLE_NODE_ALLOWLIST = frozenset({
    BATCHABLE_SAMPLER,
    "CheckpointLoader",
    "CLIPTextEncode",
    "DistributedSeed",
    "DistributedValue",
    "EmptyLatentImage",
    "ImageScale",
    "ImageScaleBy",
    "ImageFromBatch",
    "SaveImage",
    "PreviewImage",
    "PrimitiveInt",
    "PrimitiveFloat",
    "PrimitiveString",
})

@dataclasses.dataclass(frozen=True, order=True)
class GroupKey:
    """Identity of the program a request needs: requests with equal keys
    coalesce into one microbatch. ``ProgramKey`` plus the sampler knobs
    that change the program (cfg toggles CFG; sampler and scheduler
    change the step and the ladder)."""

    model: str
    height: int
    width: int
    steps: int
    cfg: float
    sampler: str
    scheduler: str
    batch_per_device: int = 1

    def program_key(self) -> ProgramKey:
        return ProgramKey(pipeline="txt2img", model=self.model,
                          height=self.height, width=self.width,
                          steps=self.steps, batch=self.batch_per_device)

    def label(self) -> str:
        """Low-cardinality telemetry and debug label."""
        return (f"{self.model}/{self.height}x{self.width}"
                f"/s{self.steps}/{self.sampler}")


@dataclasses.dataclass(frozen=True)
class Classification:
    batchable: bool
    reason: str
    group_key: Optional[GroupKey] = None
    sampler_node_id: Optional[str] = None


def fingerprint(prompt: dict) -> str:
    """The request's full content fingerprint (``cluster/cache/keys.py``):
    where the group key says "can these share a program?", this says
    "did these ask for byte-identical work?"."""
    from ..cache.keys import request_fingerprint

    return request_fingerprint(prompt)


def _literal_num(v):
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return v
    return None


def _not(reason: str) -> Classification:
    return Classification(batchable=False, reason=reason)


def classify(prompt: dict) -> Classification:
    """Classify one prompt statically. Never raises on malformed input:
    such a prompt is "not batchable" and fails on the orchestration
    path's validation."""
    if not isinstance(prompt, dict) or not prompt:
        return _not("empty")
    nodes = {k: v for k, v in prompt.items()
             if isinstance(v, dict) and v.get("class_type")}
    if len(nodes) != len(prompt):
        return _not("malformed_nodes")

    samplers = [nid for nid, n in nodes.items()
                if n["class_type"] == BATCHABLE_SAMPLER]
    if not samplers:
        return _not("no_batchable_sampler")
    if len(samplers) > 1:
        return _not("multiple_samplers")
    outside = sorted({n["class_type"] for n in nodes.values()
                      if n["class_type"] not in BATCHABLE_NODE_ALLOWLIST})
    if outside:
        return _not(f"node_outside_allowlist:{outside[0]}")

    nid = samplers[0]
    inputs = nodes[nid].get("inputs", {})
    height = _literal_num(inputs.get("height"))
    width = _literal_num(inputs.get("width"))
    steps = _literal_num(inputs.get("steps"))
    cfg = _literal_num(inputs.get("cfg"))
    if None in (height, width, steps, cfg):
        return _not("dynamic_geometry")

    sampler = inputs.get("sampler_name", "euler")
    scheduler = inputs.get("scheduler", "karras")
    if not isinstance(sampler, str) or not isinstance(scheduler, str):
        return _not("dynamic_sampler")
    if sampler not in DETERMINISTIC_SAMPLERS:
        return _not(f"stochastic_sampler:{sampler}")
    bpd = _literal_num(inputs.get("batch_per_device", 1))
    if bpd is None or int(bpd) != bpd:
        return _not("dynamic_batch")

    model = _resolve_checkpoint(inputs.get("model"), nodes)
    if model is None:
        return _not("unresolvable_model")

    key = GroupKey(model=model, height=int(height), width=int(width),
                   steps=int(steps), cfg=float(cfg), sampler=sampler,
                   scheduler=scheduler, batch_per_device=int(bpd))
    return Classification(batchable=True, reason="batchable",
                          group_key=key, sampler_node_id=nid)


def _resolve_checkpoint(link, nodes: dict) -> Optional[str]:
    """``model`` must link (one hop) to a ``CheckpointLoader`` with a
    literal ``ckpt_name``: the model's identity is known without running
    anything."""
    if not (isinstance(link, (list, tuple)) and len(link) == 2):
        return None
    src = nodes.get(str(link[0]))
    if src is None or src.get("class_type") != "CheckpointLoader":
        return None
    if link[1] != 0:
        return None
    name = src.get("inputs", {}).get("ckpt_name")
    return name if isinstance(name, str) and name else None
