"""Prompt-graph rewriting — pure functions, no I/O (the port's copy of
the JAX package's ``graph/transform.py``, same class sets, same output).

- ``PromptIndex`` — class→nodes index + memoized, cycle-safe upstream
  reachability;
- ``prune_prompt_for_worker`` — workers receive only distributed nodes +
  their upstream closure, with a preview injected where downstream
  consumers were cut;
- ``prepare_delegate_master_prompt`` — a delegate-only master keeps
  collectors + downstream + provably-safe scalar upstream branches, and
  feeds collectors from ``DistributedEmptyImage``;
- ``apply_participant_overrides`` — hidden inputs (job id, role, callback
  URL) written per participant;
- ``generate_job_id_map`` — per-node ids ``exec_<ms>_<6hex>_<node>``.
"""

from __future__ import annotations

import copy
import secrets
import time
from typing import Iterable

from .node import is_link

Prompt = dict[str, dict]

# Node classes that participate in distribution (reference constants,
# web/constants.js:172-231 and prompt_transform usage).
COLLECTOR_CLASSES = frozenset({"DistributedCollector"})
USDU_CLASSES = frozenset({"UltimateSDUpscaleDistributed"})
DISTRIBUTED_CLASSES = COLLECTOR_CLASSES | USDU_CLASSES
# Per-participant nodes that receive role overrides but don't anchor pruning
PARTICIPANT_CLASSES = frozenset(
    {"DistributedSeed", "DistributedValue", "DistributedModelName"}
)
# Upstream classes a delegate master may safely keep (cheap scalar/source
# nodes; reference keeps Primitive*/LoadImage + registered scalar outputs,
# prompt_transform.py:128-328)
SAFE_SCALAR_CLASSES = frozenset(
    {"PrimitiveInt", "PrimitiveFloat", "PrimitiveString", "LoadImage",
     "DistributedSeed", "DistributedValue"}
)
PREVIEW_CLASS = "PreviewImage"
EMPTY_IMAGE_CLASS = "DistributedEmptyImage"


class PromptIndex:
    """Index over a prompt: class lookup + upstream reachability."""

    def __init__(self, prompt: Prompt):
        self.prompt = prompt
        self._by_class: dict[str, list[str]] = {}
        for nid, node in prompt.items():
            self._by_class.setdefault(node.get("class_type", ""), []).append(nid)
        self._upstream_cache: dict[str, frozenset[str]] = {}

    def nodes_of_class(self, class_type: str) -> list[str]:
        return list(self._by_class.get(class_type, []))

    def nodes_of_classes(self, class_types: Iterable[str]) -> list[str]:
        out: list[str] = []
        for ct in class_types:
            out.extend(self._by_class.get(ct, []))
        return out

    def direct_inputs(self, nid: str) -> list[str]:
        node = self.prompt.get(nid)
        if not node:
            return []
        return [
            v[0] for v in node.get("inputs", {}).values()
            if is_link(v) and v[0] in self.prompt
        ]

    def upstream_of(self, nid: str) -> frozenset[str]:
        """All transitive input node ids (cycle-safe, memoized;
        reference ``PromptIndex`` ``:7-53``)."""
        cached = self._upstream_cache.get(nid)
        if cached is not None:
            return cached
        seen: set[str] = set()
        stack = list(self.direct_inputs(nid))
        while stack:
            cur = stack.pop()
            if cur in seen or cur == nid:
                continue
            seen.add(cur)
            stack.extend(self.direct_inputs(cur))
        result = frozenset(seen)
        self._upstream_cache[nid] = result
        return result

    def is_upstream(self, maybe_up: str, of: str) -> bool:
        return maybe_up in self.upstream_of(of)

    def downstream_of(self, nid: str) -> frozenset[str]:
        return frozenset(
            other for other in self.prompt if nid in self.upstream_of(other)
        )


def generate_job_id_map(prompt: Prompt, trace_id: str | None = None) -> dict[str, str]:
    """Per distributed-node job ids: ``exec_<ms>_<6hex>_<node_id>``
    (reference ``:423-431`` + ``api/queue_orchestration.py:315-316``)."""
    index = PromptIndex(prompt)
    base = trace_id or f"exec_{int(time.time() * 1000)}_{secrets.token_hex(3)}"
    return {
        nid: f"{base}_{nid}"
        for nid in index.nodes_of_classes(DISTRIBUTED_CLASSES)
    }


def _drop_dangling_links(prompt: Prompt) -> None:
    """Remove link-valued inputs pointing at nodes not present (in place);
    required inputs that become dangling are left absent — downstream
    validation reports them (reference drops them the same way)."""
    for node in prompt.values():
        inputs = node.get("inputs", {})
        for name in [n for n, v in inputs.items()
                     if is_link(v) and v[0] not in prompt]:
            del inputs[name]


def prune_prompt_for_worker(prompt: Prompt) -> Prompt:
    """Worker payload: distributed nodes + upstream closure only.

    Nodes downstream of a distributed node (e.g. SaveImage after a
    collector) are cut on workers — results flow back via the collector,
    not via worker-side outputs. When a collector thereby loses all its
    consumers, a ``PreviewImage`` is injected so the graph still has a
    terminal output node (reference ``:331-365``).
    """
    index = PromptIndex(prompt)
    anchors = index.nodes_of_classes(DISTRIBUTED_CLASSES)
    keep: set[str] = set(anchors)
    for nid in anchors:
        keep |= index.upstream_of(nid)
    pruned: Prompt = {nid: copy.deepcopy(prompt[nid]) for nid in keep}
    _drop_dangling_links(pruned)

    # re-terminate collectors whose consumers were cut
    consumed = {
        v[0]
        for node in pruned.values()
        for v in node.get("inputs", {}).values()
        if is_link(v)
    }
    counter = 0
    for nid in list(pruned):
        if (
            pruned[nid].get("class_type") in COLLECTOR_CLASSES
            and nid not in consumed
        ):
            counter += 1
            pruned[f"_preview_{counter}"] = {
                "class_type": PREVIEW_CLASS,
                "inputs": {"images": [nid, 0]},
            }
    return pruned


def _is_safe_scalar_branch(prompt: Prompt, index: PromptIndex, nid: str,
                           _visiting: frozenset[str] = frozenset()) -> bool:
    """A branch is safe for a delegate master iff the node and all its
    transitive inputs are in SAFE_SCALAR_CLASSES (recursively validated,
    reference ``:128-328``)."""
    if nid in _visiting:
        return False
    node = prompt.get(nid)
    if node is None or node.get("class_type") not in SAFE_SCALAR_CLASSES:
        return False
    return all(
        _is_safe_scalar_branch(prompt, index, src, _visiting | {nid})
        for src in index.direct_inputs(nid)
    )


def prepare_delegate_master_prompt(prompt: Prompt) -> Prompt:
    """Delegate-only master payload: collectors + everything downstream of
    them + safe scalar upstream branches; collector tensor inputs are fed
    from an injected 0-batch ``DistributedEmptyImage`` so the master
    contributes no compute (reference ``:368-420``)."""
    index = PromptIndex(prompt)
    collectors = index.nodes_of_classes(COLLECTOR_CLASSES)
    keep: set[str] = set(collectors)
    for nid in collectors:
        keep |= index.downstream_of(nid)
    # safe scalar upstream branches of kept nodes
    for nid in list(keep):
        for src in index.direct_inputs(nid):
            if _is_safe_scalar_branch(prompt, index, src):
                keep.add(src)
                keep |= {
                    up for up in index.upstream_of(src)
                    if _is_safe_scalar_branch(prompt, index, up)
                }
    out: Prompt = {nid: copy.deepcopy(prompt[nid]) for nid in keep}

    # feed collectors from an empty image instead of the (cut) producer
    if collectors:
        empty_id = "_delegate_empty"
        out[empty_id] = {
            "class_type": EMPTY_IMAGE_CLASS,
            "inputs": {"height": 64, "width": 64, "channels": 3},
        }
        for nid in collectors:
            inputs = out[nid].setdefault("inputs", {})
            for name, v in list(inputs.items()):
                if is_link(v) and v[0] not in out:
                    inputs[name] = [empty_id, 0]
    _drop_dangling_links(out)
    return out


def apply_participant_overrides(
    prompt: Prompt,
    participant: str,                 # "master" | worker id
    job_id_map: dict[str, str],
    master_url: str = "",
    enabled_worker_ids: tuple[str, ...] = (),
    delegate_only: bool = False,
    worker_index: int | None = None,
) -> Prompt:
    """Write per-participant hidden inputs (in a copy).

    Reference ``:434-558``: distributed nodes get ``multi_job_id``,
    ``is_worker``, ``worker_id``, ``master_url``, ``enabled_worker_ids``,
    ``delegate_only``; participant nodes (seed/value) get role fields;
    collectors that sit downstream of a USDU node get ``pass_through``
    (tiles already travelled through the tile engine).
    """
    out = copy.deepcopy(prompt)
    index = PromptIndex(out)
    is_worker = participant != "master"
    usdu_nodes = set(index.nodes_of_classes(USDU_CLASSES))

    for nid, node in out.items():
        ct = node.get("class_type", "")
        inputs = node.setdefault("inputs", {})
        if ct in DISTRIBUTED_CLASSES:
            if nid in job_id_map:
                inputs["multi_job_id"] = job_id_map[nid]
            inputs["is_worker"] = is_worker
            inputs["worker_id"] = participant if is_worker else ""
            inputs["master_url"] = master_url
            inputs["enabled_worker_ids"] = list(enabled_worker_ids)
            if not is_worker:
                inputs["delegate_only"] = delegate_only
        if ct in COLLECTOR_CLASSES:
            inputs["pass_through"] = any(
                u in usdu_nodes for u in index.upstream_of(nid)
            )
        if ct in PARTICIPANT_CLASSES:
            inputs["is_worker"] = is_worker
            inputs["worker_id"] = participant if is_worker else ""
            if worker_index is not None:
                inputs["worker_index"] = worker_index
    return out
