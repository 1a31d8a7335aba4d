"""Prompt validation + topological execution (the port's copy of the JAX
package's ``graph/executor.py``, resolving nodes through the port's
registry).

The reference delegates both to ComfyUI (``execution.validate_prompt`` and
the PromptExecutor; invoked at ``utils/async_helpers.py:108-149``). This is
the standalone equivalent: validate structure/types, then execute in
dependency order with per-node output caching.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..utils.exceptions import ValidationError
from .node import NODE_REGISTRY, get_node, is_link

Prompt = dict[str, dict]


@dataclasses.dataclass
class NodeError:
    node_id: str
    message: str

    def as_dict(self) -> dict:
        return {"node_id": self.node_id, "message": self.message}


def _is_meta(key: str, value) -> bool:
    return key.startswith("_") and not (isinstance(value, dict)
                                        and "class_type" in value)


def strip_meta(prompt: Prompt) -> Prompt:
    """Drop underscore-prefixed entries that are not nodes (``_meta``
    workflow headers etc.): shipped workflow files carry documentation
    alongside the nodes. Nodes the control plane injects under such ids
    (``_delegate_empty``, ``_preview_1``) stay; the JAX package drops
    them too, which leaves a delegate master's collector without input."""
    if isinstance(prompt, dict) and any(_is_meta(k, v) for k, v in prompt.items()):
        return {k: v for k, v in prompt.items() if not _is_meta(k, v)}
    return prompt


def validate_prompt(prompt: Prompt) -> list[NodeError]:
    """Structural validation; returns per-node errors (empty = valid).

    Mirrors the checks ComfyUI's ``validate_prompt`` performs for the
    reference (unknown class, missing required input, dangling link, cycle)
    and reports them in the ``node_errors`` shape of the public API
    (``api/job_routes.py:206-236``).
    """
    errors: list[NodeError] = []
    if not isinstance(prompt, dict) or not prompt:
        return [NodeError("", "prompt must be a non-empty object")]

    for nid, node in prompt.items():
        if not isinstance(node, dict) or "class_type" not in node:
            errors.append(NodeError(nid, "node must have class_type"))
            continue
        cls_name = node["class_type"]
        if cls_name not in NODE_REGISTRY:
            errors.append(NodeError(nid, f"unknown node class {cls_name!r}"))
            continue
        cls = NODE_REGISTRY[cls_name]
        inputs = node.get("inputs", {})
        for name in cls.INPUTS:
            if name not in inputs:
                errors.append(NodeError(nid, f"missing required input {name!r}"))
        for name, value in inputs.items():
            if is_link(value):
                src, out_idx = value
                if src not in prompt:
                    errors.append(NodeError(nid, f"input {name!r} links to missing node {src!r}"))
                else:
                    src_cls_name = prompt[src].get("class_type")
                    src_cls = NODE_REGISTRY.get(src_cls_name)
                    if src_cls is not None and out_idx >= len(src_cls.RETURNS):
                        errors.append(NodeError(
                            nid, f"input {name!r} links to output {out_idx} of "
                                 f"{src_cls_name!r} which has {len(src_cls.RETURNS)}"))
    if not errors:
        try:
            topo_order(prompt)
        except ValidationError as e:
            errors.append(NodeError("", str(e)))
    return errors


def topo_order(prompt: Prompt) -> list[str]:
    """Dependency-first order; raises on cycles."""
    state: dict[str, int] = {}   # 0=visiting, 1=done
    order: list[str] = []

    def visit(nid: str, stack: tuple[str, ...]):
        mark = state.get(nid)
        if mark == 1:
            return
        if mark == 0:
            raise ValidationError(f"cycle involving node {nid!r}")
        state[nid] = 0
        for value in prompt[nid].get("inputs", {}).values():
            if is_link(value) and value[0] in prompt:
                visit(value[0], stack + (nid,))
        state[nid] = 1
        order.append(nid)

    for nid in prompt:
        visit(nid, ())
    return order


def node_kwargs(prompt: Prompt, nid: str, cache: dict[str, tuple],
                context: dict[str, Any]) -> dict[str, Any]:
    """Resolve one node's call kwargs: links from ``cache``, literals as
    given, HIDDEN names from ``context``."""
    node = prompt[nid]
    cls = get_node(node["class_type"])
    kwargs: dict[str, Any] = {}
    for name, value in node.get("inputs", {}).items():
        if name not in cls.all_input_names():
            continue              # tolerate extra inputs (forward compat)
        if is_link(value):
            src, out_idx = value
            kwargs[name] = cache[src][out_idx]
        else:
            kwargs[name] = value
    for name in cls.HIDDEN:
        if name not in kwargs and name in context:
            kwargs[name] = context[name]
    return kwargs


class GraphExecutor:
    """Execute a validated prompt. ``context`` is shared state (the model
    registry, the output directory) that nodes may request via their
    HIDDEN declaration names. An ``interrupt_event`` in it, once set,
    stops the prompt before its next node with ``InterruptedError``.
    """

    def __init__(self, context: dict[str, Any] | None = None):
        self.context = context or {}

    def execute(self, prompt: Prompt) -> dict[str, tuple]:
        """Validate, then run every node in dependency order; returns each
        node's outputs by node id."""
        errs = validate_prompt(prompt)
        if errs:
            raise ValidationError(
                "; ".join(f"{e.node_id}: {e.message}" for e in errs)
            )
        return self.execute_nodes(prompt, topo_order(prompt), {})

    def execute_nodes(self, prompt: Prompt, node_ids: list[str],
                      cache: dict[str, tuple]) -> dict[str, tuple]:
        """Run ``node_ids`` in the given order into ``cache``, skipping
        the nodes it already holds: the microbatch executor runs a
        prompt's prefix, puts the group's sampler output in, then runs
        the suffix through this same loop. Callers own validation and
        order."""
        interrupt = self.context.get("interrupt_event")
        for nid in node_ids:
            if interrupt is not None and interrupt.is_set():
                # checked between nodes: a node already running finishes
                raise InterruptedError(f"execution interrupted before {nid}")
            if nid in cache:
                continue
            cls = get_node(prompt[nid]["class_type"])
            kwargs = node_kwargs(prompt, nid, cache, self.context)
            cache[nid] = tuple(cls().execute(**kwargs))
        return cache
