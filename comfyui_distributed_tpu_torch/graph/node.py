"""Node registry of the port (its own ``NODE_REGISTRY``: the JAX package's
registry is process-global and rejects duplicate names).

Parity: the reference registers 8 node classes into ComfyUI's
``NODE_CLASS_MAPPINGS`` (``nodes/__init__.py:14-22``). Here nodes are plain
classes registered by name with a small declared interface:

- ``INPUTS``: ``{name: type_str}`` required graph inputs;
- ``OPTIONAL``: optional inputs;
- ``HIDDEN``: inputs injected by orchestration, never wired by users
  (the reference's hidden ``is_worker``/``worker_id``/``multi_job_id``);
- ``RETURNS``: tuple of output type names;
- ``execute(**inputs)`` returning a tuple matching ``RETURNS``.

Type names are ComfyUI's ("IMAGE", "LATENT", "INT", ...) so reference
workflow JSON maps 1:1. The wildcard ``"*"`` matches anything (reference
``AnyType``, ``nodes/utilities.py:79-83``).
"""

from __future__ import annotations

from typing import Any, Type

from ..utils.exceptions import ValidationError

NODE_REGISTRY: dict[str, Type["NodeDef"]] = {}


class NodeDef:
    """Base node. Subclass, fill the declarations, implement execute()."""

    INPUTS: dict[str, str] = {}
    OPTIONAL: dict[str, str] = {}
    HIDDEN: dict[str, str] = {}
    RETURNS: tuple[str, ...] = ()
    OUTPUT_NODE = False      # terminal node: its outputs go into history

    def execute(self, **inputs) -> tuple:
        raise NotImplementedError

    @classmethod
    def all_input_names(cls) -> set[str]:
        return set(cls.INPUTS) | set(cls.OPTIONAL) | set(cls.HIDDEN)


def register_node(name: str):
    def deco(cls: Type[NodeDef]) -> Type[NodeDef]:
        if name in NODE_REGISTRY:
            raise ValidationError(f"duplicate node class {name!r}")
        NODE_REGISTRY[name] = cls
        return cls
    return deco


def get_node(name: str) -> Type[NodeDef]:
    try:
        return NODE_REGISTRY[name]
    except KeyError:
        raise ValidationError(f"unknown node class {name!r}")


def is_link(value: Any) -> bool:
    """Graph-edge encoding: ``[source_node_id, output_index]``."""
    return (
        isinstance(value, (list, tuple))
        and len(value) == 2
        and isinstance(value[0], str)
        and isinstance(value[1], int)
    )
