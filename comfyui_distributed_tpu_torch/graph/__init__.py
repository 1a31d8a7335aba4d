"""Workflow graphs: node registry, validation and execution."""

from .node import NODE_REGISTRY, NodeDef, get_node, register_node  # noqa: F401
from .executor import GraphExecutor, validate_prompt  # noqa: F401
from . import nodes_builtin  # noqa: F401  (registers the node set)
