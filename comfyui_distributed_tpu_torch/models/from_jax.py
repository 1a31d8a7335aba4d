"""Weight carry from the JAX package's parameter trees.

The port's modules name their attributes after the JAX parameter tree,
so each flax leaf maps to one PyTorch parameter by path, with these
layout rules:

- Dense ``kernel`` ``[in, out]`` → Linear ``weight`` ``[out, in]``;
- Conv ``kernel`` HWIO → Conv2d ``weight`` OIHW;
- LayerNorm/GroupNorm ``scale`` → ``weight``; Embed ``embedding`` →
  ``weight``; ``bias`` and bare parameters (``pos_emb``, the DiT's fp32
  ``q_scale``/``k_scale``) keep their name. The DiT's parameter-free
  LayerNorms have no leaf on either side.

The CLIP towers of ``models/clip.py`` carry by the same rules
(``tok_emb/embedding``, ``pos_emb``, ``layer_{i}/attn/q_proj/kernel``,
``text_projection/kernel``; ``ModelBundle.load_from_jax(clip_l=,
clip_g=)``), and so does T5 (``models/t5.py``: ``shared/embedding``,
``rel_bias/embedding`` or ``rel_bias_{i}/embedding``,
``attn_{i}/{q,k,v,o}/kernel``, the RMS norms' ``weight``); a FLUX
bundle's ``FluxTextStack`` takes both towers
(``ModelBundle.load_from_jax(t5=, clip_l=)``).

The tree is a nested mapping whose leaves are numpy arrays (or anything
with ``.shape`` for the shape-only check, e.g. ``jax.ShapeDtypeStruct``);
a top-level ``{"params": ...}`` wrapper is accepted. The carry raises on
any leaf it does not consume and on any port parameter it leaves unset.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn


class CarryError(ValueError):
    """The JAX tree and the port module disagree."""


def _leaves(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _unwrap(tree: Mapping) -> Mapping:
    if set(tree) == {"params"} and isinstance(tree["params"], Mapping):
        return tree["params"]
    return tree


def _target(path: tuple, shape: tuple) -> tuple[str, tuple, str]:
    """(port parameter name, port shape, transform) for one leaf."""
    *mods, name = path
    if name == "kernel" and len(shape) == 2:
        return ".".join(mods + ["weight"]), (shape[1], shape[0]), "t"
    if name == "kernel" and len(shape) == 4:
        kh, kw, i, o = shape
        return ".".join(mods + ["weight"]), (o, i, kh, kw), "hwio"
    if name in ("scale", "embedding"):
        return ".".join(mods + ["weight"]), tuple(shape), ""
    return ".".join(mods + [name]), tuple(shape), ""


def carry_plan(tree: Mapping, module: nn.Module) -> dict[str, tuple[tuple, str]]:
    """Map every port parameter to ``(jax path, transform)``, checking
    shapes, consumption and coverage. Works on shapes alone."""
    params = dict(module.named_parameters())
    plan: dict[str, tuple[tuple, str]] = {}
    unconsumed = []
    for path, leaf in _leaves(_unwrap(tree)):
        name, shape, transform = _target(path, tuple(leaf.shape))
        if name not in params:
            unconsumed.append("/".join(path))
            continue
        if tuple(params[name].shape) != shape:
            raise CarryError(
                f"{'/'.join(path)} {tuple(leaf.shape)} → {name}: port shape "
                f"{tuple(params[name].shape)}, expected {shape}")
        plan[name] = (path, transform)
    if unconsumed:
        raise CarryError(f"JAX leaves the port does not consume: {unconsumed}")
    unset = sorted(set(params) - set(plan))
    if unset:
        raise CarryError(f"port parameters the JAX tree does not set: {unset}")
    return plan


def _get(tree: Mapping, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def load_from_jax(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy the JAX tree's values into ``module`` (each cast to the
    parameter's dtype and device)."""
    tree = _unwrap(tree)
    params = dict(module.named_parameters())
    for name, (path, transform) in carry_plan(tree, module).items():
        value = np.asarray(_get(tree, path), dtype=np.float32)
        if transform == "t":
            value = value.T
        elif transform == "hwio":
            value = value.transpose(3, 2, 0, 1)
        params[name].copy_(torch.tensor(value))
    return module
