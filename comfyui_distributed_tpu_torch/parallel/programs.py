"""The programs a mesh runs on every rank (``MeshRuntime.run``), by name.

Each takes the rank's bundle (rank 0's own; a follower's from its
registry) and the call's arguments, and runs under the rank's mesh
(``parallel/mesh.current_mesh``):

- ``txt2img_dp`` — the UNet pipeline's ``dp`` fan-out
  (``Txt2ImgPipeline.generate_mesh``);
- ``flow_dp`` / ``flow_sp`` — the flow pipeline's ``dp`` fan-out and its
  sequence-parallel single image (``FlowPipeline.generate_mesh``,
  ``generate_sp``);
- ``param_digest`` — a digest of the bundle's parameters, computed on the
  rank's device (every rank's comes back: the ranks hold the same
  weights bit for bit);
- ``apply`` — one of the port's mesh functions (``_functions``: the
  collectives and the mesh attentions) on this rank's
  input from a list of one input per rank; every rank's output comes
  back. The tests and ``chip_smoke.py`` hold these against their plain
  versions through it.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Optional

import torch

PROGRAMS: dict[str, Callable] = {}


def program(fn: Callable) -> Callable:
    PROGRAMS[fn.__name__] = fn
    return fn


@program
def txt2img_dp(bundle, spec, seed: int, context, uncond_context, y=None,
               uncond_y=None, axis: str = "dp", noises=None,
               progress_token: Optional[int] = None):
    return bundle.pipeline.generate_mesh(
        spec, seed, context, uncond_context, y, uncond_y, axis=axis,
        noises=noises, progress_token=progress_token)


@program
def flow_dp(bundle, spec, seed: int, context, pooled, uncond_context=None,
            uncond_pooled=None, axis: str = "dp", noises=None,
            progress_token: Optional[int] = None):
    return bundle.pipeline.generate_mesh(
        spec, seed, context, pooled, uncond_context, uncond_pooled,
        axis=axis, noises=noises, progress_token=progress_token)


@program
def flow_sp(bundle, spec, seed: int, context, pooled, uncond_context=None,
            uncond_pooled=None, axis: str = "sp", noise=None):
    return bundle.pipeline.generate_sp(
        spec, seed, context, pooled, uncond_context, uncond_pooled,
        axis=axis, noise=noise)


def bundle_params(bundle) -> dict[str, torch.Tensor]:
    """Every parameter of a bundle's state entries, by dotted name."""
    return {f"{entry}.{name}": p
            for entry, module in bundle._state_entries().items()
            for name, p in module.named_parameters()}


def param_digest_of(params: dict[str, torch.Tensor]) -> str:
    """A digest of every parameter's dtype, shape and bytes: two 64-bit
    sums of its 8/16/32-bit words (plain, and weighted by a hash of the
    word's position), computed on the parameter's device, hashed
    together in name order."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    h = hashlib.sha256()
    with torch.no_grad():
        for name, p in params.items():
            w = p.detach().reshape(-1).view(ints[p.element_size()])
            plain = torch.zeros((), dtype=torch.int64, device=w.device)
            mixed = torch.zeros((), dtype=torch.int64, device=w.device)
            for start in range(0, w.numel(), 1 << 26):
                chunk = w[start:start + (1 << 26)].long()
                pos = torch.arange(start, start + chunk.numel(),
                                   device=w.device)
                plain += chunk.sum()
                mixed += (chunk * ((pos * 2654435761) % 2147483647 + 1)).sum()
            h.update(f"{name}|{p.dtype}|{tuple(p.shape)}|{int(plain)}|"
                     f"{int(mixed)};".encode())
    return h.hexdigest()


@program
def param_digest(bundle) -> str:
    return param_digest_of(bundle_params(bundle))


def _functions() -> dict[str, Callable]:
    from ..ops import attention
    from . import collectives

    return {
        "gather_batch": collectives.gather_batch,
        "all_gather": collectives.all_gather,
        "ring_shift": collectives.ring_shift,
        "all_to_all_heads": collectives.all_to_all_heads,
        "shard_index": lambda x, axis: x + collectives.shard_index(axis),
        "ring_attention": attention.ring_attention,
        "joint_ring_attention": attention.joint_ring_attention,
        "ulysses_attention": attention.ulysses_attention,
    }


@program
def apply(bundle, function: str, inputs: list, kwargs: Optional[dict] = None
          ) -> Any:
    """``function`` on this rank's entry of ``inputs`` (a tensor or a
    tuple of tensors, moved to the rank's device), with ``kwargs``."""
    from .mesh import current_mesh

    mesh = current_mesh()
    mine = inputs[mesh.rank]
    if isinstance(mine, torch.Tensor):
        mine = (mine,)
    args = tuple(t.to(mesh.device) for t in mine)
    return _functions()[function](*args, **(kwargs or {}))
