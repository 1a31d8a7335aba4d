"""The programs a mesh runs on every rank (``MeshRuntime.run``), by name.

Each takes the rank's bundle (rank 0's own; a follower's from its
registry) and the call's arguments, and runs under the rank's mesh
(``parallel/mesh.current_mesh``):

- ``txt2img_dp`` — the UNet pipeline's ``dp`` fan-out
  (``Txt2ImgPipeline.generate_mesh``; ``decode=False``: its latent form,
  the stage pools');
- ``txt2img_tp`` — one request of a tensor-parallel group
  (``Txt2ImgPipeline.generate_tp`` on the rank's shard; ``decode=False``:
  the staged lane's latents, which rank 0 decodes);
- ``flow_dp`` / ``flow_sp`` / ``flow_tp`` — the flow pipeline's ``dp``
  fan-out, its sequence-parallel single image and its tensor-parallel
  form (``FlowPipeline.generate_mesh``, ``generate_sp``,
  ``generate_tp``);
- ``video_dp`` / ``video_i2v_dp``, ``video_sp`` / ``video_i2v_sp`` and
  ``video_tp`` — the video pipeline's t2v and i2v ``dp`` fan-out, one
  video's frames over ``sp`` and its tensor-parallel t2v form, both
  experts of a two-expert bundle split (``VideoPipeline.generate_mesh``,
  ``generate_sp``, ``generate_tp``);
- ``param_digest`` — a digest of the bundle's parameters, computed on the
  rank's device (every rank's comes back: the ranks hold the same
  weights bit for bit); ``shard_digest`` — the same of the rank's shard,
  with its bytes (each must be the slice of rank 0's parameters);
- ``warm`` — the warm pass's mesh recipe: every rank builds its bundle
  (``flow_sp``) or, with a strategy mesh's ``axes``, its shard
  (``flow_tp``), and stops;
- ``apply`` — one of the port's mesh functions (``_functions``: the
  collectives and the mesh attentions) on this rank's
  input from a list of one input per rank; every rank's output comes
  back. The tests and ``chip_smoke.py`` hold these against their plain
  versions through it.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Mapping, Optional

import torch

from ..utils import constants

PROGRAMS: dict[str, Callable] = {}
# programs that run on the rank's tensor-parallel shard
SHARDED = frozenset({"txt2img_tp", "flow_tp", "video_tp", "shard_digest"})
# the dp programs: on a mesh with a tp axis, the tp-index-0 ranks alone
DP_PROGRAMS = frozenset({"txt2img_dp", "flow_dp", "video_dp",
                         "video_i2v_dp"})


def program(fn: Callable) -> Callable:
    PROGRAMS[fn.__name__] = fn
    return fn


def idle(program: str, mesh, layout: Optional[str]) -> bool:
    """Whether this rank sits a call out: a ``dp`` program on a mesh with
    a tp axis, on a rank of tp index above 0 (module docstring)."""
    tp = constants.AXIS_TENSOR
    return (program in DP_PROGRAMS and layout is None
            and mesh.axes.get(tp, 1) > 1 and mesh.coords()[tp] != 0)


def shard_coords(program: str, mesh, kwargs: Mapping
                 ) -> Optional[tuple[int, int]]:
    """(tp index, tp size) of this rank's shard for a call, or None when
    the program runs on the whole bundle: the mesh's tp coordinate, or,
    for ``warm``, the coordinate under the strategy mesh it is given."""
    tp = constants.AXIS_TENSOR
    if program == "warm":
        axes = kwargs.get("axes") or {}
        if axes.get(tp, 1) <= 1:
            return None
        from .mesh import _unravel

        coords = dict(zip(axes, _unravel(mesh.rank, tuple(axes.values()))))
        return coords[tp], axes[tp]
    if program not in SHARDED:
        return None
    if tp not in mesh.axes:
        return 0, 1
    return mesh.coords()[tp], mesh.axes[tp]


def shard_of(bundle, coords: tuple[int, int]):
    """The rank's shard pipeline: a follower's ``ShardBundle`` as built,
    else the slices of the bundle's own pipeline
    (``parallel/tensor.shard_pipeline``, kept on it)."""
    from .tensor import shard_pipeline

    index, size = coords
    if getattr(bundle, "shard", None) == coords:
        return bundle.pipeline
    return shard_pipeline(bundle.pipeline, index, size,
                          constants.AXIS_TENSOR)


def _coords(program: str, kwargs: Optional[dict] = None):
    from .mesh import current_mesh

    return shard_coords(program, current_mesh(), kwargs or {})


@program
def txt2img_dp(bundle, spec, seed: int, context, uncond_context, y=None,
               uncond_y=None, axis: str = "dp", noises=None,
               progress_token: Optional[int] = None, decode: bool = True):
    return bundle.pipeline.generate_mesh(
        spec, seed, context, uncond_context, y, uncond_y, axis=axis,
        noises=noises, progress_token=progress_token, decode=decode)


@program
def txt2img_tp(bundle, spec, seed: int, context, uncond_context, y=None,
               uncond_y=None, noises=None,
               progress_token: Optional[int] = None, decode: bool = True):
    return shard_of(bundle, _coords("txt2img_tp")).generate_tp(
        spec, seed, context, uncond_context, y, uncond_y, noises=noises,
        progress_token=progress_token, decode=decode)


@program
def flow_dp(bundle, spec, seed: int, context, pooled, uncond_context=None,
            uncond_pooled=None, axis: str = "dp", noises=None,
            progress_token: Optional[int] = None):
    return bundle.pipeline.generate_mesh(
        spec, seed, context, pooled, uncond_context, uncond_pooled,
        axis=axis, noises=noises, progress_token=progress_token)


@program
def flow_tp(bundle, spec, seed: int, context, pooled, noises=None,
            progress_token: Optional[int] = None):
    return shard_of(bundle, _coords("flow_tp")).generate_tp(
        spec, seed, context, pooled, noises=noises,
        progress_token=progress_token)


@program
def flow_sp(bundle, spec, seed: int, context, pooled, uncond_context=None,
            uncond_pooled=None, axis: str = "sp", noise=None):
    return bundle.pipeline.generate_sp(
        spec, seed, context, pooled, uncond_context, uncond_pooled,
        axis=axis, noise=noise)


@program
def video_dp(bundle, spec, seed: int, context, pooled, axis: str = "dp",
             noises=None, progress_token: Optional[int] = None):
    return bundle.pipeline.generate_mesh(
        spec, seed, context, pooled, axis=axis, noises=noises,
        progress_token=progress_token)


@program
def video_i2v_dp(bundle, spec, seed: int, image, context, pooled,
                 axis: str = "dp", noises=None,
                 progress_token: Optional[int] = None):
    return bundle.pipeline.generate_mesh(
        spec, seed, context, pooled, axis=axis, noises=noises,
        progress_token=progress_token, image=image)


@program
def video_sp(bundle, spec, seed: int, context, pooled, axis: str = "sp",
             noise=None):
    return bundle.pipeline.generate_sp(spec, seed, context, pooled,
                                       axis=axis, noise=noise)


@program
def video_i2v_sp(bundle, spec, seed: int, image, context, pooled,
                 axis: str = "sp", noise=None):
    return bundle.pipeline.generate_sp(spec, seed, context, pooled,
                                       axis=axis, noise=noise, image=image)


@program
def video_tp(bundle, spec, seed: int, context, pooled, noises=None,
             progress_token: Optional[int] = None):
    return shard_of(bundle, _coords("video_tp")).generate_tp(
        spec, seed, context, pooled, noises=noises,
        progress_token=progress_token)


def bundle_params(bundle) -> dict[str, torch.Tensor]:
    """Every parameter of a bundle's state entries, by dotted name."""
    return {f"{entry}.{name}": p
            for entry, module in bundle._state_entries().items()
            for name, p in module.named_parameters()}


def param_digest_of(params) -> str:
    """A digest of every parameter's dtype, shape and bytes (a mapping, or
    (name, tensor) pairs, consumed one at a time): two 64-bit sums of its
    8/16/32-bit words (plain, and weighted by a hash of the word's
    position), computed on the parameter's device, hashed together in
    the given order."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    h = hashlib.sha256()
    items = params.items() if isinstance(params, Mapping) else params
    with torch.no_grad():
        for name, p in items:
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


@program
def shard_digest(bundle) -> dict:
    """The digest and bytes of this rank's shard of the bundle's core
    (``parallel/tensor.shard_params`` names and order), and of a
    two-expert bundle's low expert (``digest_low``)."""
    from .tensor import cores_of, shard_bytes

    cores = cores_of(shard_of(bundle, _coords("shard_digest")))
    out = {"digest": param_digest_of(cores[0].named_parameters()),
           "bytes": shard_bytes(cores)}
    if len(cores) > 1:
        out["digest_low"] = param_digest_of(cores[1].named_parameters())
    return out


@program
def warm(bundle, axes: Optional[dict] = None) -> None:
    """Build this rank's bundle (resolved before the call) or, under a
    strategy mesh ``axes`` with a tp axis, its shard, and stop."""
    coords = _coords("warm", {"axes": axes})
    if coords is not None:
        shard_of(bundle, coords)


def _functions() -> dict[str, Callable]:
    from ..ops import attention
    from . import collectives

    return {
        "gather_batch": collectives.gather_batch,
        "tp_sum": collectives.tp_sum,
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
