"""Tensor parallelism: weights split over the ``tp`` mesh axis
(counterpart of the JAX package's ``parallel/tensor.py``).

The Megatron rules of the JAX package, translated to the port's
parameter names and to ``nn.Linear``'s ``[out, in]`` layout:

- a **column**-parallel weight (q/k/v, the MLP's up projection) splits
  dim 0, its bias with it: each rank computes its own heads, its own
  slice of the hidden layer;
- a **row**-parallel weight (the attention's output, the MLP's down
  projection) splits dim 1; each rank's partial product is summed over
  the axis (``collectives.tp_sum``, GSPMD's inserted all-reduce) and the
  bias, replicated, is added once, after the sum (:func:`row_parallel`);
- everything else (norms, embeddings, modulation, convolutions, the VAE)
  is replicated.

JAX's ``("tp", None)`` specs are GSPMD layouts: XLA reshuffles whatever
a contiguous split leaves misaligned. The port has no such pass, so it
splits the fused layouts **by head and by part**: each rule carries the
relative widths of the parts its split dim is made of (``(1, 1, 1)``
for FLUX's q|k|v, ``(1, 1)`` for GEGLU's value|gate, ``(1, 4)`` for the
single block's ``out`` over attention|MLP columns), and a rank takes its
1/tp of each part. A rank thus runs its H/tp heads and its 1/tp of the
MLP; only the order of summation changes.

The same fallback as JAX: a dim that does not divide is replicated. The
port decides it per **unit** (a UNet attention site or GEGLU, a DiT
block, a WAN attention site or feed-forward), because a unit's column
and row weights must split together, and a unit whose heads do not
divide stays whole on every rank. A WAN attention site also splits its
qk-norm scales with its heads: JAX's rules leave them whole, and GSPMD
all-reduces the norm's statistics; the port's shard normalises over the
full width the same way (``models/wan.WanRMSNorm``).
:func:`spec_for_param` and :func:`tp_sharding_summary` give JAX's
per-parameter answer, which the residency planner counts
(``cluster/residency.tp_shard_bytes``).

A shard is a copy of the model's structure: its replicated parameters
are the whole model's tensors (rank 0 keeps no second copy of them), its
split ones the rank's slices, views where the slice is contiguous
(:func:`shard_module`); a follower draws or loads it without the whole
model (``parallel/bootstrap``). A video pipeline's shard holds both
experts' shards (:func:`shard_pipeline`).
"""

from __future__ import annotations

import copy
import re
from typing import Callable, Iterable, Iterator, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.logging import debug_log

# (name regex, spec over the port's [out, in] weight, parts of the split
# dim); "tp" marks the split dim
Rule = tuple[str, tuple, tuple]

DIT_TP_RULES: tuple[Rule, ...] = (
    (r".*qkv\.qkv\.weight$", ("tp", None), (1, 1, 1)),          # column
    (r".*mlp_up\.weight$", ("tp", None), (1,)),                   # column
    (r".*(img|txt)_proj\.weight$", (None, "tp"), (1,)),           # row
    (r".*mlp_down\.weight$", (None, "tp"), (1,)),                 # row
    (r".*single_\d+\.out\.weight$", (None, "tp"), (1, 4)),        # row
)

UNET_TP_RULES: tuple[Rule, ...] = (
    (r".*to_q\.weight$", ("tp", None), (1,)),
    (r".*to_k\.weight$", ("tp", None), (1,)),
    (r".*to_v\.weight$", ("tp", None), (1,)),
    (r".*to_out\.weight$", (None, "tp"), (1,)),
    (r".*ff\.proj_in\.weight$", ("tp", None), (1, 1)),
    (r".*ff\.proj_out\.weight$", (None, "tp"), (1,)),
)

# WAN-class video DiT: q/k/v/o of the self- and cross-attention, ffn_0
# up, ffn_2 down
WAN_TP_RULES: tuple[Rule, ...] = (
    (r".*(self|cross)_attn\.[qkv]\.weight$", ("tp", None), (1,)),
    (r".*(self|cross)_attn\.o\.weight$", (None, "tp"), (1,)),
    (r".*ffn_0\.weight$", ("tp", None), (1,)),
    (r".*ffn_2\.weight$", (None, "tp"), (1,)),
)


def _match(name: str, rules: Sequence[Rule]):
    for rule in rules:
        if re.match(rule[0], name):
            return rule
    return None


def spec_for_param(name: str, shape: tuple, rules: Sequence[Rule],
                   axis: str = "tp", axis_size: int = 1) -> tuple:
    """JAX's answer for one parameter: its spec with ``axis`` on the split
    dim, or ``()`` (replicated) when no rule matches or the dim does not
    divide by ``axis_size``."""
    for pattern, dims, _ in rules:
        if not re.match(pattern, name):
            continue
        if len(dims) == len(shape) and all(
                d is None or shape[i] % axis_size == 0
                for i, d in enumerate(dims)):
            return tuple(axis if d == "tp" else None for d in dims)
        debug_log(f"tp rule {pattern} skipped for {name} (shape {shape})")
    return ()


def _named(params) -> Iterable[tuple[str, torch.Tensor]]:
    if isinstance(params, nn.Module):
        return params.named_parameters()
    return params.items() if isinstance(params, Mapping) else params


def tp_sharding_summary(params, rules: Sequence[Rule] = DIT_TP_RULES,
                        axis_size: int = 2) -> dict[str, int]:
    """How many parameters (and bytes) the rules split or replicate at
    ``axis_size`` (JAX's per-parameter arithmetic)."""
    out = {"sharded": 0, "replicated": 0, "sharded_bytes": 0,
           "replicated_bytes": 0}
    for name, p in _named(params):
        nbytes = p.numel() * p.element_size()
        kind = ("sharded" if spec_for_param(name, tuple(p.shape), rules,
                                            "tp", axis_size)
                else "replicated")
        out[kind] += 1
        out[f"{kind}_bytes"] += nbytes
    return out


def require_tp_match(params, rules: Sequence[Rule], axis_size: int,
                     family: str) -> None:
    """JAX's fail-fast: a tp degree above one over a model no rule
    matches would hold the whole model on every rank."""
    if axis_size <= 1:
        return
    if tp_sharding_summary(params, rules, axis_size)["sharded"] == 0:
        raise ValueError(
            f"no parameters matched the {family!r} TP rules — a model "
            f"this mode exists for would OOM every chip with "
            f"fully-replicated weights")


def rules_for(core: nn.Module) -> tuple[Rule, ...]:
    """The table a core shards (or plans) by."""
    from ..models.unet import UNet2D
    from ..models.wan import WanModel

    if isinstance(core, UNet2D):
        return UNET_TP_RULES
    return WAN_TP_RULES if isinstance(core, WanModel) else DIT_TP_RULES


def family_of(core: nn.Module) -> str:
    from ..models.unet import UNet2D
    from ..models.wan import WanModel

    if isinstance(core, UNet2D):
        return "unet"
    return "wan" if isinstance(core, WanModel) else "dit"


# --- units and the plan --------------------------------------------------------


def _unit_heads(module: nn.Module) -> Optional[int]:
    """The head count a unit's split must divide (None: no attention), or
    -1 when ``module`` is no unit."""
    from ..models.dit import DoubleBlock, SingleBlock
    from ..models.layers import GEGLU, Attention
    from ..models.wan import WanAttention, WanBlock

    if isinstance(module, Attention):
        return module.num_heads
    if isinstance(module, (DoubleBlock, SingleBlock, WanAttention)):
        return module.heads
    if isinstance(module, (GEGLU, WanBlock)):
        return None
    return -1


def _unit_params(unit: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """The parameters a unit splits or keeps: all of its own, but a WAN
    block's feed-forward only (its attention sites are units of their
    own)."""
    from ..models.wan import WanBlock

    params = list(unit.named_parameters())
    if isinstance(unit, WanBlock):
        return [(n, p) for n, p in params if n.startswith("ffn_")]
    return params


def tp_units(core: nn.Module) -> list[tuple[str, nn.Module]]:
    """The core's units in ``named_modules`` order (module docstring)."""
    return [(n, m) for n, m in core.named_modules() if _unit_heads(m) != -1]


def shard_plan(core: nn.Module, size: int,
               rules: Optional[Sequence[Rule]] = None
               ) -> dict[str, tuple[int, tuple]]:
    """``{parameter name: (split dim, parts)}`` of every parameter a rank
    holds a slice of at ``size`` ranks: a unit's rule-matched weights
    (and the biases of its column weights) when every one of them
    divides, part by part, and its heads divide; nothing at size 1."""
    if size <= 1:
        return {}
    from ..models.wan import WanAttention

    rules = rules_for(core) if rules is None else rules
    plan: dict[str, tuple[int, tuple]] = {}
    names = {n for n, _ in core.named_parameters()}
    for uname, unit in tp_units(core):
        heads = _unit_heads(unit)
        if heads is not None and heads % size:
            continue
        mine: dict[str, tuple[int, tuple]] = {}
        ok = True
        for pname, p in _unit_params(unit):
            name = f"{uname}.{pname}" if uname else pname
            rule = _match(name, rules)
            if rule is None:
                continue
            dim = rule[1].index("tp")
            parts = rule[2]
            width = p.shape[dim]
            if width % sum(parts) or any(
                    (width // sum(parts) * w) % size for w in parts):
                ok = False
                break
            mine[name] = (dim, parts)
            if dim == 0:
                bias = name[:-len("weight")] + "bias"
                if bias in names:
                    mine[bias] = (0, parts)
        if ok and mine and isinstance(unit, WanAttention):
            # the qk-norm scales, with their heads (module docstring)
            for norm in ("norm_q", "norm_k"):
                mine[f"{uname}.{norm}.weight"] = (0, (1,))
        if ok and mine:
            plan.update(mine)
    return plan


def shard_tensor(t: torch.Tensor, dim: int, parts: tuple, index: int,
                 size: int) -> torch.Tensor:
    """Rank ``index``'s slice of ``t`` along ``dim``: its 1/``size`` of
    each part, concatenated. A view when that is one contiguous range."""
    unit = t.shape[dim] // sum(parts)
    pieces, start = [], 0
    for w in parts:
        step = unit * w // size
        pieces.append(t.narrow(dim, start + index * step, step))
        start += unit * w
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def shard_copy_bytes(core: nn.Module, size: int) -> int:
    """Bytes of one rank's split tensors that :func:`shard_module` copies
    (a slice of several parts; a slice of one is a view of ``core``'s)."""
    return sum(core.get_parameter(name).numel()
               * core.get_parameter(name).element_size() // size
               for name, (_, parts) in shard_plan(core, size).items()
               if len(parts) > 1)


def shard_params(core: nn.Module, index: int, size: int,
                 plan: Optional[dict] = None
                 ) -> Iterator[tuple[str, torch.Tensor]]:
    """Every parameter of rank ``index``'s shard, by name, in the core's
    order: the slice of a split one, the whole tensor of a replicated
    one. Lazy: one slice at a time (a digest of a rank's shard)."""
    plan = shard_plan(core, size) if plan is None else plan
    for name, p in core.named_parameters():
        if name in plan:
            yield name, shard_tensor(p.detach(), *plan[name], index, size)
        else:
            yield name, p


def mark_tp(shard: nn.Module, plan: dict, size: int, axis: str) -> None:
    """Set the shard's units to their local geometry and their
    row-parallel sums to ``axis``: the units whose parameters the plan
    splits."""
    from ..models.dit import _QKV, DoubleBlock, SingleBlock
    from ..models.layers import Attention
    from ..models.wan import WanAttention

    for uname, unit in tp_units(shard):
        prefix = f"{uname}." if uname else ""
        if not any(prefix + n in plan for n, _ in _unit_params(unit)):
            continue
        unit.tp_axis = axis
        if isinstance(unit, Attention):
            unit.num_heads //= size
        elif isinstance(unit, (DoubleBlock, SingleBlock)):
            unit.heads //= size
            for qkv in unit.modules():
                if isinstance(qkv, _QKV):
                    qkv.heads //= size
        elif isinstance(unit, WanAttention):
            unit.heads //= size
            unit.norm_q.tp_axis = unit.norm_k.tp_axis = axis


def shard_module(core: nn.Module, index: int, size: int, axis: str = "tp",
                 plan: Optional[dict] = None) -> nn.Module:
    """Rank ``index``'s shard of ``core`` (module docstring): the
    structure copied, the replicated parameters shared with ``core``,
    the split ones sliced (views of ``core``'s where a slice is one
    range)."""
    plan = shard_plan(core, size) if plan is None else plan
    memo = {id(t): t for t in [*core.parameters(), *core.buffers()]}
    shard = copy.deepcopy(core, memo)
    for name, t in shard_params(core, index, size, plan):
        if name in plan:
            _set_param(shard, name, t)
    mark_tp(shard, plan, size, axis)
    return shard.eval().requires_grad_(False)


def _set_param(module: nn.Module, name: str, t: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    module._parameters[leaf] = nn.Parameter(t, requires_grad=False)


def draw_shard(build: Callable[[], nn.Module], device: torch.device,
               generator: torch.Generator, index: int, size: int,
               axis: str = "tp") -> nn.Module:
    """Rank ``index``'s shard of a random-init core, drawn without the
    whole core: built on ``meta``, each module's own parameters drawn in
    turn (``flax_init_one``, in ``modules()`` order: the whole core's
    draws), a split one cut to its slice at once. The shard is the slice
    of what ``flax_init_`` draws for the whole core from the same
    generator state."""
    from ..models.layers import flax_init_one

    with torch.device("meta"):
        core = build()
    core.eval().requires_grad_(False)
    plan = shard_plan(core, size)
    with torch.no_grad():
        for mname, sub in core.named_modules():
            for bname, b in list(sub._buffers.items()):
                if b is not None and b.is_meta:
                    sub._buffers[bname] = torch.empty_like(b, device=device)
            own = [n for n, p in sub._parameters.items() if p is not None]
            for pname in own:
                sub._parameters[pname] = nn.Parameter(
                    torch.empty_like(sub._parameters[pname], device=device),
                    requires_grad=False)
            flax_init_one(sub, generator)
            for pname in own:
                name = f"{mname}.{pname}" if mname else pname
                if name in plan:
                    # a copy, also of a contiguous slice: a view would
                    # keep the whole tensor's storage alive
                    full = sub._parameters[pname]
                    sub._parameters[pname] = nn.Parameter(
                        shard_tensor(full, *plan[name], index, size).clone(
                            memory_format=torch.contiguous_format),
                        requires_grad=False)
                    del full
    mark_tp(core, plan, size, axis)
    return core


def row_parallel(linear: nn.Linear, x: torch.Tensor,
                 axis: str) -> torch.Tensor:
    """A row-parallel Linear: this rank's partial product over its input
    columns, summed over ``axis``, then the bias once."""
    from .collectives import tp_sum

    y = tp_sum(F.linear(x, linear.weight), axis)
    return y if linear.bias is None else y + linear.bias


def shard_bytes(modules) -> int:
    """Bytes of a shard's distinct parameters on its device (a module, or
    a list of them: a two-expert shard's)."""
    from ..cluster.residency import _param_bytes

    modules = [modules] if isinstance(modules, nn.Module) else list(modules)
    return _param_bytes(modules, next(modules[0].parameters()).device)


def shard_pipeline(pipeline, index: int, size: int, axis: str = "tp"):
    """``pipeline`` with its core (UNet, DiT or video transformer, and a
    two-expert pipeline's low expert) replaced by rank ``index``'s shard
    of ``size``; the VAE and everything else shared. Kept on the
    pipeline, one per (index, size, axis), at most two (JAX's
    ``_tp_weights_cache``: one sharded copy per mesh)."""
    cache = pipeline.__dict__.setdefault("_tp_shards", {})
    key = (index, size, axis)
    shard = cache.get(key)
    if shard is None:
        attr = "unet" if getattr(pipeline, "unet", None) is not None else "dit"
        core = getattr(pipeline, attr)
        require_tp_match(core, rules_for(core), size, family_of(core))
        shard = copy.copy(pipeline)
        for private in ("_tp_shards", "_control_clones"):
            shard.__dict__.pop(private, None)
        shard.timings = {}
        setattr(shard, attr, shard_module(core, index, size, axis))
        low = getattr(pipeline, "dit_low", None)
        if low is not None:
            shard.dit_low = shard_module(low, index, size, axis)
        if len(cache) >= 2:
            cache.pop(next(iter(cache)))
        cache[key] = shard
    return shard


def core_of(pipeline) -> nn.Module:
    unet = getattr(pipeline, "unet", None)
    return unet if unet is not None else pipeline.dit


def cores_of(pipeline) -> list[nn.Module]:
    """The pipeline's core and, for two experts, the low one."""
    low = getattr(pipeline, "dit_low", None)
    return [core_of(pipeline)] + ([low] if low is not None else [])
