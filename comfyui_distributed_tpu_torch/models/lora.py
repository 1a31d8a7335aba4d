"""LoRA loading and merging, kohya ``.safetensors`` format (counterpart
of the JAX ``models/lora.py``).

Keys: ``lora_unet_{ldm_module_path_with_underscores}.lora_down.weight``
/ ``.lora_up.weight`` / ``.alpha`` for the UNet, ``lora_te_…`` (SD 1.5)
or ``lora_te1_…`` + ``lora_te2_…`` (SDXL) with HF ``CLIPTextModel``
paths for the text encoders.

The key map is recorded from the converter's own walks
(``convert._unet_layout``, ``convert._clip_hf_layout``), so a LoRA key
lands exactly where its base weight would, and the converter's layout
transform is applied to the delta (``W' = W + s·(α/r)·up·down``,
merged into a copy of the weight). The merged weights are plain
parameters: the attention sites read ``to_q``/``to_k``/``to_v`` on every
call, so a merged weight reaches the fused kernel (no packed-weight
cache stands in the way).

The bundle the registry holds is never changed: the patched bundle and
stack are copies that share every parameter the LoRA does not touch.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Mapping

import torch
from torch import nn

from ..utils.exceptions import ValidationError
from ..utils.logging import log
from ..utils.safetensors import load_file
from .convert import _clip_hf_layout, _unet_layout, linear_proj_of, records


def unet_records(config, linear_proj: bool = True,
                 prefix: str = "model.diffusion_model."):
    return records(_unet_layout, config, prefix, linear_proj)


def clip_hf_records(config, prefix: str = "text_model."):
    return records(_clip_hf_layout, config, prefix)


def _delta(down: torch.Tensor, up: torch.Tensor, alpha, tx,
           device: torch.device) -> torch.Tensor:
    """The torch-layout ΔW = (α/r)·up·down in fp32, then the converter's
    transform (every transform is a pure layout map)."""
    r = down.shape[0]
    scale = float(alpha) / r if alpha is not None else 1.0
    down = down.to(device, torch.float32)
    up = up.to(device, torch.float32)
    if down.ndim == 2:                       # Linear: [r, in] / [out, r]
        d = up @ down
    else:                                    # Conv: [r, in, k, k] / [out, r, 1, 1]
        d = (up.reshape(up.shape[0], -1) @ down.reshape(r, -1)).reshape(
            up.shape[0], *down.shape[1:])
    return tx.fwd(d * scale)


def collect_deltas(lora_sd: Mapping[str, torch.Tensor], recs,
                   lora_prefix: str, converter_prefix: str, strength: float,
                   device: torch.device) -> tuple[dict, set]:
    """Match LoRA keys against recorded converter entries: (parameter →
    delta in its layout, LoRA keys used)."""
    deltas: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    for src_key, dst, tx in recs:
        if (not src_key.endswith(".weight")
                or not src_key.startswith(converter_prefix)):
            continue
        base = src_key[len(converter_prefix):-len(".weight")]
        lkey = lora_prefix + base.replace(".", "_")
        dk, uk, ak = (f"{lkey}.lora_down.weight", f"{lkey}.lora_up.weight",
                      f"{lkey}.alpha")
        if dk not in lora_sd or uk not in lora_sd:
            continue
        alpha = lora_sd.get(ak)
        deltas[dst] = strength * _delta(lora_sd[dk], lora_sd[uk], alpha, tx,
                                        device)
        used.update({dk, uk})
        if ak in lora_sd:
            used.add(ak)
    return deltas, used


def _shallow(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with its own parameter and child tables, so
    that replacing an entry leaves the original alone."""
    clone = copy.copy(module)
    clone._parameters = dict(module._parameters)
    clone._buffers = dict(module._buffers)
    clone._modules = dict(module._modules)
    return clone


@torch.no_grad()
def apply_deltas(module: nn.Module, deltas: Mapping[str, torch.Tensor]
                 ) -> nn.Module:
    """A copy of ``module`` sharing every parameter not in ``deltas``, with
    ``W + ΔW`` (summed in fp32, stored in W's dtype) at each patched one;
    copy on write down each path. A shape mismatch raises."""
    root = _shallow(module)
    clones = {"": root}
    for dst, d in deltas.items():
        *path, leaf = dst.split(".")
        node, prefix = root, ""
        for part in path:
            prefix = f"{prefix}.{part}" if prefix else part
            if prefix not in clones:
                child = node._modules.get(part)
                if child is None:
                    raise ValidationError(f"LoRA target {dst!r} not in the model")
                clones[prefix] = node._modules[part] = _shallow(child)
            node = clones[prefix]
        base = node._parameters.get(leaf)
        if base is None:
            raise ValidationError(f"LoRA target {dst!r} not in the model")
        if tuple(base.shape) != tuple(d.shape):
            raise ValidationError(
                f"LoRA delta for {dst!r}: shape {tuple(d.shape)} != "
                f"{tuple(base.shape)}")
        node._parameters[leaf] = nn.Parameter(
            (base.float() + d.to(base.device)).to(base.dtype),
            requires_grad=False)
    return root


def load_lora_file(path: Path) -> dict[str, torch.Tensor]:
    return load_file(Path(path))


def apply_lora(bundle, lora_sd: Mapping[str, torch.Tensor], *,
               strength_model: float = 1.0, strength_clip: float = 1.0,
               name: str = "lora"):
    """Merge a kohya LoRA into copies of a UNet ``ModelBundle``'s UNet and
    CLIP stack. Returns ``(patched_bundle, patched_conditioner_or_None)``;
    ``patched_bundle.lora_merged`` is (UNet tensors, text-encoder tensors,
    LoRA keys unmatched)."""
    from .clip import CLIPConditioner

    if bundle.kind != "unet":
        raise ValidationError(
            f"LoRA merging supports unet-kind presets; {bundle.preset.name!r} "
            f"is {bundle.kind!r} (FLUX/video LoRA formats differ)")
    device = bundle.pipeline.device
    cfg = bundle.preset.unet
    deltas, used = collect_deltas(
        lora_sd, unet_records(cfg, linear_proj=linear_proj_of(cfg)),
        "lora_unet_", "model.diffusion_model.", strength_model, device)

    patched = copy.copy(bundle)
    patched.pipeline = copy.copy(bundle.pipeline)
    patched.pipeline._control_clones = {}    # never share pre-LoRA clones
    patched.pipeline.timings = {}
    if deltas and strength_model:
        patched.pipeline.unet = apply_deltas(bundle.pipeline.unet, deltas)

    conditioner = None
    n_te = 0
    stack = bundle.clip_stack
    if stack is not None and strength_clip:
        if bundle.preset.clip == "sdxl":
            parts = [("lora_te1_", "clip_l", stack.clip_l),
                     ("lora_te2_", "clip_g", stack.clip_g)]
        else:
            parts = [("lora_te_", "", stack)]
        te_deltas: dict[str, torch.Tensor] = {}
        for prefix, attr, enc in parts:
            d, u = collect_deltas(lora_sd, clip_hf_records(enc.config),
                                  prefix + "text_model_", "text_model.",
                                  strength_clip, device)
            used |= u
            te_deltas.update({f"{attr}.{k}" if attr else k: v
                              for k, v in d.items()})
        n_te = len(te_deltas)
        new_stack = apply_deltas(stack, te_deltas) if te_deltas else stack
        patched.clip_stack = new_stack
        old = bundle.text_encoder
        conditioner = CLIPConditioner(new_stack, kind=bundle.preset.clip,
                                      tok_l=getattr(old, "tok_l", None),
                                      tok_g=getattr(old, "tok_g", None))
        # the bundle's own encoder conditions with the LoRA too; a patched
        # encoder carries no cache identity
        patched.text_encoder = conditioner

    unmatched = [k for k in lora_sd if k not in used]
    patched.lora_merged = (len(deltas), n_te, len(unmatched))
    log(f"LoRA {name!r}: merged {len(deltas)} unet tensors"
        f"{f' + {n_te} text-encoder tensors' if n_te else ''}"
        f"{f' ({len(unmatched)} keys unmatched)' if unmatched else ''}")
    if unmatched:
        log(f"LoRA {name!r} unmatched keys (first 4): {unmatched[:4]}")
    return patched, conditioner
