"""The port's node set: the nodes of the txt2img workflows
(``workflows/distributed-txt2img.json``, ``workflows/flux-txt2img.json``),
of the upscale workflow (``workflows/distributed-upscale.json``:
``LoadImage``, ``UpscaleModelLoader``, ``ImageUpscaleWithModel``,
``UltimateSDUpscaleDistributed``), img2img, inpainting and ControlNet
(``TPUImg2Img``, ``TPUInpaint``, ``ControlNetLoader``, ``ControlNetApply``)
with the image, mask and latent nodes around them, ``LoraLoader``,
``ModelSamplingSD3`` (the flow shift the flow and video samplers read
when their own ``shift`` is not wired), the
audio and video nodes (``LoadAudio``, ``SaveAudio``, ``AudioBatchDivider``,
``LoadVideo``, ``SaveVideo`` and their VHS aliases), the primitives, the
remaining distributed nodes (``DistributedModelName``,
``ImageBatchDivider``), and the two the control plane injects
(``DistributedEmptyImage``, ``PreviewImage``), and the video samplers
(``TPUTxt2Video``, ``TPUImg2Video``: WAN t2v and i2v, one video on the
bundle's device, its frames as one IMAGE batch), with the JAX package's
names and contracts.

Graph value conventions, as in the JAX package: IMAGE = float32
[B,H,W,C] in [0,1]; MASK = float32 [B,H,W]; LATENT = {"samples":
[B,h,w,C]}; CONDITIONING = {"context": [1,N,D], "pooled": [1,P]}, with a
ControlNet under ``"control"``: {"model", "hint" [B,H,W,C], "strength"};
MODEL = ModelBundle (or a proxy of one); AUDIO = {"waveform": float32 [B,C,S] on the CPU,
"sample_rate": int} (``utils/audio_payload.py`` says why it stays on
the host). Tensors stay on the bundle's device until ``SaveImage`` or
``SaveVideo`` copies them to the host.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import constants
from ..utils.device import resolve_device
from ..utils.exceptions import ValidationError
from ..utils.logging import log
from .node import NODE_REGISTRY, NodeDef, register_node


def _chunk_bounds(total: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous chunk bounds, sizes differing by at most 1, the larger
    chunks first."""
    parts = max(1, min(parts, total)) if total > 0 else 1
    base, extra = divmod(total, parts)
    bounds, start = [], 0
    for i in range(parts):
        size = base + (1 if i < extra else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def _device(model_registry):
    return (model_registry.device if model_registry is not None
            else resolve_device())


@register_node("DistributedSeed")
class DistributedSeed(NodeDef):
    """Master passes ``seed`` through; worker N yields ``seed + N + 1``."""

    INPUTS = {"seed": "INT"}
    HIDDEN = {"is_worker": "BOOLEAN", "worker_id": "STRING", "worker_index": "INT"}
    RETURNS = ("INT",)

    def execute(self, seed: int, is_worker: bool = False, worker_id: str = "",
                worker_index: int = 0, **_):
        if not is_worker:
            return (int(seed),)
        return (int(seed) + int(worker_index) + 1,)


@register_node("DistributedValue")
class DistributedValue(NodeDef):
    """Per-worker override with typed coercion and default fallback:
    ``worker_values`` is a JSON map of 1-indexed worker number → value."""

    INPUTS = {"default_value": "*"}
    OPTIONAL = {"worker_values": "STRING", "value_type": "STRING"}
    HIDDEN = {"is_worker": "BOOLEAN", "worker_id": "STRING", "worker_index": "INT"}
    RETURNS = ("*",)

    _COERCERS = {
        "INT": lambda v: int(float(v)),
        "FLOAT": float,
        "STRING": str,
        "COMBO": str,
    }

    def _coerce(self, value: Any, value_type: str) -> Any:
        fn = self._COERCERS.get(value_type.upper())
        if fn is None:
            return value
        try:
            return fn(value)
        except (TypeError, ValueError):
            raise ValidationError(
                f"cannot coerce {value!r} to {value_type}", field="worker_values")

    def execute(self, default_value, worker_values: str = "", value_type: str = "",
                is_worker: bool = False, worker_id: str = "", worker_index: int = 0,
                **_):
        if not is_worker or not worker_values:
            return (default_value,)
        try:
            mapping = json.loads(worker_values)
        except json.JSONDecodeError:
            return (default_value,)
        key = str(int(worker_index) + 1)
        if key not in mapping:
            return (default_value,)
        vtype = value_type or mapping.get("_type", "")
        return (self._coerce(mapping[key], vtype) if vtype else mapping[key],)


@register_node("DistributedModelName")
class DistributedModelName(NodeDef):
    """Output node passing a model name through as a string, so that a
    delegate-mode worker can load a model the master lacks."""

    INPUTS = {"model_name": "*"}
    HIDDEN = {"is_worker": "BOOLEAN", "worker_id": "STRING"}
    RETURNS = ("STRING",)
    OUTPUT_NODE = True

    def execute(self, model_name, **_):
        return (str(model_name),)


@register_node("ImageBatchDivider")
class ImageBatchDivider(NodeDef):
    """Split an IMAGE batch into up to 10 contiguous chunks on the
    registry's device; the outputs past the chunks are the empty batch."""

    INPUTS = {"images": "IMAGE", "divide_by": "INT"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = tuple(["IMAGE"] * 10)

    def execute(self, images, divide_by: int = 2, model_registry=None, **_):
        divide_by = max(1, min(int(divide_by), 10))
        arr = torch.as_tensor(images).to(_device(model_registry))
        chunks = [arr[s:e] for s, e in _chunk_bounds(arr.shape[0], divide_by)]
        chunks += [arr[:0]] * (10 - len(chunks))
        return tuple(chunks)


@register_node("AudioBatchDivider")
class AudioBatchDivider(NodeDef):
    """Split AUDIO along its samples into up to 10 contiguous clips; the
    outputs past the clips are the empty clip."""

    INPUTS = {"audio": "AUDIO", "divide_by": "INT"}
    RETURNS = tuple(["AUDIO"] * 10)

    def execute(self, audio, divide_by: int = 2, **_):
        divide_by = max(1, min(int(divide_by), 10))
        wf = torch.as_tensor(audio["waveform"])
        sr = int(audio.get("sample_rate", 44100))
        chunks = [{"waveform": wf[..., s:e], "sample_rate": sr}
                  for s, e in _chunk_bounds(wf.shape[-1], divide_by)]
        chunks += [{"waveform": wf[..., :0], "sample_rate": sr}] * (10 - len(chunks))
        return tuple(chunks)


@register_node("ImageFromBatch")
class ImageFromBatch(NodeDef):
    """Slice [batch_index : batch_index + length] out of an IMAGE batch;
    index and length clamp to the batch."""

    INPUTS = {"image": "IMAGE", "batch_index": "INT", "length": "INT"}
    RETURNS = ("IMAGE",)

    def execute(self, image, batch_index: int, length: int, **_):
        arr = torch.as_tensor(image)
        start = min(max(int(batch_index), 0), max(arr.shape[0] - 1, 0))
        count = min(max(int(length), 1), arr.shape[0] - start)
        return (arr[start:start + count],)


@register_node("SolidMask")
class SolidMask(NodeDef):
    """Constant-value MASK [1, height, width] (on the host; the nodes that
    take a mask move it to their device)."""

    INPUTS = {"value": "FLOAT", "width": "INT", "height": "INT"}
    RETURNS = ("MASK",)

    def execute(self, value: float = 1.0, width: int = 64, height: int = 64,
                **_):
        return (torch.full((1, int(height), int(width)), float(value),
                           dtype=torch.float32),)


@register_node("DistributedEmptyImage")
class DistributedEmptyImage(NodeDef):
    """0-batch IMAGE placeholder for delegate-only masters, on the
    registry's device so the worker images it is joined with meet it
    there."""

    INPUTS = {"height": "INT", "width": "INT"}
    OPTIONAL = {"channels": "INT"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, height: int = 64, width: int = 64, channels: int = 3,
                model_registry=None, **_):
        return (torch.zeros((0, int(height), int(width), int(channels)),
                            device=_device(model_registry)),)


@register_node("DistributedCollector")
class DistributedCollector(NodeDef):
    """Result gather point. Across controllers the execution context
    provides a ``collector_bridge``: a worker sends its batch to the
    master, the master waits for every worker and joins the batches
    master first (``cluster/collector_bridge.py``). Without a bridge or
    job id, and with ``pass_through``, it is the identity. AUDIO rides
    along: a worker sends its clip with its images, and the master joins
    the clips along their samples, master first."""

    INPUTS = {"images": "IMAGE"}
    OPTIONAL = {"audio": "AUDIO"}
    HIDDEN = {
        "multi_job_id": "STRING", "is_worker": "BOOLEAN", "worker_id": "STRING",
        "master_url": "STRING", "enabled_worker_ids": "*",
        "delegate_only": "BOOLEAN", "pass_through": "BOOLEAN",
        "collector_bridge": "*",
    }
    RETURNS = ("IMAGE", "AUDIO")

    def execute(self, images, audio=None, multi_job_id: str = "",
                is_worker: bool = False, worker_id: str = "",
                master_url: str = "", enabled_worker_ids=(),
                delegate_only: bool = False, pass_through: bool = False,
                collector_bridge=None, **_):
        if pass_through or not multi_job_id or collector_bridge is None:
            return (images, audio)
        if is_worker:
            collector_bridge.send(multi_job_id, worker_id, images, audio,
                                  master_url)
            return (images, audio)
        # a delegate-only master's collector is fed the empty image on
        # every input (graph/transform.py), so it has no clip of its own
        # (the JAX package joins that image as a clip and fails)
        return collector_bridge.collect(
            multi_job_id, images, None if delegate_only else audio,
            enabled_worker_ids=tuple(enabled_worker_ids),
            delegate_only=delegate_only)


def _registry(model_registry):
    if model_registry is None:
        from ..models.registry import ModelRegistry
        model_registry = ModelRegistry()
    return model_registry


def _resolve_model_file(env_root, subdir: str, name: str,
                        model_registry=None):
    """A model file for a loader node: ``<env_root>/<name>.safetensors``
    (``.safetensors`` appended unless given), where ``env_root`` is the
    node's directory knob, falling back to ``<checkpoint root>/<subdir>``
    (the registry's, else ``CDT_CHECKPOINT_ROOT``). Returns (path or
    None, the directory searched)."""
    ckpt_root = (model_registry.checkpoint_root if model_registry is not None
                 else constants.checkpoint_root())
    root = env_root or (str(Path(ckpt_root) / subdir) if ckpt_root else "")
    if not root:
        return None, ""
    fname = name if name.endswith(".safetensors") else f"{name}.safetensors"
    path = Path(root) / fname
    return (path if path.is_file() else None), root


@register_node("CheckpointLoader")
class CheckpointLoader(NodeDef):
    """A bundle by preset name from the registry: converted from
    ``<checkpoint root>/<name>.safetensors`` or ``<name>/`` where one is
    there, with the preset's CLIP stack as CLIP, else random-initialised
    with the hash-tokenised text encoder."""

    INPUTS = {"ckpt_name": "STRING"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("MODEL", "CLIP", "VAE")

    def execute(self, ckpt_name: str, model_registry=None, **_):
        bundle = _registry(model_registry).get(ckpt_name)
        return (bundle, bundle.text_encoder, bundle.pipeline.vae)


class _ShiftedModel:
    """A MODEL carrying a sampling-shift override; every other attribute
    is the wrapped bundle's (ComfyUI's patched-model clone, without
    copying weights)."""

    def __init__(self, base, shift: float):
        self._base = base
        self.sampling_shift = float(shift)

    def __getattr__(self, name):
        return getattr(self._base, name)


@register_node("ModelSamplingSD3")
class ModelSamplingSD3(NodeDef):
    """The flow shift of a MODEL: the ladder becomes σ' = shift·σ / (1 +
    (shift − 1)·σ) in every flow or video sampler node whose own
    ``shift`` is not wired."""

    INPUTS = {"model": "MODEL", "shift": "FLOAT"}
    RETURNS = ("MODEL",)

    def execute(self, model, shift: float, **_):
        return (_ShiftedModel(model, shift),)


def _shift(model, shift) -> float:
    """A wired ``shift``, else a ``ModelSamplingSD3`` override on the
    model, else the FLUX convention's 3.0."""
    return float(getattr(model, "sampling_shift", 3.0) if shift is None
                 else shift)


@register_node("CLIPTextEncode")
class CLIPTextEncode(NodeDef):
    """Encodes through the controller's conditioning tier when its
    context carries one (``cluster/cache``): the same text on the same
    encoder encodes once. A plain encode otherwise, or for an encoder
    the registry did not stamp."""

    INPUTS = {"text": "STRING", "clip": "CLIP"}
    HIDDEN = {"content_cache": "*"}
    RETURNS = ("CONDITIONING",)

    def execute(self, text: str, clip, content_cache=None, **_):
        from ..cluster.cache.conditioning import cached_encode

        owner = getattr(clip, "_cdt_bundle", None)
        with _pinned(owner() if owner is not None else None):
            ctx, pooled = cached_encode(content_cache, clip, [str(text)])
        return ({"context": ctx, "pooled": pooled},)


@register_node("LoraLoader")
class LoraLoader(NodeDef):
    """Merge a kohya LoRA into copies of the model and its CLIP stack
    (``models/lora.py``); the registry's bundle is never changed.
    ``lora_name`` resolves under ``CDT_LORA_DIR`` (or ``<checkpoint
    root>/loras``). The last 4 merges are kept, per (name, file, mtime,
    strengths) and base model."""

    INPUTS = {"model": "MODEL", "clip": "CLIP", "lora_name": "STRING"}
    OPTIONAL = {"strength_model": "FLOAT", "strength_clip": "FLOAT"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("MODEL", "CLIP")

    KEPT = 4
    _cache: dict = {}

    def execute(self, model, clip, lora_name: str,
                strength_model: float = 1.0, strength_clip: float = 1.0,
                model_registry=None, **_):
        from ..models.lora import apply_lora, load_lora_file

        if not strength_model and not strength_clip:
            return (model, clip)
        name = str(lora_name)
        path, root = _resolve_model_file(constants.lora_dir(), "loras", name,
                                         model_registry)
        if path is None:
            raise ValidationError(
                f"LoRA {name!r} not found under {root or '$CDT_LORA_DIR'}",
                field="lora_name")
        key = (name, str(path), path.stat().st_mtime_ns,
               float(strength_model), float(strength_clip))
        cached = self._cache.get(key)
        # a cached entry pins its base model and clip, so identity is safe
        if cached is not None and cached[0] is model and cached[1] is clip:
            return cached[2]
        patched, conditioner = apply_lora(
            model, load_lora_file(path), strength_model=float(strength_model),
            strength_clip=float(strength_clip), name=name)
        result = (patched, conditioner if conditioner is not None else clip)
        if len(self._cache) >= self.KEPT:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (model, clip, result)
        return result


def _adm_from_cond(cond: dict, adm_channels: int,
                   device: torch.device) -> torch.Tensor:
    """The ADM vector: pooled text zero-padded (or cut) to the UNet's
    ``adm_in_channels``."""
    pooled = cond.get("pooled")
    if pooled is None:
        return torch.zeros((1, adm_channels), device=device)
    pooled = pooled.float()
    pad = adm_channels - pooled.shape[-1]
    if pad > 0:
        return F.pad(pooled, (0, pad))
    return pooled[:, :adm_channels]


@register_node("EmptyLatentImage")
class EmptyLatentImage(NodeDef):
    """Zero latents [B, height/ds, width/ds, C], the geometry of the
    preset's VAE (8× and 4 channels without a preset), on the registry's
    device."""

    INPUTS = {"width": "INT", "height": "INT"}
    OPTIONAL = {"batch_size": "INT", "ckpt_name": "STRING"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("LATENT",)

    def execute(self, width: int, height: int, batch_size: int = 1,
                ckpt_name: str = "", model_registry=None, **_):
        from ..models.registry import PRESETS

        downscale, channels = 8, 4
        preset = PRESETS.get(str(ckpt_name)) if ckpt_name else None
        if preset is not None:
            downscale = preset.vae.downscale
            channels = preset.vae.latent_channels
        return ({"samples": torch.zeros(
                    (int(batch_size), int(height) // downscale,
                     int(width) // downscale, channels),
                    device=_device(model_registry)),
                 "height": int(height), "width": int(width)},)


def _vae_device(vae) -> torch.device:
    return next(vae.parameters()).device


@register_node("VAEEncode")
class VAEEncode(NodeDef):
    INPUTS = {"pixels": "IMAGE", "vae": "VAE"}
    RETURNS = ("LATENT",)

    @torch.no_grad()
    def execute(self, pixels, vae, **_):
        x = torch.as_tensor(pixels).float().to(_vae_device(vae))
        return ({"samples": vae.encode(x * 2.0 - 1.0)},)


@register_node("VAEDecode")
class VAEDecode(NodeDef):
    INPUTS = {"samples": "LATENT", "vae": "VAE"}
    RETURNS = ("IMAGE",)

    @torch.no_grad()
    def execute(self, samples, vae, **_):
        out = vae.decode(samples["samples"].to(_vae_device(vae)))
        return (torch.clamp(out / 2.0 + 0.5, 0.0, 1.0),)


def _method(method: str) -> str:
    from ..ops.resize import normalize_method

    try:
        return normalize_method(method)
    except ValueError as e:
        raise ValidationError(str(e), field="upscale_method") from None


def _image_batch(image) -> torch.Tensor:
    images = torch.as_tensor(image).float()
    return images[None] if images.ndim == 3 else images


@register_node("ImageScale")
class ImageScale(NodeDef):
    """Resize to (width, height) with ``jax.image.resize``'s kernels
    (``ops/resize.py``). ComfyUI's ``upscale_method`` names are taken; a
    width or height of 0 keeps the aspect; ``crop="center"`` cuts the
    source to the target aspect first."""

    INPUTS = {"image": "IMAGE", "width": "INT", "height": "INT"}
    OPTIONAL = {"method": "STRING", "upscale_method": "STRING",
                "crop": "STRING"}
    RETURNS = ("IMAGE",)

    def execute(self, image, width: int, height: int,
                method: str = "lanczos3", upscale_method: str = "",
                crop: str = "disabled", **_):
        from ..ops.resize import resize_to

        method = _method(upscale_method or method)
        if crop not in ("disabled", "center"):
            raise ValidationError(
                f"unknown crop mode {crop!r}; have disabled|center",
                field="crop")
        images = _image_batch(image)
        _, H, W, _ = images.shape
        width, height = int(width), int(height)
        if width < 0 or height < 0:
            raise ValidationError(
                "width/height must be >= 0 (0 keeps aspect)", field="width")
        if width == 0 and height == 0:
            raise ValidationError("width and height cannot both be 0",
                                  field="width")
        if width == 0:
            width = max(1, round(W * height / H))
        if height == 0:
            height = max(1, round(H * width / W))
        if crop == "center" and H * width != W * height:
            if W * height > H * width:            # too wide
                new_w = max(1, round(H * width / height))
                x0 = (W - new_w) // 2
                images = images[:, :, x0:x0 + new_w, :]
            else:                                  # too tall
                new_h = max(1, round(W * height / width))
                y0 = (H - new_h) // 2
                images = images[:, y0:y0 + new_h, :, :]
        return (resize_to(images, height, width, method),)


@register_node("ImageScaleBy")
class ImageScaleBy(NodeDef):
    INPUTS = {"image": "IMAGE", "scale_by": "FLOAT"}
    OPTIONAL = {"method": "STRING", "upscale_method": "STRING"}
    RETURNS = ("IMAGE",)

    def execute(self, image, scale_by: float, method: str = "lanczos3",
                upscale_method: str = "", **_):
        from ..ops.resize import upscale_image

        method = _method(upscale_method or method)
        if float(scale_by) <= 0:
            raise ValidationError("scale_by must be > 0", field="scale_by")
        return (upscale_image(_image_batch(image), float(scale_by), method),)


@register_node("ControlNetLoader")
class ControlNetLoader(NodeDef):
    """A ControlNet: a published ``.safetensors`` under
    ``CDT_CONTROLNET_DIR`` (or ``<checkpoint root>/controlnet``), its base
    architecture (sd15 or sdxl) read from the file, or else a preset
    name (``tiny``, ``sd15``, ``sdxl``) random-initialised from the
    registry's seed; kept by the registry on its device."""

    INPUTS = {"control_net_name": "STRING"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("CONTROL_NET",)

    def execute(self, control_net_name: str, model_registry=None, **_):
        registry = _registry(model_registry)
        name = str(control_net_name)
        path, _ = _resolve_model_file(constants.controlnet_dir(),
                                      "controlnet", name, registry)
        return (registry.get_controlnet(name, path),)


@register_node("ControlNetApply")
class ControlNetApply(NodeDef):
    """Attach a control hint to a conditioning (ComfyUI semantics): the
    sampler nodes read ``conditioning["control"]`` and feed the hint to
    every denoise step, under CFG to both passes."""

    INPUTS = {"conditioning": "CONDITIONING", "control_net": "CONTROL_NET",
              "image": "IMAGE"}
    OPTIONAL = {"strength": "FLOAT"}
    RETURNS = ("CONDITIONING",)

    def execute(self, conditioning, control_net, image,
                strength: float = 1.0, **_):
        return ({**conditioning,
                 "control": {"model": control_net, "hint": _image_batch(image),
                             "strength": float(strength)}},)


def _control_from_cond(pipeline, cond: dict, height: int, width: int):
    """The conditioning's ControlNet on a pipeline clone, and the hint
    shaped for its stem: latent resolution × 8 (the image size for the
    SD VAEs), resized bilinear where it differs. Returns (pipeline,
    hint); (pipeline, None) without a ControlNet."""
    from ..models.controlnet import HINT_DOWNSCALE
    from ..ops.resize import resize_to

    control = cond.get("control") if isinstance(cond, dict) else None
    if not control:
        return pipeline, None
    hint = torch.as_tensor(control["hint"]).float().to(pipeline.device)
    ds = pipeline.vae.config.downscale
    target = (height // ds * HINT_DOWNSCALE, width // ds * HINT_DOWNSCALE)
    if tuple(hint.shape[1:3]) != target:
        hint = resize_to(hint, *target, "bilinear")
    return (pipeline.with_control(control["model"],
                                  control.get("strength", 1.0)), hint)


class _ProgressScope:
    """Progress lifecycle shared by the sampler nodes: allocates a token
    on entry; ``complete()`` counts the run's queued step events once, at
    its end, before exit marks the run done. Any other exit marks it
    failed, freezing progress where it stopped instead of reporting
    100%. Without a tracker or a prompt id the token is None and the
    pipelines run as they do without progress."""

    def __init__(self, tracker, prompt_id: str, total_calls: int):
        self.tracker, self.prompt_id = tracker, prompt_id
        self.token = (tracker.start(prompt_id, total_calls)
                      if tracker is not None and prompt_id else None)
        self._ok = False

    def complete(self) -> None:
        if self.token is not None:
            self.tracker.complete(self.token)
        self._ok = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.token is not None:
            self.tracker.finish(self.prompt_id, failed=not self._ok)
        return False


def _pinned(model):
    """The residency pin of one call on a bundle: with
    ``CDT_HBM_BUDGET_GB`` set, no concurrent acquire (another model's
    request) evicts this bundle mid-call (``cluster/residency.
    pinned_bundle``; nothing without a planner or a bundle)."""
    from ..cluster.residency import pinned_bundle

    return pinned_bundle(model)


def _observe_shape(pipeline: str, model, height: int, width: int,
                   steps: int, batch: int = 1, frames: int = 0) -> None:
    """Feed the shape catalog (``cluster/shape_catalog.py``) from the
    request path, so that the next boot warms the programs this host
    serves. Never raises; a set lookup after a key's first sight."""
    from ..cluster.shape_catalog import observe

    name = getattr(getattr(model, "preset", None), "name", None)
    if name:
        observe(pipeline, name, height, width, steps, batch=batch,
                frames=frames)


def _multi_rank(mesh) -> bool:
    """A mesh of more than one rank (the context's hidden ``mesh``)."""
    return mesh is not None and mesh.size > 1


def _refuse_mesh(mesh, what: str) -> None:
    """The nodes that take a mesh in the JAX package but have no mesh
    program in the port yet refuse one of more than one rank; none of
    them runs on one rank without saying so."""
    if _multi_rank(mesh):
        raise ValidationError(
            f"{what} over a mesh of {mesh.size} ranks is not ported yet "
            "(ROADMAP.md, item A.6b iii); give the controller a one-rank "
            "mesh (update_mesh) for it", field="mesh")


def _mesh_runtime(mesh, model, model_registry):
    """The mesh's runtime for a call on ``model``: every follower
    resolves the bundle by its preset name from its own registry, so the
    model must be the registry's bundle (a LoRA merge, for one, is
    refused)."""
    name = getattr(getattr(model, "preset", None), "name", None)
    base = _registry(model_registry).get(name) if name else None
    if base is None or base.pipeline is not model.pipeline:
        raise ValidationError(
            "a mesh runs a registry bundle (CheckpointLoader) that every "
            "rank builds by name; this model is not one (a LoRA merge?)",
            field="model")
    return mesh.runtime


def _mesh_layout(mesh, axis: str):
    """``axis`` when the mesh lacks it (its ranks re-laid as one axis of
    that name, as the JAX flow node re-lays its devices), else None."""
    return None if axis in mesh.axes else axis


@register_node("TPUTxt2Img")
class TPUTxt2Img(NodeDef):
    """The sampler node (name kept for workflow compatibility): noise,
    ``sampler_name`` over the sigma ladder with CFG, VAE decode, on the
    bundle's device. On the prompt queue's solo lane the context carries
    a preemption token (``cluster/preemption.py``): without a ControlNet
    hint the run then takes ``generate_preemptible``'s resumable
    segments, resumes the token's checkpoint if it has one, and raises
    ``PreemptedError`` with the parked state when the token asks it to
    yield.

    On a mesh of more than one rank (the hidden ``mesh``) every rank runs
    the ``txt2img_dp`` program: participant i samples ``batch_per_device``
    images from ``participant_seed(seed, i)``, and the images come back
    in participant order, participant 0's bitwise the one-rank run; on a
    mesh with a ``tp`` axis the tp-index-0 ranks alone compute it (the
    others would compute the same images). Such a request is not
    preemptible and takes no ControlNet (ROADMAP A.6b iii). A group of
    such requests runs the mesh's group program (``cluster/frontdoor``:
    ``txt2img_tp`` on a tp axis)."""

    INPUTS = {
        "model": "MODEL", "positive": "CONDITIONING", "negative": "CONDITIONING",
        "seed": "INT", "steps": "INT", "cfg": "FLOAT",
        "width": "INT", "height": "INT",
    }
    OPTIONAL = {
        "sampler_name": "STRING", "scheduler": "STRING", "batch_per_device": "INT",
    }
    HIDDEN = {"prompt_id": "STRING", "progress_tracker": "*",
              "preemption": "*", "mesh": "*", "model_registry": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, positive, negative, seed: int, steps: int,
                cfg: float, width: int, height: int,
                sampler_name: str = "euler", scheduler: str = "karras",
                batch_per_device: int = 1, prompt_id: str = "",
                progress_tracker=None, preemption=None, mesh=None,
                model_registry=None, **_):
        from ..diffusion.pipeline import GenerationSpec
        from ..diffusion.progress import total_calls

        spec = GenerationSpec(
            height=int(height), width=int(width), steps=int(steps),
            sampler=sampler_name, scheduler=scheduler,
            guidance_scale=float(cfg), per_device_batch=int(batch_per_device),
        )
        _observe_shape("txt2img", model, spec.height, spec.width,
                       spec.steps, batch=spec.per_device_batch)
        adm = model.pipeline.unet.config.adm_in_channels
        device = model.pipeline.device
        y = _adm_from_cond(positive, adm, device) if adm else None
        uy = _adm_from_cond(negative, adm, device) if adm else None
        pipeline, hint = _control_from_cond(model.pipeline, positive,
                                            spec.height, spec.width)
        if _multi_rank(mesh):
            if hint is not None:
                _refuse_mesh(mesh, "a ControlNet")
            runtime = _mesh_runtime(mesh, model, model_registry)
            with _pinned(model), \
                    _ProgressScope(progress_tracker, prompt_id,
                                   total_calls(sampler_name, spec.steps)) as ps:
                images = runtime.run(
                    "txt2img_dp", model, spec, int(seed), positive["context"],
                    negative["context"], y, uy,
                    layout=_mesh_layout(mesh, constants.AXIS_DATA),
                    local={"progress_token": ps.token})
                ps.complete()
            return (images,)
        if preemption is not None and hint is None:
            with _pinned(model):
                return (self._execute_preemptible(
                    pipeline, spec, int(seed), positive, negative, y, uy,
                    preemption, progress_tracker, prompt_id),)
        with _pinned(model), \
                _ProgressScope(progress_tracker, prompt_id,
                               total_calls(sampler_name, spec.steps)) as ps:
            images = pipeline.generate(spec, int(seed), positive["context"],
                                       negative["context"], y, uy,
                                       progress_token=ps.token, hint=hint)
            ps.complete()
        return (images,)

    def _execute_preemptible(self, pipeline, spec, seed, positive, negative,
                             y, uy, token, progress_tracker, prompt_id):
        """The serving lane: resumable segments, a yield at a boundary when
        the token asks, the token's checkpoint resumed. The identity
        (the conditioning's digest included) is checked inside
        ``generate_preemptible``: a mismatch raises
        ``CheckpointRestoreError`` toward the queue's bounded retries."""
        from ..diffusion.checkpoint import PreemptedError
        from ..diffusion.progress import total_calls

        token.resume_consumed = token.resume is not None
        with _ProgressScope(progress_tracker, prompt_id,
                            total_calls(spec.sampler, spec.steps)) as ps:
            result = pipeline.generate_preemptible(
                spec, seed, positive["context"], negative["context"], y, uy,
                segment_steps=token.segment_steps,
                should_preempt=token.should_preempt, resume=token.resume,
                progress_token=ps.token)
            if "checkpoint" in result:
                # the scope's exit freezes the progress where it stopped;
                # the resumed run registers a new token for the prompt
                raise PreemptedError(result["checkpoint"], result["reason"])
            ps.complete()
        return result["images"]


def _i2i_setup(model, image, positive, negative, steps, cfg, denoise,
               sampler_name, scheduler):
    """The img2img and inpaint nodes' prelude: the image batch on the
    bundle's device, the spec (batch and size from the image), the ADM
    vectors and the ControlNet clone with its hint."""
    from ..diffusion.pipeline import GenerationSpec

    images = _image_batch(image).to(model.pipeline.device)
    B, H, W, _ = images.shape
    spec = GenerationSpec(height=int(H), width=int(W), steps=int(steps),
                          sampler=sampler_name, scheduler=scheduler,
                          guidance_scale=float(cfg), per_device_batch=B,
                          denoise=float(denoise))
    adm = model.pipeline.unet.config.adm_in_channels
    device = model.pipeline.device
    y = _adm_from_cond(positive, adm, device) if adm else None
    uy = _adm_from_cond(negative, adm, device) if adm else None
    pipeline, hint = _control_from_cond(model.pipeline, positive, H, W)
    return images, spec, y, uy, pipeline, hint


@register_node("TPUImg2Img")
class TPUImg2Img(NodeDef):
    """img2img (name kept for workflow compatibility): the source batch is
    encoded, noised at the head of the partial ladder (``denoise`` sets
    the fraction, as KSampler's denoise does), sampled and decoded. As in
    the JAX package it reports no sampling progress."""

    INPUTS = {
        "model": "MODEL", "image": "IMAGE",
        "positive": "CONDITIONING", "negative": "CONDITIONING",
        "seed": "INT", "steps": "INT", "cfg": "FLOAT", "denoise": "FLOAT",
    }
    OPTIONAL = {"sampler_name": "STRING", "scheduler": "STRING"}
    HIDDEN = {"mesh": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, image, positive, negative, seed: int,
                steps: int, cfg: float, denoise: float,
                sampler_name: str = "euler", scheduler: str = "karras",
                mesh=None, **_):
        _refuse_mesh(mesh, "img2img")
        images, spec, y, uy, pipeline, hint = _i2i_setup(
            model, image, positive, negative, steps, cfg, denoise,
            sampler_name, scheduler)
        return (pipeline.img2img(spec, int(seed), images, positive["context"],
                                 negative["context"], y, uy, hint=hint),)


@register_node("TPUInpaint")
class TPUInpaint(NodeDef):
    """Inpainting: img2img with a repaint mask (1 = repaint, 0 = keep),
    ComfyUI ``KSamplerX0Inpaint`` semantics on every model call
    (``diffusion/pipeline.inpaint_denoiser``), then the unmasked pixels
    taken from the source. The mask is a MASK [H,W] or [B,H,W] or an IMAGE
    (channel 0), broadcast over the batch, resized bilinear to the image
    and clipped to [0, 1]."""

    INPUTS = {
        "model": "MODEL", "image": "IMAGE", "mask": "MASK",
        "positive": "CONDITIONING", "negative": "CONDITIONING",
        "seed": "INT", "steps": "INT", "cfg": "FLOAT", "denoise": "FLOAT",
    }
    OPTIONAL = {"sampler_name": "STRING", "scheduler": "STRING"}
    HIDDEN = {"mesh": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, image, mask, positive, negative, seed: int,
                steps: int, cfg: float, denoise: float,
                sampler_name: str = "euler", scheduler: str = "karras",
                mesh=None, **_):
        from ..ops.resize import resize_to

        _refuse_mesh(mesh, "inpainting")
        images, spec, y, uy, pipeline, hint = _i2i_setup(
            model, image, positive, negative, steps, cfg, denoise,
            sampler_name, scheduler)
        B, H, W, _ = images.shape
        m = torch.as_tensor(mask).float().to(images.device)
        if m.ndim == 2:
            m = m[None]
        if m.ndim == 3:
            m = m[..., None]
        if m.shape[-1] > 1:      # an IMAGE wired as mask: take channel 0
            m = m[..., :1]
        if m.shape[0] != B:
            m = m.expand(B, *m.shape[1:])
        if tuple(m.shape[1:3]) != (H, W):
            m = resize_to(m, H, W, "bilinear")
        # both composites assume a convex blend
        m = torch.clamp(m, 0.0, 1.0)
        return (pipeline.img2img(spec, int(seed), images, positive["context"],
                                 negative["context"], y, uy, hint=hint,
                                 mask=m),)


@register_node("TPUFlowTxt2Img")
class TPUFlowTxt2Img(NodeDef):
    """The rectified-flow sampler node (FLUX- and SD3-class DiT bundles;
    name kept for workflow compatibility). ``mode="dp"`` runs on the
    bundle's device, or, on a mesh of more than one rank (the hidden
    ``mesh``), as the ``flow_dp`` program: participant i from
    ``participant_seed(seed, i)``, the images in participant order.
    ``mode="sp"`` shards one image's latent rows over the mesh (its ranks
    re-laid as ``{"sp": n}`` where it has no ``sp`` axis) with joint ring
    attention (``flow_sp``); on one rank it is the ``dp`` run.
    ``mode="offload"`` (or ``dp`` under ``CDT_OFFLOAD=1``) runs through the
    offload executor on the bundle's device alone, as in the JAX package,
    checking the interrupt between steps. ``mode="tp"`` is refused, as
    the JAX node has none: tensor parallelism is the ``flow_tp`` mesh
    program (``FlowPipeline.generate_tp``) on a mesh with a tp axis. On
    such a mesh ``dp`` runs over the dp axis, weights whole on the
    tp-index-0 ranks. ``cfg != 1`` (SD3's true CFG) needs the
    ``negative`` conditioning."""

    INPUTS = {
        "model": "MODEL", "positive": "CONDITIONING",
        "seed": "INT", "steps": "INT", "width": "INT", "height": "INT",
    }
    OPTIONAL = {
        "negative": "CONDITIONING", "cfg": "FLOAT",
        "guidance": "FLOAT", "shift": "FLOAT", "mode": "STRING",
        "batch_per_device": "INT",
    }
    HIDDEN = {"prompt_id": "STRING", "progress_tracker": "*",
              "interrupt_event": "*", "mesh": "*", "model_registry": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, positive, seed: int, steps: int, width: int,
                height: int, negative=None, cfg: float = 1.0,
                guidance: float = 3.5, shift=None, mode: str = "dp",
                batch_per_device: int = 1, prompt_id: str = "",
                progress_tracker=None, interrupt_event=None, mesh=None,
                model_registry=None, **_):
        from ..diffusion.pipeline_flow import FlowSpec
        from ..diffusion.progress import total_calls

        _flow_mode(mode)
        spec = FlowSpec(height=int(height), width=int(width), steps=int(steps),
                        shift=_shift(model, shift), guidance=float(guidance),
                        cfg=float(cfg), per_device_batch=int(batch_per_device))
        if mode == "dp":
            _observe_shape("flow_dp", model, spec.height, spec.width,
                           spec.steps, batch=spec.per_device_batch)
        pipeline = model.pipeline
        pooled = positive.get("pooled")
        if pooled is None:
            pooled = torch.zeros((1, pipeline.dit.config.pooled_dim),
                                 device=pipeline.device)
        uncond = {}
        if negative is not None:
            uncond = {"uncond_context": negative["context"],
                      "uncond_pooled": negative.get("pooled")}
        if spec.cfg != 1.0 and not uncond:
            raise ValidationError(
                f"cfg={spec.cfg} needs the 'negative' conditioning input "
                "(true CFG); FLUX-dev distilled guidance uses cfg=1.0 "
                "with 'guidance'", field="negative")
        # as in the JAX package's dp branch, no should_stop there: an
        # interrupt takes effect before the next node; the offloaded
        # ladder checks it between steps in either CDT_OFFLOAD_LADDER mode
        with _pinned(model), \
                _ProgressScope(progress_tracker, prompt_id,
                               total_calls(spec.sampler, spec.steps)) as ps:
            if _offloaded(mode, model):
                images = pipeline.generate_offloaded(
                    spec, int(seed), positive["context"], pooled,
                    progress_token=ps.token,
                    should_stop=_stop_cb(interrupt_event))
            elif _multi_rank(mesh):
                runtime = _mesh_runtime(mesh, model, model_registry)
                if mode == "sp":
                    images = runtime.run(
                        "flow_sp", model, spec, int(seed),
                        positive["context"], pooled,
                        uncond.get("uncond_context"),
                        uncond.get("uncond_pooled"),
                        layout=_mesh_layout(mesh, constants.AXIS_SEQUENCE))
                else:
                    images = runtime.run(
                        "flow_dp", model, spec, int(seed),
                        positive["context"], pooled,
                        uncond.get("uncond_context"),
                        uncond.get("uncond_pooled"),
                        layout=_mesh_layout(mesh, constants.AXIS_DATA),
                        local={"progress_token": ps.token})
            else:
                images = pipeline.generate(spec, int(seed),
                                           positive["context"], pooled,
                                           progress_token=ps.token, **uncond)
            ps.complete()
        return (images,)


def _flow_mode(mode: str) -> None:
    """``tp`` is refused: the JAX flow node has no such mode either."""
    if mode == "tp":
        raise ValidationError(
            "mode='tp' is no mode of this node (nor of the JAX package's): "
            "one model's weights over several cards is the flow_tp "
            "program (FlowPipeline.generate_tp) on a controller mesh with "
            "a tp axis", field="mode")
    if mode not in ("dp", "sp", "offload"):
        raise ValidationError(f"unknown mode {mode!r}; the port runs "
                              "mode='dp', 'sp' or 'offload'", field="mode")


def _offloaded(mode: str, model) -> bool:
    """``mode="offload"``, or ``dp`` under ``CDT_OFFLOAD=1`` (JAX's rule),
    or ``dp`` on a bundle built for offload, which cannot run resident."""
    from ..diffusion.offload import offload_enabled

    return mode == "offload" or (mode == "dp" and (
        offload_enabled() or getattr(model, "offload", False)))


def _stop_cb(interrupt_event):
    """The offloaded ladders' ``should_stop``: the executor's interrupt."""
    return interrupt_event.is_set if interrupt_event is not None else None


def _video_pooled_default(model, positive) -> torch.Tensor:
    """The conditioning's pooled vector, else zeros of the transformer's
    pooled width (WAN ignores it; any width satisfies its signature)."""
    pooled = positive.get("pooled")
    if pooled is None:
        pipeline = model.pipeline
        pooled = torch.zeros(
            (1, getattr(pipeline.dit.config, "pooled_dim", 768)),
            device=pipeline.device)
    return pooled


def _flatten_video_batch(videos: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, 3] → the IMAGE batch [B·F, H, W, 3]
    (``ImageBatchDivider`` splits it back per video)."""
    return videos.reshape(-1, *videos.shape[2:])


def _video_mode(mode: str, model) -> None:
    """The video nodes' modes: ``dp``, ``sp`` and ``offload``, as the JAX
    nodes have; ``tp`` is refused (the JAX nodes have none: tensor
    parallelism is the ``video_tp`` program), and so is ``sp`` on a
    bundle built for offload, which has no bf16 blocks to shard."""
    if mode == "tp":
        raise ValidationError(
            "mode='tp' is no mode of this node (nor of the JAX package's): "
            "one video model's weights over several cards is the video_tp "
            "program (VideoPipeline.generate_tp) on a controller mesh with "
            "a tp axis", field="mode")
    if mode not in ("dp", "sp", "offload"):
        raise ValidationError(f"unknown mode {mode!r}; the port runs "
                              "mode='dp', 'sp' or 'offload'", field="mode")
    if mode == "sp" and getattr(model, "offload", False):
        raise ValidationError(
            f"mode='sp' shards a bf16 transformer's frames; the bundle "
            f"{model.preset.name!r} was built for offload (CDT_OFFLOAD=1) "
            "and has no bf16 blocks: run it with mode='offload'",
            field="mode")


def _video_run(mode: str, model, spec, seed: int, positive, pooled, mesh,
               model_registry, ps, interrupt_event, image=None):
    """One video node's run (its class docstring): offloaded on the
    bundle's card alone, ``dp`` or ``sp`` over a mesh of more than one
    rank, else on the bundle's device."""
    pipeline, context = model.pipeline, positive["context"]
    i2v = image is not None
    if _offloaded(mode, model):
        # fp8-resident (or streamed) experts, one on the card at a time
        # (diffusion/offload.OffloadedWan)
        kw = dict(progress_token=ps.token,
                  should_stop=_stop_cb(interrupt_event))
        if i2v:
            return pipeline.generate_offloaded_i2v(spec, seed, image, context,
                                                   **kw)
        return pipeline.generate_offloaded(spec, seed, context, **kw)
    image_arg = (image,) if i2v else ()
    if _multi_rank(mesh):
        runtime = _mesh_runtime(mesh, model, model_registry)
        prefix = "video_i2v" if i2v else "video"
        if mode == "sp":
            sp = constants.AXIS_SEQUENCE
            pipeline.require_sp_frames(spec, mesh.axes.get(sp, mesh.size),
                                       i2v=i2v)
            return runtime.run(f"{prefix}_sp", model, spec, seed, *image_arg,
                               context, pooled, layout=_mesh_layout(mesh, sp))
        return runtime.run(f"{prefix}_dp", model, spec, seed, *image_arg,
                           context, pooled,
                           layout=_mesh_layout(mesh, constants.AXIS_DATA),
                           local={"progress_token": ps.token})
    if i2v:
        return pipeline.generate_i2v(spec, seed, image, context, pooled,
                                     progress_token=ps.token)
    return pipeline.generate(spec, seed, context, pooled,
                             progress_token=ps.token)


@register_node("TPUTxt2Video")
class TPUTxt2Video(NodeDef):
    """The text→video sampler node (WAN-class bundles; name kept for
    workflow compatibility), its videos flattened into an IMAGE batch of
    their frames; the frame count pads to 4n+1. ``mode="dp"``: one seeded
    video on the bundle's device, or, on a mesh of more than one rank
    (the hidden ``mesh``), the ``video_dp`` program: participant i
    samples one video from ``participant_seed(seed, i)``, participant
    0's bitwise the one-rank run (on a mesh with a ``tp`` axis the
    tp-index-0 ranks alone). ``mode="sp"``: one video whose latent frames
    are sharded over the ranks with ring attention (``video_sp``; the
    mesh re-laid as ``{"sp": n}`` where it has no ``sp`` axis; the latent
    frames must divide over the ranks, JAX's ``ValueError``); on one rank
    the ``dp`` run. ``offload`` (or ``dp`` under ``CDT_OFFLOAD=1``) runs
    through the offload executors on the bundle's card alone. ``tp`` is
    refused, as the JAX node has none (the ``video_tp`` program)."""

    INPUTS = {
        "model": "MODEL", "positive": "CONDITIONING",
        "seed": "INT", "frames": "INT", "steps": "INT",
        "width": "INT", "height": "INT",
    }
    OPTIONAL = {"cfg": "FLOAT", "shift": "FLOAT", "mode": "STRING"}
    HIDDEN = {"prompt_id": "STRING", "progress_tracker": "*",
              "interrupt_event": "*", "mesh": "*", "model_registry": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, positive, seed: int, frames: int, steps: int,
                width: int, height: int, cfg: float = 1.0, shift=None,
                mode: str = "dp", prompt_id: str = "",
                progress_tracker=None, interrupt_event=None, mesh=None,
                model_registry=None, **_):
        from ..diffusion.pipeline_video import VideoSpec
        from ..diffusion.progress import total_calls

        _video_mode(mode, model)
        spec = VideoSpec(frames=int(frames), height=int(height),
                         width=int(width), steps=int(steps),
                         shift=_shift(model, shift),
                         guidance_scale=float(cfg))
        if mode == "dp":
            _observe_shape("video_dp", model, spec.height, spec.width,
                           spec.steps, frames=spec.frames)
        pooled = _video_pooled_default(model, positive)
        with _pinned(model), \
                _ProgressScope(progress_tracker, prompt_id,
                               total_calls(spec.sampler, spec.steps)) as ps:
            videos = _video_run(mode, model, spec, int(seed), positive,
                                pooled, mesh, model_registry, ps,
                                interrupt_event)
            ps.complete()
        return (_flatten_video_batch(videos),)


@register_node("TPUImg2Video")
class TPUImg2Video(NodeDef):
    """The image→video sampler node: the start image conditions every
    model call through the causal VAE's latents and a first-frame mask
    (WAN 2.2's latent concat); the modes and the mesh programs
    (``video_i2v_dp``, ``video_i2v_sp``: each rank's frames of the
    conditioning) as ``TPUTxt2Video``'s. A t2v architecture (in_channels
    == out_channels) is refused."""

    INPUTS = {
        "model": "MODEL", "positive": "CONDITIONING", "image": "IMAGE",
        "seed": "INT", "frames": "INT", "steps": "INT",
    }
    OPTIONAL = {"cfg": "FLOAT", "shift": "FLOAT", "mode": "STRING"}
    HIDDEN = {"prompt_id": "STRING", "progress_tracker": "*",
              "interrupt_event": "*", "mesh": "*", "model_registry": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, positive, image, seed: int, frames: int,
                steps: int, cfg: float = 1.0, shift=None, mode: str = "dp",
                prompt_id: str = "", progress_tracker=None,
                interrupt_event=None, mesh=None, model_registry=None, **_):
        from ..diffusion.pipeline_video import VideoSpec
        from ..diffusion.progress import total_calls

        image = torch.as_tensor(image)
        if image.ndim == 3:
            image = image[None]
        dcfg = model.pipeline.dit.config
        din = dcfg.in_channels
        if din == getattr(dcfg, "out_channels", din):
            raise ValidationError(
                f"model {model.preset.name!r} is a t2v architecture "
                "(in_channels == out_channels): i2v needs a preset with "
                "latent-concat conditioning channels, e.g. 'wan-i2v'")
        _video_mode(mode, model)
        spec = VideoSpec(frames=int(frames), height=int(image.shape[1]),
                         width=int(image.shape[2]), steps=int(steps),
                         shift=_shift(model, shift),
                         guidance_scale=float(cfg))
        if mode == "dp":
            _observe_shape("video_dp", model, spec.height, spec.width,
                           spec.steps, frames=spec.frames)
        pooled = _video_pooled_default(model, positive)
        with _pinned(model), \
                _ProgressScope(progress_tracker, prompt_id,
                               total_calls(spec.sampler, spec.steps)) as ps:
            videos = _video_run(mode, model, spec, int(seed), positive,
                                pooled, mesh, model_registry, ps,
                                interrupt_event, image=image[:1])
            ps.complete()
        return (_flatten_video_batch(videos),)


@register_node("SaveImage")
class SaveImage(NodeDef):
    INPUTS = {"images": "IMAGE"}
    OPTIONAL = {"filename_prefix": "STRING"}
    HIDDEN = {"output_dir": "STRING"}
    RETURNS = ()
    OUTPUT_NODE = True

    def execute(self, images, filename_prefix: str = "output",
                output_dir: str = "", **_):
        from ..utils.image import encode_png, to_uint8

        out_dir = Path(output_dir or "output")
        out_dir.mkdir(parents=True, exist_ok=True)
        arr = to_uint8(images)
        paths = []
        for i in range(arr.shape[0]):
            p = out_dir / f"{filename_prefix}_{i:05d}.png"
            p.write_bytes(encode_png(arr[i]))
            paths.append(str(p))
        log(f"saved {len(paths)} images to {out_dir}")
        return ()


@register_node("PreviewImage")
class PreviewImage(NodeDef):
    """Terminal node a worker's pruned prompt ends in where its
    ``SaveImage`` was cut (``graph/transform.py``)."""

    INPUTS = {"images": "IMAGE"}
    RETURNS = ()
    OUTPUT_NODE = True

    def execute(self, images, **_):
        return ()


@register_node("LoadImage")
class LoadImage(NodeDef):
    """A PNG from the controller's input directory (``CDT_INPUT_DIR``) as a
    [1,H,W,C] image on the registry's device; any PNG the JAX package's
    Pillow decode accepts (``utils/image.decode_png``)."""

    INPUTS = {"image": "STRING"}
    HIDDEN = {"input_dir": "STRING", "model_registry": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, image: str, input_dir: str = "", model_registry=None,
                **_):
        from ..utils.image import decode_png

        path = _input_file(input_dir, image, "image")
        return (torch.from_numpy(decode_png(path.read_bytes()))[None]
                .to(_device(model_registry)),)


def _input_file(input_dir: str, name: str, field: str) -> Path:
    """``name`` inside the controller's input directory; a path that
    leaves it is refused (the JAX package's loaders do not check)."""
    root = Path(input_dir or "input")
    path = root / name
    if root.resolve() not in path.resolve().parents:
        raise ValidationError(f"{field} path {name!r} leaves the input "
                              "directory", field=field)
    if not path.is_file():
        raise ValidationError(f"{field} file not found: {path}", field=field)
    return path


@register_node("LoadAudio")
class LoadAudio(NodeDef):
    """A PCM WAV from the input directory as AUDIO
    ``{"waveform": [1,C,S] on the CPU, "sample_rate"}``."""

    INPUTS = {"audio": "STRING"}
    HIDDEN = {"input_dir": "STRING"}
    RETURNS = ("AUDIO",)

    def execute(self, audio: str, input_dir: str = "", **_):
        from ..utils.audio_payload import wav_decode

        return (wav_decode(_input_file(input_dir, audio, "audio").read_bytes()),)


@register_node("SaveAudio")
class SaveAudio(NodeDef):
    """AUDIO → one 16-bit PCM WAV per clip of the batch."""

    INPUTS = {"audio": "AUDIO"}
    OPTIONAL = {"filename_prefix": "STRING"}
    HIDDEN = {"output_dir": "STRING"}
    RETURNS = ()
    OUTPUT_NODE = True

    def execute(self, audio, filename_prefix: str = "audio",
                output_dir: str = "", **_):
        from ..utils.audio_payload import wav_bytes

        wf = torch.as_tensor(audio["waveform"])
        if wf.ndim == 2:               # tolerate [C,S]
            wf = wf[None]
        sr = int(audio.get("sample_rate", 44100))
        out_dir = Path(output_dir or "output")
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for i in range(wf.shape[0]):
            p = out_dir / f"{filename_prefix}_{i:05d}.wav"
            p.write_bytes(wav_bytes(wf[i], sr))
            paths.append(str(p))
        log(f"saved {len(paths)} audio clips to {out_dir}")
        return ()


@register_node("LoadVideo")
class LoadVideo(NodeDef):
    """A video container from the input directory → IMAGE frames
    [T,H,W,3] on the registry's device, AUDIO, fps and frame count
    (``utils/video_io.py``: the port's MJPG + PCM AVI, or mp4/webm through
    OpenCV). ``frame_load_cap``, ``skip_first_frames`` and
    ``select_every_nth`` are VHS_LoadVideo's. A silent clip gives a
    zero-length AUDIO, so an AUDIO consumer downstream does nothing."""

    INPUTS = {"video": "STRING"}
    OPTIONAL = {"frame_load_cap": "INT", "skip_first_frames": "INT",
                "select_every_nth": "INT"}
    HIDDEN = {"input_dir": "STRING", "model_registry": "*"}
    RETURNS = ("IMAGE", "AUDIO", "FLOAT", "INT")

    def execute(self, video: str, frame_load_cap: int = 0,
                skip_first_frames: int = 0, select_every_nth: int = 1,
                input_dir: str = "", model_registry=None, **_):
        from ..utils.video_io import load_video

        clip = load_video(_input_file(input_dir, video, "video"),
                          frame_load_cap=int(frame_load_cap),
                          skip_first_frames=int(skip_first_frames),
                          select_every_nth=int(select_every_nth))
        audio = clip["audio"] or {
            "waveform": torch.zeros((1, 1, 0)), "sample_rate": 44100}
        frames = torch.from_numpy(clip["frames"]).to(_device(model_registry))
        return (frames, audio, float(clip["fps"]), int(clip["frame_count"]))


@register_node("SaveVideo")
class SaveVideo(NodeDef):
    """IMAGE frames (and AUDIO) → a video container in the output
    directory, VHS_VideoCombine's surface. ``avi`` muxes the audio into
    the file; ``mp4``/``webm`` go through OpenCV with the audio as a
    sidecar ``.wav`` that ``LoadVideo`` attaches again. VHS format
    strings (``video/h264-mp4``) name their container. The file name
    skips an index whose container or ``.wav`` is taken, so that no save
    overwrites another's audio. Returns the container's path."""

    INPUTS = {"images": "IMAGE", "frame_rate": "FLOAT"}
    OPTIONAL = {"audio": "AUDIO", "format": "STRING",
                "filename_prefix": "STRING", "quality": "INT"}
    HIDDEN = {"output_dir": "STRING"}
    RETURNS = ("STRING",)
    OUTPUT_NODE = True

    _FORMATS = ("mp4", "webm", "avi")

    def execute(self, images, frame_rate: float = 8.0, audio=None,
                format: str = "mp4", filename_prefix: str = "video",
                quality: int = 95, output_dir: str = "", **_):
        from ..utils.video_io import save_video

        fmt = str(format).lower()
        fmt = next((f for f in self._FORMATS if f in fmt), fmt)
        if fmt not in self._FORMATS:
            raise ValidationError(
                f"unsupported video format {format!r} "
                f"(supported: {list(self._FORMATS)})", field="format")
        out_dir = Path(output_dir or "output")
        out_dir.mkdir(parents=True, exist_ok=True)
        i = 0
        while True:
            stem = out_dir / f"{filename_prefix}_{i:05d}.{fmt}"
            if not stem.exists() and not stem.with_suffix(".wav").exists():
                break
            i += 1
        written = save_video(stem, images, fps=float(frame_rate),
                             audio=audio, quality=int(quality))
        log(f"saved video {written[0]}"
            + (f" (+ sidecar {written[1]})" if len(written) > 1 else ""))
        return (written[0],)


# VideoHelperSuite's names, so workflows that use them run unchanged
NODE_REGISTRY["VHS_LoadVideo"] = LoadVideo
NODE_REGISTRY["VHS_VideoCombine"] = SaveVideo


@register_node("PrimitiveInt")
class PrimitiveInt(NodeDef):
    INPUTS = {"value": "INT"}
    RETURNS = ("INT",)

    def execute(self, value, **_):
        return (int(value),)


@register_node("PrimitiveFloat")
class PrimitiveFloat(NodeDef):
    INPUTS = {"value": "FLOAT"}
    RETURNS = ("FLOAT",)

    def execute(self, value, **_):
        return (float(value),)


@register_node("PrimitiveString")
class PrimitiveString(NodeDef):
    INPUTS = {"value": "STRING"}
    RETURNS = ("STRING",)

    def execute(self, value, **_):
        return (str(value),)


@register_node("UpscaleModelLoader")
class UpscaleModelLoader(NodeDef):
    """An RRDBNet upscaler: a published ``.safetensors`` under
    ``CDT_UPSCALE_MODEL_DIR`` (or ``<checkpoint root>/upscalers``), either
    ESRGAN layout, or else a preset name (``esrgan-x4``,
    ``realesrgan-x2``, ``tiny-x2``, ``tiny-x4``) random-initialised from
    the registry's seed; kept by the registry on its device."""

    INPUTS = {"model_name": "STRING"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("UPSCALE_MODEL",)

    def execute(self, model_name: str, model_registry=None, **_):
        registry = _registry(model_registry)
        name = str(model_name)
        path, _ = _resolve_model_file(constants.upscale_model_dir(),
                                      "upscalers", name, registry)
        return (registry.get_upscaler(name, path),)


@register_node("ImageUpscaleWithModel")
class ImageUpscaleWithModel(NodeDef):
    """The learned upscale, tiled (``tiles/model_upscale.py``)."""

    INPUTS = {"upscale_model": "UPSCALE_MODEL", "image": "IMAGE"}
    OPTIONAL = {"tile": "INT", "tile_padding": "INT"}
    HIDDEN = {"mesh": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, upscale_model, image, tile: int = 256,
                tile_padding: int = 16, mesh=None, **_):
        from ..tiles.model_upscale import tiled_model_upscale

        _refuse_mesh(mesh, "the tiled model upscale")
        images = _image_batch(image)
        tile = min(int(tile), images.shape[1], images.shape[2])
        return (tiled_model_upscale(upscale_model, images, tile=tile,
                                    padding=int(tile_padding)),)


def _journal_key(images, spec, seed: int, index: int = 0, chunk: int = 1,
                 total: int = 0) -> str:
    """Crash-resume key from the job's content (input pixels, spec, seed)
    and its task layout (chunk, total): a re-submitted workflow gets a
    new job id, and a restart with another chunk must not restore ranges
    of another size."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(
        torch.as_tensor(images).detach().float().cpu().numpy()).tobytes())
    h.update(repr((spec, int(seed), int(index), int(chunk), int(total))).encode())
    return f"usdu_{h.hexdigest()[:20]}"


@register_node("UltimateSDUpscaleDistributed")
class UltimateSDUpscaleDistributed(NodeDef):
    """Tiled img2img upscale (``tiles/engine.py``).

    Without a tile farm, job id or workers it runs the engine directly.
    Farmed, one tile job per image goes through the pull queue of
    ``cluster/tile_farm.py``: the master runs tasks and composites, a
    worker runs tasks and returns a plain resize of its input (the
    master owns the composite; the worker's graph stays shape-correct).
    A batch of at least ``dynamic_threshold`` images (≥ 2) is farmed by
    image instead, each task one whole upscale seeded ``seed + i``.

    A ControlNet on the positive conditioning runs on every tile with its
    hint cropped per tile, and ``spatial_cond`` (MASK, 1 = denoise) is
    cropped per tile like the image (``tiles/engine.py``), farmed or not:
    every host runs the same graph, so each builds the same hint from its
    own conditioning, and a farmed image equals a direct one. (The JAX
    package runs tiles farmed by range without a hint.)"""

    INPUTS = {
        "image": "IMAGE", "model": "MODEL",
        "positive": "CONDITIONING", "negative": "CONDITIONING",
        "seed": "INT", "steps": "INT", "denoise": "FLOAT",
        "upscale_by": "FLOAT",
    }
    OPTIONAL = {
        "tile_width": "INT", "tile_height": "INT", "tile_padding": "INT",
        "cfg": "FLOAT", "sampler_name": "STRING", "scheduler": "STRING",
        "spatial_cond": "MASK", "dynamic_threshold": "INT",
    }
    HIDDEN = {
        "multi_job_id": "STRING", "is_worker": "BOOLEAN",
        "worker_id": "STRING", "master_url": "STRING",
        "enabled_worker_ids": "*", "delegate_only": "BOOLEAN",
        "tile_farm": "*", "mesh": "*",
    }
    RETURNS = ("IMAGE",)

    def execute(self, image, model, positive, negative, seed: int, steps: int,
                denoise: float, upscale_by: float, tile_width: int = 512,
                tile_height: int = 512, tile_padding: int = 32,
                cfg: float = 5.0, sampler_name: str = "euler",
                scheduler: str = "karras", spatial_cond=None,
                dynamic_threshold: int = 8, multi_job_id: str = "",
                is_worker: bool = False, worker_id: str = "",
                master_url: str = "", enabled_worker_ids=(), tile_farm=None,
                mesh=None, **_):
        from ..cluster.tile_farm import assemble_tiles
        from ..ops.resize import upscale_image
        from ..tiles.engine import TileUpscaler, UpscaleSpec

        _refuse_mesh(mesh, "the tiled upscale (USDU)")
        spec = UpscaleSpec(
            scale=float(upscale_by), tile_w=int(tile_width),
            tile_h=int(tile_height), padding=int(tile_padding),
            steps=int(steps), denoise=float(denoise), sampler=sampler_name,
            scheduler=scheduler, guidance_scale=float(cfg))
        # the ControlNet rides the positive conditioning; its hint is
        # cropped per tile in the engine
        control = positive.get("control") if isinstance(positive, dict) else None
        pipeline = model.pipeline
        device = pipeline.device
        control_hint = None
        if control:
            pipeline = pipeline.with_control(control["model"],
                                             control.get("strength", 1.0))
            control_hint = torch.as_tensor(control["hint"]).float().to(device)
        upscaler = TileUpscaler(pipeline)
        adm = pipeline.unet.config.adm_in_channels
        y = _adm_from_cond(positive, adm, device) if adm else None
        uy = _adm_from_cond(negative, adm, device) if adm else None
        ctx, unc = positive["context"], negative["context"]
        images = _image_batch(image).to(device)
        B = images.shape[0]
        journal_dir = constants.tile_journal_dir()
        smap = None
        if spatial_cond is not None:
            # MASK [B,H,W] → [B,H,W,1]
            smap = torch.as_tensor(spatial_cond).float().to(device)
            if smap.ndim == 3:
                smap = smap[..., None]

        farm_active = (tile_farm is not None and multi_job_id
                       and (is_worker or enabled_worker_ids))
        if not farm_active:
            return (upscaler.upscale(images, spec, int(seed), ctx, unc, y, uy,
                                     spatial_cond=smap,
                                     control_hint=control_hint),)
        def per_image(t, i: int):
            return t if t is None or t.shape[0] != B else t[i:i + 1]

        if B >= max(2, int(dynamic_threshold)):
            def process_images(start: int, end: int) -> np.ndarray:
                return np.concatenate([
                    upscaler.upscale(images[i:i + 1], spec, int(seed) + i, ctx,
                                     unc, y, uy,
                                     spatial_cond=per_image(smap, i),
                                     control_hint=per_image(control_hint, i)
                                     ).cpu().numpy()
                    for i in range(start, end)])

            def plain_resize(start: int, end: int) -> np.ndarray:
                # degraded fill of a dead-lettered image: no diffusion
                return upscale_image(images[start:end], spec.scale,
                                     spec.resize_method).cpu().numpy()

            if is_worker:
                tile_farm.worker_run(multi_job_id, worker_id, master_url,
                                     process_images)
                return (upscale_image(images, spec.scale, spec.resize_method),)
            results = tile_farm.master_run(
                multi_job_id, B, process_images, chunk=1,
                journal_dir=journal_dir or None,
                journal_key=_journal_key(images, spec, seed, 0, 1, B)
                if journal_dir else None)
            full = assemble_tiles(results, B, 1, fallback_fn=plain_resize)
            return (torch.from_numpy(full).to(pipeline.device),)

        outs = []
        grid = upscaler.grid_for(images.shape[1], images.shape[2], spec)
        T = grid.num_tiles
        hints = upscaler.tile_hints(control_hint, grid, B)
        for b in range(B):
            plan = upscaler.range_plan(
                images[b], spec, int(seed), ctx, unc, y, uy, first_index=b * T,
                spatial_cond=None if smap is None else per_image(smap, b)[0],
                control_hint=None if hints is None else hints[b])
            job_id = f"{multi_job_id}_b{b}" if B > 1 else multi_job_id
            if is_worker:
                tile_farm.worker_run(job_id, worker_id, master_url,
                                     plan.run_range)
                outs.append(upscale_image(images[b][None], spec.scale,
                                          spec.resize_method)[0])
                continue
            results = tile_farm.master_run(
                job_id, plan.num_tiles, plan.run_range, chunk=plan.chunk,
                journal_dir=journal_dir or None,
                journal_key=_journal_key(images[b], spec, seed, b, plan.chunk,
                                         plan.num_tiles)
                if journal_dir else None)
            tiles = assemble_tiles(results, plan.num_tiles, plan.chunk,
                                   fallback_fn=plan.source_range)
            outs.append(upscaler.composite(tiles, plan))
        return (torch.stack(outs),)
