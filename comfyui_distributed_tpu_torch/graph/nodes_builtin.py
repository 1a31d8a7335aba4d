"""The port's node set: the nodes of the txt2img workflows
(``workflows/distributed-txt2img.json``, ``workflows/flux-txt2img.json``),
of the upscale workflow (``workflows/distributed-upscale.json``:
``LoadImage``, ``UpscaleModelLoader``, ``ImageUpscaleWithModel``,
``UltimateSDUpscaleDistributed``) and the two the control plane injects
(``DistributedEmptyImage``, ``PreviewImage``), with the JAX package's
names and contracts.

Graph value conventions, as in the JAX package: IMAGE = float32
[B,H,W,C] in [0,1]; CONDITIONING = {"context": [1,N,D], "pooled": [1,P]};
MODEL = ModelBundle. Tensors stay on the bundle's device until
``SaveImage`` copies them to the host.
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
from .node import NodeDef, register_node


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
        device = (model_registry.device if model_registry is not None
                  else resolve_device())
        return (torch.zeros((0, int(height), int(width), int(channels)),
                            device=device),)


@register_node("DistributedCollector")
class DistributedCollector(NodeDef):
    """Result gather point. Across controllers the execution context
    provides a ``collector_bridge``: a worker sends its batch to the
    master, the master waits for every worker and joins the batches
    master first (``cluster/collector_bridge.py``). Without a bridge or
    job id, and with ``pass_through``, it is the identity. Audio passes
    through: no audio node is ported."""

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
            collector_bridge.send(multi_job_id, worker_id, images, master_url)
            return (images, audio)
        images = collector_bridge.collect(
            multi_job_id, images, enabled_worker_ids=tuple(enabled_worker_ids),
            delegate_only=delegate_only)
        return (images, audio)


@register_node("CheckpointLoader")
class CheckpointLoader(NodeDef):
    INPUTS = {"ckpt_name": "STRING"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("MODEL", "CLIP", "VAE")

    def execute(self, ckpt_name: str, model_registry=None, **_):
        if model_registry is None:
            from ..models.registry import ModelRegistry
            model_registry = ModelRegistry()
        bundle = model_registry.get(ckpt_name)
        return (bundle, bundle.text_encoder, bundle.pipeline.vae)


@register_node("CLIPTextEncode")
class CLIPTextEncode(NodeDef):
    INPUTS = {"text": "STRING", "clip": "CLIP"}
    RETURNS = ("CONDITIONING",)

    def execute(self, text: str, clip, **_):
        ctx, pooled = clip.encode([str(text)])
        return ({"context": ctx, "pooled": pooled},)


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


@register_node("TPUTxt2Img")
class TPUTxt2Img(NodeDef):
    """The sampler node (name kept for workflow compatibility): noise,
    euler over the sigma ladder with CFG, VAE decode, on the bundle's
    device."""

    INPUTS = {
        "model": "MODEL", "positive": "CONDITIONING", "negative": "CONDITIONING",
        "seed": "INT", "steps": "INT", "cfg": "FLOAT",
        "width": "INT", "height": "INT",
    }
    OPTIONAL = {
        "sampler_name": "STRING", "scheduler": "STRING", "batch_per_device": "INT",
    }
    HIDDEN = {"prompt_id": "STRING", "progress_tracker": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, positive, negative, seed: int, steps: int,
                cfg: float, width: int, height: int,
                sampler_name: str = "euler", scheduler: str = "karras",
                batch_per_device: int = 1, prompt_id: str = "",
                progress_tracker=None, **_):
        from ..diffusion.pipeline import GenerationSpec
        from ..diffusion.progress import total_calls

        spec = GenerationSpec(
            height=int(height), width=int(width), steps=int(steps),
            sampler=sampler_name, scheduler=scheduler,
            guidance_scale=float(cfg), per_device_batch=int(batch_per_device),
        )
        pipeline = model.pipeline
        adm = pipeline.unet.config.adm_in_channels
        y = _adm_from_cond(positive, adm, pipeline.device) if adm else None
        uy = _adm_from_cond(negative, adm, pipeline.device) if adm else None
        with _ProgressScope(progress_tracker, prompt_id,
                            total_calls(sampler_name, spec.steps)) as ps:
            images = pipeline.generate(spec, int(seed), positive["context"],
                                       negative["context"], y, uy,
                                       progress_token=ps.token)
            ps.complete()
        return (images,)


@register_node("TPUFlowTxt2Img")
class TPUFlowTxt2Img(NodeDef):
    """The rectified-flow sampler node (FLUX-class DiT bundles; name kept
    for workflow compatibility). ``mode="dp"`` runs on the bundle's
    device; the multi-device modes are not ported yet."""

    INPUTS = {
        "model": "MODEL", "positive": "CONDITIONING",
        "seed": "INT", "steps": "INT", "width": "INT", "height": "INT",
    }
    OPTIONAL = {
        "negative": "CONDITIONING", "cfg": "FLOAT",
        "guidance": "FLOAT", "shift": "FLOAT", "mode": "STRING",
        "batch_per_device": "INT",
    }
    HIDDEN = {"prompt_id": "STRING", "progress_tracker": "*"}
    RETURNS = ("IMAGE",)

    def execute(self, model, positive, seed: int, steps: int, width: int,
                height: int, cfg: float = 1.0, guidance: float = 3.5,
                shift: float = 3.0, mode: str = "dp",
                batch_per_device: int = 1, prompt_id: str = "",
                progress_tracker=None, **_):
        from ..diffusion.pipeline_flow import FlowSpec
        from ..diffusion.progress import total_calls

        if mode != "dp":
            raise NotImplementedError(
                f"mode={mode!r} is not yet ported; the port runs mode='dp' "
                "on one device")
        spec = FlowSpec(height=int(height), width=int(width), steps=int(steps),
                        shift=float(shift), guidance=float(guidance),
                        cfg=float(cfg), per_device_batch=int(batch_per_device))
        pipeline = model.pipeline
        pooled = positive.get("pooled")
        if pooled is None:
            pooled = torch.zeros((1, pipeline.dit.config.pooled_dim),
                                 device=pipeline.device)
        # as in the JAX package's dp branch, no should_stop: an interrupt
        # takes effect before the next node
        with _ProgressScope(progress_tracker, prompt_id,
                            total_calls(spec.sampler, spec.steps)) as ps:
            images = pipeline.generate(spec, int(seed), positive["context"],
                                       pooled, progress_token=ps.token)
            ps.complete()
        return (images,)


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

        root = Path(input_dir or "input")
        path = root / image
        if root.resolve() not in path.resolve().parents:
            raise ValidationError(f"image path {image!r} leaves the input "
                                  "directory", field="image")
        if not path.is_file():
            raise ValidationError(f"image file not found: {path}", field="image")
        device = (model_registry.device if model_registry is not None
                  else resolve_device())
        return (torch.from_numpy(decode_png(path.read_bytes()))[None].to(device),)


@register_node("UpscaleModelLoader")
class UpscaleModelLoader(NodeDef):
    """An RRDBNet upscaler by preset name (``esrgan-x4``,
    ``realesrgan-x2``, ``tiny-x2``, ``tiny-x4``), random-initialised from
    the registry's seed on its device and kept by the registry. A
    published ``.safetensors`` under ``CDT_UPSCALE_MODEL_DIR`` is refused:
    loading one is not ported yet."""

    INPUTS = {"model_name": "STRING"}
    HIDDEN = {"model_registry": "*"}
    RETURNS = ("UPSCALE_MODEL",)

    def execute(self, model_name: str, model_registry=None, **_):
        name = str(model_name)
        root = constants.upscale_model_dir()
        if root:
            fname = name if name.endswith(".safetensors") else f"{name}.safetensors"
            if (Path(root) / fname).is_file():
                raise NotImplementedError(
                    f"upscale model {fname} found under {root}, but loading "
                    ".safetensors checkpoints is not ported yet (ROADMAP.md, "
                    "item A.7: LDM loading); remove it to use the "
                    "random-init preset")
        if model_registry is None:
            from ..models.registry import ModelRegistry
            model_registry = ModelRegistry()
        return (model_registry.get_upscaler(name),)


@register_node("ImageUpscaleWithModel")
class ImageUpscaleWithModel(NodeDef):
    """The learned upscale, tiled (``tiles/model_upscale.py``)."""

    INPUTS = {"upscale_model": "UPSCALE_MODEL", "image": "IMAGE"}
    OPTIONAL = {"tile": "INT", "tile_padding": "INT"}
    RETURNS = ("IMAGE",)

    def execute(self, upscale_model, image, tile: int = 256,
                tile_padding: int = 16, **_):
        from ..tiles.model_upscale import tiled_model_upscale

        images = torch.as_tensor(image).float()
        if images.ndim == 3:
            images = images[None]
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

    ``spatial_cond`` and ControlNet conditioning are not ported yet."""

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
        "tile_farm": "*",
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
                **_):
        from ..cluster.tile_farm import assemble_tiles
        from ..ops.resize import upscale_image
        from ..tiles.engine import TileUpscaler, UpscaleSpec

        if spatial_cond is not None or (isinstance(positive, dict)
                                        and positive.get("control")):
            raise NotImplementedError(
                "spatial_cond and ControlNet conditioning of "
                "UltimateSDUpscaleDistributed are not ported yet (ROADMAP.md, "
                "item A.4: ControlNet)")
        spec = UpscaleSpec(
            scale=float(upscale_by), tile_w=int(tile_width),
            tile_h=int(tile_height), padding=int(tile_padding),
            steps=int(steps), denoise=float(denoise), sampler=sampler_name,
            scheduler=scheduler, guidance_scale=float(cfg))
        pipeline = model.pipeline
        upscaler = TileUpscaler(pipeline)
        adm = pipeline.unet.config.adm_in_channels
        y = _adm_from_cond(positive, adm, pipeline.device) if adm else None
        uy = _adm_from_cond(negative, adm, pipeline.device) if adm else None
        ctx, unc = positive["context"], negative["context"]
        images = torch.as_tensor(image).float().to(pipeline.device)
        if images.ndim == 3:
            images = images[None]
        B = images.shape[0]
        journal_dir = constants.tile_journal_dir()

        farm_active = (tile_farm is not None and multi_job_id
                       and (is_worker or enabled_worker_ids))
        if not farm_active:
            return (upscaler.upscale(images, spec, int(seed), ctx, unc, y, uy),)

        if B >= max(2, int(dynamic_threshold)):
            def process_images(start: int, end: int) -> np.ndarray:
                return np.concatenate([
                    upscaler.upscale(images[i:i + 1], spec, int(seed) + i, ctx,
                                     unc, y, uy).cpu().numpy()
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
        for b in range(B):
            T = upscaler.grid_for(images.shape[1], images.shape[2], spec).num_tiles
            plan = upscaler.range_plan(images[b], spec, int(seed), ctx, unc, y,
                                       uy, first_index=b * T)
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
