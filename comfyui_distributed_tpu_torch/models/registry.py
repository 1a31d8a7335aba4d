"""Named model registry: checkpoint name → assembled stack (counterpart of
the JAX ``models/registry.py``).

A name maps to an architecture preset and, under the registry's
``checkpoint_root`` (``CDT_CHECKPOINT_ROOT``), to weights:

- ``<root>/<name>/``: a bundle converted by ``python -m
  comfyui_distributed_tpu_torch convert`` (one torch state file,
  ``state.pt``, and ``cdt_manifest.json`` with its entries and the
  architecture facts it was saved with);
- ``<root>/<name>.safetensors``: a published single-file LDM checkpoint,
  converted on first load (``models/convert.py``) together with the
  preset's published CLIP stack (``models/clip.py``); for ``flux``, the
  BFL transformer alone.

FLUX's other files (T5-XXL, CLIP-L, ``ae.safetensors``) are converted by
``load_text_encoder_files`` and ``load_vae_file``, in practice once, by
``python -m comfyui_distributed_tpu_torch convert --preset flux
--checkpoint … --t5 … --clip-l … --vae …`` into ``<root>/flux/``. The
``flux`` preset's text stack (``models/t5.py``, T5-XXL + CLIP-L, fp32)
is built only to be filled: from a file or a converted bundle, never
drawn at full width (4.76 B T5 parameters, 19 GB); without one the
bundle encodes with the hash-tokenised ``TextEncoder``.

A file's depths decide the core's, read before it is built
(``preset_for_checkpoint``): a UNet's middle depth (a published SD 1.5
file has a middle transformer the JAX ``sd15`` preset lacks), a FLUX
transformer's double and single block counts and T5's layers (a lighter
variant, or a file cut in depth); a converted bundle's manifest records
them. The JAX package builds the preset's depths and refuses such files.

A bundle about to be filled from a checkpoint builds its denoiser on the
``meta`` device and then allocates it without drawing (``to_empty``), as
the JAX package builds an abstract core. Without a checkpoint every
bundle is random-initialised from a seed, drawn on its device in the
preset's dtype with flax's default distributions
(``layers.flax_init_``), or filled from a JAX parameter tree with
``ModelBundle.load_from_jax``; its text encoder is then the
hash-tokenised ``TextEncoder``.

One departure from flax is deliberate: the JAX DiT zero-initialises its
adaLN ``mod`` kernels and ``img_out``, so a randomly initialised JAX DiT
has every gate at 0, every block is the identity and the velocity is
exactly 0. The port draws those Linears lecun-normal like every other,
so that a random-init FLUX image depends on every block and on its
attention kernel.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Callable, Mapping, Optional, Union

import torch
from torch import nn

from ..diffusion.pipeline import Txt2ImgPipeline
from ..diffusion.pipeline_flow import FlowPipeline
from ..parallel.rng import seed_generator
from ..utils import constants
from ..utils.device import DeviceLike, resolve_device
from ..utils.exceptions import ValidationError
from ..utils.logging import log
from .clip import CLIPConditioner, CLIPTextTransformer, SDXLTextStack
from .controlnet import PRESETS as CONTROLNET_PRESETS
from .controlnet import ControlNetBundle, init_controlnet
from .dit import DiT, DiTConfig
from .from_jax import load_from_jax
from .t5 import FluxTextStack, T5Encoder
from .layers import flax_init_
from .text import TextEncoder, TextEncoderConfig, TextTransformer
from .unet import UNet2D, UNetConfig
from .upscaler import PRESETS as UPSCALER_PRESETS
from .upscaler import RRDBNet, UpscalerBundle
from .vae import AutoencoderKL, VAEConfig

STATE_FILE = "state.pt"
MANIFEST = "cdt_manifest.json"


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    unet: Optional[UNetConfig]
    vae: VAEConfig
    text: TextEncoderConfig
    dit: Optional[DiTConfig] = None       # flow (FLUX-class) models
    # published text stack: "sdxl" | "clip-l" | "flux" (T5-XXL + CLIP-L)
    clip: Optional[str] = None

    @property
    def kind(self) -> str:
        return "dit" if self.dit is not None else "unet"


PRESETS: dict[str, ModelPreset] = {
    "sdxl": ModelPreset("sdxl", UNetConfig.sdxl(), VAEConfig.sdxl(),
                        TextEncoderConfig(), clip="sdxl"),
    # SD 1.5 at its published widths, with the hash-tokenised text encoder
    # at CLIP-L's width (768); no ADM
    "sd15": ModelPreset("sd15", UNetConfig.sd15(),
                        VAEConfig(scaling_factor=0.18215),
                        TextEncoderConfig(output_dim=768, pooled_dim=768),
                        clip="clip-l"),
    "tiny": ModelPreset("tiny", UNetConfig.tiny(), VAEConfig.tiny(),
                        TextEncoderConfig.tiny()),
    # FLUX.1 at full width, its T5-XXL + CLIP-L stack from files; at
    # random init the hash-tokenised text encoder at T5's width (4096) and
    # CLIP-L's pooled width (768); 16-channel VAE
    "flux": ModelPreset(
        "flux", None,
        VAEConfig(latent_channels=16, scaling_factor=0.3611,
                  shift_factor=0.1159),
        TextEncoderConfig(output_dim=4096, pooled_dim=768),
        dit=DiTConfig.flux(), clip="flux"),
    "flux-tiny": ModelPreset("flux-tiny", None, VAEConfig.tiny(),
                             TextEncoderConfig.tiny(), dit=DiTConfig.tiny()),
}


def _empty(build: Callable[[], nn.Module], device: torch.device) -> nn.Module:
    """Build ``module`` without allocating, then allocate it on ``device``
    without drawing: for weights about to be overwritten."""
    with torch.device("meta"):
        module = build()
    return module.to_empty(device=device).eval().requires_grad_(False)


def _random(build: Callable[[], nn.Module], device: torch.device,
            generator: torch.Generator) -> nn.Module:
    """Build ``module`` without allocating, then allocate it on ``device``
    and draw its weights there."""
    module = _empty(build, device)
    flax_init_(module, generator)
    return module


def preset_for_checkpoint(preset: ModelPreset,
                          ckpt: Optional[Path]) -> ModelPreset:
    """``preset`` with the depths of ``ckpt``, read before anything is
    built: a UNet's middle depth, a DiT's double and single block counts.
    From a converted bundle's manifest (``arch.middle_depth``,
    ``depth``) or a single file's header (``convert.with_middle_of``,
    ``convert.with_flux_depth_of``). Widths always come from the
    preset."""
    if ckpt is None:
        return preset
    from ..utils.safetensors import SafetensorsFile
    from .convert import (detect_layout, flux_prefix_of, with_flux_depth_of,
                          with_middle_of)

    ckpt = Path(ckpt)
    unet, dit = preset.unet, preset.dit
    if ckpt.is_dir():
        manifest = (json.loads((ckpt / MANIFEST).read_text())
                    if (ckpt / MANIFEST).is_file() else {})
        middle = manifest.get("arch", {}).get("middle_depth")
        if unet is not None and middle is not None:
            unet = dataclasses.replace(unet, middle_depth=middle)
        depth = manifest.get("depth")
        if dit is not None and depth:
            dit = dataclasses.replace(dit, depth_double=depth["double"],
                                      depth_single=depth["single"])
    else:
        with SafetensorsFile(ckpt) as sd:
            if unet is not None:
                unet = with_middle_of(unet, sd)
            elif detect_layout(sd) == "flux":
                dit = with_flux_depth_of(dit, sd, flux_prefix_of(sd))
    if (unet, dit) == (preset.unet, preset.dit):
        return preset
    return dataclasses.replace(preset, unet=unet, dit=dit)


def _weights_tag(source: Optional[Path], seed: int = 0) -> str:
    """Provenance of a bundle's weights: random-init ones are pinned to
    (seed, torch version), checkpoint-backed ones to the checkpoint's
    name and mtime, so that replacing a file in place changes the tag."""
    if source is None:
        return f"seed{seed}:torch{torch.__version__}"
    try:
        return f"ckpt:{Path(source).name}:{int(Path(source).stat().st_mtime)}"
    except OSError:
        return f"ckpt:{source}"


class ModelBundle:
    """Loaded stack: the pipeline (UNet or DiT, and the VAE) and the text
    encoder. A UNet bundle's VAE has its encoder too (the tile img2img
    engine encodes); a DiT bundle's has the decoder only.

    ``empty_core=True`` allocates the denoiser without drawing it, for a
    caller about to fill every parameter from a checkpoint."""

    def __init__(self, preset: ModelPreset, device: DeviceLike = None,
                 seed: int = 0, empty_core: bool = False):
        self.preset = preset
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.clip_stack: Optional[nn.Module] = None
        self._weights_source: Optional[Path] = None
        gen = seed_generator(seed, self.device)
        self.text_encoder = TextEncoder(
            _random(lambda: TextTransformer(preset.text), self.device, gen))
        flow = preset.kind == "dit"

        def build_core():
            return DiT(preset.dit) if flow else UNet2D(preset.unet)
        core = (_empty(build_core, self.device) if empty_core
                else _random(build_core, self.device, gen))
        vae = _random(lambda: AutoencoderKL(preset.vae, encoder=not flow),
                      self.device, gen)
        self.pipeline = (FlowPipeline if flow else Txt2ImgPipeline)(core, vae)
        self._stamp_text_encoder()

    @property
    def kind(self) -> str:
        return self.preset.kind

    @property
    def core(self) -> nn.Module:
        """The denoiser: the UNet, or the DiT of a flow model."""
        return (self.pipeline.dit if self.preset.kind == "dit"
                else self.pipeline.unet)

    def _stamp_text_encoder(self) -> None:
        """The text encoder's identity (preset, stack, weights' provenance),
        stamped again whenever the encoder or its weights change, so that
        a random-init twin never shares one with a loaded bundle. A
        LoRA-patched encoder carries none."""
        stack = self.preset.clip if self.clip_stack is not None else "text"
        self.text_encoder._cdt_encoder_id = (
            f"{self.preset.name}/{stack}/"
            f"{_weights_tag(self._weights_source, self.seed)}")

    def weights_identity(self) -> str:
        """Provenance of the denoiser's weights, for result-cache keys."""
        return f"{self.preset.name}/{_weights_tag(self._weights_source, self.seed)}"

    def build_clip_stack(self, tiny: Optional[bool] = None,
                         empty: bool = False,
                         empty_t5: Optional[bool] = None,
                         t5_layers: Optional[int] = None) -> nn.Module:
        """The preset's published text stack (CLIP-L, CLIP-L + CLIP-G for
        ``sdxl``, T5 + CLIP-L for ``flux``), random-initialised from the
        bundle's seed, or allocated without drawing (``empty``; for T5
        alone ``empty_t5``) for weights about to be loaded; the bundle's
        text encoder becomes its ``CLIPConditioner`` (the
        ``FluxTextStack`` itself for ``flux``). ``tiny`` (default: the
        preset's text encoder is under 256 wide) takes the test-size
        towers; ``t5_layers`` sets T5's depth (a file's)."""
        if self.clip_stack is not None:
            return self.clip_stack
        kind = self.preset.clip
        if kind is None:
            raise ValidationError(
                f"preset {self.preset.name!r} has no published CLIP stack")
        if tiny is None:
            tiny = self.preset.text.width < 256
        gen = seed_generator(self.seed + 1, self.device)

        def make(build, blank: bool) -> nn.Module:
            return (_empty(build, self.device) if blank
                    else _random(build, self.device, gen))

        def tower(cfg):
            return make(lambda: CLIPTextTransformer(cfg), empty)
        if kind == "flux":
            cfg_t5, cfg_l = FluxTextStack.configs(tiny)
            if t5_layers is not None:
                cfg_t5 = dataclasses.replace(cfg_t5, num_layers=t5_layers)
            t5 = make(lambda: T5Encoder(cfg_t5),
                      empty if empty_t5 is None else empty_t5)
            self.clip_stack = FluxTextStack(t5, tower(cfg_l)).eval()
            self.text_encoder = self.clip_stack
            self._stamp_text_encoder()
            return self.clip_stack
        cfg_l, cfg_g = SDXLTextStack.configs(tiny)
        if kind == "sdxl":
            self.clip_stack = SDXLTextStack(tower(cfg_l), tower(cfg_g)).eval()
        else:
            self.clip_stack = tower(cfg_l)
        self.text_encoder = CLIPConditioner(self.clip_stack, kind=kind)
        self._stamp_text_encoder()
        return self.clip_stack

    def _state_entries(self) -> dict[str, nn.Module]:
        """The modules a saved bundle holds, by entry name."""
        vae = self.pipeline.vae
        state = {"core": self.core, "vae_dec": vae.decoder}
        if vae.encoder is not None:
            state["vae_enc"] = vae.encoder
        if self.clip_stack is None:
            state["text"] = self.text_encoder.module
        elif self.preset.clip == "sdxl":
            state["clip_l"] = self.clip_stack.clip_l
            state["clip_g"] = self.clip_stack.clip_g
        elif self.preset.clip == "flux":
            state["clip_l"] = self.clip_stack.clip_l
            state["t5"] = self.clip_stack.t5
        else:
            state["clip_l"] = self.clip_stack
        return state

    def _arch_fingerprint(self) -> dict:
        """Architecture facts that change what weights mean without
        changing their shapes (a RoPE ↔ sincos flip); saved with a bundle
        and checked when it is restored."""
        core = self.preset.dit or self.preset.unet
        fp: dict = {"kind": self.kind}
        for field in ("pos_embed", "rope_theta", "rope_axes_dim"):
            if hasattr(core, field):
                v = getattr(core, field)
                fp[field] = list(v) if isinstance(v, tuple) else v
        if getattr(core, "middle_depth", -1) >= 0:
            fp["middle_depth"] = core.middle_depth
        return fp

    def save_checkpoint(self, ckpt: Path) -> None:
        """Write the bundle to ``ckpt/`` (``state.pt`` and the manifest),
        each tensor in its parameter's dtype."""
        ckpt = Path(ckpt)
        ckpt.mkdir(parents=True, exist_ok=True)
        entries = self._state_entries()
        torch.save({k: m.state_dict() for k, m in entries.items()},
                   ckpt / STATE_FILE)
        tiny_clip = (self.clip_stack is not None
                     and entries["clip_l"].config.width < 256)
        manifest = {"preset": self.preset.name, "format": "torch",
                    "entries": sorted(entries), "tiny_clip": tiny_clip,
                    "arch": self._arch_fingerprint()}
        if self.preset.dit is not None:
            manifest["depth"] = {"double": self.preset.dit.depth_double,
                                 "single": self.preset.dit.depth_single}
        if "t5" in entries:
            manifest["t5_layers"] = entries["t5"].config.num_layers
        (ckpt / MANIFEST).write_text(json.dumps(manifest))
        log(f"saved checkpoint {ckpt}")

    @torch.no_grad()
    def load_checkpoint(self, ckpt: Path) -> None:
        """Restore a bundle saved by ``save_checkpoint``: the manifest's
        architecture must match the preset's, and the state file must
        cover every entry of this bundle, key for key."""
        ckpt = Path(ckpt)
        state_file = ckpt / STATE_FILE
        if not state_file.is_file():
            if (ckpt / "state").is_dir():
                raise ValidationError(
                    f"{ckpt} holds an orbax checkpoint (the JAX package's "
                    "format), which the port does not read; convert the "
                    "single file with `python -m comfyui_distributed_tpu_torch "
                    "convert`")
            raise ValidationError(
                f"{ckpt} is not a converted checkpoint (no {STATE_FILE}); "
                "run `python -m comfyui_distributed_tpu_torch convert`")
        manifest = {}
        if (ckpt / MANIFEST).is_file():
            manifest = json.loads((ckpt / MANIFEST).read_text())
        saved_arch = manifest.get("arch")
        if saved_arch and saved_arch != self._arch_fingerprint():
            raise ValidationError(
                f"checkpoint {ckpt} was saved with architecture {saved_arch} "
                f"but the preset resolves to {self._arch_fingerprint()}: "
                "re-convert the checkpoint for this preset")
        if "clip_l" in manifest.get("entries", ()):
            self.build_clip_stack(tiny=bool(manifest.get("tiny_clip")),
                                  empty=True,
                                  t5_layers=manifest.get("t5_layers"))
        targets = self._state_entries()
        state = torch.load(state_file, map_location="cpu", mmap=True,
                           weights_only=True)
        if set(state) != set(targets):
            raise ValidationError(
                f"checkpoint {ckpt} holds entries {sorted(state)}; the "
                f"{self.preset.name} bundle needs {sorted(targets)}")
        for name, module in targets.items():
            module.load_state_dict(state[name], strict=True)
        self._weights_source = ckpt
        self._stamp_text_encoder()
        log(f"loaded checkpoint {ckpt}")

    def load_safetensors_checkpoint(self, path: Path) -> None:
        """Convert a published single-file checkpoint (SDXL or SD 1.5 LDM
        layout, with the preset's CLIP stack; or a FLUX transformer) into
        this bundle in place. A FLUX file carries no text encoder: its
        stack is built by ``load_text_encoder_files`` only."""
        from .convert import convert_checkpoint

        if self.preset.clip not in (None, "flux"):
            self.build_clip_stack()
        self._weights_source = Path(path)
        convert_checkpoint(path, self)
        self._stamp_text_encoder()

    def load_text_encoder_files(self, t5: Optional[Path] = None,
                                clip_l: Optional[Path] = None) -> None:
        """Convert the text-encoder files a FLUX distribution ships
        (``t5xxl_*.safetensors`` in the HF T5 layout, ``clip_l.safetensors``
        as HF ``text_model.*``) into this bundle's ``FluxTextStack``,
        built first where there is none (each tower given a file is
        allocated without drawing)."""
        from ..utils.safetensors import SafetensorsFile
        from .convert import convert_clip_hf, convert_t5, t5_layers_of

        if self.preset.clip != "flux":
            raise ValidationError(
                "separate text-encoder files are a flux-stack feature; "
                f"preset {self.preset.name!r} bundles its encoders in the "
                "single-file checkpoint")
        if self.clip_stack is None:
            layers = None
            if t5 is not None:
                with SafetensorsFile(t5) as sd:
                    layers = t5_layers_of(sd)
            self.build_clip_stack(empty=clip_l is not None,
                                  empty_t5=t5 is not None, t5_layers=layers)
        if t5 is not None:
            with SafetensorsFile(t5) as sd:
                convert_t5(sd, self.clip_stack.t5)
            if self._weights_source is None:
                self._weights_source = Path(t5)
        if clip_l is not None:
            with SafetensorsFile(clip_l) as sd:
                convert_clip_hf(sd, self.clip_stack.clip_l)
        self._stamp_text_encoder()

    def load_vae_file(self, path: Path) -> None:
        """Convert a standalone VAE ``.safetensors``: LDM-embedded
        (``first_stage_model.*``), the SD VAE (bare keys with
        ``quant_conv``) or BFL's ``ae.safetensors`` (bare, no quant
        convs). A DiT bundle's VAE decodes only: the file's encoder is
        shape-checked and dropped (``convert.convert_vae``)."""
        from ..utils.safetensors import SafetensorsFile
        from .convert import convert_vae

        with SafetensorsFile(path) as sd:
            if any(k.startswith("first_stage_model.") for k in sd):
                prefix, qc = "first_stage_model.", True
            elif "quant_conv.weight" in sd:
                prefix, qc = "", True
            else:
                prefix, qc = "", False
            convert_vae(sd, self.pipeline.vae, prefix=prefix, quant_convs=qc)

    def load_from_jax(self, core: Mapping, vae_dec: Mapping,
                      text: Optional[Mapping] = None,
                      vae_enc: Optional[Mapping] = None,
                      clip_l: Optional[Mapping] = None,
                      clip_g: Optional[Mapping] = None,
                      t5: Optional[Mapping] = None) -> "ModelBundle":
        """Replace the weights with the JAX package's trees (UNet or DiT
        params, VAE decoder params, and where given the hash text
        encoder's, the VAE encoder's, the CLIP towers' and FLUX's T5
        params; a part without a tree keeps its weights)."""
        load_from_jax(self.core, core)
        load_from_jax(self.pipeline.vae.decoder, vae_dec)
        if text is not None:
            if self.clip_stack is not None:
                raise ValueError("the bundle encodes with its CLIP stack; "
                                 "carry clip_l/clip_g instead of text")
            load_from_jax(self.text_encoder.module, text)
        if vae_enc is not None:
            if self.pipeline.vae.encoder is None:
                raise ValueError(f"the {self.preset.name} bundle has no "
                                 "VAE encoder to carry vae_enc into")
            load_from_jax(self.pipeline.vae.encoder, vae_enc)
        if clip_l is not None or clip_g is not None or t5 is not None:
            stack = self.build_clip_stack()
            if self.preset.clip == "flux":
                if t5 is not None:
                    load_from_jax(stack.t5, t5)
                if clip_l is not None:
                    load_from_jax(stack.clip_l, clip_l)
            elif self.preset.clip == "sdxl":
                load_from_jax(stack.clip_l, clip_l)
                load_from_jax(stack.clip_g, clip_g)
            else:
                load_from_jax(stack, clip_l)
        return self


def _file_source(path: Path) -> tuple:
    return ("file", str(path), path.stat().st_mtime_ns)


class ModelRegistry:
    """Bundles by preset name, built on first use on one device from the
    checkpoints under ``checkpoint_root`` (default ``CDT_CHECKPOINT_ROOT``)
    or random-initialised; the upscalers (``get_upscaler``) and
    ControlNets (``get_controlnet``) beside them, from a file where the
    caller found one, else drawn from the same seed, so that every
    controller of a cluster builds the same weights."""

    CONTROLNETS_KEPT = 4

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 checkpoint_root: Union[str, Path, None] = None):
        self.device = resolve_device(device)
        self.seed = int(seed)
        root = checkpoint_root or constants.checkpoint_root()
        self.checkpoint_root = Path(root) if root else None
        self._cache: dict[str, ModelBundle] = {}
        # name → (weight source, bundle): a file's source is its path and
        # mtime, so a replaced file is loaded again
        self._upscalers: dict[str, tuple[tuple, UpscalerBundle]] = {}
        self._controlnets: dict[str, tuple[tuple, ControlNetBundle]] = {}
        self._lock = threading.Lock()

    def _synced(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def get_upscaler(self, name: str, path: Optional[Path] = None
                     ) -> UpscalerBundle:
        """The RRDBNet of ``path`` (a published ``.safetensors``) when one
        is given, else the preset ``name`` random-initialised; kept per
        name and reloaded when the file changes."""
        from .convert import load_upscaler_checkpoint

        with self._lock:
            source = _file_source(path) if path else ("preset", name)
            cached = self._upscalers.get(name)
            if cached is not None and cached[0] == source:
                return cached[1]
            t0 = time.perf_counter()
            if path:
                bundle = load_upscaler_checkpoint(path, self.device)
            else:
                config = UPSCALER_PRESETS.get(name)
                if config is None:
                    raise ValidationError(
                        f"unknown upscale model {name!r}; have "
                        f"{sorted(UPSCALER_PRESETS)}", field="model_name")
                bundle = UpscalerBundle(
                    _random(lambda: RRDBNet(config), self.device,
                            seed_generator(self.seed, self.device)), name)
            self._upscalers[name] = (source, bundle)
            log(f"built upscaler {name} on {self.device} in "
                f"{self._synced(t0):.2f} s "
                f"({path or f'random init, seed {self.seed}'})")
            return bundle

    def get_controlnet(self, name: str, path: Optional[Path] = None
                       ) -> ControlNetBundle:
        """The ControlNet of ``path`` (a published ``.safetensors``, its
        base architecture read from the file) when one is given, else the
        preset ``name`` (``tiny``, ``sd15``, ``sdxl``) random-initialised;
        the registry keeps at most ``CONTROLNETS_KEPT``, dropping the
        oldest."""
        from .convert import load_controlnet_checkpoint

        with self._lock:
            source = _file_source(path) if path else ("preset", name)
            cached = self._controlnets.get(name)
            if cached is not None and cached[0] == source:
                return cached[1]
            config = CONTROLNET_PRESETS.get(name)
            if path is None and config is None:
                raise ValidationError(
                    f"unknown control net {name!r}; have "
                    f"{sorted(CONTROLNET_PRESETS)}", field="control_net_name")
            self._controlnets.pop(name, None)
            if len(self._controlnets) >= self.CONTROLNETS_KEPT:
                self._controlnets.pop(next(iter(self._controlnets)))
            t0 = time.perf_counter()
            if path:
                bundle = load_controlnet_checkpoint(path, self.device)
            else:
                bundle = init_controlnet(config, self.device, self.seed,
                                         name=name)
            self._controlnets[name] = (source, bundle)
            log(f"built controlnet {name} on {self.device} in "
                f"{self._synced(t0):.2f} s "
                f"({path or f'random init, seed {self.seed}'})")
            return bundle

    def available(self) -> list[str]:
        return sorted(PRESETS)

    def checkpoint_for(self, name: str) -> Optional[Path]:
        """``<root>/<name>/`` (converted) or ``<root>/<name>.safetensors``,
        whichever exists first, else None."""
        if self.checkpoint_root is None:
            return None
        converted = self.checkpoint_root / name
        single = self.checkpoint_root / f"{name}.safetensors"
        if converted.is_dir():
            return converted
        if single.is_file():
            return single
        return None

    def get(self, name: str) -> ModelBundle:
        with self._lock:
            if name not in self._cache:
                preset = PRESETS.get(name)
                if preset is None:
                    raise ValidationError(
                        f"unknown model {name!r}; have {self.available()}")
                t0 = time.perf_counter()
                ckpt = self.checkpoint_for(name)
                preset = preset_for_checkpoint(preset, ckpt)
                bundle = ModelBundle(preset, self.device, self.seed,
                                     empty_core=ckpt is not None)
                if ckpt is not None and ckpt.is_dir():
                    bundle.load_checkpoint(ckpt)
                elif ckpt is not None:
                    bundle.load_safetensors_checkpoint(ckpt)
                self._cache[name] = bundle
                log(f"built {name} on {self.device} in "
                    f"{self._synced(t0):.2f} s "
                    f"({ckpt or f'random init, seed {self.seed}'})")
            return self._cache[name]
