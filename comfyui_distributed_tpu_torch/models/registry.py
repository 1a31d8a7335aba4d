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
  BFL transformer alone; for ``sd3-medium``/``sd35-large``, the SAI MMDiT
  alone; for ``wan``/``wan-i2v``, the WAN transformer alone (each bare or
  under ``model.diffusion_model.``);
- ``<root>/<name>.high.safetensors`` and ``<name>.low.safetensors``: the
  two experts of a dual-expert preset (``wan-2.2-t2v``), both or
  neither (one alone raises).

FLUX's other files (T5-XXL, CLIP-L, ``ae.safetensors``), SD3's (T5-XXL,
CLIP-L, CLIP-G) and WAN's UMT5-XXL are converted by
``load_text_encoder_files`` and ``load_vae_file``, in practice once, by
``python -m comfyui_distributed_tpu_torch convert --preset flux
--checkpoint … --t5 … --clip-l … --vae …`` (``--preset sd3-medium
--checkpoint … --t5 … --clip-l …``; ``--preset wan --checkpoint … --t5
…``; ``--preset wan-2.2-t2v --checkpoint … --checkpoint-low …``) into
``<root>/<name>/``; the CLI has no ``--clip-g`` (nor has JAX's), so SD3's
CLIP-G comes through ``load_text_encoder_files(clip_g=…)``. The T5 stacks
(``models/t5.py``, fp32) are built only to be filled: from a file or a
converted bundle, never drawn at full width (T5-XXL 4.76 B parameters,
UMT5-XXL 5.7 B); without one the bundle encodes with the hash-tokenised
``TextEncoder``. WAN's 3D VAE has no published layout either package
reads (``load_vae_file`` refuses it).

Presets: ``sdxl``, ``sd15``, ``tiny``; ``flux``, ``flux-tiny``;
``sd3-medium``, ``sd35-large`` (SD3's 16-channel VAE, scaling 1.5305 and
shift 0.0609; the hash encoder at 4096/2048 at random init) and
``sd3-tiny``; the
video presets ``wan`` (WAN 14B t2v, the 3D causal VAE), ``wan-i2v``
(in_channels 36: noise, a 4-channel mask, the start image's latents),
``wan-2.2-t2v`` (two WAN 14B experts split at sigma 0.875),
``video-mmdit`` (the MMDiT over frames, hidden 5120, with the 16-channel
image VAE per frame) and their test sizes ``wan-tiny`` (image VAE),
``wan-tiny-3d``, ``wan-i2v-tiny`` and ``wan-2.2-tiny``.

A file's depths decide the core's, read before it is built
(``preset_for_checkpoint``): a UNet's middle depth (a published SD 1.5
file has a middle transformer the JAX ``sd15`` preset lacks), a FLUX
transformer's double and single block counts, an SD3 MMDiT's joint
blocks, a WAN transformer's blocks
and T5's or UMT5's layers (a lighter variant, or a file cut in depth); a
converted bundle's manifest records them. The JAX package builds the
preset's depths and refuses such files.

A bundle about to be filled from a checkpoint builds its denoiser on the
``meta`` device and then allocates it without drawing (``to_empty``), as
the JAX package builds an abstract core. Without a checkpoint every
bundle is random-initialised from a seed, drawn on its device in the
preset's dtype with flax's default distributions
(``layers.flax_init_``), or filled from a JAX parameter tree with
``ModelBundle.load_from_jax``; its text encoder is then the
hash-tokenised ``TextEncoder``.

One departure from flax is deliberate: the JAX DiT (and ``VideoDiT``)
zero-initialises its adaLN ``mod`` kernels and ``img_out``, so a
randomly initialised JAX DiT has every gate at 0, every block is the
identity and the velocity is exactly 0. The port draws those Linears
lecun-normal like every other, so that a random-init FLUX image depends
on every block and on its attention kernel. WAN zero-initialises
nothing; a dual-expert bundle draws its low expert from a generator of
its own (``parallel/rng.expert_seed``).

A registry made with ``offload`` (default ``CDT_OFFLOAD``) builds FLUX-class
DiT and WAN bundles for ``diffusion/offload.py``: the core is built on the
``meta`` device, its glue (embedders, head) drawn on the card, and each
transformer block drawn, its generator state saved (``DrawnBlocks``) and
dropped, so the bf16 blocks are never whole on the card. The offload
executor draws each block again from its state, quantises it and places
it: the same numbers as the resident bundle of the same preset and seed
(the same draws, in the same order, on the same device). A
checkpoint-backed offload bundle allocates its transformer(s) in host
memory and loads them there (``core_home``), to be read block by block:
the card never holds them whole, not even while loading.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import threading
import time
import weakref
from pathlib import Path
from typing import Callable, Mapping, Optional, Union

import torch
from torch import nn

from ..diffusion.pipeline import Txt2ImgPipeline
from ..diffusion.pipeline_flow import FlowPipeline
from ..diffusion.pipeline_video import VideoPipeline
from ..parallel.rng import expert_seed, seed_generator
from ..utils import constants
from ..utils.device import DeviceLike, resolve_device
from ..utils.exceptions import ValidationError
from ..utils.logging import log
from .clip import CLIPConditioner, CLIPTextTransformer, SDXLTextStack
from .controlnet import PRESETS as CONTROLNET_PRESETS
from .controlnet import ControlNetBundle, init_controlnet
from .dit import DiT, DiTConfig
from .from_jax import load_from_jax
from .t5 import FluxTextStack, SD3TextStack, T5Encoder, UMT5Conditioner
from .layers import flax_init_, flax_init_one
from .text import TextEncoder, TextEncoderConfig, TextTransformer
from .unet import UNet2D, UNetConfig
from .upscaler import PRESETS as UPSCALER_PRESETS
from .upscaler import RRDBNet, UpscalerBundle
from .vae import AutoencoderKL, VAEConfig
from .video_dit import VideoDiT, VideoDiTConfig
from .wan import WanConfig, WanModel
from .wan_vae import WanVAE3D, WanVAEConfig

STATE_FILE = "state.pt"
MANIFEST = "cdt_manifest.json"


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    unet: Optional[UNetConfig]
    vae: Union[VAEConfig, WanVAEConfig]
    text: TextEncoderConfig
    dit: Optional[DiTConfig] = None       # flow (FLUX-class) models
    # published text stack: "sdxl" | "clip-l" | "flux" (T5-XXL + CLIP-L) |
    # "sd3" (CLIP-L + CLIP-G + T5-XXL) | "umt5" (WAN's UMT5-XXL)
    clip: Optional[str] = None
    video: Union[WanConfig, VideoDiTConfig, None] = None   # t2v/i2v models
    # WAN 2.2's dual experts: the sigma at which the high-noise expert
    # hands over to the low-noise one (t2v 0.875); None = one expert
    moe_boundary: Optional[float] = None

    @property
    def kind(self) -> str:
        if self.video is not None:
            return "video"
        return "dit" if self.dit is not None else "unet"


# WAN's conditioning width: UMT5-XXL's 4096 (the hash encoder at random init)
_WAN_TEXT = TextEncoderConfig(output_dim=4096, pooled_dim=768)
# SD3's: T5-XXL's 4096 and the CLIP-L + CLIP-G projections' 768 + 1280
_SD3_TEXT = TextEncoderConfig(output_dim=4096, pooled_dim=2048)
_SD3_VAE = VAEConfig(latent_channels=16, scaling_factor=1.5305,
                     shift_factor=0.0609)


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
    # SD3: the 16-channel VAE of its own scaling; CLIP-L + CLIP-G + T5-XXL
    # from files (kind "sd3"), the hash encoder at 4096/2048 at random init
    "sd3-medium": ModelPreset("sd3-medium", None, _SD3_VAE, _SD3_TEXT,
                              dit=DiTConfig.sd3_medium(), clip="sd3"),
    "sd35-large": ModelPreset("sd35-large", None, _SD3_VAE, _SD3_TEXT,
                              dit=DiTConfig.sd35_large(), clip="sd3"),
    "sd3-tiny": ModelPreset("sd3-tiny", None, VAEConfig.tiny(),
                            TextEncoderConfig.tiny(),
                            dit=DiTConfig.sd3_tiny(), clip="sd3"),
    # WAN t2v: 16-channel video latents from the 3D causal VAE (4× in time)
    "wan": ModelPreset("wan", None, WanVAEConfig.wan(), _WAN_TEXT,
                       video=WanConfig.wan_14b(), clip="umt5"),
    "wan-tiny": ModelPreset("wan-tiny", None, VAEConfig.tiny(),
                            TextEncoderConfig.tiny(), video=WanConfig.tiny()),
    "wan-tiny-3d": ModelPreset("wan-tiny-3d", None, WanVAEConfig.tiny(),
                               TextEncoderConfig.tiny(),
                               video=WanConfig.tiny()),
    # WAN i2v: in_channels 36 = 16 noise + 4 mask (one per compressed
    # pixel frame) + 16 latents of the start image
    "wan-i2v": ModelPreset(
        "wan-i2v", None, WanVAEConfig.wan(), _WAN_TEXT,
        video=dataclasses.replace(WanConfig.wan_14b(), in_channels=36),
        clip="umt5"),
    # 4 noise + 2 mask (2× temporal VAE) + 4 latents
    "wan-i2v-tiny": ModelPreset("wan-i2v-tiny", None, WanVAEConfig.tiny(),
                                TextEncoderConfig.tiny(),
                                video=WanConfig.tiny(in_channels=10)),
    # WAN 2.2 14B t2v: two WAN 14B experts, switched at sigma 0.875
    "wan-2.2-t2v": ModelPreset("wan-2.2-t2v", None, WanVAEConfig.wan(),
                               _WAN_TEXT, video=WanConfig.wan_14b(),
                               clip="umt5", moe_boundary=0.875),
    "wan-2.2-tiny": ModelPreset("wan-2.2-tiny", None, VAEConfig.tiny(),
                                TextEncoderConfig.tiny(),
                                video=WanConfig.tiny(), moe_boundary=0.875),
    # the generic MMDiT over frames, with the image VAE per frame
    "video-mmdit": ModelPreset(
        "video-mmdit", None,
        VAEConfig(latent_channels=16, scaling_factor=0.3611), _WAN_TEXT,
        video=VideoDiTConfig.wan()),
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


def offloadable(preset: ModelPreset) -> bool:
    """Whether the preset's core runs through an offload executor: a
    FLUX-class DiT (RoPE or sinusoidal positions) or a WAN transformer."""
    if preset.kind == "dit":
        return preset.dit.pos_embed in ("rope", "sincos")
    return preset.kind == "video" and isinstance(preset.video, WanConfig)


def core_home(device: torch.device, offload: bool,
              empty_core: bool) -> torch.device:
    """Where a bundle allocates its transformer(s): host memory for a
    checkpoint-backed offload bundle (the offload executors read it block
    by block; a random-init one draws its blocks with ``DrawnBlocks``),
    else the bundle's device."""
    return torch.device("cpu") if offload and empty_core else device


def offload_prefixes(core: nn.Module) -> tuple:
    return ("block",) if isinstance(core, WanModel) else ("double", "single")


class DrawnBlocks:
    """An offload bundle's transformer blocks (a block source of
    ``diffusion/offload.py``). The core is built on ``meta``; its own
    parameters and its glue are drawn on ``device`` and stay there; each
    block is drawn there in turn, the generator's state before it saved,
    and dropped. ``block_params`` draws a block again from its state:
    part by part in ``modules()`` order, these are ``flax_init_``'s draws
    of the whole core."""

    def __init__(self, build: Callable[[], nn.Module], device: torch.device,
                 generator: torch.Generator):
        from ..diffusion.offload import block_names

        with torch.device("meta"):
            core = build()
        core.eval().requires_grad_(False)
        self.core, self.device = core, device
        self.states: dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()
        blocks = set(block_names(core, offload_prefixes(core)))
        with torch.no_grad():
            for pname, p in list(core._parameters.items()):
                if p is not None:
                    core._parameters[pname] = nn.Parameter(
                        torch.empty_like(p, device=device),
                        requires_grad=False)
            flax_init_one(core, generator)
            for name, child in core.named_children():
                child.to_empty(device=device)
                if name in blocks:
                    self.states[name] = generator.get_state()
                flax_init_(child, generator)
                if name in blocks:
                    child.to("meta")

    def block_params(self, name: str, device) -> dict[str, torch.Tensor]:
        """Block ``name`` drawn again on the bundle's device (held there
        until ``done``), its parameters moved to ``device``."""
        with self._lock:
            child = getattr(self.core, name)
            child.to_empty(device=self.device)
            gen = torch.Generator(device=self.device)
            gen.set_state(self.states[name])
            with torch.no_grad():
                flax_init_(child, gen)
            return {n: p.detach().to(device)
                    for n, p in child.named_parameters()}

    def done(self, name: str) -> None:
        with self._lock:
            getattr(self.core, name).to("meta")


def preset_for_checkpoint(preset: ModelPreset,
                          ckpt: Optional[Path]) -> ModelPreset:
    """``preset`` with the depths of ``ckpt``, read before anything is
    built: a UNet's middle depth, a DiT's double and single block counts
    (an SD3 file's joint blocks), a WAN transformer's blocks (a
    dual-expert pair: the high file's). From a converted bundle's manifest
    (``arch.middle_depth``, ``depth``, ``wan_layers``) or a single file's
    header (``convert.with_middle_of``, ``convert.with_flux_depth_of``,
    ``convert.with_sd3_depth_of``, ``convert.with_wan_depth_of``).
    Widths always come from the preset."""
    if ckpt is None:
        return preset
    from ..utils.safetensors import SafetensorsFile
    from .convert import (detect_layout, flux_prefix_of, wan_prefix_of,
                          with_flux_depth_of, with_middle_of,
                          with_sd3_depth_of, with_wan_depth_of)

    ckpt = Path(ckpt)
    unet, dit, video = preset.unet, preset.dit, preset.video
    wan = isinstance(video, WanConfig)
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
        if wan and manifest.get("wan_layers"):
            video = dataclasses.replace(video,
                                        num_layers=manifest["wan_layers"])
    else:
        with SafetensorsFile(ckpt) as sd:
            if unet is not None:
                unet = with_middle_of(unet, sd)
            else:
                layout = detect_layout(sd)
                if layout == "flux" and dit is not None:
                    dit = with_flux_depth_of(dit, sd, flux_prefix_of(sd))
                elif layout == "sd3" and dit is not None:
                    dit = with_sd3_depth_of(dit, sd, flux_prefix_of(sd))
                elif layout == "wan" and wan:
                    video = with_wan_depth_of(video, sd, wan_prefix_of(sd))
    if (unet, dit, video) == (preset.unet, preset.dit, preset.video):
        return preset
    return dataclasses.replace(preset, unet=unet, dit=dit, video=video)


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
    """Loaded stack: the pipeline (UNet, DiT or video transformer, and the
    VAE) and the text encoder. A UNet bundle's VAE has its encoder too
    (the tile img2img engine encodes), and so has the WAN 3D VAE (i2v
    encodes the start image); a DiT bundle's and an image-VAE video
    bundle's have the decoder only. A dual-expert bundle holds its low
    expert beside the core (``pipeline.dit_low``).

    ``empty_core=True`` allocates the denoiser without drawing it, for a
    caller about to fill every parameter from a checkpoint."""

    # set by release_device: the parameters left the device
    released = False

    def __init__(self, preset: ModelPreset, device: DeviceLike = None,
                 seed: int = 0, empty_core: bool = False,
                 offload: bool = False):
        self.preset = preset
        self.device = resolve_device(device)
        self.seed = int(seed)
        # built for the offload executors (module docstring)
        self.offload = bool(offload) and offloadable(preset)
        drawn: dict[str, DrawnBlocks] = {}
        self.clip_stack: Optional[nn.Module] = None
        self._weights_source: Optional[Path] = None
        gen = seed_generator(seed, self.device)
        self.text_encoder = TextEncoder(
            _random(lambda: TextTransformer(preset.text), self.device, gen))
        kind = preset.kind

        def build_core():
            if kind == "video":
                return (WanModel(preset.video)
                        if isinstance(preset.video, WanConfig)
                        else VideoDiT(preset.video))
            return DiT(preset.dit) if kind == "dit" else UNet2D(preset.unet)

        def core_from(generator: torch.Generator,
                      which: str = "high") -> nn.Module:
            if empty_core:
                return _empty(build_core, core_home(self.device, self.offload,
                                                    empty_core))
            if self.offload:
                drawn[which] = DrawnBlocks(build_core, self.device, generator)
                return drawn[which].core
            return _random(build_core, self.device, generator)
        core = core_from(gen)
        if isinstance(preset.vae, WanVAEConfig):
            vae = _random(lambda: WanVAE3D(preset.vae), self.device, gen)
        else:
            vae = _random(lambda: AutoencoderKL(preset.vae,
                                                encoder=kind == "unet"),
                          self.device, gen)
        if kind == "video":
            low = None
            if preset.moe_boundary is not None:
                low = core_from(seed_generator(expert_seed(seed, 1),
                                               self.device), "low")
            self.pipeline = VideoPipeline(core, vae, low, preset.moe_boundary)
            self.pipeline.offload_sources.update(drawn)
        else:
            self.pipeline = (FlowPipeline if kind == "dit"
                             else Txt2ImgPipeline)(core, vae)
            if drawn:
                self.pipeline.offload_source = drawn["high"]
        if self.offload and empty_core:
            # the core is in host memory (core_home); the executors and
            # the rest of the pipeline run on the bundle's device
            self.pipeline.offload_device = self.device
        self._stamp_text_encoder()

    @property
    def kind(self) -> str:
        return self.preset.kind

    @property
    def core(self) -> nn.Module:
        """The denoiser: the UNet, the DiT of a flow model, or the video
        transformer (a dual-expert bundle's high-noise expert)."""
        return (self.pipeline.unet if self.preset.kind == "unet"
                else self.pipeline.dit)

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
                         t5_layers: Optional[int] = None,
                         empty_g: Optional[bool] = None) -> nn.Module:
        """The preset's published text stack (CLIP-L, CLIP-L + CLIP-G for
        ``sdxl``, T5 + CLIP-L for ``flux``, CLIP-L + CLIP-G + T5 for
        ``sd3``, UMT5 for ``umt5``), random-initialised from the bundle's
        seed, or allocated without drawing (``empty``; for T5 alone
        ``empty_t5``, for SD3's CLIP-G alone ``empty_g``) for weights about
        to be loaded; the bundle's text encoder becomes its
        ``CLIPConditioner`` (the ``FluxTextStack``, ``SD3TextStack`` or
        ``UMT5Conditioner`` itself for ``flux``, ``sd3`` and ``umt5``).
        ``tiny`` (default: the preset's text encoder is under 256 wide)
        takes the test-size towers; ``t5_layers`` sets T5's depth (a
        file's)."""
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

        def tower(cfg, blank: bool = empty):
            return make(lambda: CLIPTextTransformer(cfg), blank)

        def adopt_stack(stack: nn.Module) -> nn.Module:
            self.clip_stack = stack.eval()
            self.text_encoder = self.clip_stack
            self._stamp_text_encoder()
            return self.clip_stack

        def t5_tower(cfg_t5):
            if t5_layers is not None:
                cfg_t5 = dataclasses.replace(cfg_t5, num_layers=t5_layers)
            return make(lambda: T5Encoder(cfg_t5),
                        empty if empty_t5 is None else empty_t5)
        if kind == "umt5":
            return adopt_stack(UMT5Conditioner(
                t5_tower(UMT5Conditioner.config(tiny))))
        if kind == "flux":
            cfg_t5, cfg_l = FluxTextStack.configs(tiny)
            t5 = t5_tower(cfg_t5)
            return adopt_stack(FluxTextStack(t5, tower(cfg_l)))
        if kind == "sd3":
            cfg_l, cfg_g, cfg_t5 = SD3TextStack.configs(tiny)
            clip_l = tower(cfg_l)
            clip_g = tower(cfg_g, empty if empty_g is None else empty_g)
            return adopt_stack(SD3TextStack(clip_l, clip_g, t5_tower(cfg_t5)))
        cfg_l, cfg_g = SDXLTextStack.configs(tiny)
        if kind == "sdxl":
            self.clip_stack = SDXLTextStack(tower(cfg_l), tower(cfg_g)).eval()
        else:
            self.clip_stack = tower(cfg_l)
        self.text_encoder = CLIPConditioner(self.clip_stack, kind=kind)
        self._stamp_text_encoder()
        return self.clip_stack

    def offload_planned_bytes(self) -> int:
        """Card bytes an offload bundle's store takes at the knobs'
        defaults, one expert's at a time: its resident blocks and, when
        any stream, two slots of the largest block (0 for other
        bundles)."""
        if not self.offload:
            return 0
        from ..diffusion.offload import (GLUE_KEYS, WAN_GLUE_KEYS,
                                         block_packed_bytes, plan_offload,
                                         resident_budget_bytes)

        budget, most = resident_budget_bytes(), 0
        for core in (self.core, getattr(self.pipeline, "dit_low", None)):
            if core is None:
                continue
            prefixes = offload_prefixes(core)
            glue = WAN_GLUE_KEYS if prefixes == ("block",) else GLUE_KEYS
            plan = plan_offload(core, budget, None, prefixes, glue)
            held = plan["resident_bytes"] - plan["glue_bytes"]
            if plan["streamed"]:
                held += 2 * max(block_packed_bytes(getattr(core, n), True)
                                for n in plan["streamed"])
            most = max(most, held)
        return most

    def device_modules(self) -> list[nn.Module]:
        """Every module whose parameters the bundle holds on its device:
        the denoiser (and a dual-expert bundle's low expert), the VAE and
        the active text stack."""
        te = self.text_encoder
        candidates = [self.core, getattr(self.pipeline, "dit_low", None),
                      self.pipeline.vae, self.clip_stack,
                      te if isinstance(te, nn.Module) else None,
                      getattr(te, "module", None)]
        out: list[nn.Module] = []
        for m in candidates:
            if isinstance(m, nn.Module) and all(m is not o for o in out):
                out.append(m)
        return out

    def release_device(self) -> None:
        """Give the bundle's device memory back (the residency planner's
        eviction, ``cluster/residency.py``): every parameter and buffer
        moves to the ``meta`` device, so the memory is freed even while
        a caller still holds this object, which cannot compute any more
        (``released``); the registry builds the preset again on its next
        ``get``. The JAX package keeps host copies and uploads again;
        the port keeps none. The pipeline's offload stores are released
        first (JAX ``release_store``)."""
        release = getattr(self.pipeline, "release_offload", None)
        if release is not None:
            release()
        for module in self.device_modules():
            module.to("meta")
        clones = getattr(self.pipeline, "_control_clones", None)
        if isinstance(clones, dict):
            clones.clear()
        # rank 0's tensor-parallel shards: copies, and views that pin the
        # whole weights' storage
        self.pipeline.__dict__.pop("_tp_shards", None)
        self.released = True

    def _state_entries(self) -> dict[str, nn.Module]:
        """The modules a saved bundle holds, by entry name."""
        vae = self.pipeline.vae
        state = {"core": self.core, "vae_dec": vae.decoder}
        if vae.encoder is not None:
            state["vae_enc"] = vae.encoder
        if getattr(self.pipeline, "dit_low", None) is not None:
            state["core_low"] = self.pipeline.dit_low
        if self.clip_stack is None:
            state["text"] = self.text_encoder.module
        elif self.preset.clip == "sdxl":
            state["clip_l"] = self.clip_stack.clip_l
            state["clip_g"] = self.clip_stack.clip_g
        elif self.preset.clip == "flux":
            state["clip_l"] = self.clip_stack.clip_l
            state["t5"] = self.clip_stack.t5
        elif self.preset.clip == "sd3":
            state["clip_l"] = self.clip_stack.clip_l
            state["clip_g"] = self.clip_stack.clip_g
            state["t5"] = self.clip_stack.t5
        elif self.preset.clip == "umt5":
            state["t5"] = self.clip_stack.t5
        else:
            state["clip_l"] = self.clip_stack
        return state

    def _arch_fingerprint(self) -> dict:
        """Architecture facts that change what weights mean without
        changing their shapes (a RoPE ↔ sincos flip); saved with a bundle
        and checked when it is restored."""
        core = self.preset.dit or self.preset.video or self.preset.unet
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
        if self.clip_stack is None:
            tiny_clip = False
        elif self.preset.clip == "umt5":
            tiny_clip = entries["t5"].config.d_model < 256
        else:
            tiny_clip = entries["clip_l"].config.width < 256
        manifest = {"preset": self.preset.name, "format": "torch",
                    "entries": sorted(entries), "tiny_clip": tiny_clip,
                    "arch": self._arch_fingerprint()}
        if self.preset.dit is not None:
            manifest["depth"] = {"double": self.preset.dit.depth_double,
                                 "single": self.preset.dit.depth_single}
        if isinstance(self.preset.video, WanConfig):
            manifest["wan_layers"] = self.preset.video.num_layers
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
        if {"clip_l", "t5"} & set(manifest.get("entries", ())):
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
        layout, with the preset's CLIP stack; or a FLUX, SD3 or WAN
        transformer) into this bundle in place. A FLUX, SD3 or WAN file
        carries no text encoder: its stack is built by
        ``load_text_encoder_files`` only."""
        from .convert import convert_checkpoint

        if self.preset.clip not in (None, "flux", "sd3", "umt5"):
            self.build_clip_stack()
        self._weights_source = Path(path)
        convert_checkpoint(path, self)
        self._stamp_text_encoder()

    def load_safetensors_moe(self, high: Path, low: Path) -> None:
        """Convert a WAN 2.2 dual-expert release: the high-noise
        transformer file into the core, the low-noise one into
        ``pipeline.dit_low`` (each shape-checked against the preset)."""
        from .convert import convert_checkpoint

        if self.preset.moe_boundary is None:
            raise ValidationError(
                f"preset {self.preset.name!r} is not a dual-expert model; "
                "use load_safetensors_checkpoint for single-transformer "
                "releases")
        self._weights_source = Path(high)
        convert_checkpoint(Path(high), self)
        convert_checkpoint(Path(low), self, expert="low")
        self._stamp_text_encoder()

    def load_text_encoder_files(self, t5: Optional[Path] = None,
                                clip_l: Optional[Path] = None,
                                clip_g: Optional[Path] = None) -> None:
        """Convert the text-encoder files a FLUX, SD3 or WAN distribution
        ships (``t5xxl_*.safetensors`` or UMT5-XXL in the HF T5 layout,
        ``clip_l.safetensors``/``clip_g.safetensors`` as HF
        ``text_model.*``, SD3's with their ``text_projection``) into this
        bundle's ``FluxTextStack``, ``SD3TextStack`` or
        ``UMT5Conditioner``, built first where there is none: each tower
        given a file is allocated without drawing, the others drawn from
        the bundle's seed."""
        from ..utils.safetensors import SafetensorsFile
        from .convert import convert_clip_hf, convert_t5, t5_layers_of

        if self.preset.clip not in ("flux", "sd3", "umt5"):
            raise ValidationError(
                "separate text-encoder files are a flux-stack feature (and "
                "the sd3 presets', and the wan presets' UMT5); preset "
                f"{self.preset.name!r} bundles its encoders in the "
                "single-file checkpoint")
        if clip_l is not None and self.preset.clip not in ("flux", "sd3"):
            raise ValidationError("clip_l is part of the flux stack only "
                                  "(and of the sd3 stack)")
        if clip_g is not None and self.preset.clip != "sd3":
            raise ValidationError("clip_g is part of the sd3 stack only")
        if self.clip_stack is None:
            layers = None
            if t5 is not None:
                with SafetensorsFile(t5) as sd:
                    layers = t5_layers_of(sd)
            self.build_clip_stack(empty=clip_l is not None,
                                  empty_t5=t5 is not None, t5_layers=layers,
                                  empty_g=clip_g is not None)
        if t5 is not None:
            with SafetensorsFile(t5) as sd:
                convert_t5(sd, self.clip_stack.t5)
            if self._weights_source is None:
                self._weights_source = Path(t5)
        for path, tower in ((clip_l, "clip_l"), (clip_g, "clip_g")):
            if path is not None:
                with SafetensorsFile(path) as sd:
                    convert_clip_hf(sd, getattr(self.clip_stack, tower))
        self._stamp_text_encoder()

    def load_vae_file(self, path: Path) -> None:
        """Convert a standalone VAE ``.safetensors``: LDM-embedded
        (``first_stage_model.*``), the SD VAE (bare keys with
        ``quant_conv``) or BFL's ``ae.safetensors`` (bare, no quant
        convs). A DiT bundle's VAE decodes only: the file's encoder is
        shape-checked and dropped (``convert.convert_vae``)."""
        from ..utils.safetensors import SafetensorsFile
        from .convert import ConversionError, convert_vae

        if isinstance(self.preset.vae, WanVAEConfig):
            raise ConversionError(
                "WAN 3D-causal-VAE weights are not read (models/wan_vae.py); "
                "--vae applies to image-VAE presets only")
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
        encoder's, the VAE encoder's, the CLIP towers' and FLUX's or SD3's
        T5 params; a part without a tree keeps its weights)."""
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
            if self.preset.clip in ("flux", "sd3"):
                for tree, tower in ((t5, "t5"), (clip_l, "clip_l"),
                                    (clip_g, "clip_g")):
                    if tree is not None:
                        load_from_jax(getattr(stack, tower), tree)
            elif self.preset.clip == "sdxl":
                load_from_jax(stack.clip_l, clip_l)
                load_from_jax(stack.clip_g, clip_g)
            else:
                load_from_jax(stack, clip_l)
        return self


@dataclasses.dataclass
class ShardBundle:
    """A mesh follower's tensor-parallel shard of a bundle
    (``ModelRegistry.get_shard``): ``pipeline`` runs the shard of the
    core (``parallel/tensor.py``; of both experts of a two-expert video
    bundle) beside the whole VAE; ``shard`` is (tp index, tp size)."""

    preset: ModelPreset
    pipeline: object
    shard: tuple


def _drawn_shard_pipeline(preset: ModelPreset, device: torch.device,
                          seed: int, index: int, size: int, axis: str):
    """The pipeline of rank ``index``'s shard of a random-init bundle,
    drawn in ``ModelBundle``'s order (text encoder, core, VAE, a
    two-expert bundle's low expert from its own seed) from the same
    seed, each transformer part by part (``tensor.draw_shard``), so that
    none lies whole on the device; the text encoder's draws are made and
    dropped."""
    from ..parallel.tensor import draw_shard

    gen = seed_generator(seed, device)
    _random(lambda: TextTransformer(preset.text), device, gen)
    kind = preset.kind
    if kind == "video":
        build = ((lambda: WanModel(preset.video))
                 if isinstance(preset.video, WanConfig)
                 else (lambda: VideoDiT(preset.video)))
    else:
        build = ((lambda: DiT(preset.dit)) if kind == "dit"
                 else (lambda: UNet2D(preset.unet)))
    core = draw_shard(build, device, gen, index, size, axis)
    if isinstance(preset.vae, WanVAEConfig):
        vae = _random(lambda: WanVAE3D(preset.vae), device, gen)
    else:
        vae = _random(lambda: AutoencoderKL(preset.vae,
                                            encoder=kind == "unet"),
                      device, gen)
    if kind == "video":
        low = None
        if preset.moe_boundary is not None:
            low = draw_shard(build, device,
                             seed_generator(expert_seed(seed, 1), device),
                             index, size, axis)
        return VideoPipeline(core, vae, low, preset.moe_boundary)
    return (FlowPipeline if kind == "dit" else Txt2ImgPipeline)(core, vae)


def _file_source(path: Path) -> tuple:
    return ("file", str(path), path.stat().st_mtime_ns)


class ModelRegistry:
    """Bundles by preset name, built on first use on one device from the
    checkpoints under ``checkpoint_root`` (default ``CDT_CHECKPOINT_ROOT``)
    or random-initialised; the upscalers (``get_upscaler``) and
    ControlNets (``get_controlnet``) beside them, from a file where the
    caller found one, else drawn from the same seed, so that every
    controller of a cluster builds the same weights. With a memory budget
    (``hbm_budget_bytes``, default ``CDT_HBM_BUDGET_GB``) the residency
    planner keeps the bundles under it, evicting by priority and LRU."""

    CONTROLNETS_KEPT = 4

    def __init__(self, device: DeviceLike = None, seed: int = 0,
                 checkpoint_root: Union[str, Path, None] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 offload: Optional[bool] = None):
        self.device = resolve_device(device)
        self.seed = int(seed)
        if offload is None:
            from ..diffusion.offload import offload_enabled

            offload = offload_enabled()
        # FLUX-class and WAN bundles built for the offload executors
        self.offload = bool(offload)
        root = checkpoint_root or constants.checkpoint_root()
        self.checkpoint_root = Path(root) if root else None
        self._cache: dict[str, ModelBundle] = {}
        # tensor-parallel shards a mesh follower holds (get_shard)
        self._shards: dict[tuple, ShardBundle] = {}
        # bundles built by ``get`` so far (a warm pass's outcome, and the
        # proof that a request after it built none)
        self.builds = 0
        # name → (weight source, bundle): a file's source is its path and
        # mtime, so a replaced file is loaded again
        self._upscalers: dict[str, tuple[tuple, UpscalerBundle]] = {}
        self._controlnets: dict[str, tuple[tuple, ControlNetBundle]] = {}
        # the stage pools' encode threads resolve bundles concurrently: a
        # check-then-build without the lock would build a preset twice
        self._lock = threading.RLock()
        # the residency planner (cluster/residency.py), attached when a
        # budget is set (default CDT_HBM_BUDGET_GB; 0 = unlimited, off)
        self.residency = None
        if hbm_budget_bytes is None:
            from ..cluster.residency import hbm_budget_bytes as _budget

            hbm_budget_bytes = _budget()
        if hbm_budget_bytes and hbm_budget_bytes > 0:
            from ..cluster.residency import BundleResidency

            self.residency = BundleResidency(self, hbm_budget_bytes)

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

    def checkpoint_for(self, name: str) -> Union[Path, tuple, None]:
        """``<root>/<name>/`` (converted), a dual-expert preset's
        ``(<name>.high.safetensors, <name>.low.safetensors)`` or
        ``<root>/<name>.safetensors``, whichever exists first, else None.
        One expert's file without the other raises."""
        if self.checkpoint_root is None:
            return None
        root = self.checkpoint_root
        converted = root / name
        # not with_suffix: a dotted name ("wan-2.2-t2v") has no suffix
        single = root / f"{name}.safetensors"
        if converted.is_dir():
            return converted
        preset = PRESETS.get(name)
        if preset is not None and preset.moe_boundary is not None:
            hi = root / f"{name}.high.safetensors"
            lo = root / f"{name}.low.safetensors"
            if hi.is_file() and lo.is_file():
                return hi, lo
            if hi.is_file() or lo.is_file():
                missing = lo if hi.is_file() else hi
                raise ValidationError(
                    f"dual-expert checkpoint incomplete: {missing} not found "
                    "(need both .high.safetensors and .low.safetensors)")
        if single.is_file():
            return single
        return None

    def drop_tp_shards(self) -> None:
        """Let go of every tensor-parallel shard, when the mesh they were
        cut for is dropped: a follower's own (``get_shard``) and those
        rank 0 keeps on its bundles' pipelines (``shard_pipeline``)."""
        with self._lock:
            self._shards.clear()
            for bundle in self._cache.values():
                bundle.pipeline.__dict__.pop("_tp_shards", None)

    def get_shard(self, name: str, index: int, size: int,
                  axis: str = constants.AXIS_TENSOR) -> ShardBundle:
        """Rank ``index``'s tensor-parallel shard of the bundle ``get``
        builds (``parallel/tensor.py``), with its VAE: the slice of each
        of the whole bundle's split parameters. A random-init bundle not
        built here yet is drawn shard-only (``_drawn_shard_pipeline``);
        otherwise the shard is the slices of the whole bundle, which stays
        (a file-backed bundle is loaded whole first). A random-init video
        bundle built here (a ``dp`` or ``sp`` call's) is dropped first and
        its shard drawn: a rank never holds a whole 14B transformer beside
        its shard. A two-expert shard is one bundle. At most two shards
        are kept, one a mesh."""
        from ..parallel.tensor import shard_pipeline

        with self._lock:
            key = (name, index, size, axis)
            shard = self._shards.get(key)
            if shard is not None:
                return shard
            preset = PRESETS.get(name)
            if preset is None:
                raise ValidationError(
                    f"unknown model {name!r}; have {self.available()}")
            t0 = time.perf_counter()
            filed = self.checkpoint_for(name) is not None
            whole = self._cache.get(name)
            if whole is not None and preset.kind == "video" and not filed:
                self._cache.pop(name)
                whole.release_device()
                whole = None
                gc.collect()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
            if whole is None and filed:
                whole = self.get(name)
            if whole is not None:
                pipeline = shard_pipeline(whole.pipeline, index, size, axis)
            else:
                pipeline = _drawn_shard_pipeline(preset, self.device,
                                                 self.seed, index, size, axis)
            if len(self._shards) >= 2:
                self._shards.pop(next(iter(self._shards)))
            shard = self._shards[key] = ShardBundle(preset, pipeline,
                                                    (index, size))
            log(f"built {name} shard {index}/{size} on {self.device} in "
                f"{self._synced(t0):.2f} s "
                f"({'sliced' if whole is not None else 'drawn'})")
            return shard

    def get(self, name: str) -> ModelBundle:
        with self._lock:
            if name not in self._cache:
                preset = PRESETS.get(name)
                if preset is None:
                    raise ValidationError(
                        f"unknown model {name!r}; have {self.available()}")
                t0 = time.perf_counter()
                ckpt = self.checkpoint_for(name)
                pair = ckpt if isinstance(ckpt, tuple) else None
                preset = preset_for_checkpoint(
                    preset, pair[0] if pair else ckpt)
                bundle = ModelBundle(preset, self.device, self.seed,
                                     empty_core=ckpt is not None,
                                     offload=self.offload)
                if pair:
                    bundle.load_safetensors_moe(*pair)
                elif ckpt is not None and ckpt.is_dir():
                    bundle.load_checkpoint(ckpt)
                elif ckpt is not None:
                    bundle.load_safetensors_checkpoint(ckpt)
                self._cache[name] = bundle
                self.builds += 1
                log(f"built {name} on {self.device} in "
                    f"{self._synced(t0):.2f} s "
                    f"({ckpt or f'random init, seed {self.seed}'}"
                    f"{', for offload' if bundle.offload else ''})")
            bundle = self._cache[name]
            if self.residency is not None:
                try:
                    self.residency.note_use(name, bundle)
                except Exception:
                    # a bundle the budget cannot place must not stay in
                    # the cache, over budget and never evictable
                    self._cache.pop(name, None)
                    bundle.release_device()
                    raise
                # lets a holder pin the bundle for a call on it
                # (cluster/residency.pinned_bundle), also through its
                # text encoder (CLIPTextEncode)
                bundle._residency = self.residency
                bundle.text_encoder._cdt_bundle = weakref.ref(bundle)
            return bundle
