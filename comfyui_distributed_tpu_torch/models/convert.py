"""Published single-file checkpoints → the port's modules (counterpart
of the JAX ``models/convert.py``).

Source layouts (key prefixes of the standard single-file
``.safetensors``):

- UNet: ``model.diffusion_model.*`` (LDM/SGM ``UNetModel`` numbering);
- VAE: ``first_stage_model.*`` (LDM ``AutoencoderKL``);
- CLIP-L: ``conditioner.embedders.0.transformer.text_model.*`` (SDXL) or
  ``cond_stage_model.transformer.text_model.*`` (SD 1.5), HF layout;
- CLIP-G: ``conditioner.embedders.1.model.*`` (SDXL), OpenCLIP layout
  with a fused ``in_proj_weight``;
- RRDBNet upscalers (both ESRGAN layouts) and LDM ControlNets
  (``control_model.*``) in files of their own.

The port's parameters are already in torch layout (``[out, in]``
Linears, OIHW convolutions), so most of a walk is renaming. The real
transforms: OpenCLIP's fused ``in_proj`` split into q/k/v, OpenCLIP's
``text_projection`` (``[in, out]``) transposed into a Linear, and the 1×1
convolutions the port runs as Linears (SD 1.5's ``proj_in``/``proj_out``,
the VAE's mid attention) squeezed.

Every walk is one function over an abstract ``put`` with three users:
``_Filler`` copies each source tensor into its parameter (cast to the
parameter's dtype on its device, one tensor at a time) with shape checks,
and ``finish`` refuses an unfilled parameter or a source key left over
under the prefix; ``_Recorder`` records (source key, parameter,
transform), the LoRA key map of ``models/lora.py``; ``_Exporter`` inverts
each transform to write a module back in the published layout (the
tests and ``chip_smoke.py`` write synthetic checkpoints with it).

FLUX, SD3 and WAN files are detected and refused, each naming the item
that ports it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, Mapping, Optional

import torch
from torch import nn

from ..utils.logging import log
from ..utils.safetensors import SafetensorsFile


class ConversionError(ValueError):
    pass


class _Tx:
    """A layout transform: ``fwd`` maps a source tensor to the port's
    parameter layout, ``inv`` maps a parameter back."""

    def __init__(self, name: str, fwd: Callable, inv: Callable):
        self.name, self.fwd, self.inv = name, fwd, inv

    def __repr__(self) -> str:
        return f"<{self.name}>"


ID = _Tx("id", lambda w: w, lambda w: w)
# a 1×1 convolution [O, I, 1, 1] the port runs as a Linear [O, I]
SQUEEZE = _Tx("squeeze", lambda w: w.reshape(w.shape[0], -1) if w.ndim == 4 else w,
              lambda w: w[:, :, None, None])
# OpenCLIP's text_projection is applied as ``x @ P``: [in, out]
T = _Tx("transpose", lambda w: w.t(), lambda w: w.t())


class _PutHelpers:
    """The naming rules every walk uses, over an abstract ``put``."""

    def put(self, src_key: str, dst: str, tx: _Tx = ID) -> None:
        raise NotImplementedError

    def fused(self, src_key: str, dsts: tuple) -> None:
        """Rows of ``src_key`` split evenly over the parameters ``dsts``
        (OpenCLIP's ``in_proj_weight``/``in_proj_bias`` → q, k, v)."""
        raise NotImplementedError

    def ignore(self, keys) -> None:
        """Source keys that carry nothing the port uses."""

    def linear(self, src: str, dst: str, bias: bool = True,
               tx: _Tx = ID) -> None:
        self.put(f"{src}.weight", f"{dst}.weight", tx)
        if bias:
            self.put(f"{src}.bias", f"{dst}.bias")

    conv = linear
    norm = linear


class _Filler(_PutHelpers):
    """Fills ``module``'s parameters from ``sd`` with shape checks; tracks
    the source keys used and the parameters filled."""

    def __init__(self, sd: Mapping[str, torch.Tensor], module: nn.Module):
        self.sd = sd
        self.params = dict(module.named_parameters())
        self.filled: set[str] = set()
        self.used: set[str] = set()

    def _take(self, src_key: str) -> torch.Tensor:
        if src_key not in self.sd:
            raise ConversionError(f"missing source key {src_key!r}")
        self.used.add(src_key)
        return self.sd[src_key]

    @torch.no_grad()
    def put_raw(self, value: torch.Tensor, dst: str, src_key: str = "") -> None:
        param = self.params.get(dst)
        if param is None:
            raise ConversionError(f"no parameter {dst!r}")
        if tuple(param.shape) != tuple(value.shape):
            raise ConversionError(
                f"{src_key} -> {dst}: shape {tuple(value.shape)} != "
                f"parameter {tuple(param.shape)}")
        param.copy_(value)
        self.filled.add(dst)

    def put(self, src_key: str, dst: str, tx: _Tx = ID) -> None:
        self.put_raw(tx.fwd(self._take(src_key)), dst, src_key)

    def fused(self, src_key: str, dsts: tuple) -> None:
        value = self._take(src_key)
        rows = value.shape[0] // len(dsts)
        if value.shape[0] % len(dsts):
            raise ConversionError(
                f"{src_key}: shape {tuple(value.shape)} does not split into "
                f"{len(dsts)}")
        for j, dst in enumerate(dsts):
            self.put_raw(value[j * rows:(j + 1) * rows], dst, src_key)

    def ignore(self, keys) -> None:
        self.used.update(keys)

    def finish(self, expect_prefix: str = "",
               skip: Callable[[str], bool] = lambda k: False) -> None:
        missing = sorted(set(self.params) - self.filled)
        if missing:
            raise ConversionError(
                f"unfilled parameters: {missing[:8]}"
                f"{'…' if len(missing) > 8 else ''}")
        if expect_prefix is not None:
            leftover = [k for k in self.sd if k.startswith(expect_prefix)
                        and k not in self.used and not skip(k)]
            if leftover:
                raise ConversionError(
                    f"unconsumed source keys under {expect_prefix!r}: "
                    f"{leftover[:8]}{'…' if len(leftover) > 8 else ''}")


class _Recorder(_PutHelpers):
    """Records (source key, parameter, transform) instead of filling."""

    def __init__(self):
        self.records: list[tuple[str, str, _Tx]] = []
        self.fused_records: list[tuple[str, tuple]] = []

    def put(self, src_key: str, dst: str, tx: _Tx = ID) -> None:
        self.records.append((src_key, dst, tx))

    def fused(self, src_key: str, dsts: tuple) -> None:
        self.fused_records.append((src_key, dsts))


class _Exporter(_PutHelpers):
    """Writes ``module``'s parameters back under their source keys: the
    inverse of a ``_Filler`` walk (``out``: source key → tensor, views
    of the parameters where the layout allows)."""

    def __init__(self, module: nn.Module, prefix: str = ""):
        self.params = dict(module.named_parameters())
        self.prefix = prefix
        self.out: dict[str, torch.Tensor] = {}

    def put(self, src_key: str, dst: str, tx: _Tx = ID) -> None:
        self.out[self.prefix + src_key] = tx.inv(self.params[dst].detach())

    def fused(self, src_key: str, dsts: tuple) -> None:
        self.out[self.prefix + src_key] = torch.cat(
            [self.params[d].detach() for d in dsts])


class _Prefixed(Mapping[str, torch.Tensor]):
    """The keys of ``sd`` under ``prefix``, with the prefix cut off."""

    def __init__(self, sd: Mapping[str, torch.Tensor], prefix: str):
        self.sd, self.prefix = sd, prefix
        self._keys = [k[len(prefix):] for k in sd if k.startswith(prefix)]

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.sd[self.prefix + key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and (self.prefix + key) in self.sd


# ---------------------------------------------------------------------------
# CLIP: HF layout (SD 1.5's encoder, SDXL's embedders.0), OpenCLIP layout
# (SDXL's embedders.1)
# ---------------------------------------------------------------------------

def _clip_hf_layout(f, config, p: str) -> None:
    f.put(f"{p}embeddings.token_embedding.weight", "tok_emb.weight")
    f.put(f"{p}embeddings.position_embedding.weight", "pos_emb")
    for i in range(config.layers):
        src, dst = f"{p}encoder.layers.{i}", f"layer_{i}"
        f.norm(f"{src}.layer_norm1", f"{dst}.ln1")
        f.norm(f"{src}.layer_norm2", f"{dst}.ln2")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            f.linear(f"{src}.self_attn.{proj}", f"{dst}.attn.{proj}")
        f.linear(f"{src}.mlp.fc1", f"{dst}.fc1")
        f.linear(f"{src}.mlp.fc2", f"{dst}.fc2")
    f.norm(f"{p}final_layer_norm", "final_ln")
    if config.projection_dim:
        # CLIPTextModelWithProjection keeps it outside text_model.
        f.linear("text_projection", "text_projection", bias=False)


def convert_clip_hf(sd: Mapping[str, torch.Tensor], module: nn.Module,
                    prefix: str = "text_model.") -> None:
    """HF ``CLIPTextModel`` state dict → ``clip.CLIPTextTransformer``. The
    ``position_ids`` buffers of HF dumps are ignored."""
    f = _Filler(sd, module)
    _clip_hf_layout(f, module.config, prefix)
    f.ignore(k for k in sd if k.endswith("position_ids"))
    f.finish(expect_prefix=prefix)


def _clip_openclip_layout(f, config, p: str) -> None:
    f.put(f"{p}token_embedding.weight", "tok_emb.weight")
    f.put(f"{p}positional_embedding", "pos_emb")
    for i in range(config.layers):
        src, dst = f"{p}transformer.resblocks.{i}", f"layer_{i}"
        f.norm(f"{src}.ln_1", f"{dst}.ln1")
        f.norm(f"{src}.ln_2", f"{dst}.ln2")
        for part in ("weight", "bias"):
            f.fused(f"{src}.attn.in_proj_{part}",
                    tuple(f"{dst}.attn.{q}.{part}"
                          for q in ("q_proj", "k_proj", "v_proj")))
        f.linear(f"{src}.attn.out_proj", f"{dst}.attn.out_proj")
        f.linear(f"{src}.mlp.c_fc", f"{dst}.fc1")
        f.linear(f"{src}.mlp.c_proj", f"{dst}.fc2")
    f.norm(f"{p}ln_final", "final_ln")
    f.put(f"{p}text_projection", "text_projection.weight", T)


def convert_clip_openclip(sd: Mapping[str, torch.Tensor], module: nn.Module,
                          prefix: str = "model.") -> None:
    """OpenCLIP text tower → ``clip.CLIPTextTransformer`` (with its
    projection); ``attn_mask`` and ``logit_scale`` are ignored."""
    f = _Filler(sd, module)
    _clip_openclip_layout(f, module.config, prefix)
    f.ignore(k for k in sd if k.startswith(prefix)
             and k.endswith(("attn_mask", "logit_scale")))
    f.finish(expect_prefix=prefix)


# ---------------------------------------------------------------------------
# UNet (LDM/SGM UNetModel numbering)
# ---------------------------------------------------------------------------

def _res_block(f, src: str, dst: str, has_skip: bool) -> None:
    """LDM ResBlock: in_layers=[GN, SiLU, conv], emb_layers=[SiLU,
    Linear], out_layers=[GN, SiLU, dropout, conv], a 1×1 skip_connection
    where the width changes."""
    f.norm(f"{src}.in_layers.0", f"{dst}.GroupNorm32_0.GroupNorm_0")
    f.conv(f"{src}.in_layers.2", f"{dst}.conv1")
    f.linear(f"{src}.emb_layers.1", f"{dst}.time_proj")
    f.norm(f"{src}.out_layers.0", f"{dst}.GroupNorm32_1.GroupNorm_0")
    f.conv(f"{src}.out_layers.3", f"{dst}.conv2")
    if has_skip:
        f.conv(f"{src}.skip_connection", f"{dst}.skip")


def _spatial_transformer(f, src: str, dst: str, depth: int,
                         linear_proj: bool) -> None:
    f.norm(f"{src}.norm", f"{dst}.GroupNorm32_0.GroupNorm_0")
    proj_tx = ID if linear_proj else SQUEEZE
    f.linear(f"{src}.proj_in", f"{dst}.proj_in", tx=proj_tx)
    for d in range(depth):
        b_src, b_dst = f"{src}.transformer_blocks.{d}", f"{dst}.block_{d}"
        for n in range(3):
            f.norm(f"{b_src}.norm{n + 1}", f"{b_dst}.LayerNorm_{n}")
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                f.put(f"{b_src}.{attn}.{proj}.weight",
                      f"{b_dst}.{attn}.{proj}.weight")
            f.linear(f"{b_src}.{attn}.to_out.0", f"{b_dst}.{attn}.to_out")
        f.linear(f"{b_src}.ff.net.0.proj", f"{b_dst}.ff.proj_in")
        f.linear(f"{b_src}.ff.net.2", f"{b_dst}.ff.proj_out")
    f.linear(f"{src}.proj_out", f"{dst}.proj_out", tx=proj_tx)


def _unet_embed_layout(f, cfg, p: str) -> None:
    f.linear(f"{p}time_embed.0", "time_1")
    f.linear(f"{p}time_embed.2", "time_2")
    if cfg.adm_in_channels:
        f.linear(f"{p}label_emb.0.0", "label_1")
        f.linear(f"{p}label_emb.0.2", "label_2")


def _unet_down_layout(f, cfg, p: str, linear_proj: bool) -> int:
    """The encoder walk (the ControlNet's trunk is a copy of it); returns
    the number of skips."""
    f.conv(f"{p}input_blocks.0.0", "conv_in")
    idx = skips = 1
    prev_ch = cfg.model_channels
    for level, mult in enumerate(cfg.channel_mult):
        ch = cfg.model_channels * mult
        for i in range(cfg.num_res_blocks):
            src = f"{p}input_blocks.{idx}"
            _res_block(f, f"{src}.0", f"down_{level}_res_{i}",
                       has_skip=prev_ch != ch)
            if cfg.transformer_depth[level]:
                _spatial_transformer(f, f"{src}.1", f"down_{level}_attn_{i}",
                                     cfg.transformer_depth[level], linear_proj)
            prev_ch = ch
            idx += 1
            skips += 1
        if level < len(cfg.channel_mult) - 1:
            f.conv(f"{p}input_blocks.{idx}.0.op", f"down_{level}_ds.Conv_0")
            idx += 1
            skips += 1
    return skips


def _unet_mid_layout(f, cfg, p: str, linear_proj: bool) -> None:
    """The middle block by the preset's config. The ``sd15`` preset has no
    middle transformer (as the JAX preset), so a published SD 1.5 file,
    whose ``middle_block.1`` is one, fails here on
    ``middle_block.1.in_layers``."""
    _res_block(f, f"{p}middle_block.0", "mid_res_1", has_skip=False)
    if cfg.transformer_depth[-1]:
        _spatial_transformer(f, f"{p}middle_block.1", "mid_attn",
                             cfg.transformer_depth[-1], linear_proj)
        _res_block(f, f"{p}middle_block.2", "mid_res_2", has_skip=False)
    else:
        _res_block(f, f"{p}middle_block.1", "mid_res_2", has_skip=False)


def _unet_layout(f, cfg, p: str, linear_proj: bool) -> None:
    """The whole LDM walk, in the LDM constructor's block numbering."""
    _unet_embed_layout(f, cfg, p)
    _unet_down_layout(f, cfg, p, linear_proj)
    _unet_mid_layout(f, cfg, p, linear_proj)
    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            src = f"{p}output_blocks.{idx}"
            _res_block(f, f"{src}.0", f"up_{level}_res_{i}", has_skip=True)
            sub = 1
            if cfg.transformer_depth[level]:
                _spatial_transformer(f, f"{src}.{sub}", f"up_{level}_attn_{i}",
                                     cfg.transformer_depth[level], linear_proj)
                sub += 1
            if level > 0 and i == cfg.num_res_blocks:
                f.conv(f"{src}.{sub}.conv", f"up_{level}_us.Conv_0")
            idx += 1
    f.norm(f"{p}out.0", "norm_out.GroupNorm_0")
    f.conv(f"{p}out.2", "conv_out")


def linear_proj_of(config) -> bool:
    """Whether a published file of this UNet runs ``proj_in``/``proj_out``
    as Linears (SDXL) or as 1×1 convolutions (SD 1.5: context 768, no
    ADM)."""
    return not (config.context_dim == 768 and config.adm_in_channels == 0)


def _detect_linear_proj(sd: Mapping[str, torch.Tensor], prefix: str) -> bool:
    for k in sd:
        if k.startswith(prefix) and k.endswith("proj_in.weight"):
            return len(sd[k].shape) == 2
    return True


def convert_unet(sd: Mapping[str, torch.Tensor], module: nn.Module,
                 prefix: str = "model.diffusion_model.") -> None:
    """LDM ``UNetModel`` → ``unet.UNet2D``; Linear or 1×1-conv
    ``proj_in``/``proj_out`` as the file has them."""
    f = _Filler(sd, module)
    _unet_layout(f, module.config, prefix, _detect_linear_proj(sd, prefix))
    f.finish(expect_prefix=prefix)


# ---------------------------------------------------------------------------
# VAE (LDM AutoencoderKL)
# ---------------------------------------------------------------------------

def _vae_res(f, src: str, dst: str, has_skip: bool) -> None:
    f.norm(f"{src}.norm1", f"{dst}.GroupNorm32_0.GroupNorm_0")
    f.conv(f"{src}.conv1", f"{dst}.conv1")
    f.norm(f"{src}.norm2", f"{dst}.GroupNorm32_1.GroupNorm_0")
    f.conv(f"{src}.conv2", f"{dst}.conv2")
    if has_skip:
        f.conv(f"{src}.nin_shortcut", f"{dst}.skip")


def _vae_mid(f, src: str, dst: str) -> None:
    _vae_res(f, f"{src}.block_1", f"{dst}.res1", has_skip=False)
    f.norm(f"{src}.attn_1.norm", f"{dst}.GroupNorm32_0.GroupNorm_0")
    for t_proj, o_proj in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                           ("proj_out", "to_out")):
        f.linear(f"{src}.attn_1.{t_proj}", f"{dst}.attn.{o_proj}", tx=SQUEEZE)
    _vae_res(f, f"{src}.block_2", f"{dst}.res2", has_skip=False)


def _vae_encoder_layout(f, cfg, p: str, quant_convs: bool = True) -> None:
    e = "encoder."
    f.conv(f"{p}encoder.conv_in", f"{e}conv_in")
    prev_ch = cfg.base_channels
    for level, mult in enumerate(cfg.channel_mult):
        ch = cfg.base_channels * mult
        for i in range(cfg.num_res_blocks):
            _vae_res(f, f"{p}encoder.down.{level}.block.{i}",
                     f"{e}down_{level}_res_{i}", has_skip=prev_ch != ch)
            prev_ch = ch
        if level < len(cfg.channel_mult) - 1:
            f.conv(f"{p}encoder.down.{level}.downsample.conv",
                   f"{e}down_{level}_ds")
    _vae_mid(f, f"{p}encoder.mid", f"{e}mid")
    f.norm(f"{p}encoder.norm_out", f"{e}norm_out.GroupNorm_0")
    f.conv(f"{p}encoder.conv_out", f"{e}conv_out")
    if quant_convs:
        f.conv(f"{p}quant_conv", f"{e}quant_conv")


def _vae_decoder_layout(f, cfg, p: str, quant_convs: bool = True) -> None:
    d = "decoder."
    if quant_convs:
        f.conv(f"{p}post_quant_conv", f"{d}post_quant_conv")
    f.conv(f"{p}decoder.conv_in", f"{d}conv_in")
    _vae_mid(f, f"{p}decoder.mid", f"{d}mid")
    prev_ch = cfg.base_channels * cfg.channel_mult[-1]
    for level in reversed(range(len(cfg.channel_mult))):
        ch = cfg.base_channels * cfg.channel_mult[level]
        for i in range(cfg.num_res_blocks + 1):
            _vae_res(f, f"{p}decoder.up.{level}.block.{i}",
                     f"{d}up_{level}_res_{i}", has_skip=prev_ch != ch)
            prev_ch = ch
        if level > 0:
            f.conv(f"{p}decoder.up.{level}.upsample.conv", f"{d}up_{level}_us")
    f.norm(f"{p}decoder.norm_out", f"{d}norm_out.GroupNorm_0")
    f.conv(f"{p}decoder.conv_out", f"{d}conv_out")


def _vae_layout(f, cfg, p: str, quant_convs: bool = True) -> None:
    _vae_encoder_layout(f, cfg, p, quant_convs)
    _vae_decoder_layout(f, cfg, p, quant_convs)


def _identity_conv(channels: int) -> torch.Tensor:
    return torch.eye(channels)[:, :, None, None]


def convert_vae(sd: Mapping[str, torch.Tensor], vae: nn.Module,
                prefix: str = "first_stage_model.",
                quant_convs: bool = True) -> None:
    """LDM ``AutoencoderKL`` → ``vae.AutoencoderKL`` with its encoder (a
    UNet bundle's). ``quant_convs=False`` takes the BFL ``ae.safetensors``
    layout, which has none: identity 1×1 convolutions are put in."""
    cfg = vae.config
    f = _Filler(sd, vae)
    _vae_layout(f, cfg, prefix, quant_convs)
    if not quant_convs:
        z = cfg.latent_channels
        f.put_raw(_identity_conv(2 * z), "encoder.quant_conv.weight")
        f.put_raw(torch.zeros(2 * z), "encoder.quant_conv.bias")
        f.put_raw(_identity_conv(z), "decoder.post_quant_conv.weight")
        f.put_raw(torch.zeros(z), "decoder.post_quant_conv.bias")
    f.finish(expect_prefix=prefix,
             skip=lambda k: "loss" in k or "model_ema" in k)


# ---------------------------------------------------------------------------
# single-file checkpoint assembly
# ---------------------------------------------------------------------------

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
SDXL_CLIP_L_ROOT = "conditioner.embedders.0.transformer."
SDXL_CLIP_G_ROOT = "conditioner.embedders.1."
SD15_CLIP_ROOT = "cond_stage_model.transformer."
SDXL_CLIP_L_PREFIX = SDXL_CLIP_L_ROOT + "text_model."
SDXL_CLIP_G_PREFIX = SDXL_CLIP_G_ROOT + "model."
SD15_CLIP_PREFIX = SD15_CLIP_ROOT + "text_model."

FLUX_DIFFUSERS_HINT = "transformer_blocks."
FLUX_SINGLE_DIFFUSERS_HINT = "single_transformer_blocks."
_NOT_PORTED = {
    "flux": "FLUX transformer files are not ported yet (ROADMAP.md, item "
            "A.7b: T5, FluxTextStack, convert_flux)",
    "sd3": "SD3 MMDiT files are not ported yet (ROADMAP.md, item 13: SD3 "
           "presets)",
    "wan": "WAN transformer files are not ported yet (ROADMAP.md, item 15: "
           "video)",
}


def detect_layout(sd: Mapping[str, torch.Tensor]) -> str:
    if any(k.endswith("double_blocks.0.img_attn.qkv.weight") for k in sd):
        return "flux"
    if any(k.endswith("joint_blocks.0.x_block.attn.qkv.weight") for k in sd):
        return "sd3"
    if any(k.endswith("blocks.0.self_attn.norm_q.weight") for k in sd):
        return "wan"
    if any(FLUX_SINGLE_DIFFUSERS_HINT in k for k in sd):
        raise ConversionError(
            "diffusers-repacked FLUX transformer (transformer_blocks.*/"
            "single_transformer_blocks.*) is not supported: convert from "
            "the BFL single-file layout (double_blocks.*/single_blocks.*) "
            "instead")
    if any(k.startswith(FLUX_DIFFUSERS_HINT) for k in sd):
        raise ConversionError(
            "diffusers-repacked SD3 MMDiT (transformer_blocks.*) is not "
            "supported: convert from the single-file layout "
            "(joint_blocks.*) instead")
    if any(k.startswith(SDXL_CLIP_G_PREFIX) for k in sd):
        return "sdxl"
    if any(k.startswith(SD15_CLIP_PREFIX) for k in sd):
        return "sd15"
    if any(k.startswith(UNET_PREFIX) for k in sd):
        return "unet-only"
    raise ConversionError("unrecognized checkpoint layout")


def convert_checkpoint(path: Path, bundle) -> None:
    """Fill a UNet ``ModelBundle`` (preset ``sdxl``/``sd15`` or one of
    their shape) from a single-file checkpoint, in place; each tensor is
    shape-checked against the live module and copied onto its device."""
    with SafetensorsFile(path) as sd:
        layout = detect_layout(sd)
        log(f"converting {path} (layout: {layout})")
        if layout in _NOT_PORTED:
            raise ConversionError(_NOT_PORTED[layout])
        if bundle.kind != "unet":
            raise ConversionError(
                f"a {layout} checkpoint needs a unet preset; "
                f"{bundle.preset.name!r} is {bundle.kind!r}")
        want = {"sdxl": "sdxl", "sd15": "clip-l"}.get(layout)
        if want and bundle.preset.clip != want:
            raise ConversionError(
                f"a {layout} checkpoint carries a {want!r} text stack; preset "
                f"{bundle.preset.name!r} has {bundle.preset.clip!r}")
        convert_unet(sd, bundle.core)
        if layout == "unet-only":
            log("unet-only checkpoint: VAE and text encoder keep their "
                "current weights")
            return
        convert_vae(sd, bundle.pipeline.vae)
        stack = bundle.build_clip_stack()
        if layout == "sdxl":
            convert_clip_hf(_Prefixed(sd, SDXL_CLIP_L_ROOT), stack.clip_l)
            convert_clip_openclip(_Prefixed(sd, SDXL_CLIP_G_ROOT), stack.clip_g)
        else:
            convert_clip_hf(_Prefixed(sd, SD15_CLIP_ROOT), stack)
    log(f"converted {path} into the {bundle.preset.name} bundle")


def export_checkpoint(bundle) -> dict[str, torch.Tensor]:
    """A UNet bundle with its CLIP stack in the published single-file
    layout (the inverse of ``convert_checkpoint``): SDXL's
    ``conditioner.embedders.*`` or SD 1.5's ``cond_stage_model.*``, with
    the ``position_ids`` and ``logit_scale`` entries a published file
    carries. Tensors are views of the parameters where the layout
    allows."""
    preset = bundle.preset
    unet = _Exporter(bundle.core, UNET_PREFIX)
    _unet_layout(unet, preset.unet, "", linear_proj_of(preset.unet))
    vae = _Exporter(bundle.pipeline.vae, VAE_PREFIX)
    _vae_layout(vae, preset.vae, "")
    out = {**unet.out, **vae.out}
    stack = bundle.clip_stack
    if preset.clip == "sdxl":
        cl, cg = stack.clip_l, stack.clip_g
        roots = [(SDXL_CLIP_L_ROOT, cl)]
        g = _Exporter(cg, SDXL_CLIP_G_ROOT)
        _clip_openclip_layout(g, cg.config, "model.")
        out.update(g.out)
        out[SDXL_CLIP_G_ROOT + "model.logit_scale"] = torch.tensor(4.6052)
    elif preset.clip == "clip-l":
        roots = [(SD15_CLIP_ROOT, stack)]
    else:
        raise ConversionError(f"preset {preset.name!r} has no CLIP stack to "
                              "export")
    for root, enc in roots:
        e = _Exporter(enc, root)
        _clip_hf_layout(e, enc.config, "text_model.")
        out.update(e.out)
        out[root + "text_model.embeddings.position_ids"] = torch.arange(
            enc.config.max_len)[None]
    return out


# ---------------------------------------------------------------------------
# ESRGAN-family upscalers (RRDBNet)
# ---------------------------------------------------------------------------

def _upscaler_config_from_sd(sd: Mapping[str, torch.Tensor], dtype: str):
    """The RRDBNet geometry from the checkpoint's shapes: BasicSR's "new
    arch" (``conv_first``/``body.N``) or original ESRGAN's "old arch"
    (``model.0``/``model.1.sub.N``)."""
    from .upscaler import UpscalerConfig

    if "conv_first.weight" in sd:
        arch = "new"
        first = sd["conv_first.weight"]
        blocks = {int(k.split(".")[1]) for k in sd if k.startswith("body.")}
        grow = sd["body.0.rdb1.conv1.weight"].shape[0]
    elif "model.0.weight" in sd:
        arch = "old"
        first = sd["model.0.weight"]
        blocks = {int(k.split(".")[3]) for k in sd
                  if k.startswith("model.1.sub.") and ".RDB" in k}
        grow = sd["model.1.sub.0.RDB1.conv1.0.weight"].shape[0]
    else:
        raise ConversionError("unrecognized upscaler layout "
                              "(no conv_first.* / model.0.*)")
    num_feat, in_total = first.shape[0], first.shape[1]
    scale = {1: 4, 4: 2, 16: 1}.get(in_total // 3)
    if scale is None or in_total % 3:
        raise ConversionError(f"cannot infer scale from stem width {in_total}")
    cfg = UpscalerConfig(scale=scale, num_feat=num_feat,
                         num_block=max(blocks) + 1, grow_ch=grow, dtype=dtype)
    return cfg, arch


def _upscaler_layout(f, cfg, arch: str) -> None:
    if arch == "new":
        def body_key(i, j, k):
            return f"body.{i}.rdb{j}.conv{k}"
        heads = {"conv_first": "conv_first", "conv_body": "conv_body",
                 "conv_up1": "conv_up1", "conv_up2": "conv_up2",
                 "conv_hr": "conv_hr", "conv_last": "conv_last"}
    else:
        def body_key(i, j, k):
            return f"model.1.sub.{i}.RDB{j}.conv{k}.0"
        heads = {"model.0": "conv_first",
                 f"model.1.sub.{cfg.num_block}": "conv_body",
                 "model.3": "conv_up1", "model.6": "conv_up2",
                 "model.8": "conv_hr", "model.10": "conv_last"}
    for src, dst in heads.items():
        f.conv(src, dst)
    for i in range(cfg.num_block):
        for j in (1, 2, 3):
            for k in (1, 2, 3, 4, 5):
                f.conv(body_key(i, j, k), f"body_{i}.rdb{j}.conv{k}")


def convert_upscaler(sd: Mapping[str, torch.Tensor], device,
                     dtype: str = "bfloat16"):
    """A torch RRDBNet state dict → an ``upscaler.RRDBNet`` on ``device``
    (built empty, every parameter filled from the file)."""
    from .upscaler import RRDBNet

    cfg, arch = _upscaler_config_from_sd(sd, dtype)
    with torch.device("meta"):
        model = RRDBNet(cfg)
    model = model.to_empty(device=device)
    f = _Filler(sd, model)
    _upscaler_layout(f, cfg, arch)
    f.finish(expect_prefix="")
    return model.eval().requires_grad_(False)


def export_upscaler(model: nn.Module, arch: str = "new") -> dict:
    e = _Exporter(model)
    _upscaler_layout(e, model.config, arch)
    return e.out


def load_upscaler_checkpoint(path: Path, device, dtype: str = "bfloat16"):
    """A published RRDBNet ``.safetensors`` → ``UpscalerBundle``."""
    from .upscaler import UpscalerBundle

    with SafetensorsFile(path) as sd:
        model = convert_upscaler(sd, device, dtype)
    cfg = model.config
    log(f"converted upscaler {path} "
        f"(x{cfg.scale}, {cfg.num_block} blocks, {cfg.num_feat} feat)")
    return UpscalerBundle(model, name=Path(path).stem)


# ---------------------------------------------------------------------------
# ControlNet (LDM cldm layout, control_model.*)
# ---------------------------------------------------------------------------

_HINT_SRC_INDICES = (0, 2, 4, 6, 8, 10, 12, 14)
CONTROLNET_PREFIX = "control_model."


def _controlnet_layout(f, cfg, p: str, linear_proj: bool) -> None:
    """The trunk is the UNet encoder's walk, plus the hint stem, one zero
    conv per skip and the middle's."""
    _unet_embed_layout(f, cfg, p)
    n_skips = _unet_down_layout(f, cfg, p, linear_proj)
    _unet_mid_layout(f, cfg, p, linear_proj)
    for j, src_idx in enumerate(_HINT_SRC_INDICES):
        f.conv(f"{p}input_hint_block.{src_idx}", f"hint_{j}")
    for i in range(n_skips):
        f.conv(f"{p}zero_convs.{i}.0", f"zero_{i}")
    f.conv(f"{p}middle_block_out.0", "mid_out")


def convert_controlnet(sd: Mapping[str, torch.Tensor], module: nn.Module,
                       prefix: str = CONTROLNET_PREFIX) -> None:
    """LDM ControlNet → ``controlnet.ControlNet``, in place."""
    f = _Filler(sd, module)
    _controlnet_layout(f, module.config, prefix,
                       _detect_linear_proj(sd, prefix))
    f.finish(expect_prefix=prefix)


def export_controlnet(module: nn.Module) -> dict:
    e = _Exporter(module, CONTROLNET_PREFIX)
    _controlnet_layout(e, module.config, "", linear_proj_of(module.config))
    return e.out


def controlnet_config_of(sd: Mapping[str, torch.Tensor]):
    """The base architecture of a ControlNet file (sdxl has an ADM)."""
    from .unet import UNetConfig

    if CONTROLNET_PREFIX + "label_emb.0.0.weight" in sd:
        return UNetConfig.sdxl()
    return UNetConfig.sd15()


def load_controlnet_checkpoint(path: Path, device, config=None):
    """A published ControlNet ``.safetensors`` → ``ControlNetBundle`` on
    ``device`` (the base architecture read from the file unless
    ``config`` is given)."""
    from .controlnet import ControlNet, ControlNetBundle

    with SafetensorsFile(path) as sd:
        cfg = config or controlnet_config_of(sd)
        with torch.device("meta"):
            model = ControlNet(cfg)
        model = model.to_empty(device=device)
        convert_controlnet(sd, model)
    log(f"converted controlnet {path} ({cfg.context_dim}-ctx)")
    return ControlNetBundle(model.eval().requires_grad_(False),
                            name=Path(path).stem)


def records(walk: Callable, *args) -> list[tuple[str, str, _Tx]]:
    """(source key, parameter, transform) of a layout walk."""
    rec = _Recorder()
    walk(rec, *args)
    return rec.records

