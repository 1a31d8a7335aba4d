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
  (``control_model.*``) in files of their own;
- FLUX's files: the BFL transformer (``double_blocks.*``,
  ``single_blocks.*``, bare or under ``model.diffusion_model.``), T5 in
  the HF ``T5EncoderModel`` layout (``encoder.block.*``, ``shared``),
  CLIP-L as bare ``text_model.*`` and BFL's ``ae.safetensors``.

The port's parameters are already in torch layout (``[out, in]``
Linears, OIHW convolutions), so most of a walk is renaming. The real
transforms: OpenCLIP's fused ``in_proj`` split into q/k/v, OpenCLIP's
``text_projection`` (``[in, out]``) transposed into a Linear, and the 1×1
convolutions the port runs as Linears (SD 1.5's ``proj_in``/``proj_out``,
the VAE's mid attention) squeezed, FLUX's patch-feature order permuted
(``img_in``'s columns, ``final_layer.linear``'s rows), its single
blocks' ``linear1`` split by rows and its final adaLN padded with a zero
gate third.

Every walk is one function over an abstract ``put`` with three users:
``_Filler`` copies each source tensor into its parameter (cast to the
parameter's dtype on its device, one tensor at a time) with shape checks,
and ``finish`` refuses an unfilled parameter or a source key left over
under the prefix; ``_Recorder`` records (source key, parameter,
transform), the LoRA key map of ``models/lora.py``; ``_Exporter`` inverts
each transform to write a module back in the published layout (the
tests and ``chip_smoke.py`` write synthetic checkpoints with it).

SD3 and WAN files are detected and refused, each naming the item that
ports it.
"""

from __future__ import annotations

import dataclasses
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

    def fused(self, src_key: str, dsts: tuple,
              rows: Optional[tuple] = None) -> None:
        """Rows of ``src_key`` split over the parameters ``dsts``: evenly
        (OpenCLIP's ``in_proj_weight``/``in_proj_bias`` → q, k, v), or
        ``rows[j]`` rows each (FLUX's ``linear1`` → qkv, mlp_up)."""
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

    def _checked(self, value: torch.Tensor, dst: str,
                 src_key: str) -> torch.Tensor:
        """The parameter ``dst``, once ``value`` is known to fit it."""
        param = self.params.get(dst)
        if param is None:
            raise ConversionError(f"no parameter {dst!r}")
        if tuple(param.shape) != tuple(value.shape):
            raise ConversionError(
                f"{src_key} -> {dst}: shape {tuple(value.shape)} != "
                f"parameter {tuple(param.shape)}")
        self.filled.add(dst)
        return param

    @torch.no_grad()
    def put_raw(self, value: torch.Tensor, dst: str, src_key: str = "") -> None:
        self._checked(value, dst, src_key).copy_(value)

    def put(self, src_key: str, dst: str, tx: _Tx = ID) -> None:
        self.put_raw(tx.fwd(self._take(src_key)), dst, src_key)

    def fused(self, src_key: str, dsts: tuple,
              rows: Optional[tuple] = None) -> None:
        value = self._take(src_key)
        if rows is None:
            rows = (value.shape[0] // len(dsts),) * len(dsts)
        if sum(rows) != value.shape[0]:
            raise ConversionError(
                f"{src_key}: shape {tuple(value.shape)} does not split into "
                f"{len(dsts)} parts of {rows} rows")
        start = 0
        for dst, n in zip(dsts, rows):
            self.put_raw(value[start:start + n], dst, src_key)
            start += n

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

    def fused(self, src_key: str, dsts: tuple,
              rows: Optional[tuple] = None) -> None:
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

    def fused(self, src_key: str, dsts: tuple,
              rows: Optional[tuple] = None) -> None:
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
    """The middle block by the config's ``mid_depth``: res, transformer,
    res (``middle_block.0-2``), or two res blocks (``middle_block.0-1``)
    where it is 0."""
    _res_block(f, f"{p}middle_block.0", "mid_res_1", has_skip=False)
    if cfg.mid_depth:
        _spatial_transformer(f, f"{p}middle_block.1", "mid_attn",
                             cfg.mid_depth, linear_proj)
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


def middle_depth_of(sd, prefix: str = "model.diffusion_model.") -> Optional[int]:
    """The middle transformer's depth in a UNet state dict (the blocks of
    ``middle_block.1.transformer_blocks`` where ``middle_block.2`` exists,
    else 0), or None where the file has no middle block. Reads key names
    only, so a file's header is enough."""
    mid = f"{prefix}middle_block."
    keys = [k for k in sd if k.startswith(mid)]
    if not keys:
        return None
    if not any(k.startswith(mid + "2.") for k in keys):
        return 0
    blocks = mid + "1.transformer_blocks."
    return len({k[len(blocks):].split(".", 1)[0] for k in keys
                if k.startswith(blocks)})


def with_middle_of(config, sd, prefix: str = "model.diffusion_model."):
    """``config`` with the middle depth of the file ``sd`` where the file
    has a middle block and its depth differs (a published SD 1.5 file
    for the ``sd15`` preset)."""
    depth = middle_depth_of(sd, prefix)
    if depth is None or depth == config.mid_depth:
        return config
    log(f"the file's middle block has {depth} transformer block(s); the "
        f"config has {config.mid_depth}: building the file's")
    return dataclasses.replace(config, middle_depth=depth)


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


class _ShapeChecker(_Filler):
    """A ``_Filler`` that checks each source tensor's shape against a
    module (one on the ``meta`` device will do) and copies nothing."""

    def put_raw(self, value: torch.Tensor, dst: str, src_key: str = "") -> None:
        self._checked(value, dst, src_key)


def convert_vae(sd: Mapping[str, torch.Tensor], vae: nn.Module,
                prefix: str = "first_stage_model.",
                quant_convs: bool = True) -> None:
    """LDM ``AutoencoderKL`` → ``vae.AutoencoderKL``. ``quant_convs=False``
    takes the BFL ``ae.safetensors`` layout, which has none: identity 1×1
    convolutions are put in. A VAE built without its encoder (a FLUX
    bundle decodes only) takes the decoder; the file's encoder keys are
    shape-checked against an encoder on the ``meta`` device and dropped."""
    cfg = vae.config
    f = _Filler(sd, vae)
    z = cfg.latent_channels
    if vae.encoder is None:
        from .vae import AutoencoderKL

        with torch.device("meta"):
            ghost = AutoencoderKL(cfg, encoder=True)
        check = _ShapeChecker(sd, ghost)
        _vae_encoder_layout(check, cfg, prefix, quant_convs)
        f.used |= check.used
        _vae_decoder_layout(f, cfg, prefix, quant_convs)
    else:
        _vae_layout(f, cfg, prefix, quant_convs)
        if not quant_convs:
            f.put_raw(_identity_conv(2 * z), "encoder.quant_conv.weight")
            f.put_raw(torch.zeros(2 * z), "encoder.quant_conv.bias")
    if not quant_convs:
        f.put_raw(_identity_conv(z), "decoder.post_quant_conv.weight")
        f.put_raw(torch.zeros(z), "decoder.post_quant_conv.bias")
    f.finish(expect_prefix=prefix,
             skip=lambda k: "loss" in k or "model_ema" in k)


def export_vae(vae: nn.Module, prefix: str = "",
               quant_convs: bool = True) -> dict:
    """A VAE with its encoder in the LDM layout (``quant_convs=False``:
    BFL's ``ae.safetensors``, whose identity quant convs are left out)."""
    e = _Exporter(vae, prefix)
    _vae_layout(e, vae.config, "", quant_convs)
    return e.out


# ---------------------------------------------------------------------------
# T5 (HF T5EncoderModel / UMT5EncoderModel layout)
# ---------------------------------------------------------------------------

T5_TIED = "encoder.embed_tokens.weight"     # the tied copy HF also emits


def _t5_layout(f, cfg) -> None:
    f.put("shared.weight", "shared.weight")
    for i in range(cfg.num_layers):
        blk = f"encoder.block.{i}.layer"
        for proj in ("q", "k", "v", "o"):
            f.put(f"{blk}.0.SelfAttention.{proj}.weight",
                  f"attn_{i}.{proj}.weight")
        f.put(f"{blk}.0.layer_norm.weight", f"ln_attn_{i}.weight")
        bias_key = f"{blk}.0.SelfAttention.relative_attention_bias.weight"
        if cfg.per_layer_rel_bias:
            f.put(bias_key, f"rel_bias_{i}.weight")
        elif i == 0:
            f.put(bias_key, "rel_bias.weight")
        for proj in ("wi_0", "wi_1", "wo"):
            f.put(f"{blk}.1.DenseReluDense.{proj}.weight",
                  f"ff_{i}.{proj}.weight")
        f.put(f"{blk}.1.layer_norm.weight", f"ln_ff_{i}.weight")
    f.put("encoder.final_layer_norm.weight", "final_ln.weight")


def convert_t5(sd: Mapping[str, torch.Tensor], module: nn.Module) -> None:
    """HF ``T5EncoderModel``/``UMT5EncoderModel`` state dict →
    ``t5.T5Encoder``, in place (the layouts agree: renaming only). The
    tied ``encoder.embed_tokens.weight`` is consumed; any other key left
    over raises."""
    f = _Filler(sd, module)
    _t5_layout(f, module.config)
    if T5_TIED in sd:
        f.ignore([T5_TIED])
    f.finish(expect_prefix="")


def export_t5(module: nn.Module) -> dict:
    """A ``T5Encoder`` in the HF layout, with the tied embedding copy HF
    writes."""
    e = _Exporter(module)
    _t5_layout(e, module.config)
    e.out[T5_TIED] = e.out["shared.weight"]
    return e.out


def export_clip_hf(module: nn.Module, root: str = "") -> dict:
    """A CLIP tower in the HF ``CLIPTextModel`` layout under ``root``
    (FLUX's ``clip_l.safetensors``: bare ``text_model.*``), with the
    ``position_ids`` a published file carries."""
    e = _Exporter(module, root)
    _clip_hf_layout(e, module.config, "text_model.")
    e.out[root + "text_model.embeddings.position_ids"] = torch.arange(
        module.config.max_len)[None]
    return e.out


# ---------------------------------------------------------------------------
# FLUX transformer (BFL layout)
# ---------------------------------------------------------------------------

FLUX_PREFIXED = "model.diffusion_model."         # ComfyUI single-file repack


def _flux_patch_perm(p: int, c: int) -> torch.Tensor:
    """Patch-token feature order, BFL → the port. BFL patchifies
    ``(c, ph, pw)``-major, ``dit.patchify`` flattens ``(ph, pw, c)``:
    ``perm[j]`` is the BFL feature that holds the port's feature ``j``."""
    return torch.arange(c * p * p).reshape(c, p, p).permute(1, 2, 0).reshape(-1)


def _flux_txs(cfg) -> tuple[_Tx, _Tx, _Tx]:
    """(img_in's columns, final_layer.linear's rows: both permuted by
    ``_flux_patch_perm``; the final adaLN's [shift | scale] rows padded
    with a zero gate third, which the final layer never reads)."""
    perm = _flux_patch_perm(cfg.patch_size, cfg.in_channels)
    inv = torch.argsort(perm)

    def gate0(w: torch.Tensor) -> torch.Tensor:
        return torch.cat([w, w.new_zeros((w.shape[0] // 2, *w.shape[1:]))])

    return (_Tx("cols", lambda w: w[:, perm.to(w.device)],
                lambda w: w[:, inv.to(w.device)]),
            _Tx("rows", lambda w: w[perm.to(w.device)],
                lambda w: w[inv.to(w.device)]),
            _Tx("gate0", gate0, lambda w: w[: w.shape[0] * 2 // 3]))


def _flux_layout(f, cfg, p: str) -> None:
    """The BFL walk: ``img_in``, ``txt_in``, the embedders, double blocks
    (``{img,txt}_{mod.lin,attn.qkv,attn.norm,attn.proj,mlp.0,mlp.2}``),
    single blocks (``linear1``'s rows ``[3h | 4h]`` → qkv, mlp_up),
    ``final_layer``."""
    cols, rows, gate0 = _flux_txs(cfg)
    h = cfg.hidden
    f.put(f"{p}img_in.weight", "img_in.weight", cols)
    f.put(f"{p}img_in.bias", "img_in.bias")
    f.linear(f"{p}txt_in", "txt_in")
    embedders = ["time_in", "vector_in"]
    if cfg.guidance_embed:
        embedders.append("guidance_in")
    for name in embedders:
        f.linear(f"{p}{name}.in_layer", f"{name}.in_layer")
        f.linear(f"{p}{name}.out_layer", f"{name}.out_layer")
    for i in range(cfg.depth_double):
        src, dst = f"{p}double_blocks.{i}", f"double_{i}"
        for s in ("img", "txt"):
            f.linear(f"{src}.{s}_mod.lin", f"{dst}.{s}_mod.mod")
            f.linear(f"{src}.{s}_attn.qkv", f"{dst}.{s}_qkv.qkv")
            f.put(f"{src}.{s}_attn.norm.query_norm.scale",
                  f"{dst}.{s}_qkv.q_scale")
            f.put(f"{src}.{s}_attn.norm.key_norm.scale",
                  f"{dst}.{s}_qkv.k_scale")
            f.linear(f"{src}.{s}_attn.proj", f"{dst}.{s}_proj")
            f.linear(f"{src}.{s}_mlp.0", f"{dst}.{s}_mlp_up")
            f.linear(f"{src}.{s}_mlp.2", f"{dst}.{s}_mlp_down")
    for i in range(cfg.depth_single):
        src, dst = f"{p}single_blocks.{i}", f"single_{i}"
        for part in ("weight", "bias"):
            f.fused(f"{src}.linear1.{part}",
                    (f"{dst}.qkv.qkv.{part}", f"{dst}.mlp_up.{part}"),
                    rows=(3 * h, 4 * h))
        f.put(f"{src}.norm.query_norm.scale", f"{dst}.qkv.q_scale")
        f.put(f"{src}.norm.key_norm.scale", f"{dst}.qkv.k_scale")
        f.linear(f"{src}.linear2", f"{dst}.out")
        f.linear(f"{src}.modulation.lin", f"{dst}.mod.mod")
    for part in ("weight", "bias"):
        f.put(f"{p}final_layer.adaLN_modulation.1.{part}",
              f"final_mod.mod.{part}", gate0)
    f.put(f"{p}final_layer.linear.weight", "img_out.weight", rows)
    f.put(f"{p}final_layer.linear.bias", "img_out.bias", rows)


def _blocks_under(sd, head: str) -> int:
    """The number of distinct ``{head}{N}.`` block indices among the keys."""
    return len({k[len(head):].split(".", 1)[0] for k in sd
                if k.startswith(head)})


def with_flux_depth_of(config, sd, prefix: str = ""):
    """``config`` with the double and single block counts of the FLUX file
    ``sd`` where they differ (a lighter published variant, or a file cut
    in depth); widths are never read from the file."""
    double = _blocks_under(sd, f"{prefix}double_blocks.")
    single = _blocks_under(sd, f"{prefix}single_blocks.")
    if (double, single) == (config.depth_double, config.depth_single):
        return config
    log(f"the FLUX file has {double} double and {single} single blocks; "
        f"the config has {config.depth_double} and {config.depth_single}: "
        "building the file's")
    return dataclasses.replace(config, depth_double=double,
                               depth_single=single)


def t5_layers_of(sd) -> int:
    """The encoder blocks of a T5 file (HF ``encoder.block.N``)."""
    return _blocks_under(sd, "encoder.block.")


def flux_prefix_of(sd: Mapping[str, torch.Tensor]) -> str:
    """``model.diffusion_model.`` for a single-file repack, else bare."""
    return (FLUX_PREFIXED if any(k.startswith(FLUX_PREFIXED) for k in sd)
            else "")


def convert_flux(sd: Mapping[str, torch.Tensor], module: nn.Module,
                 prefix: str = "") -> None:
    """BFL FLUX transformer (the published ``flux1-dev``/``flux1-schnell``
    keys, bare or under ``model.diffusion_model.``) → ``dit.DiT``, in
    place. A preset with distilled guidance refuses a file without
    ``guidance_in.*`` (schnell)."""
    cfg = module.config
    if cfg.guidance_embed and f"{prefix}guidance_in.in_layer.weight" not in sd:
        raise ConversionError(
            "preset expects distilled guidance (guidance_embed=True) but "
            "the checkpoint has no guidance_in.* keys: use a schnell-style "
            "preset with guidance_embed=False")
    f = _Filler(sd, module)
    _flux_layout(f, cfg, prefix)
    f.finish(expect_prefix=prefix)


def export_flux(module: nn.Module, prefix: str = "") -> dict:
    """A ``DiT`` in the BFL layout (views of the parameters, except the
    permuted ``img_in``/``final_layer.linear`` and the concatenated
    ``linear1``)."""
    e = _Exporter(module, prefix)
    _flux_layout(e, module.config, "")
    return e.out


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
    """Fill a ``ModelBundle`` from a single-file checkpoint, in place: a
    UNet bundle (preset ``sdxl``/``sd15`` or one of their shape) with its
    VAE and CLIP stack, or a DiT bundle's transformer from a FLUX file;
    each tensor is shape-checked against the live module and copied onto
    its device."""
    with SafetensorsFile(path) as sd:
        layout = detect_layout(sd)
        log(f"converting {path} (layout: {layout})")
        if layout in _NOT_PORTED:
            raise ConversionError(_NOT_PORTED[layout])
        if layout == "flux":
            if bundle.kind != "dit":
                raise ConversionError(
                    "a FLUX transformer checkpoint needs a dit preset; "
                    f"{bundle.preset.name!r} is {bundle.kind!r}")
            convert_flux(sd, bundle.core, flux_prefix_of(sd))
            log("FLUX transformer converted; the VAE and the text encoders "
                "ship in files of their own (load_vae_file, "
                "load_text_encoder_files)")
            return
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
        out.update(export_clip_hf(enc, root))
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
        cfg = config or with_middle_of(controlnet_config_of(sd), sd,
                                       CONTROLNET_PREFIX)
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

