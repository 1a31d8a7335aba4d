"""Shared helpers of the checkpoint parity tests
(``test_torch_{convert,lora,checkpoint}.py``): tiny fp32 bundles of the
JAX package with their CLIP stacks, every weight perturbed with seeded
numpy noise, and the port's bundles carrying the same weights."""

import dataclasses

import jax
import numpy as np

from comfyui_distributed_tpu.models import registry as jreg
from comfyui_distributed_tpu.models import text as jtext
from comfyui_distributed_tpu.models import unet as junet
from comfyui_distributed_tpu.models import vae as jvae
from comfyui_distributed_tpu_torch.models import registry as treg
from comfyui_distributed_tpu_torch.models import unet as tunet
from comfyui_distributed_tpu_torch.models import vae as tvae

F32 = dict(dtype="float32")


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        tree)


def presets(clip: str, context_dim: int = 0, name: str = ""):
    """(JAX preset, port preset) of a tiny fp32 UNet bundle with the CLIP
    stack ``clip`` ("sdxl": context 80 = 32 + 48, ADM 8; "clip-l":
    context 32, no ADM; None: no stack)."""
    context_dim = context_dim or {"sdxl": 80, "clip-l": 32, None: 32}[clip]
    adm = 8 if clip == "sdxl" else 0
    ju = dataclasses.replace(junet.UNetConfig.tiny(**F32), context_dim=context_dim,
                             adm_in_channels=adm)
    tu = dataclasses.replace(tunet.UNetConfig.tiny(**F32), context_dim=context_dim,
                             adm_in_channels=adm)
    name = name or f"tiny-{clip}"
    jp = jreg.ModelPreset(name, ju, jvae.VAEConfig.tiny(**F32),
                          jtext.TextEncoderConfig.tiny(), sample_hw=(8, 8),
                          clip=clip)
    tp = treg.ModelPreset(name, tu, tvae.VAEConfig.tiny(**F32),
                          treg.TextEncoderConfig.tiny(), clip=clip)
    return jp, tp


def jax_bundle(jp, seed=0):
    """A JAX bundle with its tiny CLIP stack (where the preset has one),
    every weight perturbed."""
    b = jreg.ModelBundle(jp, seed=seed)
    b.pipeline.unet_params = perturbed(b.pipeline.unet_params, seed + 1)
    b.pipeline.vae.enc_params = perturbed(b.pipeline.vae.enc_params, seed + 2)
    b.pipeline.vae.dec_params = perturbed(b.pipeline.vae.dec_params, seed + 3)
    if jp.clip == "sdxl":
        b.build_clip_stack(tiny=True)
        b.clip_stack.clip_l.params = perturbed(b.clip_stack.clip_l.params, seed + 4)
        b.clip_stack.clip_g.params = perturbed(b.clip_stack.clip_g.params, seed + 5)
    elif jp.clip == "clip-l":
        b.build_clip_stack(tiny=True)
        b.clip_stack.params = perturbed(b.clip_stack.params, seed + 4)
    return b


def port_from_jax(tp, jb, seed=0):
    """The port bundle of preset ``tp`` carrying ``jb``'s weights."""
    stack = jb.clip_stack
    if tp.clip == "sdxl":
        clip = {"clip_l": stack.clip_l.params, "clip_g": stack.clip_g.params}
    elif tp.clip == "clip-l":
        clip = {"clip_l": stack.params}
    else:
        clip = {"text": jb.text_encoder.params}
    return treg.ModelBundle(tp, "cpu", seed=seed).load_from_jax(
        jb.pipeline.unet_params, jb.pipeline.vae.dec_params,
        vae_enc=jb.pipeline.vae.enc_params, **clip)
