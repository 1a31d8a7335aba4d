#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) when it fails:

1. device  — card name, count, torch/CUDA versions and the
   ``nvidia-smi`` name and power limit; no card → exit 2.
2. build   — nvcc builds the attention kernels from
   ``comfyui_distributed_tpu_torch/ops/csrc`` into ``build/torch_kernels``
   and prints ptxas's register / stack / spill report per kernel and the
   short-key kernel's dynamic shared memory per (head width, key tile); a
   spill, a missing instantiation (a streamed core for each of D 40, 64,
   80, 128, 160, a short-key kernel for each key tile the wrapper selects
   there: 80 and 128, only 80 at D = 160), or a kernel that hands
   registers over with ``setmaxnreg`` but does not hold 168 at entry fails
   the run.
3. kernels — every attention kernel at its path's shapes, at ragged
   shapes, at the streamed core's tile edges (keys 1, 77, 128, 129; q
   rows 1, 64, 4173; D 64 and 128) and at the short-key kernel's (keys
   1, 16, 17, 77, 80, 128; q rows 1, 64, 128, 129, 4173; D 64 and 128;
   B 1 and 2; one work item; an item count that is not a multiple of
   the grid), and K1's projection GEMM alone, against their plain
   PyTorch versions in bf16 (max-abs error ≤ 1e-2·max|plain|); each
   compared attention call follows a call at the same shape on other
   inputs, so a tile the kernel skipped shows stale numbers. Then
   CUDA-event times of the kernel, the plain version and one PyTorch
   library call computing the same function (a yardstick only: the
   port never calls it), beside the least time the card could take, and
   the host's enqueue time per call. K1 is also timed as its two
   launches (projection, core), K2 also on the streamed core (the
   kernel that takes more than 128 keys) at the same shapes. Then K3 at
   SD 1.5's head widths 40, 80 and 160 (one-head layout only; the packed
   layout takes D 64 and 128): the sd15 path's shapes (batch 2 at 512²:
   4096, 1024 and 256 tokens, self and against 77 keys; a published
   file's middle transformer at 64 tokens, D 160), the ControlNet
   tile upscale's (batch 8: 10816, 2704 and 676 tokens) and the tile
   edges (keys 1, 77, 128, 129; q rows 1, 64, 4173; B 1 and 2), each
   compared call after a poisoning call, the plain version taken one
   batch row at a time; timed beside the plain version and
   ``scaled_dot_product_attention``, the bound counted at the true D.
   The video upscale's tile shapes the ControlNet tile upscale does not
   give (batch 8: 10404 tokens at D 40, 2601 at D 80, self and over 77
   keys) are compared and timed the same way.
   FLUX from its files (4608 tokens: T5's 512 context tokens) is compared
   and timed beside the random-init FLUX shape (4173).
4. sdxl path — the SDXL preset at full width (random weights from seed
   0) runs ``workflows/distributed-txt2img.json`` through the port's
   ``GraphExecutor`` as three requests (seed 7, 8, 7): images
   [1,1024,1024,3], finite, in [0,1], PNGs written, the repeated seed
   bitwise equal, the other seed different, and each wrapper's launch
   counter and each CUDA kernel's rising by exactly the count one
   request needs.
5. sdxl reference — the same UNet at a 512² latent, once through the
   kernels and once with its attention sites on the plain versions; the
   two eps predictions agree within 5e-2·max|plain|.
6. upscale path — ``workflows/distributed-upscale.json`` unchanged on
   the sdxl path's registry: a seeded 1024² RGB ``input.png`` (written by
   the port's ``encode_png``) → ``esrgan-x4`` (RRDBNet, 23 blocks, random
   init from seed 0) to 4096² → USDU at ``upscale_by`` 1.0 with 1024²
   tiles and padding 32 (16 crops of 1088², 4 a chunk, 7 euler steps of
   the 20-step karras ladder at denoise 0.35, CFG 6) → a 4096² PNG, run
   twice: the two images bitwise equal, [1,4096,4096,3], finite, in
   [0,1], and exactly 1968 K1 and 1960 K2 launches a request. Prints the
   seconds of the ESRGAN upscale, of each chunk's encode, sampling and
   decode, of the composite, and the peak memory; and the host seconds
   of ``decode_png`` on a 1024² PNG under the Average and Paeth filters.
7. upscale reference — one 4-tile chunk of that upscale through
   ``TileUpscaler`` with the kernels, each of its 7 UNet forwards also
   run on the same inputs with the attention sites on the plain
   versions: every eps within 5e-2·max|plain|. The whole chunk on the
   plain versions (same noise) is printed beside it, not bounded, with
   the plain chunk's difference from itself in chunks of 2 (the
   round-off floor).
8. img2img + ControlNet — on the sdxl path's registry, a graph of
   ``LoadImage`` (the upscale path's 1024² input), ``ControlNetLoader
   sdxl`` (a copy of SDXL's encoder and middle, random init from seed 0),
   ``ControlNetApply`` (strength 0.8, the input as hint) and ``TPUImg2Img``
   (30 steps at denoise 0.6: 18 UNet + ControlNet forwards, CFG 5) at
   seeds 21, 22, 21: images [1,1024,1024,3], the repeat bitwise equal,
   the seeds different, exactly 18·104 + 8 = 1880 K1 and 1872 K2
   launches a request; the same graph without ``ControlNetApply`` (1268
   K1, 1260 K2) gives another image. Then one UNet + ControlNet forward
   at a 512² latent through the kernels and with the attention sites on
   the plain versions: within 5e-2·max|plain|.
9. inpaint — ``TPUInpaint`` on the same input with a mask PNG whose
   left half is white (channel 0 is the mask), same spec, no ControlNet:
   the right half bitwise the source, the left half not, 1268 K1 and
   1260 K2 launches.
10. USDU with ControlNet and ``spatial_cond`` — ``ImageScaleBy`` 2.0
   (lanczos) of the input to 2048², then ``UltimateSDUpscaleDistributed``
   at ``upscale_by`` 1.0 with 1024² tiles and padding 32 (4 crops of
   1088², one chunk: UNet batch 8 at 4624 and 1156 tokens), 7 of 20
   steps (denoise 0.35), CFG 6, the positive carrying the ControlNet
   (hint: the 1024² input, resized per image to 2048² and cropped per
   tile) and a ``spatial_cond`` whose top half is 1: twice bitwise equal,
   exactly 7·104 + 8 = 736 K1 and 728 K2 launches, the bottom half the
   scaled source (within 1e-5), and another image without the
   ControlNet (498 K1, 490 K2).
11. sd15 samplers — on the sdxl path's registry, ``CheckpointLoader
   sd15`` (SD 1.5's UNet at its published widths, random init from seed
   0: 320·[1,2,4,4], 8 heads, one transformer block a level at the first
   three levels, none in the middle, as the JAX preset; the parameter
   counts are printed) → two ``CLIPTextEncode`` → ``TPUTxt2Img`` at 512²,
   karras, CFG 7 → ``SaveImage``, once for each of the 14 sampler names
   at 8 steps: [1,512,512,3], finite, in [0,1], a PNG, and exactly 8 K1
   launches and ``total_calls(name, 8)`` × 30 K3 launches (15 on the
   streamed core, 15 on the short-key kernel a UNet call); the stochastic
   names again at the same seed (bitwise equal) and at another (a
   different image). Then one timed request with dpmpp_2m at 20 steps.
12. sd15 reference — one sd15 UNet forward at a 64² latent (batch 2):
   30 K3 launches, within 5e-2·max|plain| of the plain versions.
13. ControlNet tile upscale — ``workflows/controlnet-tile-upscale.json``
   unchanged on the 1024² input (``ControlNetLoader sd15``, strength 0.8,
   the input as hint; USDU at ``upscale_by`` 2.0 with 768² tiles and
   padding 32: 9 crops of 832², 4 a chunk, 7 euler steps at denoise 0.4,
   CFG 6) twice: [1,2048,2048,3], finite, in [0,1], bitwise equal, exactly
   8 K1 and 21·42 = 882 K3 launches a request; seconds with the encode,
   sampling and decode split, and the peak memory. Then one UNet +
   ControlNet forward at a tile's shape (104² latent, 832² hint, batch 2)
   within 5e-2·max|plain| of the plain versions.
13a. audio — ``clip.wav`` (60 s of seeded stereo at 48 kHz, 16-bit,
   11.5 MB) and ``input.avi`` (24 seeded frames of 960×540 at 24 fps, a
   1 s stereo track at 48 kHz, written by the port's muxer and JPEG
   encoder: seconds a frame printed) are written to the upscale input
   directory; ``workflows/distributed-audio.json`` runs unchanged:
   ``chunk_a``/``chunk_b`` must be the two halves of the clip, bitwise as
   the 16-bit codec writes them, and no kernel launches.
13b. video — ``workflows/video-upscale.json`` with node 4 reading
   ``input.avi`` (whether ``import cv2`` works is printed; where it does,
   the workflow also runs on an ``input.mp4`` of the first 8 frames
   written through OpenCV, 8 K1 and 1440 K3):
   ``realesrgan-x2`` to 1920×1080, USDU at ``upscale_by`` 1.0 with 768²
   tiles and padding 24 (6 crops of 816² a frame, latents 102², 4 a
   chunk: 48 chunks), res_2m on beta for 3 of 12 steps (denoise 0.25),
   CFG 5: frames [24,1080,1920,3], finite, in [0,1], exactly 8 K1 and
   144 · 30 = 4320 K3 launches, the seconds of each stage (decode,
   ESRGAN, USDU, encode) and of JPEG a frame; ``video_up_00000.avi``
   read back by ``load_video`` as 24 frames of 1920×1080 at 24 fps with
   the source's track bitwise as the muxer writes it. Then one tile
   chunk's UNet forward (batch 8 at a 102² latent) through the kernels
   and on the plain versions, within 5e-2·max|plain|.
14. serve — the SDXL workflow served through the HTTP control plane: a
   worker controller started as ``python -m comfyui_distributed_tpu_torch
   serve`` (a subprocess, on the card, with an empty ``CDT_INPUT_DIR`` of
   its own, declared ``remote`` in the master's config) and a master
   ``Controller`` in this process (its own event-loop thread, the sdxl
   path's registry) answer two ``POST /distributed/queue`` requests (seed
   7), each polled on ``/distributed/history`` until final: one worker
   dispatched, success, two 1024² PNGs from the master's ``SaveImage``,
   PNG 0 bitwise equal to the sdxl path's seed-7 image and PNG 1 within
   one level of its seed-8 image (the worker's seed is 7 + index 0 + 1),
   and the master's launch counters rising by exactly one request's.
   Prints seconds per served request beside the direct request's, and
   the frame bytes the worker's image put on the wire. Once the master
   has shut down and the sdxl path's record is dropped, the SDXL bundle
   (and its ControlNet) must be freed without the cycle collector: the
   card's allocated memory falls back to within 1 GiB of what it was
   before the sdxl path.
   After the two txt2img requests the pair serves
   ``workflows/distributed-upscale.json`` once: the master syncs
   ``input.png`` to the worker first (``/distributed/check_file`` and
   ``/upload/image``; the worker's copy must be byte-identical and the
   sync report say 1 uploaded), and holds back
   (``CDT_TILE_MASTER_HOLDBACK_S``) until the worker's first pull: the
   master's PNG must be bitwise equal to the direct upscale, the worker
   must have submitted at least one of the 4 tile tasks over
   ``/distributed/submit_tiles``, and the master's launches must be the
   text encoder's 8 plus 490 K1 and 490 K2 (70 × 7 steps) per chunk it
   ran itself. Prints both processes' peak memory. Then the img2img +
   ControlNet graph of phase 8 is served once (seed 21, with
   ``DistributedSeed`` and ``DistributedCollector``): the sync report
   says 1 skipped, the master's PNG is bitwise equal to the direct
   seed-21 image and the worker's to the direct seed-22 image, and the
   master ran exactly 1880 K1 and 1872 K2 launches. Last the ControlNet
   tile upscale of phase 13 is served once (media sync 1 skipped; master
   holdback until the worker's first pull): the worker must have
   submitted at least one of the 3 tile tasks, every host building the
   hint from its own graph, the master's PNG must be bitwise equal to the
   direct image, and the master's launches must be the text encoder's 8
   K1 plus 294 K3 per chunk it ran itself. Then the audio workflow is
   served (media sync uploads ``clip.wav``; the worker's clip reaches
   the master on its count-0 envelope, whose JSON bytes are printed;
   ``chunk_a`` bitwise the master's clip and ``chunk_b`` the worker's;
   no launch), and again cut after the collector, whose joined AUDIO
   ``/distributed/history`` summarises as [1, 2, 5 760 000] at 48 kHz.
   Last the video upscale is served on its first 8 frames
   (``frame_load_cap``; media sync uploads ``input.avi``; master
   holdback): a batch of 8 is farmed frame by frame (the dynamic mode),
   the worker must have run at least one frame, the master's launches
   must be 8 K1 plus 180 K3 per frame it ran, every frame of the
   master's USDU must be bitwise that frame upscaled alone at seed 7 +
   its index, and the AVI read back holds 8 frames at 24 fps with
   16 000 samples of the track.
15. checkpoint sdxl: write — a synthetic CLIP BPE vocabulary at CLIP's
   size (49 408 entries, ``<|endoftext|>`` 49 407) under
   ``CDT_TOKENIZER_DIR``; a source ``sdxl`` bundle at full width with its
   published CLIP stack (``build_clip_stack``: CLIP-L 123 M, OpenCLIP-G
   695 M parameters), random from seed 11 and rounded through fp16 once;
   ``sdxl.safetensors`` in F16 in the LDM single-file layout
   (``model.diffusion_model.*``, ``first_stage_model.*``,
   ``conditioner.embedders.0.transformer.text_model.*``,
   ``conditioner.embedders.1.model.*``) from the converter's own walks
   inverted. Prints the bytes and seconds. The source bundle's seed-7
   request of ``workflows/distributed-txt2img.json`` is kept.
16. checkpoint sdxl: run from the file — the source released, a fresh
   ``ModelRegistry`` with ``checkpoint_root`` converts the file on its
   first ``get("sdxl")`` (seconds and peak memory printed); every
   converted parameter bitwise equal to the source's; the workflow
   unchanged at seeds 7, 8, 7: the seed-7 image bitwise equal to the
   source bundle's, the repeat equal, seed 8 different, tokenizer mode
   ``bpe``, exactly 2100 K1 and 2100 K2 launches a request (the CLIP stack
   launches none).
17. LoRA — a synthetic kohya SDXL LoRA (rank 8, alpha 8) over every UNet
   attention projection, ``ff`` and ``proj_in``/``proj_out`` and every
   CLIP-L/G attention and MLP Linear (``lora_te1_``/``lora_te2_``), under
   ``CDT_LORA_DIR``; ``CheckpointLoader`` → ``LoraLoader`` → two
   ``CLIPTextEncode`` → ``TPUTxt2Img`` at 1024²: 722 UNet and 264
   text-encoder tensors merged, none unmatched; the image differs from
   the base, its repeat is equal, strength 0/0 gives the base image, the
   base bundle's next image is the base image, 2100/2100 launches a
   request; one merged UNet forward at a 512² latent within
   5e-2·max|plain| of the plain attention versions.
18. checkpoint sd15 — an ``sd15`` source bundle in the published layout
   (seed 11, CLIP-L under ``cond_stage_model.transformer.``, and the
   middle transformer the preset lacks: 1280 channels, 8 heads of 160)
   written in F16, converted by ``python -m comfyui_distributed_tpu_torch
   convert --preset sd15`` in a subprocess on the card (the middle depth
   read from the file), restored through a registry whose
   ``checkpoint_root`` holds the output (manifest ``arch`` with
   ``middle_depth`` 1 checked): parameters bitwise equal to the source's,
   one request (euler, 8 steps, 512²) bitwise equal to the source's, 0 K1
   and 8 × 32 = 256 K3 launches (the middle adds 2 a UNet call at
   [2·8, 64, 160]).
19. checkpoint files — an ``esrgan-x4`` RRDBNet file and an ``sd15``
   ControlNet file (F16) through ``UpscaleModelLoader`` and
   ``ControlNetLoader``: parameters bitwise equal to the source modules',
   one forward of each bitwise equal to theirs.
20. flux path — the FLUX preset at full width (11.9 B parameters, random
   weights from seed 0) runs ``workflows/flux-txt2img.json`` unchanged as
   three requests (seed 1234, 1235, 1234) with the same checks; every
   joint-attention site takes the one-head kernel. Then one direct
   request at 1024² with dpmpp_2m at 8 steps: finite, in [0,1], exactly 4
   K1 and 8 × 57 K3 launches.
21. flux reference — the same DiT at a 512² image (1024 + 77 tokens),
   once through the kernels and once with its attention sites on the
   plain version; the velocities are non-zero and agree within
   5e-2·max|plain|.
22. flux files: write — a synthetic T5 ``tokenizer.json`` at t5-v1_1's
   size (32 100 pieces, a ``Precompiled`` charsmap from the port's
   encoder) under ``CDT_T5_TOKENIZER_DIR`` and the CLIP vocabulary under
   ``CDT_TOKENIZER_DIR``; the direct FLUX bundle as the BFL files hold it
   (rounded through e4m3, the final gate third zero, the identity
   post-quant conv), a T5-XXL (4.76 B parameters, fp32, rounded through
   e4m3) and a CLIP-L drawn on the card; the source's T5 context [1, 512,
   4096] and pooled vector for the workflow's prompt, its velocity at a
   fixed 1024² latent (4096 + 512 = 4608 tokens) and a digest of every
   parameter's bytes recorded; then, from the converter's walks
   inverted, ``flux.safetensors`` and ``t5xxl`` in F8_E4M3 (11.9 and
   4.9 GB), ``clip_l`` (F16, HF ``text_model.*``), ``ae`` (F32, an
   encoder drawn beside the bundle's decoder), and the transformer and
   T5 files cut to 2 double + 4 single blocks and 2 layers (BF16 and
   F8_E4M3); the sources dropped.
23. flux files: convert — ``python -m comfyui_distributed_tpu_torch
   convert --preset flux --checkpoint … --t5 … --clip-l … --vae …`` on
   the cut files in a subprocess on the card (its seconds, peak card
   memory, ``state.pt`` bytes; the manifest's depths checked), the
   ``state.pt`` restored by a fresh ``ModelRegistry`` (every parameter's
   digest the source's, tokenization ``real``) and the workflow run once
   from it (6 × 28 = 168 K3).
24. flux files: run — the full-depth files loaded into a ``flux``
   bundle by the calls ``convert`` makes (seconds, peak memory): every
   parameter's digest the source's, tokenization ``real``, the context,
   the pooled vector and the velocity bitwise the source's;
   ``workflows/flux-txt2img.json`` unchanged at seeds 1234, 1235, 1234:
   images [1,1024,1024,3], finite, in [0,1], the repeat bitwise equal,
   the seeds different, exactly 0 K1 and 57 × 28 = 1596 K3 launches a
   request (at [24, 4608, 128]); one DiT forward at 512² with the T5
   context (1024 + 512 tokens) through the kernels and on the plain
   version within 5e-2·max|plain|.
25. flux serve — the direct FLUX bundle is dropped (the card's
   allocated memory is printed), then ``workflows/flux-txt2img.json`` is
   served: a master ``Controller`` in this process and a fresh worker
   subprocess each build ``flux``, both under one ``CDT_AUTH_TOKEN``, the
   master with ``settings.websocket_orchestration`` and the fault plan
   ``dispatch@1-9:http500`` (only the first dispatch call, the
   WebSocket connect, is left unharmed, so an HTTP fallback would fail).
   A ``POST /distributed/queue`` without the token must answer 401; with
   it, seed 1234, twice (a fresh plan each time), polled on
   ``/distributed/progress/{id}`` every 50 ms: the step count rises
   monotonically to 28 of 28, one
   ``/distributed/preview/{id}`` PNG decodes to 128×128×3, the plan saw
   exactly one dispatch call and injected nothing, the master's PNG is
   bitwise equal to the direct seed-1234 image and the worker's to the
   direct seed-1235 image, and the master ran exactly 1596 K3 and 4 K1
   launches. Then the workflow is queued on the master alone
   (``POST /prompt``) and ``POST /distributed/interrupt`` is sent while
   it samples: history must say ``interrupted`` and no PNG be written.
   Prints the served seconds beside the direct ones, the master's
   prompt, sampling and decode seconds and the worker's prompt seconds
   (from its log), and each process's peak memory.

The launch counters are set to 0 just before each path and read just
after it. The second-to-last stdout line is the kernel table as JSON; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "comfyui_distributed_tpu_torch"
OUTPUT_DIR = ROOT / "output" / "chip_smoke"

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 rate
KERNEL_TOL = 1e-2            # max-abs error / max|plain|, bf16 in and out
REFERENCE_TOL = 5e-2         # whole-model output, kernels vs plain attention
SPIN_CLOCK_HZ = 2.0e9        # above the H100's top SM clock: spins run long
CU_SOURCE = "comfyui_distributed_tpu_torch/ops/csrc/flash_attention.cu"
TPU_SOURCE = "comfyui_distributed_tpu/ops/flash_attention.py"

# The SDXL txt2img path at 1024² with CFG (batch 2): per UNet forward, 10
# transformer blocks at 4096 tokens × 640 channels (10 heads) and 60 at
# 1024 tokens × 1280 channels (20 heads); each block has one self- and
# one cross-attention site (77 context tokens). The text encoder has 4
# self-attention layers (77 tokens × 768, 12 heads) and runs once per
# prompt, twice per request. All heads are 64 wide.
STEPS = 30
FUSED_SHAPES = [  # (B, N, C, H), launches per SDXL request
    ((2, 4096, 640, 10), STEPS * 10),
    ((2, 1024, 1280, 20), STEPS * 60),
    ((1, 77, 768, 12), 2 * 4),
]
PACKED_SHAPES = [  # (B, Nq, Nk, H, D), launches per SDXL request
    ((2, 4096, 77, 10, 64), STEPS * 10),
    ((2, 1024, 77, 20, 64), STEPS * 60),
]
# The FLUX path at 1024², batch 1, no CFG: 77 text tokens + (1024/16)²
# image tokens = 4173 in every joint attention (24 heads of 128; H·D =
# 3072 is past the packed layout's widest row), 19 double + 38 single
# blocks per forward, 28 forwards per request. Its text encoder (one
# prompt) adds 4 fused launches at [1, 77, 768].
FLUX_STEPS = 28
FLUX_TOKENS = 77 + (1024 // 16) ** 2
BH_SHAPES = [  # (B, Nq, Nk, H, D), launches per FLUX request
    ((1, FLUX_TOKENS, FLUX_TOKENS, 24, 128), FLUX_STEPS * (19 + 38)),
]
# The upscale path at the workflow's size: 16 tiles of 1088² (latents
# 136²), 4 a chunk, CFG (batch 8), 7 steps: 28 UNet forwards of 10 blocks
# at 68² = 4624 tokens × 640 channels and 60 at 34² = 1156 × 1280; the
# text encoder as in the sdxl path (8 launches at [1, 77, 768]).
UPSCALE_STEPS = 7
UPSCALE_TILES, UPSCALE_CHUNK = 16, 4
UPSCALE_FORWARDS = UPSCALE_TILES // UPSCALE_CHUNK * UPSCALE_STEPS
TILE_FUSED = [  # (B, N, C, H), launches per upscale request
    ((8, 4624, 640, 10), UPSCALE_FORWARDS * 10),
    ((8, 1156, 1280, 20), UPSCALE_FORWARDS * 60),
]
TILE_PACKED = [  # (B, Nq, Nk, H, D), launches per upscale request
    ((8, 4624, 77, 10, 64), UPSCALE_FORWARDS * 10),
    ((8, 1156, 77, 20, 64), UPSCALE_FORWARDS * 60),
]
TEXT_SHAPE = FUSED_SHAPES[2][0]
# Transformer blocks per UNet forward at level 2 and level 3 (4096 and
# 1024 tokens at 1024²): the UNet's, and with a ControlNet (a copy of
# the encoder and middle: 4 more at level 2, 20 + 10 in the middle).
UNET_BLOCKS = (10, 60)
CONTROL_BLOCKS = (10 + 4, 60 + 30)
I2I_STEPS, I2I_DENOISE = 30, 0.6
I2I_FORWARDS = round(I2I_STEPS * I2I_DENOISE)              # 18
RAGGED_FUSED = [(2, 4000, 640, 10), (1, 130, 256, 2)]
RAGGED_CORE = [(2, 4000, 77, 10, 64), (1, 300, 1000, 2, 128)]
# the core's 128-row q / 128-key tiles: (B, Nq, Nk, H, D), both layouts
EDGE_CORE = [(2, nq, nk, 2, d) for d in (64, 128) for nq in (1, 64, 4173)
             for nk in (1, 77, 128, 129)]
# the short-key kernel (at most 128 keys): its key tiles' edges, q tiles
# of 128 rows stored as two 64-row boxes; (B, Nq, Nk, H, D), both layouts
SHORT_KV_EDGES = [(b, nq, nk, 2, d) for d in (64, 128) for b in (1, 2)
                  for nq in (1, 64, 128, 129, 4173)
                  for nk in (1, 16, 17, 77, 80, 128)]
SHORT_KV_SCHEDULES = [
    (1, 64, 77, 1, 64),       # one work item: fewer than the SMs
    (1, 1000, 77, 37, 64),    # 296 items: 3 a CTA on 132 SMs, the last 2
]
# K1 at the text encoder's 77 rows with C = 192 (H·D = 192: a 128-column
# projection tile half outside the weight)
EDGE_FUSED = [(1, 77, 192, 3), (2, 200, 192, 3)]
KERNEL_NAMES = ("fused_qkv_attention", "flash_attention_packed",
                "flash_attention_bh")
SHORT_KV_MAX_KEYS = 128      # the wrapper's threshold, checked in phase 2
# The sd15 path at 512² with CFG (batch 2): per UNet forward 15
# transformer blocks (6 down, 9 up, none in the middle), 5 at each of
# 4096 tokens × 320 channels, 1024 × 640 and 256 × 1280, 8 heads
# everywhere (head widths 40, 80, 160). Each block has one self- and one
# cross-attention site (77 keys); none is fusable (D % 64 ≠ 0), so all 30
# take the one-head kernel (K3): the streamed core for self-attention, the
# short-key kernel for cross-attention. The sd15 ControlNet copies the
# encoder: 2 blocks a level. The text encoder (768 wide, 12 heads of 64)
# takes K1: 4 layers, two prompts.
SD15_HEADS = 8
SD15_LEVELS = ((4096, 320), (1024, 640), (256, 1280))   # tokens, channels
SD15_UNET_BLOCKS, SD15_CONTROL_BLOCKS = 5, 2            # a level, a forward
SD15_STEPS, SD15_TIMED_STEPS = 8, 20
SD15_HW = 512
# workflows/controlnet-tile-upscale.json on the 1024² input: upscale_by
# 2.0 to 2048², 768² tiles with padding 32: 9 crops of 832² (latents 104²:
# 10816, 2704 and 676 tokens at the three levels), 4 a chunk (3 chunks,
# the last padded), CFG (batch 8), 7 steps of the 18-step ladder at
# denoise 0.4: 21 UNet + ControlNet forwards.
CN_TILE_TILES, CN_TILE_CHUNK, CN_TILE_STEPS = 9, 4, 7
CN_TILE_CHUNKS = -(-CN_TILE_TILES // CN_TILE_CHUNK)
CN_TILE_FORWARDS = CN_TILE_CHUNKS * CN_TILE_STEPS
CN_TILE_LEVELS = ((10816, 320), (2704, 640), (676, 1280))
FLUX_DPMPP_STEPS = 8
# FLUX from its files (phases 22 to 24): T5's 512 context tokens + the
# 4096 image tokens of 1024² in every joint attention, 57 blocks a
# forward, 28 forwards a request; T5 and CLIP-L are plain fp32 (no K1)
FLUX_T5_TOKENS = 512
FLUX_FILE_TOKENS = FLUX_T5_TOKENS + (1024 // 16) ** 2              # 4608
FILE_BH_SHAPES = [  # (B, Nq, Nk, H, D), launches per FLUX request from a file
    ((1, FLUX_FILE_TOKENS, FLUX_FILE_TOKENS, 24, 128), FLUX_STEPS * (19 + 38)),
]
# a published SD 1.5 file's middle transformer (phase 18): 1280 channels,
# 8 heads of 160, at 8² = 64 tokens of 512², self- and cross-attention
SD15_MID_SHAPES = [((2, 64, 64, SD15_HEADS, 160), 1),
                   ((2, 64, 77, SD15_HEADS, 160), 1)]


def sd15_shapes(batch: int, levels, launches_a_level: int) -> list:
    """(B, Nq, Nk, H, D) of K3's self- and cross-attention launches at an
    sd15 UNet's three attention levels, each with ``launches_a_level``."""
    out = []
    for tokens, channels in levels:
        D = channels // SD15_HEADS
        out.append(((batch, tokens, tokens, SD15_HEADS, D), launches_a_level))
        out.append(((batch, tokens, 77, SD15_HEADS, D), launches_a_level))
    return out


# per UNet call of an sd15 txt2img request (CFG batch 2)
SD15_SHAPES = sd15_shapes(2, SD15_LEVELS, SD15_UNET_BLOCKS)
# per workflow request: 21 forwards of the UNet and the ControlNet
CN_TILE_SHAPES = sd15_shapes(8, CN_TILE_LEVELS, CN_TILE_FORWARDS * (
    SD15_UNET_BLOCKS + SD15_CONTROL_BLOCKS))
# workflows/video-upscale.json on a 540p clip (phase 13b): realesrgan-x2
# to 1080p, then USDU at upscale_by 1.0 with 768² tiles and padding 24: 3
# × 2 = 6 crops of 816² a frame (latents 102²: 10404, 2601 and 676 tokens
# at the three levels), 4 a chunk (2 chunks a frame, the second padded),
# CFG (batch 8), res_2m (one UNet call a step) for 3 of the 12 steps
# (denoise 0.25): 24 · 2 · 3 = 144 UNet forwards a request.
VIDEO_FRAMES, VIDEO_FPS = 24, 24.0
VIDEO_IN_HW, VIDEO_OUT_HW = (540, 960), (1080, 1920)
VIDEO_TILE, VIDEO_PADDING = 768, 24
VIDEO_TILES_A_FRAME, VIDEO_CHUNK, VIDEO_STEPS = 6, 4, 3
VIDEO_CHUNKS_A_FRAME = -(-VIDEO_TILES_A_FRAME // VIDEO_CHUNK)
VIDEO_FORWARDS = VIDEO_FRAMES * VIDEO_CHUNKS_A_FRAME * VIDEO_STEPS
VIDEO_LEVELS = ((10404, 320), (2601, 640), (676, 1280))
VIDEO_FORWARD_SHAPES = sd15_shapes(8, VIDEO_LEVELS, SD15_UNET_BLOCKS)
VIDEO_SHAPES = sd15_shapes(8, VIDEO_LEVELS, VIDEO_FORWARDS * SD15_UNET_BLOCKS)
# the shapes the ControlNet tile upscale does not already give K3 (its
# third level is the same 676 tokens at D = 160)
VIDEO_NEW_SHAPES = VIDEO_SHAPES[:4]
# the one-head kernel's tile edges at the new widths: keys 1, 77, 128,
# 129 (at D = 160 the short-key kernel takes at most 80); q rows 1, 64,
# 4173; B 1 and 2
SD15_EDGES = [(b, nq, nk, 2, d) for d in (40, 80, 160) for b in (1, 2)
              for nq in (1, 64, 4173) for nk in (1, 77, 128, 129)]
# the CUDA kernels behind each wrapper at the paths' shapes
HOPPER_KERNELS = {
    "fused_qkv_attention": ["qkv_projection_kernel", "flash_attention_kernel<64>",
                            "short_kv_attention_kernel<64,80> (77 text tokens)"],
    "flash_attention_packed": ["short_kv_attention_kernel<64,80>"],
    "flash_attention_bh": ["flash_attention_kernel<128> (flux)",
                           "flash_attention_kernel<40>, <80>, <160> (sd15 "
                           "self-attention)",
                           "short_kv_attention_kernel<40,80>, <80,80>, "
                           "<160,80> (sd15 cross-attention)"],
}


def short_kv_max_keys(head_dim: int) -> int:
    """The most keys the short-key kernel takes (the wrapper's rule,
    checked in phase 2): 128, or 80 at D = 160."""
    return SHORT_KV_MAX_KEYS if head_dim <= 128 else 80


def cuda_counts(fused: list, cores: list) -> dict:
    """Launches per CUDA kernel for (shape, launches) lists of K1 (B, N,
    C, H) and of K2/K3 (B, Nq, Nk, H, D): K1 is the projection then an
    attention launch over N keys (D = 64); an attention launch over at
    most ``short_kv_max_keys(D)`` keys takes the short-key kernel, over
    more the streamed core."""
    counts = {"qkv_projection": sum(n for _, n in fused),
              "flash_attention_core": 0, "short_kv_attention": 0}
    for nk, d, n in ([(s[1], 64, n) for s, n in fused]
                     + [(s[2], s[4], n) for s, n in cores]):
        kernel = ("short_kv_attention" if nk <= short_kv_max_keys(d)
                  else "flash_attention_core")
        counts[kernel] += n
    return counts


def k3_counts(calls: int, shapes: list, text_prompts: int = 2) -> tuple:
    """(launches per wrapper, per CUDA kernel) of ``calls`` passes over
    K3 ``shapes`` (launches per pass) plus the text encoder's 4 K1
    launches a prompt."""
    cores = [(shape, calls * n) for shape, n in shapes]
    fused = [(TEXT_SHAPE, 4 * text_prompts)]
    return ({"fused_qkv_attention": 4 * text_prompts,
             "flash_attention_packed": 0,
             "flash_attention_bh": sum(n for _, n in cores)},
            cuda_counts(fused, cores))


class PathSpec(NamedTuple):
    """One workflow the script drives: its node ids, its seeds and the
    kernel launches one request must make."""
    name: str
    workflow: str
    steps: int
    seed_node: str
    sampler_node: str
    image_node: str
    png: str
    seeds: tuple
    expected: dict
    expected_cuda: dict


SDXL_PATH = PathSpec(
    "sdxl", "distributed-txt2img.json", STEPS, "4", "5", "6",
    "txt2img_00000.png", (7, 8, 7),
    {"fused_qkv_attention": sum(n for _, n in FUSED_SHAPES),       # 2108
     "flash_attention_packed": sum(n for _, n in PACKED_SHAPES),   # 2100
     "flash_attention_bh": 0},
    # projection 2108, streamed core 2100, short-key 2108
    cuda_counts(FUSED_SHAPES, PACKED_SHAPES))
# per upscale request: K1 8 + 1960, K2 1960
UPSCALE_EXPECTED = {
    "fused_qkv_attention": 8 + sum(n for _, n in TILE_FUSED),
    "flash_attention_packed": sum(n for _, n in TILE_PACKED),
    "flash_attention_bh": 0}
# projection 1968, streamed core 1960, short-key 1968
UPSCALE_EXPECTED_CUDA = cuda_counts(TILE_FUSED + [(TEXT_SHAPE, 8)], TILE_PACKED)


def unet_counts(forwards: int, blocks: tuple, level_shapes) -> tuple:
    """(launches per wrapper, per CUDA kernel, K1 and K2 shapes) of a
    request of ``forwards`` UNet forwards with ``blocks`` transformer
    blocks at the two attention levels, ``level_shapes`` their (B, N, C,
    H), plus the text encoder's 8 K1 launches."""
    fused = [(shape, forwards * n) for shape, n in zip(level_shapes, blocks)]
    packed = [((B, N, 77, H, C // H), n) for (B, N, C, H), n in fused]
    fused.append((TEXT_SHAPE, 8))
    expected = {"fused_qkv_attention": sum(n for _, n in fused),
                "flash_attention_packed": sum(n for _, n in packed),
                "flash_attention_bh": 0}
    return expected, cuda_counts(fused, packed), fused + packed


SDXL_LEVELS = [FUSED_SHAPES[0][0], FUSED_SHAPES[1][0]]
TILE_LEVELS = [TILE_FUSED[0][0], TILE_FUSED[1][0]]
# img2img at 1024²: 1880 K1 / 1872 K2 with the ControlNet, 1268 / 1260 without
I2I_CN = unet_counts(I2I_FORWARDS, CONTROL_BLOCKS, SDXL_LEVELS)
I2I_PLAIN = unet_counts(I2I_FORWARDS, UNET_BLOCKS, SDXL_LEVELS)
# USDU of 4 tiles (one chunk, batch 8), 7 steps: 736 / 728 and 498 / 490
USDU_CN = unet_counts(UPSCALE_STEPS, CONTROL_BLOCKS, TILE_LEVELS)
USDU_PLAIN = unet_counts(UPSCALE_STEPS, UNET_BLOCKS, TILE_LEVELS)
FLUX_PATH = PathSpec(
    "flux", "flux-txt2img.json", FLUX_STEPS, "3", "4", "5",
    "flux_00000.png", (1234, 1235, 1234),
    {"fused_qkv_attention": 4, "flash_attention_packed": 0,
     "flash_attention_bh": sum(n for _, n in BH_SHAPES)},          # 1596
    # projection 4, streamed core 1596, short-key 4
    cuda_counts([(FUSED_SHAPES[2][0], 4)], BH_SHAPES))


class SmokeFailure(RuntimeError):
    pass


def say(*parts) -> None:
    print(*parts, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --- phase 1 -----------------------------------------------------------------


def device_phase(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"device: {name} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    first = smi.stdout.strip().splitlines()[0]
    say(first)
    return {"platform": "gpu", "kind": name, "count": count, "smi": first}


# --- phase 2 -----------------------------------------------------------------


def ptxas_registers(log: str) -> dict[str, int]:
    """Registers per compiled entry function (mangled name) in ptxas's
    ``-v`` report."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    return regs


def build_phase(fa) -> None:
    t0 = time.perf_counter()
    fa.KERNELS.load()
    say(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {fa.KERNELS.build_seconds:.2f} s)")
    # an existing build was loaded: its report lies beside it
    log = (fa.KERNELS.build_log
           or fa.KERNELS.path().with_suffix(".log").read_text())
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "smem", "warning")):
            say("  " + line.strip())
    spills = [line.strip() for line in log.splitlines()
              if "spill" in line and not line.strip().startswith(
                  "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]
    require(not spills, f"ptxas reports spills: {spills}")
    require(fa.SHORT_KV_MAX_KEYS == SHORT_KV_MAX_KEYS
            and all(fa.short_kv_max_keys(d) == short_kv_max_keys(d)
                    for d in fa.HEAD_DIMS),
            f"the wrapper's short-key thresholds are "
            f"{[fa.short_kv_max_keys(d) for d in fa.HEAD_DIMS]}")
    regs = ptxas_registers(log)
    # a short-key kernel for every (D, key tile) the wrapper can select, a
    # streamed core for every D
    tiles = {d: [kw for kw in fa.SHORT_KV_TILES
                 if kw <= fa.short_kv_tile(fa.short_kv_max_keys(d), d)]
             for d in fa.HEAD_DIMS}
    short = {e: n for e, n in regs.items() if "short_kv_attention_kernel" in e}
    want = sum(len(t) for t in tiles.values())
    require(len(short) == want,
            f"ptxas compiled {len(short)} short-key kernels, expected {want} "
            f"({tiles})")
    cores = [e for e in regs if "flash_attention_kernel" in e]
    require(len(cores) == len(fa.HEAD_DIMS),
            f"ptxas compiled {len(cores)} streamed cores, expected one for "
            f"each D in {fa.HEAD_DIMS}")
    # setmaxnreg moves registers within the block's allocation: 24 for the
    # producer and 232 for each consumer thread need 168 at entry
    handing = {e: n for e, n in regs.items() if "attention_kernel" in e}
    require(all(n == 168 for n in handing.values()),
            f"attention kernels not at 168 registers at entry: {handing}")
    for d, kws in tiles.items():
        for kw in kws:
            smem, stages = fa.KERNELS.short_kv_layout(d, kw)
            require(smem > 0, f"no short-key layout at D={d}, {kw} keys")
            say(f"  short_kv_attention_kernel<{d},{kw}>: {smem} B dynamic "
                f"shared memory, {stages} Q stages")


# --- phase 3 -----------------------------------------------------------------


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    calls after ``warmup`` calls.

    A short kernel (the 77-token cross-attention takes well under 0.1 ms)
    runs faster than Python enqueues it, so events around back-to-back
    calls would time the host. The card is therefore first held in a spin
    at least twice as long as the host takes to enqueue every call: all
    calls are queued before the first one runs, and the events time the
    card alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_s = max(1e-3, 2.0 * enqueue_s * iters)
    torch.cuda._sleep(int(spin_s * SPIN_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_us(torch, fn, iters: int = 50) -> float:
    """Mean host microseconds to enqueue one call: the calls are made
    while the card is held in a spin, so none waits on the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    one_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(max(1e-3, 4.0 * one_s * iters) * SPIN_CLOCK_HZ))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / iters * 1e6


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of operations over
    the bf16 tensor-core peak and bytes over the memory rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fused_work(B, N, C, H, D=64) -> tuple[float, float]:
    flops = 3 * 2 * B * N * C * H * D + 4 * B * H * N * N * D
    nbytes = 2 * (B * N * C + 3 * H * D * C + B * N * H * D)
    return flops, nbytes


def core_work(B, Nq, Nk, H, D) -> tuple[float, float]:
    flops = 4 * B * H * Nq * Nk * D
    nbytes = 2 * (2 * B * Nq * H * D + 2 * B * Nk * H * D)
    return flops, nbytes


def compare(torch, name: str, out, ref) -> float:
    torch.cuda.synchronize()
    require(tuple(out.shape) == tuple(ref.shape),
            f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = err <= KERNEL_TOL * scale
    say(f"  {name}: max_abs_err {err:.6g} (max|plain| {scale:.6g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


def kernel_phase(torch, fa) -> tuple[list[dict], dict]:
    from unittest import mock

    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf16)

    def fused_inputs(B, N, C, H, D=64):
        x = randn(B, N, C)
        ws = [randn(H * D, C, scale=C ** -0.5) for _ in range(3)]
        return x, ws

    def core_inputs(B, Nq, Nk, H, D):
        return randn(B, Nq, H, D), randn(B, Nk, H, D), randn(B, Nk, H, D)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ).transpose(1, 2)

    say("kernels: correctness (bf16; tolerance max_abs_err <= "
        f"{KERNEL_TOL}*max|plain|)")
    errs = {k: 0.0 for k in KERNEL_NAMES}
    for shape in ([s for s, _ in FUSED_SHAPES + TILE_FUSED] + RAGGED_FUSED
                  + EDGE_FUSED):
        B, N, C, H = shape
        x, (wq, wk, wv) = fused_inputs(*shape)
        compare(torch, f"qkv_projection {shape}",
                fa.qkv_projection(x, wq, wk, wv),
                fa.qkv_projection_plain(x, wq, wk, wv))
        # a call on other inputs first, as for the attention cores below
        fa.fused_qkv_attention(fused_inputs(*shape)[0], wq, wk, wv, H)
        err = compare(torch, f"fused_qkv_attention {shape}",
                      fa.fused_qkv_attention(x, wq, wk, wv, H),
                      fa.fused_qkv_attention_plain(x, wq, wk, wv, H))
        errs["fused_qkv_attention"] = max(errs["fused_qkv_attention"], err)
        del x
    core_cases = ([s for s, _ in PACKED_SHAPES + TILE_PACKED + BH_SHAPES
                   + FILE_BH_SHAPES]
                  + RAGGED_CORE + EDGE_CORE + SHORT_KV_EDGES
                  + SHORT_KV_SCHEDULES)
    for shape in core_cases:
        q, k, v = core_inputs(*shape)
        ref = fa.flash_attention_plain(q, k, v)
        for layout in ("packed", "bh"):
            key = f"flash_attention_{layout}"
            # a call on other inputs first: the compared call's output
            # likely reuses a block it freed, so a skipped tile holds
            # numbers of another attention
            fa.flash_attention(*core_inputs(*shape), layout=layout)
            err = compare(torch, f"{key} {shape}",
                          fa.flash_attention(q, k, v, layout=layout), ref)
            errs[key] = max(errs[key], err)
        del ref
    # the one-head kernel at SD 1.5's head widths (the packed layout takes
    # D 64 and 128 only): the paths' shapes, then the tile edges
    for shape in ([s for s, _ in SD15_SHAPES + SD15_MID_SHAPES
                   + CN_TILE_SHAPES + VIDEO_NEW_SHAPES] + SD15_EDGES):
        q, k, v = core_inputs(*shape)
        ref = plain_by_row(fa, q, k, v)
        fa.flash_attention(*core_inputs(*shape), layout="bh")
        err = compare(torch, f"flash_attention_bh {shape}",
                      fa.flash_attention(q, k, v, layout="bh"), ref)
        errs["flash_attention_bh"] = max(errs["flash_attention_bh"], err)
        del q, k, v, ref

    say("kernels: timing (CUDA events; ms per launch)")
    rows = []

    def time_row(kernel, shape, launches, work, run, plain, library,
                 path, **extra):
        ms = cuda_ms(torch, run)
        plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        lib_ms = cuda_ms(torch, library)
        host_us = enqueue_us(torch, run)
        b, by = bound_ms(*work)
        say(f"  {kernel} {shape}: {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"library {lib_ms:.4f}, bound {b:.4f} by {by}; "
            f"{b / ms:.1%} of bound; {ms / lib_ms:.2f}x library); host "
            f"{host_us:.1f} us to enqueue; {launches} launches per {path} "
            "request")
        rows.append({"kernel": kernel, "shape": shape, "path": path,
                     "launches": launches,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b, "bound_by": by, "enqueue_us": host_us,
                     "flops": work[0], "bytes": work[1], **extra})

    for path, shape, n in ([("sdxl", sh, n) for sh, n in FUSED_SHAPES]
                           + [("upscale", sh, n) for sh, n in TILE_FUSED]):
        B, N, C, H = shape
        x, (wq, wk, wv) = fused_inputs(*shape)

        def library(x=x, wq=wq, wk=wk, wv=wv, B=B, N=N, H=H):
            q, k, v = (torch.matmul(x, w.t()).view(B, N, H, 64)
                       for w in (wq, wk, wv))
            return sdpa(q, k, v)

        # K1's two launches on their own
        q, k, v = fa.qkv_projection(x, wq, wk, wv).view(3, B, N, H, 64)
        proj_ms = cuda_ms(torch, lambda: fa.qkv_projection(x, wq, wk, wv))
        core_ms = cuda_ms(
            torch, lambda: fa.flash_attention(q, k, v, layout="packed"))
        proj_us = enqueue_us(torch, lambda: fa.qkv_projection(x, wq, wk, wv))
        core_us = enqueue_us(
            torch, lambda: fa.flash_attention(q, k, v, layout="packed"))
        pb, pby = bound_ms(2 * 3 * B * N * C * H * 64,
                           2 * (B * N * C + 3 * H * 64 * C + 3 * B * N * H * 64))
        cb, cby = bound_ms(*core_work(B, N, N, H, 64))
        say(f"  fused_qkv_attention {shape} split: projection {proj_ms:.4f} "
            f"ms (bound {pb:.4f} by {pby}; {pb / proj_ms:.1%}; host "
            f"{proj_us:.1f} us), core {core_ms:.4f} ms (bound {cb:.4f} by "
            f"{cby}; {cb / core_ms:.1%}; host {core_us:.1f} us)")
        time_row("fused_qkv_attention", shape, n, fused_work(*shape),
                 lambda: fa.fused_qkv_attention(x, wq, wk, wv, H),
                 lambda: fa.fused_qkv_attention_plain(x, wq, wk, wv, H),
                 library, path, projection_ms=proj_ms, core_ms=core_ms)
        del x, q, k, v
    for layout, path, shapes in (("packed", "sdxl", PACKED_SHAPES),
                                 ("packed", "upscale", TILE_PACKED),
                                 ("bh", "flux", BH_SHAPES),
                                 ("bh", "flux_file", FILE_BH_SHAPES)):
        for shape, n in shapes:
            q, k, v = core_inputs(*shape)
            extra = {}
            if shape[2] <= fa.SHORT_KV_MAX_KEYS:
                # the streamed core (the kernel past 128 keys) at this shape
                with mock.patch.object(fa, "SHORT_KV_MAX_KEYS", 0):
                    extra["streamed_core_ms"] = cuda_ms(
                        torch, lambda: fa.flash_attention(q, k, v, layout=layout))
                say(f"  {layout} {shape} on the streamed core: "
                    f"{extra['streamed_core_ms']:.4f} ms")
            time_row(f"flash_attention_{layout}", shape, n, core_work(*shape),
                     lambda: fa.flash_attention(q, k, v, layout=layout),
                     lambda: fa.flash_attention_plain(q, k, v),
                     lambda: sdpa(q, k, v), path, **extra)
    # K3 at SD 1.5's widths; the bound counts the true D (the padding to
    # whole 64-column boxes is the kernel's waste, not the function's work)
    for path, shapes in (("sd15", SD15_SHAPES), ("sd15_file", SD15_MID_SHAPES),
                         ("cn_upscale", CN_TILE_SHAPES),
                         ("video", VIDEO_NEW_SHAPES)):
        for shape, n in shapes:
            q, k, v = core_inputs(*shape)
            time_row("flash_attention_bh", shape, n, core_work(*shape),
                     lambda: fa.flash_attention(q, k, v, layout="bh"),
                     lambda: plain_by_row(fa, q, k, v),
                     lambda: sdpa(q, k, v), path)
            del q, k, v
    return rows, errs


def plain_by_row(fa, q, k, v):
    """The plain attention one batch row at a time: the same function,
    with the fp32 score matrix of one row resident at a time (8 heads of
    10816² keys are 3.7 GB a row)."""
    import torch

    return torch.cat([fa.flash_attention_plain(q[i:i + 1], k[i:i + 1],
                                               v[i:i + 1])
                      for i in range(q.shape[0])])


def kernel_table(rows: list[dict], errs: dict,
                 path_launches: dict[str, dict]) -> list[dict]:
    """One entry per kernel: launch-weighted sums over one request's
    shapes on the path that carries the kernel (ms per request; K1 per
    SDXL request), and its launches summed over every path's run."""
    replaces = {"fused_qkv_attention": f"{TPU_SOURCE}:227",
                "flash_attention_packed": f"{TPU_SOURCE}:197",
                "flash_attention_bh": f"{TPU_SOURCE}:99"}
    out = []

    def per_request(mine):
        tot = {key: sum(r[key] * r["launches"] for r in mine)
               for key in ("ms", "plain_ms", "library_ms", "flops", "bytes")}
        b, by = bound_ms(tot["flops"], tot["bytes"])
        return {"ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": b,
                "bound_by": by, "library_ms": tot["library_ms"],
                "launches": sum(r["launches"] for r in mine)}

    def at(name, shape_launches) -> dict:
        """Per request of a path whose launches of ``name`` at each shape
        are ``shape_launches``, from the timed rows at those shapes."""
        mine = [{**r, "launches": n} for shape, n in shape_launches
                for r in rows if r["kernel"] == name and r["shape"] == shape]
        return per_request(mine) if mine else None

    sd15_request = [(shape, SD15_TIMED_STEPS * n) for shape, n in SD15_SHAPES]
    sd15_file_request = [(shape, SD15_STEPS * n)
                         for shape, n in SD15_SHAPES + SD15_MID_SHAPES]
    others = ("upscale", "sd15", "sd15_file", "cn_upscale", "video",
              "flux_file")
    for name in KERNEL_NAMES:
        every = [r for r in rows if r["kernel"] == name]
        mine = [r for r in every if r["path"] not in others]
        tot = {key: sum(r[key] * r["launches"] for r in mine)
               for key in ("ms", "plain_ms", "library_ms", "flops", "bytes")}
        b, by = bound_ms(tot["flops"], tot["bytes"])
        n = sum(r["launches"] for r in mine)
        # one upscale request: its tile rows and the text encoder's
        upscale = [r for r in every if r["path"] == "upscale"]
        split_upscale = ({"per_upscale_request": per_request(
            upscale + [r for r in every if r["shape"] == TEXT_SHAPE])}
            if upscale else {})
        split = {}
        if name == "fused_qkv_attention":
            split = {"split_ms": {
                part: sum(r[f"{part}_ms"] * r["launches"] for r in mine)
                for part in ("projection", "core")}}
        if all("streamed_core_ms" in r for r in mine):
            split = {"streamed_core_ms": sum(
                r["streamed_core_ms"] * r["launches"] for r in mine)}
        out.append({
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": replaces[name],
            "launches": sum(c[name] for c in path_launches.values()),
            "max_abs_err": errs[name], "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": tot["library_ms"],
            "per": ("one flux request" if name == "flash_attention_bh"
                    else "one sdxl request"),
            "hopper_kernels": HOPPER_KERNELS[name],
            "enqueue_us": sum(r["enqueue_us"] * r["launches"] for r in mine) / n,
            "launches_by_path": {p: c[name] for p, c in path_launches.items()},
            **split, **split_upscale,
            **{key: value for key, value in (
                ("per_img2img_controlnet_request", at(name, I2I_CN[2])),
                ("per_usdu_controlnet_request", at(name, USDU_CN[2])),
                ("per_sd15_request", at(name, sd15_request)),
                ("per_sd15_file_request", at(name, sd15_file_request)),
                ("per_cn_upscale_request", at(name, CN_TILE_SHAPES)),
                ("per_video_request", at(name, VIDEO_SHAPES)),
                ("per_flux_file_request", at(name, FILE_BH_SHAPES)))
               if value is not None},
            **({"k3_rows": [
                {key: r[key] for key in ("path", "shape", "launches", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
                for r in every if r["path"] in others]}
               if name == "flash_attention_bh" else {}),
        })
    return out


# --- phase 4 -----------------------------------------------------------------


def png_size(path: Path) -> tuple[int, int]:
    data = path.read_bytes()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    return (int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big"))


class PathRun(NamedTuple):
    """What a path phase leaves for the phases after it."""
    registry: object
    bundle: object
    launches: dict          # per wrapper, over the path's run
    timings: dict           # the pipeline's, of the last request
    images: dict            # seed → image of its first request
    seconds: list           # per request, in order


def path_phase(torch, fa, spec: PathSpec) -> PathRun:
    """Build the workflow's preset at full width on the card and run the
    workflow as three requests."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / spec.workflow).read_text()))
    sampler = workflow[spec.sampler_node]["inputs"]
    require(sampler["steps"] == spec.steps,
            f"{spec.workflow}: the step count changed; update the script")
    hw = (int(sampler["height"]), int(sampler["width"]))
    registry = ModelRegistry("cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = registry.get(workflow["1"]["inputs"]["ckpt_name"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in bundle.core.parameters())
    say(f"{spec.name} path: {bundle.preset.name} bundle built in "
        f"{time.perf_counter() - t0:.2f} s ({type(bundle.core).__name__} "
        f"{n_params / 1e9:.3f} B params, {n_params} exactly)")
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(OUTPUT_DIR)})
    png = OUTPUT_DIR / spec.png
    images, counts, kernel_counts, seconds = [], [], [], []
    fa.reset_launches()
    for seed in spec.seeds:
        prompt = json.loads(json.dumps(workflow))
        prompt[spec.seed_node]["inputs"]["seed"] = seed
        png.unlink(missing_ok=True)
        before = dict(fa.LAUNCHES)
        cuda_before = dict(fa.CUDA_LAUNCHES)
        t0 = time.perf_counter()
        out = executor.execute(prompt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seconds.append(secs)
        counts.append({k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES})
        kernel_counts.append({k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                            for k in fa.CUDA_LAUNCHES})
        img = out[spec.image_node][0]
        timings = dict(bundle.pipeline.timings)
        say(f"  request seed {seed}: {secs:.3f} s; sampling "
            f"{timings['sample_s']:.3f} s = "
            f"{timings['sample_s'] / timings['steps']:.4f} s/step over "
            f"{timings['steps']} steps; decode {timings['decode_s']:.3f} s; "
            f"launches {counts[-1]}; CUDA kernels {kernel_counts[-1]}")
        require(tuple(img.shape) == (1, *hw, 3),
                f"image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), "non-finite image")
        require(img.min().item() >= 0.0 and img.max().item() <= 1.0,
                "image outside [0, 1]")
        require(png.is_file() and png_size(png) == hw[::-1],
                f"{png} missing or not {hw[1]}x{hw[0]}")
        images.append(img)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    say(f"  max_memory_allocated {peak / 2**30:.3f} GiB")
    for i, (c, cc) in enumerate(zip(counts, kernel_counts)):
        require(c == spec.expected,
                f"{spec.name} request {i}: launches {c} != expected "
                f"{spec.expected}")
        require(cc == spec.expected_cuda,
                f"{spec.name} request {i}: CUDA kernel launches {cc} != "
                f"expected {spec.expected_cuda}")
    a, b, _ = spec.seeds
    require(torch.equal(images[0], images[2]),
            f"seed {a} twice gave different images")
    require(not torch.equal(images[0], images[1]),
            f"seeds {a} and {b} gave the same image")
    say(f"  launch counts as expected; seed {a} repeatable; seed {b} differs")
    return PathRun(registry, bundle, launches, timings,
                   {a: images[0], b: images[1]}, seconds)


# --- phases 6 and 7 ----------------------------------------------------------

UPSCALE_DIR = OUTPUT_DIR / "upscale"
UPSCALE_WORKFLOW = "distributed-upscale.json"
UPSCALE_INPUT_HW = 1024
UPSCALE_OUT_HW = 4096
UPSCALE_PNG = "upscaled_00000.png"


def write_upscale_input(torch) -> Path:
    """The workflow's ``input.png``: a seeded 1024² RGB image, by the
    port's own PNG writer; and the host seconds of ``decode_png`` on the
    same image under the Average and Paeth filters (decoded byte by byte
    in Python)."""
    from comfyui_distributed_tpu_torch.utils.image import decode_png, encode_png

    input_dir = UPSCALE_DIR / "input"
    input_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(3)
    img = torch.rand(UPSCALE_INPUT_HW, UPSCALE_INPUT_HW, 3, generator=gen)
    (input_dir / "input.png").write_bytes(encode_png(img.numpy()))
    for kind, name in ((3, "Average"), (4, "Paeth")):
        data = encode_png(img.numpy(), filter_type=kind)
        t0 = time.perf_counter()
        decoded = decode_png(data)
        secs = time.perf_counter() - t0
        require(decoded.shape == (UPSCALE_INPUT_HW, UPSCALE_INPUT_HW, 3),
                f"decode_png under {name}: shape {decoded.shape}")
        say(f"  decode_png of a 1024² RGB PNG under the {name} filter: "
            f"{secs:.3f} s on the host")
    return input_dir


def upscale_workflow() -> dict:
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / UPSCALE_WORKFLOW).read_text()))
    usdu = workflow["5"]["inputs"]
    require((usdu["steps"], usdu["denoise"], usdu["upscale_by"],
             usdu["tile_width"], usdu["tile_padding"], usdu["cfg"])
            == (20, 0.35, 1.0, 1024, 32, 6.0)
            and workflow["8"]["inputs"]["model_name"] == "esrgan-x4",
            f"{UPSCALE_WORKFLOW} changed; update the script")
    return workflow


class UpscaleRun(NamedTuple):
    launches: dict
    image: object           # the first request's [1,4096,4096,3] on the card
    image_u8: object        # the same as uint8 numpy
    input_dir: Path
    seconds: list


def upscale_phase(torch, fa, sdxl: PathRun) -> UpscaleRun:
    """The upscale workflow, twice, on the sdxl path's registry."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    say("upscale path:")
    input_dir = write_upscale_input(torch)
    workflow = upscale_workflow()
    out_dir = UPSCALE_DIR / "out"
    png = out_dir / UPSCALE_PNG
    executor = GraphExecutor({"model_registry": sdxl.registry,
                              "input_dir": str(input_dir),
                              "output_dir": str(out_dir)})
    pipeline = sdxl.bundle.pipeline
    torch.cuda.reset_peak_memory_stats()
    images, seconds = [], []
    fa.reset_launches()
    for i in range(2):
        png.unlink(missing_ok=True)
        before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
        t0 = time.perf_counter()
        out = executor.execute(workflow)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        seconds.append(secs)
        counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                         for k in fa.CUDA_LAUNCHES}
        esrgan = sdxl.registry.get_upscaler("esrgan-x4").timings
        chunks = pipeline.timings["tile_chunks"]
        say(f"  request {i}: {secs:.3f} s; esrgan-x4 {esrgan['seconds']:.3f} s "
            f"({esrgan['tiles']} tiles of 544², {esrgan['tile_batch']} a call); "
            f"composite {pipeline.timings['composite_s']:.3f} s; "
            f"launches {counts}; CUDA kernels {kernel_counts}")
        for j, c in enumerate(chunks):
            say(f"    chunk {j}: {c['tiles']} tiles; encode {c['encode_s']:.3f} s, "
                f"sampling {c['sample_s']:.3f} s ({c['sample_s'] / UPSCALE_STEPS:.4f}"
                f" s/step), decode {c['decode_s']:.3f} s")
        img = out["5"][0]
        hw = (UPSCALE_OUT_HW, UPSCALE_OUT_HW)
        require(len(chunks) == UPSCALE_TILES // UPSCALE_CHUNK
                and all(c["tiles"] == UPSCALE_CHUNK for c in chunks),
                f"upscale request {i}: chunks {[c['tiles'] for c in chunks]}")
        require(tuple(img.shape) == (1, *hw, 3), f"image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), "non-finite image")
        require(img.min().item() >= 0.0 and img.max().item() <= 1.0,
                "image outside [0, 1]")
        require(png.is_file() and png_size(png) == hw,
                f"{png} missing or not {hw[1]}x{hw[0]}")
        require(counts == UPSCALE_EXPECTED,
                f"upscale request {i}: launches {counts} != {UPSCALE_EXPECTED}")
        require(kernel_counts == UPSCALE_EXPECTED_CUDA,
                f"upscale request {i}: CUDA kernel launches {kernel_counts} != "
                f"{UPSCALE_EXPECTED_CUDA}")
        images.append(img)
    peak = torch.cuda.max_memory_allocated()
    esrgan = sdxl.registry.get_upscaler("esrgan-x4").model
    say(f"  esrgan-x4: {sum(p.numel() for p in esrgan.parameters())} "
        "parameters (RRDBNet, 23 blocks, 64 features)")
    require(torch.equal(images[0], images[1]),
            "the upscale workflow twice gave different images")
    say(f"  launch counts as expected; repeat bitwise equal; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    return UpscaleRun(dict(fa.LAUNCHES), images[0], to_uint8(images[0])[0],
                      input_dir, seconds)


def upscale_reference_phase(torch, fa, sdxl: PathRun, up: UpscaleRun) -> None:
    """One 4-tile chunk of the upscale with the kernels, each of its 7
    UNet forwards (batch 8: 4 tiles × CFG) also run on the same inputs
    with the attention sites on the plain versions: every forward's eps
    within 5e-2·max|plain|. Then the whole chunk once more on the plain
    versions, on the same noise: its difference from the kernels' chunk
    after 7 steps, CFG 6 and the VAE is printed, not held to a bound
    (random weights amplify round-off along the trajectory)."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.graph.nodes_builtin import _adm_from_cond
    from comfyui_distributed_tpu_torch.models import layers
    from comfyui_distributed_tpu_torch.tiles.engine import TileUpscaler, UpscaleSpec

    def plain_attention():
        return (mock.patch.object(layers, "self_attention",
                                  fa.fused_qkv_attention_plain),
                mock.patch.object(layers, "full_attention",
                                  fa.flash_attention_plain))

    workflow = upscale_workflow()
    bundle = sdxl.bundle
    pipeline = bundle.pipeline
    adm = pipeline.unet.config.adm_in_channels
    conds = []
    for node in ("2", "3"):
        ctx, pooled = bundle.text_encoder.encode([workflow[node]["inputs"]["text"]])
        conds.append((ctx, _adm_from_cond({"pooled": pooled}, adm, pipeline.device)))
    (ctx, y), (unc, uy) = conds
    spec = UpscaleSpec(scale=1.0, tile_w=1024, tile_h=1024, padding=32,
                       steps=20, denoise=0.35, guidance_scale=6.0)
    ups = TileUpscaler(pipeline)
    plan = ups.range_plan(up.image[0], spec, 42, ctx, unc, y, uy)
    require(plan.chunk == UPSCALE_CHUNK and plan.num_tiles == UPSCALE_TILES,
            f"upscale reference: chunk {plan.chunk}, {plan.num_tiles} tiles")
    unet = pipeline.unet
    forward = unet.forward
    errs = []

    def checked(*args, **kwargs):
        out = forward(*args, **kwargs)
        sa, fu = plain_attention()
        with sa, fu:
            ref = forward(*args, **kwargs)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(out).all()), "upscale reference: non-finite eps")
        errs.append(((out.float() - ref.float()).abs().max().item(),
                     ref.float().abs().max().item(), tuple(out.shape)))
        return out

    before = dict(fa.LAUNCHES)
    with mock.patch.object(unet, "forward", checked):
        tiles = plan.run_range(0, UPSCALE_CHUNK)
    sites = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    require(sites["fused_qkv_attention"] == 70 * UPSCALE_STEPS
            and sites["flash_attention_packed"] == 70 * UPSCALE_STEPS
            and len(errs) == UPSCALE_STEPS,
            f"upscale reference: launches {sites}, {len(errs)} forwards")
    worst = max(e / m for e, m, _ in errs)
    say("upscale reference: the chunk's UNet forwards (eps "
        f"{errs[0][2]}) with kernels vs plain attention on the same inputs: "
        "max_abs_err / max|plain| per step "
        f"{[round(e / m, 5) for e, m, _ in errs]} (tolerance {REFERENCE_TOL})")
    require(worst <= REFERENCE_TOL,
            "upscale reference: a UNet forward of the chunk disagrees")
    # the round-off floor: the same plain chain in chunks of 2 tiles, whose
    # products cuBLAS and cuDNN compute in another order
    halves = ups.range_plan(up.image[0], spec, 42, ctx, unc, y, uy,
                            tiles_per_device=2)
    sa, fu = plain_attention()
    with sa, fu:
        ref = plan.run_range(0, UPSCALE_CHUNK)
        floor = halves.run_range(0, UPSCALE_CHUNK)
    for what, a, b in (("kernels vs plain", tiles, ref),
                       ("plain in chunks of 4 vs of 2 (round-off floor)",
                        ref, floor)):
        diff = abs(a - b)
        say(f"  the whole chunk, {what}, each on its own trajectory from the "
            f"same noise: decoded tiles differ by max {diff.max():.6g}, mean "
            f"{diff.mean():.6g}; {(diff > 1 / 255).mean():.4%} of values by "
            "more than one 8-bit level (not bounded)")


# --- phases 8 to 10 ----------------------------------------------------------

CONTROL_DIR = OUTPUT_DIR / "control"
CONTROL_PRESET = "sdxl"          # the checkpoint and the ControlNet
I2I_SEEDS = (21, 22, 21)
CN_STRENGTH = 0.8
USDU_SEED = 42
USDU_OUT_HW = 2 * UPSCALE_INPUT_HW
USDU_TILE, USDU_PADDING = 1024, 32


def i2i_workflow(control: bool = True, inpaint: bool = False) -> dict:
    """The img2img graph on the upscale path's ``input.png``: a ControlNet
    fed the input itself as hint, seed through ``DistributedSeed`` and the
    image through ``DistributedCollector`` (both the identity when run
    directly), so that the same graph is served in phase 14. With
    ``inpaint``: ``TPUInpaint`` with ``mask.png``."""
    prompt = {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": CONTROL_PRESET}},
        "2": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "a harbour at dawn, watercolor", "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "blurry, low quality", "clip": ["1", 1]}},
        "4": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
        "5": {"class_type": "DistributedSeed", "inputs": {"seed": I2I_SEEDS[0]}},
        "6": {"class_type": "TPUImg2Img", "inputs": {
            "model": ["1", 0], "image": ["4", 0], "positive": ["2", 0],
            "negative": ["3", 0], "seed": ["5", 0], "steps": I2I_STEPS,
            "cfg": 5.0, "denoise": I2I_DENOISE, "sampler_name": "euler",
            "scheduler": "karras"}},
        "7": {"class_type": "DistributedCollector", "inputs": {"images": ["6", 0]}},
        "8": {"class_type": "SaveImage", "inputs": {
            "images": ["7", 0], "filename_prefix": "img2img"}},
    }
    if control:
        prompt["9"] = {"class_type": "ControlNetLoader",
                       "inputs": {"control_net_name": CONTROL_PRESET}}
        prompt["10"] = {"class_type": "ControlNetApply", "inputs": {
            "conditioning": ["2", 0], "control_net": ["9", 0],
            "image": ["4", 0], "strength": CN_STRENGTH}}
        prompt["6"]["inputs"]["positive"] = ["10", 0]
    if inpaint:
        prompt["11"] = {"class_type": "LoadImage", "inputs": {"image": "mask.png"}}
        prompt["6"]["class_type"] = "TPUInpaint"
        prompt["6"]["inputs"]["mask"] = ["11", 0]
        prompt["8"]["inputs"]["filename_prefix"] = "inpaint"
    return prompt


def usdu_workflow(spatial, control: bool = True) -> dict:
    """``ImageScaleBy`` 2.0 of the input, then USDU at ``upscale_by`` 1.0 in
    four 1024² tiles with ``spatial_cond`` and a ControlNet whose hint is
    the 1024² input (resized to 2048² by the engine)."""
    prompt = {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": CONTROL_PRESET}},
        "2": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "a harbour at dawn, watercolor, detailed", "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "blurry, low quality", "clip": ["1", 1]}},
        "4": {"class_type": "LoadImage", "inputs": {"image": "input.png"}},
        "5": {"class_type": "ImageScaleBy", "inputs": {
            "image": ["4", 0], "scale_by": 2.0, "upscale_method": "lanczos"}},
        "6": {"class_type": "UltimateSDUpscaleDistributed", "inputs": {
            "image": ["5", 0], "model": ["1", 0], "positive": ["2", 0],
            "negative": ["3", 0], "seed": USDU_SEED, "steps": 20,
            "denoise": 0.35, "upscale_by": 1.0, "tile_width": USDU_TILE,
            "tile_height": USDU_TILE, "tile_padding": USDU_PADDING, "cfg": 6.0,
            "sampler_name": "euler", "scheduler": "karras",
            "spatial_cond": spatial}},
        "7": {"class_type": "SaveImage", "inputs": {
            "images": ["6", 0], "filename_prefix": "usdu_controlnet"}},
    }
    if control:
        prompt["8"] = {"class_type": "ControlNetLoader",
                       "inputs": {"control_net_name": CONTROL_PRESET}}
        prompt["9"] = {"class_type": "ControlNetApply", "inputs": {
            "conditioning": ["2", 0], "control_net": ["8", 0],
            "image": ["4", 0], "strength": CN_STRENGTH}}
        prompt["6"]["inputs"]["positive"] = ["9", 0]
    return prompt


def run_counted(torch, fa, executor, prompt: dict, node: str, want: tuple,
                what: str, hw: tuple):
    """One request: the image of ``node`` (checked: shape [1, *hw, 3],
    finite, in [0, 1]), its seconds, and its launches per wrapper and per
    CUDA kernel, which must be ``want``'s."""
    before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
    t0 = time.perf_counter()
    out = executor.execute(prompt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                     for k in fa.CUDA_LAUNCHES}
    img = out[node][0]
    require(tuple(img.shape) == (1, *hw, 3), f"{what}: image shape "
            f"{tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), f"{what}: non-finite image")
    require(img.min().item() >= 0.0 and img.max().item() <= 1.0,
            f"{what}: image outside [0, 1]")
    require(counts == want[0], f"{what}: launches {counts} != {want[0]}")
    require(kernel_counts == want[1],
            f"{what}: CUDA kernel launches {kernel_counts} != {want[1]}")
    return img, secs, out


class ControlRun(NamedTuple):
    launches: dict          # path → launches per wrapper over its run
    images: dict            # seed → uint8 image of the img2img + ControlNet graph
    seconds: list           # per img2img + ControlNet request


def write_mask(input_dir: Path) -> None:
    """``mask.png``: the input's size, left half white."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils.image import encode_png

    mask = np.zeros((UPSCALE_INPUT_HW, UPSCALE_INPUT_HW, 3), np.float32)
    mask[:, :UPSCALE_INPUT_HW // 2] = 1.0
    (input_dir / "mask.png").write_bytes(encode_png(mask))


def control_phase(torch, fa, sdxl: PathRun, up: UpscaleRun) -> ControlRun:
    """Phases 8 to 10 on the sdxl path's registry and the upscale path's
    input."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    say("img2img + ControlNet path:")
    write_mask(up.input_dir)
    executor = GraphExecutor({"model_registry": sdxl.registry,
                              "input_dir": str(up.input_dir),
                              "output_dir": str(CONTROL_DIR)})
    hw = (UPSCALE_INPUT_HW, UPSCALE_INPUT_HW)
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cn = sdxl.registry.get_controlnet(CONTROL_PRESET)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in cn.model.parameters())
    say(f"  controlnet {CONTROL_PRESET} built in {time.perf_counter() - t0:.2f} s "
        f"({n_params / 1e9:.3f} B params, {n_params} exactly; "
        f"{sum(1 for m in cn.model.modules() if type(m).__name__ == 'TransformerBlock')}"
        " transformer blocks)")
    clone = sdxl.bundle.pipeline.with_control(cn, CN_STRENGTH)
    fa.reset_launches()
    images, seconds = [], []
    for seed in I2I_SEEDS:
        prompt = i2i_workflow()
        prompt["5"]["inputs"]["seed"] = seed
        img, secs, _ = run_counted(torch, fa, executor, prompt, "6", I2I_CN,
                                   f"img2img + ControlNet seed {seed}", hw)
        t = clone.timings
        say(f"  request seed {seed}: {secs:.3f} s; encode {t['encode_s']:.3f} s, "
            f"sampling {t['sample_s']:.3f} s = {t['sample_s'] / t['steps']:.4f} "
            f"s/step over {t['steps']} steps, decode {t['decode_s']:.3f} s")
        images.append(img)
        seconds.append(secs)
    launches["img2img_controlnet"] = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(torch.equal(images[0], images[2]),
            f"img2img + ControlNet: seed {I2I_SEEDS[0]} twice gave different images")
    require(not torch.equal(images[0], images[1]),
            "img2img + ControlNet: two seeds gave the same image")
    plain, secs, _ = run_counted(torch, fa, executor, i2i_workflow(control=False),
                                 "6", I2I_PLAIN, "img2img without ControlNet", hw)
    diff = (plain - images[0]).abs()
    require(diff.max().item() > 0, "the ControlNet did not change the image")
    say(f"  launches {I2I_CN[0]} a request as expected; seed {I2I_SEEDS[0]} "
        f"repeatable, seed {I2I_SEEDS[1]} differs; max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; without ControlNetApply {secs:.3f} s, "
        f"{I2I_PLAIN[0]['fused_qkv_attention']} K1 launches, differs by max "
        f"{diff.max().item():.4f}, mean {diff.mean().item():.4f}")
    control_reference_phase(torch, fa, sdxl.bundle, cn)

    say("inpaint path:")
    fa.reset_launches()
    out_img, secs, out = run_counted(
        torch, fa, executor, i2i_workflow(control=False, inpaint=True), "6",
        I2I_PLAIN, "inpaint", hw)
    launches["inpaint"] = dict(fa.LAUNCHES)
    src = out["4"][0]
    half = UPSCALE_INPUT_HW // 2
    require(torch.equal(out_img[:, :, half:], src[:, :, half:]),
            "inpaint: the unmasked right half is not the source")
    left = (out_img[:, :, :half] - src[:, :, :half]).abs()
    require(left.max().item() > 0, "inpaint: the masked left half is the source")
    say(f"  request: {secs:.3f} s; right half bitwise the source, left half "
        f"differs by max {left.max().item():.4f}; launches {I2I_PLAIN[0]}")

    say("USDU with ControlNet and spatial_cond path:")
    spatial = torch.zeros(1, USDU_OUT_HW, USDU_OUT_HW, device=cn.device)
    spatial[:, :USDU_OUT_HW // 2] = 1.0
    usdu_hw = (USDU_OUT_HW, USDU_OUT_HW)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    runs = []
    for i in range(2):
        img, secs, out = run_counted(torch, fa, executor, usdu_workflow(spatial),
                                     "6", USDU_CN, f"USDU + ControlNet {i}", usdu_hw)
        chunks = clone.timings["tile_chunks"]
        require(len(chunks) == 1 and chunks[0]["tiles"] == UPSCALE_CHUNK,
                f"USDU + ControlNet: chunks {[c['tiles'] for c in chunks]}")
        c = chunks[0]
        say(f"  request {i}: {secs:.3f} s; 4 tiles in one chunk: encode "
            f"{c['encode_s']:.3f} s, sampling {c['sample_s']:.3f} s "
            f"({c['sample_s'] / UPSCALE_STEPS:.4f} s/step), decode "
            f"{c['decode_s']:.3f} s; composite {clone.timings['composite_s']:.3f} s")
        runs.append((img, secs))
    launches["usdu_controlnet"] = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    scaled = out["5"][0]
    require(tuple(scaled.shape) == (1, *usdu_hw, 3), "ImageScaleBy shape")
    require(torch.equal(runs[0][0], runs[1][0]),
            "USDU + ControlNet twice gave different images")
    kept = (runs[0][0] - scaled)[:, USDU_OUT_HW // 2:].abs().max().item()
    moved = (runs[0][0] - scaled)[:, :USDU_OUT_HW // 2].abs().max().item()
    require(kept <= 1e-5, f"USDU spatial_cond: the bottom half moved by {kept}")
    require(moved > 0, "USDU spatial_cond: the top half was not denoised")
    plain, secs, _ = run_counted(torch, fa, executor,
                                 usdu_workflow(spatial, control=False), "6",
                                 USDU_PLAIN, "USDU without ControlNet", usdu_hw)
    diff = (plain - runs[0][0]).abs().max().item()
    require(diff > 0, "USDU: the ControlNet did not change the image")
    say(f"  launches {USDU_CN[0]} a request as expected; repeat bitwise "
        f"equal; bottom half (spatial_cond 0) the scaled source within "
        f"{kept:.3g}, top half moved by max {moved:.4f}; without ControlNet "
        f"{secs:.3f} s ({USDU_PLAIN[0]['fused_qkv_attention']} K1 launches), "
        f"differs by max {diff:.4f}; max_memory_allocated {peak / 2**30:.3f} GiB")
    return ControlRun(launches, {s: to_uint8(img)[0] for s, img in
                                 zip(I2I_SEEDS[:2], images[:2])}, seconds)


def control_reference_phase(torch, fa, bundle, cn) -> None:
    """One UNet + ControlNet forward at a 512² latent (batch 2) through
    the kernels and with every attention site on the plain versions."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.models import layers

    unet = bundle.pipeline.unet
    cfg = unet.config
    dev = cn.device
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, 64, 64, cfg.in_channels, generator=gen, device=dev)
    t = torch.tensor([500.0, 500.0], device=dev)
    ctx = torch.randn(2, 77, cfg.context_dim, generator=gen, device=dev)
    y = torch.randn(2, cfg.adm_in_channels, generator=gen, device=dev)
    hint = torch.rand(2, 512, 512, 3, generator=gen, device=dev)

    def forward():
        down, mid = cn.model(x, t, ctx, y, hint)
        return unet(x, t, ctx, y, control=([d * CN_STRENGTH for d in down],
                                           mid * CN_STRENGTH))

    with torch.no_grad():
        before = dict(fa.LAUNCHES)
        eps = forward()
        sites = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        base = unet(x, t, ctx, y)
        with mock.patch.object(layers, "self_attention",
                               fa.fused_qkv_attention_plain), \
                mock.patch.object(layers, "full_attention",
                                  fa.flash_attention_plain):
            ref = forward()
    n = sum(CONTROL_BLOCKS)
    require(sites["fused_qkv_attention"] == n
            and sites["flash_attention_packed"] == n,
            f"control reference: launches {sites} per forward, expected {n}")
    require((eps - base).abs().max().item() > 0,
            "control reference: the residuals changed nothing")
    compare_whole(torch, "control reference: UNet + ControlNet eps at 512²",
                  eps, ref)


# --- phases 11 to 13 ---------------------------------------------------------

SD15_DIR = OUTPUT_DIR / "sd15"
SD15_SEEDS = (5, 6)
CN_TILE_WORKFLOW = "controlnet-tile-upscale.json"
CN_TILE_DIR = OUTPUT_DIR / "cn_tile"
CN_TILE_OUT_HW = 2 * UPSCALE_INPUT_HW
CN_TILE_PNG = "cn_upscaled_00000.png"


def sd15_workflow(sampler: str, seed: int, steps: int = SD15_STEPS) -> dict:
    """``CheckpointLoader sd15`` → two ``CLIPTextEncode`` → ``TPUTxt2Img``
    at 512², karras, CFG 7 → ``SaveImage``."""
    return {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": "sd15"}},
        "2": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "a lighthouse on a cliff at dusk, oil painting",
            "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "blurry, low quality", "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": steps, "cfg": 7.0, "width": SD15_HW,
            "height": SD15_HW, "sampler_name": sampler, "scheduler": "karras"}},
        "5": {"class_type": "SaveImage", "inputs": {
            "images": ["4", 0], "filename_prefix": f"sd15_{sampler}"}},
    }


def sd15_phase(torch, fa, registry) -> dict:
    """Phase 11: the sd15 txt2img graph once for each of the 14 sampler
    names at 8 steps (the stochastic ones also repeated and at another
    seed), then one timed request at 20 steps with dpmpp_2m; returns the
    launches over the phase."""
    from comfyui_distributed_tpu_torch.diffusion.progress import total_calls
    from comfyui_distributed_tpu_torch.diffusion.samplers import (SAMPLERS,
                                                                  STOCHASTIC)
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    say("sd15 path:")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = registry.get("sd15")
    torch.cuda.synchronize()
    counts = {part: sum(p.numel() for p in module.parameters()) for part, module
              in (("unet", bundle.pipeline.unet), ("vae", bundle.pipeline.vae),
                  ("text", bundle.text_encoder.module))}
    say(f"  sd15 bundle built in {time.perf_counter() - t0:.2f} s (UNet "
        f"{counts['unet'] / 1e9:.3f} B params, {counts['unet']} exactly; VAE "
        f"{counts['vae']}; text encoder {counts['text']}); UNet "
        f"{bundle.pipeline.unet.config}")
    require(len(SAMPLERS) == 14, f"{len(SAMPLERS)} samplers")
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(SD15_DIR)})
    hw = (SD15_HW, SD15_HW)
    fa.reset_launches()
    for name in SAMPLERS:
        calls = total_calls(name, SD15_STEPS)
        want = k3_counts(calls, SD15_SHAPES)
        png = SD15_DIR / f"sd15_{name}_00000.png"
        png.unlink(missing_ok=True)
        img, secs, _ = run_counted(torch, fa, executor,
                                   sd15_workflow(name, SD15_SEEDS[0]), "4",
                                   want, f"sd15 {name}", hw)
        require(png.is_file() and png_size(png) == hw,
                f"{png} missing or not {hw[1]}x{hw[0]}")
        line = (f"  {name}: {secs:.3f} s; {calls} UNet calls; launches "
                f"{want[0]}, CUDA kernels {want[1]}")
        if name in STOCHASTIC:
            again, _, _ = run_counted(torch, fa, executor,
                                      sd15_workflow(name, SD15_SEEDS[0]), "4",
                                      want, f"sd15 {name} again", hw)
            other, _, _ = run_counted(torch, fa, executor,
                                      sd15_workflow(name, SD15_SEEDS[1]), "4",
                                      want, f"sd15 {name} seed {SD15_SEEDS[1]}",
                                      hw)
            require(torch.equal(img, again),
                    f"sd15 {name}: seed {SD15_SEEDS[0]} twice differs")
            require(not torch.equal(img, other),
                    f"sd15 {name}: seeds {SD15_SEEDS} gave one image")
            line += (f"; seed {SD15_SEEDS[0]} repeat bitwise equal, seed "
                     f"{SD15_SEEDS[1]} differs")
        say(line)
    want = k3_counts(total_calls("dpmpp_2m", SD15_TIMED_STEPS), SD15_SHAPES)
    _, secs, _ = run_counted(
        torch, fa, executor,
        sd15_workflow("dpmpp_2m", SD15_SEEDS[0], SD15_TIMED_STEPS), "4", want,
        "sd15 dpmpp_2m at 20 steps", hw)
    t = bundle.pipeline.timings
    say(f"  timed request (dpmpp_2m, {SD15_TIMED_STEPS} steps): {secs:.3f} s; "
        f"sampling {t['sample_s']:.3f} s = {t['sample_s'] / t['steps']:.4f} "
        f"s/step, decode {t['decode_s']:.3f} s; launches {want[0]}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return dict(fa.LAUNCHES)


def plain_attention_patches(fa):
    """Every attention site of the UNet blocks on its plain version (one
    batch row at a time for the one-head sites)."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.models import layers

    return (mock.patch.object(layers, "self_attention",
                              fa.fused_qkv_attention_plain),
            mock.patch.object(layers, "full_attention",
                              lambda q, k, v: plain_by_row(fa, q, k, v)))


def sd15_reference_phase(torch, fa, bundle) -> None:
    """Phase 12: one sd15 UNet forward at a 64² latent (batch 2) through
    the kernels and with the attention sites on the plain versions."""
    unet = bundle.pipeline.unet
    cfg = unet.config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(2, 64, 64, cfg.in_channels, generator=gen, device=dev)
    t = torch.tensor([500.0, 500.0], device=dev)
    ctx = torch.randn(2, 77, cfg.context_dim, generator=gen, device=dev)
    with torch.no_grad():
        before = dict(fa.LAUNCHES)
        eps = unet(x, t, ctx)
        sites = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        sa, fu = plain_attention_patches(fa)
        with sa, fu:
            ref = unet(x, t, ctx)
    n = 3 * SD15_UNET_BLOCKS * 2
    require(sites == {"fused_qkv_attention": 0, "flash_attention_packed": 0,
                      "flash_attention_bh": n},
            f"sd15 reference: launches {sites} per forward, expected {n} K3")
    compare_whole(torch, "sd15 reference: UNet eps at 512²", eps, ref)


def cn_tile_workflow() -> dict:
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / CN_TILE_WORKFLOW).read_text()))
    usdu = workflow["5"]["inputs"]
    require((usdu["steps"], usdu["denoise"], usdu["upscale_by"],
             usdu["tile_width"], usdu["tile_height"], usdu["tile_padding"],
             usdu["cfg"], usdu.get("sampler_name", "euler"))
            == (18, 0.4, 2.0, 768, 768, 32, 6.0, "euler")
            and workflow["1"]["inputs"]["ckpt_name"] == "sd15"
            and workflow["8"]["inputs"]["control_net_name"] == "sd15"
            and workflow["4"]["inputs"]["image"] == "input.png",
            f"{CN_TILE_WORKFLOW} changed; update the script")
    return workflow


class CnTileRun(NamedTuple):
    launches: dict
    image_u8: object        # the first request's image as uint8 numpy
    seconds: list


def cn_tile_phase(torch, fa, registry, input_dir: Path) -> CnTileRun:
    """Phase 13: ``workflows/controlnet-tile-upscale.json`` unchanged on
    the 1024² input, twice; then one UNet + ControlNet forward at a
    tile's shape against plain attention."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    say("ControlNet tile upscale path:")
    workflow = cn_tile_workflow()
    strength = workflow["9"]["inputs"]["strength"]
    executor = GraphExecutor({"model_registry": registry,
                              "input_dir": str(input_dir),
                              "output_dir": str(CN_TILE_DIR)})
    t0 = time.perf_counter()
    cn = registry.get_controlnet("sd15")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in cn.model.parameters())
    say(f"  controlnet sd15 built in {time.perf_counter() - t0:.2f} s "
        f"({n_params / 1e9:.3f} B params, {n_params} exactly)")
    bundle = registry.get("sd15")
    clone = bundle.pipeline.with_control(cn, strength)
    want = k3_counts(1, CN_TILE_SHAPES)
    hw = (CN_TILE_OUT_HW, CN_TILE_OUT_HW)
    png = CN_TILE_DIR / CN_TILE_PNG
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    images, seconds = [], []
    for i in range(2):
        png.unlink(missing_ok=True)
        img, secs, _ = run_counted(torch, fa, executor, workflow, "5", want,
                                   f"ControlNet tile upscale {i}", hw)
        require(png.is_file() and png_size(png) == hw,
                f"{png} missing or not {hw[1]}x{hw[0]}")
        chunks = clone.timings["tile_chunks"]
        require(len(chunks) == CN_TILE_CHUNKS
                and all(c["tiles"] == CN_TILE_CHUNK for c in chunks),
                f"ControlNet tile upscale: chunks {[c['tiles'] for c in chunks]}")
        split = {part: sum(c[f"{part}_s"] for c in chunks)
                 for part in ("encode", "sample", "decode")}
        say(f"  request {i}: {secs:.3f} s; {CN_TILE_TILES} tiles of 832² in "
            f"{CN_TILE_CHUNKS} chunks of {CN_TILE_CHUNK}: encode "
            f"{split['encode']:.3f} s, sampling {split['sample']:.3f} s "
            f"({split['sample'] / CN_TILE_FORWARDS:.4f} s a step of a chunk), "
            f"decode {split['decode']:.3f} s; composite "
            f"{clone.timings['composite_s']:.3f} s; launches {want[0]}, CUDA "
            f"kernels {want[1]}")
        images.append(img)
        seconds.append(secs)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(torch.equal(images[0], images[1]),
            "the ControlNet tile upscale twice gave different images")
    say(f"  repeat bitwise equal; max_memory_allocated {peak / 2**30:.3f} GiB")
    cn_tile_reference_phase(torch, fa, bundle, cn, strength)
    return CnTileRun(launches, to_uint8(images[0])[0], seconds)


def cn_tile_reference_phase(torch, fa, bundle, cn, strength: float) -> None:
    """One UNet + ControlNet forward at a tile's shape (a 104² latent, an
    832² hint, batch 2) through the kernels and on the plain versions."""
    unet = bundle.pipeline.unet
    cfg = unet.config
    dev = cn.device
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(2, 104, 104, cfg.in_channels, generator=gen, device=dev)
    t = torch.tensor([300.0, 300.0], device=dev)
    ctx = torch.randn(2, 77, cfg.context_dim, generator=gen, device=dev)
    hint = torch.rand(2, 832, 832, 3, generator=gen, device=dev)

    def forward():
        down, mid = cn.model(x, t, ctx, None, hint)
        return unet(x, t, ctx, control=([d * strength for d in down],
                                        mid * strength))

    with torch.no_grad():
        before = dict(fa.LAUNCHES)
        eps = forward()
        sites = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        sa, fu = plain_attention_patches(fa)
        with sa, fu:
            ref = forward()
    n = 3 * (SD15_UNET_BLOCKS + SD15_CONTROL_BLOCKS) * 2
    require(sites["flash_attention_bh"] == n and sites["fused_qkv_attention"] == 0,
            f"ControlNet tile reference: launches {sites}, expected {n} K3")
    compare_whole(torch, "ControlNet tile reference: UNet + ControlNet eps "
                  "at a 832² tile", eps, ref)


# --- phases 13a and 13b: audio and video --------------------------------------

AUDIO_DIR = OUTPUT_DIR / "audio"
VIDEO_DIR = OUTPUT_DIR / "video"
AUDIO_WORKFLOW = "distributed-audio.json"
VIDEO_WORKFLOW = "video-upscale.json"
AUDIO_SECONDS, AUDIO_RATE, AUDIO_CHANNELS = 60, 48000, 2
VIDEO_SEED = 7                          # the workflow's USDU seed
VIDEO_SERVED_FRAMES = 8                 # frame_load_cap of the served run
CHUNK_WAVS = ("chunk_a_00000.wav", "chunk_b_00000.wav")
VIDEO_AVI = "video_up_00000.avi"


def audio_workflow() -> dict:
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / AUDIO_WORKFLOW).read_text()))
    require(workflow["1"]["inputs"]["audio"] == "clip.wav"
            and workflow["4"]["inputs"]["divide_by"] == 2
            and [workflow[n]["inputs"]["filename_prefix"] for n in ("5", "6")]
            == ["chunk_a", "chunk_b"],
            f"{AUDIO_WORKFLOW} changed; update the script")
    return workflow


def video_workflow(frame_cap: int = 0) -> dict:
    """``workflows/video-upscale.json`` with node 4 reading ``input.avi``
    (and ``frame_load_cap`` when given)."""
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / VIDEO_WORKFLOW).read_text()))
    usdu = workflow["5"]["inputs"]
    require((usdu["steps"], usdu["denoise"], usdu["upscale_by"],
             usdu["tile_width"], usdu["tile_height"], usdu["tile_padding"],
             usdu["cfg"], usdu["sampler_name"], usdu["scheduler"],
             usdu["seed"])
            == (12, 0.25, 1.0, VIDEO_TILE, VIDEO_TILE, VIDEO_PADDING, 5.0,
                "res_2m", "beta", VIDEO_SEED)
            and workflow["1"]["inputs"]["ckpt_name"] == "sd15"
            and workflow["8"]["inputs"]["model_name"] == "realesrgan-x2"
            and workflow["7"]["inputs"]["format"] == "avi"
            and workflow["4"]["inputs"]["video"] == "input.mp4",
            f"{VIDEO_WORKFLOW} changed; update the script")
    workflow["4"]["inputs"]["video"] = "input.avi"
    if frame_cap:
        workflow["4"]["inputs"]["frame_load_cap"] = frame_cap
    return workflow


def video_counts(frames: int) -> tuple:
    """K1 and K3 launches of ``frames`` frames' USDU (and the text)."""
    return k3_counts(frames * VIDEO_CHUNKS_A_FRAME * VIDEO_STEPS,
                     VIDEO_FORWARD_SHAPES)


def video_spec():
    """The workflow's USDU settings as the engine's spec."""
    from comfyui_distributed_tpu_torch.tiles.engine import UpscaleSpec

    return UpscaleSpec(scale=1.0, tile_w=VIDEO_TILE, tile_h=VIDEO_TILE,
                       padding=VIDEO_PADDING, steps=12, denoise=0.25,
                       sampler="res_2m", scheduler="beta", guidance_scale=5.0)


def stage_timer(torch, classes: tuple):
    """A context in which each named node class's ``execute`` adds its
    seconds (the card synchronised at its end) to the returned dict."""
    import contextlib
    from unittest import mock

    from comfyui_distributed_tpu_torch.graph.node import NODE_REGISTRY

    seconds: dict[str, float] = {}
    stack = contextlib.ExitStack()
    for name in classes:
        cls = NODE_REGISTRY[name]
        inner = cls.execute

        def timed(self, *a, _inner=inner, _name=name, **kw):
            t0 = time.perf_counter()
            out = _inner(self, *a, **kw)
            torch.cuda.synchronize()
            seconds[_name] = seconds.get(_name, 0.0) + time.perf_counter() - t0
            return out

        stack.enter_context(mock.patch.object(cls, "execute", timed))
    return stack, seconds


def write_av_inputs(input_dir: Path) -> dict:
    """``clip.wav`` (60 s of seeded stereo at 48 kHz, 16-bit) and
    ``input.avi`` (24 seeded frames of 960×540 at 24 fps with a 1 s stereo
    track at 48 kHz, written by the port's muxer) in the input directory;
    returns the encode's seconds a frame."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils.audio_payload import wav_bytes
    from comfyui_distributed_tpu_torch.utils.video_io import save_video

    rng = np.random.default_rng(12)
    n = AUDIO_SECONDS * AUDIO_RATE
    t = np.arange(n, dtype=np.float32) / AUDIO_RATE
    clip = np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in (220.0, 331.0)])
    clip += 0.05 * rng.standard_normal(clip.shape).astype(np.float32)
    (input_dir / "clip.wav").write_bytes(wav_bytes(clip, AUDIO_RATE))
    wav_size = (input_dir / "clip.wav").stat().st_size

    H, W = VIDEO_IN_HW
    y = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None, None]
    x = np.linspace(0.0, 1.0, W, dtype=np.float32)[None, :, None]
    phase = np.array([0.0, 2.1, 4.2], np.float32)
    frames = np.stack([
        np.clip(0.5 + 0.35 * np.sin(6 * x + 4 * y + 0.3 * i + phase)
                + 0.03 * rng.standard_normal((H, W, 3)), 0.0, 1.0)
        for i in range(VIDEO_FRAMES)]).astype(np.float32)
    s = int(AUDIO_RATE * VIDEO_FRAMES / VIDEO_FPS)
    track = {"waveform": np.clip(
        0.4 * np.sin(2 * np.pi * 440.0 * t[None, None, :s])
        + 0.02 * rng.standard_normal((1, AUDIO_CHANNELS, s)), -1, 1
    ).astype(np.float32), "sample_rate": AUDIO_RATE}
    t0 = time.perf_counter()
    save_video(input_dir / "input.avi", frames, fps=VIDEO_FPS, audio=track)
    enc_s = (time.perf_counter() - t0) / VIDEO_FRAMES
    say(f"  inputs: clip.wav {wav_size} bytes ({AUDIO_SECONDS} s, "
        f"{AUDIO_CHANNELS} channels at {AUDIO_RATE} Hz, 16-bit); input.avi "
        f"{(input_dir / 'input.avi').stat().st_size} bytes ({VIDEO_FRAMES} "
        f"frames of {W}x{H} at {VIDEO_FPS:g} fps, {s} samples of stereo); "
        f"JPEG encode {enc_s:.3f} s a {W}x{H} frame on the host")
    return {"encode_540p_s": enc_s}


def expected_chunks(input_dir: Path) -> list[bytes]:
    """The two WAVs ``SaveAudio`` must write for the direct run: the
    halves of ``clip.wav`` as the codec reads and writes them (the JAX
    package's 16-bit codec reads p / 32768 and writes trunc(x · 32767), so
    each nonzero sample moves one level toward 0)."""
    from comfyui_distributed_tpu_torch.utils.audio_payload import (wav_bytes,
                                                                   wav_decode)

    wf = wav_decode((input_dir / "clip.wav").read_bytes())["waveform"][0]
    half = wf.shape[-1] // 2
    return [wav_bytes(wf[:, :half], AUDIO_RATE),
            wav_bytes(wf[:, half:], AUDIO_RATE)]


def audio_phase(torch, fa, input_dir: Path) -> dict:
    """Phase 13a: ``workflows/distributed-audio.json`` unchanged on
    ``clip.wav``; returns its launches (none)."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    say("audio path:")
    workflow = audio_workflow()
    want = expected_chunks(input_dir)
    shutil.rmtree(AUDIO_DIR, ignore_errors=True)
    executor = GraphExecutor({"input_dir": str(input_dir),
                              "output_dir": str(AUDIO_DIR)})
    fa.reset_launches()
    t0 = time.perf_counter()
    out = executor.execute(workflow)
    secs = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    require(not any(launches.values()), f"audio path: launches {launches}")
    half = AUDIO_SECONDS * AUDIO_RATE // 2
    require(tuple(out["4"][0]["waveform"].shape) == (1, AUDIO_CHANNELS, half),
            f"audio path: chunk shape {tuple(out['4'][0]['waveform'].shape)}")
    got = [(AUDIO_DIR / name).read_bytes() for name in CHUNK_WAVS]
    require(got == want, "audio path: chunk_a/chunk_b are not the halves of "
            "clip.wav as the codec writes them")
    src = np.frombuffer((input_dir / "clip.wav").read_bytes()[44:], "<i2")
    chunks = np.concatenate([np.frombuffer(g[44:], "<i2") for g in got])
    say(f"  distributed-audio.json: {secs:.3f} s; chunk_a and chunk_b "
        f"bitwise the halves of clip.wav through the 16-bit codec "
        f"({int((chunks != src).sum())} of {src.size} samples one level "
        f"toward 0, the rest equal); launches {launches}")
    return launches


class VideoRun(NamedTuple):
    launches: dict
    seconds: float
    upscaled: object        # the ESRGAN frames of the served run's span


def video_phase(torch, fa, registry, input_dir: Path, encode_540p_s: float
                ) -> VideoRun:
    """Phase 13b: ``workflows/video-upscale.json`` on ``input.avi``: the
    stage seconds, the launches, the file read back; then one tile
    chunk's UNet forward against plain attention."""
    import numpy as np

    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.tiles.engine import TileUpscaler
    from comfyui_distributed_tpu_torch.utils.video_io import (load_video,
                                                              read_avi_mjpg)

    say("video path:")
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    say(f"  import cv2 on this machine: {'works' if has_cv2 else 'fails'}"
        + ("" if has_cv2 else " (the AVI path needs none; mp4 is skipped)"))
    workflow = video_workflow()
    bundle = registry.get("sd15")
    # the engine's own geometry for a 1080p frame
    upscaler = TileUpscaler(bundle.pipeline)
    grid = upscaler.grid_for(*VIDEO_OUT_HW, video_spec())
    chunk = upscaler.tiles_per_device_default(VIDEO_TILE, VIDEO_TILE)
    require((grid.num_tiles, chunk) == (VIDEO_TILES_A_FRAME, VIDEO_CHUNK),
            f"video path: {grid.num_tiles} tiles a frame in chunks of {chunk}")
    want = video_counts(VIDEO_FRAMES)
    shutil.rmtree(VIDEO_DIR, ignore_errors=True)
    executor = GraphExecutor({"model_registry": registry,
                              "input_dir": str(input_dir),
                              "output_dir": str(VIDEO_DIR)})
    stages = ("LoadVideo", "ImageUpscaleWithModel",
              "UltimateSDUpscaleDistributed", "SaveVideo")
    timer, seconds = stage_timer(torch, stages)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    cuda_before = dict(fa.CUDA_LAUNCHES)
    t0 = time.perf_counter()
    with timer:
        out = executor.execute(workflow)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                     for k in fa.CUDA_LAUNCHES}
    require(launches == want[0], f"video path: launches {launches} != {want[0]}")
    require(kernel_counts == want[1],
            f"video path: CUDA kernel launches {kernel_counts} != {want[1]}")
    frames = out["5"][0]
    require(tuple(frames.shape) == (VIDEO_FRAMES, *VIDEO_OUT_HW, 3),
            f"video path: frames {tuple(frames.shape)}")
    require(bool(torch.isfinite(frames).all())
            and frames.min().item() >= 0.0 and frames.max().item() <= 1.0,
            "video path: frames non-finite or outside [0, 1]")
    path = Path(out["7"][0])
    require(path == VIDEO_DIR / VIDEO_AVI and path.is_file(),
            f"video path: wrote {path}")
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    back = load_video(path)
    dec_s = (time.perf_counter() - t1) / VIDEO_FRAMES
    require(back["frames"].shape == (VIDEO_FRAMES, *VIDEO_OUT_HW, 3)
            and back["fps"] == VIDEO_FPS,
            f"video path: read back {back['frames'].shape} at {back['fps']}")
    src = read_avi_mjpg(input_dir / "input.avi", cap=1)["audio"]
    pcm = (np.clip(src["waveform"][0].numpy(), -1, 1) * 32767.0).astype(np.int16)
    track = torch.from_numpy((pcm.astype(np.float32) / 32768.0)[None])
    require(back["audio"] is not None
            and back["audio"]["sample_rate"] == AUDIO_RATE
            and torch.equal(back["audio"]["waveform"], track),
            "video path: the audio read back is not the source's track as the "
            "muxer writes it")
    jpeg_err = np.abs(back["frames"] - frames.cpu().numpy()).mean() * 255
    say(f"  video-upscale.json: {secs:.3f} s for {VIDEO_FRAMES} frames of "
        f"{VIDEO_IN_HW[1]}x{VIDEO_IN_HW[0]} → {VIDEO_OUT_HW[1]}x"
        f"{VIDEO_OUT_HW[0]}: decode {seconds['LoadVideo']:.3f} s "
        f"({seconds['LoadVideo'] / VIDEO_FRAMES:.3f} s a 540p frame), ESRGAN "
        f"{seconds['ImageUpscaleWithModel']:.3f} s, USDU "
        f"{seconds['UltimateSDUpscaleDistributed']:.3f} s ({VIDEO_FORWARDS} "
        f"UNet forwards), encode {seconds['SaveVideo']:.3f} s "
        f"({seconds['SaveVideo'] / VIDEO_FRAMES:.3f} s a 1080p frame); "
        f"launches {launches}, CUDA kernels {kernel_counts}; peak "
        f"{peak / 2**30:.3f} GiB")
    say(f"  {VIDEO_AVI}: {path.stat().st_size} bytes, read back as "
        f"{VIDEO_FRAMES} frames of 1920x1080 at {back['fps']:g} fps in "
        f"{dec_s:.3f} s a frame (JPEG decode on the host; mean error "
        f"{jpeg_err:.3f} levels against the frames), the audio bitwise the "
        f"source's track as the muxer writes it; JPEG per frame: encode "
        f"{encode_540p_s:.3f} s at 540p, {seconds['SaveVideo'] / VIDEO_FRAMES:.3f}"
        f" s at 1080p; decode {seconds['LoadVideo'] / VIDEO_FRAMES:.3f} s at "
        f"540p, {dec_s:.3f} s at 1080p")
    upscaled = out["9"][0][:VIDEO_SERVED_FRAMES].clone()
    ctx = (out["2"][0]["context"], out["3"][0]["context"])
    del out, frames, back
    video_reference_phase(torch, fa, bundle, ctx)
    if has_cv2:
        video_mp4_phase(torch, fa, registry, input_dir)
    return VideoRun(launches, secs, upscaled)


def video_mp4_phase(torch, fa, registry, input_dir: Path) -> None:
    """Where OpenCV imports: the workflow unchanged on ``input.mp4``,
    written through OpenCV from the AVI's first 8 frames (a shorter clip
    than the AVI's, to keep the run's time)."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.utils.video_io import (load_video,
                                                              save_video)

    frames = VIDEO_SERVED_FRAMES
    clip = load_video(input_dir / "input.avi", frame_load_cap=frames)
    save_video(input_dir / "input.mp4", clip["frames"], fps=clip["fps"],
               audio=clip["audio"])
    workflow = video_workflow()
    workflow["4"]["inputs"]["video"] = "input.mp4"
    executor = GraphExecutor({"model_registry": registry,
                              "input_dir": str(input_dir),
                              "output_dir": str(VIDEO_DIR / "mp4")})
    want = video_counts(frames)
    fa.reset_launches()
    t0 = time.perf_counter()
    out = executor.execute(workflow)
    torch.cuda.synchronize()
    require(dict(fa.LAUNCHES) == want[0],
            f"video path (mp4): launches {dict(fa.LAUNCHES)} != {want[0]}")
    require(tuple(out["5"][0].shape) == (frames, *VIDEO_OUT_HW, 3),
            f"video path (mp4): frames {tuple(out['5'][0].shape)}")
    say(f"  video-upscale.json on a {frames}-frame input.mp4: "
        f"{time.perf_counter() - t0:.3f} s ({out['4'][2]:g} fps as OpenCV "
        f"reads it); launches {want[0]}")


def video_reference_phase(torch, fa, bundle, ctx) -> None:
    """One tile chunk's UNet forward (4 tiles with CFG: batch 8 at a 102²
    latent, the workflow's prompts) through the kernels and on the plain
    versions."""
    unet = bundle.pipeline.unet
    cfg = unet.config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    lat = (VIDEO_TILE + 2 * VIDEO_PADDING) // 8
    x = torch.randn(8, lat, lat, cfg.in_channels, generator=gen, device=dev)
    t = torch.full((8,), 250.0, device=dev)
    context = torch.cat([ctx[0].expand(4, -1, -1), ctx[1].expand(4, -1, -1)])
    with torch.no_grad():
        before = dict(fa.LAUNCHES)
        eps = unet(x, t, context)
        sites = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        sa, fu = plain_attention_patches(fa)
        with sa, fu:
            ref = unet(x, t, context)
    n = 3 * SD15_UNET_BLOCKS * 2
    require(sites == {"fused_qkv_attention": 0, "flash_attention_packed": 0,
                      "flash_attention_bh": n},
            f"video reference: launches {sites} per forward, expected {n} K3")
    compare_whole(torch, f"video reference: UNet eps of a tile chunk "
                  f"(batch 8 at {lat}²)", eps, ref)


# --- phase 14 ----------------------------------------------------------------

SERVE_DIR = OUTPUT_DIR / "serve"
SERVE_BOOT_S = 180.0         # the worker's process start, up to /health
SERVE_REQUEST_S = 600.0      # one served request (the first builds a bundle)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_raw(url: str, payload=None, timeout: float = 30.0,
             token: str | None = None) -> tuple[int, bytes]:
    """One call as a user makes it (JSON in, the body out) on urllib;
    ``token`` goes in ``X-CDT-Auth``."""
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    headers = {"Content-Type": "application/json"}
    if token:
        headers["X-CDT-Auth"] = token
    req = urllib.request.Request(url, data=data, headers=headers)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read()


def http_json(url: str, payload=None, timeout: float = 30.0,
              token: str | None = None) -> tuple[int, dict]:
    status, body = http_raw(url, payload, timeout, token)
    return status, json.loads(body or b"{}")


def start_worker(port: int, log_path: Path, input_dir: Path):
    """``serve`` through the CLI as a worker on the card (in this process's
    environment: a ``CDT_AUTH_TOKEN`` set here is the worker's); returns
    the process once ``/distributed/health`` answers."""
    (SERVE_DIR / "worker.json").write_text("{}")
    env = {**os.environ, "CDT_IS_WORKER": "1", "CDT_WORKER_ID": "w0",
           "CDT_CONFIG_PATH": str(SERVE_DIR / "worker.json"),
           "CDT_OUTPUT_DIR": str(SERVE_DIR / "worker_out"),
           "CDT_INPUT_DIR": str(input_dir)}
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "comfyui_distributed_tpu_torch", "serve",
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < SERVE_BOOT_S:
        require(proc.poll() is None,
                f"worker exited with {proc.returncode} before answering")
        try:
            status, health = http_json(
                f"http://127.0.0.1:{port}/distributed/health", timeout=5)
            if status == 200 and health.get("role") == "worker":
                say(f"  worker up in {time.perf_counter() - t0:.2f} s "
                    f"(pid {proc.pid}, port {port})")
                return proc
        except OSError:
            pass
        time.sleep(0.25)
    proc.kill()
    raise SmokeFailure(f"worker did not answer /distributed/health in "
                       f"{SERVE_BOOT_S} s")


def wait_history(base: str, prompt_id: str, t0: float, what: str) -> dict:
    while True:
        status, entry = http_json(f"{base}/distributed/history/{prompt_id}")
        if status == 200 and entry.get("status") in (
                "success", "error", "interrupted"):
            return entry
        require(time.perf_counter() - t0 < SERVE_REQUEST_S,
                f"{what} not final after {SERVE_REQUEST_S} s")
        time.sleep(0.05)


def serve_phase(torch, fa, sdxl: PathRun, up: UpscaleRun,
                control: ControlRun, cn_tile: CnTileRun,
                video: VideoRun) -> dict:
    """Serve the SDXL workflow twice, then the upscale workflow, the
    img2img + ControlNet graph, the ControlNet tile upscale, the audio
    workflow and the video upscale once each,
    through ``POST /distributed/queue`` to a master in this process and a
    ``remote`` worker subprocess with an input directory of its own;
    returns the master's launches in the phase."""
    import shutil
    from unittest import mock

    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster import orchestration
    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.utils.frames import pack_frame
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    seed = SDXL_PATH.seeds[0]
    worker_seed = seed + 0 + 1          # seed + worker index + 1
    require(worker_seed in sdxl.images, "the sdxl path has no seed-8 image")
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    master_out = SERVE_DIR / "master_out"
    master_port, worker_port = free_port(), free_port()
    # the worker shares no files with the master: its input directory
    # starts empty and the master syncs what a prompt reads
    (SERVE_DIR / "master.json").write_text(json.dumps({
        "master": {"host": "127.0.0.1", "port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "remote", "enabled": True}]}))
    worker_in = SERVE_DIR / "worker_in"
    shutil.rmtree(worker_in, ignore_errors=True)
    worker_in.mkdir(parents=True)
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / SDXL_PATH.workflow).read_text()))
    prompt[SDXL_PATH.seed_node]["inputs"]["seed"] = seed
    want = {s: to_uint8(sdxl.images[s])[0] for s in (seed, worker_seed)}
    log_path = SERVE_DIR / "worker.log"
    reports = []
    sync = orchestration.sync_host_media

    async def recording_sync(*args, **kwargs):
        out = await sync(*args, **kwargs)
        reports.append(out[1])
        return out

    worker = server = None
    ok = False
    patch = mock.patch.object(orchestration, "sync_host_media", recording_sync)
    patch.start()
    try:
        worker = start_worker(worker_port, log_path, worker_in)
        os.environ["CDT_OUTPUT_DIR"] = str(master_out)
        os.environ["CDT_INPUT_DIR"] = str(up.input_dir)
        try:
            master = Controller(SERVE_DIR / "master.json", device="cuda",
                                model_registry=sdxl.registry)
        finally:
            del os.environ["CDT_OUTPUT_DIR"], os.environ["CDT_INPUT_DIR"]
        server = ServerThread(master, port=master_port)
        base = f"http://127.0.0.1:{master_port}"
        fa.reset_launches()
        for i in range(2):
            for png in master_out.glob("*.png"):
                png.unlink()
            before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
            t0 = time.perf_counter()
            status, answer = http_json(base + "/distributed/queue",
                                       {"prompt": prompt}, timeout=120)
            require(status == 200 and answer.get("prompt_id"),
                    f"queue answered {status}: {answer}")
            require(answer.get("worker_count") == 1,
                    f"worker_count {answer.get('worker_count')} != 1: {answer}")
            require(reports and reports[-1].checked == 0,
                    f"request {i}: media synced for a prompt without media")
            entry = wait_history(base, answer["prompt_id"], t0, f"request {i}")
            secs = time.perf_counter() - t0
            require(entry["status"] == "success", f"request {i}: {entry}")
            counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
            kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                            for k in fa.CUDA_LAUNCHES}
            require(counts == SDXL_PATH.expected,
                    f"served request {i}: master launches {counts} != "
                    f"{SDXL_PATH.expected}")
            require(kernel_counts == SDXL_PATH.expected_cuda,
                    f"served request {i}: master CUDA kernel launches "
                    f"{kernel_counts} != {SDXL_PATH.expected_cuda}")
            pngs = sorted(master_out.glob("*.png"))
            require(len(pngs) == 2, f"request {i}: {len(pngs)} PNGs, expected 2")
            got = []
            for png in pngs:
                require(png_size(png) == (1024, 1024), f"{png} not 1024x1024")
                got.append(to_uint8(decode_png(png.read_bytes()))[0])
            require(np_equal(got[0], want[seed]),
                    f"request {i}: the master's PNG differs from the direct "
                    f"seed-{seed} image")
            diff = np_absdiff(got[1], want[worker_seed])
            bitwise = diff.max() == 0
            say(f"  served request {i}: {secs:.3f} s (POST to final history; "
                f"direct request {sdxl.seconds[i]:.3f} s); worker_count 1; "
                f"master launches {counts}; PNG 0 bitwise equal to direct "
                f"seed {seed}; PNG 1 {'bitwise equal' if bitwise else 'NOT bitwise equal'}"
                f" to direct seed {worker_seed} (max level difference "
                f"{int(diff.max())}, {int((diff.max(axis=-1) > 0).sum())} "
                f"pixels differ)")
            require(diff.max() <= 1, f"request {i}: the worker's PNG is more "
                    f"than one level from the direct seed-{worker_seed} image")
        frame = pack_frame(got[1], level=1)
        say(f"  the worker's image on the wire: {len(frame)} frame bytes "
            f"(CDTF, zlib level 1) of {got[1].nbytes} raw")
        serve_upscale(torch, fa, base, worker_port, master_out, up)
        report = reports[-1]
        require((report.checked, report.uploaded, report.failed) == (1, 1, []),
                f"served upscale: media sync {report}, expected 1 uploaded")
        require((worker_in / "input.png").read_bytes()
                == (up.input_dir / "input.png").read_bytes(),
                "the worker's input.png differs from the master's")
        say(f"  media sync before the served upscale: {report}; the "
            "worker's input.png byte-identical to the master's")
        launches = dict(fa.LAUNCHES)
        fa.reset_launches()
        serve_img2img(torch, fa, base, master_out, control, reports)
        launches = {k: launches[k] + fa.LAUNCHES[k] for k in launches}
        fa.reset_launches()
        serve_cn_tile(torch, fa, base, master_out, cn_tile, reports)
        launches = {k: launches[k] + fa.LAUNCHES[k] for k in launches}
        fa.reset_launches()
        serve_audio(torch, fa, base, master, master_out, up.input_dir, reports)
        require(not any(fa.LAUNCHES.values()),
                f"served audio: master launches {dict(fa.LAUNCHES)}")
        fa.reset_launches()
        video_launches = serve_video(torch, fa, base, master_out, video,
                                     reports)
        ok = True
        return {k: launches[k] + video_launches[k] for k in launches}
    finally:
        patch.stop()
        if server is not None:
            server.stop()
        if worker is not None:
            stop_worker(worker)
        if not ok and log_path.is_file():
            tail = log_path.read_text(errors="replace").splitlines()[-40:]
            print("chip_smoke: worker log tail:\n" + "\n".join(tail),
                  file=sys.stderr)


UPSCALE_HOLDBACK_S = 120.0   # the master waits this long for the worker's pull


def serve_upscale(torch, fa, base: str, worker_port: int, master_out: Path,
                  up: UpscaleRun) -> None:
    """The upscale workflow through ``POST /distributed/queue``: the tiles
    are pulled over HTTP from the master's queue by the master and the
    worker."""
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    for png in master_out.glob("*.png"):
        png.unlink()
    torch.cuda.reset_peak_memory_stats()
    before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
    os.environ["CDT_TILE_MASTER_HOLDBACK_S"] = str(UPSCALE_HOLDBACK_S)
    try:
        t0 = time.perf_counter()
        status, answer = http_json(base + "/distributed/queue",
                                   {"prompt": upscale_workflow()}, timeout=120)
        require(status == 200 and answer.get("worker_count") == 1,
                f"upscale queue answered {status}: {answer}")
        entry = wait_history(base, answer["prompt_id"], t0, "upscale request")
        secs = time.perf_counter() - t0
    finally:
        del os.environ["CDT_TILE_MASTER_HOLDBACK_S"]
    require(entry["status"] == "success", f"upscale request: {entry}")
    master_peak = torch.cuda.max_memory_allocated()
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                     for k in fa.CUDA_LAUNCHES}
    status, summary = http_json(
        f"{base}/distributed/queue_status/{answer['trace_id']}_5")
    require(status == 200 and summary.get("finished"),
            f"upscale tile job status {status}: {summary}")
    owners = summary["completed_by"]
    mine = sum(1 for w in owners.values() if w == "master")
    theirs = sum(1 for w in owners.values() if w == "w0")
    require(len(owners) == UPSCALE_TILES // UPSCALE_CHUNK and mine + theirs
            == len(owners) and not summary["dead_letter"],
            f"upscale tile tasks: {summary}")
    require(theirs >= 1, "the worker submitted none of the upscale's tile "
            f"tasks over /distributed/submit_tiles: {owners}")
    per_chunk = 70 * UPSCALE_STEPS
    want = {"fused_qkv_attention": 8 + per_chunk * mine,
            "flash_attention_packed": per_chunk * mine,
            "flash_attention_bh": 0}
    require(counts == want, f"served upscale: master launches {counts} != {want}")
    want_cuda = {"qkv_projection": 8 + per_chunk * mine,
                 "flash_attention_core": per_chunk * mine,
                 "short_kv_attention": 8 + per_chunk * mine}
    require(kernel_counts == want_cuda,
            f"served upscale: master CUDA kernel launches {kernel_counts} != "
            f"{want_cuda}")
    pngs = sorted(master_out.glob("upscaled_*.png"))
    require(len(pngs) == 1, f"served upscale: {len(pngs)} PNGs, expected 1")
    got = to_uint8(decode_png(pngs[0].read_bytes()))[0]
    require(np_equal(got, up.image_u8),
            "the served upscale differs from the direct upscale")
    status, info = http_json(f"http://127.0.0.1:{worker_port}/distributed/system_info")
    worker_peak = (info["devices"][0].get("max_memory_allocated", 0)
                   if status == 200 and info.get("devices") else 0)
    say(f"  served upscale: {secs:.3f} s (POST to final history; direct "
        f"{up.seconds[0]:.3f} / {up.seconds[1]:.3f} s); tile tasks "
        f"{dict(sorted(owners.items()))} (master {mine}, worker {theirs}); "
        f"master launches {counts}; PNG bitwise equal to the direct upscale; "
        f"peak memory master {master_peak / 2**30:.3f} GiB (this request), "
        f"worker {worker_peak / 2**30:.3f} GiB (its process)")


def serve_img2img(torch, fa, base: str, master_out: Path,
                  control: ControlRun, reports: list) -> None:
    """The img2img + ControlNet graph of phase 8 through ``POST
    /distributed/queue``: ``input.png`` is already on the worker."""
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    for png in master_out.glob("*.png"):
        png.unlink()
    seed, worker_seed = I2I_SEEDS[0], I2I_SEEDS[0] + 0 + 1
    prompt = i2i_workflow()
    before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
    t0 = time.perf_counter()
    status, answer = http_json(base + "/distributed/queue",
                               {"prompt": prompt}, timeout=120)
    require(status == 200 and answer.get("worker_count") == 1,
            f"img2img queue answered {status}: {answer}")
    report = reports[-1]
    require((report.checked, report.skipped, report.uploaded, report.failed)
            == (1, 1, 0, []),
            f"served img2img: media sync {report}, expected 1 skipped")
    entry = wait_history(base, answer["prompt_id"], t0, "served img2img")
    secs = time.perf_counter() - t0
    require(entry["status"] == "success", f"served img2img: {entry}")
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                     for k in fa.CUDA_LAUNCHES}
    require(counts == I2I_CN[0],
            f"served img2img: master launches {counts} != {I2I_CN[0]}")
    require(kernel_counts == I2I_CN[1],
            f"served img2img: master CUDA kernel launches {kernel_counts} "
            f"!= {I2I_CN[1]}")
    pngs = sorted(master_out.glob("img2img_*.png"))
    require(len(pngs) == 2, f"served img2img: {len(pngs)} PNGs, expected 2")
    got = [to_uint8(decode_png(p.read_bytes()))[0] for p in pngs]
    require(np_equal(got[0], control.images[seed]),
            f"served img2img: the master's PNG differs from the direct "
            f"seed-{seed} image")
    require(np_equal(got[1], control.images[worker_seed]),
            f"served img2img: the worker's PNG differs from the direct "
            f"seed-{worker_seed} image")
    say(f"  served img2img + ControlNet: {secs:.3f} s (POST to final "
        f"history; direct {control.seconds[0]:.3f} / {control.seconds[1]:.3f}"
        f" s); media sync {report}; master launches {counts}; PNG 0 "
        f"bitwise equal to direct seed {seed}, PNG 1 to direct seed "
        f"{worker_seed}")


def serve_cn_tile(torch, fa, base: str, master_out: Path, cn_tile: CnTileRun,
                  reports: list) -> None:
    """The ControlNet tile upscale through ``POST /distributed/queue``:
    ``input.png`` is already on the worker; the tiles are pulled from the
    master's queue by both, each building the hint from its own graph."""
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    for png in master_out.glob("*.png"):
        png.unlink()
    before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
    os.environ["CDT_TILE_MASTER_HOLDBACK_S"] = str(UPSCALE_HOLDBACK_S)
    try:
        t0 = time.perf_counter()
        status, answer = http_json(base + "/distributed/queue",
                                   {"prompt": cn_tile_workflow()}, timeout=120)
        require(status == 200 and answer.get("worker_count") == 1,
                f"ControlNet tile queue answered {status}: {answer}")
        report = reports[-1]
        require((report.checked, report.skipped, report.uploaded, report.failed)
                == (1, 1, 0, []),
                f"served ControlNet tile: media sync {report}, expected 1 "
                "skipped")
        entry = wait_history(base, answer["prompt_id"], t0,
                             "served ControlNet tile upscale")
        secs = time.perf_counter() - t0
    finally:
        del os.environ["CDT_TILE_MASTER_HOLDBACK_S"]
    require(entry["status"] == "success", f"served ControlNet tile: {entry}")
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                     for k in fa.CUDA_LAUNCHES}
    status, summary = http_json(
        f"{base}/distributed/queue_status/{answer['trace_id']}_5")
    require(status == 200 and summary.get("finished"),
            f"ControlNet tile job status {status}: {summary}")
    owners = summary["completed_by"]
    mine = sum(1 for w in owners.values() if w == "master")
    theirs = sum(1 for w in owners.values() if w == "w0")
    require(len(owners) == CN_TILE_CHUNKS and mine + theirs == len(owners)
            and not summary["dead_letter"],
            f"ControlNet tile tasks: {summary}")
    require(theirs >= 1, "the worker submitted none of the ControlNet tile "
            f"upscale's tasks over /distributed/submit_tiles: {owners}")
    want = k3_counts(CN_TILE_STEPS * mine, [
        (shape, n // CN_TILE_FORWARDS) for shape, n in CN_TILE_SHAPES])
    require(counts == want[0],
            f"served ControlNet tile: master launches {counts} != {want[0]}")
    require(kernel_counts == want[1],
            f"served ControlNet tile: master CUDA kernel launches "
            f"{kernel_counts} != {want[1]}")
    pngs = sorted(master_out.glob("cn_upscaled_*.png"))
    require(len(pngs) == 1, f"served ControlNet tile: {len(pngs)} PNGs, "
            "expected 1")
    got = to_uint8(decode_png(pngs[0].read_bytes()))[0]
    require(np_equal(got, cn_tile.image_u8),
            "the served ControlNet tile upscale differs from the direct one")
    say(f"  served ControlNet tile upscale: {secs:.3f} s (POST to final "
        f"history; direct {cn_tile.seconds[0]:.3f} / {cn_tile.seconds[1]:.3f} "
        f"s); media sync {report}; tile tasks {dict(sorted(owners.items()))} "
        f"(master {mine}, worker {theirs}); master launches {counts}; PNG "
        "bitwise equal to the direct run")


def serve_audio(torch, fa, base: str, master, master_out: Path,
                input_dir: Path, reports: list) -> None:
    """``workflows/distributed-audio.json`` through ``POST
    /distributed/queue``: ``clip.wav`` is synced to the worker, whose clip
    comes back on the count-0 envelope (``DistributedEmptyImage`` feeds
    its images) and is joined after the master's; then the workflow cut
    after the collector, whose joined AUDIO the history summarises."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.utils.audio_payload import (wav_bytes,
                                                                   wav_decode)

    samples = AUDIO_SECONDS * AUDIO_RATE
    # the joined clip is the master's then the worker's: its halves are
    # each whole clip.wav through the codec
    clip = wav_decode((input_dir / "clip.wav").read_bytes())["waveform"][0]
    want = wav_bytes(clip, AUDIO_RATE)
    envelopes = []
    put = master.store.put_collector_result

    async def recording_put(job_id, envelope, *a, **kw):
        envelopes.append((envelope.get("worker_id"), envelope.get("batch_idx"),
                          len(json.dumps(envelope)) if envelope.get("audio")
                          else 0))
        return await put(job_id, envelope, *a, **kw)

    for wav in master_out.glob("*.wav"):
        wav.unlink()
    with mock.patch.object(master.store, "put_collector_result", recording_put):
        t0 = time.perf_counter()
        status, answer = http_json(base + "/distributed/queue",
                                   {"prompt": audio_workflow()}, timeout=120)
        require(status == 200 and answer.get("worker_count") == 1,
                f"audio queue answered {status}: {answer}")
        report = reports[-1]
        require((report.checked, report.uploaded, report.failed) == (1, 1, []),
                f"served audio: media sync {report}, expected 1 uploaded")
        entry = wait_history(base, answer["prompt_id"], t0, "served audio")
        secs = time.perf_counter() - t0
        require(entry["status"] == "success", f"served audio: {entry}")
        got = [(master_out / name).read_bytes() for name in CHUNK_WAVS]
        require(got == [want, want], "served audio: chunk_a is not the "
                "master's clip or chunk_b not the worker's")
        require([e[:2] for e in envelopes] == [("w0", -1)] and envelopes[0][2],
                f"served audio: the master received {envelopes}, expected one "
                "count-0 envelope from w0 with its audio")
        say(f"  served distributed-audio.json: {secs:.3f} s (POST to final "
            f"history); media sync {report}; the worker's clip on its count-0 "
            f"envelope, {envelopes[0][2]} bytes of JSON; chunk_a bitwise the "
            f"master's clip and chunk_b the worker's ({samples} samples each)")
        cut = {k: v for k, v in audio_workflow().items() if k in ("1", "2", "3")}
        t0 = time.perf_counter()
        status, answer = http_json(base + "/distributed/queue",
                                   {"prompt": cut}, timeout=120)
        require(status == 200 and answer.get("worker_count") == 1,
                f"audio (cut) queue answered {status}: {answer}")
        entry = wait_history(base, answer["prompt_id"], t0, "served audio (cut)")
    require(entry["status"] == "success", f"served audio (cut): {entry}")
    summary = entry["outputs"]["3"][1]
    require(summary == {"audio": {"shape": [1, AUDIO_CHANNELS, 2 * samples],
                                  "sample_rate": AUDIO_RATE}},
            f"served audio: history summarises the joined clip as {summary}")
    say(f"  served audio cut after the collector: {time.perf_counter() - t0:.3f}"
        f" s; /distributed/history summarises the joined clip as {summary}; "
        f"media sync {reports[-1]}")


def serve_video(torch, fa, base: str, master_out: Path, video: VideoRun,
                reports: list) -> dict:
    """``workflows/video-upscale.json`` on the first 8 frames through
    ``POST /distributed/queue``: ``input.avi`` is synced to the worker; a
    batch of 8 frames is farmed frame by frame (the dynamic mode), each
    task one frame's USDU seeded seed + its index; the master's frames
    must equal each of its input frames upscaled alone that way. Returns
    the master's launches."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.graph.node import NODE_REGISTRY
    from comfyui_distributed_tpu_torch.tiles.engine import TileUpscaler
    from comfyui_distributed_tpu_torch.utils.video_io import load_video

    usdu = NODE_REGISTRY["UltimateSDUpscaleDistributed"]
    inner = usdu.execute
    seen = {}

    def capturing(self, image, model, positive, negative, *a, **kw):
        out = inner(self, image, model, positive, negative, *a, **kw)
        if not kw.get("is_worker"):
            seen.update(image=image, model=model, positive=positive,
                        negative=negative, out=out[0])
        return out

    for avi in master_out.glob("*.avi"):
        avi.unlink()
    before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
    os.environ["CDT_TILE_MASTER_HOLDBACK_S"] = str(UPSCALE_HOLDBACK_S)
    try:
        with mock.patch.object(usdu, "execute", capturing):
            t0 = time.perf_counter()
            status, answer = http_json(
                base + "/distributed/queue",
                {"prompt": video_workflow(VIDEO_SERVED_FRAMES)}, timeout=120)
            require(status == 200 and answer.get("worker_count") == 1,
                    f"video queue answered {status}: {answer}")
            report = reports[-1]
            require((report.checked, report.uploaded, report.failed)
                    == (1, 1, []),
                    f"served video: media sync {report}, expected 1 uploaded")
            entry = wait_history(base, answer["prompt_id"], t0, "served video")
            secs = time.perf_counter() - t0
    finally:
        del os.environ["CDT_TILE_MASTER_HOLDBACK_S"]
    require(entry["status"] == "success", f"served video: {entry}")
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    kernel_counts = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k]
                     for k in fa.CUDA_LAUNCHES}
    status, summary = http_json(
        f"{base}/distributed/queue_status/{answer['trace_id']}_5")
    require(status == 200 and summary.get("finished"),
            f"video frame job status {status}: {summary}")
    owners = summary["completed_by"]
    mine = sum(1 for w in owners.values() if w == "master")
    theirs = sum(1 for w in owners.values() if w == "w0")
    require(len(owners) == VIDEO_SERVED_FRAMES and mine + theirs == len(owners)
            and not summary["dead_letter"], f"video frame tasks: {summary}")
    require(theirs >= 1, f"the worker ran none of the video's frames: {owners}")
    want = video_counts(mine)
    require(counts == want[0],
            f"served video: master launches {counts} != {want[0]}")
    require(kernel_counts == want[1],
            f"served video: master CUDA kernel launches {kernel_counts} != "
            f"{want[1]}")
    launches = counts
    # each frame as one upscale of its own at seed + index (its launches
    # are not the served request's)
    frames, images = seen["out"], seen["image"]
    require(tuple(frames.shape) == (VIDEO_SERVED_FRAMES, *VIDEO_OUT_HW, 3),
            f"served video: the master's frames {tuple(frames.shape)}")
    upscaler = TileUpscaler(seen["model"].pipeline)
    ctx, unc = seen["positive"]["context"], seen["negative"]["context"]
    for i in range(VIDEO_SERVED_FRAMES):
        alone = upscaler.upscale(images[i:i + 1], video_spec(), VIDEO_SEED + i,
                                 ctx, unc)
        require(torch.equal(frames[i:i + 1], alone),
                f"served video: frame {i} differs from its own upscale at "
                f"seed {VIDEO_SEED + i}")
    esr = (images - video.upscaled).abs().max().item()
    path = master_out / VIDEO_AVI
    back = load_video(path)
    span = round(VIDEO_SERVED_FRAMES / VIDEO_FPS * AUDIO_RATE)
    require(back["frames"].shape == (VIDEO_SERVED_FRAMES, *VIDEO_OUT_HW, 3)
            and back["fps"] == VIDEO_FPS and back["audio"] is not None
            and tuple(back["audio"]["waveform"].shape) == (1, AUDIO_CHANNELS,
                                                            span),
            f"served video: {path} read back as {back['frames'].shape} at "
            f"{back['fps']} fps")
    say(f"  served video-upscale.json ({VIDEO_SERVED_FRAMES} frames, "
        f"frame_load_cap): {secs:.3f} s (POST to final history; the direct "
        f"run of {VIDEO_FRAMES} frames {video.seconds:.3f} s); media sync "
        f"{report}; frame tasks {dict(sorted(owners.items()))} (master {mine}, "
        f"worker {theirs}); master launches {counts}; every master frame "
        f"bitwise its own upscale at seed {VIDEO_SEED} + index; the master's "
        f"ESRGAN frames within {esr:.3g} of the direct run's (batch 8 vs 24); "
        f"{VIDEO_AVI} read back as {VIDEO_SERVED_FRAMES} frames at "
        f"{back['fps']:g} fps with {span} samples of audio")
    return launches


# --- phases 15 to 19 ---------------------------------------------------------

DEVICE = "cuda"
CKPT_SEED = 11               # the source bundles' seed (not the registry's 0)
CKPT_HW = 1024               # the txt2img workflow's size
VOCAB_SIZE = 49408           # CLIP's: <|startoftext|> 49406, <|endoftext|> 49407
LORA_NAME = "synthetic-sdxl"
LORA_RANK, LORA_ALPHA = 8, 8.0
LORA_UP_STD = 0.1 / LORA_RANK ** 0.5   # ΔW about a tenth of W
# per SDXL request from a checkpoint: the CLIP stack launches nothing, so
# K1 and K2 are the UNet's 70 sites × 30 calls (60 at 1024 tokens)
CKPT_SDXL = ({"fused_qkv_attention": sum(n for _, n in FUSED_SHAPES[:2]),
              "flash_attention_packed": sum(n for _, n in PACKED_SHAPES),
              "flash_attention_bh": 0},
             cuda_counts(FUSED_SHAPES[:2], PACKED_SHAPES))
# 70 transformer blocks × (attn1, attn2: 4 each; ff: 2) + 11 × proj_in/out
LORA_UNET_TENSORS = 70 * 10 + 11 * 2
LORA_TE_TENSORS = (12 + 32) * 6      # q/k/v/out_proj, fc1, fc2 a layer
CKPT_SD15_SEED = 5
# a published SD 1.5 file: 30 K3 a UNet call and the middle's 2: 8 × 32
CKPT_SD15 = k3_counts(SD15_STEPS, SD15_SHAPES + SD15_MID_SHAPES,
                      text_prompts=0)


def source_bundle(torch, preset: str, middle_depth: int = -1):
    """A ``preset`` bundle at full width with its CLIP stack (and the
    UNet middle depth ``middle_depth`` where it is set), random from
    ``CKPT_SEED`` and rounded through fp16 once (so an F16 file holds it
    exactly); returns (bundle, host copy of every parameter)."""
    import dataclasses

    from comfyui_distributed_tpu_torch.models.registry import (PRESETS,
                                                               ModelBundle)

    preset = PRESETS[preset]
    if middle_depth >= 0:
        preset = dataclasses.replace(preset, unet=dataclasses.replace(
            preset.unet, middle_depth=middle_depth))
    bundle = ModelBundle(preset, DEVICE, seed=CKPT_SEED)
    bundle.build_clip_stack()
    return bundle, round_fp16(torch, {
        f"{entry}.{name}": p for entry, module in bundle._state_entries().items()
        for name, p in module.named_parameters()})


def round_fp16(torch, params: dict) -> dict:
    """Round each parameter through fp16 in place; its host copy."""
    with torch.no_grad():
        for p in params.values():
            p.copy_(p.to(torch.float16).to(p.dtype))
    return {k: p.detach().cpu() for k, p in params.items()}


def require_params_equal(torch, what: str, params: dict, host: dict) -> None:
    require(set(params) == set(host),
            f"{what}: parameter names differ: {sorted(set(params) ^ set(host))[:4]}")
    bad = [k for k, p in params.items() if not torch.equal(p.detach().cpu(), host[k])]
    require(not bad, f"{what}: {len(bad)} parameters differ, e.g. {bad[:4]}")
    say(f"  {what}: all {len(params)} parameters "
        f"({sum(t.numel() for t in host.values())} values) bitwise equal to "
        f"the source's")


def bundle_params(bundle) -> dict:
    return {f"{entry}.{name}": p
            for entry, module in bundle._state_entries().items()
            for name, p in module.named_parameters()}


def write_vocab(directory: Path) -> None:
    """A synthetic CLIP BPE vocabulary at CLIP's size: the 512 byte units
    (bare and with ``</w>``), merges that build the workflows' words,
    filler merges up to 49 406 entries, then the two specials."""
    from comfyui_distributed_tpu_torch.models.tokenizer import (
        EOT, SOT, bytes_to_unicode)

    units = list(bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    merges = []

    def add(a: str, b: str) -> None:
        if a + b not in vocab and len(vocab) < VOCAB_SIZE - 2:
            merges.append((a, b))
            vocab[a + b] = len(vocab)

    words = ("a cinematic photo of lighthouse at dawn crashing waves blurry low "
             "quality watermark on cliff dusk oil painting").split()
    for w in words:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            add(parts[0], parts[1])
            parts = [parts[0] + parts[1]] + parts[2:]
    for a in units:
        for b in units:
            add(a, b + "</w>")
    vocab[SOT], vocab[EOT] = VOCAB_SIZE - 2, VOCAB_SIZE - 1
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "vocab.json").write_text(json.dumps(vocab))
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def write_checkpoint(torch, bundle, path: Path) -> float:
    """``bundle`` in the published single-file layout, F16; seconds."""
    from comfyui_distributed_tpu_torch.models.convert import export_checkpoint
    from comfyui_distributed_tpu_torch.utils.safetensors import save_file

    t0 = time.perf_counter()
    nbytes = save_file(export_checkpoint(bundle), path, dtype=torch.float16)
    secs = time.perf_counter() - t0
    say(f"  wrote {path.name}: {nbytes / 1e9:.3f} GB in {secs:.2f} s "
        f"({nbytes / 1e9 / secs:.2f} GB/s)")
    return secs


class CkptRun(NamedTuple):
    registry: object        # file-backed, holding the converted sdxl bundle
    image: object           # the seed-7 image from the file
    launches: dict


def adopt(registry, name: str, bundle) -> None:
    """Serve ``bundle`` under ``name`` from ``registry`` (the source
    bundles of these phases are built outside any registry)."""
    registry._cache[name] = bundle


def ckpt_sdxl_phase(torch, fa, tmp: Path) -> CkptRun:
    """Phases 15 and 16: write ``sdxl.safetensors`` from a source bundle and
    a CLIP vocabulary, then run ``workflows/distributed-txt2img.json`` from
    the file on a fresh registry."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    say("checkpoint sdxl: write")
    t0 = time.perf_counter()
    write_vocab(tmp / "tokenizer")
    os.environ["CDT_TOKENIZER_DIR"] = str(tmp / "tokenizer")
    say(f"  vocabulary: {VOCAB_SIZE} entries in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    source, host = source_bundle(torch, "sdxl")
    torch.cuda.synchronize()
    parts = {entry: sum(p.numel() for p in m.parameters())
             for entry, m in source._state_entries().items()}
    say(f"  source bundle (seed {CKPT_SEED}) built and rounded through fp16 "
        f"in {time.perf_counter() - t0:.2f} s: {parts}")
    write_checkpoint(torch, source, tmp / "sdxl.safetensors")

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / SDXL_PATH.workflow).read_text()))
    hw = (CKPT_HW, CKPT_HW)

    def request(executor, seed: int, what: str):
        prompt = json.loads(json.dumps(workflow))
        prompt[SDXL_PATH.seed_node]["inputs"]["seed"] = seed
        return run_counted(torch, fa, executor, prompt, SDXL_PATH.image_node,
                           CKPT_SDXL, what, hw)

    src_registry = ModelRegistry(DEVICE, seed=0)
    adopt(src_registry, "sdxl", source)
    require(source.text_encoder.tokenization_mode == "bpe",
            "the source stack did not load the vocabulary")
    # (the request's node outputs, which hold the bundle, are dropped)
    ref, secs = request(GraphExecutor({"model_registry": src_registry,
                                       "output_dir": str(tmp / "out")}),
                        7, "sdxl source seed 7")[:2]
    say(f"  source seed-7 request: {secs:.3f} s")
    ref = ref.cpu()
    del source, src_registry
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  source released: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        "allocated")

    say("checkpoint sdxl: convert and run from the file")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    registry = ModelRegistry(DEVICE, seed=0, checkpoint_root=tmp)
    t0 = time.perf_counter()
    bundle = registry.get("sdxl")
    torch.cuda.synchronize()
    say(f"  converted sdxl.safetensors in {time.perf_counter() - t0:.2f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB ({(torch.cuda.memory_allocated() - before) / 2**30:.3f} GiB "
        f"held)")
    require_params_equal(torch, "converted sdxl", bundle_params(bundle), host)
    del host
    mode = bundle.text_encoder.tokenization_mode
    require(mode == "bpe", f"tokenization mode {mode}")
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(OUTPUT_DIR / "ckpt")})
    fa.reset_launches()
    images, seconds = [], []
    for seed in SDXL_PATH.seeds:
        img, secs, _ = request(executor, seed, f"sdxl from file seed {seed}")
        images.append(img)
        seconds.append(secs)
    launches = dict(fa.LAUNCHES)
    require(torch.equal(images[0].cpu(), ref),
            "the seed-7 image from the file differs from the source's")
    require(torch.equal(images[0], images[2]), "seed 7 twice differs")
    require(not torch.equal(images[0], images[1]), "seeds 7 and 8 gave one image")
    say(f"  requests {[round(s, 3) for s in seconds]} s; launches "
        f"{CKPT_SDXL[0]} a request (CUDA {CKPT_SDXL[1]}); tokenizer {mode}; "
        f"seed 7 bitwise equal to the source bundle's, repeatable; seed 8 "
        f"differs; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return CkptRun(registry, images[0], launches)


def write_lora(torch, bundle, path: Path) -> None:
    """A kohya SDXL LoRA (rank 8, alpha 8) over every UNet attention
    projection, ``ff`` and ``proj_in``/``proj_out``, and every CLIP-L and
    CLIP-G attention and MLP Linear (``lora_te1_``/``lora_te2_``), written
    from the converter's own records."""
    from comfyui_distributed_tpu_torch.models.convert import linear_proj_of
    from comfyui_distributed_tpu_torch.models.lora import (clip_hf_records,
                                                           unet_records)
    from comfyui_distributed_tpu_torch.utils.safetensors import save_file

    dev = bundle.device
    gen = torch.Generator(device=dev).manual_seed(CKPT_SEED)
    cfg = bundle.preset.unet
    sites = [(r, "lora_unet_", "model.diffusion_model.", bundle.core)
             for r in unet_records(cfg, linear_proj_of(cfg))
             if r[0].endswith(".weight") and any(
                 s in r[0] for s in (".to_q.", ".to_k.", ".to_v.",
                                     ".to_out.0.", ".ff.net.", ".proj_in.",
                                     ".proj_out."))]
    for prefix, enc in (("lora_te1_", bundle.clip_stack.clip_l),
                        ("lora_te2_", bundle.clip_stack.clip_g)):
        sites += [(r, prefix + "text_model_", "text_model.", enc)
                  for r in clip_hf_records(enc.config)
                  if r[0].endswith(".weight") and ("_proj." in r[0]
                                                   or ".mlp." in r[0])]
    out = {}
    for (src, dst, _), prefix, conv_prefix, module in sites:
        w = module.get_parameter(dst)
        n_out, n_in = w.shape[0], w[0].numel()
        key = prefix + src[len(conv_prefix):-len(".weight")].replace(".", "_")
        out[f"{key}.lora_down.weight"] = torch.randn(
            LORA_RANK, n_in, generator=gen, device=dev) / n_in ** 0.5
        out[f"{key}.lora_up.weight"] = torch.randn(
            n_out, LORA_RANK, generator=gen, device=dev) * LORA_UP_STD
        out[f"{key}.alpha"] = torch.tensor(LORA_ALPHA)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_file(out, path, dtype=torch.float16)
    say(f"  wrote {path.name}: {len(sites)} LoRA pairs "
        f"({path.stat().st_size / 1e6:.1f} MB)")


def lora_workflow(seed: int, strength_model: float, strength_clip: float,
                  lora: bool = True) -> dict:
    """``CheckpointLoader sdxl`` → ``LoraLoader`` → two ``CLIPTextEncode``
    → ``TPUTxt2Img`` at 1024² (the txt2img workflow's spec)."""
    model, clip = (["9", 0], ["9", 1]) if lora else (["1", 0], ["1", 1])
    prompt = {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": "sdxl"}},
        "2": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "a cinematic photo of a lighthouse at dawn, crashing waves",
            "clip": clip}},
        "3": {"class_type": "CLIPTextEncode", "inputs": {
            "text": "blurry, low quality, watermark", "clip": clip}},
        "5": {"class_type": "TPUTxt2Img", "inputs": {
            "model": model, "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": STEPS, "cfg": 6.0, "width": CKPT_HW,
            "height": CKPT_HW, "sampler_name": "euler", "scheduler": "karras"}},
    }
    if lora:
        prompt["9"] = {"class_type": "LoraLoader", "inputs": {
            "model": ["1", 0], "clip": ["1", 1], "lora_name": LORA_NAME,
            "strength_model": strength_model, "strength_clip": strength_clip}}
    return prompt


def ckpt_lora_phase(torch, fa, ckpt: CkptRun, tmp: Path) -> dict:
    """Phase 17: a synthetic LoRA through ``LoraLoader`` on the converted
    bundle: it changes the image, strength 0/0 is the base image, the
    base bundle is untouched, the launches are the base request's, and a
    merged UNet forward holds against the plain attention versions."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.node import get_node

    say("checkpoint sdxl: LoRA")
    bundle = ckpt.registry.get("sdxl")
    write_lora(torch, bundle, tmp / "loras" / f"{LORA_NAME}.safetensors")
    os.environ["CDT_LORA_DIR"] = str(tmp / "loras")
    base_params = {k: p for k, p in bundle_params(bundle).items()}
    executor = GraphExecutor({"model_registry": ckpt.registry,
                              "output_dir": str(OUTPUT_DIR / "ckpt")})
    hw = (CKPT_HW, CKPT_HW)
    fa.reset_launches()
    t0 = time.perf_counter()
    lora_img, secs, out = run_counted(torch, fa, executor,
                                      lora_workflow(7, 1.0, 1.0), "5",
                                      CKPT_SDXL, "LoRA at 1/1", hw)
    patched = out["9"][0]
    say(f"  LoRA request (merge included): {secs:.3f} s; merged "
        f"{patched.lora_merged} (UNet, text-encoder tensors, keys unmatched)")
    require(patched.lora_merged == (LORA_UNET_TENSORS, LORA_TE_TENSORS, 0),
            f"merged {patched.lora_merged}, expected "
            f"{(LORA_UNET_TENSORS, LORA_TE_TENSORS, 0)}")
    require(not torch.equal(lora_img, ckpt.image), "the LoRA changed nothing")
    again, secs2, _ = run_counted(torch, fa, executor,
                                  lora_workflow(7, 1.0, 1.0), "5", CKPT_SDXL,
                                  "LoRA at 1/1 again (cached merge)", hw)
    require(torch.equal(again, lora_img), "the LoRA image is not repeatable")
    zero, _, out0 = run_counted(torch, fa, executor, lora_workflow(7, 0.0, 0.0),
                                "5", CKPT_SDXL, "LoRA at 0/0", hw)
    require(out0["9"][0] is bundle, "strength 0/0 did not return the base model")
    require(torch.equal(zero, ckpt.image), "strength 0/0 changed the image")
    base, _, _ = run_counted(torch, fa, executor,
                             lora_workflow(7, 1.0, 1.0, lora=False), "5",
                             CKPT_SDXL, "base after the LoRA", hw)
    require(torch.equal(base, ckpt.image),
            "the base bundle's image changed after the LoRA")
    require(all(p is base_params[k] for k, p in bundle_params(bundle).items()),
            "the base bundle's parameters were replaced")
    say(f"  LoRA image differs from the base; cached repeat {secs2:.3f} s, "
        f"bitwise equal; strength 0/0 and the base bundle's next image "
        f"bitwise the base image; launches {CKPT_SDXL[0]} a request")
    launches = dict(fa.LAUNCHES)
    # one merged UNet forward at a 512² latent, kernels vs plain attention
    unet = patched.pipeline.unet
    cfg = unet.config
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(2, 64, 64, cfg.in_channels, generator=gen, device=dev)
    t = torch.tensor([500.0, 500.0], device=dev)
    ctx, pooled = patched.text_encoder.encode(["a lighthouse", ""])
    y = torch.nn.functional.pad(pooled, (0, cfg.adm_in_channels - pooled.shape[-1]))
    with torch.no_grad():
        eps = unet(x, t, ctx, y)
        sa, fu = plain_attention_patches(fa)
        with sa, fu:
            ref = unet(x, t, ctx, y)
    compare_whole(torch, "LoRA-merged UNet eps at 512²", eps, ref)
    get_node("LoraLoader")._cache.clear()
    return launches


def ckpt_sd15_phase(torch, fa, tmp: Path) -> dict:
    """Phase 18: an sd15 file converted by ``python -m
    comfyui_distributed_tpu_torch convert`` in a subprocess on the card,
    restored through a registry and run."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import (MANIFEST,
                                                               ModelRegistry)

    say("checkpoint sd15: write, convert, restore")
    # the published layout: a middle transformer the sd15 preset lacks
    source, host = source_bundle(torch, "sd15", middle_depth=1)
    write_checkpoint(torch, source, tmp / "sd15.safetensors")
    src_registry = ModelRegistry(DEVICE, seed=0)
    adopt(src_registry, "sd15", source)
    hw = (SD15_HW, SD15_HW)
    workflow = sd15_workflow("euler", CKPT_SD15_SEED)
    ref = run_counted(
        torch, fa, GraphExecutor({"model_registry": src_registry,
                                  "output_dir": str(tmp / "out")}),
        workflow, "4", CKPT_SD15, "sd15 source", hw)[0].cpu()
    del source, src_registry
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  source released: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        "allocated")
    out_dir = tmp / "root15" / "sd15"
    cmd = [sys.executable, "-m", "comfyui_distributed_tpu_torch", "convert",
           "--preset", "sd15", "--checkpoint", str(tmp / "sd15.safetensors"),
           "--out", str(out_dir), "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
    require(proc.returncode == 0, f"convert exited {proc.returncode}")
    say(f"  convert subprocess: {secs:.2f} s (process start included); "
        f"{proc.stdout.strip().splitlines()[-1]}")
    manifest = json.loads((out_dir / MANIFEST).read_text())
    require(manifest["arch"] == {"kind": "unet", "middle_depth": 1}
            and manifest["format"] == "torch", f"manifest {manifest}")
    registry = ModelRegistry(DEVICE, seed=0, checkpoint_root=out_dir.parent)
    t0 = time.perf_counter()
    bundle = registry.get("sd15")
    torch.cuda.synchronize()
    say(f"  restored {out_dir} in {time.perf_counter() - t0:.2f} s "
        f"({(out_dir / 'state.pt').stat().st_size / 1e9:.3f} GB); manifest "
        f"{manifest}")
    require(bundle.core.config.mid_depth == 1,
            "the restored sd15 core has no middle transformer")
    require_params_equal(torch, "restored sd15", bundle_params(bundle), host)
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(OUTPUT_DIR / "ckpt")})
    fa.reset_launches()
    img, secs, _ = run_counted(torch, fa, executor, workflow, "4", CKPT_SD15,
                               "sd15 restored", hw)
    require(torch.equal(img.cpu(), ref),
            "the restored sd15 image differs from the source's")
    say(f"  restored request: {secs:.3f} s, bitwise equal to the source's; "
        f"launches {CKPT_SD15[0]} (CUDA {CKPT_SD15[1]})")
    return dict(fa.LAUNCHES)


def ckpt_models_phase(torch, tmp: Path) -> None:
    """Phase 19: an ``esrgan-x4`` RRDBNet file and an sd15 ControlNet file
    through ``UpscaleModelLoader`` and ``ControlNetLoader``."""
    from comfyui_distributed_tpu_torch.graph.node import get_node
    from comfyui_distributed_tpu_torch.models.controlnet import init_controlnet
    from comfyui_distributed_tpu_torch.models.convert import (
        export_controlnet, export_upscaler)
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.models.unet import UNetConfig
    from comfyui_distributed_tpu_torch.utils.safetensors import save_file

    say("checkpoint files: upscaler and ControlNet")
    dev = torch.device(DEVICE)
    esrgan = ModelRegistry(dev, seed=CKPT_SEED).get_upscaler("esrgan-x4").model
    cn = init_controlnet(UNetConfig.sd15(), dev, CKPT_SEED, name="src").model
    hosts = {}
    for what, module, export, sub in (
            ("upscaler", esrgan, export_upscaler, "upscalers"),
            ("controlnet", cn, export_controlnet, "controlnet")):
        hosts[what] = round_fp16(torch, dict(module.named_parameters()))
        (tmp / sub).mkdir(parents=True, exist_ok=True)
        save_file(export(module), tmp / sub / "synthetic.safetensors",
                  dtype=torch.float16)
    registry = ModelRegistry(dev, seed=0, checkpoint_root=tmp)
    (up,) = get_node("UpscaleModelLoader")().execute(
        "synthetic", model_registry=registry)
    (cnb,) = get_node("ControlNetLoader")().execute(
        "synthetic", model_registry=registry)
    require_params_equal(torch, "upscaler from file",
                         dict(up.model.named_parameters()), hosts["upscaler"])
    require_params_equal(torch, "controlnet from file",
                         dict(cnb.model.named_parameters()), hosts["controlnet"])
    gen = torch.Generator(device=dev).manual_seed(9)
    image = torch.rand(1, 64, 64, 3, generator=gen, device=dev)
    x = torch.randn(2, 64, 64, 4, generator=gen, device=dev)
    t = torch.tensor([300.0, 300.0], device=dev)
    ctx = torch.randn(2, 77, 768, generator=gen, device=dev)
    hint = torch.rand(2, 512, 512, 3, generator=gen, device=dev)
    with torch.no_grad():
        require(torch.equal(up.model(image), esrgan(image)),
                "the upscaler from the file computes other values")
        down, mid = cnb.model(x, t, ctx, None, hint)
        sdown, smid = cn(x, t, ctx, None, hint)
    require(all(torch.equal(a, b) for a, b in zip(down + [mid], sdown + [smid])),
            "the ControlNet from the file computes other residuals")
    say(f"  upscaler x{up.scale} and ControlNet ({cnb.model.config.context_dim}"
        f"-ctx) forwards bitwise equal to the source modules'")


# --- phases 22 to 24 ---------------------------------------------------------

T5_PIECES = 32100            # t5-v1_1: <pad> 0, </s> 1, <unk> 2, 100 <extra_id_N>
T5_SEED = 13                 # the T5-XXL and CLIP-L drawn for the files
FLUX_FILE_DIR = OUTPUT_DIR / "flux_file"
FLUX_FILE = ({"fused_qkv_attention": 0, "flash_attention_packed": 0,
              "flash_attention_bh": sum(n for _, n in FILE_BH_SHAPES)},  # 1596
             # projection 0, streamed core 1596, short-key 0
             cuda_counts([], FILE_BH_SHAPES))
# The whole run keeps its disk writes (deleted files included) under
# 45 GiB, ~13 GB of them before these phases. So the full-depth files go
# in F8_E4M3 (11.9 + 4.9 GB) and are loaded with the calls `convert`
# makes, and `convert` itself and the restore of its state.pt run on
# files cut in depth (2 double + 4 single blocks, 2 T5 layers: 3.3 GB of
# files, a 5.4 GB state.pt). Full depth, its state.pt alone is 43.6 GB.
FLUX_CUT = (2, 4)
T5_CUT = 2
FLUX_CUT_SHAPES = [(FILE_BH_SHAPES[0][0], FLUX_STEPS * sum(FLUX_CUT))]
FLUX_CUT_COUNTS = ({"fused_qkv_attention": 0, "flash_attention_packed": 0,
                    "flash_attention_bh": FLUX_STEPS * sum(FLUX_CUT)},   # 168
                   cuda_counts([], FLUX_CUT_SHAPES))
FLUX_FILE_DISK = 30e9        # the files and the state.pt, with room to spare


def write_t5_tokenizer(directory: Path, words) -> None:
    """A synthetic T5 ``tokenizer.json`` at t5-v1_1's size: 32 100 pieces
    (the three specials, ``▁``, the characters and ``▁word`` pieces of
    ``words``, filler pieces, then ``<extra_id_99>`` … ``<extra_id_0>``
    as added tokens), seeded scores, a ``Precompiled`` charsmap written by
    the port's ``encode_charsmap`` (fullwidth ASCII and NBSP), the
    ``Replace(" {2,}", " ")`` normalizer, ``Metaspace`` and ``$A </s>``."""
    import base64
    import random

    from comfyui_distributed_tpu_torch.models.t5_tokenizer import encode_charsmap

    rng = random.Random(T5_SEED)
    pieces = ["▁"] + sorted(set("".join(words))) + [f"▁{w}" for w in words]
    pieces += [f"▁p{i}" for i in range(T5_PIECES - 100 - 3 - len(pieces))]
    extra = [f"<extra_id_{i}>" for i in range(99, -1, -1)]
    vocab = ([["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
             + [[p, -rng.uniform(1.0, 15.0)] for p in pieces]
             + [[e, 0.0] for e in extra])
    assert len(vocab) == T5_PIECES
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, c in [(0, "<pad>"), (1, "</s>"), (2, "<unk>")]
             + [(T5_PIECES - 100 + j, e) for j, e in enumerate(extra)]]
    charsmap = {chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}
    charsmap["\u00a0"] = " "
    spec = {
        "version": "1.0", "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
                encode_charsmap(charsmap)).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                        "tokens": ["</s>"]}}},
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab,
                  "byte_fallback": False},
    }
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "tokenizer.json").write_text(json.dumps(spec),
                                              encoding="utf-8")


def param_digests(torch, params: dict) -> dict:
    """A digest of each parameter's bytes, computed on the card: its
    dtype, shape, and two 64-bit sums of its 8/16/32-bit words (plain,
    and weighted by a hash of the word's position)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    sums = []
    for p in params.values():
        w = p.detach().reshape(-1).view(ints[p.element_size()])
        plain = torch.zeros((), dtype=torch.int64, device=w.device)
        mixed = torch.zeros((), dtype=torch.int64, device=w.device)
        for start in range(0, w.numel(), 1 << 26):
            chunk = w[start:start + (1 << 26)].long()
            pos = torch.arange(start, start + chunk.numel(), device=w.device)
            plain += chunk.sum()
            mixed += (chunk * ((pos * 2654435761) % 2147483647 + 1)).sum()
        sums.append(torch.stack([plain, mixed]))
    values = torch.stack(sums).tolist()
    return {k: (str(p.dtype), tuple(p.shape), tuple(v))
            for (k, p), v in zip(params.items(), values)}


def as_published_flux(torch, bundle) -> None:
    """What the BFL files hold of a random-init FLUX bundle: the DiT
    rounded through BF16 (its fp32 ``img_out`` and qk-norm scales too),
    the final adaLN's gate third zero (the layout has none; the final
    layer never reads it), the VAE's post-quant conv the identity."""
    dit, dec = bundle.core, bundle.pipeline.vae.decoder
    h, z = dit.config.hidden, bundle.pipeline.vae.config.latent_channels
    with torch.no_grad():
        for p in dit.parameters():
            p.copy_(p.to(torch.bfloat16))
        dit.final_mod.mod.weight[2 * h:].zero_()
        dit.final_mod.mod.bias[2 * h:].zero_()
        dec.post_quant_conv.weight.copy_(
            torch.eye(z, device=dec.post_quant_conv.weight.device)[:, :, None, None])
        dec.post_quant_conv.bias.zero_()


class FluxSource(NamedTuple):
    """What phase 22 records of the source before dropping it."""
    digests: dict           # "<entry>.<parameter>" → digest
    context: object         # T5 context of the prompt, on the host
    pooled: object          # CLIP-L pooled vector of the prompt, on the host
    x: object               # the fixed latent, on the host
    velocity: object        # the source DiT's velocity there, on the host
    prompt: str


def _cut(key: str) -> bool:
    """Whether a FLUX or T5 file key survives the cut in depth."""
    m = re.match(r"(double_blocks|single_blocks|encoder\.block)\.(\d+)\.", key)
    if m is None:
        return True
    keep = {"double_blocks": FLUX_CUT[0], "single_blocks": FLUX_CUT[1],
            "encoder.block": T5_CUT}[m.group(1)]
    return int(m.group(2)) < keep


def flux_write_phase(torch, fa, holder: dict, tmp: Path) -> FluxSource:
    """Phase 22: FLUX's published files from the direct FLUX bundle and a
    T5-XXL + CLIP-L drawn on the card (``holder["bundle"]`` is taken and
    dropped): at full depth, and cut in depth for ``convert``."""
    from comfyui_distributed_tpu_torch.models.clip import CLIPTextTransformer
    from comfyui_distributed_tpu_torch.models.convert import (
        export_clip_hf, export_flux, export_t5, export_vae)
    from comfyui_distributed_tpu_torch.models.registry import _random
    from comfyui_distributed_tpu_torch.models.t5 import FluxTextStack, T5Encoder
    from comfyui_distributed_tpu_torch.models.vae import AutoencoderKL
    from comfyui_distributed_tpu_torch.utils.safetensors import save_file

    say("flux files: write")
    dev = torch.device(DEVICE)
    workflow = json.loads((ROOT / "workflows" / FLUX_PATH.workflow).read_text())
    prompt = workflow["2"]["inputs"]["text"]
    write_t5_tokenizer(tmp / "t5_tokenizer", prompt.split())
    write_vocab(tmp / "tokenizer")
    os.environ["CDT_T5_TOKENIZER_DIR"] = str(tmp / "t5_tokenizer")
    os.environ["CDT_TOKENIZER_DIR"] = str(tmp / "tokenizer")
    free = shutil.disk_usage(tmp).free
    require(free >= FLUX_FILE_DISK, f"{free / 1e9:.1f} GB free under {tmp}; "
            f"the files need {FLUX_FILE_DISK / 1e9:.0f} GB")
    bundle = holder.pop("bundle")
    t0 = time.perf_counter()
    as_published_flux(torch, bundle)
    with torch.no_grad():                 # held exactly by an e4m3 file
        for p in bundle.core.parameters():
            p.copy_(p.to(torch.float8_e4m3fn))
    gen = torch.Generator(device=dev).manual_seed(T5_SEED)
    cfg_t5, cfg_l = FluxTextStack.configs()
    t5 = _random(lambda: T5Encoder(cfg_t5), dev, gen)
    clip_l = _random(lambda: CLIPTextTransformer(cfg_l), dev, gen)
    round_fp16(torch, dict(clip_l.named_parameters()))
    with torch.no_grad():
        for p in t5.parameters():
            p.copy_(p.to(torch.float8_e4m3fn))
    vae = _random(lambda: AutoencoderKL(bundle.pipeline.vae.config,
                                        encoder=True), dev, gen)
    vae.decoder.load_state_dict(bundle.pipeline.vae.decoder.state_dict())
    stack = FluxTextStack(t5, clip_l).eval()
    torch.cuda.synchronize()
    say(f"  sources ready in {time.perf_counter() - t0:.2f} s ({free / 1e9:.1f}"
        f" GB free): DiT {sum(p.numel() for p in bundle.core.parameters())} "
        f"parameters (rounded through e4m3), T5-XXL "
        f"{sum(p.numel() for p in t5.parameters())} (fp32, rounded through "
        f"e4m3), CLIP-L {sum(p.numel() for p in clip_l.parameters())}; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    require(stack.tokenization_mode == "real",
            f"source stack tokenization {stack.tokenization_mode}")
    params = {**{f"core.{k}": p for k, p in bundle.core.named_parameters()},
              **{f"vae_dec.{k}": p
                 for k, p in bundle.pipeline.vae.decoder.named_parameters()},
              **{f"t5.{k}": p for k, p in t5.named_parameters()},
              **{f"clip_l.{k}": p for k, p in clip_l.named_parameters()}}
    t0 = time.perf_counter()
    digests = param_digests(torch, params)
    say(f"  {len(digests)} parameter digests in "
        f"{time.perf_counter() - t0:.2f} s")
    dcfg = bundle.core.config
    with torch.no_grad():
        t0 = time.perf_counter()
        context, pooled = stack.encode([prompt])
        torch.cuda.synchronize()
        say(f"  source T5 + CLIP-L encode: {time.perf_counter() - t0:.3f} s "
            f"(first call); context {tuple(context.shape)}, pooled "
            f"{tuple(pooled.shape)}")
        x = torch.randn(1, 1024 // 8, 1024 // 8, dcfg.in_channels,
                        generator=gen, device=dev)
        before = fa.LAUNCHES["flash_attention_bh"]
        v = bundle.core(x, torch.tensor([0.5], device=dev), context, pooled,
                        torch.tensor([3.5], device=dev))
        sites = fa.LAUNCHES["flash_attention_bh"] - before
    require(context.shape == (1, cfg_t5.max_len, dcfg.context_dim)
            and pooled.shape == (1, dcfg.pooled_dim),
            f"source conditioning shapes {tuple(context.shape)}, "
            f"{tuple(pooled.shape)}")
    require(sites == dcfg.depth_double + dcfg.depth_single
            and v.abs().max().item() > 1e-3,
            f"source velocity: {sites} K3 launches")
    source = FluxSource(digests, context.cpu(), pooled.cpu(), x.cpu(),
                        v.cpu(), prompt)
    flux_sd, t5_sd = export_flux(bundle.core), export_t5(t5)
    files = {
        "flux.safetensors": (flux_sd, torch.float8_e4m3fn),
        "t5xxl.safetensors": (t5_sd, torch.float8_e4m3fn),
        "clip_l.safetensors": (export_clip_hf(clip_l), torch.float16),
        "ae.safetensors": (export_vae(vae, quant_convs=False), torch.float32),
        # cut in depth, in the published dtypes, for convert
        "flux_cut.safetensors": ({k: t for k, t in flux_sd.items() if _cut(k)},
                                 torch.bfloat16),
        "t5xxl_cut.safetensors": ({k: t for k, t in t5_sd.items() if _cut(k)},
                                  torch.float8_e4m3fn)}
    total = 0
    for name, (tensors, dtype) in files.items():
        t0 = time.perf_counter()
        nbytes = save_file(tensors, tmp / name, dtype=dtype)
        total += nbytes
        secs = time.perf_counter() - t0
        say(f"  wrote {name}: {len(tensors)} tensors, {nbytes / 1e9:.3f} GB "
            f"{str(dtype).split('.')[-1]} in {secs:.2f} s "
            f"({nbytes / 1e9 / secs:.2f} GB/s)")
    del files, tensors, flux_sd, t5_sd, stack, t5, clip_l, vae, bundle, params
    del context, pooled, x, v
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    say(f"  {total / 1e9:.3f} GB written; the sources dropped, "
        f"{left / 2**30:.3f} GiB allocated")
    require(left < 4 * 2**30, "the FLUX sources outlived their phase")
    return source


def require_digests(what: str, got: dict, source: FluxSource,
                    every: bool = True) -> None:
    """Each digest in ``got`` is the source parameter's (and, where
    ``every``, every source parameter is there)."""
    names = set(got) if not every else set(got) | set(source.digests)
    missing = sorted(n for n in names if n not in got or n not in source.digests)
    require(not missing, f"{what}: parameter names differ: {missing[:4]}")
    bad = [k for k in got if got[k] != source.digests[k]]
    require(not bad, f"{what}: {len(bad)} parameters differ from the "
            f"source's, e.g. {bad[:4]}")
    say(f"  {what}: all {len(got)} parameters bitwise equal to the source's "
        "(digests)")


def flux_convert_phase(torch, fa, source: FluxSource, tmp: Path) -> dict:
    """Phase 23: ``python -m comfyui_distributed_tpu_torch convert --preset
    flux`` on the files cut in depth, in a subprocess on the card, then
    their ``state.pt`` restored by a fresh registry and run once; returns
    that request's launches."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    out_dir = tmp / "root" / "flux"
    cmd = [sys.executable, "-m", "comfyui_distributed_tpu_torch", "convert",
           "--preset", "flux", "--checkpoint", str(tmp / "flux_cut.safetensors"),
           "--t5", str(tmp / "t5xxl_cut.safetensors"),
           "--clip-l", str(tmp / "clip_l.safetensors"),
           "--vae", str(tmp / "ae.safetensors"),
           "--out", str(out_dir), "--device", DEVICE]
    say(f"flux files: convert (cut to {FLUX_CUT[0]} double + {FLUX_CUT[1]} "
        f"single blocks, {T5_CUT} T5 layers)")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
    require(proc.returncode == 0, f"convert exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    manifest = json.loads((out_dir / "cdt_manifest.json").read_text())
    say(f"  convert subprocess: {secs:.2f} s (process start included); "
        f"entries {line['entries']}; max_memory_allocated "
        f"{line.get('max_memory_allocated', 0) / 2**30:.3f} GiB; state.pt "
        f"{(out_dir / 'state.pt').stat().st_size / 1e9:.3f} GB; manifest "
        f"depth {manifest.get('depth')}, t5_layers {manifest.get('t5_layers')}")
    require(line["entries"] == ["clip_l", "core", "t5", "vae_dec"]
            and manifest.get("depth") == {"double": FLUX_CUT[0],
                                          "single": FLUX_CUT[1]}
            and manifest.get("t5_layers") == T5_CUT,
            f"converted entries {line['entries']}, manifest {manifest}")
    for name in ("flux_cut.safetensors", "t5xxl_cut.safetensors"):
        (tmp / name).unlink()
    torch.cuda.reset_peak_memory_stats()
    registry = ModelRegistry(DEVICE, seed=0, checkpoint_root=out_dir.parent)
    t0 = time.perf_counter()
    bundle = registry.get("flux")
    torch.cuda.synchronize()
    say(f"  restored {out_dir} in {time.perf_counter() - t0:.2f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        "GiB")
    require_digests("restored (cut in depth)",
                    param_digests(torch, bundle_params(bundle)), source,
                    every=False)
    mode = bundle.text_encoder.tokenization_mode
    require(mode == "real", f"tokenization mode {mode}")
    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / FLUX_PATH.workflow).read_text()))
    sampler = workflow[FLUX_PATH.sampler_node]["inputs"]
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(FLUX_FILE_DIR)})
    fa.reset_launches()
    _, secs, _ = run_counted(torch, fa, executor, workflow,
                             FLUX_PATH.image_node, FLUX_CUT_COUNTS,
                             "flux restored (cut in depth)",
                             (int(sampler["height"]), int(sampler["width"])))
    say(f"  one request from the restored state: {secs:.3f} s; tokenization "
        f"{mode}; launches {FLUX_CUT_COUNTS[0]}")
    return dict(fa.LAUNCHES)


def flux_file_phase(torch, fa, source: FluxSource, tmp: Path,
                    random_seconds: list) -> dict:
    """Phase 24: ``flux`` at full depth loaded from its files with the
    calls ``convert`` makes (without its state.pt), checked against the
    source and run; returns the launches of its three requests."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.models import dit as dit_module
    from comfyui_distributed_tpu_torch.models.registry import (
        PRESETS, ModelBundle, ModelRegistry)

    say("flux files: load at full depth and run")
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = ModelBundle(PRESETS["flux"], DEVICE, empty_core=True)
    bundle.load_safetensors_checkpoint(tmp / "flux.safetensors")
    bundle.load_text_encoder_files(t5=tmp / "t5xxl.safetensors",
                                   clip_l=tmp / "clip_l.safetensors")
    bundle.load_vae_file(tmp / "ae.safetensors")
    torch.cuda.synchronize()
    say(f"  loaded the four files in {time.perf_counter() - t0:.2f} s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB ({torch.cuda.memory_allocated() / 2**30:.3f} held)")
    registry = ModelRegistry(DEVICE, seed=0)
    adopt(registry, "flux", bundle)
    require_digests("loaded", param_digests(torch, bundle_params(bundle)),
                    source)
    stack = bundle.text_encoder
    mode = stack.tokenization_mode
    require(mode == "real", f"tokenization mode {mode}")
    with torch.no_grad():
        t0 = time.perf_counter()
        context, pooled = stack.encode([source.prompt])
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stack.encode([source.prompt])
        torch.cuda.synchronize()
        encode2_s = time.perf_counter() - t0
        v = bundle.core(source.x.to(dev), torch.tensor([0.5], device=dev),
                        context, pooled, torch.tensor([3.5], device=dev))
    require(torch.equal(context.cpu(), source.context)
            and torch.equal(pooled.cpu(), source.pooled),
            "the T5 context or the pooled vector differs from the source's")
    require(torch.equal(v.cpu(), source.velocity),
            "the velocity at 4608 tokens differs from the source's")
    say(f"  tokenization {mode}; T5 + CLIP-L encode {encode_s:.3f} s first, "
        f"{encode2_s:.3f} s again; context, pooled vector and the velocity "
        f"at {context.shape[1] + source.x.shape[1] * source.x.shape[2] // 4} "
        "tokens bitwise the source's")
    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / FLUX_PATH.workflow).read_text()))
    sampler = workflow[FLUX_PATH.sampler_node]["inputs"]
    hw = (int(sampler["height"]), int(sampler["width"]))
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(FLUX_FILE_DIR)})
    fa.reset_launches()
    images, seconds = [], []
    for seed in FLUX_PATH.seeds:
        prompt = json.loads(json.dumps(workflow))
        prompt[FLUX_PATH.seed_node]["inputs"]["seed"] = seed
        img, secs, _ = run_counted(torch, fa, executor, prompt,
                                   FLUX_PATH.image_node, FLUX_FILE,
                                   f"flux from its files seed {seed}", hw)
        t = bundle.pipeline.timings
        say(f"  request seed {seed}: {secs:.3f} s; sampling {t['sample_s']:.3f}"
            f" s = {t['sample_s'] / t['steps']:.4f} s/step; decode "
            f"{t['decode_s']:.3f} s")
        images.append(img)
        seconds.append(secs)
    launches = dict(fa.LAUNCHES)
    a, b, _ = FLUX_PATH.seeds
    require(torch.equal(images[0], images[2]), f"seed {a} twice differs")
    require(not torch.equal(images[0], images[1]),
            f"seeds {a} and {b} gave one image")
    say(f"  requests {[round(s, 3) for s in seconds]} s from the files against "
        f"{[round(s, 3) for s in random_seconds]} s at random init (77 hash "
        f"tokens); launches {FLUX_FILE[0]} a request (CUDA {FLUX_FILE[1]}); "
        f"seed {a} repeatable, seed {b} differs; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # one forward at 512² with the T5 context: 1024 + 512 tokens
    model = bundle.core
    cfg = model.config
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, 64, 64, cfg.in_channels, generator=gen, device=dev)
    with torch.no_grad():
        before = fa.LAUNCHES["flash_attention_bh"]
        v = model(x, torch.tensor([0.5], device=dev), context, pooled,
                  torch.tensor([3.5], device=dev))
        sites = fa.LAUNCHES["flash_attention_bh"] - before
        with mock.patch.object(dit_module, "full_attention",
                               fa.flash_attention_plain):
            ref = model(x, torch.tensor([0.5], device=dev), context, pooled,
                        torch.tensor([3.5], device=dev))
    require(sites == cfg.depth_double + cfg.depth_single,
            f"flux file reference: {sites} K3 launches")
    compare_whole(torch, "flux file reference: DiT velocity at 512² "
                  f"({32 * 32 + context.shape[1]} tokens)", v, ref)
    return launches


def flux_file_phases(torch, fa, holder: dict, random_seconds: list) -> dict:
    """Phases 22 to 24 in one temporary directory, removed at the end;
    returns their launches by path."""
    tmp = Path(tempfile.mkdtemp(prefix="cdt_flux_"))
    t0 = time.perf_counter()
    launches = {}
    try:
        source = flux_write_phase(torch, fa, holder, tmp)
        launches["flux_cut"] = flux_convert_phase(torch, fa, source, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        launches["flux_file"] = flux_file_phase(torch, fa, source, tmp,
                                                random_seconds)
    finally:
        holder.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        for var in ("CDT_T5_TOKENIZER_DIR", "CDT_TOKENIZER_DIR"):
            os.environ.pop(var, None)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"flux file phases: {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated")
    return launches


# --- phase 25 ----------------------------------------------------------------

FLUX_SERVE_DIR = OUTPUT_DIR / "serve_flux"
FLUX_FAULTS = "dispatch@1-9:http500"
FLUX_PREVIEW_HW = (1024 // 8, 1024 // 8)     # the 16-channel latent's grid
POLL_S = 0.05


def stop_worker(worker) -> None:
    worker.terminate()
    try:
        worker.wait(timeout=30)
    except subprocess.TimeoutExpired:
        worker.kill()
        worker.wait(timeout=30)


def poll_progress(base: str, prompt_id: str, t0: float, what: str,
                  until_step: int | None = None) -> tuple[list, bytes | None, dict]:
    """Poll ``/distributed/progress/{id}`` every 50 ms until the history is
    final (or, with ``until_step``, until that step is reached); returns
    the steps seen, one preview PNG taken while sampling, and the final
    history entry (or {})."""
    steps, preview = [], None
    while True:
        status, snap = http_json(f"{base}/distributed/progress/{prompt_id}")
        if status == 200:
            steps.append(snap["step"])
            require(snap["total"] == FLUX_STEPS,
                    f"{what}: progress total {snap['total']} != {FLUX_STEPS}")
            if preview is None and 0 < snap["step"] < FLUX_STEPS:
                code, body = http_raw(f"{base}/distributed/preview/{prompt_id}")
                if code == 200:
                    preview = body
            if until_step is not None and snap["step"] >= until_step:
                return steps, preview, {}
        else:
            require(status == 404, f"{what}: progress answered {status}")
        status, entry = http_json(f"{base}/distributed/history/{prompt_id}")
        if status == 200 and entry.get("status") in (
                "success", "error", "interrupted"):
            return steps, preview, entry
        require(time.perf_counter() - t0 < SERVE_REQUEST_S,
                f"{what} not final after {SERVE_REQUEST_S} s")
        time.sleep(POLL_S)


def serve_flux_request(torch, fa, i: int, base: str, prompt: dict, token: str,
                       master, master_out: Path, log_path: Path, want: dict,
                       direct_seconds: list) -> dict:
    """One served FLUX request under a fresh fault plan (its first
    dispatch call, the WebSocket connect, is index 0); returns the
    master's launches over it."""
    from comfyui_distributed_tpu_torch.cluster import faults
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    seed = FLUX_PATH.seeds[0]
    worker_seed = seed + 0 + 1          # seed + worker index + 1
    for png in master_out.glob("*.png"):
        png.unlink()
    plan = faults.activate(faults.FaultPlan.parse(FLUX_FAULTS))
    fa.reset_launches()
    t0 = time.perf_counter()
    status, answer = http_json(base + "/distributed/queue",
                               {"prompt": prompt}, timeout=120, token=token)
    require(status == 200 and answer.get("prompt_id"),
            f"flux queue answered {status}: {answer}")
    require(answer.get("worker_count") == 1,
            f"worker_count {answer.get('worker_count')} != 1: {answer}")
    steps, preview, entry = poll_progress(base, answer["prompt_id"], t0,
                                          f"served flux {i}")
    secs = time.perf_counter() - t0
    served = dict(fa.LAUNCHES)
    served_cuda = dict(fa.CUDA_LAUNCHES)
    faults.deactivate()
    require(entry["status"] == "success", f"served flux {i}: {entry}")
    require(plan.calls.get("dispatch") == 1 and plan.injected == [],
            f"the fault plan saw calls {plan.calls}, injected "
            f"{plan.injected}: the prompt did not go over the WebSocket")
    require(steps and steps == sorted(steps) and steps[-1] == FLUX_STEPS,
            f"progress steps not rising to {FLUX_STEPS}: {steps}")
    require(preview is not None, "no preview PNG while sampling")
    shape = to_uint8(decode_png(preview))[0].shape
    require(shape == (*FLUX_PREVIEW_HW, 3), f"preview shape {shape}")
    require(served == FLUX_PATH.expected,
            f"served flux {i}: master launches {served} != {FLUX_PATH.expected}")
    require(served_cuda == FLUX_PATH.expected_cuda,
            f"served flux {i}: master CUDA kernel launches {served_cuda} != "
            f"{FLUX_PATH.expected_cuda}")
    pngs = sorted(master_out.glob("*.png"))
    require(len(pngs) == 2, f"served flux {i}: {len(pngs)} PNGs, expected 2")
    got = [to_uint8(decode_png(p.read_bytes()))[0] for p in pngs]
    require(np_equal(got[0], want[seed]), f"served flux {i}: the master's PNG "
            f"differs from the direct seed-{seed} image")
    require(np_equal(got[1], want[worker_seed]), f"served flux {i}: the "
            f"worker's PNG differs from the direct seed-{worker_seed} image")
    timings = master.model_registry.get("flux").pipeline.timings
    worker_log = log_path.read_text(errors="replace")
    done = re.findall(r"prompt \S+ done in ([\d.]+)s", worker_log)
    built = re.findall(r"built flux on cuda in ([\d.]+) s", worker_log)
    say(f"  served flux request {i}: {secs:.3f} s (POST to final history; "
        f"direct request {direct_seconds[i]:.3f} s); master prompt "
        f"{entry['duration']:.3f} s, its sampling {timings['sample_s']:.3f} s "
        f"({timings['sample_s'] / timings['steps']:.4f} s/step), decode "
        f"{timings['decode_s']:.3f} s; worker prompt "
        f"{done[-1] if done else 'not logged'} s (its FLUX bundle built in "
        f"{built[0] if built else 'not logged'} s); worker_count 1 over the "
        f"WebSocket (plan {FLUX_FAULTS}: calls {plan.calls}, injected "
        f"{plan.injected}); {len(steps)} progress polls, steps "
        f"{sorted(set(steps))}; preview {shape}; master launches {served}; "
        f"PNG 0 bitwise equal to direct seed {seed}, PNG 1 to direct seed "
        f"{worker_seed}")
    return served


def flux_serve_phase(torch, fa, images: dict, direct_seconds: list) -> dict:
    """Serve the FLUX workflow through ``POST /distributed/queue`` over the
    worker's WebSocket, with progress, previews, the auth token and a
    fault plan that blocks the HTTP dispatch, twice; then interrupt a
    prompt mid-sampling. Returns the master's launches over the two
    served requests."""
    import secrets

    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster import faults
    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    seed = FLUX_PATH.seeds[0]
    want = {s: to_uint8(images[s])[0] for s in (seed, seed + 1)}
    FLUX_SERVE_DIR.mkdir(parents=True, exist_ok=True)
    master_out = FLUX_SERVE_DIR / "master_out"
    master_port, worker_port = free_port(), free_port()
    (FLUX_SERVE_DIR / "master.json").write_text(json.dumps({
        "master": {"host": "127.0.0.1", "port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "local", "enabled": True}],
        "settings": {"websocket_orchestration": True}}))
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / FLUX_PATH.workflow).read_text()))
    prompt[FLUX_PATH.seed_node]["inputs"]["seed"] = seed
    token = secrets.token_urlsafe(24)
    log_path = FLUX_SERVE_DIR / "worker.log"
    base = f"http://127.0.0.1:{master_port}"
    worker = server = None
    ok = False
    os.environ["CDT_AUTH_TOKEN"] = token
    try:
        torch.cuda.reset_peak_memory_stats()
        worker = start_worker(worker_port, log_path, UPSCALE_DIR / "input")
        os.environ["CDT_OUTPUT_DIR"] = str(master_out)
        try:
            master = Controller(FLUX_SERVE_DIR / "master.json", device="cuda")
        finally:
            del os.environ["CDT_OUTPUT_DIR"]
        server = ServerThread(master, port=master_port)
        status, answer = http_json(base + "/distributed/queue",
                                   {"prompt": prompt})
        require(status == 401, f"queue without the token answered {status}: "
                               f"{answer}")
        served: dict = {}
        for i in range(2):
            one = serve_flux_request(torch, fa, i, base, prompt, token,
                                     master, master_out, log_path, want,
                                     direct_seconds)
            served = {k: served.get(k, 0) + n for k, n in one.items()}
        master_peak = torch.cuda.max_memory_allocated()
        status, info = http_json(
            f"http://127.0.0.1:{worker_port}/distributed/system_info")
        worker_peak = (info["devices"][0].get("max_memory_allocated", 0)
                       if status == 200 and info.get("devices") else 0)
        say(f"  served flux: 401 without the token; peak memory master "
            f"{master_peak / 2**30:.3f} GiB, worker "
            f"{worker_peak / 2**30:.3f} GiB (each process, both requests)")

        for png in master_out.glob("*.png"):
            png.unlink()
        t0 = time.perf_counter()
        status, answer = http_json(base + "/prompt", {"prompt": prompt},
                                   token=token)
        require(status == 200 and answer.get("prompt_id"),
                f"/prompt answered {status}: {answer}")
        pid = answer["prompt_id"]
        steps, _, entry = poll_progress(base, pid, t0, "interrupted flux",
                                        until_step=1)
        require(not entry, f"the prompt ended before it was interrupted: {entry}")
        status, answer = http_json(base + "/distributed/interrupt", {},
                                   token=token)
        require(status == 200 and answer.get("status") == "interrupted",
                f"interrupt answered {status}: {answer}")
        at = steps[-1]
        entry = wait_history(base, pid, t0, "interrupted flux")
        require(entry["status"] == "interrupted",
                f"interrupted flux ended {entry}")
        pngs = list(master_out.glob("*.png"))
        require(not pngs, f"an interrupted prompt wrote {pngs}")
        say(f"  interrupt: POST /distributed/interrupt at step {at} of "
            f"{FLUX_STEPS} ({answer}); history interrupted after "
            f"{time.perf_counter() - t0:.3f} s, no PNG written")
        ok = True
        return served
    finally:
        faults.deactivate()
        del os.environ["CDT_AUTH_TOKEN"]
        if server is not None:
            server.stop()
        if worker is not None:
            stop_worker(worker)
        if not ok and log_path.is_file():
            tail = log_path.read_text(errors="replace").splitlines()[-40:]
            print("chip_smoke: flux worker log tail:\n" + "\n".join(tail),
                  file=sys.stderr)


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def np_absdiff(a, b):
    require(a.shape == b.shape, f"image shapes {a.shape} != {b.shape}")
    return abs(a.astype("int16") - b.astype("int16"))


# --- phases 5 and 21 ---------------------------------------------------------


def compare_whole(torch, what: str, out, ref) -> None:
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    say(f"{what} with kernels vs plain attention: max_abs_err {err:.6g} "
        f"(max|plain| {scale:.6g}; tolerance {REFERENCE_TOL}*max|plain|)")
    require(err <= REFERENCE_TOL * scale, f"{what}: outputs disagree")


def reference_phase(torch, fa, bundle) -> None:
    from unittest import mock

    from comfyui_distributed_tpu_torch.models import layers

    unet = bundle.pipeline.unet
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = unet.config
    x = torch.randn(2, 64, 64, cfg.in_channels, generator=gen, device=dev)
    t = torch.tensor([500.0, 500.0], device=dev)
    ctx = torch.randn(2, 77, cfg.context_dim, generator=gen, device=dev)
    y = torch.randn(2, cfg.adm_in_channels, generator=gen, device=dev)
    with torch.no_grad():
        eps = unet(x, t, ctx, y)
        with mock.patch.object(layers, "self_attention",
                               fa.fused_qkv_attention_plain), \
                mock.patch.object(layers, "full_attention",
                                  fa.flash_attention_plain):
            ref = unet(x, t, ctx, y)
    compare_whole(torch, "reference: UNet eps at 512²", eps, ref)


def flux_sampler_phase(torch, fa, bundle) -> dict:
    """One direct FLUX request at full width with dpmpp_2m at 8 steps (one
    DiT call a step); returns its launches."""
    from comfyui_distributed_tpu_torch.diffusion.pipeline_flow import FlowSpec

    fa.reset_launches()
    t0 = time.perf_counter()
    ctx, pooled = bundle.text_encoder.encode(["a red fox in fresh snow, photograph"])
    spec = FlowSpec(height=1024, width=1024, steps=FLUX_DPMPP_STEPS,
                    sampler="dpmpp_2m")
    img = bundle.pipeline.generate(spec, FLUX_PATH.seeds[0], ctx, pooled)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    cfg = bundle.pipeline.dit.config
    want = {"fused_qkv_attention": 4, "flash_attention_packed": 0,
            "flash_attention_bh": FLUX_DPMPP_STEPS * (cfg.depth_double
                                                      + cfg.depth_single)}
    require(tuple(img.shape) == (1, 1024, 1024, 3),
            f"flux dpmpp_2m: image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "flux dpmpp_2m: non-finite image")
    require(img.min().item() >= 0.0 and img.max().item() <= 1.0,
            "flux dpmpp_2m: image outside [0, 1]")
    require(launches == want, f"flux dpmpp_2m: launches {launches} != {want}")
    t = bundle.pipeline.timings
    say(f"flux dpmpp_2m: {secs:.3f} s for {FLUX_DPMPP_STEPS} steps at 1024²; "
        f"sampling {t['sample_s']:.3f} s, decode {t['decode_s']:.3f} s; "
        f"launches {launches}")
    return launches


def flux_reference_phase(torch, fa, bundle) -> None:
    from unittest import mock

    from comfyui_distributed_tpu_torch.models import dit as dit_module

    model = bundle.pipeline.dit
    cfg = model.config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(1, 64, 64, cfg.in_channels, generator=gen, device=dev)
    t = torch.tensor([0.5], device=dev)
    ctx = torch.randn(1, 77, cfg.context_dim, generator=gen, device=dev)
    pooled = torch.randn(1, cfg.pooled_dim, generator=gen, device=dev)
    g = torch.tensor([3.5], device=dev)
    before = fa.LAUNCHES["flash_attention_bh"]
    with torch.no_grad():
        v = model(x, t, ctx, pooled, g)
        sites = fa.LAUNCHES["flash_attention_bh"] - before
        with mock.patch.object(dit_module, "full_attention",
                               fa.flash_attention_plain):
            ref = model(x, t, ctx, pooled, g)
    require(sites == cfg.depth_double + cfg.depth_single,
            f"flux reference: {sites} one-head launches per forward")
    require(ref.abs().max().item() > 1e-3,
            "flux reference: the velocity is zero (gates at zero?)")
    compare_whole(torch, "flux reference: DiT velocity at 512² (1101 tokens)",
                  v, ref)


def checkpoint_phases(torch, fa) -> dict:
    """Phases 15 to 19 in one temporary directory, removed at the end;
    returns their launches by path."""
    tmp = Path(tempfile.mkdtemp(prefix="cdt_ckpt_"))
    launches = {}
    t0 = time.perf_counter()
    try:
        ckpt = ckpt_sdxl_phase(torch, fa, tmp)
        launches["ckpt_sdxl"] = ckpt.launches
        launches["ckpt_lora"] = ckpt_lora_phase(torch, fa, ckpt, tmp)
        del ckpt
        gc.collect()
        torch.cuda.empty_cache()
        (tmp / "sdxl.safetensors").unlink()
        launches["ckpt_sd15"] = ckpt_sd15_phase(torch, fa, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        ckpt_models_phase(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for var in ("CDT_TOKENIZER_DIR", "CDT_LORA_DIR"):
            os.environ.pop(var, None)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"checkpoint phases: {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated")
    return launches


def main() -> int:
    if not (PACKAGE / "ops" / "csrc" / "flash_attention.cu").is_file():
        print(f"chip_smoke: {PACKAGE} not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from comfyui_distributed_tpu_torch.ops import flash_attention as fa
    from comfyui_distributed_tpu_torch.utils.device import use_full_fp32

    # the direct paths and the comparisons build models without a
    # Controller: give them the precision a controller sets on the card
    use_full_fp32()
    t_start = time.perf_counter()
    try:
        device = device_phase(torch)
        build_phase(fa)
        rows, errs = kernel_phase(torch, fa)
        path_launches = {}
        allocated = torch.cuda.memory_allocated()
        sdxl = path_phase(torch, fa, SDXL_PATH)
        path_launches["sdxl"] = sdxl.launches
        reference_phase(torch, fa, sdxl.bundle)
        up = upscale_phase(torch, fa, sdxl)
        path_launches["upscale"] = up.launches
        upscale_reference_phase(torch, fa, sdxl, up)
        up = up._replace(image=None)
        control = control_phase(torch, fa, sdxl, up)
        path_launches.update(control.launches)
        path_launches["sd15"] = sd15_phase(torch, fa, sdxl.registry)
        sd15_reference_phase(torch, fa, sdxl.registry.get("sd15"))
        cn_tile = cn_tile_phase(torch, fa, sdxl.registry, up.input_dir)
        path_launches["cn_upscale"] = cn_tile.launches
        say("audio and video inputs:")
        av = write_av_inputs(up.input_dir)
        path_launches["audio"] = audio_phase(torch, fa, up.input_dir)
        video = video_phase(torch, fa, sdxl.registry, up.input_dir,
                            av["encode_540p_s"])
        path_launches["video"] = video.launches
        path_launches["serve"] = serve_phase(torch, fa, sdxl, up, control,
                                             cn_tile, video)
        del sdxl, up, control, cn_tile, video
        left = torch.cuda.memory_allocated() - allocated
        say(f"serve: {left / 2**30:.3f} GiB still allocated after the "
            f"master's shutdown and the sdxl path's end")
        require(left < 2**30, "the SDXL bundle outlived the master's shutdown")
        torch.cuda.empty_cache()
        path_launches.update(checkpoint_phases(torch, fa))
        flux = path_phase(torch, fa, FLUX_PATH)
        path_launches["flux"], timings = flux.launches, flux.timings
        path_launches["flux_dpmpp_2m"] = flux_sampler_phase(torch, fa,
                                                            flux.bundle)
        flux_reference_phase(torch, fa, flux.bundle)
        images = {s: flux.images[s].cpu() for s in FLUX_PATH.seeds[:2]}
        seconds = flux.seconds
        holder = {"bundle": flux.bundle}
        del flux
        gc.collect()
        path_launches.update(flux_file_phases(torch, fa, holder, seconds))
        gc.collect()
        torch.cuda.empty_cache()
        say(f"flux serve: the direct bundle dropped, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        path_launches["serve_flux"] = flux_serve_phase(torch, fa, images,
                                                       seconds)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    table = kernel_table(rows, errs, path_launches)
    k3 = next(k for k in table if k["name"] == "flash_attention_bh")
    say(f"flux: K3 {k3['ms'] / 1e3:.3f} s per request of "
        f"{timings['sample_s']:.3f} s sampling "
        f"({k3['ms'] / 1e3 / timings['sample_s']:.1%})")
    say(f"total {time.perf_counter() - t_start:.1f} s on {device['smi']}")
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
