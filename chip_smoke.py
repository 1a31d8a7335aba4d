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
   and timed beside the random-init FLUX shape (4173). Then WAN's K3 rows
   at D 128 (batch 2, 40 heads): self-attention at 14 040 tokens (the
   streamed core), cross-attention over 77 hash tokens (the short-key
   kernel at D 128) and over UMT5's 512 (the streamed core, Nq ≠ Nk), the
   same two at batch 1 (phase 38's offloaded WAN: cond and uncond as two
   forwards), and video-mmdit's joint attention at 7877 tokens, the plain
   version a batch row and 8 heads at a time. Then SD3's joint attention at D 64 (batch
   2): sd3-medium's on the packed layout (24 heads, H·D 1536) at 4173
   tokens and at 4685 (T5's context from files), sd35-large's on the
   one-head layout (38 heads, H·D 2432) at 4173, and at 4685 (a shape no
   driven path gives: sd35-large from its files).
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
   11.5 MB) and ``input.avi`` (8 seeded frames of 960×540 at 24 fps, a
   1/3 s stereo track at 48 kHz, written by the port's muxer and JPEG
   encoder: seconds a frame printed) are written to the upscale input
   directory; ``workflows/distributed-audio.json`` runs unchanged:
   ``chunk_a``/``chunk_b`` must be the two halves of the clip, bitwise as
   the 16-bit codec writes them, and no kernel launches.
13b. video — ``workflows/video-upscale.json`` with node 4 reading
   ``input.avi`` (whether ``import cv2`` works is printed; where it does,
   the workflow also runs on an ``input.mp4`` of the first 2 frames
   written through OpenCV, 8 K1 and 360 K3; 8 frames until PR 20):
   ``realesrgan-x2`` to 1920×1080, USDU at ``upscale_by`` 1.0 with 768²
   tiles and padding 24 (6 crops of 816² a frame, latents 102², 4 a
   chunk: 16 chunks), res_2m on beta for 3 of 12 steps (denoise 0.25),
   CFG 5, on ``VIDEO_FRAMES`` (2) frames, cut for the run's limit:
   frames [2,1080,1920,3], finite, in [0,1], exactly 8 K1 and 180 K3
   launches a frame, the seconds of each stage (decode,
   ESRGAN, USDU, encode) and of JPEG a frame; ``video_up_00000.avi``
   read back by ``load_video`` as 2 frames of 1920×1080 at 24 fps with
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
   Last the video upscale is served on its first 2 frames
   (``frame_load_cap``; media sync uploads ``input.avi``; master
   holdback): a batch of 2 is farmed frame by frame (the dynamic mode),
   the worker must have run at least one frame, the master's launches
   must be 8 K1 plus 180 K3 per frame it ran, every frame of the
   master's USDU must be bitwise that frame upscaled alone at seed 7 +
   its index, and the AVI read back holds 8 frames at 24 fps with
   16 000 samples of the track.
14b. managed worker — after phase 14's worker is stopped, a master in
   this process (config: one ``local`` host ``w0``,
   ``stop_workers_on_master_exit``, a cluster token) answers ``/``, the
   ``/web/*`` files ``index.html`` names and ``/distributed/config``
   (401 without the token), then launches its worker with ``POST
   /distributed/launch_worker``: ``serve --device cuda`` under
   ``worker_monitor.py``, ``launching`` until its ready report (seconds
   printed). The txt2img workflow is served twice at 1024², 30 steps
   (the master's PNG bitwise the direct seed-7 image, the worker's the
   direct seed-8 image, exactly 2108 K1 and 2100 K2 master launches a
   request); the second request's sampling starts held until
   ``POST /distributed/profile/start`` has answered, so the exported
   ``torch.profiler`` trace counts exactly the master's K1 launches in
   its window as ``qkv_projection_kernel`` events (and shows
   ``flash_attention_kernel`` and ``short_kv_attention_kernel``). Then
   ``/distributed/metrics`` on both hosts (``cdt_prompts_total`` and
   ``cdt_sampler_step_seconds`` count 2 each), the master's trace tree of
   the second request (its ``orchestrate`` span and the worker's
   ``prompt.execute`` under the dispatch span), ``memory_stats``,
   ``step_times``, the worker's log, ``tunnel/status`` and
   ``tunnel/start`` (503: no binary, no download); one direct request
   (at 8 of its 30 steps since PR 20: 568 K1, 560 K2) with telemetry on
   and one off, each under ``torch.profiler`` (CUDA
   activity): the same count of synchronising calls
   (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``, device-to-host
   copies); ``POST /distributed/stop_worker``: the monitor and the worker
   exit and the card's free memory comes back within 1 GiB of its value
   before the launch; last ``python -m comfyui_distributed_tpu_torch
   info`` names the card.
14c. front door — with the defaults of the front door, the content
   cache and the stage pools (the served phases before it run with
   ``CDT_CACHE=0`` and ``CDT_STAGES=0``, so that their launch gates count
   every text encode on the path they were written for; phase 36 runs the
   defaults too, and the file request of phase 37 the cache), a master in
   this process (no
   workers, ``CDT_FD_WINDOW_MS`` 1500, its own empty cache directory)
   takes four concurrent ``POST /distributed/queue`` requests of the
   batchable graph (``CheckpointLoader sdxl`` → positive and negative
   ``CLIPTextEncode`` → ``TPUTxt2Img`` 1024², 30 euler karras steps, CFG
   5 → ``SaveImage``; seeds 41–44, four positives, one shared negative,
   two ``interactive`` and two ``batch``) and a byte-identical twin of the
   first while it runs: the four answer ``batched`` and run as one group
   (history ``batch_size`` 4, ``cdt_batch_size`` one observation of 4),
   each PNG bitwise its own solo ``GraphExecutor`` run without
   ``content_cache``; the twin answers ``coalesced``, copies its leader's
   history; the group launches exactly the four solo
   runs' K1 and K2 less the 12 text-encoder K1 launches the conditioning
   tier saved (8420 K1, 8400 K2); the conditioning tier counts 5 misses
   and at least 3 hits. Member 1 again is served by the result tier
   (history ``cache`` "hit", no launch, the PNG bitwise); member 2 with
   ``cache: "bypass"`` runs (2100 K1, 2100 K2: its encodes hit the
   conditioning tier). ``workflows/distributed-txt2img.json`` (a
   collector) answers ``batched: false`` and runs through the
   orchestrator (2104 K1, 2100 K2: its negative prompt, the members'
   shared one, is a conditioning hit). ``/distributed/system_info`` carries
   ``environment`` with the card's name and the driver's version. A second master with
   ``CDT_FD_SHED_DEPTH`` 2 takes a burst of 6 requests (512², 4 steps):
   at least one 429 with ``Retry-After``, every admitted one succeeds.
   The group runs the staged lane (encode pool → the one denoise worker
   → decode pool): ``GET /distributed/stages`` reports at least 1 group
   and 4 members, 0 fallbacks and 0 re-dispatches, each member's history
   carries ``decode_batch``, and ``cdt_decode_batch_size`` sums to 4.
   Printed: the group's seconds against the four solo runs', the queue
   wait by priority, and one SDXL UNet forward of 4 stacked requests
   (batch 8) against 4 at batch 2 (max abs difference, bitwise or not,
   the time ratio).
14d. stages and residency — a master with ``CDT_STAGE_WIRE=1`` takes
   two batchable SDXL requests at 512², 4 euler steps, as one group:
   exactly 572 K1 / 560 K2 (2 × 280 UNet + 3 encodes), each PNG bitwise
   its solo ``GraphExecutor`` run, ``cdt_latent_transfer_bytes`` two
   handoffs of 65 536 B through the checksummed wire. ``POST
   /distributed/stages/decode`` with one of those latents answers an
   image bitwise that member's direct decode; one flipped bit answers
   400. Then a ``ModelRegistry`` under ``CDT_HBM_BUDGET_GB`` with room
   for ``sdxl`` or ``sd15`` (sized from the bundles phases 4 and 11
   built), not both: ``get("sd15")`` evicts ``sdxl`` (one more
   ``cdt_residency_evictions_total``, the evicted bundle ``released``),
   the card's allocated memory falls by at least 0.9 of the SDXL
   bundle's parameter bytes; a pin of the evicted ``sdxl`` bundle raises
   ``ResidencyError`` (its parameters left the card); under a pin on
   ``sd15``, ``get("sdxl")`` raises ``ResidencyError`` and its refused
   build is freed.
14e. catalog, warmup and preemption — the shape catalog (a file of its
   own since 14c) holds ``txt2img``/``sdxl``/1024²/30 steps/batch 1,
   observed from the stage pools' denoise thread (14c's group); a catalog
   seeded from ``workflows/`` holds their three keys and round-trips
   through its file. A reference request (1024², 30 karras steps, CFG 5,
   ``dpmpp_2m_sde``, seed 61) runs direct: exactly 2100 K2. A worker
   subprocess boots with ``CDT_WARMUP=1``, ``CDT_WARMUP_MODELS=sdxl`` and
   an empty catalog seeded from the workflows: ``GET
   /distributed/warmup`` reaches ``ready`` (health says so),
   ``cdt_warmup_programs_total{outcome="compiled"}`` ≥ 1 and no
   ``error``; its first served request (the reference's graph) builds no
   bundle (``bundle_builds`` unchanged), launches 2100 K2 there and its
   PNG is bitwise the direct one. On a master with the defaults of the
   front door, the cache and the stages: the reference's graph posted
   ``priority: "batch"``, then, once its progress shows a step, an
   ``interactive`` ``euler_ancestral`` request (seed 62): the batch
   request's history counts ``preemptions`` ≥ 1,
   ``cdt_preemptions_total{reason="priority"}`` ≥ 1, the interactive one
   finishes first, the batch PNG is bitwise the reference's, exactly 4200
   K2 launch over the window (2100 each: no step twice, none skipped),
   ``cdt_jobs_preempted`` is 0 and the checkpoint store holds 0 bytes at
   the end. Then the reference's graph in this process's executor with a
   token that yields at step 8 (560 K2): its checkpoint posted to the
   worker's ``/distributed/checkpoint`` and resumed there by
   ``checkpoint_id``: the PNG bitwise the reference's, 2100 − 8·70 = 1540
   K2 on the worker; a flipped byte and a checkpoint whose
   ``meta.backend`` is not ``torch`` answer 400. Prints the warm pass's
   and the warm request's seconds, the interactive request's wait from
   its POST to its start, and the phase's seconds and peak.
14f. fleet cache — the fleet tier of the content cache and its near
   tier. A master in this process, built as 14c's but with an empty
   ``CDT_CACHE_DIR`` (memory only: after a clear only the ring can
   answer) and one ``remote`` host ``w0``, a worker subprocess with its
   own output and cache directories that builds no model, shares phase
   4's SDXL registry; the batchable graph (14c's, 1024², 8 of 30 euler
   karras steps, CFG 5). (a) ``GET /distributed/cache`` has
   ``fleet.members`` ``["master", "w0"]``, ``ring_size`` 2, ``vnodes``
   64, and ``/distributed/health`` ``cache.fleet_ring`` 2; the seed is
   the first of 41–48 whose result key (it carries this card's name) the
   master's ring gives to w0. (b) The first POST computes: 568 K1 and
   560 K2, the PNG and the sampler output bitwise a solo
   ``GraphExecutor`` run without ``content_cache``, ``remote_miss`` 1 and
   ``fill`` 1; w0's ``GET /distributed/cache/entry/{key}`` decodes to the
   master's entry bitwise. (c) ``POST /distributed/cache/clear``, then
   the same POST: history ``cache`` "hit", 8 K1 (the two text encodes the
   clear dropped) and 0 K2, the PNG and the images bitwise (b)'s,
   ``remote_hit`` 1, ``cdt_fleet_cache_remote_total{op="get",outcome="hit"}``
   up by 1. (d) A ``cache: "near"`` POST of a new positive: the donor
   (564 K1, its negative a conditioning hit, 560 K2), parked at step 4,
   bitwise its ``cache: "bypass"`` twin (560 / 560). (e) The same graph
   under another seed, ``cache: "near"``: history ``cache`` "near",
   exactly 280 K1 and 280 K2 (4 of 8 steps × 70), the near counters up
   by 1 and by 4, the image finite, in [0, 1], unequal to the donor's and
   to that seed's full run, and bitwise ``generate_near`` in this process
   on the donor's latent and that seed; no remote error. Prints each
   request's seconds, the entry's GET and PUT bytes and the fill's
   landing.
14g. mesh dp — a master on ``{"dp": 2}`` over two ranks of the card
   (gloo) serves the SDXL graph: two images, image 0 bitwise the
   one-device run, each rank's launches exact, equal digests.
14h. mesh tp — a master on ``{"dp": 1, "tp": 2}`` serves SDXL at 2
   steps: a lone request solo on rank 0, bitwise; a group of two on
   ``txt2img_tp`` (staged, no fallback), each rank's launches at the
   per-rank geometries (``TP_SDXL_STEP``, ``TP_SDXL_TIERS``), PSNR >
   30 dB against the one-rank runs, the shard digests the slices of
   rank 0's parameters, each rank's card bytes within 10% of its plan,
   a repeat a result hit under the mesh's key.
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
   converted parameter bitwise equal to the source's; the workflow at 8
   of its 30 steps (a depth cut for the time limit since PR 20; the
   source's request too) at seeds 7, 8, 7: the seed-7 image bitwise equal
   to the source bundle's, the repeat equal, seed 8 different, tokenizer
   mode ``bpe``, exactly 560 K1 and 560 K2 launches a request (the CLIP
   stack launches none).
17. LoRA — a synthetic kohya SDXL LoRA (rank 8, alpha 8) over every UNet
   attention projection, ``ff`` and ``proj_in``/``proj_out`` and every
   CLIP-L/G attention and MLP Linear (``lora_te1_``/``lora_te2_``), under
   ``CDT_LORA_DIR``; ``CheckpointLoader`` → ``LoraLoader`` → two
   ``CLIPTextEncode`` → ``TPUTxt2Img`` at 1024²: 722 UNet and 264
   text-encoder tensors merged, none unmatched; the image differs from
   the base, its repeat is equal, strength 0/0 gives the base image, the
   base bundle's next image is the base image, 560/560 launches a request
   (8 steps); one merged UNet forward at a 512² latent within
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
21a. mesh sp — FLUX ``sp`` at 2 steps over two ranks (a ``{"dp": 1,
   "tp": 2}`` mesh re-laid as ``{"sp": 2}``, as the node does; > 30 dB,
   no K3), and Ulysses against the plain attention.
21b. mesh tp flux — on the same mesh, FLUX at full depth, 2 steps,
   ``flow_tp`` (rank 1 slices its shard from 21a's FLUX): 57 K2 a step on
   each rank at [1, 4173, 12·128], no K3, > 30 dB against the one-device
   run, peaks < 80 GB together, the card's memory back after the
   follower stops.
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
   from it (6 × 28 = 168 K3); then the same ``state.pt`` built by an
   offload registry (phase 38's rule): the transformer allocated and
   loaded in host memory, the card's peak during the build within 256
   MiB of what the bundle keeps there, its digests the source's.
24. flux files: run — the full-depth files loaded into a ``flux``
   bundle by the calls ``convert`` makes (seconds, peak memory): every
   parameter's digest the source's, tokenization ``real``, the context,
   the pooled vector and the velocity bitwise the source's;
   ``workflows/flux-txt2img.json`` at 4 of its 28 steps (a depth cut for
   the time limit since PR 20) at seeds 1234, 1235, 1234: images
   [1,1024,1024,3], finite, in [0,1], the repeat bitwise equal, the seeds
   different, exactly 0 K1 and 57 × 4 = 228 K3 launches a request (at
   [24, 4608, 128]); one DiT forward at 512² with the T5
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
   it, seed 1234 at 8 of the workflow's 28 steps (a depth cut for the
   time limit since PR 20), twice (a fresh plan each time), polled on
   ``/distributed/progress/{id}`` every 50 ms: the step count rises
   monotonically to 8 of 8, one
   ``/distributed/preview/{id}`` PNG decodes to 128×128×3, the plan saw
   exactly one dispatch call and injected nothing, the master's PNG is
   bitwise equal to the direct 8-step seed-1234 image (phase 20-21 runs
   seeds 1234 and 1235 at 8 steps for this) and the worker's to the
   seed-1235 one, and the master ran exactly 456 K3 and 4 K1 launches.
   Then the workflow is queued on the master alone
   (``POST /prompt``) and ``POST /distributed/interrupt`` is sent while
   it samples: history must say ``interrupted`` and no PNG be written.
   Prints the served seconds beside the direct ones, the master's
   prompt, sampling and decode seconds and the worker's prompt seconds
   (from its log), and each process's peak memory.

26. wan t2v — ``workflows/wan-t2v.json`` on the ``wan`` preset (WAN 14B
   at full width and depth, 14.3 B parameters, the WAN 3D causal VAE;
   random init from seed 0), its 20 steps cut to 2 for the time limit (4
   from PR 18, 2 since PR 20): 33 frames of 832×480, CFG 5, shift 3,
   ``dp``, through ``GraphExecutor``: exactly 4 K1, 0 K2 and 160 K3
   launches (80 on the streamed core at 14 040 tokens, 80 on the
   short-key kernel over 77 keys), the collected
   batch [33, 480, 832, 3], finite, in [0, 1], ``wan_v0_00000.mp4`` and
   ``wan_v1_00000.mp4`` read back as the divider's 17 and 16 frames at 16
   fps; the sampling, tiled decode and request seconds and the peak
   memory. Then the same graph at seed 100; both videos are kept as 8-bit
   frames for phase 28.
27. wan reference — one WanModel velocity at full width and depth at 9
   frames (3 latent frames, 4680 tokens; cut from 33 so that the plain
   attention fits), through the kernels and with both attention sites on
   the plain version: within 5e-2·max|plain|.
28. wan served — the t2v workflow at 2 steps through ``POST
   /distributed/queue`` to a master in this process (phase 26's bundle)
   and a ``remote`` worker subprocess that builds its own WAN 14B (two
   processes, 57 GB of weights on the card): the collected batch of 66
   frames holds the master's video bitwise the direct seed-99 video and
   the worker's the direct seed-100 video (8-bit frames), both mp4s 33
   frames; the master's launches 4 K1 + 320 K3, the worker's kernels
   counted from a ``torch.profiler`` trace of its request (its
   ``/distributed/profile/start|stop``): 160 K3 and 4 K1.
29. wan i2v — ``workflows/wan-i2v.json`` on ``wan-i2v`` (in_channels 36),
   its 20 steps cut to 2 as in phase 26, with a seeded 832×480
   ``start_frame.png`` the script writes: the same launch counts as phase
   26, 33 frames of 480×832, the start frame's VAE encode seconds.
30. wan 2.2 — the t2v graph on ``wan-2.2-t2v`` (two WAN 14B experts, 57.2
   GB) at 2 steps, twice: each expert's model calls equal the split (1
   high-noise step of 2 at shift 3), 160 K3 a request, the repeat bitwise
   equal, the peak memory; its video, seconds and peak are kept for phase
   38.
31. wan files — synthetic files at full width cut in depth: a WAN 14B t2v
   file of 2 of 40 blocks under ``model.diffusion_model.``, a
   ``.high``/``.low`` pair of 2 blocks, UMT5-XXL of 2 of 24 layers in the
   HF ``encoder.*`` layout (all BF16) and a synthetic ``tokenizer.json``;
   ``convert --preset wan --checkpoint … --t5 …`` and ``--preset
   wan-2.2-t2v --checkpoint … --checkpoint-low …`` (the CLI's ``main``,
   in this process), ``state.pt`` and a restore: every parameter's digest
   its source's; one 2-step request of the converted ``wan`` bundle with
   UMT5's 512-token context: 0 K1 and 8 K3, all on the streamed core;
   the ``wan-2.2-t2v`` pair built by an offload registry as in 23: both
   experts in host memory, the card's peak within 256 MiB of what the
   bundle keeps, their digests the sources'.
32. video-mmdit — at full width (hidden 5120, 40 heads of 128) cut to 1
   double + 1 single block, the t2v graph at 5 frames of 832×480 (the
   image VAE per frame: 7800 + 77 tokens) and 2 steps: 4 K1 and 4 K3.

33. sd3-medium — the SD3 graph (no workflow file ships it):
   ``CheckpointLoader`` → positive and negative ``CLIPTextEncode`` →
   ``ModelSamplingSD3`` (shift 3.0) → ``TPUFlowTxt2Img`` (``dp``, 1024²,
   8 of its 28 euler steps in every SD3 request of the run (a depth cut
   for the time limit since PR 20), CFG 4.5 with the negative wired: cond
   and uncond in one
   DiT call of batch 2 a step) → ``DistributedCollector`` → ``SaveImage``
   on ``sd3-medium`` at full width and depth (2.0 B DiT, random init from
   seed 0, the hash encoder at 4096/2048) at seeds 31, 32, 31: images
   [1,1024,1024,3], finite, in [0,1], PNGs written, the repeat bitwise,
   the seeds different, exactly 8 K1 and 24 × 8 = 192 K2 launches a
   request, all K2 on the streamed core at [2, 4173, 24·64], and no call
   of ``scaled_dot_product_attention``.
34. sd3-medium reference — one DiT velocity at the path's shape (batch
   2, 4173 tokens, full depth) through the kernels and with its attention
   sites on the plain version: within 5e-2·max|plain|.
35. sd35-large — the same graph on ``sd35-large`` (8.1 B, RMS qk-norm)
   at seed 31 twice: exactly 8 K1 and 38 × 8 = 304 K3 at [2·38, 4173,
   64] a request, the repeat bitwise; then its reference velocity as in
   phase 34 (K3's sites on the plain version).
36. sd3 served — with the content cache's defaults, master and worker:
   the graph on ``sd3-medium`` through ``POST /distributed/queue`` to a
   master in this process (phase 33's bundle) and a ``remote`` worker
   subprocess that builds its own: the master's PNG bitwise the direct
   seed-31 image, the worker's the seed-32 one; the master's launches 8
   K1 + 192 K2, the worker's kernels counted from a ``torch.profiler``
   trace of its request; each host's conditioning tier 2 misses, and the
   master's 2 entries persisted.
37. sd3 files — phase 33's DiT rounded through BF16 and made pre-only as
   an SAI file holds it (``sd3_medium.safetensors`` at full depth, BF16,
   under ``model.diffusion_model.``), CLIP-L (with its 768-wide
   projection) and CLIP-G drawn on the card and written as F16
   ``text_model.*``, T5-XXL cut to 2 layers as F8_E4M3, the CLIP
   vocabulary and T5 ``tokenizer.json``; ``convert --preset sd3-medium
   --checkpoint … --t5 … --clip-l …`` (the CLI's ``main`` in this
   process) → ``state.pt`` → a fresh registry's restore, CLIP-G through
   ``load_text_encoder_files(clip_g=…)`` (the CLI has no ``--clip-g``,
   as JAX's): every parameter's digest the source's; the context [1,
   589, 4096], pooled vector [1, 2048] and a velocity at 4685 tokens
   bitwise the source's; three requests from it at seed 31, each exactly
   0 K1 and 192 K2 at [2, 4685, 24·64], through ``CLIPTextEncode``'s
   conditioning tier (the ``content_cache`` a controller gives its
   executor, over a persisted directory): the first encodes both prompts
   on the three towers (2 misses, both entries persisted), the second
   encodes nothing (2 memory hits), the third, with a new cache over the
   same directory, encodes nothing (2 hits from the persisted tier, copied
   back to the card); the second's and third's images and PNGs bitwise
   the first's.

38. offload (ROADMAP A.5) — after every earlier bundle is dropped, the
   host's memory printed: a ``ModelRegistry(offload=True)`` builds
   ``flux`` for offload (the glue drawn on the card, each block drawn,
   its generator state kept, dropped); its ``double_0`` drawn again and
   quantised on the card and on the host: the fp8 bytes, the scales and
   the native leaves equal. ``workflows/flux-txt2img.json`` with ``mode:
   "offload"`` at seed 1234 (28 steps): the default 13 GiB plan fully
   resident with 11e9 to 13 GiB resident, exactly 4 K1 and 1596 K3, the
   peak at least 10 GB under phase 20-21's, and against phase 20-21's
   bf16 image PSNR > 25 dB and max |diff| < 0.25 (JAX's fp8 trajectory
   gates); then 4 steps on the fully resident executor and on one built
   at half its budget (blocks streamed from pinned host memory): 228 K3,
   bitwise equal; the bytes streamed a step and s/step. The FLUX bundle
   dropped, ``wan-2.2-t2v`` built for offload, its ``block_0`` quantised
   on both, phase 30's request with ``mode: "offload"`` at seeds 99 and
   100: 4 K1 and 320 K3 (twice phase 30's: cond and uncond as two
   forwards), the card's allocated memory after the high expert's
   release within 1 GiB of its level before the high expert was placed,
   the peak at most 24 GiB, seed 99's video PSNR > 25 dB against phase
   30's. Then the shipped graph (``dp``) served by a master in this
   process (that bundle) and a ``remote`` worker subprocess with
   ``CDT_OFFLOAD=1`` that builds its own: each video bitwise the direct
   offloaded one at its seed (8-bit frames), the master's launches and
   the worker's profiled kernels exact, the two peaks together under 80
   GB, each process's host RSS printed.

Each phase prints its seconds and the card's peak allocated memory; every
bundle is dropped before the WAN phases, each WAN bundle before the
next is built, every WAN bundle before the SD3 phases, and every SD3
bundle before phase 38.

The launch counters are set to 0 just before each path and read just
after it. The second-to-last stdout line is the kernel table as JSON; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
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


# Ulysses over the mesh's two ranks (phase 21a): each rank attends over
# the whole [1, 4096] sequence with 12 of FLUX's 24 heads of 128, one
# launch a rank
ULYSSES_ROWS = [((1, 4096, 4096, 12, 128), 2)]
# Tensor parallelism at tp 2 (phases 14h, 21b): each rank runs half the
# heads. SDXL's 1280-wide sites at 10 of 20 heads: K1 with C 1280 != H·D
# 640 (the fused kernel's first such launch), K2 over 77 keys at 10·64;
# its 640-wide sites at 5 of 10 (5·64 = 320 is neither fused- nor
# packed-legal): K3, self and over 77 keys. FLUX's joint attention at 12
# of 24 heads of 128 (H·D 1536 is packed-legal). Launches a rank per
# request of the workflows' own steps (30 SDXL, 28 FLUX): the kernel
# phase's weights; the kernels line counts what 14h and 21b launched
# (TP_MEASURED).
TP = 2
TP_FUSED = [((2, 1024, 1280, 10), STEPS * 60)]        # (B, N, C, H)
TP_PACKED = [((2, 1024, 77, 10, 64), STEPS * 60)]     # (B, Nq, Nk, H, D)
TP_BH = [((2, 4096, 4096, 5, 64), STEPS * 10),
         ((2, 4096, 77, 5, 64), STEPS * 10)]
TP_FLUX_PACKED = [((1, FLUX_TOKENS, FLUX_TOKENS, 12, 128),
                   FLUX_STEPS * (19 + 38))]


def ulysses_layout() -> str:
    """The layout the port's dispatch gives a rank's Ulysses attention
    (12 heads of 128: H·D 1536 takes the packed layout)."""
    from comfyui_distributed_tpu_torch.ops.attention import packed_legal

    B, Nq, Nk, H, D = ULYSSES_ROWS[0][0]
    return "packed" if packed_legal(H, D) else "bh"


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
VIDEO_FRAMES, VIDEO_FPS = 2, 24.0     # cut from 24 (to 4, then 2) for the run's limit
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
    "flash_attention_packed": ["short_kv_attention_kernel<64,80>",
                               "flash_attention_kernel<64> at packed strides "
                               "(sd3-medium joint attention)"],
    "flash_attention_bh": ["flash_attention_kernel<128> (flux, wan, "
                           "video-mmdit)",
                           "flash_attention_kernel<64> (sd35-large joint "
                           "attention)",
                           "short_kv_attention_kernel<128,80> (wan "
                           "cross-attention over 77 tokens)",
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


# WAN (phases 26 to 32): workflows/wan-t2v.json and wan-i2v.json at
# 832×480, 33 frames: 9 latent frames of 60×104 (the 3D VAE: 4× in time,
# 8× in space), patch 2×2: 9·30·52 = 14 040 tokens. WAN 14B has 40 blocks
# of 40 heads of 128 (H·D 5120: not packed-legal, so both sites take K3),
# CFG doubles the batch; a forward launches 40 self-attentions (the
# streamed core) and 40 cross-attentions over the hash encoder's 77 tokens
# (the short-key kernel at D 128), one forward a step; the hash encoder
# adds 4 K1 launches (one prompt).
# The workflows' 20 steps (WAN_STEPS, the kernel table's per-request
# launches) run as WAN_SERVED_STEPS in every WAN request: a depth cut for
# the run's time limit (4 since PR 18, 2 since PR 20 made room for phase
# 38; PERF.md §4). At 2 steps and shift 3 the two-expert split is 1 + 1.
WAN_STEPS, WAN_FRAMES, WAN_HW = 20, 33, (480, 832)
WAN_LAYERS, WAN_HEADS = 40, 40
WAN_TOKENS = 9 * (WAN_HW[0] // 16) * (WAN_HW[1] // 16)              # 14040
WAN_FORWARD_SHAPES = [((2, WAN_TOKENS, WAN_TOKENS, WAN_HEADS, 128), WAN_LAYERS),
                      ((2, WAN_TOKENS, 77, WAN_HEADS, 128), WAN_LAYERS)]
WAN_SHAPES = [(s, WAN_STEPS * n) for s, n in WAN_FORWARD_SHAPES]   # 800 + 800
WAN_SERVED_STEPS = 2         # every WAN request this run makes
WAN_SERVED = k3_counts(WAN_SERVED_STEPS, WAN_FORWARD_SHAPES, text_prompts=1)
# phase 31: WAN and UMT5 files cut to 2 blocks and 2 layers; a request of
# 2 steps from them: the cross-attention over UMT5's 512 tokens takes the
# streamed core; UMT5 is plain fp32 (no K1)
WAN_FILE_BLOCKS, WAN_FILE_STEPS, WAN_UMT5_TOKENS = 2, 2, 512
WAN_UMT5_SHAPE = (2, WAN_TOKENS, WAN_UMT5_TOKENS, WAN_HEADS, 128)
WAN_FILE_FORWARD = [(WAN_FORWARD_SHAPES[0][0], WAN_FILE_BLOCKS),
                    (WAN_UMT5_SHAPE, WAN_FILE_BLOCKS)]
WAN_FILE_COUNTS = ({"fused_qkv_attention": 0, "flash_attention_packed": 0,
                    "flash_attention_bh": WAN_FILE_STEPS * 2 * WAN_FILE_BLOCKS},
                   cuda_counts([], [(s, WAN_FILE_STEPS * n)
                                    for s, n in WAN_FILE_FORWARD]))
# phase 32: video-mmdit at hidden 5120 (40 heads of 128) cut to 1 double +
# 1 single block, 5 frames of 832×480 through the image VAE per frame:
# 5·30·52 = 7800 video tokens + 77 text tokens in each joint attention, 2
# steps
MMDIT_CUT, MMDIT_FRAMES, MMDIT_STEPS = (1, 1), 5, 2
MMDIT_TOKENS = 77 + MMDIT_FRAMES * (WAN_HW[0] // 16) * (WAN_HW[1] // 16)
MMDIT_FORWARD_SHAPES = [((2, MMDIT_TOKENS, MMDIT_TOKENS, WAN_HEADS, 128),
                         sum(MMDIT_CUT))]
MMDIT_COUNTS = k3_counts(MMDIT_STEPS, MMDIT_FORWARD_SHAPES, text_prompts=1)
# phase 38: WAN offloaded runs CFG as two batch-1 forwards a step (cond,
# then uncond): the same 40 + 40 launches a forward at batch 1, twice a step
WAN_OFFLOAD_FORWARD_SHAPES = [((1, *s[1:]), n) for s, n in WAN_FORWARD_SHAPES]
WAN_OFFLOAD_SHAPES = [(s, 2 * WAN_STEPS * n)
                      for s, n in WAN_OFFLOAD_FORWARD_SHAPES]   # 1600 + 1600
WAN_OFFLOAD = k3_counts(2 * WAN_SERVED_STEPS, WAN_OFFLOAD_FORWARD_SHAPES,
                        text_prompts=1)
# the kernel phase's WAN rows: (path, shape, launches per request)
WAN_K3_ROWS = ([("wan", s, n) for s, n in WAN_SHAPES]
               + [("wan_offload", s, n) for s, n in WAN_OFFLOAD_SHAPES]
               + [("wan_file", WAN_UMT5_SHAPE, WAN_STEPS * WAN_LAYERS),
                  ("video_mmdit", MMDIT_FORWARD_SHAPES[0][0],
                   MMDIT_STEPS * sum(MMDIT_CUT))])

# SD3 (phases 33 to 37): the SD3 graph at 1024², 28 euler steps, true CFG
# 4.5 (cond and uncond in one batch of 2), shift 3: 77 hash tokens + 4096
# image tokens = 4173 in every joint attention, one DiT call a step.
# sd3-medium: 24 joint blocks of 24 heads of 64 (H·D 1536, packed-legal:
# K2 on the streamed core); sd35-large: 38 of 38 heads of 64 (H·D 2432,
# past the packed layout's widest row: K3 at D 64). The hash encoder adds
# 8 K1 a request (two prompts); from files T5's 512 tokens make the
# context 77 + 512 (4685 tokens) and the towers are plain fp32 (no K1).
SD3_STEPS, SD3_HW, SD3_CFG, SD3_SHIFT = 28, 1024, 4.5, 3.0
SD3_TOKENS = 77 + (SD3_HW // 16) ** 2                             # 4173
SD3_T5_TOKENS = 512
SD3_FILE_TOKENS = SD3_TOKENS + SD3_T5_TOKENS                      # 4685
SD3_K2_SHAPES = [((2, SD3_TOKENS, SD3_TOKENS, 24, 64), SD3_STEPS * 24)]
SD35_K3_SHAPES = [((2, SD3_TOKENS, SD3_TOKENS, 38, 64), SD3_STEPS * 38)]
SD3_FILE_SHAPES = [((2, SD3_FILE_TOKENS, SD3_FILE_TOKENS, 24, 64),
                    SD3_STEPS * 24)]
# every SD3 request of the run takes SD3_RUN_STEPS of the graph's 28 (a
# depth cut for the run's time limit since PR 20; PERF.md §4); the shapes
# above count a 28-step request for the kernel table
SD3_RUN_STEPS = 8


def sd3_run(shapes: list) -> list:
    return [(s, n * SD3_RUN_STEPS // SD3_STEPS) for s, n in shapes]


SD3_REQUEST = ({"fused_qkv_attention": 8,
                "flash_attention_packed": 24 * SD3_RUN_STEPS,      # 192
                "flash_attention_bh": 0},
               cuda_counts([(TEXT_SHAPE, 8)], sd3_run(SD3_K2_SHAPES)))
SD35_REQUEST = ({"fused_qkv_attention": 8, "flash_attention_packed": 0,
                 "flash_attention_bh": 38 * SD3_RUN_STEPS},        # 304
                cuda_counts([(TEXT_SHAPE, 8)], sd3_run(SD35_K3_SHAPES)))
SD3_FILE_REQUEST = ({"fused_qkv_attention": 0,
                     "flash_attention_packed": 24 * SD3_RUN_STEPS,
                     "flash_attention_bh": 0},
                    cuda_counts([], sd3_run(SD3_FILE_SHAPES)))
# the kernel phase's SD3 rows: (path, layout, shape, launches per request);
# no phase drives sd35-large from its files, so its row times the shape
# and counts no launch (a request from files would make 38 × 28)
SD3_ROWS = [("sd3", "packed", *SD3_K2_SHAPES[0]),
            ("sd3_file", "packed", *SD3_FILE_SHAPES[0]),
            ("sd35", "bh", *SD35_K3_SHAPES[0]),
            ("sd35_file", "bh", (2, SD3_FILE_TOKENS, SD3_FILE_TOKENS, 38, 64),
             0)]

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
    for shape in ([s for s, _ in FUSED_SHAPES + TILE_FUSED + TP_FUSED]
                  + RAGGED_FUSED + EDGE_FUSED):
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
                   + FILE_BH_SHAPES + ULYSSES_ROWS]
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
    # a tp rank's geometries, each on the layout its path takes
    for layout, shapes in (("packed", TP_PACKED + TP_FLUX_PACKED),
                           ("bh", TP_BH)):
        for shape, _ in shapes:
            q, k, v = core_inputs(*shape)
            ref = fa.flash_attention_plain(q, k, v)
            key = f"flash_attention_{layout}"
            fa.flash_attention(*core_inputs(*shape), layout=layout)
            err = compare(torch, f"{key} {shape} (a tp rank's)",
                          fa.flash_attention(q, k, v, layout=layout), ref)
            errs[key] = max(errs[key], err)
            del q, k, v, ref
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
    # WAN's shapes at D 128 (H·D 5120: one-head layout only): self-attention
    # at 14 040 tokens, cross-attention over 77 hash tokens (the short-key
    # kernel) and over UMT5's 512 (the streamed core, Nq != Nk), and
    # video-mmdit's joint attention; the plain version a batch row and 8
    # heads at a time
    for _, shape, _ in WAN_K3_ROWS:
        q, k, v = core_inputs(*shape)
        ref = plain_by_row(fa, q, k, v)
        fa.flash_attention(*core_inputs(*shape), layout="bh")
        err = compare(torch, f"flash_attention_bh {shape}",
                      fa.flash_attention(q, k, v, layout="bh"), ref)
        errs["flash_attention_bh"] = max(errs["flash_attention_bh"], err)
        del q, k, v, ref
    # SD3's joint attention at D 64: sd3-medium's on the packed layout
    # (H·D 1536) past 128 keys, sd35-large's on the one-head layout (H·D
    # 2432), at 4173 tokens and at 4685 (T5's context from files)
    for _, layout, shape, _ in SD3_ROWS:
        q, k, v = core_inputs(*shape)
        ref = plain_by_row(fa, q, k, v)
        key = f"flash_attention_{layout}"
        fa.flash_attention(*core_inputs(*shape), layout=layout)
        err = compare(torch, f"{key} {shape}",
                      fa.flash_attention(q, k, v, layout=layout), ref)
        errs[key] = max(errs[key], err)
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
                           + [("upscale", sh, n) for sh, n in TILE_FUSED]
                           + [("mesh_tp", sh, n) for sh, n in TP_FUSED]):
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
                                 ("bh", "flux_file", FILE_BH_SHAPES),
                                 (ulysses_layout(), "mesh_ulysses",
                                  ULYSSES_ROWS),
                                 ("packed", "mesh_tp", TP_PACKED),
                                 ("bh", "mesh_tp", TP_BH),
                                 ("packed", "flux_tp", TP_FLUX_PACKED)):
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
    for path, shape, n in WAN_K3_ROWS:
        q, k, v = core_inputs(*shape)
        time_row("flash_attention_bh", shape, n, core_work(*shape),
                 lambda: fa.flash_attention(q, k, v, layout="bh"),
                 lambda: plain_by_row(fa, q, k, v),
                 lambda: sdpa(q, k, v), path)
        del q, k, v
    for path, layout, shape, n in SD3_ROWS:
        q, k, v = core_inputs(*shape)
        time_row(f"flash_attention_{layout}", shape, n, core_work(*shape),
                 lambda: fa.flash_attention(q, k, v, layout=layout),
                 lambda: plain_by_row(fa, q, k, v),
                 lambda: sdpa(q, k, v), path)
        del q, k, v
    return rows, errs


def plain_by_row(fa, q, k, v, heads: int = 8):
    """The plain attention one batch row and at most ``heads`` heads at a
    time: the same function, with the fp32 scores of 8 heads resident at a
    time (8 heads of 10816² keys are 3.7 GB; a row of WAN's 40 heads at
    14 040 tokens would be 31.5 GB)."""
    import torch

    return torch.cat([
        torch.cat([fa.flash_attention_plain(q[i:i + 1, :, h:h + heads],
                                            k[i:i + 1, :, h:h + heads],
                                            v[i:i + 1, :, h:h + heads])
                   for h in range(0, q.shape[2], heads)], dim=2)
        for i in range(q.shape[0])])


def kernel_table(rows: list[dict], errs: dict,
                 path_launches: dict[str, dict]) -> list[dict]:
    """One entry per kernel: launch-weighted sums over one request's
    shapes on the path that carries the kernel (ms per request; K1 per
    SDXL request), and its launches summed over every path's run."""
    replaces = {"fused_qkv_attention": f"{TPU_SOURCE}:227",
                "flash_attention_packed": f"{TPU_SOURCE}:197",
                "flash_attention_bh": f"{TPU_SOURCE}:99"}
    # the tp rows weighted by what 14h and 21b launched, not by the
    # workflows' steps
    measured = {(p, shape): n for p, pairs in TP_MEASURED.items()
                for shape, n in pairs}
    rows = [{**r, "launches": measured[(r["path"], r["shape"])]}
            if (r["path"], r["shape"]) in measured else r for r in rows]
    tp_per = (f"one request of {TP_STEPS} steps on rank 1, launches as "
              "phases 14h and 21b counted them")
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
              "flux_file", "wan", "wan_offload", "wan_file", "video_mmdit",
              "sd3", "sd3_file", "sd35", "sd35_file", "mesh_ulysses",
              "mesh_tp", "flux_tp")
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
            # each mesh phase's launches on rank 0 and on rank 1 (phases
            # 14g, 14h, 21a, 21b; rank 0's include its text encodes in
            # 14g and 21a; 14h's are the group's tp programs)
            "mesh_launches_by_rank": {p: [r[name] for r in ranks]
                                      for p, ranks in MESH_TOTALS.items()},
            **split, **split_upscale,
            **{key: value for key, value in (
                ("per_img2img_controlnet_request", at(name, I2I_CN[2])),
                ("per_usdu_controlnet_request", at(name, USDU_CN[2])),
                ("per_sd15_request", at(name, sd15_request)),
                ("per_sd15_file_request", at(name, sd15_file_request)),
                ("per_cn_upscale_request", at(name, CN_TILE_SHAPES)),
                ("per_video_request", at(name, VIDEO_SHAPES)),
                ("per_flux_file_request", at(name, FILE_BH_SHAPES)),
                ("per_wan_request", at(name, WAN_SHAPES)),
                ("per_wan_offload_request", at(name, WAN_OFFLOAD_SHAPES)),
                ("per_sd3_request", at(name, SD3_K2_SHAPES)),
                ("per_sd3_file_request", at(name, SD3_FILE_SHAPES)),
                ("per_sd35_request", at(name, SD35_K3_SHAPES)),
                # a tp rank's part of one request (phases 14h, 21b)
                ("per_sdxl_tp_rank_request",
                 at(name, TP_MEASURED.get("mesh_tp", []))),
                ("per_flux_tp_rank_request",
                 at(name, TP_MEASURED.get("flux_tp", []))))
               if value is not None},
            "tp_per": tp_per,
            "tp_rows": [
                {key: r[key] for key in ("path", "shape", "launches", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
                for r in every if r["path"] in ("mesh_tp", "flux_tp")],
            **({{"flash_attention_bh": "k3_rows",
                 "flash_attention_packed": "k2_rows"}[name]: [
                {key: r[key] for key in ("path", "shape", "launches", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
                for r in every if r["path"] in others and r["path"] != "upscale"]}
               if name != "fused_qkv_attention" else {}),
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
    reset_peak(torch)
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
    reset_peak(torch)
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
    reset_peak(torch)
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
    reset_peak(torch)
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
    reset_peak(torch)
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
    reset_peak(torch)
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
VIDEO_SERVED_FRAMES = 2                 # frame_load_cap of the served run
VIDEO_MP4_FRAMES = 2                    # the mp4 run's (8 until PR 20)
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
    (and ``frame_load_cap`` when given, with USDU's ``dynamic_threshold``
    lowered to it, so that the capped batch is still farmed frame by
    frame)."""
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
        workflow["5"]["inputs"]["dynamic_threshold"] = frame_cap
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
    ``input.avi`` (8 seeded frames of 960×540 at 24 fps with a 1/3 s stereo
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
    reset_peak(torch)
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
    written through OpenCV from the AVI's first ``VIDEO_MP4_FRAMES`` frames
    (a shorter clip than the AVI's, to keep the run's time)."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.utils.video_io import (load_video,
                                                              save_video)

    frames = VIDEO_MP4_FRAMES
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


def start_worker(port: int, log_path: Path, input_dir: Path,
                 extra_env: dict | None = None):
    """``serve`` through the CLI as a worker on the card (in this process's
    environment: a ``CDT_AUTH_TOKEN`` set here is the worker's; then
    ``extra_env``); returns the process once ``/distributed/health``
    answers."""
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    (SERVE_DIR / "worker.json").write_text("{}")
    env = {**os.environ, "CDT_IS_WORKER": "1", "CDT_WORKER_ID": "w0",
           "CDT_CONFIG_PATH": str(SERVE_DIR / "worker.json"),
           "CDT_OUTPUT_DIR": str(SERVE_DIR / "worker_out"),
           "CDT_INPUT_DIR": str(input_dir), **(extra_env or {})}
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


class Served(NamedTuple):
    """A master and its worker, as ``served_pair`` started them."""
    master: object          # the master's Controller
    base: str               # the master's URL
    worker_base: str        # the worker's URL
    worker_port: int
    master_out: Path        # the master's output directory
    log_path: Path          # the worker's log
    worker_pid: int = 0


@contextlib.contextmanager
def served_pair(torch, serve_dir: Path, what: str, worker_in: Path,
                registry=None, master_env: dict | None = None,
                worker_type: str = "remote", settings: dict | None = None,
                worker_env: dict | None = None):
    """A worker subprocess (``start_worker``, input directory ``worker_in``,
    its ``torch.profiler`` traces under ``serve_dir / "profiles"``) and a
    master ``Controller`` in this process behind a ``ServerThread`` (its
    outputs in ``serve_dir / "master_out"``, ``master_env`` set while it
    is built; ``worker_env`` the worker's) that lists the worker as
    ``worker_type``; yields a
    ``Served``, then stops both and, if the block failed, prints the tail
    of the worker's log."""
    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster.controller import Controller

    SERVE_DIR.mkdir(parents=True, exist_ok=True)     # start_worker's config
    serve_dir.mkdir(parents=True, exist_ok=True)
    master_out = serve_dir / "master_out"
    master_port, worker_port = free_port(), free_port()
    (serve_dir / "master.json").write_text(json.dumps({
        "master": {"host": "127.0.0.1", "port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": worker_type, "enabled": True}],
        **({"settings": settings} if settings else {})}))
    log_path = serve_dir / "worker.log"
    worker = server = None
    ok = False
    os.environ["CDT_PROFILE_DIR"] = str(serve_dir / "profiles")
    try:
        reset_peak(torch)
        worker = start_worker(worker_port, log_path, worker_in,
                              extra_env=worker_env)
        env = {"CDT_OUTPUT_DIR": str(master_out), **(master_env or {})}
        os.environ.update(env)
        try:
            master = Controller(serve_dir / "master.json", device=DEVICE,
                                model_registry=registry)
        finally:
            for key in env:
                del os.environ[key]
        server = ServerThread(master, port=master_port)
        yield Served(master, f"http://127.0.0.1:{master_port}",
                     f"http://127.0.0.1:{worker_port}", worker_port,
                     master_out, log_path, worker.pid)
        ok = True
    finally:
        os.environ.pop("CDT_PROFILE_DIR", None)
        if server is not None:
            server.stop()
        if worker is not None:
            stop_worker(worker)
        if not ok and log_path.is_file():
            tail = log_path.read_text(errors="replace").splitlines()[-40:]
            print(f"chip_smoke: {what} worker log tail:\n" + "\n".join(tail),
                  file=sys.stderr)


def worker_peak(worker_base: str) -> int:
    """The worker's peak device memory (``/distributed/system_info``), 0
    when it does not say."""
    status, info = http_json(worker_base + "/distributed/system_info")
    return (info["devices"][0].get("max_memory_allocated", 0)
            if status == 200 and info.get("devices") else 0)


def served_request(fa, served: Served, prompt: dict,
                   what: str) -> tuple[float, dict, dict]:
    """``prompt`` through the master's ``POST /distributed/queue`` to one
    worker, the worker traced (``trace_kernels``); returns the seconds
    from the POST to the final history, the master's launches and the
    worker's kernel events by name."""
    stop_trace = trace_kernels(served.worker_base, what.replace(" ", "_"))
    before = dict(fa.LAUNCHES)
    t0 = time.perf_counter()
    status, answer = http_json(served.base + "/distributed/queue",
                               {"prompt": prompt}, timeout=120)
    require(status == 200 and answer.get("worker_count") == 1,
            f"{what}: queue answered {status}: {answer}")
    entry = wait_history(served.base, answer["prompt_id"], t0, what)
    secs = time.perf_counter() - t0
    require(entry["status"] == "success", f"{what}: {entry}")
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    return secs, counts, stop_trace()


def serve_phase(torch, fa, sdxl: PathRun, up: UpscaleRun,
                control: ControlRun, cn_tile: CnTileRun,
                video: VideoRun) -> dict:
    """Serve the SDXL workflow twice, then the upscale workflow, the
    img2img + ControlNet graph, the ControlNet tile upscale, the audio
    workflow and the video upscale once each,
    through ``POST /distributed/queue`` to a master in this process and a
    ``remote`` worker subprocess with an input directory of its own, with
    leg A of the elastic fleet (``drain_leg``) after the upscale; returns
    the master's launches of the phase and of the leg by path."""
    import shutil
    from unittest import mock

    from comfyui_distributed_tpu_torch.cluster import orchestration
    from comfyui_distributed_tpu_torch.cluster.elastic.states import DRAIN
    from comfyui_distributed_tpu_torch.cluster.resilience import BREAKERS
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.utils.frames import pack_frame
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    seed = SDXL_PATH.seeds[0]
    worker_seed = seed + 0 + 1          # seed + worker index + 1
    require(worker_seed in sdxl.images, "the sdxl path has no seed-8 image")
    # the worker shares no files with the master: its input directory
    # starts empty and the master syncs what a prompt reads
    worker_in = SERVE_DIR / "worker_in"
    shutil.rmtree(worker_in, ignore_errors=True)
    worker_in.mkdir(parents=True)
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / SDXL_PATH.workflow).read_text()))
    prompt[SDXL_PATH.seed_node]["inputs"]["seed"] = seed
    want = {s: to_uint8(sdxl.images[s])[0] for s in (seed, worker_seed)}
    reports = []
    sync = orchestration.sync_host_media

    async def recording_sync(*args, **kwargs):
        out = await sync(*args, **kwargs)
        reports.append(out[1])
        return out

    with mock.patch.object(orchestration, "sync_host_media", recording_sync), \
            served_pair(torch, SERVE_DIR, "sdxl", worker_in,
                        registry=sdxl.registry,
                        master_env={"CDT_INPUT_DIR": str(up.input_dir)}) as served:
        base, master, master_out = served.base, served.master, served.master_out
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
        serve_upscale(torch, fa, base, served.worker_port, master_out, up)
        report = reports[-1]
        require((report.checked, report.uploaded, report.failed) == (1, 1, []),
                f"served upscale: media sync {report}, expected 1 uploaded")
        require((worker_in / "input.png").read_bytes()
                == (up.input_dir / "input.png").read_bytes(),
                "the worker's input.png differs from the master's")
        say(f"  media sync before the served upscale: {report}; the "
            "worker's input.png byte-identical to the master's")
        launches = dict(fa.LAUNCHES)
        try:
            drained = drain_leg(torch, fa, served, up)
        finally:
            DRAIN.reset()
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
        require(BREAKERS.state("w0") == "closed",
                "the served requests after leg A's rolling restart left "
                f"w0's breaker {BREAKERS.state('w0')}")
    return {"serve": {k: launches[k] + video_launches[k] for k in launches},
            "elastic_drain": drained}


UPSCALE_HOLDBACK_S = 120.0   # the master waits this long for the worker's pull
# leg A (the elastic fleet): w0 is drained while it holds a 4-tile chunk
# (about 2.5 s on the card), with a deadline well below it, so the chunk
# is handed back; an arrival in this process steals with job_id "*"
DRAIN_DEADLINE_S = 0.5
STEAL_ID = "w-steal"
DRAIN_WAIT_S = 60.0          # the drain's decommission after its deadline


def serve_upscale(torch, fa, base: str, worker_port: int, master_out: Path,
                  up: UpscaleRun) -> None:
    """The upscale workflow through ``POST /distributed/queue``: the tiles
    are pulled over HTTP from the master's queue by the master and the
    worker."""
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    for png in master_out.glob("*.png"):
        png.unlink()
    reset_peak(torch)
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
    peak = worker_peak(f"http://127.0.0.1:{worker_port}")
    say(f"  served upscale: {secs:.3f} s (POST to final history; direct "
        f"{up.seconds[0]:.3f} / {up.seconds[1]:.3f} s); tile tasks "
        f"{dict(sorted(owners.items()))} (master {mine}, worker {theirs}); "
        f"master launches {counts}; PNG bitwise equal to the direct upscale; "
        f"peak memory master {master_peak / 2**30:.3f} GiB (this request), "
        f"worker {peak / 2**30:.3f} GiB (its process)")


class CapturedPlan:
    """A tile farm that keeps a worker's process function and runs nothing:
    the USDU node, run as a worker, hands it the range plan's
    ``run_range``, as a dispatched worker's graph builds it."""

    def __init__(self):
        self.fn = None

    def worker_run(self, job_id, worker_id, master_url, process_fn):
        self.fn = process_fn
        return 0


def steal_plan(registry, input_dir: Path, base: str):
    """The upscale workflow's tile process function over the in-process
    SDXL bundle: nodes 1–5 run as the worker ``STEAL_ID`` would run them
    (ESRGAN, the two text encodes, the range plan)."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import topo_order

    prompt = upscale_workflow()
    capture = CapturedPlan()
    executor = GraphExecutor({
        "model_registry": registry, "input_dir": str(input_dir),
        "is_worker": True, "worker_id": STEAL_ID, "master_url": base,
        "multi_job_id": "steal_plan", "tile_farm": capture})
    order = topo_order(prompt)
    executor.execute_nodes(prompt, order[:order.index("5") + 1], {})
    require(capture.fn is not None, "the USDU node built no tile plan")
    return capture.fn


def metric(base: str, sample: str) -> float:
    status, text = http_raw(base + "/distributed/metrics")
    require(status == 200, f"metrics answered {status}")
    return prometheus_samples(text.decode()).get(sample, 0.0)


def drain_leg(torch, fa, served: Served, up: UpscaleRun) -> dict:
    """Leg A of the elastic fleet: a second served upscale. The worker w0
    is drained (``POST /distributed/worker/w0/drain``) while it holds a
    chunk, with a deadline below a chunk's time, so the chunk is handed
    back; meanwhile this process steals with ``TileFarm.worker_steal_run``
    as the arrival ``STEAL_ID`` (``job_id="*"``), its tiles on the
    in-process bundle. The PNG must be bitwise the direct upscale; then
    w0 is undrained (the rolling restart) and the later served requests
    go to it again. Returns the master's launches in the leg (the master
    and the arrival share this process)."""
    import asyncio
    import threading

    from comfyui_distributed_tpu_torch.cluster.elastic.states import DRAIN
    from comfyui_distributed_tpu_torch.cluster.job_store import JobStore
    from comfyui_distributed_tpu_torch.cluster.resilience import BREAKERS
    from comfyui_distributed_tpu_torch.cluster.tile_farm import TileFarm
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    master, base, master_out = served.master, served.base, served.master_out
    store = master.store

    def on_master(coro):
        return asyncio.run_coroutine_threadsafe(coro, master.loop).result(30)

    t_leg = time.perf_counter()
    run_range = steal_plan(master.model_registry, up.input_dir, base)
    plan_s = time.perf_counter() - t_leg
    for png in master_out.glob("*.png"):
        png.unlink()
    # every grant of the store, in order: (worker, job, task)
    grants = []
    grant = store._grant_locked

    def recording(job, worker_id):
        task = grant(job, worker_id)
        if task is not None:
            grants.append((worker_id, job.job_id, task["task_id"]))
        return task

    steal_loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=steal_loop.run_forever, daemon=True)
    loop_thread.start()
    farm = TileFarm(JobStore(), steal_loop)
    stolen: dict = {}
    steal_thread = None
    handbacks0 = metric(base, "cdt_drain_handbacks_total")
    steals0 = metric(base, 'cdt_steal_assignments_total{kind="stolen"}')
    store._grant_locked = recording
    os.environ["CDT_TILE_MASTER_HOLDBACK_S"] = str(UPSCALE_HOLDBACK_S)
    try:
        fa.reset_launches()
        before_cuda = dict(fa.CUDA_LAUNCHES)
        t0 = time.perf_counter()
        status, answer = http_json(base + "/distributed/queue",
                                   {"prompt": upscale_workflow()}, timeout=120)
        require(status == 200 and answer.get("worker_count") == 1,
                f"leg A: queue answered {status}: {answer}")
        job_id = f"{answer['trace_id']}_5"
        while True:
            held = on_master(store.worker_held_tasks("w0"))
            if held.get(job_id):
                break
            require(time.perf_counter() - t0 < SERVE_REQUEST_S,
                    "leg A: w0 never held a task of the upscale")
            time.sleep(0.05)
        t_drain = time.perf_counter()
        drained_at = len(grants)
        status, report = http_json(base + "/distributed/worker/w0/drain",
                                   {"deadline_s": DRAIN_DEADLINE_S,
                                    "stop_process": False})
        require(status == 200 and report.get("status") == "draining",
                f"leg A: drain answered {status}: {report}")

        def steal():
            stolen.update(farm.worker_steal_run(
                STEAL_ID, base,
                lambda jid: run_range if jid == job_id else None))

        steal_thread = threading.Thread(target=steal, daemon=True)
        steal_thread.start()
        while True:
            status, elastic = http_json(base + "/distributed/elastic")
            report = elastic["drain"]["reports"].get("w0", {})
            if report.get("phase") == "decommissioned":
                break
            require(time.perf_counter() - t_drain < DRAIN_WAIT_S,
                    f"leg A: the drain did not end: {report}")
            time.sleep(0.05)
        decommission_s = time.perf_counter() - t_drain
        refusal = http_json(base + "/distributed/request_image",
                            {"job_id": "*", "worker_id": "w0"})
        drain_gauge = metric(base, 'cdt_worker_drain_state{worker="w0"}')
        entry = wait_history(base, answer["prompt_id"], t0, "leg A upscale")
        secs = time.perf_counter() - t0
        steal_thread.join(SERVE_REQUEST_S)
        require(not steal_thread.is_alive(), "leg A: the steal loop never ended")
    finally:
        store._grant_locked = grant
        del os.environ["CDT_TILE_MASTER_HOLDBACK_S"]
        if steal_thread is not None:
            steal_thread.join(DRAIN_WAIT_S)
        steal_loop.call_soon_threadsafe(steal_loop.stop)
        loop_thread.join(30)
        steal_loop.close()
    require(entry["status"] == "success", f"leg A upscale: {entry}")
    counts = dict(fa.LAUNCHES)
    kernel_counts = {k: fa.CUDA_LAUNCHES[k] - before_cuda[k]
                     for k in fa.CUDA_LAUNCHES}
    status, summary = http_json(f"{base}/distributed/queue_status/{job_id}")
    require(status == 200 and summary.get("finished"),
            f"leg A tile job status {status}: {summary}")
    owners = summary["completed_by"]
    held_at_start = report["held_at_start"].get(job_id, [])
    handed = report["handed_back"].get(job_id, [])
    mine = sum(1 for w, j, _ in grants if w == "master" and j == job_id)
    theirs = sum(1 for w, j, _ in grants if w == STEAL_ID and j == job_id)
    late = [g for g in grants[drained_at:] if g[0] == "w0"]
    handbacks = metric(base, "cdt_drain_handbacks_total") - handbacks0
    steals = metric(base, 'cdt_steal_assignments_total{kind="stolen"}') - steals0
    require(len(owners) == UPSCALE_TILES // UPSCALE_CHUNK
            and not summary["dead_letter"],
            f"leg A tile tasks: {summary}")
    require(summary["requeue_counts"] == {},
            f"leg A: requeue counts {summary['requeue_counts']}")
    require(STEAL_ID in owners.values(),
            f"leg A: {STEAL_ID} completed none of the tasks: {owners}")
    require(not late and all(int(t) in held_at_start
                             for t, w in owners.items() if w == "w0"),
            f"leg A: w0 was granted or completed work after its drain: "
            f"{owners}, held at the drain {held_at_start}, late {late}")
    require(len(handed) >= 1 and handbacks == len(handed),
            f"leg A: handed back {handed}, cdt_drain_handbacks_total rose "
            f"{handbacks}")
    require(BREAKERS.state("w0") == "closed",
            f"leg A: w0's breaker is {BREAKERS.state('w0')}")
    require(refusal == (200, {"task": None, "draining": True}),
            f"leg A: w0's pull after the drain: {refusal}")
    require(drain_gauge == 2.0,
            f"leg A: cdt_worker_drain_state of w0 {drain_gauge}, expected 2")
    require(steals >= 1, f"leg A: {steals} stolen grants counted")
    require(stolen.get(job_id) == theirs and sum(stolen.values()) == theirs,
            f"leg A: the arrival ran {stolen}, granted {theirs}")
    per_chunk = 70 * UPSCALE_STEPS
    want = {"fused_qkv_attention": 8 + per_chunk * (mine + theirs),
            "flash_attention_packed": per_chunk * (mine + theirs),
            "flash_attention_bh": 0}
    require(counts == want, f"leg A: master launches {counts} != {want}")
    want_cuda = {"qkv_projection": 8 + per_chunk * (mine + theirs),
                 "flash_attention_core": per_chunk * (mine + theirs),
                 "short_kv_attention": 8 + per_chunk * (mine + theirs)}
    require(kernel_counts == want_cuda,
            f"leg A: master CUDA kernel launches {kernel_counts} != {want_cuda}")
    pngs = sorted(master_out.glob("upscaled_*.png"))
    require(len(pngs) == 1, f"leg A: {len(pngs)} PNGs, expected 1")
    require(np_equal(to_uint8(decode_png(pngs[0].read_bytes()))[0],
                     up.image_u8),
            "leg A: the drained and stolen upscale differs from the direct one")
    # the rolling restart: w0 rejoins, and phase 14's later requests go to it
    status, body = http_json(base + "/distributed/worker/w0/undrain", {})
    require(status == 200 and body.get("cleared") is True,
            f"leg A: undrain answered {status}: {body}")
    require(DRAIN.state("w0") == "active", "leg A: w0 not active again")
    say(f"  leg A (drain, handback, steal): {secs:.3f} s (POST to final "
        f"history; the arrival's plan built in {plan_s:.3f} s before it); "
        f"w0 drained {t_drain - t0:.3f} s after the POST, decommissioned "
        f"{decommission_s:.3f} s later; held {held_at_start}, handed back "
        f"{handed}; grants {[(w, t) for w, _, t in grants]}; tasks "
        f"{dict(sorted(owners.items()))}; master {mine}, {STEAL_ID} {theirs} "
        f"(its stolen grants counted {steals:.0f}); master launches {counts}; "
        f"PNG bitwise the direct upscale; w0's breaker closed; undrained")
    return counts


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
        f"ESRGAN frames within {esr:.3g} of the direct run's; "
        f"{VIDEO_AVI} read back as {VIDEO_SERVED_FRAMES} frames at "
        f"{back['fps']:g} fps with {span} samples of audio")
    return launches


# --- phase 14b: a worker the master launches --------------------------------

MANAGED_DIR = OUTPUT_DIR / "managed"
MANAGED_STOP_S = 30.0        # the worker's exit and its memory coming back
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
K1_EVENT = "qkv_projection_kernel"


def count_kernel_events(trace: str) -> tuple[dict, int]:
    """A ``torch.profiler`` trace's K1 and attention kernel events, counted
    by kernel name, and the trace's number of events."""
    events = json.loads(Path(trace).read_text())["traceEvents"]
    kernels: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            for name in (K1_EVENT, "flash_attention_kernel",
                         "short_kv_attention_kernel"):
                if name in e.get("name", ""):
                    kernels[name] = kernels.get(name, 0) + 1
    return kernels, len(events)


def proc_children(pid: int) -> list[int]:
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(") ", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(fields[1]) == pid:
            out.append(int(stat.parent.name))
    return out


def pid_alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(") ", 1)[1][:1]
    except (OSError, IndexError):
        return False
    return state != "Z"


def prometheus_samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def sync_counts(prof) -> tuple[int, int]:
    """(synchronising calls, device-to-host copies) of a profile."""
    syncs = copies = 0
    for e in prof.key_averages():
        if e.key in SYNC_CALLS:
            syncs += e.count
        elif e.key.startswith("Memcpy DtoH"):
            copies += e.count
    return syncs, copies


# the telemetry on/off requests run MANAGED_DIRECT_STEPS of the workflow's
# 30 (a depth cut since PR 20; their gate is equal synchronisations):
# 8 K1 on the text encoder and 70 K1 / 70 K2 a step
MANAGED_DIRECT_STEPS = 8
MANAGED_DIRECT = {"fused_qkv_attention": 8 + 70 * MANAGED_DIRECT_STEPS,
                  "flash_attention_packed": 70 * MANAGED_DIRECT_STEPS,
                  "flash_attention_bh": 0}


def direct_sdxl(torch, fa, registry, seed: int) -> float:
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / SDXL_PATH.workflow).read_text()))
    prompt[SDXL_PATH.seed_node]["inputs"]["seed"] = seed
    prompt[SDXL_PATH.sampler_node]["inputs"]["steps"] = MANAGED_DIRECT_STEPS
    before = dict(fa.LAUNCHES)
    t0 = time.perf_counter()
    GraphExecutor({"model_registry": registry,
                   "output_dir": str(MANAGED_DIR / "direct")}).execute(prompt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    require(counts == MANAGED_DIRECT, f"direct request: {counts}")
    return secs


def managed_phase(torch, fa, sdxl: PathRun) -> dict:
    """Launch, serve through, observe and stop a worker the master starts
    itself; returns the master's launches in the phase."""
    import re
    import secrets
    import shutil
    import threading
    from unittest import mock

    from comfyui_distributed_tpu_torch import telemetry
    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.diffusion import pipeline as pipemod
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.utils.image import decode_png, to_uint8

    shutil.rmtree(MANAGED_DIR, ignore_errors=True)
    MANAGED_DIR.mkdir(parents=True)
    seed = SDXL_PATH.seeds[0]
    want = {s: to_uint8(sdxl.images[s])[0] for s in (seed, seed + 1)}
    token = secrets.token_hex(16)
    auth = {"token": token}
    master_port, worker_port = free_port(), free_port()
    cfg_path = MANAGED_DIR / "master.json"
    cfg_path.write_text(json.dumps({
        "master": {"host": "127.0.0.1", "port": master_port},
        "hosts": [{"id": "w0", "address": f"http://127.0.0.1:{worker_port}",
                   "type": "local", "enabled": True}],
        "settings": {"stop_workers_on_master_exit": True,
                     "auth_token": token}}))
    master_out = MANAGED_DIR / "master_out"
    env = {"CDT_LOG_DIR": str(MANAGED_DIR / "logs"),
           "CDT_PROFILE_DIR": str(MANAGED_DIR / "profiles"),
           "CDT_CLOUDFLARED_AUTO_DOWNLOAD": "0",
           "CDT_OUTPUT_DIR": str(master_out)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    telemetry.REGISTRY.reset()
    telemetry.SPAN_STORE.reset()
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / SDXL_PATH.workflow).read_text()))
    prompt[SDXL_PATH.seed_node]["inputs"]["seed"] = seed
    # the master's sampling waits here while armed (the profile window
    # then opens on a drained card, before its first UNet launch): both
    # the uninterrupted and the preemptible lane bind their sampler here
    reached, go, armed = threading.Event(), threading.Event(), [False]
    prepare = pipemod.Txt2ImgPipeline._prepare_sampling

    def held(self, *args, **kwargs):
        if armed[0]:
            armed[0] = False
            torch.cuda.synchronize()
            reached.set()
            require(go.wait(SERVE_REQUEST_S), "the profile window never opened")
        return prepare(self, *args, **kwargs)

    patch = mock.patch.object(pipemod.Txt2ImgPipeline, "_prepare_sampling",
                              held)
    master = server = monitor = None
    log_path = None
    ok = False
    launches = {k: 0 for k in fa.LAUNCHES}
    try:
        patch.start()
        master = Controller(cfg_path, device=DEVICE,
                            model_registry=sdxl.registry)
        server = ServerThread(master, port=master_port)
        base = f"http://127.0.0.1:{master_port}"

        # 1. the dashboard, the config, the launch and the ready report
        status, index = http_raw(base + "/")
        require(status == 200 and b"CUDA Distributed" in index,
                f"/ answered {status}")
        assets = sorted(set(re.findall(rb'"/web/([\w.-]+)"', index)))
        for name in assets:
            status, _ = http_raw(f"{base}/web/{name.decode()}")
            require(status == 200, f"/web/{name.decode()} answered {status}")
        require(http_json(base + "/distributed/config")[0] == 401,
                "/distributed/config answered without the token")
        status, cfg = http_json(base + "/distributed/config", **auth)
        require(status == 200 and cfg["hosts"][0]["id"] == "w0",
                f"/distributed/config: {status}")
        # the master's cache returned first, here and after the stop, so
        # the two readings differ by what the worker held
        torch.cuda.empty_cache()
        free_before = torch.cuda.mem_get_info()[0]
        os.environ["CDT_OUTPUT_DIR"] = str(MANAGED_DIR / "worker_out")
        t0 = time.perf_counter()
        status, launched = http_json(base + "/distributed/launch_worker",
                                     {"worker_id": "w0"}, **auth)
        os.environ["CDT_OUTPUT_DIR"] = str(master_out)
        require(status == 200, f"launch_worker answered {status}: {launched}")
        monitor, log_path = launched["pid"], Path(launched["log"])
        seen_launching = False
        while True:
            status, managed = http_json(base + "/distributed/managed_workers")
            entry = managed["workers"].get("w0")
            require(entry is not None, "the launched worker died while booting")
            if not entry["launching"]:
                break
            seen_launching = True
            require(time.perf_counter() - t0 < SERVE_BOOT_S,
                    f"no ready report in {SERVE_BOOT_S} s")
            time.sleep(0.25)
        ready_s = time.perf_counter() - t0
        require(seen_launching, "the worker was never seen launching")
        cmdline = Path(f"/proc/{monitor}/cmdline").read_bytes().split(b"\0")
        require(any(a.endswith(b"worker_monitor.py") for a in cmdline),
                f"the managed process is not the monitor: {cmdline[:3]}")
        (worker,) = proc_children(monitor)
        wargs = Path(f"/proc/{worker}/cmdline").read_bytes().split(b"\0")
        require(b"--device" in wargs and wargs[wargs.index(b"--device") + 1]
                == DEVICE.encode(), f"the worker's argv: {wargs}")
        say(f"  launch_worker → ready report in {ready_s:.3f} s (monitor pid "
            f"{monitor}, worker pid {worker}, port {worker_port}); /, "
            f"{len(assets)} /web files and /distributed/config (token) answer")

        # 2 and 3. two served requests, the second under the profiler
        prompt_ids, served = [], []
        for i in range(2):
            for png in master_out.glob("*.png"):
                png.unlink()
            before = dict(fa.LAUNCHES)
            if i == 1:
                armed[0] = True
            t0 = time.perf_counter()
            status, answer = http_json(base + "/distributed/queue",
                                       {"prompt": prompt}, timeout=120, **auth)
            require(status == 200 and answer.get("worker_count") == 1,
                    f"queue answered {status}: {answer}")
            if i == 1:
                require(reached.wait(SERVE_REQUEST_S),
                        "the master never reached its sampling")
                k1_start = fa.LAUNCHES["fused_qkv_attention"]
                status, started = http_json(base + "/distributed/profile/start",
                                            {"out": "served"}, **auth)
                require(status == 200 and started["status"] == "tracing",
                        f"profile/start answered {status}: {started}")
                go.set()
            entry = wait_history(base, answer["prompt_id"], t0,
                                 f"managed request {i}")
            secs = time.perf_counter() - t0
            require(entry["status"] == "success", f"managed request {i}: {entry}")
            if i == 1:
                k1_window = fa.LAUNCHES["fused_qkv_attention"] - k1_start
                t_stop = time.perf_counter()
                status, stopped = http_json(base + "/distributed/profile/stop",
                                            {}, timeout=600, **auth)
                require(status == 200, f"profile/stop answered {status}")
                stop_s = time.perf_counter() - t_stop
            counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
            require(counts == SDXL_PATH.expected,
                    f"managed request {i}: master launches {counts}")
            launches = {k: launches[k] + counts[k] for k in launches}
            pngs = sorted(master_out.glob("*.png"))
            require(len(pngs) == 2, f"managed request {i}: {len(pngs)} PNGs")
            got = [to_uint8(decode_png(p.read_bytes()))[0] for p in pngs]
            require(np_equal(got[0], want[seed]),
                    f"managed request {i}: the master's PNG differs from the "
                    f"direct seed-{seed} image")
            require(np_equal(got[1], want[seed + 1]),
                    f"managed request {i}: the worker's PNG differs from the "
                    f"direct seed-{seed + 1} image")
            prompt_ids.append(answer["prompt_id"])
            served.append(secs)
            say(f"  managed request {i}: {secs:.3f} s (direct "
                f"{sdxl.seconds[i]:.3f} s); master launches {counts}; both "
                f"PNGs bitwise the direct seed {seed} and {seed + 1} images")
        t_parse = time.perf_counter()
        kernels, events = count_kernel_events(stopped["trace"])
        size = Path(stopped["trace"]).stat().st_size
        say(f"  profile of request 1: {events} events, {size} bytes, "
            f"stop and export {stop_s:.2f} s, parse "
            f"{time.perf_counter() - t_parse:.2f} s; kernels {kernels}; K1 "
            f"launches in the window {k1_window}")
        require(kernels.get(K1_EVENT) == k1_window,
                f"{K1_EVENT} events {kernels.get(K1_EVENT)} != the K1 "
                f"launch delta {k1_window}")
        require(kernels.get("flash_attention_kernel", 0) > 0
                and kernels.get("short_kv_attention_kernel", 0) > 0,
                f"attention kernels missing from the trace: {kernels}")

        # the rest of 3: metrics, the trace tree, memory, step times, log
        for where, port in (("master", master_port), ("worker", worker_port)):
            status, text = http_raw(f"http://127.0.0.1:{port}/distributed/metrics")
            require(status == 200, f"{where} metrics answered {status}")
            m = prometheus_samples(text.decode())
            got = (m.get('cdt_prompts_total{status="success"}'),
                   m.get('cdt_sampler_step_seconds_count{pipeline="txt2img"}'))
            require(got == (2, 2), f"{where} metrics: prompts and step "
                    f"observations {got}, expected (2, 2)")
            step = (m['cdt_sampler_step_seconds_sum{pipeline="txt2img"}'] / 2)
            say(f"  {where} /distributed/metrics: {len(m)} samples; "
                f"cdt_prompts_total 2, cdt_sampler_step_seconds count 2, mean "
                f"{step:.4f} s a step")
        status, trace = http_json(f"{base}/distributed/trace/{prompt_ids[1]}")
        require(status == 200, f"trace answered {status}")
        spans = {s["span_id"]: s for s in trace["spans"]}
        orchestrate = [s for s in spans.values() if s["name"] == "orchestrate"]
        remote = [s for s in spans.values() if s["name"] == "prompt.execute"
                  and s["attrs"].get("prompt_id") != prompt_ids[1]]
        require(len(orchestrate) == 1 and len(remote) == 1,
                f"trace spans {sorted(s['name'] for s in spans.values())}")
        require(spans.get(remote[0]["parent_id"], {}).get("name") == "dispatch",
                "the worker's execution span is not under the dispatch span")
        require(trace["tree"][0]["name"] == "orchestrate",
                f"trace tree roots {[r['name'] for r in trace['tree']]}")
        worker_calls = [s for s in spans.values() if s["name"] == "pipeline_call"
                        and s["parent_id"] == remote[0]["span_id"]]
        require(len(worker_calls) == 1, "no worker pipeline_call span")
        say(f"  trace {trace['trace_id']}: {len(spans)} spans, master "
            f"orchestrate {orchestrate[0]['duration_s']:.3f} s, worker "
            f"prompt.execute {remote[0]['duration_s']:.3f} s under dispatch, "
            f"worker pipeline_call {worker_calls[0]['duration_s']:.3f} s "
            f"(attn {worker_calls[0]['attrs'].get('attn_kernels')})")
        status, mem = http_json(base + "/distributed/memory_stats")
        stats = mem["devices"][0]["stats"]
        require(all(stats.get(k, 0) > 0 for k in (
            "allocated_bytes", "reserved_bytes", "free_bytes", "total_bytes")),
            f"memory_stats: {mem}")
        say(f"  memory_stats: allocated {stats['allocated_bytes'] / 2**30:.3f}, "
            f"reserved {stats['reserved_bytes'] / 2**30:.3f}, free "
            f"{stats['free_bytes'] / 2**30:.3f} of "
            f"{stats['total_bytes'] / 2**30:.3f} GiB")
        status, steps = http_json(base + "/distributed/step_times")
        listed = [p["prompt_id"] for p in steps["prompts"]]
        require(set(prompt_ids) <= set(listed), f"step_times: {listed}")
        status, wlog = http_json(base + "/distributed/worker_log/w0", **auth)
        require(status == 200 and f"controller up as worker on {DEVICE}"
                in wlog.get("log", ""), "the worker's log does not show it up")
        status, tun = http_json(base + "/distributed/tunnel/status")
        require(status == 200 and tun["running"] is False,
                f"tunnel/status: {status} {tun}")
        t0 = time.perf_counter()
        status, tun = http_json(base + "/distributed/tunnel/start", {}, **auth)
        tunnel_s = time.perf_counter() - t0
        require(status == 503 and tunnel_s < 1.0,
                f"tunnel/start answered {status} in {tunnel_s:.2f} s: {tun}")
        say(f"  step_times lists both prompts; worker log tailed "
            f"({len(wlog['log'])} chars); tunnel/start 503 in "
            f"{tunnel_s:.3f} s: {tun['error']}")

        # 4. telemetry on and off: the same synchronisations
        cost = {}
        activity = (torch.profiler.ProfilerActivity.CUDA if DEVICE == "cuda"
                    else torch.profiler.ProfilerActivity.CPU)
        for on in (True, False):
            telemetry.set_enabled(on)
            try:
                with torch.profiler.profile(activities=[activity]) as prof:
                    secs = direct_sdxl(torch, fa, sdxl.registry, seed)
            finally:
                telemetry.set_enabled(True)
            cost[on] = (secs, *sync_counts(prof))
        say(f"  telemetry on: {cost[True][0]:.3f} s, {cost[True][1]} sync "
            f"calls, {cost[True][2]} device-to-host copies; off: "
            f"{cost[False][0]:.3f} s, {cost[False][1]} sync calls, "
            f"{cost[False][2]} device-to-host copies")
        require(cost[True][1:] == cost[False][1:],
                "telemetry changed the synchronising calls")
        require(cost[True][1] > 0, "the profile recorded no synchronisation")

        # 5. stop: the monitor and the worker exit, the memory comes back
        t0 = time.perf_counter()
        status, stopped = http_json(base + "/distributed/stop_worker",
                                    {"worker_id": "w0"}, **auth)
        stop_s = time.perf_counter() - t0
        require(status == 200, f"stop_worker answered {status}: {stopped}")
        require(http_json(base + "/distributed/managed_workers")[1]
                == {"workers": {}}, "managed_workers not empty after stop")
        require(not pid_alive(monitor) and not pid_alive(worker),
                "the monitor or the worker outlived stop_worker")
        while True:
            torch.cuda.empty_cache()
            free_after = torch.cuda.mem_get_info()[0]
            if free_before - free_after < 2**30:
                break
            require(time.perf_counter() - t0 < MANAGED_STOP_S,
                    f"free memory {free_after / 2**30:.3f} GiB did not come "
                    f"back to {free_before / 2**30:.3f} GiB")
            time.sleep(0.25)
        say(f"  stop_worker in {stop_s:.3f} s: monitor and worker gone; free "
            f"card memory {free_before / 2**30:.3f} GiB before the launch, "
            f"{free_after / 2**30:.3f} GiB after the stop")

        # 6. info
        proc = subprocess.run(
            [sys.executable, "-m", "comfyui_distributed_tpu_torch", "info"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "CDT_CONFIG_PATH": str(MANAGED_DIR / "info.json")})
        require(proc.returncode == 0, f"info exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        info = json.loads(proc.stdout)
        require(info["devices"][0]["name"] == torch.cuda.get_device_name(0),
                f"info devices: {info['devices']}")
        say(f"  info: {info['devices'][0]['name']}, torch {info['torch']}, "
            f"CUDA {info.get('cuda')}")
        ok = True
        return launches
    finally:
        patch.stop()
        go.set()
        if master is not None:
            master.worker_manager.cleanup_all()
        if server is not None:
            server.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if not ok and log_path is not None and log_path.is_file():
            tail = log_path.read_text(errors="replace").splitlines()[-40:]
            print("chip_smoke: managed worker log tail:\n" + "\n".join(tail),
                  file=sys.stderr)


# leg B (the elastic fleet): the autoscaler on 14b's managed host, each
# knob at its quickest (one evaluation a streak, no cooldown, a fleet of
# at most one worker); pressure 1 (one prompt queued or running with no
# worker) launches w0, an idle queue (pressure 0) drains it
AUTOSCALE_ENV = {"CDT_AUTOSCALE": "1", "CDT_AUTOSCALE_INTERVAL_S": "0.5",
                 "CDT_AUTOSCALE_UP_STREAK": "1", "CDT_AUTOSCALE_DOWN_STREAK": "1",
                 "CDT_AUTOSCALE_UP_COOLDOWN_S": "0",
                 "CDT_AUTOSCALE_DOWN_COOLDOWN_S": "0", "CDT_AUTOSCALE_MAX": "1",
                 "CDT_AUTOSCALE_UP_DEPTH": "1", "CDT_AUTOSCALE_DOWN_DEPTH": "0"}
AUTOSCALE_PROMPTS = 2        # SDXL at MANAGED_DIRECT_STEPS, no collector
AUTOSCALE_DECIDE_S = 30.0    # a decision after its condition (0.5 s ticks)


class DecisionWatch:
    """Polls ``GET /distributed/elastic`` every 0.1 s in a thread and keeps
    each up or down decision it shows (the route lists the last 10, five
    seconds of 0.5 s ticks)."""

    def __init__(self, base: str):
        import threading

        self.base, self.seen, self.errors = base, [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.is_set():
            try:
                status, elastic = http_json(self.base + "/distributed/elastic")
                for d in elastic["autoscaler"]["recent_decisions"]:
                    if d["direction"] != "hold" and d not in self.seen:
                        self.seen.append(d)
            except (OSError, KeyError, ValueError) as e:
                self.errors.append(repr(e))
            self._stop.wait(0.1)

    def wait(self, direction: str, limit_s: float) -> dict:
        t0 = time.perf_counter()
        while True:
            hits = [d for d in self.seen if d["direction"] == direction]
            if hits:
                return hits[0]
            require(time.perf_counter() - t0 < limit_s,
                    f"leg B: no {direction} decision in {limit_s} s; seen "
                    f"{self.seen}, poll errors {self.errors[-3:]}")
            time.sleep(0.05)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10)


def autoscale_leg(torch, fa, sdxl: PathRun) -> dict:
    """Leg B of the elastic fleet: a master on 14b's config (its ``local``
    host w0) started with ``CDT_AUTOSCALE=1``. Queued SDXL prompts press
    it, and the autoscaler launches w0 through ``LocalProcessProvider``
    (the master holds its first sampling until w0 reports ready); once the
    queue is idle it drains w0, which stops its process and marks it
    decommissioned. Returns the master's launches."""
    import threading
    from unittest import mock

    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster.controller import Controller
    from comfyui_distributed_tpu_torch.cluster.elastic.states import DRAIN
    from comfyui_distributed_tpu_torch.cluster.resilience import BREAKERS
    from comfyui_distributed_tpu_torch.diffusion import pipeline as pipemod

    cfg_path = MANAGED_DIR / "master.json"
    cfg = json.loads(cfg_path.read_text())
    require(not cfg.get("managed_processes"),
            f"leg B: 14b left managed processes {cfg.get('managed_processes')}")
    master_port = cfg["master"]["port"]
    auth = {"token": cfg["settings"]["auth_token"]}
    env = {**AUTOSCALE_ENV, "CDT_LOG_DIR": str(MANAGED_DIR / "logs"),
           "CDT_CLOUDFLARED_AUTO_DOWNLOAD": "0",
           "CDT_OUTPUT_DIR": str(MANAGED_DIR / "autoscale_out")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reached, go = threading.Event(), threading.Event()
    prepare = pipemod.Txt2ImgPipeline._prepare_sampling

    def held(self, *args, **kwargs):
        # the first sampling waits until the launched worker is ready
        if not reached.is_set():
            reached.set()
            require(go.wait(SERVE_REQUEST_S), "leg B: the hold was never lifted")
        return prepare(self, *args, **kwargs)

    patch = mock.patch.object(pipemod.Txt2ImgPipeline, "_prepare_sampling",
                              held)
    master = server = watch = None
    try:
        patch.start()
        master = Controller(cfg_path, device=DEVICE,
                            model_registry=sdxl.registry)
        server = ServerThread(master, port=master_port)
        base = f"http://127.0.0.1:{master_port}"
        watch = DecisionWatch(base)
        status, elastic = http_json(base + "/distributed/elastic")
        require(status == 200 and elastic["autoscaler_running"]
                and elastic["autoscaler"]["policy"]["max_workers"] == 1,
                f"leg B: the autoscaler is not running: {elastic}")
        torch.cuda.empty_cache()
        free_before = torch.cuda.mem_get_info()[0]
        fa.reset_launches()
        t0 = time.perf_counter()
        ids = []
        for i in range(AUTOSCALE_PROMPTS):
            status, answer = http_json(base + "/prompt", {"prompt": fd_prompt(
                7 + i, fd_positive(i), f"autoscale_{i}",
                steps=MANAGED_DIRECT_STEPS)}, **auth)
            require(status == 200 and answer.get("prompt_id"),
                    f"leg B: /prompt answered {status}: {answer}")
            ids.append(answer["prompt_id"])
        up = watch.wait("up", AUTOSCALE_DECIDE_S)
        up_s = time.perf_counter() - t0
        require(reached.wait(SERVE_REQUEST_S), "leg B: the master never sampled")
        require((up["reason"], up["worker_id"]) == ("queue_pressure", "w0"),
                f"leg B: scale-up {up}")
        monitor = worker = None
        while True:
            managed = http_json(base + "/distributed/managed_workers")[1]
            entry = managed["workers"].get("w0")
            require(entry is not None, "leg B: the launched worker died booting")
            if monitor is None:
                monitor = entry["pid"]
            if not entry["launching"]:
                break
            require(time.perf_counter() - t0 < SERVE_BOOT_S,
                    f"leg B: no ready report in {SERVE_BOOT_S} s")
            time.sleep(0.25)
        ready_s = time.perf_counter() - t0
        (worker,) = proc_children(monitor)
        go.set()
        for i, pid in enumerate(ids):
            entry = wait_history(base, pid, t0, f"leg B prompt {i}")
            require(entry["status"] == "success", f"leg B prompt {i}: {entry}")
        idle_s = time.perf_counter() - t0
        counts = dict(fa.LAUNCHES)
        want = {k: v * AUTOSCALE_PROMPTS for k, v in MANAGED_DIRECT.items()}
        require(counts == want, f"leg B: master launches {counts} != {want}")
        down = watch.wait("down", AUTOSCALE_DECIDE_S)
        require((down["reason"], down["worker_id"]) == ("idle_fleet", "w0"),
                f"leg B: scale-down {down}")
        while True:
            status, elastic = http_json(base + "/distributed/elastic")
            report = elastic["drain"]["reports"].get("w0", {})
            if report.get("phase") == "decommissioned":
                break
            require(time.perf_counter() - t0 < SERVE_REQUEST_S,
                    f"leg B: the drain did not end: {report}")
            time.sleep(0.1)
        down_s = time.perf_counter() - t0
        require(report.get("process_stopped") is True
                and report.get("handed_back") == {},
                f"leg B: drain report {report}")
        require(DRAIN.state("w0") == "decommissioned",
                f"leg B: w0 is {DRAIN.state('w0')}")
        require(http_json(base + "/distributed/managed_workers")[1]
                == {"workers": {}}, "leg B: managed_workers not empty")
        require(not pid_alive(monitor) and not pid_alive(worker),
                "leg B: the monitor or the worker outlived the drain")
        while True:
            torch.cuda.empty_cache()
            free_after = torch.cuda.mem_get_info()[0]
            if free_before - free_after < 2**30:
                break
            require(time.perf_counter() - t0 < SERVE_REQUEST_S,
                    f"leg B: free memory {free_after / 2**30:.3f} GiB did not "
                    f"come back to {free_before / 2**30:.3f} GiB")
            time.sleep(0.25)
        require(all(s == "closed" for s in BREAKERS.states().values()),
                f"leg B: breakers {BREAKERS.states()}")
        status, text = http_raw(base + "/distributed/metrics")
        m = prometheus_samples(text.decode())
        got = (m.get('cdt_autoscale_decisions_total{direction="up",'
                     'reason="queue_pressure"}'),
               m.get('cdt_autoscale_decisions_total{direction="down",'
                     'reason="idle_fleet"}'),
               m.get('cdt_worker_drain_state{worker="w0"}'))
        require(got == (1, 1, 2), f"leg B: decisions up and down and w0's "
                f"state {got}, expected (1, 1, 2)")
        require([d["direction"] for d in watch.seen] == ["up", "down"],
                f"leg B: decisions {watch.seen}")
        say(f"  leg B (autoscaler): up/queue_pressure {up_s:.3f} s after the "
            f"first POST (pressure {up['pressure']}), w0 ready at "
            f"{ready_s:.3f} s, the queue idle at {idle_s:.3f} s, "
            f"down/idle_fleet and w0 decommissioned (process stopped) at "
            f"{down_s:.3f} s; master launches {counts}; free card memory "
            f"{free_before / 2**30:.3f} GiB before, {free_after / 2**30:.3f} "
            f"GiB after; no breaker opened")
        return counts
    finally:
        patch.stop()
        go.set()
        if watch is not None:
            watch.close()
        if master is not None:
            master.worker_manager.cleanup_all()
        if server is not None:
            server.stop()
        DRAIN.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# --- phases 15 to 19 ---------------------------------------------------------

DEVICE = "cuda"
CKPT_SEED = 11               # the source bundles' seed (not the registry's 0)
CKPT_HW = 1024               # the txt2img workflow's size
VOCAB_SIZE = 49408           # CLIP's: <|startoftext|> 49406, <|endoftext|> 49407
LORA_NAME = "synthetic-sdxl"
LORA_RANK, LORA_ALPHA = 8, 8.0
LORA_UP_STD = 0.1 / LORA_RANK ** 0.5   # ΔW about a tenth of W
# per SDXL request from a checkpoint: the CLIP stack launches nothing, so
# K1 and K2 are the UNet's 70 sites a call (60 at 1024 tokens); the
# requests run CKPT_STEPS of the workflow's 30 (a depth cut for the run's
# time limit since PR 20; PERF.md §4): 560 K1 and 560 K2
CKPT_STEPS = 8
CKPT_SDXL_SHAPES = [(s, n * CKPT_STEPS // STEPS) for s, n in FUSED_SHAPES[:2]]
CKPT_SDXL_PACKED = [(s, n * CKPT_STEPS // STEPS) for s, n in PACKED_SHAPES]
CKPT_SDXL = ({"fused_qkv_attention": sum(n for _, n in CKPT_SDXL_SHAPES),
              "flash_attention_packed": sum(n for _, n in CKPT_SDXL_PACKED),
              "flash_attention_bh": 0},
             cuda_counts(CKPT_SDXL_SHAPES, CKPT_SDXL_PACKED))
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
    workflow[SDXL_PATH.sampler_node]["inputs"]["steps"] = CKPT_STEPS
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
    reset_peak(torch)
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
    → ``TPUTxt2Img`` at 1024² (the txt2img workflow's spec at
    ``CKPT_STEPS``)."""
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
            "seed": seed, "steps": CKPT_STEPS, "cfg": 6.0, "width": CKPT_HW,
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
# phase 24's requests run FLUX_FILE_STEPS of the workflow's 28 (a depth cut
# for the run's time limit since PR 20; PERF.md §4): 57 × 4 = 228 K3
FLUX_FILE_STEPS = 4
FLUX_FILE_RUN_SHAPES = [(s, FLUX_FILE_STEPS * (19 + 38))
                        for s, _ in FILE_BH_SHAPES]
FLUX_FILE = ({"fused_qkv_attention": 0, "flash_attention_packed": 0,
              "flash_attention_bh": sum(n for _, n in FLUX_FILE_RUN_SHAPES)},
             # projection 0, streamed core 228, short-key 0
             cuda_counts([], FLUX_FILE_RUN_SHAPES))
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
    reset_peak(torch)
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
    launches = dict(fa.LAUNCHES)
    del registry, bundle, executor
    core = offload_file_build(torch, out_dir.parent, "flux")["core"]
    require_digests("offload build (cut in depth)",
                    {f"core.{k}": v for k, v in core.items()}, source,
                    every=False)
    return launches


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
    reset_peak(torch)
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
    sampler["steps"] = FLUX_FILE_STEPS
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
    say(f"  requests {[round(s, 3) for s in seconds]} s from the files at "
        f"{FLUX_FILE_STEPS} steps against "
        f"{[round(s, 3) for s in random_seconds]} s at random init (77 hash "
        f"tokens, 28 steps); launches {FLUX_FILE[0]} a request (CUDA "
        f"{FLUX_FILE[1]}); "
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
# the served requests run FLUX_SERVE_STEPS of the workflow's 28 (a depth
# cut for the run's time limit since PR 20; PERF.md §4), against direct
# references at the same count from phase 20-21: 57 × 8 = 456 K3
FLUX_SERVE_STEPS = 8
FLUX_SERVED = ({"fused_qkv_attention": 4, "flash_attention_packed": 0,
                "flash_attention_bh": FLUX_SERVE_STEPS * (19 + 38)},
               cuda_counts([(FUSED_SHAPES[2][0], 4)],
                           [(s, FLUX_SERVE_STEPS * (19 + 38))
                            for s, _ in BH_SHAPES]))
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
            require(snap["total"] == FLUX_SERVE_STEPS,
                    f"{what}: progress total {snap['total']} != "
                    f"{FLUX_SERVE_STEPS}")
            if preview is None and 0 < snap["step"] < FLUX_SERVE_STEPS:
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
    require(steps and steps == sorted(steps)
            and steps[-1] == FLUX_SERVE_STEPS,
            f"progress steps not rising to {FLUX_SERVE_STEPS}: {steps}")
    require(preview is not None, "no preview PNG while sampling")
    shape = to_uint8(decode_png(preview))[0].shape
    require(shape == (*FLUX_PREVIEW_HW, 3), f"preview shape {shape}")
    require(served == FLUX_SERVED[0],
            f"served flux {i}: master launches {served} != {FLUX_SERVED[0]}")
    require(served_cuda == FLUX_SERVED[1],
            f"served flux {i}: master CUDA kernel launches {served_cuda} != "
            f"{FLUX_SERVED[1]}")
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

    from comfyui_distributed_tpu_torch.cluster import faults
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    seed = FLUX_PATH.seeds[0]
    want = {s: to_uint8(images[s])[0] for s in (seed, seed + 1)}
    prompt = strip_meta(json.loads(
        (ROOT / "workflows" / FLUX_PATH.workflow).read_text()))
    prompt[FLUX_PATH.seed_node]["inputs"]["seed"] = seed
    prompt[FLUX_PATH.sampler_node]["inputs"]["steps"] = FLUX_SERVE_STEPS
    token = secrets.token_urlsafe(24)
    os.environ["CDT_AUTH_TOKEN"] = token
    try:
        with served_pair(torch, FLUX_SERVE_DIR, "flux", UPSCALE_DIR / "input",
                         worker_type="local",
                         settings={"websocket_orchestration": True}) as served:
            base, master_out = served.base, served.master_out
            status, answer = http_json(base + "/distributed/queue",
                                       {"prompt": prompt})
            require(status == 401, f"queue without the token answered "
                                   f"{status}: {answer}")
            served_counts: dict = {}
            for i in range(2):
                one = serve_flux_request(torch, fa, i, base, prompt, token,
                                         served.master, master_out,
                                         served.log_path, want, direct_seconds)
                served_counts = {k: served_counts.get(k, 0) + n
                                 for k, n in one.items()}
            master_peak = torch.cuda.max_memory_allocated()
            peak = worker_peak(served.worker_base)
            say(f"  served flux: 401 without the token; peak memory master "
                f"{master_peak / 2**30:.3f} GiB, worker {peak / 2**30:.3f} "
                "GiB (each process, both requests)")

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
            require(not entry,
                    f"the prompt ended before it was interrupted: {entry}")
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
                f"{FLUX_SERVE_STEPS} ({answer}); history interrupted after "
                f"{time.perf_counter() - t0:.3f} s, no PNG written")
        return served_counts
    finally:
        faults.deactivate()
        del os.environ["CDT_AUTH_TOKEN"]


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


def flux_serve_refs(torch, fa, registry) -> tuple[dict, list]:
    """The served FLUX phase's references: the workflow at
    ``FLUX_SERVE_STEPS`` steps at seeds 1234 and 1235 on phase 20's
    bundle; returns the images (on the host) and the seconds."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / FLUX_PATH.workflow).read_text()))
    sampler = workflow[FLUX_PATH.sampler_node]["inputs"]
    sampler["steps"] = FLUX_SERVE_STEPS
    hw = (int(sampler["height"]), int(sampler["width"]))
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(OUTPUT_DIR / "flux_8")})
    images, seconds = {}, []
    for seed in FLUX_PATH.seeds[:2]:
        workflow[FLUX_PATH.seed_node]["inputs"]["seed"] = seed
        img, secs, _ = run_counted(torch, fa, executor, workflow,
                                   FLUX_PATH.image_node, FLUX_SERVED,
                                   f"flux {FLUX_SERVE_STEPS} steps seed {seed}",
                                   hw)
        images[seed] = img.cpu()
        seconds.append(secs)
    say(f"flux at {FLUX_SERVE_STEPS} steps (the served phase's references): "
        f"{[round(x, 3) for x in seconds]} s; launches {FLUX_SERVED[0]} a "
        "request")
    return images, seconds


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


# --- phases 26 to 32: WAN video ----------------------------------------------

WAN_DIR = OUTPUT_DIR / "wan"
WAN_SERVE_DIR = OUTPUT_DIR / "serve_wan"
WAN_T2V, WAN_I2V = "wan-t2v.json", "wan-i2v.json"
WAN_FPS = 16.0
WAN_SEED = 99                # the t2v workflow's seed (the worker's is 100)
WAN_SPLIT = 1                # of WAN_SERVED_STEPS at shift 3: sigma >= 0.875
WAN_REF_FRAMES = 9           # phase 27: 3 latent frames, 4680 tokens
# ImageBatchDivider(divide_by=2) of one video: 17 and 16 frames
WAN_HALVES = ((WAN_FRAMES + 1) // 2, WAN_FRAMES // 2)
WAN_FILE_SEEDS = {"wan": 21, "high": 22, "low": 23, "umt5": 24}


def wan_workflow(name: str, **sampler) -> dict:
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    prompt = strip_meta(json.loads((ROOT / "workflows" / name).read_text()))
    node = "4" if name == WAN_T2V else "5"
    prompt[node]["inputs"].update(sampler)
    return prompt


def wan_request(torch, fa, executor, prompt: dict, what: str, want: tuple,
                node: str = "5", frames: int = 0) -> tuple:
    """Run ``prompt``; its launches per wrapper and per CUDA kernel must be
    ``want``, the collected batch [frames (default the workflow's), 480,
    832, 3], finite, in [0, 1]. Returns (the batch, the seconds, the
    launches)."""
    frames, hw = frames or WAN_FRAMES, WAN_HW
    before, cuda_before = dict(fa.LAUNCHES), dict(fa.CUDA_LAUNCHES)
    t0 = time.perf_counter()
    out = executor.execute(prompt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    cuda = {k: fa.CUDA_LAUNCHES[k] - cuda_before[k] for k in fa.CUDA_LAUNCHES}
    batch = out[node][0]
    require(counts == want[0], f"{what}: launches {counts} != {want[0]}")
    require(cuda == want[1],
            f"{what}: CUDA kernel launches {cuda} != {want[1]}")
    require(tuple(batch.shape) == (frames, *hw, 3),
            f"{what}: batch shape {tuple(batch.shape)}")
    require(bool(torch.isfinite(batch).all()), f"{what}: non-finite frames")
    require(batch.min().item() >= 0.0 and batch.max().item() <= 1.0,
            f"{what}: frames outside [0, 1]")
    return batch, secs, counts


def check_mp4s(out_dir: Path, prefix: str, counts: tuple) -> None:
    """``<prefix>_v<k>_00000.mp4`` read back with ``counts[k]`` frames of
    832×480 at 16 fps."""
    from comfyui_distributed_tpu_torch.utils.video_io import load_video

    hw = WAN_HW

    for k, count in enumerate(counts):
        path = out_dir / f"{prefix}_v{k}_00000.mp4"
        require(path.is_file(), f"{path} was not written")
        clip = load_video(path)
        require(clip["frame_count"] == count and clip["fps"] == WAN_FPS
                and clip["frames"].shape[1:3] == hw,
                f"{path}: {clip['frame_count']} frames of "
                f"{clip['frames'].shape[1:3]} at {clip['fps']} fps, expected "
                f"{count} of {hw} at {WAN_FPS}")


def wan_bundle(torch, registry, name: str):
    t0 = time.perf_counter()
    bundle = registry.get(name)
    torch.cuda.synchronize()
    cores = [bundle.core] + ([bundle.pipeline.dit_low]
                             if bundle.pipeline.dit_low is not None else [])
    n = [sum(p.numel() for p in c.parameters()) for c in cores]
    say(f"  {name} bundle built in {time.perf_counter() - t0:.2f} s "
        f"({' + '.join(f'{k / 1e9:.3f} B' for k in n)} transformer params; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated)")
    return bundle


class WanRun(NamedTuple):
    registry: object        # holding the wan bundle
    frames: dict            # seed → uint8 frames of its direct 4-step video
    seconds: float          # the workflow's request
    launches: dict


def wan_t2v_phase(torch, fa) -> WanRun:
    """Phase 26: ``workflows/wan-t2v.json`` on the full-width ``wan``
    preset, its 20 steps cut to ``WAN_SERVED_STEPS``, then the same graph
    at seed 100: the served phase's references are this seed-99 video and
    that one."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    prompt = wan_workflow(WAN_T2V)
    node = prompt["4"]["inputs"]
    require((node["frames"], node["steps"], node["height"], node["width"],
             node["cfg"], node["shift"], node["mode"],
             prompt["1"]["inputs"]["ckpt_name"], prompt["3"]["inputs"]["seed"])
            == (WAN_FRAMES, WAN_STEPS, *WAN_HW, 5.0, 3.0, "dp", "wan",
                WAN_SEED),
            f"{WAN_T2V} changed; update the script")
    node["steps"] = WAN_SERVED_STEPS
    registry = ModelRegistry(DEVICE, seed=0)
    bundle = wan_bundle(torch, registry, "wan")
    out_dir = WAN_DIR / "t2v"
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(out_dir)})
    reset_peak(torch)
    fa.reset_launches()
    batch, secs, _ = wan_request(torch, fa, executor, prompt, "wan t2v",
                                 WAN_SERVED)
    t = bundle.pipeline.timings
    peak = torch.cuda.max_memory_allocated()
    check_mp4s(out_dir, "wan", WAN_HALVES)
    say(f"  wan-t2v.json: {secs:.3f} s for {WAN_FRAMES} frames of "
        f"{WAN_HW[1]}x{WAN_HW[0]}; sampling {t['sample_s']:.3f} s = "
        f"{t['sample_s'] / t['steps']:.4f} s/step over {t['steps']} steps; "
        f"tiled VAE decode {t['decode_s']:.3f} s; launches "
        f"{WAN_SERVED[0]}, CUDA kernels {WAN_SERVED[1]}; batch "
        f"{tuple(batch.shape)}; wan_v0/wan_v1 mp4 read back as "
        f"{WAN_HALVES[0]} and {WAN_HALVES[1]} frames at {WAN_FPS:g} fps; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    launches = dict(fa.LAUNCHES)
    frames = {WAN_SEED: to_uint8(batch)}
    del batch
    seed = WAN_SEED + 1
    p = wan_workflow(WAN_T2V, steps=WAN_SERVED_STEPS)
    p["3"]["inputs"]["seed"] = seed
    fa.reset_launches()
    batch, s, _ = wan_request(torch, fa, executor, p,
                              f"wan t2v {WAN_SERVED_STEPS} steps", WAN_SERVED)
    frames[seed] = to_uint8(batch)
    say(f"  direct seed {seed} at {WAN_SERVED_STEPS} steps: {s:.3f} s "
        f"(sampling {bundle.pipeline.timings['sample_s']:.3f} s, decode "
        f"{bundle.pipeline.timings['decode_s']:.3f} s)")
    require(not np_equal(frames[WAN_SEED], frames[WAN_SEED + 1]),
            "seeds 99 and 100 gave the same video")
    return WanRun(registry, frames, secs, launches)


def wan_reference_phase(torch, fa, bundle) -> None:
    """Phase 27: one full-depth WanModel velocity at 9 frames (3 latent
    frames: 4680 tokens, batch 1) through the kernels and with its
    attention sites on the plain version."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.models import wan as wan_module

    model = bundle.core
    cfg = model.config
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    f = (WAN_REF_FRAMES - 1) // 4 + 1
    x = torch.randn(1, f, WAN_HW[0] // 8, WAN_HW[1] // 8, cfg.in_channels,
                    generator=gen, device=dev)
    t = torch.tensor([0.5], device=dev)
    ctx = torch.randn(1, 77, cfg.text_dim, generator=gen, device=dev)
    before = fa.LAUNCHES["flash_attention_bh"]
    with torch.no_grad():
        v = model(x, t, ctx)
        sites = fa.LAUNCHES["flash_attention_bh"] - before
        with mock.patch.object(wan_module, "full_attention",
                               fa.flash_attention_plain):
            ref = model(x, t, ctx)
    require(sites == 2 * cfg.num_layers,
            f"wan reference: {sites} one-head launches per forward")
    require(ref.abs().max().item() > 1e-3, "wan reference: the velocity is 0")
    tokens = f * (WAN_HW[0] // 16) * (WAN_HW[1] // 16)
    compare_whole(torch, f"wan reference: WanModel velocity at "
                  f"{WAN_REF_FRAMES} frames ({tokens} tokens, full depth)",
                  v, ref)


def wan_serve_phase(torch, fa, t2v: WanRun) -> dict:
    """Phase 28: ``workflows/wan-t2v.json`` at ``WAN_SERVED_STEPS`` steps
    through ``POST /distributed/queue`` to a master in this process (the
    t2v phase's bundle) and a ``remote`` worker subprocess that builds its
    own; the
    worker's kernels counted from a ``torch.profiler`` trace of its
    request (``/distributed/profile/start|stop`` on the worker)."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.graph import nodes_builtin
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    prompt = wan_workflow(WAN_T2V, steps=WAN_SERVED_STEPS)
    seen = []
    divide = nodes_builtin.ImageBatchDivider.execute

    def recording(self, images, *a, **kw):
        seen.append(images)
        return divide(self, images, *a, **kw)

    with served_pair(torch, WAN_SERVE_DIR, "wan", WAN_SERVE_DIR / "worker_in",
                     registry=t2v.registry) as served:
        with mock.patch.object(nodes_builtin.ImageBatchDivider, "execute",
                               recording):
            secs, counts, kernels = served_request(fa, served, prompt,
                                                   "served wan")
        master_peak = torch.cuda.max_memory_allocated()
        peak = worker_peak(served.worker_base)
        want_cuda = WAN_SERVED[1]
        worker_k3 = (kernels.get("flash_attention_kernel", 0)
                     + kernels.get("short_kv_attention_kernel", 0)
                     - kernels.get(K1_EVENT, 0))
        say(f"  served wan-t2v.json at {WAN_SERVED_STEPS} steps: {secs:.3f} s "
            f"(POST to final history; direct {t2v.seconds:.3f} s); master "
            f"launches {counts}; worker kernels "
            f"(profiled) {kernels}; peak memory master "
            f"{master_peak / 2**30:.3f} GiB, worker {peak / 2**30:.3f} GiB")
        require(counts == WAN_SERVED[0],
                f"served wan: master launches {counts} != {WAN_SERVED[0]}")
        require(kernels.get(K1_EVENT) == want_cuda["qkv_projection"]
                and kernels.get("flash_attention_kernel")
                == want_cuda["flash_attention_core"]
                and kernels.get("short_kv_attention_kernel")
                == want_cuda["short_kv_attention"]
                and worker_k3 == WAN_SERVED[0]["flash_attention_bh"],
                f"served wan: the worker's kernels {kernels} != {want_cuda}")
        batch = next((s for s in seen if s.shape[0] == 2 * WAN_FRAMES), None)
        require(batch is not None,
                "served wan: no collected batch of two videos")
        require(np_equal(to_uint8(batch[:WAN_FRAMES]), t2v.frames[WAN_SEED]),
                "served wan: the master's video differs from the direct "
                f"seed-{WAN_SEED} video")
        require(np_equal(to_uint8(batch[WAN_FRAMES:]),
                         t2v.frames[WAN_SEED + 1]),
                "served wan: the worker's video differs from the direct "
                f"seed-{WAN_SEED + 1} video")
        check_mp4s(served.master_out, "wan", (WAN_FRAMES, WAN_FRAMES))
        say(f"  wan_v0 bitwise the direct seed-{WAN_SEED} video, wan_v1 the "
            f"seed-{WAN_SEED + 1} video (8-bit frames); the worker ran "
            f"{worker_k3} K3 launches; both mp4s {WAN_FRAMES} frames")
    return counts


def trace_kernels(base: str, out: str):
    """Start ``torch.profiler`` on the controller at ``base``
    (``/distributed/profile/start``); returns a function that stops it and
    counts the trace's attention kernel events by kernel name."""
    status, started = http_json(base + "/distributed/profile/start",
                                {"out": out})
    require(status == 200 and started.get("status") == "tracing",
            f"{base} profile/start answered {status}: {started}")

    def stop() -> dict:
        status, stopped = http_json(base + "/distributed/profile/stop", {},
                                    timeout=600)
        require(status == 200 and stopped.get("trace"),
                f"{base} profile/stop answered {status}: {stopped}")
        return count_kernel_events(stopped["trace"])[0]

    return stop


def write_start_frame(directory: Path) -> None:
    """A seeded 832×480 ``start_frame.png``: a colour gradient with noise."""
    import numpy as np

    from comfyui_distributed_tpu_torch.utils.image import encode_png

    h, w = WAN_HW
    rng = np.random.default_rng(5)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.stack(np.broadcast_arrays(y * x, 1.0 - y,
                                       0.5 + 0.5 * x * (1.0 - y)), axis=-1)
    img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0.0, 1.0)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "start_frame.png").write_bytes(
        encode_png((img * 255.0 + 0.5).astype(np.uint8)))


def wan_i2v_phase(torch, fa) -> dict:
    """Phase 29: ``workflows/wan-i2v.json`` (``wan-i2v``: in_channels 36),
    its 20 steps cut to ``WAN_SERVED_STEPS``, on a seeded 832×480 start
    frame."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    prompt = wan_workflow(WAN_I2V)
    node = prompt["5"]["inputs"]
    require((node["frames"], node["steps"], prompt["1"]["inputs"]["ckpt_name"])
            == (WAN_FRAMES, WAN_STEPS, "wan-i2v"),
            f"{WAN_I2V} changed; update the script")
    node["steps"] = WAN_SERVED_STEPS
    input_dir = WAN_DIR / "i2v_input"
    write_start_frame(input_dir)
    registry = ModelRegistry(DEVICE, seed=0)
    bundle = wan_bundle(torch, registry, "wan-i2v")
    out_dir = WAN_DIR / "i2v"
    executor = GraphExecutor({"model_registry": registry,
                              "input_dir": str(input_dir),
                              "output_dir": str(out_dir)})
    reset_peak(torch)
    fa.reset_launches()
    batch, secs, _ = wan_request(torch, fa, executor, prompt, "wan i2v",
                                 WAN_SERVED, node="6")
    t = bundle.pipeline.timings
    peak = torch.cuda.max_memory_allocated()
    check_mp4s(out_dir, "wan_i2v", WAN_HALVES)
    say(f"  wan-i2v.json: {secs:.3f} s for {WAN_FRAMES} frames; start frame "
        f"VAE encode {t['encode_s']:.3f} s, sampling {t['sample_s']:.3f} s = "
        f"{t['sample_s'] / t['steps']:.4f} s/step, tiled decode "
        f"{t['decode_s']:.3f} s; launches {WAN_SERVED[0]}; batch "
        f"{tuple(batch.shape)}; max_memory_allocated {peak / 2**30:.3f} GiB")
    return dict(fa.LAUNCHES)


def wan22_phase(torch, fa, refs: dict) -> dict:
    """Phase 30: the t2v graph on ``wan-2.2-t2v`` (two WAN 14B experts) at
    ``WAN_SERVED_STEPS`` steps, twice: each expert's model calls equal the
    split, the repeat is bitwise equal. The video (on the host) and the
    peak go to ``refs`` for phase 38."""
    from comfyui_distributed_tpu_torch.diffusion.schedules import sigmas_flow
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    registry = ModelRegistry(DEVICE, seed=0)
    bundle = wan_bundle(torch, registry, "wan-2.2-t2v")
    pipeline = bundle.pipeline
    split = pipeline._expert_split(sigmas_flow(WAN_SERVED_STEPS, 3.0))
    require(split == WAN_SPLIT, f"wan 2.2: expert split {split} != {WAN_SPLIT}")
    prompt = wan_workflow(WAN_T2V, steps=WAN_SERVED_STEPS)
    prompt["1"]["inputs"]["ckpt_name"] = "wan-2.2-t2v"
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(WAN_DIR / "wan22")})
    reset_peak(torch)
    fa.reset_launches()
    batches, seconds = [], []
    for i in range(2):
        batch, secs, _ = wan_request(torch, fa, executor, prompt,
                                     f"wan 2.2 request {i}", WAN_SERVED)
        calls = pipeline.timings["calls"]
        want = {"high": split, "low": WAN_SERVED_STEPS - split}
        require(calls == want, f"wan 2.2: expert calls {calls} != {want}")
        batches.append(batch)
        seconds.append(secs)
    require(torch.equal(batches[0], batches[1]),
            "wan 2.2: the repeated request differs")
    peak = torch.cuda.max_memory_allocated()
    refs["wan22"] = batches[0].cpu()
    refs["wan22_peak"] = peak
    refs["wan22_seconds"] = seconds[0]
    say(f"  wan-2.2-t2v at {WAN_SERVED_STEPS} steps: requests "
        f"{[round(s, 3) for s in seconds]} s; expert calls {calls} (split "
        f"{split}); repeat bitwise equal; launches {WAN_SERVED[0]} a request; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    return dict(fa.LAUNCHES)


def as_published_wan(torch, module) -> None:
    """What a BF16 file holds of ``module``: every parameter (the fp32
    norms, modulations and head too) rounded through BF16."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.to(torch.bfloat16))


def wan_file_phases(torch, fa) -> dict:
    """Phase 31: synthetic WAN files at full width, cut in depth (a WAN 14B
    t2v file under ``model.diffusion_model.``, a ``.high``/``.low`` pair,
    UMT5-XXL in the HF layout, BF16, and a ``tokenizer.json``) through
    ``convert`` (the CLI's ``main``), ``state.pt`` and a restore: every
    parameter's digest the source's; one request from the converted
    ``wan`` bundle with UMT5's 512-token context."""
    import contextlib
    import dataclasses
    import io

    from comfyui_distributed_tpu_torch.__main__ import main as cli
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.convert import (WAN_PREFIXED,
                                                              export_t5,
                                                              export_wan)
    from comfyui_distributed_tpu_torch.models.registry import (ModelRegistry,
                                                               _random)
    from comfyui_distributed_tpu_torch.models.t5 import (T5Encoder,
                                                         UMT5Conditioner)
    from comfyui_distributed_tpu_torch.models.wan import WanConfig, WanModel
    from comfyui_distributed_tpu_torch.parallel.rng import seed_generator
    from comfyui_distributed_tpu_torch.utils.safetensors import save_file

    dev = torch.device(DEVICE)
    tmp = Path(tempfile.mkdtemp(prefix="cdt_wan_"))
    launches = {}
    try:
        cfg = dataclasses.replace(WanConfig.wan_14b(),
                                  num_layers=WAN_FILE_BLOCKS)
        digests, wrote = {}, []
        t0 = time.perf_counter()
        for name, path, prefix in (
                ("wan", tmp / "wan.safetensors", WAN_PREFIXED),
                ("high", tmp / "wan-2.2-t2v.high.safetensors", ""),
                ("low", tmp / "wan-2.2-t2v.low.safetensors", "")):
            model = _random(lambda: WanModel(cfg), dev,
                            seed_generator(WAN_FILE_SEEDS[name], dev))
            as_published_wan(torch, model)
            digests[name] = param_digests(torch, dict(model.named_parameters()))
            wrote.append((path.name, save_file(export_wan(model, prefix), path,
                                               dtype=torch.bfloat16)))
            del model
        t5_cfg = dataclasses.replace(UMT5Conditioner.config(),
                                     num_layers=WAN_FILE_BLOCKS)
        t5 = _random(lambda: T5Encoder(t5_cfg), dev,
                     seed_generator(WAN_FILE_SEEDS["umt5"], dev))
        as_published_wan(torch, t5)
        digests["t5"] = param_digests(torch, dict(t5.named_parameters()))
        wrote.append(("umt5.safetensors", save_file(
            export_t5(t5), tmp / "umt5.safetensors", dtype=torch.bfloat16)))
        del t5
        prompt = wan_workflow(WAN_T2V, steps=WAN_FILE_STEPS)
        words = prompt["2"]["inputs"]["text"].replace(",", "").split()
        write_t5_tokenizer(tmp / "umt5_tok", words)
        os.environ["CDT_T5_TOKENIZER_DIR"] = str(tmp / "umt5_tok")
        gc.collect()
        torch.cuda.empty_cache()
        say(f"  wrote {', '.join(f'{n} {b / 1e9:.3f} GB' for n, b in wrote)} "
            f"(BF16; {WAN_FILE_BLOCKS} of 40 blocks, {WAN_FILE_BLOCKS} of 24 "
            f"UMT5 layers) in {time.perf_counter() - t0:.2f} s")

        root = tmp / "root"
        for preset, args in (
                ("wan", ["--checkpoint", str(tmp / "wan.safetensors"),
                         "--t5", str(tmp / "umt5.safetensors")]),
                ("wan-2.2-t2v",
                 ["--checkpoint", str(tmp / "wan-2.2-t2v.high.safetensors"),
                  "--checkpoint-low",
                  str(tmp / "wan-2.2-t2v.low.safetensors")])):
            buf = io.StringIO()
            t0 = time.perf_counter()
            reset_peak(torch)
            with contextlib.redirect_stdout(buf):
                rc = cli(["convert", "--preset", preset, *args, "--out",
                          str(root / preset), "--device", DEVICE])
            require(rc == 0, f"convert --preset {preset} exited {rc}")
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            out = root / preset
            manifest = json.loads((out / "cdt_manifest.json").read_text())
            require(manifest.get("wan_layers") == WAN_FILE_BLOCKS,
                    f"{preset} manifest: {manifest}")
            peak = line.get("max_memory_allocated", 0) / 2**30
            say(f"  convert --preset {preset}: "
                f"{time.perf_counter() - t0:.2f} s in this process; entries "
                f"{line['entries']}; max_memory_allocated {peak:.3f} GiB; "
                f"state.pt {(out / 'state.pt').stat().st_size / 1e9:.3f} GB")
            gc.collect()
            torch.cuda.empty_cache()

        registry = ModelRegistry(DEVICE, seed=0, checkpoint_root=root)
        t0 = time.perf_counter()
        bundle = registry.get("wan")
        torch.cuda.synchronize()
        say(f"  restored {root / 'wan'} in {time.perf_counter() - t0:.2f} s")
        require_digests_equal("wan core", param_digests(
            torch, dict(bundle.core.named_parameters())), digests["wan"])
        t5_params = dict(bundle.clip_stack.t5.named_parameters())
        require_digests_equal("umt5", param_digests(torch, t5_params),
                              digests["t5"])
        del t5_params
        require(bundle.text_encoder.tokenization_mode == "sp",
                f"umt5 tokenization {bundle.text_encoder.tokenization_mode}")
        executor = GraphExecutor({"model_registry": registry,
                                  "output_dir": str(WAN_DIR / "files")})
        fa.reset_launches()
        _, secs, _ = wan_request(torch, fa, executor, prompt,
                                 "wan from its files", WAN_FILE_COUNTS)
        launches["wan_file"] = dict(fa.LAUNCHES)
        say(f"  wan from its files ({WAN_FILE_BLOCKS} blocks, UMT5 context "
            f"[1, {WAN_UMT5_TOKENS}, 4096]): {secs:.3f} s at "
            f"{WAN_FILE_STEPS} steps; launches {WAN_FILE_COUNTS[0]}, CUDA "
            f"kernels {WAN_FILE_COUNTS[1]} (the cross-attention over "
            f"{WAN_UMT5_TOKENS} keys on the streamed core)")
        registry._cache.clear()
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pair = registry.get("wan-2.2-t2v")
        torch.cuda.synchronize()
        say(f"  restored {root / 'wan-2.2-t2v'} in "
            f"{time.perf_counter() - t0:.2f} s")
        require_digests_equal("wan 2.2 high expert", param_digests(
            torch, dict(pair.core.named_parameters())), digests["high"])
        require_digests_equal("wan 2.2 low expert", param_digests(
            torch, dict(pair.pipeline.dit_low.named_parameters())),
            digests["low"])
        say("  every converted parameter's digest equals its source's (wan, "
            "umt5, the high and the low expert)")
        registry._cache.clear()
        del pair
        built = offload_file_build(torch, root, "wan-2.2-t2v")
        require_digests_equal("offload build, high expert", built["core"],
                              digests["high"])
        require_digests_equal("offload build, low expert", built["core_low"],
                              digests["low"])
        say("  the offload build's experts: every digest their source's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("CDT_T5_TOKENIZER_DIR", None)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def require_digests_equal(what: str, got: dict, want: dict) -> None:
    require(set(got) == set(want),
            f"{what}: parameters {sorted(set(got) ^ set(want))[:8]}")
    bad = [k for k in want if got[k] != want[k]]
    require(not bad, f"{what}: parameters differ from the source: {bad[:8]}")


def video_mmdit_phase(torch, fa) -> dict:
    """Phase 32: ``video-mmdit`` at full width (hidden 5120, 40 heads), cut to
    1 double + 1 single block, through the t2v graph at 5 frames of 832×480
    (the image VAE per frame: 7800 video tokens + 77 text tokens), 2
    steps."""
    import dataclasses

    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import (PRESETS,
                                                               ModelBundle,
                                                               ModelRegistry)

    preset = PRESETS["video-mmdit"]
    preset = dataclasses.replace(preset, video=dataclasses.replace(
        preset.video, depth_double=MMDIT_CUT[0], depth_single=MMDIT_CUT[1]))
    registry = ModelRegistry(DEVICE, seed=0)
    t0 = time.perf_counter()
    adopt(registry, "video-mmdit", ModelBundle(preset, DEVICE, seed=0))
    bundle = wan_bundle(torch, registry, "video-mmdit")
    say(f"  video-mmdit cut to {MMDIT_CUT[0]} double + {MMDIT_CUT[1]} single "
        f"blocks, built in {time.perf_counter() - t0:.2f} s")
    prompt = wan_workflow(WAN_T2V, frames=MMDIT_FRAMES, steps=MMDIT_STEPS)
    prompt["1"]["inputs"]["ckpt_name"] = "video-mmdit"
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(WAN_DIR / "mmdit")})
    reset_peak(torch)
    fa.reset_launches()
    _, secs, _ = wan_request(torch, fa, executor, prompt, "video-mmdit",
                             MMDIT_COUNTS, frames=MMDIT_FRAMES)
    t = bundle.pipeline.timings
    say(f"  video-mmdit: {secs:.3f} s for {MMDIT_FRAMES} frames at "
        f"{MMDIT_STEPS} steps ({MMDIT_TOKENS} joint tokens); sampling "
        f"{t['sample_s']:.3f} s, per-frame decode {t['decode_s']:.3f} s; "
        f"launches {MMDIT_COUNTS[0]}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return dict(fa.LAUNCHES)


def wan_phases(torch, fa, refs: dict) -> dict:
    """Phases 26 to 32, each bundle dropped before the next is built;
    returns their launches by path (phase 30's video into ``refs``)."""
    launches = {}
    with phase(torch, "26 wan t2v"):
        t2v = wan_t2v_phase(torch, fa)
        launches["wan_t2v"] = t2v.launches
    with phase(torch, "27 wan reference"):
        wan_reference_phase(torch, fa, t2v.registry.get("wan"))
    with phase(torch, "28 wan served"):
        launches["wan_serve"] = wan_serve_phase(torch, fa, t2v)
    del t2v
    free_card(torch)
    with phase(torch, "29 wan i2v"):
        launches["wan_i2v"] = wan_i2v_phase(torch, fa)
    free_card(torch)
    with phase(torch, "30 wan 2.2"):
        launches["wan22"] = wan22_phase(torch, fa, refs)
    free_card(torch)
    with phase(torch, "31 wan files"):
        launches.update(wan_file_phases(torch, fa))
    free_card(torch)
    with phase(torch, "32 video-mmdit"):
        launches["video_mmdit"] = video_mmdit_phase(torch, fa)
    free_card(torch)
    return launches


# --- phases 33 to 37: SD3 ----------------------------------------------------

SD3_DIR = OUTPUT_DIR / "sd3"
SD3_SERVE_DIR = OUTPUT_DIR / "serve_sd3"
SD3_SEED = 31                # the graph's seed (the served worker's is 32)
SD3_FILE_SEED = 33           # the CLIP-L, CLIP-G and T5 drawn for the files
SD3_T5_CUT = 2               # T5-XXL layers in the files (the write cap)
SD3_POSITIVE = "a cinematic photo of a lighthouse at dawn, crashing waves"
SD3_NEGATIVE = "blurry, low quality, watermark"


def sd3_workflow(ckpt: str, seed: int = SD3_SEED) -> dict:
    """The SD3 txt2img graph (no workflow file ships it): ``CheckpointLoader``
    → positive and negative ``CLIPTextEncode`` → ``ModelSamplingSD3`` (shift
    3.0) → ``TPUFlowTxt2Img`` (``dp``, 1024², ``SD3_RUN_STEPS`` of its 28
    euler steps, CFG 4.5, the negative wired; the seed through
    ``DistributedSeed``) → ``DistributedCollector`` → ``SaveImage``."""
    sampler = {"model": ["4", 0], "positive": ["2", 0], "negative": ["3", 0],
               "seed": ["5", 0], "steps": SD3_RUN_STEPS, "width": SD3_HW,
               "height": SD3_HW, "cfg": SD3_CFG, "mode": "dp"}
    return {
        "1": {"class_type": "CheckpointLoader", "inputs": {"ckpt_name": ckpt}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": SD3_POSITIVE, "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": SD3_NEGATIVE, "clip": ["1", 1]}},
        "4": {"class_type": "ModelSamplingSD3",
              "inputs": {"model": ["1", 0], "shift": SD3_SHIFT}},
        "5": {"class_type": "DistributedSeed", "inputs": {"seed": seed}},
        "6": {"class_type": "TPUFlowTxt2Img", "inputs": sampler},
        "7": {"class_type": "DistributedCollector", "inputs": {"images": ["6", 0]}},
        "8": {"class_type": "SaveImage",
              "inputs": {"images": ["7", 0], "filename_prefix": "sd3"}},
    }


def sd3_bundle(torch, registry, name: str):
    t0 = time.perf_counter()
    bundle = registry.get(name)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in bundle.core.parameters())
    say(f"  {name} bundle built in {time.perf_counter() - t0:.2f} s ({n / 1e9:.3f}"
        f" B DiT params, {n} exactly; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated)")
    return bundle


def sd3_requests(torch, fa, registry, name: str, seeds: tuple, want: tuple,
                 out_dir: Path) -> tuple:
    """The SD3 graph on ``name`` once per seed: each request's launches per
    wrapper and per CUDA kernel must be ``want``; returns (the images, the
    PNG bytes, the seconds, the launches of the run)."""
    from unittest import mock

    import torch.nn.functional as F

    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(out_dir)})
    bundle = registry.get(name)
    fa.reset_launches()
    images, pngs, seconds = [], [], []
    sdpa = mock.Mock(wraps=F.scaled_dot_product_attention)
    for seed in seeds:
        png = out_dir / "sd3_00000.png"
        png.unlink(missing_ok=True)
        reset_peak(torch)
        with mock.patch.object(F, "scaled_dot_product_attention", sdpa):
            img, secs, _ = run_counted(torch, fa, executor,
                                       sd3_workflow(name, seed), "6", want,
                                       f"{name} seed {seed}", (SD3_HW, SD3_HW))
        require(sdpa.call_count == 0,
                f"{name}: {sdpa.call_count} scaled_dot_product_attention calls")
        t = bundle.pipeline.timings
        require(png.is_file() and png_size(png) == (SD3_HW, SD3_HW),
                f"{png} missing or not {SD3_HW}x{SD3_HW}")
        say(f"  {name} seed {seed}: {secs:.3f} s; sampling {t['sample_s']:.3f} "
            f"s = {t['sample_s'] / t['steps']:.4f} s/step over {t['steps']} "
            f"steps (CFG batch 2); decode {t['decode_s']:.3f} s; launches "
            f"{want[0]}, CUDA kernels {want[1]}, SDPA calls 0; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        images.append(img)
        pngs.append(png.read_bytes())
        seconds.append(secs)
    return images, pngs, seconds, dict(fa.LAUNCHES)


class Sd3Run(NamedTuple):
    registry: object        # holding sd3-medium
    pngs: dict              # seed → PNG bytes of its direct request
    seconds: list


def sd3_medium_phase(torch, fa) -> tuple:
    """Phase 33: the SD3 graph on ``sd3-medium`` at full width and depth
    (random init from seed 0) at seeds 31, 32, 31: 8 K1 (the hash encoder,
    two prompts) and 24 × 8 = 192 K2 on the streamed core at [2, 4173,
    24·64] a request; the repeat bitwise, the seeds different."""
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    registry = ModelRegistry(DEVICE, seed=0)
    sd3_bundle(torch, registry, "sd3-medium")
    seeds = (SD3_SEED, SD3_SEED + 1, SD3_SEED)
    images, pngs, seconds, launches = sd3_requests(
        torch, fa, registry, "sd3-medium", seeds, SD3_REQUEST, SD3_DIR / "medium")
    require(torch.equal(images[0], images[2]),
            f"sd3-medium: seed {SD3_SEED} twice gave different images")
    require(not torch.equal(images[0], images[1]),
            f"sd3-medium: seeds {SD3_SEED} and {SD3_SEED + 1} gave one image")
    say(f"  sd3-medium: seed {SD3_SEED} repeatable, seed {SD3_SEED + 1} differs")
    return Sd3Run(registry, {SD3_SEED: pngs[0], SD3_SEED + 1: pngs[1]},
                  seconds), launches


def sd3_reference(torch, fa, bundle, what: str, wrapper: str) -> None:
    """One DiT velocity at the path's shape (1024², CFG batch 2, 77 context
    tokens: 4173 in each joint attention) through the kernels and with
    its attention sites on the plain version."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.models import dit as dit_module

    model = bundle.core
    cfg = model.config
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(2, SD3_HW // 8, SD3_HW // 8, cfg.in_channels,
                    generator=gen, device=dev)
    t = torch.tensor([0.6, 0.6], device=dev)
    ctx = torch.randn(2, 77, cfg.context_dim, generator=gen, device=dev)
    pooled = torch.randn(2, cfg.pooled_dim, generator=gen, device=dev)
    before = fa.LAUNCHES[wrapper]
    with torch.no_grad():
        v = model(x, t, ctx, pooled)
        sites = fa.LAUNCHES[wrapper] - before
        with mock.patch.object(dit_module, "full_attention",
                               fa.flash_attention_plain):
            ref = model(x, t, ctx, pooled)
    require(sites == cfg.depth_double,
            f"{what} reference: {sites} {wrapper} launches per forward")
    require(ref.abs().max().item() > 1e-3, f"{what} reference: the velocity is 0")
    compare_whole(torch, f"{what} reference: DiT velocity at {SD3_HW}² "
                  f"({SD3_TOKENS} tokens, batch 2, full depth)", v, ref)


def sd35_phase(torch, fa) -> dict:
    """Phase 35: the SD3 graph on ``sd35-large`` (38 joint blocks of 38
    heads of 64: H·D 2432, past the packed layout's widest row) at seed 31
    twice: 8 K1 and 38 × 8 = 304 K3 at [2·38, 4173, 64] a request, the
    repeat bitwise; then its reference forward."""
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    registry = ModelRegistry(DEVICE, seed=0)
    bundle = sd3_bundle(torch, registry, "sd35-large")
    images, _, seconds, launches = sd3_requests(
        torch, fa, registry, "sd35-large", (SD3_SEED, SD3_SEED), SD35_REQUEST,
        SD3_DIR / "large")
    require(torch.equal(images[0], images[1]),
            f"sd35-large: seed {SD3_SEED} twice gave different images")
    say(f"  sd35-large: seed {SD3_SEED} repeatable; requests "
        f"{[round(s, 3) for s in seconds]} s")
    sd3_reference(torch, fa, bundle, "sd35-large", "flash_attention_bh")
    return launches


def sd3_serve_phase(torch, fa, run: Sd3Run) -> dict:
    """Phase 36: the SD3 graph on ``sd3-medium`` through ``POST
    /distributed/queue`` to a master in this process (phase 33's bundle)
    and a ``remote`` worker subprocess that builds its own: the master's
    PNG bitwise the direct seed-31 image, the worker's the seed-32 one;
    the master's launches 8 K1 + 192 K2, the worker's kernels counted from
    a ``torch.profiler`` trace of its request. Both hosts run the content
    cache's defaults: each encodes both prompts once (2 misses)."""
    off = {k: os.environ.pop(k, None) for k in ("CDT_CACHE", "CDT_STAGES")}
    try:
        return sd3_served(torch, fa, run)
    finally:
        for k, v in off.items():
            if v is not None:
                os.environ[k] = v


def sd3_served(torch, fa, run: Sd3Run) -> dict:
    with served_pair(torch, SD3_SERVE_DIR, "sd3", SD3_SERVE_DIR / "worker_in",
                     registry=run.registry) as served:
        secs, counts, kernels = served_request(
            fa, served, sd3_workflow("sd3-medium"), "served sd3")
        want = SD3_REQUEST[1]
        say(f"  served sd3-medium: {secs:.3f} s (POST to final history; direct "
            f"{[round(s, 3) for s in run.seconds]} s); master launches "
            f"{counts}; worker kernels (profiled) {kernels}; peak memory "
            f"master {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
            f"worker {worker_peak(served.worker_base) / 2**30:.3f} GiB")
        require(counts == SD3_REQUEST[0],
                f"served sd3: master launches {counts} != {SD3_REQUEST[0]}")
        require(kernels.get(K1_EVENT) == want["qkv_projection"]
                and kernels.get("flash_attention_kernel")
                == want["flash_attention_core"]
                and kernels.get("short_kv_attention_kernel")
                == want["short_kv_attention"],
                f"served sd3: the worker's kernels {kernels} != {want}")
        for k, seed in enumerate((SD3_SEED, SD3_SEED + 1)):
            png = served.master_out / f"sd3_0000{k}.png"
            require(png.is_file() and png.read_bytes() == run.pngs[seed],
                    f"served sd3: {png.name} is not the direct seed-{seed} "
                    "image")
        say(f"  sd3_00000.png bitwise the direct seed-{SD3_SEED} image, "
            f"sd3_00001.png the seed-{SD3_SEED + 1} image; the worker ran "
            f"{want['flash_attention_core']} K2 launches")
        master_cond = served.master.cache.conditioning.stats()
        status, worker_cache = http_json(served.worker_base + "/distributed/cache")
        worker_cond = worker_cache.get("conditioning", {})
        say(f"  conditioning tier: master {master_cond}, worker {worker_cond}")
        require(master_cond["miss"] == 2 and master_cond["hit"] == 0
                and master_cond["persisted"] == 2,
                f"served sd3: the master's conditioning tier {master_cond}")
        require(status == 200 and worker_cond.get("miss") == 2,
                f"served sd3: the worker's cache answered {status}: "
                f"{worker_cache}")
    return counts


def as_published_sd3(torch, dit) -> None:
    """What a BF16 SAI file holds of a DiT: every parameter rounded
    through BF16, the last context block pre-only (its gates, second
    shift/scale and text outputs zero) and the final adaLN without its
    gate third."""
    h, last = dit.config.hidden, dit.config.depth_double - 1
    blk = getattr(dit, f"double_{last}")
    with torch.no_grad():
        for p in dit.parameters():        # the fp32 table and img_out too
            p.copy_(p.to(torch.bfloat16))
        for p in (blk.txt_mod.mod.weight, blk.txt_mod.mod.bias,
                  dit.final_mod.mod.weight, dit.final_mod.mod.bias):
            p[2 * h:].zero_()
        for m in (blk.txt_proj, blk.txt_mlp_up, blk.txt_mlp_down):
            m.weight.zero_()
            m.bias.zero_()


def sd3_file_phase(torch, fa, run: Sd3Run) -> dict:
    """Phase 37: SD3's files at full width (the sd3-medium bundle of phase
    33 as an SAI file at full depth, BF16; CLIP-L with its projection and
    CLIP-G as F16 ``text_model.*``; T5-XXL cut to 2 layers, F8_E4M3; the
    CLIP vocabulary and T5 ``tokenizer.json``), ``convert --preset
    sd3-medium --t5 --clip-l`` (the CLI's ``main`` in this process) →
    ``state.pt`` → a fresh registry's restore, CLIP-G through
    ``load_text_encoder_files`` (the CLI has no ``--clip-g``, as JAX's):
    every parameter's digest the source's, the context ([1, 589, 4096]),
    pooled vector and a velocity at 4685 tokens bitwise the source's; one
    request from it: 0 K1 and 192 K2 at [2, 4685, 24·64]."""
    import contextlib
    import io

    from comfyui_distributed_tpu_torch.__main__ import main as cli
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.clip import CLIPTextTransformer
    from comfyui_distributed_tpu_torch.models.convert import (
        FLUX_PREFIXED, export_clip_hf, export_mmdit_sd3, export_t5)
    from comfyui_distributed_tpu_torch.models.registry import (ModelRegistry,
                                                               _random)
    from comfyui_distributed_tpu_torch.models.t5 import SD3TextStack, T5Encoder
    from comfyui_distributed_tpu_torch.utils.safetensors import save_file

    dev = torch.device(DEVICE)
    tmp = Path(tempfile.mkdtemp(prefix="cdt_sd3_"))
    try:
        write_vocab(tmp / "tokenizer")
        write_t5_tokenizer(tmp / "t5_tokenizer", sorted(set(
            (SD3_POSITIVE + " " + SD3_NEGATIVE).replace(",", "").split())))
        os.environ["CDT_TOKENIZER_DIR"] = str(tmp / "tokenizer")
        os.environ["CDT_T5_TOKENIZER_DIR"] = str(tmp / "t5_tokenizer")
        t0 = time.perf_counter()
        dit = run.registry.get("sd3-medium").core
        as_published_sd3(torch, dit)
        gen = torch.Generator(device=dev).manual_seed(SD3_FILE_SEED)
        cfg_l, cfg_g, cfg_t5 = SD3TextStack.configs()
        cfg_t5 = dataclasses.replace(cfg_t5, num_layers=SD3_T5_CUT)
        clip_l = _random(lambda: CLIPTextTransformer(cfg_l), dev, gen)
        clip_g = _random(lambda: CLIPTextTransformer(cfg_g), dev, gen)
        t5 = _random(lambda: T5Encoder(cfg_t5), dev, gen)
        for tower in (clip_l, clip_g):
            round_fp16(torch, dict(tower.named_parameters()))
        with torch.no_grad():             # held exactly by an e4m3 file
            for p in t5.parameters():
                p.copy_(p.to(torch.float8_e4m3fn))
        stack = SD3TextStack(clip_l, clip_g, t5).eval()
        require(stack.tokenization_mode == "real",
                f"source stack tokenization {stack.tokenization_mode}")
        towers = {"core": dit, "clip_l": clip_l, "clip_g": clip_g, "t5": t5}
        digests = param_digests(torch, {f"{e}.{k}": p for e, m in towers.items()
                                        for k, p in m.named_parameters()})
        with torch.no_grad():
            context, pooled = stack.encode([SD3_POSITIVE])
            x = torch.randn(1, SD3_HW // 8, SD3_HW // 8, dit.config.in_channels,
                            generator=gen, device=dev)
            v = dit(x, torch.tensor([0.6], device=dev), context, pooled)
        dcfg = dit.config
        require(tuple(context.shape) == (1, 77 + SD3_T5_TOKENS, dcfg.context_dim)
                and tuple(pooled.shape) == (1, dcfg.pooled_dim),
                f"source conditioning {tuple(context.shape)}, "
                f"{tuple(pooled.shape)}")
        source = (context.cpu(), pooled.cpu(), x, v.cpu())
        files = {"sd3_medium.safetensors": (export_mmdit_sd3(dit, FLUX_PREFIXED),
                                            torch.bfloat16),
                 "clip_l.safetensors": (export_clip_hf(clip_l), torch.float16),
                 "clip_g.safetensors": (export_clip_hf(clip_g), torch.float16),
                 "t5xxl_cut.safetensors": (export_t5(t5), torch.float8_e4m3fn)}
        wrote = []
        for name, (tensors, dtype) in files.items():
            wrote.append(f"{name} {save_file(tensors, tmp / name, dtype=dtype) / 1e9:.3f}"
                         f" GB {str(dtype).split('.')[-1]}")
        del files, tensors, towers, stack, clip_l, clip_g, t5, dit, context, pooled
        run.registry._cache.pop("sd3-medium")
        gc.collect()
        torch.cuda.empty_cache()
        write_s = time.perf_counter() - t0
        say(f"  sd3 files: wrote {', '.join(wrote)} in {write_s:.2f} s (sources "
            f"and digests included); the sources dropped, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")

        root = tmp / "root"
        buf = io.StringIO()
        reset_peak(torch)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(["convert", "--preset", "sd3-medium", "--checkpoint",
                      str(tmp / "sd3_medium.safetensors"),
                      "--t5", str(tmp / "t5xxl_cut.safetensors"),
                      "--clip-l", str(tmp / "clip_l.safetensors"),
                      "--out", str(root / "sd3-medium"), "--device", DEVICE])
        convert_s = time.perf_counter() - t0
        require(rc == 0, f"convert --preset sd3-medium exited {rc}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        manifest = json.loads((root / "sd3-medium" / "cdt_manifest.json").read_text())
        state = root / "sd3-medium" / "state.pt"
        require(line["entries"] == ["clip_g", "clip_l", "core", "t5", "vae_dec"]
                and manifest.get("t5_layers") == SD3_T5_CUT
                and manifest.get("depth") == {"double": dcfg.depth_double,
                                              "single": 0},
                f"converted entries {line['entries']}, manifest {manifest}")
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak(torch)
        t0 = time.perf_counter()
        registry = ModelRegistry(DEVICE, seed=0, checkpoint_root=root)
        bundle = registry.get("sd3-medium")
        bundle.load_text_encoder_files(clip_g=tmp / "clip_g.safetensors")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = param_digests(torch, {k: p for k, p in bundle_params(bundle).items()
                                    if not k.startswith("vae_dec.")})
        require(set(got) == set(digests),
                f"restored parameter names differ: "
                f"{sorted(set(got) ^ set(digests))[:4]}")
        bad = [k for k in got if got[k] != digests[k]]
        require(not bad, f"restored sd3: {len(bad)} parameters differ from the "
                f"source's, e.g. {bad[:4]}")
        stack = bundle.text_encoder
        require(stack.tokenization_mode == "real",
                f"tokenization mode {stack.tokenization_mode}")
        with torch.no_grad():
            context, pooled = stack.encode([SD3_POSITIVE])
            v = bundle.core(source[2], torch.tensor([0.6], device=dev), context,
                            pooled)
        require(torch.equal(context.cpu(), source[0])
                and torch.equal(pooled.cpu(), source[1]),
                "the restored context or pooled vector differs from the source's")
        require(torch.equal(v.cpu(), source[3]),
                f"the velocity at {SD3_FILE_TOKENS} tokens differs from the "
                "source's")
        say(f"  convert {convert_s:.2f} s (peak "
            f"{line.get('max_memory_allocated', 0) / 2**30:.3f} GiB; state.pt "
            f"{state.stat().st_size / 1e9:.3f} GB), restore + CLIP-G "
            f"{restore_s:.2f} s; all {len(got)} parameters bitwise the "
            f"source's (digests); tokenization real; context "
            f"{tuple(context.shape)}, pooled vector and the velocity at "
            f"{SD3_FILE_TOKENS} tokens bitwise the source's")
        del context, pooled, v
        fa.reset_launches()
        sd3_file_requests(torch, fa, registry, stack, tmp / "cache")
        return dict(fa.LAUNCHES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for var in ("CDT_TOKENIZER_DIR", "CDT_T5_TOKENIZER_DIR"):
            os.environ.pop(var, None)


def sd3_file_requests(torch, fa, registry, stack, cache_dir: Path) -> None:
    """Phase 37's requests from the restored files at seed 31, through
    ``CLIPTextEncode``'s conditioning tier on the three real towers:
    a miss that encodes and persists, a memory hit, and a hit from the
    persisted tier under a new cache; each 0 K1 and 192 K2, the hits'
    images and PNGs bitwise the first's."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.cluster.cache import CacheManager
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    out_dir = SD3_DIR / "file"
    png = out_dir / "sd3_00000.png"
    encode = type(stack).encode
    encodes = []

    def counted(self, texts):
        encodes.append(list(texts))
        return encode(self, texts)

    cache = CacheManager(directory=cache_dir)
    runs = (("from its files", cache, 2, {"miss": 2, "persisted": 2}),
            ("again (conditioning from memory)", cache, 2, {"hit": 2}),
            ("with a new cache over the persisted tier",
             CacheManager(directory=cache_dir), 2, {"disk_hit": 2}))
    first = None
    for what, manager, want_encodes, want_counts in runs:
        executor = GraphExecutor({"model_registry": registry,
                                  "output_dir": str(out_dir),
                                  "content_cache": manager})
        png.unlink(missing_ok=True)
        reset_peak(torch)
        with mock.patch.object(type(stack), "encode", counted):
            img, secs, _ = run_counted(torch, fa, executor,
                                       sd3_workflow("sd3-medium"), "6",
                                       SD3_FILE_REQUEST,
                                       f"sd3-medium {what}", (SD3_HW, SD3_HW))
        cond = manager.conditioning.counts
        require(len(encodes) == want_encodes
                and all(cond[k] == n for k, n in want_counts.items()),
                f"sd3-medium {what}: {len(encodes)} encodes in all, "
                f"conditioning tier {cond}, wanted {want_encodes} and "
                f"{want_counts}")
        require(png.is_file() and png_size(png) == (SD3_HW, SD3_HW),
                f"{png} missing or not {SD3_HW}x{SD3_HW}")
        if first is None:
            first = (img, png.read_bytes())
        else:
            require(torch.equal(img, first[0]) and png.read_bytes() == first[1],
                    f"sd3-medium {what}: the image is not the first request's")
        t = registry.get("sd3-medium").pipeline.timings
        say(f"  one request {what}: {secs:.3f} s; sampling "
            f"{t['sample_s']:.3f} s = {t['sample_s'] / t['steps']:.4f} s/step; "
            f"launches {SD3_FILE_REQUEST[0]}, CUDA kernels "
            f"{SD3_FILE_REQUEST[1]}; text encodes {len(encodes)} in all; "
            f"conditioning {dict(cond)}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    say("  the memory and persisted conditioning hits gave the first "
        "request's image and PNG bitwise")


def sd3_phases(torch, fa) -> dict:
    """Phases 33 to 37, sd3-medium's bundle kept for the served and file
    phases, sd35-large's dropped after its own; returns their launches by
    path."""
    launches = {}
    with phase(torch, "33 sd3-medium"):
        run, launches["sd3"] = sd3_medium_phase(torch, fa)
    with phase(torch, "34 sd3-medium reference"):
        sd3_reference(torch, fa, run.registry.get("sd3-medium"), "sd3-medium",
                      "flash_attention_packed")
    with phase(torch, "35 sd35-large"):
        launches["sd35"] = sd35_phase(torch, fa)
    free_card(torch)
    with phase(torch, "36 sd3 served"):
        launches["sd3_serve"] = sd3_serve_phase(torch, fa, run)
    with phase(torch, "37 sd3 files"):
        launches["sd3_file"] = sd3_file_phase(torch, fa, run)
    del run
    free_card(torch)
    return launches



# --- phase clock -------------------------------------------------------------


# the running phase's peak allocated bytes before the last reset_peak
# --- phase 14c: the serving front door ----------------------------------------

FD_DIR = OUTPUT_DIR / "frontdoor"
FD_WINDOW_MS = "1500"        # the coalescing window: concurrent posts meet
FD_SEEDS = (41, 42, 43, 44)
FD_PRIORITIES = ("interactive", "interactive", "batch", "batch")
FD_NEGATIVE = "blurry, low quality, watermark"
FD_SHED_DEPTH = "2"          # the second master sheds from the third request
FD_BURST = 6
FD_BURST_HW, FD_BURST_STEPS = 512, 4
FD_TEXT_K1 = 4               # K1 launches of one text encode (4 layers)
# 14c's requests run 8 of the workflow's 30 steps (a depth cut for the
# run's time limit; PERF.md §4): 560 K1 and 560 K2 a request
FD_STEPS = 8
FD_UNET = {"fused_qkv_attention": sum(n for _, n in FUSED_SHAPES[:2]),  # 2100
           "flash_attention_packed": sum(n for _, n in PACKED_SHAPES),  # 2100
           "flash_attention_bh": 0}


def fd_prompt(seed: int, positive: str, prefix: str, hw: int = 1024,
              steps: int = STEPS) -> dict:
    """The batchable graph: ``CheckpointLoader("sdxl")`` → positive and
    negative ``CLIPTextEncode`` → ``TPUTxt2Img`` (euler, karras, CFG 5) →
    ``SaveImage``; no collector, so the front door can group it."""
    return {
        "1": {"class_type": "CheckpointLoader",
              "inputs": {"ckpt_name": "sdxl"}},
        "2": {"class_type": "CLIPTextEncode",
              "inputs": {"text": positive, "clip": ["1", 1]}},
        "3": {"class_type": "CLIPTextEncode",
              "inputs": {"text": FD_NEGATIVE, "clip": ["1", 1]}},
        "4": {"class_type": "TPUTxt2Img", "inputs": {
            "model": ["1", 0], "positive": ["2", 0], "negative": ["3", 0],
            "seed": seed, "steps": steps, "cfg": 5.0, "width": hw,
            "height": hw, "sampler_name": "euler", "scheduler": "karras"}},
        "5": {"class_type": "SaveImage",
              "inputs": {"images": ["4", 0], "filename_prefix": prefix}},
    }


def fd_positive(i: int) -> str:
    return f"a lighthouse on a cliff at dusk, oil painting, variant {i}"


def fd_counts(text_encodes: int, requests: int) -> dict:
    """Launches of ``requests`` SDXL UNet runs at ``FD_STEPS`` and
    ``text_encodes`` encodes of the hash text encoder."""
    return {k: v // STEPS * FD_STEPS * requests
            + (FD_TEXT_K1 * text_encodes if k == "fused_qkv_attention" else 0)
            for k, v in FD_UNET.items()}


@contextlib.contextmanager
def fd_master(torch, name: str, registry, env: dict,
              config: dict | None = None, home: Path | None = None):
    """A master ``Controller`` on the card (no workers unless ``config``
    lists some), behind a ``ServerThread``, built under ``env`` with the
    defaults of the front door, the cache (its own cache directory,
    empty), its fleet tier and the stage pools; yields (master, base URL,
    output directory)."""
    from comfyui_distributed_tpu_torch.api.app import ServerThread
    from comfyui_distributed_tpu_torch.cluster.controller import Controller

    home = home or FD_DIR / name
    home.mkdir(parents=True)
    (home / "master.json").write_text(json.dumps(config or {}))
    full = {"CDT_OUTPUT_DIR": str(home / "out"),
            "CDT_CACHE_DIR": str(home / "cache"), "CDT_CACHE": "1",
            "CDT_FRONTDOOR": "1", "CDT_STAGES": "1", **env}
    saved = {k: os.environ.get(k) for k in full}
    os.environ.update(full)
    try:
        master = Controller(home / "master.json", device=DEVICE,
                            model_registry=registry)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(master.frontdoor is not None and master.cache is not None
            and master.stages is not None,
            f"{name}: the front door, the cache or the stages are off by "
            "default")
    server = ServerThread(master, port=free_port())
    try:
        yield master, f"http://127.0.0.1:{server.port}", home / "out"
    finally:
        server.stop()


def http_with_headers(url: str, payload: dict) -> tuple[int, dict, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, dict(e.headers), json.loads(e.read())


def wait_final(master, prompt_id: str, what: str) -> dict:
    """The history entry of ``prompt_id`` once terminal (the front door
    adds ``expired``)."""
    t0 = time.perf_counter()
    while True:
        entry = master.queue.history.get(prompt_id)
        if entry is not None and entry.get("status") in (
                "success", "error", "interrupted", "expired"):
            return entry
        require(time.perf_counter() - t0 < SERVE_REQUEST_S,
                f"{what} not final after {SERVE_REQUEST_S} s")
        time.sleep(0.02)


def histogram(snap: dict, name: str) -> dict:
    """label tuple → (count, sum) of a histogram in a registry snapshot."""
    return {tuple(sorted(s["labels"].items())): (s["count"], s["sum"])
            for s in snap.get(name, {}).get("series", [])}


def frontdoor_phase(torch, fa, sdxl: PathRun) -> dict:
    """Phase 14c: concurrent SDXL txt2img requests through a master's
    front door with its defaults; returns the master's launches."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from comfyui_distributed_tpu_torch import telemetry
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    shutil.rmtree(FD_DIR, ignore_errors=True)
    FD_DIR.mkdir(parents=True)
    telemetry.set_enabled(True)
    registry = sdxl.registry
    # each member alone, content_cache absent: the reference bytes
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(FD_DIR / "solo")})
    solo_png, solo_s = {}, []
    for i, seed in enumerate(FD_SEEDS):
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        executor.execute(fd_prompt(seed, fd_positive(i), f"fd{i}",
                                   steps=FD_STEPS))
        torch.cuda.synchronize()
        solo_s.append(time.perf_counter() - t0)
        counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        require(counts == fd_counts(2, 1),
                f"front door: solo request {i}: launches {counts}")
        solo_png[i] = (FD_DIR / "solo" / f"fd{i}_00000.png").read_bytes()
    say(f"  four solo requests: {sum(solo_s):.3f} s "
        f"({', '.join(f'{s:.3f}' for s in solo_s)}); each "
        f"{fd_counts(2, 1)}")

    launches = {k: 0 for k in fa.LAUNCHES}

    def counted(fn):
        before = dict(fa.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        delta = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        for k in delta:
            launches[k] += delta[k]
        return out, delta

    telemetry.REGISTRY.reset()
    with fd_master(torch, "master", registry,
                   {"CDT_FD_WINDOW_MS": FD_WINDOW_MS}) as (master, base, out):
        queue = base + "/distributed/queue"

        def post(i: int, **extra) -> tuple[int, dict]:
            return http_json(queue, {
                "prompt": fd_prompt(FD_SEEDS[i], fd_positive(i), f"fd{i}",
                                    steps=FD_STEPS),
                "tenant": f"user{i}", "priority": FD_PRIORITIES[i], **extra})

        # gates 1 and 2: four at once, then member 0's twin while it runs
        def group():
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as pool:
                answers = list(pool.map(post, range(4)))
            twin = post(0)
            entries = [wait_final(master, a["prompt_id"], f"member {i}")
                       for i, (_, a) in enumerate(answers)]
            twin_entry = wait_final(master, twin[1]["prompt_id"], "the twin")
            return answers, twin, entries, twin_entry, time.perf_counter() - t0

        (answers, twin, entries, twin_entry, group_s), delta = counted(group)
        ids = []
        for i, (status, a) in enumerate(answers):
            require(status == 200 and a.get("batched") is True
                    and a.get("coalesced") is False
                    and a.get("outcome") == "admitted",
                    f"front door: member {i} answered {status}: {a}")
            ids.append(a["prompt_id"])
        for i, e in enumerate(entries):
            require(e["status"] == "success" and e.get("batch_size") == 4,
                    f"front door: member {i}: {e}")
            png = out / f"fd{i}_00000.png"
            require(png.is_file() and png.read_bytes() == solo_png[i],
                    f"front door: member {i}'s PNG is not its solo run's")
        require(twin[0] == 200 and twin[1].get("coalesced") is True
                and twin[1].get("batched") is True,
                f"front door: the twin answered {twin}")
        require(twin_entry.get("coalesced_with") == ids[0]
                and twin_entry["status"] == "success"
                and twin_entry.get("outputs") == entries[0].get("outputs"),
                f"front door: the twin's history {twin_entry}")
        # five encodes ran: four positives and the shared negative once
        want = fd_counts(5, 4)
        saved = {k: fd_counts(2, 1)[k] * 4 - want[k] for k in want}
        require(delta == want,
                f"front door: the group's launches {delta} != {want} (the "
                f"solo runs' sum less the conditioning tier's {saved})")
        snap = telemetry.REGISTRY.snapshot()
        sizes = histogram(snap, "cdt_batch_size")
        require(sizes.get(()) == (1, 4.0),
                f"front door: cdt_batch_size observed {sizes}, not one 4")
        # the group ran the staged lane (encode, denoise, decode pools),
        # not the fused fallback
        status, st = http_json(base + "/distributed/stages")
        require(status == 200 and st.get("enabled") is True
                and st["groups"] >= 1 and st["members"] >= 4
                and st["fallbacks"] == 0 and st["redispatched"] == 0,
                f"front door: the stage pools answered {status}: {st}")
        decoded = histogram(snap, "cdt_decode_batch_size").get(())
        require(decoded is not None and decoded[0] >= 1
                and decoded[1] == 4.0
                and all(e.get("decode_batch") for e in entries),
                f"front door: cdt_decode_batch_size observed {decoded}, "
                f"entries {entries}")
        done = {k: v["done"] for k, v in st["pools"].items()}
        say(f"  staged: {st['groups']} group, {st['members']} members, "
            f"fallbacks {st['fallbacks']}, redispatched "
            f"{st['redispatched']}; {decoded[0]} decode batch(es) for 4 "
            f"latents (history decode_batch "
            f"{[e['decode_batch'] for e in entries]}); pools done {done}")
        waits = histogram(snap, "cdt_queue_wait_seconds")
        say(f"  group of four (+ a coalesced twin): {group_s:.3f} s against "
            f"{sum(solo_s):.3f} s solo ({group_s / sum(solo_s):.3f}×); "
            f"launches {delta} = solo {fd_counts(2, 1)} × 4 less {saved}")
        for labels, (n, total) in sorted(waits.items()):
            say(f"  queue wait {dict(labels)['priority']}: {n} request(s), "
                f"mean {total / n:.3f} s")
        status, stats = http_json(base + "/distributed/cache")
        cond = stats["conditioning"]
        require(status == 200 and cond["hit"] >= 3 and cond["miss"] == 5,
                f"front door: conditioning tier {cond}")
        say(f"  conditioning tier: {cond['hit']} hits, {cond['miss']} misses "
            f"(the shared negative encoded once)")

        # gate 3: the same request again, then with cache "bypass"; each
        # rewrites its member's PNG (same prefix: a byte-identical request)
        def again(i: int, **extra):
            png = out / f"fd{i}_00000.png"
            png.unlink()
            status, a = post(i, **extra)
            entry = wait_final(master, a["prompt_id"], f"member {i} again")
            hist = http_json(f"{base}/distributed/history/{a['prompt_id']}")[1]
            require(png.is_file() and png.read_bytes() == solo_png[i],
                    f"front door: member {i} again: the PNG is not the "
                    f"solo run's")
            return entry, hist

        (entry, hist), delta = counted(lambda: again(1))
        require(entry.get("cache") == "hit" and hist.get("cache") == "hit"
                and all(v == 0 for v in delta.values()),
                f"front door: repeat {hist}, launches {delta}")
        (entry, hist), delta = counted(lambda: again(2, cache="bypass"))
        require(entry["status"] == "success" and "cache" not in hist
                and delta == fd_counts(0, 1),
                f"front door: bypass {hist}, launches {delta}")
        say(f"  result tier: the repeat launched {{0, 0, 0}}, history cache "
            f"'hit', PNG bitwise; bypass launched {delta}")

        # gate 6: the shipped workflow has a collector: orchestrated
        from comfyui_distributed_tpu_torch.graph.executor import strip_meta

        wf = strip_meta(json.loads(
            (ROOT / "workflows" / SDXL_PATH.workflow).read_text()))
        wf[SDXL_PATH.sampler_node]["inputs"]["steps"] = FD_STEPS

        def orchestrated():
            status, a = http_json(queue, {"prompt": wf})
            return status, a, wait_final(master, a.get("prompt_id", ""),
                                         "orchestrated")

        (status, a, entry), delta = counted(orchestrated)
        # its negative prompt is the members' shared one: a conditioning hit
        require(status == 200 and a.get("batched") is False
                and entry["status"] == "success"
                and "batch_size" not in entry
                and delta == fd_counts(1, 1),
                f"front door: the collector workflow {a}, {entry}, {delta}")
        status, fd = http_json(base + "/distributed/frontdoor")
        require(fd["classified"].get(
            "node_outside_allowlist:DistributedCollector") == 1,
            f"front door: classified {fd['classified']}")
        say(f"  the collector workflow: batched false, orchestrated, "
            f"launches {delta}; classified {fd['classified']}")

        # gate 7: the environment
        status, info = http_json(base + "/distributed/system_info")
        cuda_env = info.get("environment", {}).get("cuda", {})
        require(status == 200 and cuda_env.get("device_name")
                and cuda_env.get("driver_version"),
                f"front door: system_info {info}")
        say(f"  system_info environment: {info['environment']}")
    # gate 5: a second master that sheds from the third request
    with fd_master(torch, "shed", registry,
                   {"CDT_FD_WINDOW_MS": FD_WINDOW_MS,
                    "CDT_FD_SHED_DEPTH": FD_SHED_DEPTH}) as (master, base,
                                                             out):
        def burst():
            answers = [http_with_headers(base + "/distributed/queue", {
                "prompt": fd_prompt(100 + j, "a burst", f"burst{j}",
                                    FD_BURST_HW, FD_BURST_STEPS),
                "tenant": "burst"}) for j in range(FD_BURST)]
            admitted = [a["prompt_id"] for status, _, a in answers
                        if status == 200]
            return answers, [wait_final(master, p, "burst") for p in admitted]

        (answers, entries), delta = counted(burst)
        shed = [(h, a) for status, h, a in answers if status == 429]
        require(shed and all(
            h.get("Retry-After") == str(int(a["retry_after_s"]) or 1)
            and a.get("outcome") == "shed" for h, a in shed),
            f"front door: no 429 with Retry-After in {answers}")
        require(entries and all(e["status"] == "success" for e in entries),
                f"front door: admitted burst requests {entries}")
        say(f"  shedding (CDT_FD_SHED_DEPTH {FD_SHED_DEPTH}): {len(shed)} of "
            f"{FD_BURST} answered 429 (Retry-After "
            f"{sorted({h['Retry-After'] for h, _ in shed})} s), "
            f"{len(entries)} admitted and done; launches {delta}")
    gc.collect()
    batch_invariance(torch, sdxl.bundle)
    return launches


def batch_invariance(torch, bundle, requests: int = 4, iters: int = 3) -> None:
    """Printed, not gated: one UNet forward of ``requests`` stacked
    requests (batch 2R under CFG) against R forwards at batch 2 on the same
    inputs: the max abs difference, whether it is bitwise, the time ratio."""
    unet = bundle.pipeline.unet
    cfg = unet.config
    g = torch.Generator(device="cuda").manual_seed(5)
    lat = 1024 // bundle.pipeline.vae.config.downscale

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    xs = [randn(2, lat, lat, cfg.in_channels) for _ in range(requests)]
    ts = [torch.full((2,), 500.0 + 10 * r, device="cuda")
          for r in range(requests)]
    ctxs = [randn(2, 77, cfg.context_dim) for _ in range(requests)]
    ys = [randn(2, cfg.adm_in_channels) for _ in range(requests)]

    def timed(fn):
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return out, best

    with torch.no_grad():
        solo, solo_s = timed(lambda: [unet(x, t, c, y) for x, t, c, y
                                      in zip(xs, ts, ctxs, ys)])
        stacked, stacked_s = timed(lambda: unet(
            torch.cat(xs), torch.cat(ts), torch.cat(ctxs), torch.cat(ys)))
    from comfyui_distributed_tpu_torch.diffusion.pipeline import (
        demux_microbatch)

    parts = demux_microbatch(stacked, requests, 2)
    diff = max(float((p.float() - s.float()).abs().max())
               for p, s in zip(parts, solo))
    scale = max(float(s.float().abs().max()) for s in solo)
    bitwise = all(torch.equal(p, s) for p, s in zip(parts, solo))
    say(f"  batch invariance: one UNet forward of {requests} stacked requests "
        f"(batch {2 * requests}) vs {requests} at batch 2: max abs diff "
        f"{diff:.6g} (max|solo| {scale:.4g}), bitwise {bitwise}; "
        f"{stacked_s * 1e3:.2f} ms vs {solo_s * 1e3:.2f} ms "
        f"(ratio {stacked_s / solo_s:.3f})")


# --- phase 14d: stages and residency ------------------------------------------

ST_SEEDS = (51, 52)
ST_FALL = 0.9                # of the evicted SDXL bundle's parameter bytes
ST_REBUILD_SLACK = 1 << 27   # bytes the refused SDXL build may leave behind


def st_counts(text_encodes: int, requests: int) -> dict:
    """Launches of ``requests`` SDXL runs at ``FD_BURST_STEPS`` euler steps
    and ``text_encodes`` encodes (``fd_counts`` at another step count)."""
    return {k: v // STEPS * FD_BURST_STEPS * requests
            + (FD_TEXT_K1 * text_encodes if k == "fused_qkv_attention" else 0)
            for k, v in FD_UNET.items()}


def stages_phase(torch, fa, sdxl: PathRun) -> dict:
    """Phase 14d: the stage split under ``CDT_STAGE_WIRE=1``, the remote
    decode route and the residency planner's eviction on the card;
    returns the staged group's launches."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    from comfyui_distributed_tpu_torch import telemetry
    from comfyui_distributed_tpu_torch.cluster.residency import (
        ResidencyError, bundle_bytes, pinned_bundle)
    from comfyui_distributed_tpu_torch.cluster.stages.latents import (
        LatentHandoff, decode_array_payload)
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    telemetry.set_enabled(True)
    registry = sdxl.registry
    solo_dir = FD_DIR / "stages-solo"
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(solo_dir)})
    prompts = [fd_prompt(seed, fd_positive(10 + i), f"st{i}", FD_BURST_HW,
                         FD_BURST_STEPS) for i, seed in enumerate(ST_SEEDS)]
    solo = []
    for i, prompt in enumerate(prompts):
        executor.execute(prompt)
        solo.append((solo_dir / f"st{i}_00000.png").read_bytes())
    # every latent the decode pool decodes, and its image
    pipeline = registry.get("sdxl").pipeline
    decode = pipeline.decode_latents
    decoded = []

    def recording(latents, **kw):
        images = decode(latents, **kw)
        decoded.extend((lat.clone(), img.clone())
                       for lat, img in zip(latents, images))
        return images

    telemetry.REGISTRY.reset()
    # read at each handoff, so set for the master's whole life
    os.environ["CDT_STAGE_WIRE"] = "1"
    try:
        with fd_master(torch, "stages-wire", registry,
                       {"CDT_FD_WINDOW_MS": FD_WINDOW_MS,
                        "CDT_FD_MAX_BATCH": str(len(ST_SEEDS))}) as (
                master, base, out):
            queue = base + "/distributed/queue"
            torch.cuda.synchronize()
            before = dict(fa.LAUNCHES)
            t0 = time.perf_counter()
            pipeline.decode_latents = recording
            try:
                with ThreadPoolExecutor(len(prompts)) as pool:
                    answers = list(pool.map(
                        lambda p: http_json(queue, {"prompt": p}), prompts))
                entries = [wait_final(master, a.get("prompt_id", ""),
                                      f"staged member {i}")
                           for i, (_, a) in enumerate(answers)]
            finally:
                del pipeline.decode_latents
            torch.cuda.synchronize()
            group_s = time.perf_counter() - t0
            launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
            want = st_counts(3, len(prompts))
            require(launches == want,
                    f"stages: the wire group's launches {launches} != {want}")
            for i, (status, a) in enumerate(answers):
                e = entries[i]
                require(status == 200 and a.get("batched") is True
                        and e["status"] == "success"
                        and e.get("batch_size") == len(prompts)
                        and e.get("decode_batch"),
                        f"stages: member {i} answered {status} {a}: {e}")
                png = out / f"st{i}_00000.png"
                require(png.is_file() and png.read_bytes() == solo[i],
                        f"stages: member {i}'s PNG is not its solo run's")
            snap = telemetry.REGISTRY.snapshot()
            moved = histogram(snap, "cdt_latent_transfer_bytes").get(())
            lat_bytes = (FD_BURST_HW // 8) ** 2 * 4 * 4
            require(moved == (len(prompts), float(len(prompts) * lat_bytes)),
                    f"stages: cdt_latent_transfer_bytes observed {moved}")
            status, st = http_json(base + "/distributed/stages")
            require(st.get("wire") is True and st["fallbacks"] == 0
                    and st["redispatched"] == 0 and len(decoded) == 2,
                    f"stages: {st}, {len(decoded)} latents decoded")
            say(f"  wire group of {len(prompts)} ({FD_BURST_HW}², "
                f"{FD_BURST_STEPS} steps): {group_s:.3f} s, each PNG bitwise "
                f"its solo run, launches {launches}, latent handoffs "
                f"{moved[0]} of {lat_bytes} B through the checksummed wire")
            # the remote decode route: one of those latents, by HTTP
            lat, img = decoded[0]
            handoff = LatentHandoff(prompt_id="st-remote",
                                    latents=lat.cpu().numpy(),
                                    meta={"model": "sdxl"})
            status, body = http_json(base + "/distributed/stages/decode",
                                     handoff.to_payload(), timeout=120)
            require(status == 200 and body.get("prompt_id") == "st-remote",
                    f"stages: the decode route answered {status}: {body}")
            remote = decode_array_payload(body["images"])
            direct = decode([lat])[0].cpu().numpy()
            require(np_equal(remote, direct)
                    and np_equal(direct, img.cpu().numpy()),
                    "stages: the decode route's image is not the member's "
                    "direct decode")
            bad = handoff.to_payload()
            raw = bytearray(base64.b64decode(bad["data"]))
            raw[len(raw) // 2] ^= 0x01
            bad["data"] = base64.b64encode(bytes(raw)).decode("ascii")
            status, body = http_json(base + "/distributed/stages/decode", bad)
            require(status == 400 and "CHECKSUM" in body.get("error", ""),
                    f"stages: a flipped bit answered {status}: {body}")
            say(f"  /distributed/stages/decode: image {remote.shape} bitwise "
                f"the member's direct decode; one flipped bit answered 400")
    finally:
        os.environ.pop("CDT_STAGE_WIRE", None)
        decoded.clear()

    # the residency planner on the card: room for sdxl or sd15, not both
    sizes = {name: bundle_bytes(registry.get(name))
             for name in ("sdxl", "sd15")}
    budget_gb = (sizes["sdxl"] + sizes["sd15"] // 2) / 2**30
    saved = os.environ.get("CDT_HBM_BUDGET_GB")
    os.environ["CDT_HBM_BUDGET_GB"] = repr(budget_gb)
    try:
        res_registry = ModelRegistry(DEVICE, seed=0)
    finally:
        if saved is None:
            os.environ.pop("CDT_HBM_BUDGET_GB")
        else:
            os.environ["CDT_HBM_BUDGET_GB"] = saved
    require(res_registry.residency is not None and min(sizes.values()) > 0,
            f"residency: no planner under {budget_gb} GiB (sizes {sizes})")
    planner = res_registry.residency.planner

    def evictions() -> float:
        series = telemetry.REGISTRY.snapshot()[
            "cdt_residency_evictions_total"]["series"]
        return sum(s["value"] for s in series)

    t0 = time.perf_counter()
    big = res_registry.get("sdxl")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    evicted0 = evictions()
    t0 = time.perf_counter()
    small = res_registry.get("sd15")
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    fall = held + bundle_bytes(small) - after
    require(planner.resident() == ["sd15"] and big.released
            and "sdxl" not in res_registry._cache
            and evictions() == evicted0 + 1,
            f"residency: resident {planner.resident()}, sdxl released "
            f"{getattr(big, 'released', False)}, evictions "
            f"{evictions() - evicted0}")
    require(fall >= ST_FALL * sizes["sdxl"],
            f"residency: the card's memory fell by {fall} B, under "
            f"{ST_FALL} of the SDXL bundle's {sizes['sdxl']} B")
    try:
        with pinned_bundle(big):
            require(False, "residency: the evicted sdxl bundle took a pin")
    except ResidencyError:
        pass
    with pinned_bundle(small):
        try:
            res_registry.get("sdxl")
            require(False, "residency: an acquire evicted a pinned bundle")
        except ResidencyError as e:
            refused = str(e)
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - after
    require(planner.resident() == ["sd15"] and not small.released
            and "sdxl" not in res_registry._cache
            and abs(left) < ST_REBUILD_SLACK,
            f"residency: under a pin, resident {planner.resident()}, "
            f"{left} B left by the refused build")
    say(f"  residency (budget {budget_gb:.3f} GiB; sdxl {sizes['sdxl']} B, "
        f"sd15 {sizes['sd15']} B): sdxl built in {build_s:.2f} s; get(sd15) "
        f"in {swap_s:.2f} s evicted sdxl (1 eviction), the card's memory "
        f"fell by {fall} B ({fall / sizes['sdxl']:.4f} of sdxl's); under a "
        f"pin get(sdxl) raised ResidencyError ({refused[:60]}...) and left "
        f"{left} B")
    del big, small, res_registry, planner
    gc.collect()
    return launches


# --- phase 14e: the shape catalog, warmup and preemption -----------------------

PREEMPT_DIR = OUTPUT_DIR / "preempt"
CATALOG_FILE = OUTPUT_DIR / "catalog" / "shape_catalog_torch.json"
PR_SEED = 61                 # the batch request (dpmpp_2m_sde)
PR_INTERACTIVE_SEED = 62     # the interactive one (euler_ancestral)
PR_CUT = 8                   # the default segment: the first boundary
PR_K2 = FD_UNET["flash_attention_packed"]                          # 2100
PR_K2_STEP = PR_K2 // STEPS                                        # 70
# the first served sdxl request of a cold worker, H100 80GB HBM3 at 700 W
# (PERF.md §6, run Y): printed beside the warm worker's
COLD_SERVED_Y_S = 11.276
WARM_S = 300.0               # the worker's warm pass, up to ready


class CatalogWatch:
    """Points the process's shape catalog at a file of its own and records
    each ``observe`` with the observing thread's name (installed before
    14c: phase 14e reads it)."""

    def __init__(self):
        from comfyui_distributed_tpu_torch.cluster import shape_catalog

        self.module = shape_catalog
        self.calls: list[tuple[str, tuple]] = []
        shutil.rmtree(CATALOG_FILE.parent, ignore_errors=True)
        os.environ["CDT_SHAPE_CATALOG"] = str(CATALOG_FILE)
        shape_catalog.reset_default_catalog()
        self.observe = shape_catalog.observe

        def observe(*args, **kwargs):
            import threading

            self.calls.append((threading.current_thread().name,
                               args + tuple(sorted(kwargs.items()))))
            return self.observe(*args, **kwargs)

        shape_catalog.observe = observe

    def close(self) -> None:
        self.module.observe = self.observe
        os.environ.pop("CDT_SHAPE_CATALOG", None)
        self.module.reset_default_catalog()


def pr_prompt(seed: int, sampler: str, prefix: str) -> dict:
    """``fd_prompt``'s graph with another sampler (1024², 30 karras steps,
    CFG 5): a stochastic sampler keeps it off the group lane."""
    prompt = fd_prompt(seed, fd_positive(60 + seed % 10), prefix)
    prompt["4"]["inputs"]["sampler_name"] = sampler
    return prompt


class YieldOnce:
    """A preemption token (the hidden input ``TPUTxt2Img`` reads) that asks
    the run to yield at its first segment boundary."""

    def __init__(self):
        self.resume, self.segment_steps = None, PR_CUT
        self.resume_consumed, self.asked = False, 0

    def should_preempt(self):
        self.asked += 1
        return "manual" if self.asked == 1 else None


def worker_k2(base: str) -> int:
    status, body = http_json(base + "/distributed/kernel_launches")
    require(status == 200, f"kernel_launches answered {status}: {body}")
    return body["launches"]["flash_attention_packed"]


def catalog_gates(watch: CatalogWatch) -> None:
    from comfyui_distributed_tpu_torch.cluster.shape_catalog import (
        ProgramKey, ShapeCatalog, keys_from_prompt)

    watch.close()
    # 14c's staged group
    want = ProgramKey("txt2img", "sdxl", 1024, 1024, FD_STEPS, batch=1)
    cat = ShapeCatalog(CATALOG_FILE)
    group = [name for name, args in watch.calls
             if name.startswith("stage-denoise")
             and args[:5] == ("txt2img", "sdxl", 1024, 1024, FD_STEPS)]
    require(want in cat and group,
            f"catalog: {want} in {CATALOG_FILE}: {want in cat}; group "
            f"observations {group} of {len(watch.calls)}")
    seeded = ShapeCatalog(PREEMPT_DIR / "seeded.json", autoload=False)
    added = seeded.seed_from_workflows(ROOT / "workflows")
    expect = sorted({k for path in sorted((ROOT / "workflows").glob("*.json"))
                     for k in keys_from_prompt(json.loads(path.read_text()))})
    require(seeded.save() and added == len(expect)
            and ShapeCatalog(PREEMPT_DIR / "seeded.json").entries() == expect,
            f"catalog: the seeded catalog {seeded.entries()} != {expect}")
    say(f"  catalog {CATALOG_FILE.name}: {len(cat)} key(s), {want} observed "
        f"by {sorted(set(group))}; workflows seed {added} key(s), "
        f"round-tripped")


def warm_worker(torch, fa, ref_png: bytes):
    """Boots the warm worker; returns (process, URL, its output
    directory)."""
    port = free_port()
    out = PREEMPT_DIR / "worker_out"
    catalog = PREEMPT_DIR / "worker_catalog.json"
    catalog.write_text(json.dumps({"version": 1, "entries": []}))
    reset_peak(torch)
    worker = start_worker(port, PREEMPT_DIR / "worker.log", PREEMPT_DIR, {
        "CDT_WARMUP": "1", "CDT_WARMUP_MODELS": "sdxl",
        "CDT_SHAPE_CATALOG": str(catalog), "CDT_OUTPUT_DIR": str(out)})
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            status, warm = http_json(base + "/distributed/warmup")
            if status == 200 and warm.get("state") in ("ready", "error"):
                break
            require(time.perf_counter() - t0 < WARM_S,
                    f"warmup: not ready after {WARM_S} s: {warm}")
            time.sleep(0.1)
        boot_s = time.perf_counter() - t0
        _, health = http_json(base + "/distributed/health")
        samples = prometheus_samples(
            http_raw(base + "/distributed/metrics")[1].decode())
        compiled = samples.get('cdt_warmup_programs_total{outcome="compiled"}', 0)
        errors = samples.get('cdt_warmup_programs_total{outcome="error"}', 0)
        require(warm["state"] == "ready" and health.get("warmup") == "ready"
                and compiled >= 1 and errors == 0
                and warm["outcomes"].get("compiled", 0) >= 1,
                f"warmup: {warm}, health {health.get('warmup')}, metrics "
                f"compiled {compiled} error {errors}")
        builds = warm["bundle_builds"]
        k2 = worker_k2(base)
        t0 = time.perf_counter()
        status, answer = http_json(base + "/distributed/queue", {
            "prompt": pr_prompt(PR_SEED, "dpmpp_2m_sde", "warm")})
        require(status == 200, f"warm request answered {status}: {answer}")
        entry = wait_history(base, answer["prompt_id"], t0, "warm request")
        request_s = time.perf_counter() - t0
        _, after = http_json(base + "/distributed/warmup")
        k2 = worker_k2(base) - k2
        png = out / "warm_00000.png"
        require(entry["status"] == "success"
                and after["bundle_builds"] == builds and k2 == PR_K2
                and png.is_file() and png.read_bytes() == ref_png,
                f"warm request: {entry}, bundle builds {builds} → "
                f"{after['bundle_builds']}, {k2} K2, PNG bitwise "
                f"{png.is_file() and png.read_bytes() == ref_png}")
        say(f"  warm worker: ready {boot_s:.2f} s after its health answered "
            f"(the pass {warm['seconds']:.3f} s: {warm['outcomes']}, "
            f"{builds} bundle build(s)); its first served sdxl request "
            f"{request_s:.3f} s (run Y's cold one {COLD_SERVED_Y_S} s), no "
            f"bundle built, {k2} K2, PNG bitwise the direct run's")
        return worker, base, out
    except BaseException:
        stop_worker(worker)
        tail = (PREEMPT_DIR / "worker.log").read_text(
            errors="replace").splitlines()[-40:]
        print("chip_smoke: warm worker log tail:\n" + "\n".join(tail),
              file=sys.stderr)
        raise


def priority_preemption(torch, fa, registry, ref_png: bytes) -> dict:
    """A batch request preempted by an interactive one on a master with
    the defaults; returns the window's launches."""
    from comfyui_distributed_tpu_torch import telemetry

    telemetry.REGISTRY.reset()
    with fd_master(torch, "preempt", registry, {}) as (master, base, out):
        require(master.preemption is not None,
                "preemption: off by default on the master")
        queue = base + "/distributed/queue"
        torch.cuda.synchronize()
        before = dict(fa.LAUNCHES)
        status, b = http_json(queue, {
            "prompt": pr_prompt(PR_SEED, "dpmpp_2m_sde", "pbatch"),
            "priority": "batch"})
        require(status == 200 and b.get("batched") is False,
                f"preemption: the batch request answered {status}: {b}")
        t0 = time.perf_counter()
        while True:
            status, prog = http_json(
                f"{base}/distributed/progress/{b['prompt_id']}")
            if status == 200 and prog.get("step", 0) >= 1:
                break
            require(time.perf_counter() - t0 < SERVE_REQUEST_S,
                    f"preemption: no progress on the batch request: {prog}")
            time.sleep(0.01)
        t_post = time.perf_counter()
        status, i = http_json(queue, {
            "prompt": pr_prompt(PR_INTERACTIVE_SEED, "euler_ancestral",
                                "pinter"),
            "priority": "interactive"})
        require(status == 200 and i.get("batched") is False,
                f"preemption: the interactive request answered {status}: {i}")
        ids = {"batch": b["prompt_id"], "interactive": i["prompt_id"]}
        ended, started = {}, None
        while len(ended) < 2:
            if started is None and master.queue.executing == ids["interactive"]:
                started = time.perf_counter()
            for what, pid in ids.items():
                entry = master.queue.history.get(pid, {})
                if what not in ended and entry.get("status") in (
                        "success", "error", "interrupted", "expired"):
                    ended[what] = time.perf_counter()
            require(time.perf_counter() - t_post < SERVE_REQUEST_S,
                    f"preemption: not both final: {ended}")
            time.sleep(0.002)
        torch.cuda.synchronize()
        launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        batch = master.queue.history[ids["batch"]]
        inter = master.queue.history[ids["interactive"]]
        _, hist = http_json(f"{base}/distributed/history/{ids['batch']}")
        _, stats = http_json(base + "/distributed/preemption")
        snap = telemetry.REGISTRY.snapshot()
        reasons = {s["labels"]["reason"]: s["value"] for s in
                   snap.get("cdt_preemptions_total", {}).get("series", [])}
        parked = [s["value"] for s in
                  snap.get("cdt_jobs_preempted", {}).get("series", [])]
        png = out / "pbatch_00000.png"
        require(batch["status"] == inter["status"] == "success"
                and batch.get("preemptions", 0) >= 1
                and hist.get("preemptions", 0) >= 1,
                f"preemption: batch {batch}, interactive {inter}")
        require(reasons.get("priority", 0) >= 1 and parked and parked[-1] == 0
                and stats["store"]["bytes"] == 0 and not stats["parked_jobs"],
                f"preemption: reasons {reasons}, parked gauge {parked}, "
                f"store {stats['store']}")
        require(ended["interactive"] < ended["batch"],
                "preemption: the batch request finished before the "
                "interactive one")
        require(png.is_file() and png.read_bytes() == ref_png,
                "preemption: the batch PNG is not the uninterrupted run's")
        require(launches["flash_attention_packed"] == 2 * PR_K2,
                f"preemption: {launches['flash_attention_packed']} K2 over "
                f"the window, not {2 * PR_K2} (a step ran twice or not at all)")
        waits = histogram(snap, "cdt_queue_wait_seconds")
        wait = waits.get((("priority", "interactive"),), (0, float("nan")))
        say(f"  priority preemption: the batch request preempted "
            f"{batch['preemptions']} time(s) ({reasons}), finished "
            f"{ended['batch'] - ended['interactive']:.3f} s after the "
            f"interactive one; the interactive request waited "
            f"{started - t_post:.3f} s from its POST to its start (queue "
            f"wait {wait[1]:.3f} s); window launches {launches}; batch PNG "
            f"bitwise; store {stats['store']['bytes']} B, "
            f"{stats['preempted']} preempted, {stats['resumed']} resumed")
    return launches


def resume_elsewhere(torch, fa, registry, worker_base: str, worker_out: Path,
                     ref_png: bytes) -> dict:
    """Preempted in this process at step 8, resumed on the warm worker;
    returns this process's launches."""
    from comfyui_distributed_tpu_torch.diffusion.checkpoint import (
        LatentCheckpoint, PreemptedError)
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    token = YieldOnce()
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(PREEMPT_DIR / "cut"),
                              "preemption": token})
    before = dict(fa.LAUNCHES)
    try:
        executor.execute(pr_prompt(PR_SEED, "dpmpp_2m_sde", "cut"))
        raise SmokeFailure("resume: the run did not yield at step 8")
    except PreemptedError as e:
        ckpt = e.checkpoint
    torch.cuda.synchronize()
    launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    require(ckpt.step == PR_CUT and ckpt.meta.get("backend") == "torch"
            and launches["flash_attention_packed"] == PR_CUT * PR_K2_STEP,
            f"resume: checkpoint at {ckpt.step}, meta {ckpt.meta}, "
            f"launches {launches}")
    wire = ckpt.to_payload()
    status, parked = http_json(worker_base + "/distributed/checkpoint", wire)
    require(status == 200 and parked.get("step") == PR_CUT,
            f"resume: the worker parked {status}: {parked}")
    k2 = worker_k2(worker_base)
    t0 = time.perf_counter()
    status, answer = http_json(worker_base + "/distributed/queue", {
        "prompt": pr_prompt(PR_SEED, "dpmpp_2m_sde", "resumed"),
        "checkpoint_id": parked["checkpoint_id"]})
    require(status == 200, f"resume: queue answered {status}: {answer}")
    entry = wait_history(worker_base, answer["prompt_id"], t0, "resume")
    resume_s = time.perf_counter() - t0
    k2 = worker_k2(worker_base) - k2
    png = worker_out / "resumed_00000.png"
    want = PR_K2 - PR_CUT * PR_K2_STEP
    require(entry["status"] == "success" and k2 == want and png.is_file()
            and png.read_bytes() == ref_png,
            f"resume: {entry}, worker K2 {k2} (want {want}), PNG bitwise "
            f"{png.is_file() and png.read_bytes() == ref_png}")
    raw = bytearray(base64.b64decode(wire["data"]))
    raw[len(raw) // 2] ^= 0x01
    status, flipped = http_json(worker_base + "/distributed/checkpoint", {
        **wire, "data": base64.b64encode(bytes(raw)).decode("ascii")})
    require(status == 400 and "CHECKSUM" in flipped.get("error", ""),
            f"resume: a flipped byte answered {status}: {flipped}")
    foreign = LatentCheckpoint(ckpt.sampler, ckpt.step, ckpt.total_steps,
                               ckpt.carry, meta={**ckpt.meta,
                                                 "backend": "jax"})
    status, refused = http_json(worker_base + "/distributed/checkpoint",
                                foreign.to_payload())
    require(status == 400 and "backend" in refused.get("error", ""),
            f"resume: a jax-backend checkpoint answered {status}: {refused}")
    say(f"  resume elsewhere: yielded at step {ckpt.step} here "
        f"({len(wire['data'])} B of base64), resumed on the worker in "
        f"{resume_s:.3f} s with {k2} K2, PNG bitwise; a flipped byte and a "
        f"jax-backend checkpoint answered 400")
    return launches


def preempt_phase(torch, fa, sdxl: PathRun, watch: CatalogWatch) -> dict:
    """Phase 14e; returns this process's launches."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    shutil.rmtree(PREEMPT_DIR, ignore_errors=True)
    PREEMPT_DIR.mkdir(parents=True)
    catalog_gates(watch)
    registry = sdxl.registry
    before = dict(fa.LAUNCHES)
    GraphExecutor({"model_registry": registry,
                   "output_dir": str(PREEMPT_DIR / "ref")}).execute(
        pr_prompt(PR_SEED, "dpmpp_2m_sde", "ref"))
    torch.cuda.synchronize()
    launches = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    require(launches["flash_attention_packed"] == PR_K2,
            f"preempt: the reference request's launches {launches}")
    ref_png = (PREEMPT_DIR / "ref" / "ref_00000.png").read_bytes()
    worker, base, out = warm_worker(torch, fa, ref_png)
    try:
        for part in (priority_preemption(torch, fa, registry, ref_png),
                     resume_elsewhere(torch, fa, registry, base, out,
                                      ref_png)):
            for k in launches:
                launches[k] += part[k]
        PHASE_PEAK["bytes"] = max(PHASE_PEAK["bytes"], worker_peak(base))
    finally:
        stop_worker(worker)
    return launches


# --- phase 14f: the fleet cache and its near tier -----------------------------

FLEET_DIR = OUTPUT_DIR / "fleet"
FLEET_SEEDS = tuple(range(41, 49))     # the first whose key w0 owns
FLEET_POSITIVE = "a harbour at dawn, watercolour, fleet cache"
NEAR_POSITIVE = "a harbour at dawn, watercolour, near tier"
NEAR_SEEDS = (81, 82)                  # the donor, the re-roll
NEAR_STEPS = FD_STEPS // 2             # the re-roll's tail: 4 of 8 steps
FILL_S = 60.0                          # the asynchronous fill, to landed


def fleet_key(bundle, prompt: dict) -> str:
    """The result key the group executor gives ``prompt`` on this card
    (it carries the card's name, torch's and CUDA's versions and TF32,
    so it is known only here)."""
    from comfyui_distributed_tpu_torch.cluster.cache import (
        execution_signature, request_fingerprint, result_key)
    from comfyui_distributed_tpu_torch.cluster.cache.conditioning import \
        encoder_mode
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    return result_key(request_fingerprint(strip_meta(prompt)),
                      execution_signature(bundle.pipeline.device),
                      encoder_mode(bundle.text_encoder),
                      bundle.weights_identity())


def fleet_phase(torch, fa, sdxl: PathRun) -> dict:
    """Phase 14f: the fleet cache between a master in this process and a
    worker subprocess that builds no model, then the near tier; returns
    the master's launches of the served requests."""
    import numpy as np

    from comfyui_distributed_tpu_torch import telemetry
    from comfyui_distributed_tpu_torch.cluster.cache.fleet import (
        decode_entry, encode_entry)
    from comfyui_distributed_tpu_torch.cluster.frontdoor import microbatch
    from comfyui_distributed_tpu_torch.diffusion.pipeline import \
        GenerationSpec
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph import nodes_builtin as nb

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    (FLEET_DIR / "worker_in").mkdir(parents=True)
    telemetry.set_enabled(True)
    registry, bundle = sdxl.registry, sdxl.bundle
    solo = GraphExecutor({"model_registry": registry,
                          "output_dir": str(FLEET_DIR / "solo")})

    def solo_run(seed: int, positive: str, prefix: str):
        """The request alone, no content cache: (images, PNG bytes)."""
        before = dict(fa.LAUNCHES)
        images = solo.execute(fd_prompt(seed, positive, prefix,
                                        steps=FD_STEPS))["4"][0]
        torch.cuda.synchronize()
        counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        require(counts == fd_counts(2, 1),
                f"fleet: the solo {prefix} run's launches {counts}")
        return images, (FLEET_DIR / "solo" / f"{prefix}_00000.png").read_bytes()

    # the sampler output each served member's suffix got, and the donor
    seen, donors = {}, []
    real_finish = microbatch._finish

    def finish(prep, images):
        seen[prep.member.prompt_id] = images.detach().clone()
        return real_finish(prep, images)

    launches = {k: 0 for k in fa.LAUNCHES}
    port = free_port()
    w0 = f"http://127.0.0.1:{port}"
    reset_peak(torch)
    worker = start_worker(port, FLEET_DIR / "worker.log",
                          FLEET_DIR / "worker_in", {
                              "CDT_CACHE": "1",
                              "CDT_CACHE_DIR": str(FLEET_DIR / "w0_cache"),
                              "CDT_OUTPUT_DIR": str(FLEET_DIR / "w0_out")})
    microbatch._finish = finish
    try:
        config = {"hosts": [{"id": "w0", "address": w0, "type": "remote",
                             "enabled": True}]}
        with fd_master(torch, "fleet", registry, {"CDT_CACHE_DIR": ""},
                       config=config, home=FLEET_DIR / "master") as (
                master, base, out):
            fleet = master.cache.fleet
            require(fleet is not None and master.cache.dir is None,
                    "fleet: the tier is off by default or the master's "
                    "cache is not memory-only")
            real_offer = fleet.near.offer

            def offer(near_k, ckpt):
                donors.append(ckpt)
                return real_offer(near_k, ckpt)

            fleet.near.offer = offer
            queue = base + "/distributed/queue"

            def served(payload: dict, prefix: str, what: str):
                png = out / f"{prefix}_00000.png"
                png.unlink(missing_ok=True)
                before = dict(fa.LAUNCHES)
                t0 = time.perf_counter()
                status, a = http_json(queue, payload)
                require(status == 200 and a.get("batched") is True,
                        f"fleet: {what} answered {status}: {a}")
                entry = wait_final(master, a["prompt_id"], what)
                secs = time.perf_counter() - t0
                torch.cuda.synchronize()
                delta = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
                for k in delta:
                    launches[k] += delta[k]
                _, hist = http_json(
                    f"{base}/distributed/history/{a['prompt_id']}")
                require(entry["status"] == "success" and png.is_file(),
                        f"fleet: {what}: {entry}")
                say(f"  {what}: {secs:.3f} s, launches {delta}, history "
                    f"cache {hist.get('cache')!r}")
                return seen[a["prompt_id"]], hist, delta, png.read_bytes()

            # gate (a): the ring over the master and w0
            status, stats = http_json(base + "/distributed/cache")
            ring = stats.get("fleet") or {}
            _, health = http_json(base + "/distributed/health")
            require(status == 200 and ring.get("members") == ["master", "w0"]
                    and ring.get("ring_size") == 2 and ring.get("vnodes") == 64
                    and (health.get("cache") or {}).get("fleet_ring") == 2,
                    f"fleet: the master's ring {ring}, health {health}")
            seed = next((s for s in FLEET_SEEDS if fleet.owner_of(fleet_key(
                bundle, fd_prompt(s, FLEET_POSITIVE, "fleet",
                                  steps=FD_STEPS)))[0] == "w0"), None)
            require(seed is not None,
                    f"fleet: w0 owns none of seeds {FLEET_SEEDS}' keys")
            prompt = fd_prompt(seed, FLEET_POSITIVE, "fleet", steps=FD_STEPS)
            key = fleet_key(bundle, prompt)
            say(f"  ring {ring['members']} ({ring['vnodes']} vnodes each); "
                f"seed {seed}'s key {key[:16]}… belongs to w0")

            # gate (b): computed, then filled to w0 asynchronously
            ref_images, ref_png = solo_run(seed, FLEET_POSITIVE, "fleet")
            images, hist, delta, png = served({"prompt": prompt}, "fleet",
                                              "the first request")
            require(delta == fd_counts(2, 1) and "cache" not in hist
                    and png == ref_png and torch.equal(images, ref_images)
                    and master.cache.results.keys() == [key],
                    f"fleet: the first request: launches {delta}, history "
                    f"{hist}, PNG bitwise {png == ref_png}, keys "
                    f"{master.cache.results.keys()} (want {key})")
            t0 = time.perf_counter()
            while (fleet.counts["fill"] + fleet.counts["fill_error"] < 1
                   and time.perf_counter() - t0 < FILL_S):
                time.sleep(0.02)
            fill_s = time.perf_counter() - t0
            require(fleet.counts["remote_miss"] == 1
                    and fleet.counts["fill"] == 1,
                    f"fleet: after the first request {fleet.counts}")
            t0 = time.perf_counter()
            status, body = http_raw(f"{w0}/distributed/cache/entry/{key}")
            get_s = time.perf_counter() - t0
            held = decode_entry(body) if status == 200 else None
            mine = master.cache.results.peek(key)["images"]
            require(held is not None and held["images"].dtype == np.float32
                    and held["images"].tobytes() == mine.numpy().tobytes(),
                    f"fleet: w0's entry answered {status}, not the master's "
                    "bytes")
            put_bytes = len(json.dumps(encode_entry(key, {"images": mine})))
            say(f"  w0 holds the entry: GET {len(body)} B in {get_s:.3f} s, "
                f"PUT {put_bytes} B (landed {fill_s:.3f} s after the "
                f"request ended), fp32 {list(mine.shape)} bitwise")

            # gate (c): the local tiers cleared, only the ring answers
            status, _ = http_json(base + "/distributed/cache/clear", {})
            hit_sample = 'cdt_fleet_cache_remote_total{op="get",outcome="hit"}'
            hits = metric(base, hit_sample)
            images, hist, delta, png = served({"prompt": prompt}, "fleet",
                                              "the repeat after a clear")
            require(status == 200 and hist.get("cache") == "hit"
                    and delta == fd_counts(2, 0) and png == ref_png
                    and torch.equal(images, ref_images)
                    and fleet.counts["remote_hit"] == 1
                    and metric(base, hit_sample) == hits + 1,
                    f"fleet: the repeat: history {hist}, launches {delta}, "
                    f"PNG bitwise {png == ref_png}, {fleet.counts}")

            # gate (d): a near donor, bitwise its bypass twin
            donor_prompt = fd_prompt(NEAR_SEEDS[0], NEAR_POSITIVE, "near",
                                     steps=FD_STEPS)
            donor_img, hist, delta, donor_png = served(
                {"prompt": donor_prompt, "cache": "near"}, "near",
                "the near donor")
            _, stats = http_json(base + "/distributed/cache")
            require(delta == fd_counts(1, 1) and "cache" not in hist
                    and stats["fleet"]["near"]["donor"] == 1 and len(donors) == 1
                    and donors[0].step == FD_STEPS // 2,
                    f"fleet: the donor: launches {delta}, history {hist}, "
                    f"near {stats['fleet']['near']}")
            twin_img, hist, delta, twin_png = served(
                {"prompt": donor_prompt, "cache": "bypass"}, "near",
                "the donor's bypass twin")
            require(delta == fd_counts(0, 1) and torch.equal(twin_img, donor_img)
                    and twin_png == donor_png,
                    f"fleet: the donor is not its bypass twin (launches "
                    f"{delta})")

            # gate (e): the re-roll runs the ladder's second half
            reroll = fd_prompt(NEAR_SEEDS[1], NEAR_POSITIVE, "near",
                               steps=FD_STEPS)
            reuse0 = metric(base, "cdt_fleet_near_reuse_total")
            saved0 = metric(base, "cdt_fleet_near_steps_saved_total")
            img, hist, delta, _ = served({"prompt": reroll, "cache": "near"},
                                         "near", "the near re-roll")
            want = {k: v // STEPS * NEAR_STEPS for k, v in FD_UNET.items()}
            require(hist.get("cache") == "near" and delta == want
                    and metric(base, "cdt_fleet_near_reuse_total") == reuse0 + 1
                    and metric(base, "cdt_fleet_near_steps_saved_total")
                    == saved0 + NEAR_STEPS,
                    f"fleet: the re-roll: history {hist}, launches {delta} "
                    f"(want {want})")
            require(bool(torch.isfinite(img).all()) and float(img.min()) >= 0
                    and float(img.max()) <= 1
                    and not torch.equal(img, donor_img),
                    "fleet: the re-roll's image is not finite in [0, 1] or is "
                    "the donor's")
            full_img, _ = solo_run(NEAR_SEEDS[1], NEAR_POSITIVE, "nearfull")
            require(not torch.equal(img, full_img),
                    "fleet: the re-roll is its seed's full run")
            cond = solo.execute({k: v for k, v in reroll.items()
                                 if k in ("1", "2", "3")})
            pos, neg = cond["2"][0], cond["3"][0]
            pipe = bundle.pipeline
            adm = pipe.unet.config.adm_in_channels
            args = reroll["4"]["inputs"]
            t0 = time.perf_counter()
            direct = pipe.generate_near(
                GenerationSpec(height=args["height"], width=args["width"],
                               steps=args["steps"],
                               sampler=args["sampler_name"],
                               scheduler=args["scheduler"],
                               guidance_scale=args["cfg"],
                               denoise=NEAR_STEPS / args["steps"]),
                NEAR_SEEDS[1], torch.from_numpy(np.array(donors[0].carry[0])),
                pos["context"], neg["context"],
                nb._adm_from_cond(pos, adm, pipe.device),
                nb._adm_from_cond(neg, adm, pipe.device))
            torch.cuda.synchronize()
            direct_s = time.perf_counter() - t0
            diff = float((img - full_img).abs().max())
            require(torch.equal(direct, img),
                    "fleet: the re-roll is not generate_near on the donor's "
                    "latent")
            require(fleet.counts["remote_error"] == 0
                    and fleet.counts["fill_error"] == 0,
                    f"fleet: remote errors {fleet.counts}")
            say(f"  near: the re-roll bitwise generate_near on the donor's "
                f"step-{donors[0].step} latent ({direct_s:.3f} s in "
                f"process), max |re-roll − its seed's full run| {diff:.4f}; "
                f"fleet {fleet.stats()}")
    except BaseException:
        tail = (FLEET_DIR / "worker.log").read_text(
            errors="replace").splitlines()[-40:]
        print("chip_smoke: fleet worker log tail:\n" + "\n".join(tail),
              file=sys.stderr)
        raise
    finally:
        microbatch._finish = real_finish
        stop_worker(worker)
    return launches


# --- phase 38: offload ------------------------------------------------------

OFFLOAD_DIR = OUTPUT_DIR / "offload"
OFFLOAD_SERVE_DIR = OUTPUT_DIR / "serve_offload"
# JAX's fp8 trajectory gates (tests/test_offload.py:274-318)
OFFLOAD_PSNR_DB = 25.0
OFFLOAD_MAX_DIFF = 0.25
# the fp8 plan of FLUX.1 [dev] at the default budget, as JAX's full-scale
# plan test asserts (tests/test_offload.py:608-618)
OFFLOAD_FLUX_RESIDENT = (11e9, 13 * 2**30)
OFFLOAD_FLUX_UNDER = 10e9    # its peak under phase 20-21's bf16 one
OFFLOAD_STREAMED_STEPS = 4
OFFLOAD_STREAMED = {"fused_qkv_attention": 0, "flash_attention_packed": 0,
                    "flash_attention_bh": OFFLOAD_STREAMED_STEPS * (19 + 38)}
OFFLOAD_WAN_PEAK = 24 * 2**30
OFFLOAD_SWAP_SLACK = 2**30   # card memory at the swap against before the high
OFFLOAD_CARD = 80e9          # master + worker peaks together
# an offload build from files: the card's peak over what the bundle keeps
OFFLOAD_BUILD_SLACK = 256 * 2**20


def psnr(a, b) -> tuple[float, float]:
    """(PSNR in dB over [0, 1] values, max |a − b|) on the host in fp64."""
    import numpy as np

    x = np.asarray(a, np.float64)
    y = np.asarray(b, np.float64)
    mse = float(np.mean((x - y) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20)), float(np.abs(x - y).max())


def host_memory() -> str:
    """The host's memory as /proc/meminfo gives it (``free -g``'s numbers)."""
    info = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, _, rest = line.partition(":")
        info[key] = int(rest.split()[0]) * 1024
    return (f"host memory {info['MemTotal'] / 2**30:.1f} GiB total, "
            f"{info['MemAvailable'] / 2**30:.1f} GiB available")


def rss(pid: int | str = "self") -> str:
    """A process's resident set now and at its peak (VmRSS, VmHWM; the
    peak of this process from ``getrusage`` where VmHWM is missing)."""
    import resource

    fields = {}
    for line in Path(f"/proc/{pid}/status").read_text().splitlines():
        key, _, rest = line.partition(":")
        if key in ("VmRSS", "VmHWM") and rest.split():
            fields[key] = int(rest.split()[0]) * 1024 / 2**30
    if not fields.get("VmHWM"):             # a sandbox's /proc may say 0
        fields.pop("VmHWM", None)
    if "VmHWM" not in fields and pid == "self":
        fields["VmHWM"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024 / 2**30
    peak = (f"{fields['VmHWM']:.2f} GiB" if "VmHWM" in fields
            else "not reported")
    return f"RSS {fields.get('VmRSS', 0):.2f} GiB (peak {peak})"


def offload_file_build(torch, root: Path, name: str) -> dict:
    """Phase 38's rule for a checkpoint-backed bundle, run where phases 23
    and 31 hold their converted files: an offload registry builds
    ``name`` from ``root`` with its transformer(s) allocated and loaded in
    host memory (``models/registry.core_home``), so the card's peak
    during the build stays within OFFLOAD_BUILD_SLACK of what the bundle
    keeps there, far under the transformers' bytes. Returns each
    transformer's parameter digests by entry (taken on the card after the
    gate)."""
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    gc.collect()
    torch.cuda.empty_cache()
    reset_peak(torch)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bundle = ModelRegistry(DEVICE, seed=0, checkpoint_root=root,
                           offload=True).get(name)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    held = torch.cuda.memory_allocated() - before
    cores = {"core": bundle.core,
             "core_low": getattr(bundle.pipeline, "dit_low", None)}
    cores = {k: m for k, m in cores.items() if m is not None}
    core_bytes = sum(p.numel() * p.element_size() for m in cores.values()
                     for p in m.parameters())
    on_card = [n for m in cores.values() for n, p in m.named_parameters()
               if p.device.type != "cpu"]
    say(f"  offload build of {root / name}: {secs:.2f} s; transformer(s) "
        f"{core_bytes / 1e9:.3f} GB in host memory; the card holds "
        f"{held / 2**30:.3f} GiB more, its peak {peak / 2**30:.3f} GiB over "
        f"the level before; this process {rss()}")
    require(bundle.offload and not on_card,
            f"offload build of {name}: parameters on the card {on_card[:4]}")
    require(core_bytes > 4 * OFFLOAD_BUILD_SLACK,
            f"offload build of {name}: {core_bytes} B of transformer cannot "
            "tell a card-side load from the slack")
    require(peak - held <= OFFLOAD_BUILD_SLACK,
            f"offload build of {name}: the card peaked {peak - held} B over "
            "what the bundle keeps there")
    dev = torch.device(DEVICE)
    digests = {k: param_digests(torch, {n: p.to(dev)
                                        for n, p in m.named_parameters()})
               for k, m in cores.items()}
    del bundle, cores
    gc.collect()
    torch.cuda.empty_cache()
    return digests


def offload_quant_phase(torch, what: str, bundle, name: str) -> None:
    """38a: block ``name`` of an offload bundle, drawn on the card,
    quantised and packed on the card and on the host: the fp8 bytes, the
    scales and every native leaf equal."""
    from comfyui_distributed_tpu_torch.diffusion import offload

    pipe = bundle.pipeline
    source = (pipe.offload_source if what == "flux"
              else pipe.offload_sources["high"])
    t0 = time.perf_counter()
    params = source.block_params(name, torch.device(DEVICE))
    layout = offload.block_layout(getattr(source.core, name), True)
    card = offload.pack_block(params, layout)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = offload.pack_block({k: v.cpu() for k, v in params.items()},
                              layout)
    host_s = time.perf_counter() - t0
    source.done(name)
    for key, buf in card.items():
        require(torch.equal(buf.cpu(), host[key]),
                f"offload quantisation: {what} {name} buffer {key} differs "
                "between the card and the host")
    quantised = sum(1 for leaf in layout.leaves if leaf.scale_offset >= 0)
    say(f"  {what} {name}: {quantised} of {len(layout.leaves)} leaves "
        f"quantised, {layout.nbytes / 1e9:.4f} GB packed; fp8 bytes, scales "
        f"and native leaves equal on the card ({card_s:.3f} s with the "
        f"draw) and on the host ({host_s:.3f} s)")


def offload_flux_phase(torch, fa, registry, refs: dict) -> dict:
    """38b and 38c: ``workflows/flux-txt2img.json`` with ``mode:
    "offload"`` on an offload bundle (fully resident at the default
    budget, the fp8 image against phase 20-21's bf16 one), then the same
    executor at half the budget, streamed, bitwise its resident run."""
    from comfyui_distributed_tpu_torch.diffusion.offload import (
        normalize_stream_dtype, resident_budget_bytes)
    from comfyui_distributed_tpu_torch.diffusion.pipeline_flow import FlowSpec
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta

    bundle = registry.get("flux")
    pipe = bundle.pipeline
    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / FLUX_PATH.workflow).read_text()))
    sampler = workflow[FLUX_PATH.sampler_node]["inputs"]
    require(sampler["steps"] == FLUX_STEPS and sampler["mode"] == "dp",
            f"{FLUX_PATH.workflow} changed; update the script")
    sampler["mode"] = "offload"
    seed = FLUX_PATH.seeds[0]
    workflow[FLUX_PATH.seed_node]["inputs"]["seed"] = seed
    hw = (int(sampler["height"]), int(sampler["width"]))
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(OFFLOAD_DIR)})
    fa.reset_launches()
    img, secs, _ = run_counted(torch, fa, executor, workflow,
                               FLUX_PATH.image_node,
                               (FLUX_PATH.expected, FLUX_PATH.expected_cuda),
                               "offloaded flux", hw)
    launches = dict(fa.LAUNCHES)
    (off,) = pipe.offload_stores()
    plan = off.plan
    peak = max(PHASE_PEAK["bytes"], torch.cuda.max_memory_allocated())
    db, diff = psnr(img.cpu(), refs["flux"][seed])
    t = pipe.timings
    say(f"  offloaded flux-txt2img.json seed {seed}: {secs:.3f} s (bf16 "
        f"direct {refs['flux_seconds'][0]:.3f} s); sampling "
        f"{t['sample_s']:.3f} s = {t['sample_s'] / t['steps']:.4f} s/step, "
        f"decode {t['decode_s']:.3f} s; plan at "
        f"{resident_budget_bytes() / 2**30:.1f} GiB "
        f"({normalize_stream_dtype(None)}): "
        f"{len(plan['resident'])} of {len(plan['order'])} blocks resident, "
        f"{plan['resident_bytes'] / 1e9:.3f} GB with the glue, store "
        f"{off.store_bytes() / 1e9:.3f} GB on the card; launches {launches}; "
        f"peak {peak / 2**30:.3f} GiB against phase 20-21's "
        f"{refs['flux_peak'] / 2**30:.3f} GiB; against the bf16 image PSNR "
        f"{db:.2f} dB, max |diff| {diff:.4f}")
    lo, hi = OFFLOAD_FLUX_RESIDENT
    require(plan["fully_resident"] and lo < plan["resident_bytes"] < hi,
            f"offloaded flux: plan {len(plan['streamed'])} streamed, "
            f"{plan['resident_bytes']} resident bytes")
    require(peak <= refs["flux_peak"] - OFFLOAD_FLUX_UNDER,
            f"offloaded flux: peak {peak} not {OFFLOAD_FLUX_UNDER:.0f} B "
            f"under the bf16 path's {refs['flux_peak']}")
    require(db > OFFLOAD_PSNR_DB and diff < OFFLOAD_MAX_DIFF,
            f"offloaded flux: PSNR {db:.2f} dB, max |diff| {diff:.4f}")

    # 38c: the same weights streamed: half the fp8 set resident
    spec = FlowSpec(height=hw[0], width=hw[1], steps=OFFLOAD_STREAMED_STEPS,
                    shift=3.0, guidance=float(sampler["guidance"]))
    ctx, pooled = bundle.text_encoder.encode([workflow["2"]["inputs"]["text"]])
    resident = pipe.generate_offloaded(spec, seed, ctx, pooled)
    resident_s = pipe.timings["sample_s"]
    half = (plan["resident_bytes"] - plan["glue_bytes"]) // 2 + \
        plan["glue_bytes"]
    before = dict(fa.LAUNCHES)
    t0 = time.perf_counter()
    streamed = pipe.generate_offloaded(spec, seed, ctx, pooled,
                                       resident_bytes=half)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    (off,) = pipe.offload_stores()
    t = pipe.timings
    say(f"  streamed flux at {OFFLOAD_STREAMED_STEPS} steps, budget "
        f"{half / 1e9:.3f} GB: {len(off.plan['resident'])} blocks resident, "
        f"{len(off.plan['streamed'])} streamed, {off.streamed_bytes / 1e9:.3f} "
        f"GB from pinned host memory a step; {secs:.3f} s with the build, "
        f"sampling {t['sample_s']:.3f} s = "
        f"{t['sample_s'] / t['steps']:.4f} s/step (resident "
        f"{resident_s / t['steps']:.4f} s/step); launches {counts}")
    require(off.streamed and not off.stacked,
            "streamed flux: the half budget streamed nothing")
    require(counts == OFFLOAD_STREAMED,
            f"streamed flux: launches {counts} != {OFFLOAD_STREAMED}")
    require(torch.equal(streamed, resident),
            "streamed flux: the image differs from the resident executor's")
    say("  streamed image bitwise the resident executor's")
    launches = {k: launches[k] + counts[k] for k in launches}
    pipe.release_offload()
    return launches


def offload_wan_phase(torch, fa, registry, refs: dict) -> dict:
    """38d: phase 30's request on an offload ``wan-2.2-t2v`` bundle (mode
    ``offload``) at seeds 99 and 100: twice phase 30's K3, the card memory
    back at the swap, the peak, the fp8 video against phase 30's bf16
    one."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    bundle = wan_bundle(torch, registry, "wan-2.2-t2v")
    pipeline = bundle.pipeline
    require(WAN_OFFLOAD[0]["flash_attention_bh"]
            == 2 * WAN_SERVED[0]["flash_attention_bh"],
            "the offloaded WAN counts are not twice the resident ones")
    executor = GraphExecutor({"model_registry": registry,
                              "output_dir": str(OFFLOAD_DIR / "wan22")})
    frames, launches = {}, {}
    for seed in (WAN_SEED, WAN_SEED + 1):
        prompt = wan_workflow(WAN_T2V, steps=WAN_SERVED_STEPS, mode="offload")
        prompt["1"]["inputs"]["ckpt_name"] = "wan-2.2-t2v"
        prompt["3"]["inputs"]["seed"] = seed
        reset_peak(torch)
        fa.reset_launches()
        batch, secs, counts = wan_request(torch, fa, executor, prompt,
                                          f"offloaded wan 2.2 seed {seed}",
                                          WAN_OFFLOAD)
        launches = {k: launches.get(k, 0) + n for k, n in counts.items()}
        peak = torch.cuda.max_memory_allocated()
        t = pipeline.timings
        calls = t["calls"]
        want = {"high": 2 * WAN_SPLIT,
                "low": 2 * (WAN_SERVED_STEPS - WAN_SPLIT)}
        require(calls == want, f"offloaded wan 2.2: calls {calls} != {want}")
        before = t.get("allocated_before", {}).get("high", 0)
        after = t.get("allocated_after_release", 0)
        (low,) = [o.plan for o in pipeline.offload_stores()]
        say(f"  offloaded wan-2.2-t2v seed {seed}: {secs:.3f} s (bf16 phase "
            f"30: {refs['wan22_seconds']:.3f} s); sampling {t['sample_s']:.3f}"
            f" s over {t['steps']} steps ({calls} model calls), decode "
            f"{t['decode_s']:.3f} s; card memory before the high expert "
            f"{before / 2**30:.3f} GiB, after its release {after / 2**30:.3f} "
            f"GiB; the low store {low['resident_bytes'] / 1e9:.3f} "
            f"GB resident, {len(low['streamed'])} blocks "
            f"({low['streamed_bytes'] / 1e9:.3f} GB) streamed a "
            f"forward; peak {peak / 2**30:.3f} GiB (bf16 phase 30 "
            f"{refs['wan22_peak'] / 2**30:.3f} GiB); launches {counts}")
        require(abs(after - before) <= OFFLOAD_SWAP_SLACK,
                f"offloaded wan 2.2: card memory {after} after the high "
                f"expert's release against {before} before it")
        require(peak <= OFFLOAD_WAN_PEAK,
                f"offloaded wan 2.2: peak {peak / 2**30:.3f} GiB")
        if seed == WAN_SEED:
            db, diff = psnr(batch.cpu(), refs["wan22"])
            say(f"  against phase 30's bf16 video: PSNR {db:.2f} dB, max "
                f"|diff| {diff:.4f}")
            require(db > OFFLOAD_PSNR_DB,
                    f"offloaded wan 2.2: PSNR {db:.2f} dB against bf16")
        frames[seed] = to_uint8(batch)
        del batch
    refs["wan22_offload"] = frames
    return launches


def offload_serve_phase(torch, fa, registry, refs: dict) -> dict:
    """38e: the t2v graph on ``wan-2.2-t2v`` through ``POST
    /distributed/queue`` to a master in this process (38d's offload
    bundle) and a ``remote`` worker subprocess with ``CDT_OFFLOAD=1`` that
    builds its own: each video bitwise 38d's at its seed, the two peaks
    together under the card's memory."""
    from unittest import mock

    from comfyui_distributed_tpu_torch.graph import nodes_builtin
    from comfyui_distributed_tpu_torch.utils.image import to_uint8

    prompt = wan_workflow(WAN_T2V, steps=WAN_SERVED_STEPS)
    prompt["1"]["inputs"]["ckpt_name"] = "wan-2.2-t2v"
    seen = []
    divide = nodes_builtin.ImageBatchDivider.execute

    def recording(self, images, *a, **kw):
        seen.append(images)
        return divide(self, images, *a, **kw)

    frames = refs["wan22_offload"]
    with served_pair(torch, OFFLOAD_SERVE_DIR, "offloaded wan",
                     OFFLOAD_SERVE_DIR / "worker_in", registry=registry,
                     worker_env={"CDT_OFFLOAD": "1"}) as served:
        with mock.patch.object(nodes_builtin.ImageBatchDivider, "execute",
                               recording):
            secs, counts, kernels = served_request(fa, served, prompt,
                                                   "served offloaded wan")
        master_peak = torch.cuda.max_memory_allocated()
        peak = worker_peak(served.worker_base)
        want_cuda = WAN_OFFLOAD[1]
        say(f"  served offloaded wan-2.2-t2v at {WAN_SERVED_STEPS} steps: "
            f"{secs:.3f} s (POST to final history); master launches {counts}; "
            f"worker kernels (profiled) {kernels}; peak memory master "
            f"{master_peak / 2**30:.3f} GiB, worker {peak / 2**30:.3f} GiB, "
            f"together {(master_peak + peak) / 1e9:.3f} GB; master "
            f"{rss()}, worker {rss(served.worker_pid)}")
        require(counts == WAN_OFFLOAD[0],
                f"served offloaded wan: master launches {counts}")
        require(kernels.get(K1_EVENT) == want_cuda["qkv_projection"]
                and kernels.get("flash_attention_kernel")
                == want_cuda["flash_attention_core"]
                and kernels.get("short_kv_attention_kernel")
                == want_cuda["short_kv_attention"],
                f"served offloaded wan: the worker's kernels {kernels} != "
                f"{want_cuda}")
        require(peak > 0 and master_peak + peak < OFFLOAD_CARD,
                f"served offloaded wan: peaks {master_peak} + {peak}")
        batch = next((s for s in seen if s.shape[0] == 2 * WAN_FRAMES), None)
        require(batch is not None,
                "served offloaded wan: no collected batch of two videos")
        require(np_equal(to_uint8(batch[:WAN_FRAMES]), frames[WAN_SEED]),
                "served offloaded wan: the master's video differs from the "
                f"direct offloaded seed-{WAN_SEED} video")
        require(np_equal(to_uint8(batch[WAN_FRAMES:]), frames[WAN_SEED + 1]),
                "served offloaded wan: the worker's video differs from the "
                f"direct offloaded seed-{WAN_SEED + 1} video")
        say(f"  wan_v0 bitwise the direct offloaded seed-{WAN_SEED} video, "
            f"wan_v1 the seed-{WAN_SEED + 1} one (8-bit frames)")
    return counts


def offload_phases(torch, fa, refs: dict) -> dict:
    """Phase 38: offload (ROADMAP A.5) on the card, after every earlier
    bundle is dropped: FLUX, then WAN 2.2, each bundle built for offload
    from a registry of seed 0; returns the launches by path."""
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    launches = {}
    with phase(torch, "38 offload"):
        say(f"offload: {host_memory()}; "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on "
            f"the card; this process {rss()}")
        reset_peak(torch)
        registry = ModelRegistry(DEVICE, seed=0, offload=True)
        t0 = time.perf_counter()
        flux = registry.get("flux")
        torch.cuda.synchronize()
        say(f"  flux offload bundle built in {time.perf_counter() - t0:.2f} s "
            f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated: "
            "the glue, the VAE, the text encoder)")
        offload_quant_phase(torch, "flux", flux, "double_0")
        launches["flux_offload"] = offload_flux_phase(torch, fa, registry,
                                                      refs)
        flux.release_device()
        del flux, registry
        free_card(torch)
        registry = ModelRegistry(DEVICE, seed=0, offload=True)
        wan = wan_bundle(torch, registry, "wan-2.2-t2v")
        offload_quant_phase(torch, "wan", wan, "block_0")
        launches["wan_offload"] = offload_wan_phase(torch, fa, registry, refs)
        launches["wan_offload_served"] = offload_serve_phase(
            torch, fa, registry, refs)
        wan.release_device()
        del wan, registry
        free_card(torch)
    return launches

# --- the device mesh I (phases 14g and 21a) ---------------------------------

MESH_DIR = OUTPUT_DIR / "mesh"
MESH_SEED = 91
MESH_POSITIVE = "a lighthouse on a cliff at dusk, oil painting, mesh"
MESH_RANKS = 2
MESH_HW = 1024                       # both mesh phases' image side
MESH_SP_STEPS = 2                    # 2 of FLUX's 28 (4 until the tp phases)
MESH_PSNR_DB = 30.0
MESH_RETURN_SLACK = 2**30            # card memory back after the followers
MESH_CARD = 80e9                     # both ranks' peaks together
ULYSSES_SHAPE = (1, 4096, 24, 128)   # FLUX's heads at 4096 tokens
MESH_TOTALS = {}                     # phase → per-rank launches (kernels line)
# path → [(shape, launches)] of one request of TP_STEPS steps on rank 1,
# as phases 14h and 21b counted them (the kernels line's tp rows)
TP_MEASURED = {}


@contextlib.contextmanager
def virtual_ranks(n: int):
    """``CDT_VIRTUAL_DEVICES=n`` while a mesh is built on the one card."""
    saved = os.environ.get("CDT_VIRTUAL_DEVICES")
    os.environ["CDT_VIRTUAL_DEVICES"] = str(n)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("CDT_VIRTUAL_DEVICES", None)
        else:
            os.environ["CDT_VIRTUAL_DEVICES"] = saved


def rank_launches(call: dict) -> list[dict]:
    return [dict(r["launches"]) for r in call["ranks"]]


def mesh_dp_phase(torch, fa, sdxl: PathRun) -> dict:
    """Phase 14g: a master with ``mesh.shape {"dp": 2}`` over two ranks on
    the one card (rank 1 a follower process on ``cuda:0``, gloo) serves
    the SDXL graph at 8 of 30 steps: two images, image 0 bitwise the
    one-device run, image 1 bitwise ``sample_and_decode`` of participant
    1's noise, each rank's K1/K2 exact, both ranks' parameter digests
    equal; the card's memory back after the followers stop. Returns rank
    0's and rank 1's launches."""
    from comfyui_distributed_tpu_torch.diffusion.pipeline import GenerationSpec
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.nodes_builtin import (
        SaveImage, _adm_from_cond)
    from comfyui_distributed_tpu_torch.parallel.mesh import describe_mesh
    from comfyui_distributed_tpu_torch.parallel.programs import param_digest
    from comfyui_distributed_tpu_torch.parallel.rng import (
        participant_seed, seed_generator, step_noise)

    free0 = torch.cuda.mem_get_info()[0]
    prompt = fd_prompt(MESH_SEED, MESH_POSITIVE, "mesh", hw=MESH_HW,
                       steps=FD_STEPS)
    direct = MESH_DIR / "direct"
    t0 = time.perf_counter()
    out = GraphExecutor({"model_registry": sdxl.registry,
                         "output_dir": str(direct)}).execute(prompt)
    torch.cuda.synchronize()
    say(f"  one-device run (seed {MESH_SEED}, {FD_STEPS} steps): "
        f"{time.perf_counter() - t0:.3f} s")
    # participant 1 by hand on this process's bundle, as the node builds it
    pipe = sdxl.bundle.pipeline
    pos, neg = out["2"][0], out["3"][0]
    adm = pipe.unet.config.adm_in_channels
    spec = GenerationSpec(height=MESH_HW, width=MESH_HW, steps=FD_STEPS,
                          sampler="euler", scheduler="karras",
                          guidance_scale=5.0)
    s1 = participant_seed(MESH_SEED, 1)
    img1 = pipe.sample_and_decode(
        pipe.initial_noise(spec, seed_generator(s1, pipe.device)), spec,
        pos["context"], neg["context"], _adm_from_cond(pos, adm, pipe.device),
        _adm_from_cond(neg, adm, pipe.device),
        sampler_noise=step_noise(s1, pipe.device))
    SaveImage().execute(img1, filename_prefix="mesh_p1",
                        output_dir=str(direct))
    refs = [(direct / "mesh_00000.png").read_bytes(),
            (direct / "mesh_p1_00000.png").read_bytes()]
    del img1, out
    with virtual_ranks(MESH_RANKS), \
            fd_master(torch, "mesh_dp", sdxl.registry, {},
                      config={"mesh": {"shape": {"dp": MESH_RANKS}}},
                      home=MESH_DIR / "dp") as (master, base, out_dir):
        mesh = master.mesh
        described = describe_mesh(mesh)
        say(f"  mesh: {described}")
        require(mesh.shape == {"dp": MESH_RANKS}, f"mesh {mesh.shape}")
        require(described["backend"] == "gloo",
                f"ranks sharing one card must talk over gloo, not "
                f"{described['backend']}")
        runtime = mesh.runtime
        before = dict(fa.LAUNCHES)
        reset_peak(torch)
        t0 = time.perf_counter()
        code, _, answer = http_with_headers(f"{base}/distributed/queue",
                                            {"prompt": prompt})
        require(code == 200 and answer.get("prompt_id"), f"queue: {answer}")
        entry = wait_final(master, answer["prompt_id"], "mesh dp request")
        secs = time.perf_counter() - t0
        require(entry["status"] == "success", f"mesh dp request: {entry}")
        require(answer.get("batched") is True,
                "a mesh request is classified as on one rank (a group of "
                "one runs solo)")
        rank0 = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        call = runtime.last_call
        ranks = rank_launches(call)
        pngs = sorted(out_dir.glob("mesh_*.png"))
        say(f"  served over {MESH_RANKS} ranks: {secs:.3f} s (POST to "
            f"history; the first call starts rank 1 and builds its sdxl); "
            f"ranks' program seconds "
            f"{[round(r['seconds'], 3) for r in call['ranks']]}, peaks "
            f"{[round(r['peak_bytes'] / 2**30, 3) for r in call['ranks']]} "
            f"GiB; rank 0 launches {rank0} (program {ranks[0]}), rank 1 "
            f"{ranks[1]}")
        require([p.name for p in pngs] == ["mesh_00000.png", "mesh_00001.png"],
                f"mesh dp PNGs {[p.name for p in pngs]}")
        require(pngs[0].read_bytes() == refs[0],
                "image 0 is not bitwise the one-device run")
        require(pngs[1].read_bytes() == refs[1],
                "image 1 is not bitwise participant 1's sample_and_decode")
        unet = fd_counts(0, 1)
        require(ranks[0] == unet and ranks[1] == unet,
                f"per-rank sampler launches {ranks} != {unet}")
        require(rank0 == fd_counts(2, 1), f"rank 0 launches {rank0}")
        t0 = time.perf_counter()
        digests = runtime.run("param_digest", sdxl.bundle)
        require(len(set(digests)) == 1 and digests[0] == param_digest(
            sdxl.bundle), f"parameter digests differ: {digests}")
        say(f"  parameter digests of both ranks equal ({digests[0][:16]}…, "
            f"{time.perf_counter() - t0:.2f} s)")
        MESH_TOTALS["sdxl_dp"] = [rank0, ranks[1]]
    require(not runtime.procs and master._mesh is None,
            "the master's shutdown left its followers")
    gc.collect()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    say(f"  card memory free {free0 / 2**30:.3f} GiB before, "
        f"{free1 / 2**30:.3f} GiB after the followers stopped")
    require(free0 - free1 < MESH_RETURN_SLACK,
            "the followers' card memory did not come back")
    return {"rank0": rank0, "rank1": ranks[1]}


def mesh_sp_phase(torch, fa, flux: PathRun, mesh) -> dict:
    """Phase 21a: ``TPUFlowTxt2Img`` mode ``sp`` runs FLUX at full width,
    1024², 2 of 28 steps, over two ranks on the card (``mesh``, the
    ``{"dp": 1, "tp": 2}`` mesh phase 21b runs on, re-laid as ``{"sp":
    2}`` as the node does; the ring staged through host memory over
    gloo): PSNR > 30 dB against the one-device run of the same noise, no
    K3 launch on the ring path, both ranks' peaks under 80 GB together.
    Then (c) Ulysses over the same ranks at [1, 4096, 24, 128] against
    the plain attention within 1e-2·max|plain|."""
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.parallel.mesh import describe_mesh

    workflow = strip_meta(json.loads(
        (ROOT / "workflows" / FLUX_PATH.workflow).read_text()))
    workflow[FLUX_PATH.seed_node]["inputs"]["seed"] = FLUX_PATH.seeds[0]
    workflow[FLUX_PATH.sampler_node]["inputs"].update(
        steps=MESH_SP_STEPS, width=MESH_HW, height=MESH_HW)
    t0 = time.perf_counter()
    ref = GraphExecutor({"model_registry": flux.registry,
                         "output_dir": str(MESH_DIR / "flux_direct")}).execute(
        workflow)[FLUX_PATH.image_node][0]
    torch.cuda.synchronize()
    say(f"  one-device run ({MESH_SP_STEPS} steps): "
        f"{time.perf_counter() - t0:.3f} s")
    described = describe_mesh(mesh)
    say(f"  mesh: {described}")
    require(described["backend"] == "gloo", f"backend {described['backend']}")
    # the ring's traffic a forward, each rank: the image K/V of its 2048
    # tokens (bf16) rotate once in each of FLUX's 57 blocks
    hop = 2 * (4096 // MESH_RANKS) * 3072 * 2
    say(f"  ring traffic: {MESH_RANKS - 1} hop(s) of {hop / 1e6:.1f} MB of "
        f"K/V a block, {57 * (MESH_RANKS - 1) * hop / 1e9:.2f} GB a forward "
        "through host memory on each rank")
    sp = json.loads(json.dumps(workflow))
    sp[FLUX_PATH.sampler_node]["inputs"]["mode"] = "sp"
    before = dict(fa.LAUNCHES)
    reset_peak(torch)
    t0 = time.perf_counter()
    out = GraphExecutor({"model_registry": flux.registry, "mesh": mesh,
                         "output_dir": str(MESH_DIR / "flux_sp")}).execute(
        sp)[FLUX_PATH.image_node][0]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rank0 = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    call = mesh.runtime.last_call
    ranks = rank_launches(call)
    free = torch.cuda.mem_get_info()[0]
    peaks = [r["peak_bytes"] for r in call["ranks"]]
    db, diff = psnr(out.float().cpu(), ref.float().cpu())
    timings = flux.bundle.pipeline.timings
    say(f"  sp over {MESH_RANKS} ranks: {secs:.3f} s (the first call "
        f"starts rank 1 and builds its flux); rank 0 sampling "
        f"{timings['sample_s']:.3f} s ({timings['sample_s'] / MESH_SP_STEPS:.3f}"
        f" s/step), decode {timings['decode_s']:.3f} s; ranks' program "
        f"seconds {[round(r['seconds'], 3) for r in call['ranks']]}; "
        f"PSNR {db:.2f} dB against the one-device run, max |Δ| "
        f"{diff:.5f}; peaks {[round(p / 2**30, 3) for p in peaks]} GiB, "
        f"card free {free / 2**30:.3f} GiB; rank 0 launches {rank0}, "
        f"rank 1 {ranks[1]}")
    require(tuple(out.shape) == tuple(ref.shape)
            == (1, MESH_HW, MESH_HW, 3),
            f"sp image {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite sp image")
    require(db > MESH_PSNR_DB, f"sp PSNR {db:.2f} dB <= {MESH_PSNR_DB}")
    require(all(r["flash_attention_bh"] == 0 for r in ranks + [rank0]),
            "K3 launched on the ring path")
    require(rank0 == {"fused_qkv_attention": 4, "flash_attention_packed": 0,
                      "flash_attention_bh": 0}, f"rank 0 {rank0}")
    require(sum(peaks) < MESH_CARD,
            f"both ranks' peaks {sum(peaks) / 1e9:.1f} GB")
    MESH_TOTALS["flux_sp"] = [rank0, ranks[1]]
    ulysses = ulysses_check(torch, fa, mesh)
    return {"flux_sp": rank0, "flux_sp_rank1": ranks[1], **ulysses}


def flux_mesh(torch, flux: PathRun):
    """Phases 21a and 21b's two ranks on the card: a ``{"dp": 1, "tp":
    2}`` mesh (its followers start at its first call) and the card's
    free memory before it."""
    from comfyui_distributed_tpu_torch.parallel.bootstrap import MeshRuntime
    from comfyui_distributed_tpu_torch.parallel.mesh import build_mesh

    free0 = torch.cuda.mem_get_info()[0]
    with virtual_ranks(MESH_RANKS):
        mesh = build_mesh({"dp": 1, "tp": MESH_RANKS},
                          device=torch.device(DEVICE))
    mesh.runtime = MeshRuntime(mesh, flux.registry.seed,
                               flux.registry.checkpoint_root)
    return mesh, free0


def stop_flux_mesh(torch, flux: PathRun, mesh, free0: int) -> None:
    """The followers stopped, rank 0's shard dropped as a controller's
    ``reset_mesh`` drops it (``ModelRegistry.drop_tp_shards``), the card's
    memory back within ``MESH_RETURN_SLACK`` of ``free0``."""
    mesh.runtime.stop()
    flux.registry.drop_tp_shards()
    require(not mesh.runtime.procs, "the followers outlived their stop")
    require("_tp_shards" not in flux.bundle.pipeline.__dict__,
            "rank 0 kept its shard after the mesh was dropped")
    gc.collect()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    say(f"  card memory free {free0 / 2**30:.3f} GiB before the mesh, "
        f"{free1 / 2**30:.3f} GiB after the followers stopped")
    require(free0 - free1 < MESH_RETURN_SLACK,
            "the followers' card memory did not come back")


def ulysses_check(torch, fa, mesh) -> dict:
    """(c): Ulysses over the mesh's two ranks at ``ULYSSES_SHAPE``: each
    rank attends over the whole sequence with half the heads (the port's
    kernel for that geometry), held against the plain attention."""
    from comfyui_distributed_tpu_torch.ops.attention import select_kernel

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v = (torch.randn(*ULYSSES_SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    per = ULYSSES_SHAPE[1] // MESH_RANKS
    shards = [tuple(t[:, r * per:(r + 1) * per].cpu() for t in (q, k, v))
              for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    outs = mesh.runtime.run("apply", None, "ulysses_attention", shards,
                            {"axis": "sp"}, layout="sp")
    secs = time.perf_counter() - t0
    got = torch.cat([o.to(dev) for o in outs], dim=1)
    ref = fa.flash_attention_plain(q, k, v)
    err = compare(torch, f"ulysses over {MESH_RANKS} ranks {ULYSSES_SHAPE}",
                  got, ref)
    ranks = rank_launches(mesh.runtime.last_call)
    tier = select_kernel(dev, False, ULYSSES_SHAPE[2] // MESH_RANKS,
                         ULYSSES_SHAPE[3])
    want = {name: int(name == f"flash_attention_{tier}")
            for name in KERNEL_NAMES}
    say(f"  ulysses: {secs:.3f} s a call; each rank [1, {ULYSSES_SHAPE[1]}, "
        f"{ULYSSES_SHAPE[2] // MESH_RANKS}·{ULYSSES_SHAPE[3]}] on the {tier} "
        f"layout; ranks' launches {ranks}; max_abs_err {err:.5f}")
    require(ranks == [want] * MESH_RANKS, f"ulysses launches {ranks}")
    MESH_TOTALS["ulysses"] = ranks
    return {"ulysses": ranks[0], "ulysses_rank1": ranks[1]}


# --- the device mesh II (phases 14h and 21b): tensor parallelism --------------

TP_DIR = OUTPUT_DIR / "mesh_tp"
TP_STEPS = 2                  # 2 of SDXL's 30 and of FLUX's 28 (PERF.md §4)
TP_LONE_SEED = 92
TP_SEEDS = (93, 94)           # the group's two requests
TP_BYTES_SLACK = 0.10         # a rank's card bytes against its plan
# a tp rank's launches a euler step (ops/attention.select_kernel at half
# the heads, TP_FUSED / TP_PACKED / TP_BH above): SDXL 60 K1 (the
# 1280-wide self-attention), 60 K2 (its 77 keys), 20 K3 (the 640-wide
# sites, self and 77 keys); by CUDA kernel 60 projections, 70 streamed
# cores (K1's and K3's self) and 70 short-key cores; FLUX 57 K2
TP_SDXL_STEP = {"fused_qkv_attention": 60, "flash_attention_packed": 60,
                "flash_attention_bh": 20}
TP_SDXL_CUDA_STEP = {"qkv_projection": 60, "flash_attention_core": 70,
                     "short_kv_attention": 70}
TP_FLUX_STEP = {"fused_qkv_attention": 0, "flash_attention_packed": 57,
                "flash_attention_bh": 0}
# the geometries a tp rank chooses tiers for (geometry_key = tier)
TP_SDXL_TIERS = {"h10.d64.q1024.kv1024.bf16=fused",
                 "h10.d64.q1024.kv128.bf16=packed",
                 "h5.d64.q4096.kv4096.bf16=bh",
                 "h5.d64.q4096.kv128.bf16=bh"}
TP_FLUX_TIERS = {"h12.d128.q8192.kv8192.bf16=packed"}


def scaled(step: dict, steps: int) -> dict:
    return {k: v * steps for k, v in step.items()}


def tp_tiers_check(torch) -> None:
    """The tiers a tp rank's geometries take, from ``select_kernel``,
    before any launch: what TP_SDXL_STEP and TP_FLUX_STEP count."""
    from comfyui_distributed_tpu_torch.ops.attention import select_kernel

    dev = torch.device(DEVICE)
    got = (select_kernel(dev, True, 10, 64, 1280),
           select_kernel(dev, False, 10, 64),
           select_kernel(dev, True, 5, 64, 640),
           select_kernel(dev, False, 5, 64),
           select_kernel(dev, False, 12, 128))
    require(got == ("fused", "packed", "bh", "bh", "packed"),
            f"a tp rank's tiers {got}")


def recording(runtime) -> list:
    """Every call's ``last_call`` of ``runtime`` from now on, in order."""
    calls = []
    run = runtime.run

    def rec(*args, **kwargs):
        out = run(*args, **kwargs)
        calls.append(runtime.last_call)
        return out

    runtime.run = rec
    return calls


def tp_card_gates(torch, bundle, call: dict, before0: int) -> dict:
    """Each rank's card bytes after its shard's build: rank 1 holds its
    shard (``tp_shard_bytes``) and the whole VAE; rank 0 holds, besides
    what it held before the first tp call, its shard's slices that are
    not views of its bundle (``shard_extra_bytes``)."""
    from comfyui_distributed_tpu_torch.cluster.residency import (
        _param_bytes, _tp_rules_for, shard_extra_bytes, tp_shard_bytes)

    core = bundle.core
    plan1 = (tp_shard_bytes(core, _tp_rules_for(bundle), TP)
             + _param_bytes([bundle.pipeline.vae], bundle.device))
    got1 = call["ranks"][1]["allocated_bytes"]
    extra = shard_extra_bytes(bundle, TP)
    got0 = torch.cuda.memory_allocated() - before0
    say(f"  card bytes: rank 1 {got1 / 2**30:.3f} GiB against its shard "
        f"(tp_shard_bytes) and the VAE {plan1 / 2**30:.3f} GiB; rank 0 "
        f"{got0 / 2**30:.3f} GiB more than before its first tp call against "
        f"its shard's slices apart from its bundle {extra / 2**30:.3f} GiB; "
        f"shard bytes {[r['shard_bytes'] for r in call['ranks']]}")
    require(abs(got1 - plan1) <= TP_BYTES_SLACK * plan1,
            f"rank 1 holds {got1} bytes, planned {plan1}")
    require(abs(got0 - extra) <= TP_BYTES_SLACK * extra + 2**26,
            f"rank 0 grew by {got0} bytes, its shard's slices {extra}")
    return {"rank1_bytes": got1, "rank1_plan": plan1, "rank0_extra": extra}


def mesh_tp_phase(torch, fa, sdxl: PathRun) -> dict:
    """Phase 14h: a master on ``{"dp": 1, "tp": 2}`` (two ranks on the one
    card, gloo), the front door and the stage pools on by default, serves
    SDXL at 1024², 4 of 30 steps. A lone request runs solo on rank 0
    (rank 1 sits it out), bitwise the one-rank run, at full heads. Two
    concurrent requests form one group that runs ``txt2img_tp`` on the
    staged lane (latents to rank 0, which decodes) with no fallback: each
    rank's launches as predicted at the per-rank geometries, each image
    > 30 dB against its one-rank run, the ranks' shard digests the slices
    of rank 0's parameters, each rank's card bytes within 10% of its
    plan; a repeat is a result hit under the mesh's signature, whose key
    differs from the one-rank key. Returns rank 0's and rank 1's
    launches."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from comfyui_distributed_tpu_torch import telemetry
    from comfyui_distributed_tpu_torch.cluster.cache import (
        execution_signature, request_fingerprint, result_key)
    from comfyui_distributed_tpu_torch.cluster.cache.conditioning import \
        encoder_mode
    from comfyui_distributed_tpu_torch.graph import GraphExecutor
    from comfyui_distributed_tpu_torch.graph.executor import strip_meta
    from comfyui_distributed_tpu_torch.parallel.mesh import describe_mesh
    from comfyui_distributed_tpu_torch.parallel.programs import \
        param_digest_of
    from comfyui_distributed_tpu_torch.parallel.tensor import shard_params

    tp_tiers_check(torch)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    free0 = torch.cuda.mem_get_info()[0]
    bundle = sdxl.bundle
    prompts = {seed: fd_prompt(seed, fd_positive(seed), f"tp{seed}",
                               hw=MESH_HW, steps=TP_STEPS)
               for seed in (TP_LONE_SEED,) + TP_SEEDS}
    direct = TP_DIR / "direct"
    executor = GraphExecutor({"model_registry": sdxl.registry,
                              "output_dir": str(direct)})
    refs, one_s = {}, []
    for seed, prompt in prompts.items():
        t0 = time.perf_counter()
        refs[seed] = executor.execute(prompt)["4"][0].float().cpu()
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
    say(f"  one-rank runs ({TP_STEPS} steps): "
        f"{', '.join(f'{s:.3f}' for s in one_s)} s")
    # the lone request's UNet at full heads, TP_STEPS steps
    full = {k: v // STEPS * TP_STEPS for k, v in FD_UNET.items()}
    telemetry.set_enabled(True)
    telemetry.REGISTRY.reset()
    with virtual_ranks(TP), \
            fd_master(torch, "mesh_tp", sdxl.registry,
                      {"CDT_FD_WINDOW_MS": FD_WINDOW_MS},
                      config={"mesh": {"shape": {"dp": 1, "tp": TP}}},
                      home=TP_DIR / "served") as (master, base, out_dir):
        mesh = master.mesh
        described = describe_mesh(mesh)
        say(f"  mesh: {described}")
        require(mesh.shape == {"dp": 1, "tp": TP} and described["tp"] == TP,
                f"mesh {mesh.shape}")
        require(described["backend"] == "gloo",
                f"backend {described['backend']}")
        runtime = mesh.runtime
        calls = recording(runtime)
        queue = base + "/distributed/queue"
        # the tp sums a forward, each rank: 3 a transformer block (self-
        # and cross-attention out, the feed-forward down) over its tokens,
        # 10 blocks at 4096 × 640 and 60 at 1024 × 1280, CFG's batch 2,
        # bf16
        sums = 3 * 2 * 2 * (10 * 4096 * 640 + 60 * 1024 * 1280)
        say(f"  tp sums: 210 a forward, {sums / 1e9:.2f} GB through host "
            "memory on each rank")

        def post(seed):
            return http_with_headers(queue, {"prompt": prompts[seed]})

        # (a) a lone request: a group of one, solo, on rank 0 alone
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        code, _, answer = post(TP_LONE_SEED)
        require(code == 200 and answer.get("batched") is True,
                f"lone request: {answer}")
        entry = wait_final(master, answer["prompt_id"], "tp lone request")
        lone_s = time.perf_counter() - t0
        rank0 = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        require(entry["status"] == "success" and entry["batch_size"] == 1,
                f"lone request: {entry}")
        lone = calls[-1]
        require(lone["program"] == "txt2img_dp"
                and lone["ranks"][1].get("idle"),
                f"lone request ran {lone['program']}, rank 1 {lone['ranks'][1]}")
        require((out_dir / f"tp{TP_LONE_SEED}_00000.png").read_bytes()
                == (direct / f"tp{TP_LONE_SEED}_00000.png").read_bytes(),
                "the lone request is not bitwise the one-rank run")
        require(rank0 == {k: full[k] + (FD_TEXT_K1 * 2 if k ==
                                        "fused_qkv_attention" else 0)
                          for k in full},
                f"lone request launches {rank0} (full heads + 2 encodes)")
        say(f"  lone request: {lone_s:.3f} s from the POST, solo on rank 0 "
            f"(rank 1 idle), bitwise the one-rank run; launches {rank0}")

        # (b) two concurrent requests: one tp group on the staged lane
        before0 = torch.cuda.memory_allocated()
        n_calls = len(calls)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(TP_SEEDS)) as pool:
            answers = list(pool.map(post, TP_SEEDS))
        entries = [wait_final(master, a["prompt_id"], f"tp member {i}")
                   for i, (_, _, a) in enumerate(answers)]
        group_s = time.perf_counter() - t0
        for i, e in enumerate(entries):
            require(e["status"] == "success" and e.get("batch_size") == 2,
                    f"tp member {i}: {e}")
        group = calls[n_calls:]
        require([c["program"] for c in group] == ["txt2img_tp"] * 2,
                f"the group ran {[c['program'] for c in group]}")
        status, st = http_json(base + "/distributed/stages")
        snap = telemetry.REGISTRY.snapshot()
        fallbacks = sum(x["value"] for x in snap.get(
            "cdt_batch_fallbacks_total", {}).get("series", []))
        require(status == 200 and st["fallbacks"] == 0 and fallbacks == 0
                and st["members"] >= 2,
                f"stages {st}, batch fallbacks {fallbacks}")
        want = scaled(TP_SDXL_STEP, TP_STEPS)
        want_cuda = scaled(TP_SDXL_CUDA_STEP, TP_STEPS)
        for c in group:
            for r, rep in enumerate(c["ranks"]):
                require(rep["launches"] == want
                        and rep["cuda_launches"] == want_cuda,
                        f"rank {r} launches {rep['launches']} "
                        f"{rep['cuda_launches']} != {want} {want_cuda}")
        tiers = set(group[-1]["ranks"][1]["attn_kernels"].split(","))
        require(tiers == TP_SDXL_TIERS, f"rank 1's tiers {tiers}")

        def key_of(seed, m):
            return result_key(request_fingerprint(strip_meta(prompts[seed])),
                              execution_signature(bundle.pipeline.device, m),
                              encoder_mode(bundle.text_encoder),
                              bundle.weights_identity())

        # each member's images as the group computed them (the result
        # tier's host copy) against its one-rank run
        dbs = []
        for seed in TP_SEEDS:
            held = master.cache.results.peek(key_of(seed, mesh))
            require(held is not None, f"tp member {seed} left no result")
            db, diff = psnr(torch.as_tensor(held["images"]).float(),
                            refs[seed])
            dbs.append((db, diff))
            require(db > MESH_PSNR_DB,
                    f"tp image {seed}: PSNR {db:.2f} dB <= {MESH_PSNR_DB}")
        secs = [[round(r["seconds"], 3) for r in c["ranks"]] for c in group]
        peaks = [r["peak_bytes"] for r in group[0]["ranks"]]
        say(f"  group of {len(TP_SEEDS)}: {group_s:.3f} s from the POSTs "
            f"(the first tp call starts rank 1 and builds both shards); "
            f"ranks' program seconds {secs}; peaks "
            f"{[round(p / 2**30, 3) for p in peaks]} GiB; PSNR, max |Δ| "
            f"{[(round(d, 2), round(x, 5)) for d, x in dbs]}; each rank "
            f"{want} ({want_cuda}); rank 1's tiers {sorted(tiers)}")
        card = tp_card_gates(torch, bundle, group[0], before0)
        # (c) the shards are the slices of rank 0's parameters
        t0 = time.perf_counter()
        digests = runtime.run("shard_digest", bundle)
        slices = [param_digest_of(shard_params(bundle.core, r, TP))
                  for r in range(TP)]
        require([d["digest"] for d in digests] == slices,
                f"shard digests {digests} != the slices' {slices}")
        say(f"  shard digests equal rank 0's slices "
            f"({[d['digest'][:12] for d in digests]}, "
            f"{time.perf_counter() - t0:.2f} s)")
        # (d) a repeat is a result hit, keyed by the mesh's signature
        n_calls = len(calls)
        with ThreadPoolExecutor(len(TP_SEEDS)) as pool:
            again = list(pool.map(post, TP_SEEDS))
        hits = [wait_final(master, a["prompt_id"], "tp repeat")
                for _, _, a in again]
        require(all(e.get("cache") == "hit" for e in hits)
                and len(calls) == n_calls, f"the repeat: {hits}")
        keys = [key_of(TP_SEEDS[0], m) for m in (mesh, None)]
        require(keys[0] != keys[1]
                and master.cache.results.peek(keys[0]) is not None
                and master.cache.results.peek(keys[1]) is None,
                "the tp result is not keyed by the mesh's signature")
        say(f"  repeat: {len(hits)} result hits under the mesh's key "
            f"{keys[0][:12]}…, not the one-rank key {keys[1][:12]}…")
        # rank 1's launches a request by shape: K3's self-attention is
        # the streamed cores past K1's, its 77-key sites the rest
        rep = group[0]["ranks"][1]
        k1 = rep["launches"]["fused_qkv_attention"]
        k3_self = rep["cuda_launches"]["flash_attention_core"] - k1
        TP_MEASURED["mesh_tp"] = [
            (TP_FUSED[0][0], k1),
            (TP_PACKED[0][0], rep["launches"]["flash_attention_packed"]),
            (TP_BH[0][0], k3_self),
            (TP_BH[1][0], rep["launches"]["flash_attention_bh"] - k3_self)]
        MESH_TOTALS["sdxl_tp"] = [
            {k: sum(c["ranks"][r]["launches"][k] for c in group)
             for k in KERNEL_NAMES} for r in range(TP)]
        rank0_total = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        free_up = torch.cuda.mem_get_info()[0]
    require(not runtime.procs and master._mesh is None,
            "the master's shutdown left its followers")
    require("_tp_shards" not in bundle.pipeline.__dict__,
            "the master's shutdown left rank 0's shard on its bundle")
    gc.collect()
    torch.cuda.empty_cache()
    free1 = torch.cuda.mem_get_info()[0]
    say(f"  card memory free {free0 / 2**30:.3f} GiB before the phase, "
        f"{free_up / 2**30:.3f} GiB with both ranks up, {free1 / 2**30:.3f} "
        f"GiB after the follower stopped and rank 0 dropped its shard")
    # rank 1's shard and VAE, and rank 0's slices, came back
    require(free1 - free_up >= card["rank1_bytes"] + card["rank0_extra"],
            "the follower's and the shard's card memory did not come back")
    return {"rank0": rank0_total, "rank1": MESH_TOTALS["sdxl_tp"][1],
            "card": card, "psnr": dbs}


def mesh_flux_tp_phase(torch, fa, flux: PathRun, mesh) -> dict:
    """Phase 21b: ``flux-txt2img.json``'s FLUX at full width and depth,
    1024², 2 of 28 steps, through ``generate_tp`` (the ``flow_tp``
    program) on 21a's ``{"dp": 1, "tp": 2}`` mesh, whose follower slices
    its shard from the FLUX it built for 21a: each rank 57 K2 a step at
    [1, 4173, 12·128] and no K3, PSNR > 30 dB against the one-device run
    of the same seed, both ranks' peaks under 80 GB together."""
    from comfyui_distributed_tpu_torch.diffusion.pipeline_flow import FlowSpec
    from comfyui_distributed_tpu_torch.graph import GraphExecutor

    workflow = json.loads((ROOT / "workflows" / FLUX_PATH.workflow).read_text())
    inputs = workflow[FLUX_PATH.sampler_node]["inputs"]
    text = {k: workflow[k] for k in ("1", "2")}
    cond = GraphExecutor({"model_registry": flux.registry,
                          "output_dir": str(TP_DIR / "flux")}).execute(
        text)["2"][0]
    spec = FlowSpec(height=MESH_HW, width=MESH_HW, steps=TP_STEPS,
                    shift=float(inputs["shift"]),
                    guidance=float(inputs["guidance"]))
    seed = FLUX_PATH.seeds[0]
    pipe = flux.bundle.pipeline
    context, pooled = cond["context"], cond.get("pooled")
    if pooled is None:                 # as the sampler node fills it
        pooled = torch.zeros((1, pipe.dit.config.pooled_dim),
                             device=pipe.device)
    t0 = time.perf_counter()
    ref = pipe.generate(spec, seed, context, pooled)
    torch.cuda.synchronize()
    say(f"  one-device run ({TP_STEPS} steps): "
        f"{time.perf_counter() - t0:.3f} s")
    require(mesh.shape == {"dp": 1, "tp": TP}, f"mesh {mesh.shape}")
    # the tp sums a forward, each rank: 19 double blocks × 4 (each
    # stream's projection and MLP, over its own tokens) and 38 single
    # blocks × 1 (over all 4173), bf16
    sums = (19 * 2 + 38) * FLUX_TOKENS * 3072 * 2
    say(f"  tp sums: {19 * 4 + 38} a forward, {sums / 1e9:.2f} GB through "
        "host memory on each rank")
    before = dict(fa.LAUNCHES)
    reset_peak(torch)
    t0 = time.perf_counter()
    out = mesh.runtime.run("flow_tp", flux.bundle, spec, seed, context, pooled)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rank0 = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
    call = mesh.runtime.last_call
    ranks = rank_launches(call)
    peaks = [r["peak_bytes"] for r in call["ranks"]]
    db, diff = psnr(out.float().cpu(), ref.float().cpu())
    timings = pipe._tp_shards[(0, TP, "tp")].timings
    say(f"  flow_tp over {TP} ranks: {secs:.3f} s (rank 1 slices its shard "
        f"from its flux); rank 0 sampling {timings['sample_s']:.3f} s "
        f"({timings['sample_s'] / TP_STEPS:.3f} s/step); ranks' program "
        f"seconds {[round(r['seconds'], 3) for r in call['ranks']]}; PSNR "
        f"{db:.2f} dB against the one-device run, max |Δ| {diff:.5f}; peaks "
        f"{[round(p / 2**30, 3) for p in peaks]} GiB; card bytes "
        f"{[round(r['allocated_bytes'] / 2**30, 3) for r in call['ranks']]}"
        f" GiB; shard bytes {[r['shard_bytes'] for r in call['ranks']]}; "
        f"launches {ranks}")
    want = scaled(TP_FLUX_STEP, TP_STEPS)
    require(rank0 == want and ranks == [want] * TP,
            f"flow_tp launches rank 0 {rank0}, ranks {ranks} != {want}")
    tiers = set(call["ranks"][1]["attn_kernels"].split(","))
    require(TP_FLUX_TIERS <= tiers, f"rank 1's tiers {tiers}")
    require(tuple(out.shape) == (1, MESH_HW, MESH_HW, 3)
            and bool(torch.isfinite(out).all()),
            f"flow_tp image {tuple(out.shape)}")
    require(db > MESH_PSNR_DB, f"flow_tp PSNR {db:.2f} dB")
    require(sum(peaks) < MESH_CARD,
            f"both ranks' peaks {sum(peaks) / 1e9:.1f} GB")
    MESH_TOTALS["flux_tp"] = [rank0, ranks[1]]
    TP_MEASURED["flux_tp"] = [(TP_FLUX_PACKED[0][0],
                               ranks[1]["flash_attention_packed"])]
    return {"flux_tp": rank0, "flux_tp_rank1": ranks[1]}


PHASE_PEAK = {"bytes": 0}


def reset_peak(torch) -> None:
    """Reset the card's peak-memory counter for a request's own reading,
    keeping the peak so far for the running phase's."""
    PHASE_PEAK["bytes"] = max(PHASE_PEAK["bytes"],
                              torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


class phase:
    """Prints a phase's seconds and the card's peak allocated memory in it,
    over every reset_peak inside it."""

    def __init__(self, torch, name: str):
        self.torch, self.name = torch, name

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        PHASE_PEAK["bytes"] = 0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, *_):
        self.torch.cuda.synchronize()
        peak = max(PHASE_PEAK["bytes"], self.torch.cuda.max_memory_allocated())
        say(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s, peak "
            f"{peak / 2**30:.3f} GiB" + ("" if kind is None else " (failed)"))
        return False


def free_card(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  {torch.cuda.memory_allocated() / 2**30:.3f} GiB still allocated")


def keep_bytecode() -> None:
    """Write Python's bytecode under ``output/pycache`` for this process and
    every process it starts, also where ``PYTHONDONTWRITEBYTECODE`` is set:
    otherwise each worker and converter compiles torch and the port from
    source again at its start (PERF.md §6)."""
    prefix = str(ROOT / "output" / "pycache")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix


def main() -> int:
    if not (PACKAGE / "ops" / "csrc" / "flash_attention.cu").is_file():
        print(f"chip_smoke: {PACKAGE} not found beside this script",
              file=sys.stderr)
        return 2
    keep_bytecode()
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
    # the served phases before 14c run without the content cache and the
    # stage pools (as before they existed), so that each counts every text
    # encode it gates on and keeps its path; 14c, 14d and 36 run the
    # controllers' defaults, and 37's file request goes through the
    # conditioning tier
    os.environ["CDT_CACHE"] = "0"
    os.environ["CDT_STAGES"] = "0"
    t_start = time.perf_counter()
    try:
        device = device_phase(torch)
        with phase(torch, "2 build"):
            build_phase(fa)
        with phase(torch, "3 kernels"):
            rows, errs = kernel_phase(torch, fa)
        path_launches = {}
        allocated = torch.cuda.memory_allocated()
        with phase(torch, "4-5 sdxl"):
            sdxl = path_phase(torch, fa, SDXL_PATH)
            path_launches["sdxl"] = sdxl.launches
            reference_phase(torch, fa, sdxl.bundle)
        with phase(torch, "6-7 upscale"):
            up = upscale_phase(torch, fa, sdxl)
            path_launches["upscale"] = up.launches
            upscale_reference_phase(torch, fa, sdxl, up)
            up = up._replace(image=None)
        with phase(torch, "8-10 img2img, inpaint, usdu + controlnet"):
            control = control_phase(torch, fa, sdxl, up)
            path_launches.update(control.launches)
        with phase(torch, "11-12 sd15"):
            path_launches["sd15"] = sd15_phase(torch, fa, sdxl.registry)
            sd15_reference_phase(torch, fa, sdxl.registry.get("sd15"))
        with phase(torch, "13 controlnet tile upscale"):
            cn_tile = cn_tile_phase(torch, fa, sdxl.registry, up.input_dir)
            path_launches["cn_upscale"] = cn_tile.launches
        with phase(torch, "13a-13b audio and video"):
            say("audio and video inputs:")
            av = write_av_inputs(up.input_dir)
            path_launches["audio"] = audio_phase(torch, fa, up.input_dir)
            video = video_phase(torch, fa, sdxl.registry, up.input_dir,
                                av["encode_540p_s"])
            path_launches["video"] = video.launches
        with phase(torch, "14 serve"):
            path_launches.update(serve_phase(torch, fa, sdxl, up, control,
                                             cn_tile, video))
        with phase(torch, "14b managed worker"):
            path_launches["managed"] = managed_phase(torch, fa, sdxl)
            path_launches["elastic_autoscale"] = autoscale_leg(torch, fa,
                                                               sdxl)
        # the shape catalog gets a file of its own, and its observations
        # are recorded, from 14c on (phase 14e reads them)
        watch = CatalogWatch()
        with phase(torch, "14c front door"):
            path_launches["frontdoor"] = frontdoor_phase(torch, fa, sdxl)
        with phase(torch, "14d stages and residency"):
            path_launches["stages"] = stages_phase(torch, fa, sdxl)
        with phase(torch, "14e catalog, warmup and preemption"):
            path_launches["preempt"] = preempt_phase(torch, fa, sdxl, watch)
        with phase(torch, "14f fleet cache"):
            path_launches["fleet"] = fleet_phase(torch, fa, sdxl)
        with phase(torch, "14g mesh dp"):
            mesh_dp = mesh_dp_phase(torch, fa, sdxl)
            path_launches["mesh_dp"] = mesh_dp["rank0"]
            path_launches["mesh_dp_rank1"] = mesh_dp["rank1"]
        with phase(torch, "14h mesh tp"):
            mesh_tp = mesh_tp_phase(torch, fa, sdxl)
            path_launches["mesh_tp"] = mesh_tp["rank0"]
            path_launches["mesh_tp_rank1"] = mesh_tp["rank1"]
        del sdxl, up, control, cn_tile, video
        left = torch.cuda.memory_allocated() - allocated
        say(f"serve: {left / 2**30:.3f} GiB still allocated after the "
            f"master's shutdown and the sdxl path's end")
        require(left < 2**30, "the SDXL bundle outlived the master's shutdown")
        torch.cuda.empty_cache()
        with phase(torch, "15-19 checkpoints"):
            path_launches.update(checkpoint_phases(torch, fa))
        with phase(torch, "20-21 flux"):
            flux = path_phase(torch, fa, FLUX_PATH)
            path_launches["flux"], timings = flux.launches, flux.timings
            path_launches["flux_dpmpp_2m"] = flux_sampler_phase(torch, fa,
                                                                flux.bundle)
            fa.reset_launches()
            serve_refs, serve_seconds = flux_serve_refs(torch, fa,
                                                        flux.registry)
            path_launches["flux_8"] = dict(fa.LAUNCHES)
            flux_reference_phase(torch, fa, flux.bundle)
            images = {s: flux.images[s].cpu() for s in FLUX_PATH.seeds[:2]}
            seconds = flux.seconds
            # phase 38's references: the bf16 images, seconds and peak
            refs = {"flux": images, "flux_seconds": seconds,
                    "flux_peak": max(PHASE_PEAK["bytes"],
                                     torch.cuda.max_memory_allocated())}
        # 21a and 21b share two ranks (the follower's flux too)
        mesh, free0 = flux_mesh(torch, flux)
        try:
            with phase(torch, "21a mesh sp and ulysses"):
                path_launches.update(mesh_sp_phase(torch, fa, flux, mesh))
            with phase(torch, "21b mesh tp flux"):
                path_launches.update(mesh_flux_tp_phase(torch, fa, flux,
                                                        mesh))
                stop_flux_mesh(torch, flux, mesh, free0)
        finally:
            mesh.runtime.stop()
        holder = {"bundle": flux.bundle}
        del flux
        gc.collect()
        with phase(torch, "22-24 flux files"):
            path_launches.update(flux_file_phases(torch, fa, holder, seconds))
        gc.collect()
        torch.cuda.empty_cache()
        say(f"flux serve: the direct bundle dropped, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        with phase(torch, "25 flux serve"):
            path_launches["serve_flux"] = flux_serve_phase(
                torch, fa, serve_refs, serve_seconds)
        free_card(torch)
        path_launches.update(wan_phases(torch, fa, refs))
        path_launches.update(sd3_phases(torch, fa))
        path_launches.update(offload_phases(torch, fa, refs))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    table = kernel_table(rows, errs, path_launches)
    k3 = next(k for k in table if k["name"] == "flash_attention_bh")
    say(f"flux: K3 {k3['ms'] / 1e3:.3f} s per request of "
        f"{timings['sample_s']:.3f} s sampling "
        f"({k3['ms'] / 1e3 / timings['sample_s']:.1%})")
    for what, wan in (("wan", k3["per_wan_request"]),
                      ("wan offloaded", k3["per_wan_offload_request"])):
        say(f"{what}: K3 {wan['ms'] / 1e3:.3f} s per t2v request of "
            f"{WAN_STEPS} steps (bound {wan['bound_ms'] / 1e3:.3f} s, plain "
            f"{wan['plain_ms'] / 1e3:.3f} s, library "
            f"{wan['library_ms'] / 1e3:.3f} s, {wan['launches']} launches)")
    k2 = next(k for k in table if k["name"] == "flash_attention_packed")
    for what, entry in (("sd3-medium: K2", k2["per_sd3_request"]),
                        ("sd3-medium from its files: K2",
                         k2["per_sd3_file_request"]),
                        ("sd35-large: K3", k3["per_sd35_request"])):
        say(f"{what} {entry['ms'] / 1e3:.3f} s per request (bound "
            f"{entry['bound_ms'] / 1e3:.3f} s, plain {entry['plain_ms'] / 1e3:.3f}"
            f" s, library {entry['library_ms'] / 1e3:.3f} s, "
            f"{entry['launches']} launches)")
    say(f"total {time.perf_counter() - t_start:.1f} s on {device['smi']}")
    say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
