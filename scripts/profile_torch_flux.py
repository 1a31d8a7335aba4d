#!/usr/bin/env python3
"""Device-time breakdown of one denoising forward of the PyTorch port on
one NVIDIA card: FLUX's DiT, SDXL's UNet, SDXL's UNet with a ControlNet,
or WAN 14B's transformer.

    python3 scripts/profile_torch_flux.py [--model flux|sdxl|sdxl-controlnet|wan] [--forwards 2] [--trace PATH]

Builds the full-width ``flux`` or ``sdxl`` preset (random weights from
seed 0) and runs one model forward at the shape of the model's workflow:
FLUX at 1024² (4096 image + 77 text tokens, batch 1,
``workflows/flux-txt2img.json``), SDXL at 1024² with CFG (a 128² latent,
batch 2, ``workflows/distributed-txt2img.json``); ``sdxl-controlnet``
runs the ``sdxl`` ControlNet (hint 1024², strength 0.8) before the
UNet, as each step of ``chip_smoke.py``'s img2img + ControlNet graph
does; ``wan`` runs WAN 14B at ``workflows/wan-t2v.json``'s shape with
CFG (33 frames of 832×480: 9 latent frames of 60×104, 14 040 tokens,
batch 2, the hash encoder's 77 context tokens). It warms up, times
``--forwards`` forwards untraced, then traces as many with
``torch.profiler`` (device activity only: tracing every host-side op
slows the host enough to starve the card) and prints, per forward:

- wall seconds, untraced and traced (host clock around forwards ending
  in a synchronise);
- device busy seconds (the union of kernel intervals in the trace) and
  the device's idle share of the untraced wall time;
- device seconds by kernel class: the streamed attention core (FLUX:
  every joint attention, K3; SDXL: K1's second launch; WAN: the
  self-attention, K3), the short-key attention kernel (SDXL: K2; WAN:
  the cross-attention, K3; all: the text encoder's K1 core), K1's
  projection GEMM,
  convolutions (cuDNN), other matrix products (cuBLAS / CUTLASS
  kernels), and everything else (norms, modulation, RoPE, GELU, copies);
- the kernels with the most device time.

The Chrome trace is written to ``--trace``. Exits nonzero without a card
or when the trace holds no kernel.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GEMM_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "nvjet", "xmma", "cublas")
CONV_MARKS = ("fprop", "dgrad", "wgrad", "conv", "Conv")


def kernel_class(name: str) -> str:
    if "short_kv_attention_kernel" in name:
        return "short-key attention (K2, text-encoder K1 core)"
    if "flash_attention_kernel" in name:
        return "streamed attention core (K1 second launch, K3)"
    if "qkv_projection_kernel" in name:
        return "K1 projection GEMM"
    if any(m in name for m in CONV_MARKS):
        return "convolutions"
    if any(m in name for m in GEMM_MARKS):
        return "matrix products"
    return "other (norms, modulation, RoPE, GELU, copies)"


def busy_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def flux_forward(torch, registry):
    """One DiT forward of the FLUX workflow; returns (forward, label)."""
    workflow = json.loads((ROOT / "workflows" / "flux-txt2img.json").read_text())
    sampler = workflow["4"]["inputs"]
    bundle = registry.get("flux")
    dit = bundle.pipeline.dit
    ctx, pooled = bundle.text_encoder.encode([workflow["2"]["inputs"]["text"]])
    ds = bundle.pipeline.vae.config.downscale
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, sampler["height"] // ds, sampler["width"] // ds,
                    dit.config.in_channels, generator=gen, device="cuda")
    t = torch.tensor([0.5], device="cuda")
    g = torch.tensor([float(sampler["guidance"])], device="cuda")

    def forward():
        with torch.no_grad():
            dit(x, t, ctx, pooled, g)

    label = (f"flux forward at {sampler['height']}x{sampler['width']} "
             f"({x.shape[1] * x.shape[2] // 4} image + {ctx.shape[1]} text "
             f"tokens)")
    return forward, label


def sdxl_forward(torch, registry, control: bool = False):
    """One UNet forward of the SDXL workflow with CFG (the doubled batch),
    with ``control`` the ControlNet's forward before it; returns
    (forward, label)."""
    workflow = json.loads(
        (ROOT / "workflows" / "distributed-txt2img.json").read_text())
    sampler = workflow["5"]["inputs"]
    bundle = registry.get("sdxl")
    unet = bundle.pipeline.unet
    cfg = unet.config
    ds = bundle.pipeline.vae.config.downscale
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, sampler["height"] // ds, sampler["width"] // ds,
                    cfg.in_channels, generator=gen, device="cuda")
    t = torch.tensor([500.0, 500.0], device="cuda")
    ctx = torch.randn(2, 77, cfg.context_dim, generator=gen, device="cuda")
    y = torch.randn(2, cfg.adm_in_channels, generator=gen, device="cuda")

    cn = registry.get_controlnet("sdxl") if control else None
    hint = torch.rand(2, sampler["height"], sampler["width"], 3,
                      generator=gen, device="cuda")

    def forward():
        with torch.no_grad():
            residuals = None
            if cn is not None:
                down, mid = cn.model(x, t, ctx, y, hint)
                residuals = ([d * 0.8 for d in down], mid * 0.8)
            unet(x, t, ctx, y, control=residuals)

    label = (f"sdxl UNet{' + ControlNet' if control else ''} forward at "
             f"{sampler['height']}x{sampler['width']} with CFG (latent "
             f"{tuple(x.shape)})")
    return forward, label


def wan_forward(torch, registry):
    """One WanModel forward of the WAN t2v workflow with CFG (the doubled
    batch against a zero context); returns (forward, label)."""
    from comfyui_distributed_tpu_torch.diffusion.pipeline_video import VideoSpec

    workflow = json.loads((ROOT / "workflows" / "wan-t2v.json").read_text())
    node = workflow["4"]["inputs"]
    bundle = registry.get("wan")
    model = bundle.pipeline.dit
    ctx, _ = bundle.text_encoder.encode([workflow["2"]["inputs"]["text"]])
    ctx = torch.cat([ctx, torch.zeros_like(ctx)])
    spec = VideoSpec(frames=node["frames"], height=node["height"],
                     width=node["width"])
    shape = bundle.pipeline.latent_shape(spec)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, *shape[1:], generator=gen, device="cuda")
    t = torch.tensor([0.5, 0.5], device="cuda")

    def forward():
        with torch.no_grad():
            model(x, t, ctx)

    f, h, w = shape[1:4]
    label = (f"wan forward at {node['frames']} frames of {node['width']}x"
             f"{node['height']} with CFG (latent {tuple(x.shape)}: "
             f"{f * h * w // 4} tokens, {ctx.shape[1]} text tokens)")
    return forward, label


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model",
                    choices=("flux", "sdxl", "sdxl-controlnet", "wan"),
                    default="flux")
    ap.add_argument("--forwards", type=int, default=2)
    ap.add_argument("--trace", default=None,
                    help="Chrome trace path (default output/profiles/"
                         "<model>_forward_trace.json)")
    args = ap.parse_args()
    trace = Path(args.trace or ROOT / "output" / "profiles" /
                 f"{args.model}_forward_trace.json")
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_flux: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    registry = ModelRegistry("cuda", seed=0)
    if args.model == "flux":
        forward, label = flux_forward(torch, registry)
    elif args.model == "wan":
        forward, label = wan_forward(torch, registry)
    else:
        forward, label = sdxl_forward(torch, registry,
                                      control=args.model == "sdxl-controlnet")

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.forwards):
            forward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / args.forwards

    for _ in range(2):
        forward()
    wall = timed()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_wall = timed()
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        print("profile_torch_flux: the trace holds no kernel", file=sys.stderr)
        return 1
    n = args.forwards
    busy = busy_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels]) / 1e6 / n
    by_class: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        cls = kernel_class(e["name"])
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"] / 1e6 / n
        rec = by_name.setdefault(e["name"], [0.0, 0])
        rec[0] += e["dur"] / 1e6 / n
        rec[1] += 1
    print(f"{label}, {n} traced forwards")
    print(f"  wall {wall:.4f} s/forward untraced, {traced_wall:.4f} traced; "
          f"device busy {busy:.4f} s/forward; idle share {1 - busy / wall:.1%}; "
          f"{len(kernels) / n:.0f} kernels/forward")
    for cls, secs in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {secs:.4f} s/forward ({secs / busy:.1%} of busy)")
    print("  top kernels (s/forward, launches/forward):")
    for name, (secs, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {secs:.4f}  {count // n:5d}  {name[:110]}")
    print(json.dumps({"model": args.model, "wall_s": wall,
                      "traced_wall_s": traced_wall, "busy_s": busy,
                      "idle_share": 1 - busy / wall, "by_class_s": by_class,
                      "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
