#!/usr/bin/env python3
"""The port's attention wrappers of two checkouts on one NVIDIA card, in
turns.

    python3 scripts/ab_attention_torch.py --parent DIR [--rounds 1] [--forward sdxl|flux]

DIR holds another checkout of this repository (at least its
``comfyui_distributed_tpu_torch/ops``; for example the parent commit,
unpacked with ``git archive``). Each tree's ``ops/flash_attention.py`` is
loaded as a module of its own and builds its own kernel library (into
``build/torch_kernels`` under its tree). At every shape of the SDXL and
FLUX paths (K1's self-attention, K2's cross-attention, K3's joint
attention; ``chip_smoke.py`` holds the shapes) the two trees' outputs are
compared, then each wrapper call is timed in the order parent, change,
change, parent (``--rounds`` times): device milliseconds per launch from
CUDA events, and host microseconds to enqueue one call while the card is
held in a spin. With ``--forward``, one denoising forward of the full-width
model at its workflow's shape (``scripts/profile_torch_flux.py`` builds it)
is also timed in the same order with each tree's wrappers behind the
port's attention dispatch: host seconds per forward, ended by a
synchronise, over ``--forwards`` forwards a reading. Prints one line per
reading, then the card's name and power limit, then one JSON line with
every reading.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODULE = Path("comfyui_distributed_tpu_torch") / "ops" / "flash_attention.py"


def load(tree: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, tree / MODULE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forward_readings(torch, trees: dict, args) -> list[dict]:
    """Seconds per model forward with each tree's wrappers behind the
    port's attention dispatch, in the order parent, change, change,
    parent."""
    from unittest import mock

    sys.path.insert(0, str(ROOT / "scripts"))
    import profile_torch_flux as prof
    from comfyui_distributed_tpu_torch.models.registry import ModelRegistry
    from comfyui_distributed_tpu_torch.ops import attention

    build = prof.sdxl_forward if args.forward == "sdxl" else prof.flux_forward
    forward, label = build(torch, ModelRegistry("cuda", seed=0))
    readings = []
    for _ in range(args.rounds):
        for tree in ("parent", "change", "change", "parent"):
            with mock.patch.object(attention, "fa", trees[tree]):
                forward()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.forwards):
                    forward()
                torch.cuda.synchronize()
                secs = (time.perf_counter() - t0) / args.forwards
            readings.append({"forward": label, "tree": tree, "s": secs})
            print(f"{label} {tree}: {secs:.5f} s/forward", flush=True)
    return readings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--forward", choices=("sdxl", "flux"), default=None)
    ap.add_argument("--forwards", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_attention_torch: no CUDA device is available", file=sys.stderr)
        return 2
    if not (args.parent / MODULE).is_file():
        print(f"ab_attention_torch: {args.parent / MODULE} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    trees = {"parent": load(args.parent.resolve(), "parent_attention"),
             "change": load(ROOT, "change_attention")}
    for fa in trees.values():
        fa.KERNELS.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def case(kernel, shape):
        """Inputs at the shape and, per tree, the wrapper call on them."""
        if kernel == "fused_qkv_attention":
            B, N, C, H = shape
            x = randn(B, N, C)
            ws = [randn(H * 64, C, scale=C ** -0.5) for _ in range(3)]
            return lambda fa: lambda: fa.fused_qkv_attention(x, *ws, H)
        layout = kernel.rsplit("_", 1)[1]
        B, Nq, Nk, H, D = shape
        q, k, v = randn(B, Nq, H, D), randn(B, Nk, H, D), randn(B, Nk, H, D)
        return lambda fa: lambda: fa.flash_attention(q, k, v, layout=layout)

    cases = ([("fused_qkv_attention", s) for s, _ in cs.FUSED_SHAPES]
             + [("flash_attention_packed", s) for s, _ in cs.PACKED_SHAPES]
             + [("flash_attention_bh", s) for s, _ in cs.BH_SHAPES])
    readings = []
    for kernel, shape in cases:
        call = case(kernel, shape)
        a, b = (call(trees[t])() for t in ("parent", "change"))
        torch.cuda.synchronize()
        err = (a.float() - b.float()).abs().max().item()
        scale = a.float().abs().max().item()
        if err > cs.KERNEL_TOL * scale:
            print(f"ab_attention_torch: {kernel} {shape}: the trees disagree "
                  f"({err} of max {scale})", file=sys.stderr)
            return 1
        for _ in range(args.rounds):
            for tree in ("parent", "change", "change", "parent"):
                fn = call(trees[tree])
                ms = cs.cuda_ms(torch, fn, iters=50)
                us = cs.enqueue_us(torch, fn)
                readings.append({"kernel": kernel, "shape": shape,
                                 "tree": tree, "ms": ms, "enqueue_us": us})
                print(f"{kernel} {shape} {tree}: {ms:.5f} ms, host "
                      f"{us:.2f} us to enqueue", flush=True)
    if args.forward:
        readings += forward_readings(torch, trees, args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
