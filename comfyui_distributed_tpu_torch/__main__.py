"""CLI: ``python -m comfyui_distributed_tpu_torch serve|convert``.

    python -m comfyui_distributed_tpu_torch serve [--host H] [--port P]
        [--device cuda|cpu]

Runs one host controller with its HTTP control plane until SIGINT or
SIGTERM. The role comes from the environment (``CDT_IS_WORKER``,
``CDT_WORKER_ID``, ``CDT_CONFIG_PATH``, ``CDT_OUTPUT_DIR``). The models
run on the CUDA card; without one, ``serve`` exits with status 2 unless
it is given ``--device cpu``.

    python -m comfyui_distributed_tpu_torch convert --preset sdxl|sd15|flux
        --checkpoint FILE.safetensors --out DIR [--vae FILE]
        [--t5 FILE --clip-l FILE] [--device D]

Converts a published single-file checkpoint (for ``flux`` the BFL
transformer, with its T5-XXL and CLIP-L files; optionally a standalone
VAE, BFL's ``ae.safetensors`` for ``flux``) into the port's bundle
format, ``DIR/state.pt`` and
``DIR/cdt_manifest.json``; with ``DIR`` at ``<CDT_CHECKPOINT_ROOT>/<preset>``
every controller restores it. Prints one JSON line (with the card's peak
allocated bytes when it ran there).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys


def cmd_serve(args: argparse.Namespace) -> int:
    from .api.app import run_app
    from .cluster.controller import Controller
    from .utils.logging import log

    try:
        controller = Controller(device=args.device)
    except RuntimeError as e:          # no card and no --device cpu
        print(f"serve: {e} (serve --device cpu runs the models on the CPU)",
              file=sys.stderr)
        return 2

    async def main() -> None:
        server = await run_app(controller, host=args.host, port=args.port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        log("shutting down")
        await server.stop()

    asyncio.run(main())
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    from pathlib import Path

    from .models.registry import PRESETS, ModelBundle, preset_for_checkpoint

    def refuse(why: str) -> int:
        print(f"convert: {why}", file=sys.stderr)
        return 2

    if args.checkpoint_low:
        return refuse("--checkpoint-low (WAN 2.2's dual experts) is not "
                      "ported yet (ROADMAP.md, item 15)")
    preset = PRESETS.get(args.preset)
    if preset is None or (preset.clip is None and preset.kind != "dit"):
        have = sorted(k for k, p in PRESETS.items()
                      if p.clip is not None or p.kind == "dit")
        return refuse(f"preset {args.preset!r} has no single-file "
                      f"checkpoint layout; have {have}")
    if (args.t5 or args.clip_l) and preset.clip != "flux":
        return refuse("--t5 and --clip-l are FLUX's text-encoder files; "
                      f"preset {args.preset!r} bundles its encoders in its "
                      "single file")
    files = [Path(f) for f in (args.checkpoint, args.t5, args.clip_l,
                               args.vae) if f]
    missing = [str(f) for f in files if not f.is_file()]
    if missing:
        return refuse(f"no such file: {missing}")
    try:
        bundle = ModelBundle(
            preset_for_checkpoint(preset, Path(args.checkpoint)),
            device=args.device, empty_core=True)
    except RuntimeError as e:          # no card and no --device cpu
        return refuse(str(e))
    bundle.load_safetensors_checkpoint(Path(args.checkpoint))
    if args.t5 or args.clip_l:
        bundle.load_text_encoder_files(
            t5=Path(args.t5) if args.t5 else None,
            clip_l=Path(args.clip_l) if args.clip_l else None)
    if args.vae:
        bundle.load_vae_file(Path(args.vae))
    bundle.save_checkpoint(Path(args.out))
    line = {"preset": args.preset, "out": str(args.out),
            "entries": sorted(bundle._state_entries())}
    if bundle.device.type == "cuda":
        import torch

        line["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            bundle.device)
    print(json.dumps(line))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="comfyui_distributed_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="run a host controller")
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=None,
                       help="listening port (default: the config's master.port)")
    serve.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the models run (default: cuda)")
    serve.set_defaults(fn=cmd_serve)
    conv = sub.add_parser(
        "convert", help="convert a single-file .safetensors checkpoint")
    conv.add_argument("--checkpoint", required=True)
    conv.add_argument("--preset", default="sdxl")
    conv.add_argument("--out", required=True)
    conv.add_argument("--vae", default=None,
                      help="standalone VAE .safetensors (LDM-embedded, SD "
                           "VAE or BFL ae layouts)")
    conv.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help="where the conversion runs (default: cuda)")
    conv.add_argument("--t5", default=None,
                      help="FLUX's T5-XXL file (HF T5EncoderModel layout)")
    conv.add_argument("--clip-l", dest="clip_l", default=None,
                      help="FLUX's CLIP-L file (HF text_model.* layout)")
    conv.add_argument("--checkpoint-low", dest="checkpoint_low", default=None,
                      help="WAN 2.2's low-noise expert: not ported yet "
                           "(item 15)")
    conv.set_defaults(fn=cmd_convert)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
