"""CLI: ``python -m comfyui_distributed_tpu_torch serve|info|convert``.

    python -m comfyui_distributed_tpu_torch serve [--host H] [--port P]
        [--device cuda|cpu] [--coordinator HOST:PORT --num-hosts N
        --host-index I]

Runs one host controller with its HTTP control plane until SIGINT or
SIGTERM. The role comes from the environment (``CDT_IS_WORKER``,
``CDT_WORKER_ID``, ``CDT_CONFIG_PATH``, ``CDT_OUTPUT_DIR``). The models
run on the CUDA card; without one, ``serve`` exits with status 2 unless
it is given ``--device cpu``. A master fills its host list on its first
launch (``workers/detection.auto_populate_hosts``: one ``local`` worker
per other card), launches the enabled ``local`` hosts when
``settings.auto_launch_workers`` is on, and stops the workers it
launched when it exits. ``CDT_VIRTUAL_DEVICES=n`` gives its device mesh
n ranks (``parallel/``). With ``--coordinator`` (or ``CDT_COORDINATOR``,
``CDT_NUM_HOSTS``, ``CDT_HOST_INDEX``) the hosts join one mesh, one rank
a host: host 0 serves and drives it, every other host serves host 0's
mesh calls as a follower rank until host 0 stops it.

    python -m comfyui_distributed_tpu_torch info [--device cuda|cpu]

Prints the controller's ``system_info`` (host facts and the card census)
as JSON.

    python -m comfyui_distributed_tpu_torch convert
        --preset sdxl|sd15|flux|sd3-medium|sd35-large|wan|wan-i2v|wan-2.2-t2v
        --checkpoint FILE.safetensors --out DIR [--vae FILE]
        [--t5 FILE --clip-l FILE] [--checkpoint-low FILE] [--device D]

Converts a published single-file checkpoint (for ``flux`` the BFL
transformer, with its T5-XXL and CLIP-L files; for ``sd3-medium`` and
``sd35-large`` the SAI MMDiT with its T5-XXL and CLIP-L files: as in the
JAX CLI there is no ``--clip-g``, the bundle's CLIP-G is drawn from the
seed and a file of it is loaded with ``load_text_encoder_files(clip_g=)``;
for ``wan`` the WAN
transformer with its UMT5-XXL file; for ``wan-2.2-t2v`` the high-noise
expert, with the low-noise one as ``--checkpoint-low``; optionally a
standalone VAE, BFL's ``ae.safetensors`` for ``flux``) into the port's
bundle format, ``DIR/state.pt`` and
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


def _controller(args: argparse.Namespace):
    """The controller on ``--device``, or None (and a message) when the
    card is missing."""
    from .cluster.controller import Controller

    try:
        return Controller(device=args.device)
    except RuntimeError as e:          # no card and no --device cpu
        print(f"{args.command}: {e} ({args.command} --device cpu runs on "
              "the CPU)", file=sys.stderr)
        return None


def cmd_serve(args: argparse.Namespace) -> int:
    import atexit

    from .parallel.bootstrap import (ensure_virtual_devices, init_multihost,
                                     multihost, serve_follower)

    ensure_virtual_devices()
    if init_multihost(coordinator_address=args.coordinator,
                      num_processes=args.num_hosts,
                      process_id=args.host_index) and multihost()["rank"]:
        import torch

        from .utils.constants import checkpoint_root
        from .utils.device import resolve_device, use_full_fp32

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"serve: {e}", file=sys.stderr)
            return 2
        if device.type == "cuda":
            torch.cuda.set_device(0)
            use_full_fp32()
        # a controller's registry: seed 0, CDT_CHECKPOINT_ROOT's files
        return serve_follower(device, 0, checkpoint_root())

    from .api.app import run_app
    from .utils.config import update_config
    from .utils.logging import log
    from .workers.detection import auto_populate_hosts
    from .workers.process_manager import delayed_auto_launch

    controller = _controller(args)
    if controller is None:
        return 2
    if not controller.is_worker and not controller.load_config().get(
            "settings", {}).get("has_auto_populated_workers"):
        update_config(auto_populate_hosts, controller.config_path)

    async def main() -> None:
        server = await run_app(controller, host=args.host, port=args.port)
        if not controller.is_worker:
            manager = controller.worker_manager
            launch = asyncio.ensure_future(delayed_auto_launch(manager))
            atexit.register(manager.cleanup_all)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        log("shutting down")
        if not controller.is_worker:
            launch.cancel()
        await server.stop()

    asyncio.run(main())
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    controller = _controller(args)
    if controller is None:
        return 2
    print(json.dumps(controller.system_info(), indent=2, default=str))
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    from pathlib import Path

    from .models.registry import PRESETS, ModelBundle, preset_for_checkpoint

    def refuse(why: str) -> int:
        print(f"convert: {why}", file=sys.stderr)
        return 2

    preset = PRESETS.get(args.preset)
    if preset is None or (preset.clip is None and preset.kind == "unet"):
        have = sorted(k for k, p in PRESETS.items()
                      if p.clip is not None or p.kind != "unet")
        return refuse(f"preset {args.preset!r} has no single-file "
                      f"checkpoint layout; have {have}")
    if preset.moe_boundary is not None and not args.checkpoint_low:
        # before converting 28 GB: the low expert would stay unfilled
        return refuse(f"preset {args.preset!r} is a dual-expert model: pass "
                      "the low-noise transformer with --checkpoint-low")
    if args.checkpoint_low and preset.moe_boundary is None:
        return refuse(f"--checkpoint-low is for a dual-expert preset; "
                      f"{args.preset!r} has one transformer")
    if ((args.t5 and preset.clip not in ("flux", "sd3", "umt5"))
            or (args.clip_l and preset.clip not in ("flux", "sd3"))):
        return refuse("--t5 and --clip-l are FLUX's text-encoder files "
                      "(and SD3's; --t5 also WAN's UMT5-XXL); preset "
                      f"{args.preset!r} takes no such file")
    files = [Path(f) for f in (args.checkpoint, args.checkpoint_low, args.t5,
                               args.clip_l, args.vae) if f]
    missing = [str(f) for f in files if not f.is_file()]
    if missing:
        return refuse(f"no such file: {missing}")
    try:
        bundle = ModelBundle(
            preset_for_checkpoint(preset, Path(args.checkpoint)),
            device=args.device, empty_core=True)
    except RuntimeError as e:          # no card and no --device cpu
        return refuse(str(e))
    if args.checkpoint_low:
        bundle.load_safetensors_moe(Path(args.checkpoint),
                                    Path(args.checkpoint_low))
    else:
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
    serve.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                       help="multi-host: host 0's rendezvous address "
                            "(env CDT_COORDINATOR)")
    serve.add_argument("--num-hosts", type=int, default=None,
                       help="multi-host: total host processes "
                            "(env CDT_NUM_HOSTS)")
    serve.add_argument("--host-index", type=int, default=None,
                       help="multi-host: this host's process index "
                            "(env CDT_HOST_INDEX)")
    serve.set_defaults(fn=cmd_serve)
    info = sub.add_parser("info", help="print the host's system info")
    info.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help="the controller's device (default: cuda)")
    info.set_defaults(fn=cmd_info)
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
                      help="FLUX's or SD3's T5-XXL or WAN's UMT5-XXL file "
                           "(HF T5EncoderModel/UMT5EncoderModel layout)")
    conv.add_argument("--clip-l", dest="clip_l", default=None,
                      help="FLUX's or SD3's CLIP-L file (HF text_model.* "
                           "layout)")
    conv.add_argument("--checkpoint-low", dest="checkpoint_low", default=None,
                      help="WAN 2.2's low-noise expert (--checkpoint is the "
                           "high-noise one)")
    conv.set_defaults(fn=cmd_convert)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
