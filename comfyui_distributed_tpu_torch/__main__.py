"""CLI: ``python -m comfyui_distributed_tpu_torch serve``.

    python -m comfyui_distributed_tpu_torch serve [--host H] [--port P]
        [--device cuda|cpu]

Runs one host controller with its HTTP control plane until SIGINT or
SIGTERM. The role comes from the environment (``CDT_IS_WORKER``,
``CDT_WORKER_ID``, ``CDT_CONFIG_PATH``, ``CDT_OUTPUT_DIR``). The models
run on the CUDA card; without one, ``serve`` exits with status 2 unless
it is given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
