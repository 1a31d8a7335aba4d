"""Tunnel routes on the port's router (the JAX package's
``api/tunnel_routes.py``): ``GET /distributed/tunnel/status``,
``POST /distributed/tunnel/start`` (503 naming the cause when no tunnel
comes up: no binary with the download off, a failed download, no URL in
time) and ``POST /distributed/tunnel/stop``."""

from __future__ import annotations

from ..utils.exceptions import TunnelError
from ..utils.tunnel import get_tunnel_manager


def register(app, controller) -> None:
    from .app import Response

    def manager():
        return get_tunnel_manager(controller.config_path)

    async def tunnel_status(request):
        return Response(200, manager().status())

    async def tunnel_start(request):
        port = controller.load_config().get("master", {}).get("port", 8288)
        try:
            url = await manager().start_tunnel(port)
        except TunnelError as e:
            return Response(503, {"error": str(e)})
        return Response(200, {"status": "started", "url": url})

    async def tunnel_stop(request):
        stopped = await manager().stop_tunnel()
        return Response(200, {"status": "stopped" if stopped else "not_running"})

    app.add("GET", "/distributed/tunnel/status", tunnel_status)
    app.add("POST", "/distributed/tunnel/start", tunnel_start)
    app.add("POST", "/distributed/tunnel/stop", tunnel_stop)
