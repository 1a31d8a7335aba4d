"""Config routes on the port's router (the JAX package's
``api/config_routes.py``): ``GET /distributed/config`` and its update
routes, each one config transaction with the JAX package's validation,
so the same request leaves the same config file in either package.

``POST /distributed/config/update_mesh`` declares the device mesh: the
shape is validated as a ``MeshSpec`` (400 otherwise), written to
``mesh.shape``, and the controller's mesh is dropped (its followers
stopped), so the next request builds it with the new shape.
"""

from __future__ import annotations

import asyncio

from ..utils.config import config_transaction, normalize_host
from ..utils.exceptions import ValidationError
from ..workers.detection import auto_populate_hosts
from .schemas import require_fields, validate_worker_id

# setting name → the type(s) its value must have
SETTING_SCHEMA: dict[str, type | tuple] = {
    "debug": bool,
    "auto_launch_workers": bool,
    "stop_workers_on_master_exit": bool,
    "master_delegate_only": bool,
    "worker_timeout_seconds": (int, float),
    "worker_probe_concurrency": int,
    "worker_prep_concurrency": int,
    "media_sync_concurrency": int,
    "media_sync_timeout_seconds": (int, float),
    "permissive_cors": bool,
    "auth_token": str,     # rotate or clear the cluster token (utils/auth.py)
}

HOST_FIELDS = {"id", "name", "address", "enabled", "type", "mesh_devices",
               "extra_args"}
MASTER_FIELDS = {"host", "port", "delegate_only"}


def register(app, controller) -> None:
    from .app import Response

    path = controller.config_path

    async def get_config(request):
        return Response(200, controller.load_config())

    async def update_worker(request):
        body = request.json()
        require_fields(body, "id")
        wid = validate_worker_id(body["id"])
        unknown = set(body) - HOST_FIELDS
        if unknown:
            raise ValidationError(f"unknown host fields {sorted(unknown)}")
        if "type" in body and body["type"] not in ("local", "remote", "cloud"):
            raise ValidationError(f"invalid host type {body['type']!r}",
                                  field="type")
        async with config_transaction(path) as cfg:
            hosts = cfg.setdefault("hosts", [])
            for h in hosts:
                if h.get("id") == wid:
                    h.update(body)
                    break
            else:
                hosts.append(normalize_host(body))
        return Response(200, {"status": "ok"})

    async def delete_worker(request):
        body = request.json()
        require_fields(body, "id")
        wid = body["id"]
        async with config_transaction(path) as cfg:
            before = len(cfg.get("hosts", []))
            cfg["hosts"] = [h for h in cfg.get("hosts", []) if h.get("id") != wid]
            removed = before - len(cfg["hosts"])
        if not removed:
            return Response(404, {"error": f"no host {wid!r}"})
        return Response(200, {"status": "ok"})

    async def update_setting(request):
        body = request.json()
        require_fields(body, "key")
        key = body["key"]
        if key not in SETTING_SCHEMA:
            raise ValidationError(f"unknown setting {key!r}", field="key")
        expected = SETTING_SCHEMA[key]
        value = body.get("value")
        if (not isinstance(value, expected)
                or isinstance(value, bool) and expected is not bool):
            raise ValidationError(f"setting {key!r} expects {expected}",
                                  field="value")
        async with config_transaction(path) as cfg:
            cfg.setdefault("settings", {})[key] = value
        return Response(200, {"status": "ok"})

    async def update_master(request):
        body = request.json()
        if not isinstance(body, dict):
            raise ValidationError("body must be a JSON object")
        unknown = set(body) - MASTER_FIELDS
        if unknown:
            raise ValidationError(f"unknown master fields {sorted(unknown)}")
        async with config_transaction(path) as cfg:
            cfg.setdefault("master", {}).update(body)
        return Response(200, {"status": "ok"})

    async def update_mesh(request):
        body = request.json()
        shape = body.get("shape") if isinstance(body, dict) else None
        if not isinstance(shape, dict) or not shape:
            raise ValidationError("'shape' must be a non-empty object",
                                  field="shape")
        from ..parallel.mesh import MeshSpec
        from ..utils.exceptions import ShardingError

        try:
            MeshSpec.from_mapping(shape)
        except (ShardingError, TypeError, ValueError) as e:
            raise ValidationError(str(e), field="shape") from None
        async with config_transaction(path) as cfg:
            cfg.setdefault("mesh", {})["shape"] = shape
        # rebuilt with the new shape at its next use; the followers'
        # stop blocks, so it runs off the loop
        await asyncio.get_running_loop().run_in_executor(
            None, controller.reset_mesh)
        return Response(200, {"status": "ok"})

    async def auto_populate(request):
        """The first-launch host list on demand (the dashboard's button
        is the user's consent: it runs again after the first launch)."""
        async with config_transaction(path) as cfg:
            before = {h.get("id") for h in cfg.get("hosts", [])}
            auto_populate_hosts(cfg, force=True)
            added = [h for h in cfg.get("hosts", [])
                     if h.get("id") not in before]
        return Response(200, {"status": "ok", "added": added,
                              "total_hosts": len(before) + len(added)})

    app.add("GET", "/distributed/config", get_config)
    app.add("POST", "/distributed/config/auto_populate", auto_populate)
    app.add("POST", "/distributed/config/update_worker", update_worker)
    app.add("POST", "/distributed/config/delete_worker", delete_worker)
    app.add("POST", "/distributed/config/update_setting", update_setting)
    app.add("POST", "/distributed/config/update_master", update_master)
    app.add("POST", "/distributed/config/update_mesh", update_mesh)
