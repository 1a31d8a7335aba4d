"""JSON configuration with cached loads, atomic saves, and async transactions
(the port's copy of the JAX package's ``utils/config.py``, same schema, so
one config file serves either package).

Defaults are deep-merged under the loaded values with unknown keys kept;
loads are cached by (path, mtime); saves go through a temporary file,
fsync and rename. Hosts are per-controller entries ``{id, address,
enabled, type}``.
"""

from __future__ import annotations

import asyncio
import copy
import json
import os
import tempfile
import threading
from contextlib import asynccontextmanager
from pathlib import Path
from typing import Any, AsyncIterator, Callable

from .exceptions import ConfigError

_DEFAULT_NAME = "cuda_cluster_config.json"

DEFAULT_CONFIG: dict[str, Any] = {
    "master": {
        "host": "",          # advertised callback host ("" = auto-detect)
        "port": 8288,
        "delegate_only": False,   # master coordinates but contributes no compute
    },
    "hosts": [],
    "mesh": {
        "shape": {"dp": -1},
        "collect_axis": "dp",
    },
    "settings": {
        "debug": False,
        "auto_launch_workers": False,
        "stop_workers_on_master_exit": True,
        "master_delegate_only": False,
        "worker_timeout_seconds": 60,
        "worker_probe_concurrency": 10,
        "worker_prep_concurrency": 4,
        "media_sync_concurrency": 4,
        "media_sync_timeout_seconds": 120,
    },
    "tunnel": {},
    "managed_processes": {},
}

_HOST_DEFAULTS: dict[str, Any] = {
    "id": "",
    "name": "",
    "address": "",       # http(s)://host:port of the host controller
    "enabled": False,
    "type": "remote",    # "local" | "remote" | "cloud"
    "mesh_devices": -1,
    "extra_args": "",
}


def config_path() -> Path:
    from .constants import config_path as override

    path = override()
    if path:
        return Path(path)
    return Path(__file__).resolve().parent.parent / _DEFAULT_NAME


def _deep_merge(defaults: dict, loaded: dict) -> dict:
    """Defaults filled in under loaded values; unknown keys in ``loaded``
    are kept."""
    out = copy.deepcopy(defaults)
    for k, v in loaded.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def normalize_host(entry: dict) -> dict:
    return _deep_merge(_HOST_DEFAULTS, entry)


# --- cached load -----------------------------------------------------------

_cache_lock = threading.Lock()
_cache: tuple[Path, float, dict] | None = None  # (path, mtime, config)


def load_config(path: Path | None = None) -> dict[str, Any]:
    """Load config with defaults merged; cached by (path, mtime)."""
    global _cache
    p = path or config_path()
    with _cache_lock:
        try:
            mtime = p.stat().st_mtime
        except OSError:
            _cache = None
            return copy.deepcopy(DEFAULT_CONFIG)
        if _cache is not None and _cache[0] == p and _cache[1] == mtime:
            return copy.deepcopy(_cache[2])
        try:
            with open(p, "r", encoding="utf-8") as f:
                loaded = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ConfigError(f"cannot read config {p}: {e}") from e
        merged = _deep_merge(DEFAULT_CONFIG, loaded)
        merged["hosts"] = [normalize_host(h) for h in merged.get("hosts", [])]
        _cache = (p, mtime, merged)
        return copy.deepcopy(merged)


def save_config(config: dict[str, Any], path: Path | None = None) -> None:
    """Atomic save: temporary file in the same directory, fsync, rename."""
    global _cache
    p = path or config_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(p.parent), prefix=".cdt_cfg_")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(config, f, indent=2, sort_keys=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise ConfigError(f"cannot write config {p}: {e}") from e
    with _cache_lock:
        _cache = None


def invalidate_cache() -> None:
    global _cache
    with _cache_lock:
        _cache = None


# --- transaction -----------------------------------------------------------

_txn_lock = asyncio.Lock()


@asynccontextmanager
async def config_transaction(path: Path | None = None) -> AsyncIterator[dict]:
    """Async read-modify-write: mutate the yielded dict; it is saved on
    exit."""
    async with _txn_lock:
        cfg = load_config(path)
        yield cfg
        save_config(cfg, path)


def update_config(mutate: Callable[[dict], None], path: Path | None = None) -> dict:
    """Synchronous read-modify-write for non-async callers."""
    cfg = load_config(path)
    mutate(cfg)
    save_config(cfg, path)
    return cfg


# --- accessors ---------------------------------------------------------------


def get_setting(name: str, default: Any = None, path: Path | None = None) -> Any:
    return load_config(path).get("settings", {}).get(name, default)


def peek_setting(name: str, default: Any = None,
                 path: Path | None = None) -> Any:
    """Read one settings key without deep-copying the whole config (one
    stat and a dict lookup when the cache is warm); callers must not
    mutate the returned value."""
    p = path or config_path()
    with _cache_lock:
        if _cache is not None and _cache[0] == p:
            try:
                if p.stat().st_mtime == _cache[1]:
                    return _cache[2].get("settings", {}).get(name, default)
            except OSError:
                return DEFAULT_CONFIG.get("settings", {}).get(name, default)
    try:
        return load_config(p).get("settings", {}).get(name, default)
    except ConfigError:
        return default


def get_worker_timeout_seconds(path: Path | None = None) -> float:
    from .constants import heartbeat_timeout

    v = get_setting("worker_timeout_seconds", None, path)
    return float(v) if v else heartbeat_timeout()


def is_master_delegate_only(path: Path | None = None) -> bool:
    cfg = load_config(path)
    return bool(
        cfg.get("settings", {}).get("master_delegate_only")
        or cfg.get("master", {}).get("delegate_only")
    )


def enabled_hosts(config: dict[str, Any] | None = None) -> list[dict]:
    cfg = config or load_config()
    return [h for h in cfg.get("hosts", []) if h.get("enabled")]


def ensure_config_exists(path: Path | None = None) -> Path:
    p = path or config_path()
    if not p.exists():
        save_config(copy.deepcopy(DEFAULT_CONFIG), p)
    return p
