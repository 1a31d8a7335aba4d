"""Cloudflare quick-tunnel manager for NAT traversal to remote hosts (the
port's copy of the JAX package's ``utils/tunnel.py``).

The tunnel's lifecycle runs under an async lock with its state kept in
the config; a reader thread captures the ``*.trycloudflare.com`` URL
and the errors from the child's output into a rolling buffer; starting
it swaps the config's master host to the public URL, so remote workers
call back through the tunnel, and stopping restores the previous host.
Starting a tunnel arms the cluster token first (``utils/auth.py``): the
public URL is never born unprotected.

The binary is discovered (``CLOUDFLARED_PATH`` → the package's ``bin/``
→ ``$PATH``) and, where none is found and
``CDT_CLOUDFLARED_AUTO_DOWNLOAD`` allows it, downloaded from the pinned
GitHub release with its sha256 computed and, when
``CDT_CLOUDFLARED_SHA256`` pins it, checked. ``fetcher`` replaces the
download (the tests pass a fake). With the download off and no binary,
starting fails at once with ``TunnelError``.
"""

from __future__ import annotations

import asyncio
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional

from . import constants
from .config import load_config, update_config
from .exceptions import TunnelError
from .logging import debug_log, log

URL_RE = re.compile(r"https://[a-z0-9-]+\.trycloudflare\.com")
START_TIMEOUT = constants.tunnel_start_timeout()
LOG_BUFFER_LINES = 200


def find_cloudflared() -> Optional[str]:
    """Binary discovery (reference ``binary.py:69-83``)."""
    env = os.environ.get("CLOUDFLARED_PATH")
    if env and Path(env).is_file():
        return env
    local = _local_bin_path()
    if local.is_file():
        return str(local)
    return shutil.which("cloudflared")


def _local_bin_path() -> Path:
    name = "cloudflared.exe" if os.name == "nt" else "cloudflared"
    return Path(__file__).resolve().parent.parent / "bin" / name


# --- auto-download (reference utils/cloudflare/binary.py:47-66) -------------

# Pinned by default for reproducible installs (and so a shipped
# CDT_CLOUDFLARED_SHA256 pin stays meaningful); CDT_CLOUDFLARED_VERSION
# overrides, "latest" opts into the moving target. A pinned tag that
# 404s falls back to latest with a log line.
PINNED_VERSION = "2025.2.0"
RELEASE_URL = ("https://github.com/cloudflare/cloudflared/releases/"
               "download/{version}/{asset}")
LATEST_URL = ("https://github.com/cloudflare/cloudflared/releases/"
              "latest/download/{asset}")


def _platform_asset() -> str:
    """Release asset name for this platform (the reference keys the same
    GitHub release assets by os/arch)."""
    import platform as _platform

    mach = _platform.machine().lower()
    arch = {"x86_64": "amd64", "amd64": "amd64",
            "aarch64": "arm64", "arm64": "arm64"}.get(mach, "amd64")
    sysname = _platform.system().lower()
    if sysname == "windows":
        return f"cloudflared-windows-{arch}.exe"
    if sysname == "darwin":
        return f"cloudflared-darwin-{arch}.tgz"
    return f"cloudflared-linux-{arch}"


def _http_fetch(url: str, timeout: float = 120.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def download_cloudflared(dest_dir: Optional[Path] = None, fetcher=None,
                         expected_sha256: Optional[str] = None) -> str:
    """Download the platform's cloudflared release into the package-local
    ``bin/`` dir (where ``find_cloudflared`` looks first). Atomic write +
    exec bit; the SHA-256 is always computed and logged, and enforced
    when ``expected_sha256`` (or ``CDT_CLOUDFLARED_SHA256``) is set —
    release assets are fetched over TLS from GitHub, and a pinned hash
    upgrades that to content verification."""
    import hashlib
    import io
    import tarfile

    import tempfile

    asset = _platform_asset()
    fetch = fetcher or _http_fetch
    version = constants.cloudflared_version() or PINNED_VERSION
    if version == "latest":
        url = LATEST_URL.format(asset=asset)
    else:
        url = RELEASE_URL.format(version=version, asset=asset)
    log(f"downloading {asset} ({version}) from GitHub releases")
    try:
        data = fetch(url)
    except Exception as e:
        if version == "latest":
            raise
        # a pinned tag can age out — latest keeps the feature working,
        # at the cost of reproducibility (logged so the drift is visible)
        log(f"pinned cloudflared {version} unavailable ({e}); "
            "falling back to latest")
        data = fetch(LATEST_URL.format(asset=asset))
    expected = expected_sha256 or constants.cloudflared_sha256()
    digest = hashlib.sha256(data).hexdigest()
    if expected and digest != expected.strip().lower():
        raise TunnelError(
            f"cloudflared download checksum mismatch: got {digest}, "
            f"expected {expected} — refusing to install")
    if asset.endswith(".tgz"):
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
            try:
                member = tar.extractfile(tar.getmember("cloudflared"))
            except KeyError:
                member = None
            if member is None:
                raise TunnelError("cloudflared missing from release tgz")
            data = member.read()
    dest = (Path(dest_dir) if dest_dir else _local_bin_path().parent)
    dest.mkdir(parents=True, exist_ok=True)
    out = dest / _local_bin_path().name
    # unique temp + os.replace: concurrent downloaders (master + local
    # worker) can't corrupt each other, and replace overwrites atomically
    # on every platform (same discipline as config.save_config)
    fd, tmp = tempfile.mkstemp(dir=str(dest), prefix=".cloudflared_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    log(f"cloudflared installed at {out} (sha256 {digest})")
    return str(out)


def ensure_cloudflared(fetcher=None) -> str:
    """Discovery first, download as the fallback (reference
    ``binary.py:69-83`` order). ``CDT_CLOUDFLARED_AUTO_DOWNLOAD=0``
    restores the old discovery-only behavior (e.g. air-gapped hosts
    where the download can only time out)."""
    found = find_cloudflared()
    if found:
        return found
    if not constants.cloudflared_auto_download():
        raise TunnelError(
            "cloudflared binary not found and auto-download is disabled — "
            "install it or set CLOUDFLARED_PATH")
    try:
        return download_cloudflared(fetcher=fetcher)
    except TunnelError:
        raise
    except Exception as e:
        raise TunnelError(
            f"cloudflared not found and download failed ({e}) — install "
            "it manually or set CLOUDFLARED_PATH") from e


class _ProcessReader(threading.Thread):
    """Scan tunnel stdout for the public URL + keep a rolling log buffer
    (reference ``process_reader.py:14-97``)."""

    def __init__(self, proc: subprocess.Popen):
        super().__init__(daemon=True)
        self.proc = proc
        self.url: Optional[str] = None
        self.error: Optional[str] = None
        self.lines: deque[str] = deque(maxlen=LOG_BUFFER_LINES)
        self._url_event = threading.Event()

    def run(self) -> None:
        stream = self.proc.stdout
        if stream is None:
            return
        for raw in stream:
            line = raw.decode("utf-8", "replace").rstrip() \
                if isinstance(raw, bytes) else raw.rstrip()
            self.lines.append(line)
            if self.url is None:
                m = URL_RE.search(line)
                if m:
                    self.url = m.group(0)
                    self._url_event.set()
            low = line.lower()
            if "error" in low and self.error is None:
                self.error = line

    def wait_for_url(self, timeout: float) -> Optional[str]:
        self._url_event.wait(timeout)
        return self.url


class TunnelManager:
    """Lifecycle of one quick tunnel exposing this controller's port."""

    def __init__(self, config_path: Optional[Path] = None):
        self.config_path = config_path
        self._lock = asyncio.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[_ProcessReader] = None
        self.url: Optional[str] = None

    # --- status -------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def status(self) -> dict:
        cfg_tunnel = load_config(self.config_path).get("tunnel", {})
        return {
            "running": self.running,
            "url": self.url or cfg_tunnel.get("url"),
            "enabled": bool(cfg_tunnel.get("enabled")),
            "binary": find_cloudflared(),
            "log": list(self._reader.lines) if self._reader else [],
            "error": self._reader.error if self._reader else None,
        }

    # --- lifecycle ----------------------------------------------------------

    async def start_tunnel(self, port: int) -> str:
        async with self._lock:
            if self.running and self.url:
                return self.url
            # the download is blocking urllib I/O — keep it off the event
            # loop (same executor discipline as wait_for_url below)
            binary = await asyncio.get_running_loop().run_in_executor(
                None, ensure_cloudflared)
            # arm auth BEFORE the URL becomes publicly routable — once
            # cloudflared registers with the edge, requests can arrive;
            # generating the token afterwards would leave a window with a
            # fully open mutating control plane
            self._ensure_auth_token()
            cmd = [binary, "tunnel", "--url", f"http://127.0.0.1:{port}"]
            debug_log(f"starting tunnel: {' '.join(cmd)}")
            # fork+exec can stall hundreds of ms on a loaded host — keep
            # it off the event loop (lint rule A001)
            self._proc = await asyncio.get_running_loop().run_in_executor(
                None, lambda: subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            self._reader = _ProcessReader(self._proc)
            self._reader.start()
            url = await asyncio.get_running_loop().run_in_executor(
                None, self._reader.wait_for_url, START_TIMEOUT)
            if not url:
                err = self._reader.error or "no URL within timeout"
                await self._stop_locked()
                raise TunnelError(f"tunnel failed to start: {err}")
            self.url = url
            self._persist_started(url, port)
            log(f"tunnel up: {url}")
            return url

    async def stop_tunnel(self) -> bool:
        async with self._lock:
            return await self._stop_locked()

    async def _stop_locked(self) -> bool:
        was_running = self.running
        if self._proc is not None:
            self._proc.terminate()
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self._proc.wait, 5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None
        self.url = None
        self._persist_stopped()
        return was_running

    # --- state persistence (reference state.py:28-81) -----------------------

    def _ensure_auth_token(self) -> None:
        """A public tunnel must never expose an unauthenticated control
        plane: if no cluster token exists, generate one, persist it, and
        print it ONCE so the operator can hand it to workers/dashboards
        (env ``CDT_AUTH_TOKEN`` overrides; see ``utils/auth.py``)."""
        from .auth import AUTH_ENV, configured_token, generate_token

        if configured_token(load_config(self.config_path)):
            return
        token = generate_token()

        def mutate(cfg: dict) -> None:
            cfg.setdefault("settings", {}).setdefault("auth_token", token)
        update_config(mutate, self.config_path)
        # The token goes to the operator's terminal ONLY — log() feeds the
        # rolling buffer behind /distributed/local_log, which would leak
        # the secret through the very tunnel it protects.
        print(f"[Distributed-Torch] auth token generated for the public "
              f"tunnel: {token}", file=sys.stderr, flush=True)
        log(f"auth token generated and persisted to settings.auth_token — "
            f"pass it to workers/dashboards via {AUTH_ENV} or the "
            "X-CDT-Auth header; mutating routes now require it")

    def _persist_started(self, url: str, port: int) -> None:
        def mutate(cfg: dict) -> None:
            tunnel = cfg.setdefault("tunnel", {})
            master = cfg.setdefault("master", {})
            # remote workers must call back through the tunnel: swap the
            # advertised master host, remembering the previous value
            if master.get("host") != url:
                tunnel["previous_master_host"] = master.get("host", "")
            tunnel.update(enabled=True, url=url, port=port,
                          started_at=time.time())
            master["host"] = url
        update_config(mutate, self.config_path)

    def _persist_stopped(self) -> None:
        def mutate(cfg: dict) -> None:
            tunnel = cfg.setdefault("tunnel", {})
            master = cfg.setdefault("master", {})
            if tunnel.get("url") and master.get("host") == tunnel["url"]:
                master["host"] = tunnel.get("previous_master_host", "")
            tunnel.update(enabled=False, url=None)
        update_config(mutate, self.config_path)


_manager: Optional[TunnelManager] = None


def get_tunnel_manager(config_path: Optional[Path] = None) -> TunnelManager:
    global _manager
    if _manager is None or (config_path is not None
                            and _manager.config_path != config_path):
        _manager = TunnelManager(config_path)
    return _manager
