"""Content-addressed media sync: master → remote host controllers (the
port's copy of the JAX package's ``cluster/media_sync.py``).

A prompt's media file references (``find_media_refs``) are md5-checked
against the remote host through ``/distributed/check_file`` and uploaded
through ``/upload/image`` only on a miss or a mismatch, with the path
separators converted for the host's platform (its
``/distributed/system_info`` ``path_separator``). Only ``remote`` hosts
are synced: a ``local`` one shares the master's input directory.

The transport is the port's urllib client (``utils/network.py``): every
call carries the cluster token and passes the fault plan (operation
``media``). An upload is one multipart body held in memory, where the
JAX package streams the file from disk. The receiving server reads at
most ``CDT_MAX_PAYLOAD_SIZE`` bytes (50 MiB by default) and answers a
larger body 413, so a larger media file fails its upload, and with it
that host's dispatch, until the limit is raised on the host. Each
file's outcome goes to ``cdt_media_sync_files_total`` and the uploaded
bytes to ``cdt_media_sync_bytes_total``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Any, Optional

from .. import telemetry
from ..telemetry import metrics as _tm
from ..utils import constants
from ..utils.exceptions import WorkerError
from ..utils.logging import log, trace_info
from ..utils.multipart import Part, build_multipart
from ..utils.network import build_host_url, fetch_system_info, http_request_async
from .resilience import RetryPolicy

# input names that carry a media file name
MEDIA_INPUT_KEYS = frozenset({"image", "video", "audio", "file", "filename"})

MEDIA_EXTENSIONS = (
    ".png", ".jpg", ".jpeg", ".webp", ".gif", ".bmp",
    ".mp4", ".webm", ".mov", ".avi",
    ".wav", ".mp3", ".flac", ".ogg",
    ".npy", ".npz",
)


@dataclasses.dataclass(frozen=True)
class MediaRef:
    """One media-file reference inside a prompt graph."""
    node_id: str
    input_key: str
    value: str


def looks_like_media(value: Any) -> bool:
    return (
        isinstance(value, str)
        and value.lower().endswith(MEDIA_EXTENSIONS)
        and "\n" not in value
    )


def find_media_refs(prompt: dict) -> list[MediaRef]:
    """Media file names in node inputs. Only media-typed input names
    count, so a text prompt that mentions ``foo.png`` is no reference."""
    refs: list[MediaRef] = []
    for node_id, node in prompt.items():
        inputs = node.get("inputs", {}) if isinstance(node, dict) else {}
        for key, value in inputs.items():
            if key.lower() in MEDIA_INPUT_KEYS and looks_like_media(value):
                refs.append(MediaRef(node_id, key, value))
    return refs


def convert_paths_for_platform(prompt: dict, remote_sep: str) -> dict:
    """Rewrite media-path separators to the remote host's convention
    (Windows hosts take ``\\``, the others ``/``)."""
    if remote_sep not in ("/", "\\"):
        return prompt
    local_sep = "\\" if remote_sep == "/" else "/"
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in prompt.items()}
    for ref in find_media_refs(out):
        if local_sep in ref.value:
            node = dict(out[ref.node_id])
            inputs = dict(node.get("inputs", {}))
            inputs[ref.input_key] = ref.value.replace(local_sep, remote_sep)
            node["inputs"] = inputs
            out[ref.node_id] = node
    return out


async def fetch_host_path_separator(host: dict, timeout: float = 10.0) -> str:
    """The host's ``/distributed/system_info`` ``path_separator``; ``/``
    when it is unreachable or answers something else."""
    info = await fetch_system_info(host, timeout)
    sep = (info or {}).get("path_separator", "/")
    return sep if sep in ("/", "\\") else "/"


def _md5_file(path: Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _media_policy() -> RetryPolicy:
    """Both calls are idempotent (the check reads, the upload overwrites
    with the same content), so a transient failure is retried; a dead
    host must fail its dispatch quickly, hence 3 attempts."""
    return RetryPolicy(max_attempts=3, base=constants.send_backoff_base(),
                       cap=constants.retry_cap_s())


async def _check_remote_file(host: dict, rel: str, md5: str,
                             timeout: float) -> bool:
    """True iff the host already has ``rel`` with this content."""
    url = build_host_url(host, "/distributed/check_file")
    body = json.dumps({"path": rel, "md5": md5}).encode()

    async def attempt() -> bool:
        status, raw = await http_request_async(
            url, body, {"Content-Type": "application/json"}, timeout)
        if status != 200:
            return False
        answer = json.loads(raw)
        return bool(answer.get("exists")) and bool(answer.get("matches", True))

    try:
        return await _media_policy().run(attempt, op="media")
    except (OSError, asyncio.TimeoutError, ValueError) as e:
        log(f"check_file {rel} on {host.get('id')} failed: {e}")
        return False


async def _upload_file(host: dict, rel: str, path: Path,
                       timeout: float) -> bool:
    """Upload one file through ``/upload/image`` (multipart, field
    ``image``); the file is read again for each attempt."""
    url = build_host_url(host, "/upload/image")
    loop = asyncio.get_running_loop()

    async def attempt() -> bool:
        data = await loop.run_in_executor(None, path.read_bytes)
        body, ctype = build_multipart([Part("image", data, filename=rel)])
        status, _ = await http_request_async(
            url, body, {"Content-Type": ctype, "X-CDT-Client": "1"}, timeout)
        if status >= 500:
            # a transient failure on the host: the upload is idempotent
            err = WorkerError(f"upload {rel}: {status}")
            err.retry_safe = True
            raise err
        return status == 200

    try:
        return await _media_policy().run(attempt, op="media")
    except (OSError, asyncio.TimeoutError, WorkerError) as e:
        log(f"upload {rel} to {host.get('id')} failed: {e}")
        return False


@dataclasses.dataclass
class SyncReport:
    checked: int = 0
    uploaded: int = 0
    skipped: int = 0       # already present with matching md5
    missing: int = 0       # absent locally — left untouched
    failed: list = dataclasses.field(default_factory=list)


async def sync_host_media(
    host: dict,
    prompt: dict,
    input_dir: Optional[Path] = None,
    concurrency: Optional[int] = None,
    timeout: Optional[float] = None,
    trace_id: str = "",
) -> tuple[dict, SyncReport]:
    """Make every media file the prompt references present, with the same
    content, on the remote host: at most ``concurrency`` files at a time
    (``CDT_MEDIA_SYNC_CONCURRENCY`` by default), each call bounded by
    ``timeout`` (``CDT_MEDIA_SYNC_TIMEOUT``). Returns the prompt with its
    path separators converted for the host, and the report. A file
    missing here is counted ``missing`` and left to the host."""
    base = Path(input_dir if input_dir is not None else constants.input_dir())
    if concurrency is None:
        concurrency = constants.media_sync_concurrency()
    if timeout is None:
        timeout = constants.media_sync_timeout()
    report = SyncReport()
    refs = find_media_refs(prompt)
    if not refs:
        return prompt, report

    sep = await fetch_host_path_separator(host, timeout)
    sem = asyncio.Semaphore(max(1, int(concurrency)))
    loop = asyncio.get_running_loop()

    def count(outcome: str, nbytes: int = 0) -> None:
        if telemetry.enabled():
            _tm.MEDIA_SYNC_FILES.labels(outcome=outcome).inc()
            if nbytes:
                _tm.MEDIA_SYNC_BYTES.inc(nbytes)

    async def sync_one(ref: MediaRef) -> None:
        async with sem:
            report.checked += 1
            rel = ref.value.replace("\\", "/")
            local = base / rel
            if not local.is_file():
                report.missing += 1
                count("missing")
                log(f"media sync: {local} absent locally; skipping")
                return
            md5 = await loop.run_in_executor(None, _md5_file, local)
            if await _check_remote_file(host, rel, md5, timeout):
                report.skipped += 1
                count("skipped")
            elif await _upload_file(host, rel, local, timeout):
                report.uploaded += 1
                count("uploaded", local.stat().st_size)
            else:
                report.failed.append(rel)
                count("failed")

    await asyncio.gather(*(sync_one(r) for r in refs))
    if trace_id:
        trace_info(trace_id,
                   f"media sync → {host.get('id')}: {report.checked} checked, "
                   f"{report.uploaded} uploaded, {report.skipped} up-to-date, "
                   f"{report.missing} missing, {len(report.failed)} failed")
    return convert_paths_for_platform(prompt, sep), report
