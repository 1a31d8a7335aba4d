"""The environment knobs the port's control plane reads, under the JAX
package's names and with its defaults (``utils/constants.py`` there).

Each knob is a plain function that reads the environment when it is
called, so a launcher or a test that sets a variable is seen at the next
read. An empty value means the default; a value that does not parse
raises ``KnobError`` at that read.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

# request fields of the serving front door, validated as the JAX package
# validates them (the front door itself is not ported)
PRIORITY_CLASSES = ("interactive", "batch")
DEFAULT_PRIORITY = "interactive"
DEFAULT_TENANT = "default"
CACHE_MODES = ("use", "bypass", "near")

# fallbacks of the config settings ``worker_probe_concurrency`` and
# ``worker_prep_concurrency`` (the config's defaults hold the same values)
WORKER_PROBE_CONCURRENCY = 10
WORKER_PREP_CONCURRENCY = 4


class KnobError(ValueError):
    """A ``CDT_*`` variable holds a value that does not parse."""


def _bool(raw: str) -> bool:
    low = raw.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"expected one of {_TRUE + _FALSE}")


def _read(name: str, default: T, parse: Callable[[str], T],
          lenient: bool = False) -> T:
    """``lenient``: a value that does not parse reads as the default (the
    JAX package's ``on_garbage="default"`` knobs)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return parse(raw.strip())
    except ValueError as e:
        if lenient:
            return default
        raise KnobError(f"{name}={raw!r} does not parse: {e}") from None


# --- identity and paths --------------------------------------------------------


def auth_token() -> Optional[str]:
    """The cluster's shared secret (``utils/auth.py``); it wins over the
    config's ``settings.auth_token``."""
    return _read("CDT_AUTH_TOKEN", None, str)


def is_worker() -> bool:
    return _read("CDT_IS_WORKER", False, _bool)


def worker_id() -> str:
    return _read("CDT_WORKER_ID", "", str)


def worker_index() -> int:
    return _read("CDT_WORKER_INDEX", 0, int)


def config_path() -> Optional[str]:
    return _read("CDT_CONFIG_PATH", None, str)


def output_dir() -> str:
    return _read("CDT_OUTPUT_DIR", "output", str)


def input_dir() -> str:
    return _read("CDT_INPUT_DIR", "input", str)


def checkpoint_root() -> Optional[str]:
    """Root of model checkpoints: ``<root>/<name>.safetensors`` (an LDM
    single file, converted on first load) or ``<root>/<name>/`` (a
    converted bundle) for preset ``name``."""
    return _read("CDT_CHECKPOINT_ROOT", None, str)


def upscale_model_dir() -> Optional[str]:
    """Directory of RRDBNet upscaler ``.safetensors`` files (falls back to
    ``CDT_CHECKPOINT_ROOT/upscalers``)."""
    return _read("CDT_UPSCALE_MODEL_DIR", None, str)


def controlnet_dir() -> Optional[str]:
    """Directory of ControlNet ``.safetensors`` files (falls back to
    ``CDT_CHECKPOINT_ROOT/controlnet``)."""
    return _read("CDT_CONTROLNET_DIR", None, str)


def lora_dir() -> Optional[str]:
    """Directory of kohya LoRA ``.safetensors`` files (falls back to
    ``CDT_CHECKPOINT_ROOT/loras``)."""
    return _read("CDT_LORA_DIR", None, str)


def tokenizer_dir() -> Optional[str]:
    """CLIP BPE vocabulary directory (``vocab.json`` + ``merges.txt``)."""
    return _read("CDT_TOKENIZER_DIR", None, str)


def t5_tokenizer_dir() -> Optional[str]:
    """T5 tokenizer directory (its ``tokenizer.json``; FLUX's text stack)."""
    return _read("CDT_T5_TOKENIZER_DIR", None, str)


def tile_journal_dir() -> str:
    """Crash-resume journal of completed tile tasks ("" = off)."""
    return _read("CDT_TILE_JOURNAL_DIR", "", str)


# --- payload caps --------------------------------------------------------------


def max_payload_size() -> int:
    """Largest request body the server reads (bytes)."""
    return _read("CDT_MAX_PAYLOAD_SIZE", 50 * 1024 * 1024, int)


def max_frame_raw_bytes() -> int:
    """Bound on the decoded size of one CDTF frame (bytes)."""
    return _read("CDT_MAX_FRAME_RAW_BYTES", 1 << 30, int)


def max_audio_payload_bytes() -> int:
    """Cap on an audio envelope's float32 waveform (bytes)."""
    return _read("CDT_MAX_AUDIO_PAYLOAD_BYTES", 256 * 1024 * 1024, int)


# --- orchestration concurrency and timeouts ------------------------------------


def probe_timeout() -> float:
    return _read("CDT_PROBE_TIMEOUT", 5.0, float)


def dispatch_timeout() -> float:
    return _read("CDT_DISPATCH_TIMEOUT", 30.0, float)


def media_sync_concurrency() -> int:
    """Concurrent media-sync transfers to one host (fallback of the
    config's ``settings.media_sync_concurrency``)."""
    return _read("CDT_MEDIA_SYNC_CONCURRENCY", 4, int)


def media_sync_timeout() -> float:
    """Timeout of one media-sync call, seconds (fallback of
    ``settings.media_sync_timeout_seconds``)."""
    return _read("CDT_MEDIA_SYNC_TIMEOUT", 120.0, float)


def heartbeat_timeout() -> float:
    return _read("CDT_HEARTBEAT_TIMEOUT", 60.0, float)


def heartbeat_interval() -> float:
    """How often the tile master checks its workers' heartbeats, and the
    ping interval of a worker's dispatch WebSocket."""
    return _read("CDT_HEARTBEAT_INTERVAL", 10.0, float)


def max_batch() -> int:
    """Result items per flush from a worker host."""
    return _read("CDT_MAX_BATCH", 20, int)


def work_request_budget() -> float:
    """Wall-clock window of a worker's 404-tolerant work-request loop."""
    return _read("CDT_WORK_REQUEST_BUDGET", 30.0, float)


def collect_poll_timeout() -> float:
    return _read("CDT_COLLECT_POLL_TIMEOUT", 5.0, float)


def collect_grace_s() -> float:
    """Deadline extension per round for a silent but busy worker."""
    return _read("CDT_COLLECT_GRACE_S", 30.0, float)


def collect_max_grace_rounds() -> int:
    return _read("CDT_COLLECT_MAX_GRACE_ROUNDS", 20, int)


def job_init_grace() -> float:
    """How long a result may wait for its collector job to exist."""
    return _read("CDT_JOB_INIT_GRACE", 10.0, float)


# --- retries (exponential backoff with full jitter) ----------------------------


def send_max_retries() -> int:
    return _read("CDT_SEND_MAX_RETRIES", 5, int)


def dispatch_max_retries() -> int:
    return _read("CDT_DISPATCH_MAX_RETRIES", 3, int)


def send_backoff_base() -> float:
    return _read("CDT_SEND_BACKOFF_BASE", 0.5, float)


def retry_cap_s() -> float:
    return _read("CDT_RETRY_CAP_S", 5.0, float)


# --- resilience ----------------------------------------------------------------


def breaker_fail_threshold() -> int:
    """Consecutive failures that open a worker's circuit breaker."""
    return _read("CDT_BREAKER_FAIL_THRESHOLD", 3, int)


def breaker_recovery_s() -> float:
    """Seconds an open breaker waits before one half-open trial."""
    return _read("CDT_BREAKER_RECOVERY_S", 30.0, float)


def faults() -> str:
    """A seeded fault plan for the control plane's outbound calls
    (``cluster/faults.py`` grammar; "" = off)."""
    return _read("CDT_FAULTS", "", str)


def max_tile_requeues() -> int:
    """Requeues of one tile task before it dead-letters."""
    return _read("CDT_MAX_TILE_REQUEUES", 3, int)


# --- tiles ---------------------------------------------------------------------


def tiles_per_device() -> int:
    """Tiles per dispatch of the tile engine (0 = computed)."""
    return _read("CDT_TILES_PER_DEVICE", 0, int, lenient=True)


def tile_master_holdback_s() -> float:
    """Seconds the tile master leaves the queue to workers before it
    competes for tasks itself (0 = off)."""
    return _read("CDT_TILE_MASTER_HOLDBACK_S", 0.0, float)


def tile_ready_polls() -> int:
    """Polls (one a second) while a worker waits for a tile job."""
    return _read("CDT_TILE_READY_POLLS", 120, int, lenient=True)
