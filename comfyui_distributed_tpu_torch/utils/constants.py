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


def _read(name: str, default: T, parse: Callable[[str], T]) -> T:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return parse(raw.strip())
    except ValueError as e:
        raise KnobError(f"{name}={raw!r} does not parse: {e}") from None


# --- identity and paths --------------------------------------------------------


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


# --- payload caps --------------------------------------------------------------


def max_payload_size() -> int:
    """Largest request body the server reads (bytes)."""
    return _read("CDT_MAX_PAYLOAD_SIZE", 50 * 1024 * 1024, int)


def max_frame_raw_bytes() -> int:
    """Bound on the decoded size of one CDTF frame (bytes)."""
    return _read("CDT_MAX_FRAME_RAW_BYTES", 1 << 30, int)


# --- orchestration concurrency and timeouts ------------------------------------


def probe_timeout() -> float:
    return _read("CDT_PROBE_TIMEOUT", 5.0, float)


def dispatch_timeout() -> float:
    return _read("CDT_DISPATCH_TIMEOUT", 30.0, float)


def heartbeat_timeout() -> float:
    return _read("CDT_HEARTBEAT_TIMEOUT", 60.0, float)


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
