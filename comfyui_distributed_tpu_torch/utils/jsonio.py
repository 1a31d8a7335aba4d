"""Atomic JSON persistence (the port's copy of the JAX package's
``utils/jsonio.py``): the content cache's tier indexes
(``cluster/cache/store.py``) are read, merged and written by more than
one process.

- **Reads never crash**: a missing, unreadable or garbled file reads as
  "no data".
- **Writes are atomic**: the payload lands in a sibling ``.tmp`` file
  and is ``os.replace``d into place, so a reader never sees half a file.
- **Savers merge first**: callers re-read the file before writing, so
  concurrent writers union rather than clobber.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

from .logging import debug_log


def read_json(path: "Path | str") -> Optional[Any]:
    """Parsed JSON content of ``path``, or None when the file is missing,
    unreadable or not valid JSON (never raises)."""
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError, AttributeError):
        return None


def atomic_write_json(path: "Path | str", payload: Any,
                      indent: int = 1) -> bool:
    """Serialise ``payload`` and atomically replace ``path`` with it
    (tmp + rename; parent directories are created). Returns False, never
    raises, when the write fails."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp.write_text(json.dumps(payload, indent=indent))
        os.replace(tmp, path)
        return True
    except (OSError, TypeError, ValueError) as e:
        debug_log(f"jsonio: atomic write to {path} failed: {e}")
        return False
