"""Media references of a prompt (``find_media_refs`` of the JAX
package's ``cluster/media_sync.py``). Syncing the files to a remote host
is not ported: the orchestrator reports a remote host whose prompt
references media as a failed dispatch."""

from __future__ import annotations

import dataclasses
from typing import Any

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
