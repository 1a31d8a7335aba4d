"""Content-addressed cache keys: the same bytes in give the same key out
(the port's copy of the JAX package's ``cluster/cache/keys.py``; every
function but ``execution_signature`` gives JAX's hex digests).

Every tier keys on a SHA-256 digest of a canonical byte encoding of the
inputs that determine the output, and nothing else:

- **conditioning**: (encoder identity, token ids, tokenization mode).
  Keyed on the token ids, not the string, so two prompts that tokenize
  alike share an entry, and a host whose tokenizer fell back to hash
  tokens computes another key than a healthy one.
- **request fingerprint**: the whole canonical prompt graph (prompt
  text, negative prompt, seed, every literal).
- **result**: fingerprint × execution signature × conditioning mode ×
  weights identity. The execution signature is this package's own: the
  backend, torch and CUDA versions, the device and whether TF32 is on.
  A JAX signature never equals it, so a result computed by one package
  is never served by the other.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Iterable


def canonical_bytes(obj: Any) -> bytes:
    """Deterministic byte encoding of a JSON-able structure (sorted keys,
    no whitespace). Other leaves fall back to ``repr``, stable for the
    literal types of prompt graphs."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=repr).encode()


def digest(*parts: "bytes | str") -> str:
    """SHA-256 over length-prefixed parts: ("ab", "c") never collides
    with ("a", "bc")."""
    h = hashlib.sha256()
    for p in parts:
        b = p.encode() if isinstance(p, str) else p
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    return h.hexdigest()


def conditioning_key(encoder_id: str, token_sig: Any, mode: str) -> str:
    return digest("cond", encoder_id, mode, canonical_bytes(token_sig))


def request_fingerprint(prompt: dict) -> str:
    """Identity of one submitted request: the whole (meta-stripped)
    prompt graph. Equal fingerprints asked for byte-identical work."""
    return digest("req", canonical_bytes(prompt))


def execution_signature(device=None) -> str:
    """The facts that change an output without changing the request:
    backend, torch and CUDA versions, the device's name, one device, and
    TF32 (on the card, a controller turns it off, ``utils/device.py``)."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
    else:
        name = "cpu"
    return digest("exec", canonical_bytes({
        "backend": "torch",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": name,
        "devices": 1,
        "tf32": bool(torch.backends.cuda.matmul.allow_tf32
                     or torch.backends.cudnn.allow_tf32),
    }))


def result_key(fingerprint: str, execution_sig: str,
               conditioning_mode: str = "", weights_id: str = "") -> str:
    """The conditioning mode (real or hash tokens) joins the key, so an
    image from degraded conditioning is never served to a healthy host;
    the weights identity (``ModelBundle.weights_identity``), so a
    checkpoint replaced under the same name is not served stale."""
    return digest("result", fingerprint, execution_sig, conditioning_mode,
                  weights_id)


def token_array_signature(ids) -> list:
    """Token-id array → JSON-able nested lists (the canonical form
    ``conditioning_key`` hashes)."""
    import numpy as np

    return np.asarray(ids).tolist()


def checksum(payload: "bytes | Iterable[bytes]") -> str:
    """Integrity checksum of persisted sidecar bytes."""
    h = hashlib.sha256()
    if isinstance(payload, bytes):
        h.update(payload)
    else:
        for chunk in payload:
            h.update(chunk)
    return h.hexdigest()
