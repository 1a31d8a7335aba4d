"""The latent wire format: one denoise→decode handoff (the port's
``cluster/stages/latents.py``, after the JAX package's).

A :class:`LatentHandoff` is what the denoise pool hands the decode pool:
a request's final ``x0`` latent and the meta that ties it to its prompt
(model preset, geometry, seed, fingerprint). Its bytes are the JAX
package's: one ``.npz`` (a JSON header and the latent array) with a
SHA-256 that travels with it, and a loader that refuses whatever it
cannot verify, so a flipped bit is an error and never a wrong image. A
payload written by either package parses in the other.

In process the decode pool takes the denoise pool's tensor where it lies
(on the card); ``CDT_STAGE_WIRE=1`` sends every handoff through the whole
checksummed round trip, and ``POST /distributed/stages/decode`` takes
one from another host. Arrays cross the wire as numpy; an fp32 latent
comes back bitwise.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import io
import json

import numpy as np

LATENT_WIRE_VERSION = 1


def checksum(payload: bytes) -> str:
    """SHA-256 hex digest of a payload (the JAX package's
    ``diffusion/checkpoint.checksum``)."""
    return hashlib.sha256(payload).hexdigest()


class LatentWireError(Exception):
    """A latent handoff payload is unusable (bad version, checksum
    mismatch, garbled npz). The caller re-dispatches or recomputes:
    corruption is loud and never decoded."""


@dataclasses.dataclass
class LatentHandoff:
    """One request's denoise output in flight to a decoder: ``latents``
    ``[B, h, w, C]`` fp32 (the bytes the fused path feeds its VAE) and
    ``meta`` (model preset, geometry, seed, fingerprint), which a
    receiving decoder reads before it trusts the shape."""

    prompt_id: str
    latents: np.ndarray
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = LATENT_WIRE_VERSION

    @property
    def nbytes(self) -> int:
        return int(np.asarray(self.latents).nbytes)

    def bucket_key(self) -> tuple:
        """Decode bucket: latents of one shape and dtype."""
        arr = np.asarray(self.latents)
        return (tuple(arr.shape), str(arr.dtype))

    def to_bytes(self) -> bytes:
        header = {"version": self.version, "prompt_id": self.prompt_id,
                  "meta": self.meta}
        buf = io.BytesIO()
        np.savez(buf, latents=np.asarray(self.latents),
                 header=np.frombuffer(
                     json.dumps(header, sort_keys=True).encode(), np.uint8))
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, payload: bytes) -> "LatentHandoff":
        try:
            with np.load(io.BytesIO(payload)) as z:
                header = json.loads(bytes(z["header"].tobytes()).decode())
                latents = z["latents"]
        except (KeyError, ValueError, OSError, json.JSONDecodeError) as e:
            raise LatentWireError(f"unreadable latent payload: {e}")
        if header.get("version") != LATENT_WIRE_VERSION:
            raise LatentWireError(
                f"latent wire version {header.get('version')!r} != "
                f"{LATENT_WIRE_VERSION} (refusing a cross-version decode)")
        return cls(prompt_id=str(header.get("prompt_id", "")),
                   latents=latents, meta=dict(header.get("meta") or {}))

    def to_payload(self) -> dict:
        """The JSON-safe wire form; the sha256 travels with the bytes."""
        payload = self.to_bytes()
        return {"version": LATENT_WIRE_VERSION, "prompt_id": self.prompt_id,
                "sha256": checksum(payload),
                "data": base64.b64encode(payload).decode("ascii")}

    @classmethod
    def from_payload(cls, obj: dict) -> "LatentHandoff":
        if not isinstance(obj, dict) or "data" not in obj:
            raise LatentWireError("latent payload must be an object with "
                                  "a base64 'data' field")
        try:
            payload = base64.b64decode(obj["data"], validate=True)
        except Exception as e:  # noqa: BLE001 — any b64 failure is terminal
            raise LatentWireError(f"bad base64 latent data: {e}")
        want = obj.get("sha256")
        if not want:
            # an unverifiable payload is an unusable one
            raise LatentWireError(
                "latent payload carries no sha256 — refusing an "
                "unverifiable decode")
        if checksum(payload) != want:
            raise LatentWireError(
                "latent CHECKSUM MISMATCH on the wire — rejecting (a "
                "flipped bit must never decode into an image)")
        return cls.from_bytes(payload)


def encode_array_payload(arr: np.ndarray) -> dict:
    """Checksummed JSON-safe form of one array: the answer of ``POST
    /distributed/stages/decode``, verified by its caller as the decoder
    verified the latent."""
    buf = io.BytesIO()
    np.savez(buf, array=np.asarray(arr))
    payload = buf.getvalue()
    return {"sha256": checksum(payload),
            "data": base64.b64encode(payload).decode("ascii")}


def decode_array_payload(obj: dict) -> np.ndarray:
    if not isinstance(obj, dict) or "data" not in obj:
        raise LatentWireError("array payload must be an object with a "
                              "base64 'data' field")
    try:
        payload = base64.b64decode(obj["data"], validate=True)
    except Exception as e:  # noqa: BLE001 — any b64 failure is terminal
        raise LatentWireError(f"bad base64 array data: {e}")
    want = obj.get("sha256")
    if not want or checksum(payload) != want:
        raise LatentWireError("array payload checksum missing or "
                              "mismatched — rejecting")
    try:
        with np.load(io.BytesIO(payload)) as z:
            return z["array"]
    except (KeyError, ValueError, OSError) as e:
        raise LatentWireError(f"unreadable array payload: {e}")
