"""The conditioning cache: a text encode once per distinct prompt (the
port's ``cluster/cache/conditioning.py``, after the JAX package's).

Text encoding is pure and deterministic, and the request stream repeats
itself: the same negative prompt rides almost every request, popular
prompts recur. This memoises the ``encode(texts) -> (context, pooled)``
surface of every text stack of the package (``models/text.TextEncoder``,
``models/clip.CLIPConditioner``, the T5 stacks of ``models/t5.py``).

Keys are content-addressed and tokenization-aware
(:func:`..cache.keys.conditioning_key`):

- **encoder identity** is the registry's stamp (``_cdt_encoder_id``:
  preset, stack, weights' provenance), joined here by the device the
  encoder runs on (a random init draws other numbers on the card than
  on the CPU). An encoder without a stamp is never cached.
- **token signature** is the encoder's own token ids (its
  ``token_signature(texts)`` hook).
- **mode** is real or hash tokenization per tower. Entries computed
  under a degraded (``hash``) mode stay in memory, never in the shared
  persisted tier.

A hit comes back as tensors on the encoder's device in the dtypes the
encode produced, bitwise equal to a fresh encode.

The fill is single-flight per key (:class:`SingleFlight`, a departure
from the JAX package, whose fill has none): when several threads (the
stage pools' encode workers) miss one key at once, the first encodes and
the others wait for it and take its bits, so a shared negative prompt is
encoded once, not once a thread. Results are the same; only duplicate
work goes.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Optional

import torch
from torch import nn

from ...utils.logging import debug_log
from . import keys as _keys

# the mode component of a degraded (vocabulary-less) tower; "hash-native"
# (models/text.py: hash tokens by design) is not degraded
DEGRADED_COMPONENT = "hash"


def encoder_identity(encoder) -> Optional[str]:
    """The registry-stamped identity, or None (do not cache)."""
    ident = getattr(encoder, "_cdt_encoder_id", None)
    return ident if isinstance(ident, str) and ident else None


def token_signature(encoder, texts) -> "tuple[list, str]":
    """(token signature, tokenization mode) of ``texts``: the encoder's
    own ``token_signature`` hook, else the strings under mode ``text``."""
    hook = getattr(encoder, "token_signature", None)
    if hook is not None:
        return hook(texts)
    return [str(t) for t in texts], "text"


def encoder_mode(encoder) -> str:
    """The tokenization mode for the result-cache key: an image from
    hash-tokenized conditioning is never served to a healthy host."""
    mode = getattr(encoder, "tokenization_mode", None)
    if isinstance(mode, str):
        return mode
    mode = getattr(encoder, "_tokenize_mode", None)
    return mode if isinstance(mode, str) else "unknown"


def degraded(mode: str) -> bool:
    """True when any tower of a composite mode ("l=bpe,g=hash") fell back
    to hash tokenization."""
    return DEGRADED_COMPONENT in re.split(r"[,=/]", mode)


def encoder_device(encoder) -> Optional[torch.device]:
    """The device an encoder computes on, or None when it cannot say."""
    for obj in (encoder, getattr(encoder, "stack", None),
                getattr(encoder, "module", None)):
        dev = getattr(obj, "device", None)
        if isinstance(dev, torch.device):
            return dev
        if isinstance(obj, nn.Module):
            p = next(obj.parameters(), None)
            if p is not None:
                return p.device
    return None


def _device_tag(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


class SingleFlight:
    """One computation per key at a time: the first caller of a key
    leads, the others wait in :meth:`flight` until it is done and then
    read what it stored (if the leader failed, each computes its own)."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._leading: set[str] = set()
        self._waiting = 0

    @contextlib.contextmanager
    def flight(self, key: str):
        with self._cond:
            leader = key not in self._leading
            if leader:
                self._leading.add(key)
            else:
                self._waiting += 1
                self._cond.notify_all()
                self._cond.wait_for(lambda: key not in self._leading)
                self._waiting -= 1
        if not leader:
            yield
            return
        try:
            yield
        finally:
            with self._cond:
                self._leading.discard(key)
                self._cond.notify_all()

    def wait_for_waiters(self, n: int, timeout: Optional[float] = None
                         ) -> bool:
        """Block until ``n`` callers wait behind a leader (for an
        observer that must know a flight was joined); False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self._waiting >= n, timeout)


def cached_encode(manager, encoder, texts):
    """``encoder.encode(texts)`` through the conditioning tier; a plain
    encode without a manager, for an unstamped encoder, or one whose
    device is unknown. Concurrent misses of one key encode once."""
    texts = [str(t) for t in texts]
    ident = None if manager is None else encoder_identity(encoder)
    device = None if ident is None else encoder_device(encoder)
    if device is None:
        return encoder.encode(texts)
    sig, mode = token_signature(encoder, texts)
    key = _keys.conditioning_key(f"{ident}@{_device_tag(device)}", sig, mode)
    flights = getattr(manager, "conditioning_flights", None)
    with (flights.flight(key) if flights is not None
          else contextlib.nullcontext()):
        return _encode_through(manager, encoder, texts, key, mode, device)


def _encode_through(manager, encoder, texts, key: str, mode: str,
                    device: torch.device):
    hit = manager.conditioning.get(key)
    if hit is not None and "context" in hit and "pooled" in hit:
        return (hit["context"].to(device, copy=True),
                hit["pooled"].to(device, copy=True))
    context, pooled = encoder.encode(texts)
    try:
        manager.conditioning.put(key, {"context": context, "pooled": pooled},
                                 persist=not degraded(mode))
    except Exception as e:  # noqa: BLE001 — a failed fill never sinks the
        # request that just computed a good conditioning
        debug_log(f"conditioning cache: fill failed for {key[:12]}: {e}")
    return context, pooled
