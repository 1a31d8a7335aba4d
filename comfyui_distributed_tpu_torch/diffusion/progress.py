"""In-flight sampling progress: per-step x0 previews out of the sampling
loop (the port's counterpart of the JAX package's ``diffusion/progress.py``).

``wrap_denoiser`` interposes on the (guided) denoiser: after every model
call it queues the step's ``sigma`` and the x0 estimate's first batch
element for the host as a :class:`StepEvent`, and hands the event to
every registered sink. The JAX package emits a ``jax.debug.callback``
there, an asynchronous host effect the TPU never waits on. The port
keeps that on the card: the event copies into pinned host buffers with
``non_blocking=True`` and records a ``torch.cuda.Event`` behind the
copies, so the sampling thread neither synchronises with the card nor
reads a device value per step. A consumer reads an event only once
:meth:`StepEvent.ready` says the copies landed, or after
:meth:`StepEvent.wait` at the end of the run. On the CPU the copies are
clones and an event is ready at once.

``sigma`` (strictly decreasing over the ladder) is the ordering key a
sink uses to keep the newest preview. Tokens come from one
process-global counter, so every sink can receive every event and keep
only its own jobs' (``cluster/progress.ProgressTracker``).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable

import numpy as np
import torch

from ..utils.logging import log

# sink(event: StepEvent); removal by handle
_LOCK = threading.Lock()
_SINKS: dict[int, Callable] = {}
_HANDLES = itertools.count(1)
_TOKENS = itertools.count(1)


def next_token() -> int:
    """A process-globally unique progress token."""
    with _LOCK:
        return next(_TOKENS)


def add_sink(fn: Callable) -> int:
    """Register an event sink; returns a handle for ``remove_sink``."""
    with _LOCK:
        handle = next(_HANDLES)
        _SINKS[handle] = fn
        return handle


def remove_sink(handle: int) -> None:
    with _LOCK:
        _SINKS.pop(handle, None)


class StepEvent:
    """One model call's ``sigma`` and ``x0[:1]`` on their way to the host."""

    __slots__ = ("token", "shard", "_sigma", "_x0", "_copied")

    def __init__(self, token: int, shard: int, sigma, x0: torch.Tensor):
        self.token, self.shard = int(token), int(shard)
        sigma = torch.as_tensor(sigma).detach()
        x0 = x0[:1].detach()
        if x0.is_cuda:
            self._sigma = torch.empty(sigma.shape, dtype=sigma.dtype,
                                      pin_memory=True)
            self._x0 = torch.empty(x0.shape, dtype=x0.dtype, pin_memory=True)
            self._sigma.copy_(sigma, non_blocking=True)
            self._x0.copy_(x0, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(x0.device))
        else:
            self._sigma, self._x0 = sigma.clone(), x0.clone()
            self._copied = None

    def ready(self) -> bool:
        """True once the host copies have landed (never blocks)."""
        return self._copied is None or self._copied.query()

    def wait(self) -> None:
        if self._copied is not None:
            self._copied.synchronize()

    @property
    def sigma(self) -> float:
        """Read only once ``ready()``."""
        return float(self._sigma)

    @property
    def x0(self) -> np.ndarray:
        """``x0[:1]`` as float32 numpy; read only once ``ready()``."""
        return self._x0.float().numpy()


def _dispatch(event: StepEvent) -> None:
    with _LOCK:
        sinks = list(_SINKS.values())
    for sink in sinks:
        try:
            sink(event)
        except Exception as e:  # noqa: BLE001 — a broken consumer must not kill a job
            log(f"progress sink failed: {e!r}")


# model calls the wrapped (guided) denoiser makes per sampler step: CFG is
# one doubled-batch call. Second-order samplers call twice per step except
# on their last (sigma_next = 0 takes one euler call), so their exact
# total is 2·steps − 1.
_SECOND_ORDER = {"heun", "dpmpp_sde", "res_2s", "res_2s_ancestral"}


def total_calls(sampler: str, steps: int) -> int:
    if sampler in _SECOND_ORDER:
        return max(1, 2 * steps - 1)
    return steps


def wrap_denoiser(denoise, token: int, shard_index: int = 0):
    """Interpose on a denoiser: after every model call, queue the current
    x0 estimate (first batch element) and sigma for the sinks. The x0 the
    sampler receives is the one the denoiser returned, untouched."""

    def wrapped(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        x0 = denoise(x, sigma)
        if _SINKS:
            _dispatch(StepEvent(token, shard_index, sigma, x0))
        return x0

    return wrapped
