"""Host-side sampling-progress tracker: step counts and live latent
previews (the port's copy of the JAX package's ``cluster/progress.py``).

Takes the ``StepEvent``s that ``diffusion/progress.wrap_denoiser`` queues
and serves them to the control plane (``/distributed/progress/{id}``,
``/distributed/preview/{id}``). An event is counted once its host copies
have landed: every read of the tracker first takes the events that are
ready, without waiting, and ``complete`` waits for the rest once, at the
end of a run. ``sigma``, strictly decreasing over the ladder, orders the
previews; the step count is the number of events from shard 0. Previews
are kept per shard; a video latent's preview is a strip of up to four of
its frames, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..diffusion import progress as _events
from ..diffusion.progress import StepEvent
from ..utils.image import encode_png

# Approximate linear latent→RGB map for previews of 4-channel latents
# (rows = latent channels, cols = RGB): the community-standard preview
# approximation, recognisable rather than exact.
_RGB_4CH = np.array(
    [[0.298, 0.207, 0.208],
     [0.187, 0.286, 0.173],
     [-0.158, 0.189, 0.264],
     [-0.184, -0.271, -0.473]], dtype=np.float32)


def latent_to_rgb(latent: np.ndarray) -> np.ndarray:
    """[H,W,C] latent → [H,W,3] float image in [0,1] (preview quality).

    4-channel latents go through the linear approximation; any other
    (16-channel FLUX) takes the first three channels; a video latent
    [F,H,W,C] its middle frame. Mean/std normalised, so previews stay
    visible at any sigma."""
    lat = np.asarray(latent, dtype=np.float32)
    if lat.ndim == 4:
        lat = lat[lat.shape[0] // 2]
    if lat.shape[-1] == _RGB_4CH.shape[0]:
        rgb = lat @ _RGB_4CH
    else:
        rgb = lat[..., :3]
    std = float(rgb.std()) or 1.0
    rgb = (rgb - float(rgb.mean())) / (3.0 * std) + 0.5
    return np.clip(rgb, 0.0, 1.0)


class _Job:
    __slots__ = ("prompt_id", "total", "calls_seen", "previews",
                 "preview_sigmas", "pending", "started", "updated", "done",
                 "failed")

    def __init__(self, prompt_id: str, total: int):
        self.prompt_id = prompt_id
        self.total = max(1, int(total))
        self.calls_seen = 0
        self.previews: dict[int, np.ndarray] = {}
        self.preview_sigmas: dict[int, float] = {}
        self.pending: list[StepEvent] = []
        self.started = time.time()
        self.updated = self.started
        self.done = False
        self.failed = False


class ProgressTracker:
    """Registry of in-flight sampling runs, keyed by token (handed to the
    pipeline) and by prompt id (the control plane's handle)."""

    def __init__(self, keep: int = 16):
        self._keep = keep
        self._jobs: OrderedDict[int, _Job] = OrderedDict()
        self._by_prompt: dict[str, int] = {}
        self._lock = threading.Lock()
        self._sink_handle = _events.add_sink(self._on_event)

    def close(self) -> None:
        """Detach this tracker's sink from the event registry."""
        _events.remove_sink(self._sink_handle)

    # --- producer side (node layer) -----------------------------------------

    def start(self, prompt_id: str, total_calls: int) -> int:
        """Allocate a token for a run about to execute."""
        token = _events.next_token()
        with self._lock:
            self._jobs[token] = _Job(prompt_id, total_calls)
            self._by_prompt[prompt_id] = token
            while len(self._jobs) > self._keep:
                old_token, old = self._jobs.popitem(last=False)
                # one prompt may run several sampler nodes: drop the
                # mapping only if it still points at the evicted token
                if self._by_prompt.get(old.prompt_id) == old_token:
                    self._by_prompt.pop(old.prompt_id, None)
        return token

    def complete(self, token: int) -> None:
        """Wait for a run's queued events and count them: once, at its
        end (where the JAX package drains its callbacks with
        ``jax.effects_barrier``)."""
        with self._lock:
            job = self._jobs.get(token)
            if job is not None:
                self._take_ready(job, wait=True)

    def finish(self, prompt_id: str, failed: bool = False) -> None:
        """Mark a run finished. ``failed=True`` freezes progress where it
        stopped instead of reporting 100%."""
        with self._lock:
            token = self._by_prompt.get(prompt_id)
            job = self._jobs.get(token) if token is not None else None
            if job is not None:
                job.done = True
                job.failed = failed
                job.pending = []
                if not failed:
                    job.calls_seen = job.total
                job.updated = time.time()

    # --- event sink (the sampling thread) -----------------------------------

    def _on_event(self, event: StepEvent) -> None:
        with self._lock:
            job = self._jobs.get(event.token)
            if job is None or job.done:
                return
            job.pending.append(event)
            self._take_ready(job)

    def _take_ready(self, job: _Job, wait: bool = False) -> None:
        """Count the job's events whose copies have landed, in order (a
        stream completes them in order); ``wait``: all of them."""
        while job.pending:
            event = job.pending[0]
            if wait:
                event.wait()
            elif not event.ready():
                return
            job.pending.pop(0)
            job.updated = time.time()
            if event.shard == 0:
                job.calls_seen += 1
            sigma = event.sigma
            prev = job.preview_sigmas.get(event.shard)
            if prev is None or sigma <= prev:
                x0 = event.x0
                job.preview_sigmas[event.shard] = sigma
                job.previews[event.shard] = x0[0] if x0.ndim >= 4 else x0

    # --- consumer side (routes) ---------------------------------------------

    def _job_for(self, prompt_id: str) -> Optional[_Job]:
        token = self._by_prompt.get(prompt_id)
        job = self._jobs.get(token) if token is not None else None
        if job is not None:
            self._take_ready(job)
        return job

    def snapshot(self, prompt_id: str) -> Optional[dict]:
        with self._lock:
            job = self._job_for(prompt_id)
            if job is None:
                return None
            frac = min(1.0, job.calls_seen / job.total)
            return {
                "prompt_id": prompt_id,
                "step": job.calls_seen,
                "total": job.total,
                "fraction": round(frac, 4),
                "done": job.done,
                "failed": job.failed,
                "shards_reporting": len(job.previews),
                "updated_s_ago": round(time.time() - job.updated, 2),
            }

    def preview_png(self, prompt_id: str, shard: int = 0) -> Optional[bytes]:
        """The latest preview of one shard as PNG, or None before its
        first step. A video latent [F,h,w,c] renders as a horizontal strip
        of up to four evenly spaced frames, tiled as a latent and then
        normalised once (per-frame normalisation would flatten the clip's
        changes of brightness and leave seams between the frames)."""
        with self._lock:
            job = self._job_for(prompt_id)
            lat = None if job is None else job.previews.get(shard)
            if lat is None:
                return None
            lat = np.array(lat)
        if lat.ndim == 4 and lat.shape[0] > 1:
            idxs = np.unique(np.linspace(0, lat.shape[0] - 1,
                                         min(4, lat.shape[0])).astype(int))
            lat = np.concatenate([lat[i] for i in idxs], axis=1)
        return encode_png(latent_to_rgb(lat))
