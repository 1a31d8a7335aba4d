"""Cross-controller collector transport (the JAX package's
``cluster/collector_bridge.py``).

- worker: one multipart POST of CDTF frames (``utils/frames.py``) to the
  master's ``/distributed/job_complete_frames``, its AUDIO envelope
  (``utils/audio_payload.py``) in the metadata; if the master refuses
  it, one base64-PNG envelope per image to ``/distributed/job_complete``,
  each retried with backoff, the audio on the last. A worker with no
  image (``DistributedEmptyImage`` feeding the collector) sends one
  envelope with ``batch_idx`` -1 that carries its audio;
- master: drain the job's queue until every expected worker's
  ``is_last`` envelope is consumed, giving a silent worker more time
  while its health probe says it is busy, then join the batches master
  first, workers in enabled order, each worker's in batch order, and the
  clips along their samples in the same order, cut to the fewest
  channels.

Node code calls ``send`` and ``collect`` from the execution thread; they
run their coroutines on the controller's loop.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..utils import constants
from ..utils.async_helpers import run_in_loop
from ..utils.audio_payload import decode_audio, encode_audio
from ..utils.exceptions import WorkerError
from ..utils.frames import pack_frame
from ..utils.image import decode_image_b64, encode_image_b64, from_uint8, to_uint8
from ..utils.logging import log
from ..utils.multipart import Part, build_multipart
from ..utils.network import http_request_async, normalize_host_url, probe_host
from .job_store import JobStore
from .resilience import send_policy


class CollectorBridge:
    """Bound to a controller's job store and event loop.

    ``host_resolver`` maps a worker id to its config host dict (or None);
    with it, the master probes silent workers when its deadline passes
    and extends the deadline while they are verifiably busy."""

    def __init__(self, store: JobStore, loop: asyncio.AbstractEventLoop,
                 host_resolver=None):
        self.store = store
        self.loop = loop
        self.host_resolver = host_resolver

    # --- worker role -------------------------------------------------------

    def send(self, job_id: str, worker_id: str, images, audio,
             master_url: str) -> None:
        run_in_loop(
            self.send_async(job_id, worker_id, images, audio, master_url),
            self.loop, timeout=constants.dispatch_timeout() * 4)

    async def send_async(self, job_id: str, worker_id: str, images, audio,
                         master_url: str) -> None:
        loop = asyncio.get_running_loop()
        arr = (await loop.run_in_executor(None, to_uint8, images)
               if images is not None else np.zeros((0, 1, 1, 3), np.uint8))
        audio_env = (await loop.run_in_executor(None, encode_audio, audio)
                     if audio is not None else None)
        n = arr.shape[0]
        base = normalize_host_url(master_url)
        if n and await self._send_frames(base, job_id, worker_id, arr,
                                         audio_env):
            return
        url = base + "/distributed/job_complete"
        for i in range(n):
            image_b64 = await loop.run_in_executor(None, encode_image_b64, arr[i])
            envelope = {
                "job_id": job_id, "worker_id": worker_id, "batch_idx": i,
                "image": image_b64, "is_last": i == n - 1,
            }
            if i == n - 1 and audio_env is not None:
                envelope["audio"] = audio_env
            await self._post_with_retry(url, envelope)
        if n == 0:
            # a worker with no image still completes its share, and its
            # clip rides on the completion envelope
            envelope = {"job_id": job_id, "worker_id": worker_id,
                        "batch_idx": -1, "image": "", "is_last": True}
            if audio_env is not None:
                envelope["audio"] = audio_env
            await self._post_with_retry(url, envelope)

    async def _send_frames(self, base_url: str, job_id: str, worker_id: str,
                           arr: np.ndarray, audio_env: dict | None) -> bool:
        """One multipart POST of crc-checked frames. False when the master
        refused it: the caller falls back to the envelopes, which retry."""
        meta = {"job_id": job_id, "worker_id": worker_id,
                "count": int(arr.shape[0])}
        if audio_env is not None:
            meta["audio"] = audio_env

        def encode() -> tuple[bytes, str]:
            # zlib and crc of multi-MB frames stay off the event loop
            parts = [Part("metadata", json.dumps(meta).encode(),
                          content_type="application/json")]
            parts += [Part(f"frame_{i}", pack_frame(arr[i], level=1),
                           f"frame_{i}.cdtf", "application/x-cdt-frame")
                      for i in range(arr.shape[0])]
            return build_multipart(parts)

        body, ctype = await asyncio.get_running_loop().run_in_executor(None, encode)
        try:
            status, answer = await http_request_async(
                base_url + "/distributed/job_complete_frames", body,
                {"Content-Type": ctype, "X-CDT-Client": "1"})
        except OSError as e:
            log(f"collector[{job_id}] frame send failed ({e}); using envelopes")
            return False
        if status < 400:
            return True
        log(f"collector[{job_id}] frame send {status} "
            f"({answer[:200]!r}); using envelopes")
        return False

    async def _post_with_retry(self, url: str, payload: dict) -> None:
        """Bounded retries: the master keys envelopes by (worker_id,
        batch_idx) and a repeated ``is_last`` changes nothing, so a
        re-send is safe."""
        # an envelope with a clip is tens of MB of JSON: off the loop
        body = await asyncio.get_running_loop().run_in_executor(
            None, lambda: json.dumps(payload).encode())

        async def attempt() -> None:
            status, answer = await http_request_async(
                url, body, {"Content-Type": "application/json"})
            if status >= 400:
                raise WorkerError(f"{status}: {answer[:200]!r}")

        try:
            await send_policy().run(
                attempt, op="collect",
                retryable=lambda e: isinstance(e, Exception))
        except (OSError, WorkerError) as e:
            raise WorkerError(f"send to {url} failed after retries: {e}") from e

    # --- master role -------------------------------------------------------

    def collect(self, job_id: str, local_images, local_audio=None,
                enabled_worker_ids: Sequence[str] = (),
                delegate_only: bool = False, timeout: float | None = None):
        """The joined ``(images, audio)``."""
        return run_in_loop(
            self.collect_async(job_id, local_images, local_audio,
                               enabled_worker_ids, delegate_only, timeout),
            self.loop, timeout=None)

    async def collect_async(self, job_id: str, local_images, local_audio=None,
                            enabled_worker_ids: Sequence[str] = (),
                            delegate_only: bool = False,
                            timeout: float | None = None):
        job = await self.store.prepare_collector_job(
            job_id, tuple(enabled_worker_ids))
        deadline = time.monotonic() + (timeout or constants.heartbeat_timeout() * 4)
        per_worker: dict[str, dict[int, np.ndarray]] = {
            w: {} for w in job.expected_workers}
        audio_parts: dict[str, dict] = {}
        # completion is judged on envelopes consumed here, never on
        # arrival flags, so nothing is left in the queue
        drained_done: set[str] = set()
        grace_rounds = 0
        loop = asyncio.get_running_loop()

        while not drained_done >= set(job.expected_workers):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                missing = [w for w in job.expected_workers if w not in drained_done]
                busy = await self._probe_busy(missing)
                if busy and grace_rounds < constants.collect_max_grace_rounds():
                    grace_rounds += 1
                    deadline = time.monotonic() + constants.collect_grace_s()
                    log(f"collector[{job_id}] workers {busy} still busy; "
                        f"extending deadline (grace {grace_rounds})")
                    continue
                log(f"collector[{job_id}] timed out waiting for {missing}")
                break
            try:
                envelope = await asyncio.wait_for(
                    job.results.get(),
                    timeout=min(constants.collect_poll_timeout(), remaining))
            except asyncio.TimeoutError:
                continue
            w = envelope.get("worker_id", "")
            idx = int(envelope.get("batch_idx", 0))
            if envelope.get("image_arr") is not None:
                per_worker.setdefault(w, {})[idx] = from_uint8(envelope["image_arr"])
            elif envelope.get("image"):
                per_worker.setdefault(w, {})[idx] = await loop.run_in_executor(
                    None, decode_image_b64, envelope["image"])
            if envelope.get("audio"):
                audio_parts[w] = await loop.run_in_executor(
                    None, decode_audio, envelope["audio"])
            if envelope.get("is_last"):
                drained_done.add(w)

        images = self._combine_images(local_images, per_worker,
                                      job.expected_workers, delegate_only)
        audio = self._combine_audio(local_audio, audio_parts,
                                    job.expected_workers)
        await self.store.cleanup_job(job_id)
        return images, audio

    async def _probe_busy(self, missing: Sequence[str]) -> list[str]:
        """Silent workers with work still queued or running. A dead host
        (no answer) or an idle one gets no grace."""
        if self.host_resolver is None or not missing:
            return []
        resolvable = [(w, self.host_resolver(w)) for w in missing]
        resolvable = [(w, h) for w, h in resolvable if h]
        statuses = await asyncio.gather(*(probe_host(h) for _, h in resolvable))
        return [
            w for (w, _), status in zip(resolvable, statuses)
            if status and int(status.get("queue_remaining", 0) or 0) > 0
        ]

    @staticmethod
    def _combine_images(local_images, per_worker: dict[str, dict[int, Any]],
                        expected: Sequence[str], delegate_only: bool):
        """Master first, then workers in ``expected`` order, batch order
        within each; a delegate-only master contributes nothing. Batches
        whose height and width differ from the first are dropped. Returns
        float32 on the master's device (that of ``local_images``)."""
        device = (local_images.device if isinstance(local_images, torch.Tensor)
                  else torch.device("cpu"))
        batches: list[torch.Tensor] = []
        if local_images is not None and not delegate_only:
            local = torch.as_tensor(local_images).float()
            if local.numel():
                batches.append(local)
        for w in expected:
            imgs = per_worker.get(w, {})
            for idx in sorted(imgs):
                batches.append(torch.as_tensor(
                    np.asarray(imgs[idx], np.float32))[None].to(device))
        if not batches:
            return local_images
        hw = batches[0].shape[1:3]
        kept = [b for b in batches if b.shape[1:3] == hw]
        if len(kept) != len(batches):
            log(f"collector: dropping {len(batches) - len(kept)} mismatched-size results")
        return torch.cat(kept, dim=0)

    @staticmethod
    def _combine_audio(local_audio, audio_parts: dict[str, dict],
                       expected: Sequence[str]):
        """The master's clip, then each worker's in ``expected`` order,
        joined along the samples and cut to the fewest channels (a
        delegate-only master's clip counts too, as in the JAX package).
        CPU tensors; None when nobody sent audio."""
        parts = [local_audio] if local_audio is not None else []
        parts += [audio_parts[w] for w in expected if w in audio_parts]
        if not parts:
            return None
        wfs = [torch.as_tensor(p["waveform"]).float().cpu() for p in parts]
        ch = min(w.shape[1] for w in wfs)
        return {"waveform": torch.cat([w[:, :ch] for w in wfs], dim=-1),
                "sample_rate": parts[0]["sample_rate"]}
