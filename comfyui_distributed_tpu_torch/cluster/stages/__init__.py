"""Stage-split serving (the port's ``cluster/stages``, after the JAX
package's).

The fused group path runs a front-door batch job whole on the one graph
thread: prefixes (checkpoint, text encode), the sampler, the VAE decode,
suffixes. Only the sampler needs the card for long; encode and decode
are short and come in bursts, yet they hold the queue's slot. Here a
batch job goes through three pools instead:

- **encode** (N host threads): each member's graph prefix, its text
  encode through the conditioning tier and the result-tier probe (a hit
  is answered here and never reaches the card's queue).
- **denoise** (exactly one thread: it owns the card):
  ``Txt2ImgPipeline.generate_latents``, the group's sampler stopped at
  ``x0``. The prompt queue's slot frees when it is done, so the next
  job's sampler starts while this one decodes.
- **decode** (M host threads): latents of one shape bucket, gathered
  across groups, decoded by ``decode_latents`` one at a time at their
  solo shape, then each member's suffix.

The handoff is a :class:`~.latents.LatentHandoff`. In process the latent
stays the denoise call's tensor on the card; ``CDT_STAGE_WIRE=1`` sends
it through the checksummed wire format. Each boundary splits the fused
path on values it has already computed, so every member's image is
bitwise its fused and its solo run. ``CDT_STAGES=0`` removes the
subsystem and the fused path runs as before. The denoise pool observes
each stacked group's program into the shape catalog, as the fused path
does.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ... import telemetry
from ...telemetry import metrics as _tm
from ...utils import constants
from ...utils.logging import debug_log, log
from .latents import LatentHandoff, LatentWireError
from .pool import StagePool, StageWorkerDeath

__all__ = ["StageManager", "StagePool", "StageWorkerDeath",
           "LatentHandoff", "LatentWireError", "build_stages",
           "stages_enabled"]


def stages_enabled() -> bool:
    return constants.stages()


class _EncodeWork:
    __slots__ = ("ticket", "member", "redispatch", "done")

    def __init__(self, ticket, member):
        self.ticket = ticket
        self.member = member
        self.redispatch = 0
        self.done = False

    def fail(self, manager, status: str, error: str = "") -> None:
        self.done = True
        entry = {"status": status}
        if error:
            entry["error"] = error
        manager._complete(self.ticket, self.member, entry)
        # a failed encode item still counts toward the group's encode
        # barrier, or the denoise stage never dispatches and the queue
        # waits for it forever
        manager._after_encode(self.ticket)


class _DenoiseWork:
    __slots__ = ("ticket", "redispatch", "done")

    def __init__(self, ticket):
        self.ticket = ticket
        self.redispatch = 0
        self.done = False

    def fail(self, manager, status: str, error: str = "") -> None:
        self.done = True
        for p in self.ticket.take_ready():
            entry = {"status": status}
            if error:
                entry["error"] = error
            manager._complete(self.ticket, p.member, entry)
        self.ticket.resolve_denoise()


class _DecodeWork:
    __slots__ = ("ticket", "p", "latents", "arrived", "sampler_batch",
                 "redispatch", "done")

    def __init__(self, ticket, prepared, latents: torch.Tensor,
                 sampler_batch: int):
        self.ticket = ticket
        self.p = prepared
        self.latents = latents       # the denoise call's tensor
        self.arrived = None          # the tensor the decoder reads
        self.sampler_batch = sampler_batch
        self.redispatch = 0
        self.done = False

    def bucket_key(self) -> tuple:
        return (id(self.p.pipeline), tuple(self.latents.shape))

    def handoff(self) -> LatentHandoff:
        p = self.p
        return LatentHandoff(
            prompt_id=p.member.prompt_id,
            latents=self.latents.detach().cpu().numpy(),
            meta={"model": getattr(getattr(p.model, "preset", None),
                                   "name", None),
                  "height": p.spec.height, "width": p.spec.width,
                  "steps": p.spec.steps, "seed": p.seed,
                  "fingerprint": p.member.fingerprint})

    def drop(self) -> None:
        """Let go of the latents once the member is terminal."""
        self.latents = self.arrived = None

    def fail(self, manager, status: str, error: str = "") -> None:
        self.done = True
        self.drop()
        entry = {"status": status}
        if error:
            entry["error"] = error
        manager._complete(self.ticket, self.p.member, entry)


class _GroupTicket:
    """One front-door batch job moving through the stages."""

    def __init__(self, manager, job, members, sampler_node_ids, context,
                 loop, denoise_done, record):
        self.manager = manager
        self.job = job
        self.members = list(members)
        self.sampler_node_ids = dict(sampler_node_ids)
        self.context = context
        self.loop = loop
        self.denoise_done = denoise_done
        self.record = record
        self.pending = len(self.members)
        self.encode_left = len(self.members)
        self.ready: list = []
        self._lock = threading.Lock()
        self._denoise_resolved = False

    def add_ready(self, prepared) -> None:
        with self._lock:
            self.ready.append(prepared)

    def take_ready(self) -> list:
        with self._lock:
            out, self.ready = self.ready, []
        return out

    def member_done(self) -> bool:
        """One member fewer outstanding; True for the last one."""
        with self._lock:
            self.pending -= 1
            return self.pending <= 0

    def encode_done(self) -> "tuple[bool, bool]":
        with self._lock:
            self.encode_left -= 1
            return self.encode_left <= 0, bool(self.ready)

    def resolve_denoise(self) -> None:
        """Free the card: the queue may start its next job while the
        decode pool finishes this one. Idempotent."""
        with self._lock:
            if self._denoise_resolved:
                return
            self._denoise_resolved = True
        self.manager._marshal(self.loop, _resolve, self.denoise_done)


def _resolve(fut) -> None:
    if not fut.done():
        fut.set_result(None)


class StageManager:
    """The three stage pools of one controller.

    Built by the controller unless ``CDT_STAGES=0`` and attached to the
    prompt queue (``queue.stages``), whose consumer routes batch jobs
    here and waits only for the denoise stage before it frees its slot.
    Threads are daemons and start with the first staged group."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.base_encode = max(1, constants.stage_encode_workers())
        self.base_decode = max(1, constants.stage_decode_workers())
        self.encode = StagePool("encode", self.base_encode,
                                self._run_encode, steal=self._pick_steal,
                                redispatch=self._redispatch_encode,
                                clock=clock)
        # exactly one denoise worker: one card, one sampler call at a time
        self.denoise = StagePool("denoise", 1, self._run_denoise,
                                 clock=clock)
        self.decode = StagePool(
            "decode", self.base_decode, self._run_decode,
            # duck-typed, so tests can drive the pool with fake items
            batch_key=lambda item: item.bucket_key(),
            max_batch=constants.stage_decode_batch(),
            window_s=constants.stage_decode_window_ms() / 1000.0,
            steal=self._pick_steal,
            redispatch=self._redispatch_decode, clock=clock)
        # test hook: called with a picked decode batch after its transfer,
        # while the worker holds the latents (may raise StageWorkerDeath)
        self._death_hook: Optional[Callable[[list], None]] = None
        self.counts = {"groups": 0, "members": 0, "cache_hits": 0,
                       "fallbacks": 0, "redispatched": 0}
        self._counts_lock = threading.Lock()

    # --- the runtime's side -------------------------------------------------

    def eligible(self, job) -> bool:
        """Only front-door batch jobs ride the stages: solo prompts keep
        the fused path (progress streaming, ControlNet), and so do
        ``cache: "near"`` members: the near tier's donor and re-roll
        (``cluster/frontdoor/microbatch.py``) run the fused preemptible
        sampler, which has no staged form."""
        group = getattr(job, "group", None)
        if group is None:
            return False
        return not any(getattr(m, "cache_mode", "use") == "near"
                       for m in group)

    def submit_group(self, job, members, sampler_node_ids, context, loop,
                     denoise_done, record) -> None:
        """Enter one batch job into the encode pool. ``record(member,
        entry, last)`` runs on ``loop`` as each member ends;
        ``denoise_done`` resolves when the card is free for the next
        job."""
        ticket = _GroupTicket(self, job, members, sampler_node_ids,
                              context, loop, denoise_done, record)
        with self._counts_lock:
            self.counts["groups"] += 1
            self.counts["members"] += len(ticket.members)
        self.rebalance()
        for m in ticket.members:
            self._put(self.encode, _EncodeWork(ticket, m))

    def depth(self) -> int:
        """The host-side backlog (encode + decode; the prompt queue
        bounds the denoise stage). Admission adds it to its depth, so
        slots freed at denoise-done cannot admit work without bound."""
        return self.encode.depth() + self.decode.depth()

    def depths(self) -> dict:
        return {"encode": self.encode.depth(),
                "denoise": self.denoise.depth(),
                "decode": self.decode.depth()}

    def stop(self) -> None:
        """Stop the pools in pipeline order (encode, denoise, decode), so
        a thread that ends its item within the join hands it on to a
        pool still running; queued items end ``interrupted``, and so
        does an item handed to a pool already stopped (a denoise call
        that outlives its join). Afterwards no pool, item or hook of the
        manager holds a member, a latent or a bundle. Blocks: an event
        loop runs it in an executor."""
        self._death_hook = None
        for pool in (self.encode, self.denoise, self.decode):
            for item in pool.stop():
                self._fail_quietly(item)

    def _fail_quietly(self, item) -> None:
        try:
            item.fail(self, "interrupted")
        except Exception as e:  # noqa: BLE001 — shutdown barrier
            debug_log(f"stages: drop at shutdown failed: {e!r}")

    def _put(self, pool: StagePool, item) -> None:
        """Hand ``item`` to ``pool``; a stopped pool refuses it and the
        item's members end ``interrupted`` instead of waiting forever."""
        if not pool.put(item):
            self._fail_quietly(item)

    # --- per-pool scaling ---------------------------------------------------

    def rebalance(self) -> None:
        """Size each host-side pool on its own queue depth: grow by one
        past ``CDT_STAGE_SCALE_DEPTH`` items a worker (up to
        ``CDT_STAGE_MAX_WORKERS``), shrink back to the base when idle."""
        per = constants.stage_scale_depth()
        ceiling = constants.stage_max_workers()
        for pool, base in ((self.encode, self.base_encode),
                           (self.decode, self.base_decode)):
            depth = pool.depth()
            if depth > per * pool.workers and pool.workers < ceiling:
                log(f"stages: {pool.name} pool {pool.workers} -> "
                    f"{pool.workers + 1} (depth {depth})")
                pool.resize(pool.workers + 1)
            elif depth == 0 and pool.busy == 0 and pool.workers > base:
                pool.resize(pool.workers - 1)

    def _pick_steal(self, pool) -> Optional[StagePool]:
        """The sibling host-side stage with the deepest queue, for an idle
        worker. The denoise pool neither steals nor is stolen from."""
        if not constants.stage_steal():
            return None
        sibs = [p for p in (self.encode, self.decode) if p is not pool]
        victim = max(sibs, key=lambda p: p.depth(), default=None)
        if victim is None or victim.depth() == 0:
            return None
        return victim

    # --- encode stage -------------------------------------------------------

    def _run_encode(self, works: list) -> None:
        for w in works:
            self._encode_member(w)
            w.done = True

    def _encode_member(self, w: _EncodeWork) -> None:
        from ..frontdoor.microbatch import _prepare, _serve_cached

        ticket, member = w.ticket, w.member
        cache = ticket.context.get("content_cache")
        # the whole member runs inside one barrier and the encode barrier
        # advances in the finally: an escape would otherwise leave the
        # group's denoise_done unresolved and the queue waiting forever
        try:
            ev = ticket.context.get("interrupt_event")
            if ev is not None and ev.is_set():
                self._complete(ticket, member, {"status": "interrupted"})
                return
            p = _prepare(member, ticket.sampler_node_ids[member.prompt_id],
                         ticket.context)
            results: dict = {}
            if _serve_cached(p, cache, results):
                # answered by the result tier: never reaches the card
                with self._counts_lock:
                    self.counts["cache_hits"] += 1
                self._complete(ticket, member, results[member.prompt_id])
                return
            if cache is not None and member.fingerprint is not None:
                cache.record_request(hit=False)
            ticket.add_ready(p)
        except InterruptedError:
            self._complete(ticket, member, {"status": "interrupted"})
        except Exception as e:  # noqa: BLE001 — member isolation barrier
            log(f"stages: encode failed for {member.prompt_id}: {e}")
            self._complete(ticket, member,
                           {"status": "error", "error": str(e)})
        finally:
            self._after_encode(ticket)

    def _after_encode(self, ticket: _GroupTicket) -> None:
        done, has_ready = ticket.encode_done()
        if not done:
            return
        if has_ready:
            self._put(self.denoise, _DenoiseWork(ticket))
        else:
            # every member answered (cache hit or error) without the card
            ticket.resolve_denoise()

    # --- denoise stage ------------------------------------------------------

    def _run_denoise(self, works: list) -> None:
        for w in works:
            try:
                self._denoise_ticket(w.ticket)
            finally:
                w.done = True
                w.ticket.resolve_denoise()

    def _denoise_ticket(self, ticket: _GroupTicket) -> None:
        prepared = ticket.take_ready()
        if not prepared:
            return
        # sub-group by runtime signature as the fused path does; the
        # staged lane also needs the latent entry points
        groups: dict[tuple, list] = {}
        singles: list = []
        for p in prepared:
            if (p.stackable and hasattr(p.pipeline, "generate_latents")
                    and hasattr(p.pipeline, "decode_latents")):
                groups.setdefault(p.signature(), []).append(p)
            else:
                singles.append(p)
        for p in singles:
            # ControlNet conditioning or another pipeline: the fused solo
            # path, on the denoise worker (it needs the card anyway)
            if telemetry.enabled():
                _tm.BATCH_SIZE.observe(1)
            self._solo_member(ticket, p, batch_size=1)
        for grp in groups.values():
            self._denoise_subgroup(ticket, grp)

    def _denoise_subgroup(self, ticket: _GroupTicket, grp: list) -> None:
        from ..residency import ResidencyError, pinned_bundle

        lead = grp[0]
        try:
            with pinned_bundle(lead.model):
                lats = lead.pipeline.generate_latents(
                    lead.spec, seeds=[p.seed for p in grp],
                    contexts=[p.context for p in grp],
                    uncond_contexts=[p.uncond for p in grp],
                    ys=[p.y for p in grp], uys=[p.uy for p in grp])
            if telemetry.enabled():
                _tm.BATCH_SIZE.observe(len(grp))
        except InterruptedError:
            for p in grp:
                self._complete(ticket, p.member, {"status": "interrupted"})
            return
        except ResidencyError as e:
            # the bundle was evicted before its pin: a solo run of the
            # same bundle could not compute either
            for p in grp:
                self._complete(ticket, p.member,
                               {"status": "error", "error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — fall back, lose no job
            log(f"stages: latent microbatch of {len(grp)} failed ({e}); "
                f"falling back to fused solo execution")
            if telemetry.enabled():
                _tm.BATCH_FALLBACKS.inc()
            with self._counts_lock:
                self.counts["fallbacks"] += 1
            for p in grp:
                if telemetry.enabled():
                    _tm.BATCH_SIZE.observe(1)
                self._solo_member(ticket, p, batch_size=1)
            return
        from ..frontdoor.microbatch import _observe_group_shape

        _observe_group_shape(lead)
        for p, lat in zip(grp, lats):
            self._put(self.decode, _DecodeWork(ticket, p, lat,
                                               sampler_batch=len(grp)))

    def _solo_member(self, ticket: _GroupTicket, p,
                     batch_size: int = 1) -> None:
        """The fused pass-through: the sampler node's own ``execute`` and
        the suffix, the solo queue path's code."""
        from ..frontdoor.microbatch import _fill_cache, _finish, _solo

        cache = ticket.context.get("content_cache")
        try:
            images = _solo(p)
            _fill_cache(p, cache, images)
            out_cache = _finish(p, images)
            self._complete(ticket, p.member,
                           {"status": "success", "outputs": out_cache,
                            "batch_size": batch_size})
        except InterruptedError:
            self._complete(ticket, p.member, {"status": "interrupted"})
        except Exception as e:  # noqa: BLE001 — member isolation barrier
            log(f"stages: solo member {p.member.prompt_id} failed: {e}")
            self._complete(ticket, p.member,
                           {"status": "error", "error": str(e)})

    # --- decode stage -------------------------------------------------------

    def _run_decode(self, works: list) -> None:
        live: list[_DecodeWork] = []
        for w in works:
            ev = w.ticket.context.get("interrupt_event")
            if ev is not None and ev.is_set():
                w.fail(self, "interrupted")
            else:
                live.append(w)
        ready: list[_DecodeWork] = []
        for w in live:
            # a wire failure (checksum mismatch under CDT_STAGE_WIRE=1)
            # errors that member, not the whole batch
            try:
                self._transfer(w)
            except Exception as e:  # noqa: BLE001 — member isolation
                log(f"stages: latent transfer failed for "
                    f"{w.p.member.prompt_id}: {e}")
                w.fail(self, "error", str(e))
            else:
                ready.append(w)
        if not ready:
            return
        hook = self._death_hook
        if hook is not None:
            hook(ready)             # a test's worker death
        lead = ready[0].p
        from ..residency import pinned_bundle

        try:
            with pinned_bundle(lead.model):
                images = lead.pipeline.decode_latents(
                    [w.arrived for w in ready])
            if telemetry.enabled():
                _tm.DECODE_BATCH_SIZE.observe(len(ready))
        except StageWorkerDeath:
            raise
        except InterruptedError:
            for w in ready:
                w.fail(self, "interrupted")
            return
        except Exception as e:  # noqa: BLE001 — fall back per item
            log(f"stages: batched decode of {len(ready)} failed ({e}); "
                f"decoding solo")
            for w in ready:
                self._decode_solo(w)
            return
        for w, img in zip(ready, images):
            self._finish_member(w, img, decode_batch=len(ready))

    def _transfer(self, w: _DecodeWork) -> None:
        """Hand one latent to the decode side: the denoise call's tensor
        as it lies, or under ``CDT_STAGE_WIRE=1`` the tensor back from the
        whole checksummed round trip (serialise, sha256, parse, verify)
        on the same device."""
        if w.arrived is not None:
            return
        t0 = time.perf_counter()
        if constants.stage_wire():
            back = LatentHandoff.from_payload(w.handoff().to_payload()).latents
            w.arrived = torch.from_numpy(np.array(back)).to(w.latents.device)
        else:
            w.arrived = w.latents
        if telemetry.enabled():
            _tm.LATENT_TRANSFER_BYTES.observe(
                w.arrived.numel() * w.arrived.element_size())
            _tm.LATENT_TRANSFER_SECONDS.observe(time.perf_counter() - t0)

    def _decode_solo(self, w: _DecodeWork) -> None:
        """One latent alone: the fallback of a failed decode batch, so no
        admitted member is lost to batching."""
        from ..residency import pinned_bundle

        try:
            with pinned_bundle(w.p.model):
                images = w.p.pipeline.decode_latents([w.arrived])
            if telemetry.enabled():
                _tm.DECODE_BATCH_SIZE.observe(1)
        except Exception as e:  # noqa: BLE001 — member isolation barrier
            log(f"stages: solo decode failed for "
                f"{w.p.member.prompt_id}: {e}")
            w.fail(self, "error", str(e))
            return
        self._finish_member(w, images[0], decode_batch=1)

    def _finish_member(self, w: _DecodeWork, images,
                       decode_batch: int) -> None:
        from ..frontdoor.microbatch import _fill_cache, _finish

        w.done = True
        w.drop()
        cache = w.ticket.context.get("content_cache")
        try:
            _fill_cache(w.p, cache, images)
            out_cache = _finish(w.p, images)
        except InterruptedError:
            self._complete(w.ticket, w.p.member, {"status": "interrupted"})
            return
        except Exception as e:  # noqa: BLE001 — member isolation barrier
            log(f"stages: suffix failed for {w.p.member.prompt_id}: {e}")
            self._complete(w.ticket, w.p.member,
                           {"status": "error", "error": str(e)})
            return
        self._complete(w.ticket, w.p.member,
                       {"status": "success", "outputs": out_cache,
                        "batch_size": w.sampler_batch,
                        "decode_batch": decode_batch})

    def _redispatch_decode(self, items: list) -> None:
        self._redispatch(self.decode, items)

    def _redispatch_encode(self, items: list) -> None:
        self._redispatch(self.encode, items)

    def _redispatch(self, pool: StagePool, items: list) -> None:
        """Bounded re-dispatch of a dead worker's items to a survivor (or
        a respawned worker): no dead letter, no breaker evidence; past
        ``CDT_STAGE_MAX_REDISPATCH`` the member errors loudly."""
        bound = constants.stage_max_redispatch()
        for item in items:
            if getattr(item, "done", False):
                # already terminal: re-dispatching would complete it twice
                continue
            item.redispatch += 1
            if item.redispatch > bound:
                item.fail(self, "error",
                          f"stage worker died {item.redispatch} times "
                          f"holding this item — redispatch bound "
                          f"({bound}) exceeded")
                continue
            with self._counts_lock:
                self.counts["redispatched"] += 1
            self._put(pool, item)

    # --- completion ---------------------------------------------------------

    def _complete(self, ticket: _GroupTicket, member, entry: dict) -> None:
        last = ticket.member_done()
        self._marshal(ticket.loop, ticket.record, member, entry, last)

    @staticmethod
    def _marshal(loop, fn, *args) -> None:
        """Run ``fn`` on the controller's loop; inline when the loop is
        already closed (shutdown), so the terminal state still lands."""
        try:
            loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 — teardown barrier
                debug_log(f"stages: inline completion failed: {e!r}")

    # --- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """The ``GET /distributed/stages`` payload."""
        with self._counts_lock:
            counts = dict(self.counts)
        return {
            "enabled": True,
            "pools": {p.name: p.stats()
                      for p in (self.encode, self.denoise, self.decode)},
            "wire": constants.stage_wire(),
            "steal": constants.stage_steal(),
            "decode_batch_max": self.decode.max_batch,
            "decode_window_ms": self.decode.window_s * 1000.0,
            **counts,
        }


def build_stages() -> Optional[StageManager]:
    """The controller's stage manager, or None under ``CDT_STAGES=0``
    (the fused path runs as before)."""
    if not stages_enabled():
        log("stage-split serving disabled (CDT_STAGES=0) — fused path")
        return None
    return StageManager()
