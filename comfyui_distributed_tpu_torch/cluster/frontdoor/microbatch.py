"""Group execution: N coalesced prompts, one microbatch call (the port's
``cluster/frontdoor/microbatch.py``, after the JAX package's).

A flushed group runs in the prompt queue's graph thread as one unit:

1. **Prefix**: each member's graph runs up to (not including) its
   sampler node: checkpoint load, text encode, seed. Members share the
   model registry, so the checkpoint builds once.
2. **Group**: each member's sampler inputs are resolved as the executor
   would (``graph.executor.node_kwargs``) and sub-grouped by runtime
   signature (pipeline, spec, conditioning shapes), so a member whose
   conditioning came out another shape runs solo instead.
3. **One call**: each sub-group of two or more runs
   ``Txt2ImgPipeline.generate_microbatch`` (each member bitwise its solo
   run); a singleton runs the sampler node's own ``execute``.
4. **Suffix**: each member's remaining nodes run with its images put in
   as the sampler's output.

A member that fails in its prefix or suffix fails alone; a failed group
call falls every member of that sub-group back to a solo run (counted in
``cdt_batch_fallbacks_total``), so no admitted job is lost to batching.
The result tier (``cluster/cache``) serves a member before any of this,
its ladder local memory → local disk → the fleet ring's owner
(``cluster/cache/fleet.py``) → recompute, and is filled after, the
owner's copy asynchronously. A ``cache: "near"`` member that missed the
exact tiers is served from a donor's mid-trajectory latent when the
fleet's near tier holds one (``cache: "near"`` in its history, approximate
by design, never filling the exact tier); otherwise it runs solo as a
donor, preempted once at its midpoint to park that latent, then resumed
to the end, bitwise its plain run. The group call runs under
``pinned_bundle``, so a residency planner never evicts its bundle
mid-call. A stacked group's program is observed into the shape catalog
(``cluster/shape_catalog``), so the next boot warms it. Stage-split
serving (``cluster/stages``) reuses these helpers across its pools.
"""

from __future__ import annotations

import time
from typing import Any

from ... import telemetry
from ...graph.executor import GraphExecutor, node_kwargs, topo_order
from ...telemetry import metrics as _tm
from ...utils.logging import debug_log, log


def downstream_nodes(prompt: dict, root: str) -> set:
    """Transitive consumers of ``root``'s outputs (not including it)."""
    consumers: dict[str, set] = {}
    for nid, node in prompt.items():
        for v in node.get("inputs", {}).values():
            if isinstance(v, (list, tuple)) and len(v) == 2:
                consumers.setdefault(str(v[0]), set()).add(nid)
    out: set = set()
    frontier = [root]
    while frontier:
        for nxt in consumers.get(frontier.pop(), ()):
            if nxt not in out:
                out.add(nxt)
                frontier.append(nxt)
    return out


class _Prepared:
    """One member after its prefix, ready to group."""

    def __init__(self, member, sampler_id: str, executor: GraphExecutor,
                 cache: dict, order: list, kwargs: dict):
        self.member = member
        self.sampler_id = sampler_id
        self.executor = executor
        self.cache = cache
        self.order = order
        self.kwargs = kwargs
        self.spec = None
        self.seed = None
        self.context = None
        self.uncond = None
        self.y = None
        self.uy = None
        self.pipeline = None
        self.model = None
        self.stackable = False
        self.why_solo = ""
        self.result_key = None   # the result tier's key (cluster/cache)
        self.near_key = None     # the near tier's seedless key

    def signature(self) -> tuple:
        return (id(self.pipeline), self.spec,
                tuple(self.context.shape), tuple(self.uncond.shape),
                None if self.y is None else tuple(self.y.shape))


def _prepare(member, sampler_id: str, base_context: dict) -> _Prepared:
    """Run one member's prefix and resolve its sampler call's inputs."""
    from ...diffusion.pipeline import GenerationSpec
    from ...graph import nodes_builtin as nb

    prompt = member.prompt
    context = dict(base_context)
    context["prompt_id"] = member.prompt_id
    executor = GraphExecutor(context)
    order = topo_order(prompt)
    down = downstream_nodes(prompt, sampler_id)
    prefix = [n for n in order if n != sampler_id and n not in down]
    cache: dict[str, tuple] = {}
    executor.execute_nodes(prompt, prefix, cache)

    kwargs = node_kwargs(prompt, sampler_id, cache, context)
    prep = _Prepared(member, sampler_id, executor, cache, order, kwargs)

    model = kwargs["model"]
    prep.model = model
    positive, negative = kwargs["positive"], kwargs["negative"]
    prep.spec = GenerationSpec(
        height=int(kwargs["height"]), width=int(kwargs["width"]),
        steps=int(kwargs["steps"]),
        sampler=kwargs.get("sampler_name", "euler"),
        scheduler=kwargs.get("scheduler", "karras"),
        guidance_scale=float(kwargs["cfg"]),
        per_device_batch=int(kwargs.get("batch_per_device", 1)),
    )
    prep.seed = int(kwargs["seed"])
    prep.pipeline = model.pipeline
    if isinstance(positive, dict) and positive.get("control"):
        # the classifier cannot see a ControlNet riding the conditioning
        prep.why_solo = "control_conditioning"
        return prep
    adm = model.pipeline.unet.config.adm_in_channels
    device = model.pipeline.device
    prep.context = positive["context"]
    prep.uncond = negative["context"]
    prep.y = nb._adm_from_cond(positive, adm, device) if adm else None
    prep.uy = nb._adm_from_cond(negative, adm, device) if adm else None
    if not hasattr(prep.pipeline, "generate_microbatch"):
        prep.why_solo = "pipeline_unsupported"
        return prep
    prep.stackable = True
    return prep


def _finish(prep: _Prepared, images) -> dict:
    """Put the sampler output in, run the suffix, return the whole cache."""
    prep.cache[prep.sampler_id] = (images,)
    suffix = [n for n in prep.order if n not in prep.cache]
    prep.executor.execute_nodes(prep.member.prompt, suffix, prep.cache)
    return prep.cache


def _solo(prep: _Prepared) -> Any:
    """The sampler node's own ``execute``: a solo queue job's code, its
    progress streaming included."""
    from ...graph.node import get_node

    cls = get_node(prep.member.prompt[prep.sampler_id]["class_type"])
    return cls().execute(**prep.kwargs)[0]


def execute_group(members: list, sampler_node_ids: dict,
                  base_context: dict) -> dict:
    """Execute one flushed group. Returns ``{prompt_id: entry}``, each
    entry shaped like a history record (``status``/``outputs``/``error``
    and ``batch_size``). On an interrupt the partial results come back:
    members already finished keep their success; the queue marks the
    rest interrupted."""
    results: dict[str, dict] = {}
    try:
        _execute_group_inner(members, sampler_node_ids, base_context,
                             results)
    except InterruptedError:
        pass
    return results


def _cache_key_for(p: _Prepared, cache) -> "str | None":
    """The result tier's key of one member: fingerprint × execution
    signature × conditioning mode × weights provenance; None when the
    member cannot be cached (no fingerprint, no manager, or a bundle
    that cannot state its weights' provenance)."""
    if cache is None or p.member.fingerprint is None:
        return None
    from ..cache import execution_signature, result_key
    from ..cache.conditioning import encoder_mode

    weights_fn = getattr(p.model, "weights_identity", None)
    if weights_fn is None:
        return None
    mode = encoder_mode(getattr(p.model, "text_encoder", None))
    return result_key(p.member.fingerprint,
                      execution_signature(p.pipeline.device), mode,
                      weights_fn())


def _serve_cached(p: _Prepared, cache, results: dict) -> bool:
    """Serve one member from the result tier. It still runs its suffix
    (``SaveImage`` writes its file); only the sampler is skipped. A
    ``cache: "bypass"`` member never serves (it runs and refreshes). The
    ladder: local memory, local disk (both in ``results.get``), the
    fleet ring's owner (``fleet.probe``), then a recompute."""
    p.result_key = _cache_key_for(p, cache)
    if p.result_key is None or p.member.cache_mode == "bypass":
        return False
    hit = cache.results.get(p.result_key)
    fleet = getattr(cache, "fleet", None)
    if hit is None and fleet is not None:
        hit = fleet.probe(p.result_key)
        if hit is not None and "images" in hit:
            # memory only: the entry's durable home is its owner's shard
            cache.results.put(p.result_key, hit, persist=False)
    if hit is None or "images" not in hit:
        return False
    try:
        out_cache = _finish(p, hit["images"].to(p.pipeline.device,
                                                copy=True))
    except InterruptedError:
        raise
    except Exception as e:  # noqa: BLE001 — member isolation
        results[p.member.prompt_id] = {"status": "error", "error": str(e)}
        log(f"front door: cached-suffix failed for "
            f"{p.member.prompt_id}: {e}")
        return True
    results[p.member.prompt_id] = {"status": "success",
                                   "outputs": out_cache,
                                   "cache": "hit", "batch_size": 0}
    cache.record_request(hit=True)
    return True


def _fill_cache(p: _Prepared, cache, images) -> None:
    """Record a freshly computed sampler output (a miss or a bypass); a
    failed fill never sinks the request that computed it."""
    if cache is None or p.result_key is None:
        return
    try:
        cache.results.put(p.result_key, {"images": images})
        fleet = getattr(cache, "fleet", None)
        if fleet is not None:
            # to the ring's owner, asynchronously: the host copy the tier
            # just made, so the card is read once
            fleet.fill(p.result_key, cache.results.peek(p.result_key)
                       or {"images": images})
    except Exception as e:  # noqa: BLE001
        debug_log(f"result cache: fill failed for "
                  f"{p.result_key[:12]}: {e}")


def _filled_adm(p: _Prepared) -> tuple:
    """(y, uy) with the zero ADM defaults the sampler applies: the donor
    runs with these, so the near tier's expected identity hashes the
    conditioning the donor's identity hashed."""
    import torch

    y, uy = p.y, p.uy
    if y is None:
        adm = p.pipeline.unet.config.adm_in_channels
        y = torch.zeros((1, max(adm, 1)), dtype=torch.float32)
    if uy is None:
        uy = torch.zeros_like(y)
    return y, uy


def _near_key_for(p: _Prepared, cache) -> "str | None":
    """The near tier's key of one member (``_cache_key_for``'s factors
    over the seed-masked fingerprint), or None when the member did not
    opt in with ``cache: "near"``, the fleet tier is off, or the member
    cannot group (the donor path needs what grouping proves)."""
    if cache is None or getattr(cache, "fleet", None) is None:
        return None
    if not p.stackable or p.member.cache_mode != "near":
        return None
    from ..cache import execution_signature, near_fingerprint, near_key
    from ..cache.conditioning import encoder_mode

    weights_fn = getattr(p.model, "weights_identity", None)
    if weights_fn is None:
        return None
    mode = encoder_mode(getattr(p.model, "text_encoder", None))
    return near_key(near_fingerprint(p.member.prompt),
                    execution_signature(p.pipeline.device), mode,
                    weights_fn())


def _serve_near(p: _Prepared, cache, results: dict) -> bool:
    """Serve one opted-in member from a donor's mid-trajectory latent:
    the rest of the ladder under the member's own seed. Approximate by
    design; it never fills the exact tier, and any failure falls back to
    a full compute."""
    import dataclasses

    import numpy as np
    import torch

    p.near_key = _near_key_for(p, cache)
    if p.near_key is None or not hasattr(p.pipeline, "generate_near"):
        return False
    fleet = cache.fleet
    y, uy = _filled_adm(p)
    expect = p.pipeline.checkpoint_identity(
        p.spec, p.seed, conditioning=(p.context, p.uncond, y, uy))
    expect.pop("seed", None)       # the same work modulo the seed
    ckpt = fleet.near.lookup(p.near_key, expect)
    if ckpt is None:
        return False
    total = int(ckpt.total_steps)
    remaining = total - int(ckpt.step)
    if remaining <= 0 or remaining >= total:
        return False
    # the sampler state's latent: its first 4-D leaf, NHWC
    lat = next((np.asarray(leaf) for leaf in ckpt.carry
                if np.asarray(leaf).ndim == 4), None)
    if lat is None:
        return False
    try:
        images = p.pipeline.generate_near(
            dataclasses.replace(p.spec, denoise=remaining / total), p.seed,
            torch.from_numpy(np.array(lat[: p.spec.per_device_batch])),
            p.context, p.uncond, y, uy)
        out_cache = _finish(p, images)
    except InterruptedError:
        raise
    except Exception as e:  # noqa: BLE001 — member isolation
        log(f"front door: near-tier serve failed for "
            f"{p.member.prompt_id} ({e}); computing from scratch")
        return False
    results[p.member.prompt_id] = {"status": "success",
                                   "outputs": out_cache,
                                   "cache": "near", "batch_size": 0}
    fleet.near.record_reuse(int(ckpt.step))
    return True


def _run_near_donor(p: _Prepared, cache):
    """A near-mode miss through the preemptible sampler: preempted once
    at its midpoint, the checkpoint parked as a donor for later re-rolls,
    then resumed to the end, bitwise the plain run (so the caller fills
    the exact tier as usual). Returns the images, or None for the plain
    solo path."""
    fleet = getattr(cache, "fleet", None)
    if fleet is None or not hasattr(p.pipeline, "generate_preemptible"):
        return None
    steps = int(p.spec.steps)
    half = steps // 2
    if half < 1 or half >= steps:
        return None                # a 1-step run has no midpoint
    fired = []

    def once():
        if fired:
            return None
        fired.append(1)
        return "near_donor"

    y, uy = _filled_adm(p)
    out = p.pipeline.generate_preemptible(
        p.spec, p.seed, p.context, p.uncond, y, uy, segment_steps=half,
        should_preempt=once)
    if "images" in out:
        return out["images"]
    ckpt = out["checkpoint"]
    try:
        fleet.near.offer(p.near_key, ckpt)
    except Exception as e:  # noqa: BLE001 — parking a donor is best effort
        debug_log(f"fleet.near: donor park failed: {e}")
    out = p.pipeline.generate_preemptible(
        p.spec, p.seed, p.context, p.uncond, y, uy,
        segment_steps=max(1, steps), resume=ckpt)
    return out.get("images")


def _execute_group_inner(members: list, sampler_node_ids: dict,
                         base_context: dict, results: dict) -> None:
    t0 = time.monotonic()
    cache = base_context.get("content_cache")
    prepared: list[_Prepared] = []

    for m in members:
        try:
            prepared.append(_prepare(m, sampler_node_ids[m.prompt_id],
                                     base_context))
        except InterruptedError:
            raise
        except Exception as e:  # noqa: BLE001 — member isolation
            results[m.prompt_id] = {"status": "error", "error": str(e)}
            log(f"front door: prefix failed for {m.prompt_id}: {e}")

    # the result tier: a request already answered skips its sampler
    served = [p for p in prepared if _serve_cached(p, cache, results)]
    prepared = [p for p in prepared if p not in served]
    if cache is not None:
        for p in prepared:
            if p.member.fingerprint is not None:
                cache.record_request(hit=False)

    # the near tier: a cache:"near" re-roll that missed the exact tiers
    # resumes a donor's midpoint (still a miss in the window above: a
    # reduced sampler run happens); a near miss runs solo as a donor
    near_served = [p for p in prepared if _serve_near(p, cache, results)]
    prepared = [p for p in prepared if p not in near_served]
    for p in prepared:
        if p.near_key is not None and p.stackable:
            p.stackable = False
            p.why_solo = "near_donor"

    # sub-group by runtime signature, in submission order
    groups: dict[tuple, list[_Prepared]] = {}
    singles: list[_Prepared] = []
    for p in prepared:
        if p.stackable:
            groups.setdefault(p.signature(), []).append(p)
        else:
            singles.append(p)

    def record(p: _Prepared, images, batch_size: int) -> None:
        try:
            _fill_cache(p, cache, images)
            results[p.member.prompt_id] = {
                "status": "success", "outputs": _finish(p, images),
                "batch_size": batch_size}
        except InterruptedError:
            raise
        except Exception as e:  # noqa: BLE001 — member isolation
            results[p.member.prompt_id] = {"status": "error",
                                           "error": str(e)}
            log(f"front door: suffix failed for {p.member.prompt_id}: {e}")

    def run_solo(p: _Prepared) -> None:
        if telemetry.enabled():
            _tm.BATCH_SIZE.observe(1)
        try:
            images = None
            if p.near_key is not None:
                try:
                    images = _run_near_donor(p, cache)
                except InterruptedError:
                    raise
                except Exception as e:  # noqa: BLE001 — plain solo next
                    debug_log(f"front door: near donor path failed for "
                              f"{p.member.prompt_id}: {e}")
            if images is None:
                images = _solo(p)
        except InterruptedError:
            raise
        except Exception as e:  # noqa: BLE001 — member isolation
            results[p.member.prompt_id] = {"status": "error",
                                           "error": str(e)}
            log(f"front door: solo member {p.member.prompt_id} "
                f"failed: {e}")
            return
        record(p, images, 1)

    for p in singles:
        run_solo(p)

    for grp in groups.values():
        if len(grp) == 1:
            run_solo(grp[0])
            continue
        lead = grp[0]
        try:
            from ..residency import pinned_bundle

            with pinned_bundle(lead.model):
                outs = lead.pipeline.generate_microbatch(
                    lead.spec, seeds=[p.seed for p in grp],
                    contexts=[p.context for p in grp],
                    uncond_contexts=[p.uncond for p in grp],
                    ys=[p.y for p in grp], uys=[p.uy for p in grp])
            if telemetry.enabled():
                _tm.BATCH_SIZE.observe(len(grp))
        except InterruptedError:
            raise
        except Exception as e:  # noqa: BLE001 — fall back, lose no job
            log(f"front door: microbatch of {len(grp)} failed ({e}); "
                f"falling back to solo execution")
            if telemetry.enabled():
                _tm.BATCH_FALLBACKS.inc()
            for p in grp:
                run_solo(p)
            continue
        _observe_group_shape(lead)
        for p, images in zip(grp, outs):
            record(p, images, len(grp))

    debug_log(f"front door: group of {len(members)} done in "
              f"{time.monotonic() - t0:.2f}s "
              f"({len(groups)} stack(s), {len(singles)} solo)")


def _observe_group_shape(lead: _Prepared) -> None:
    """Feed the shape catalog as the solo node does: a group's program is
    one the next boot should warm. Never raises."""
    from ..shape_catalog import observe

    try:
        name = getattr(getattr(lead.kwargs.get("model"), "preset", None),
                       "name", None)
        if name:
            observe("txt2img", name, lead.spec.height, lead.spec.width,
                    lead.spec.steps, batch=lead.spec.per_device_batch)
    except Exception as e:  # noqa: BLE001 — observation never sinks a group
        debug_log(f"shape catalog: group observation failed: {e}")
