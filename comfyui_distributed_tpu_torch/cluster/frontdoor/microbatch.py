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
The result tier (``cluster/cache``) serves a member before any of this
and is filled after. The group call runs under ``pinned_bundle``, so a
residency planner never evicts its bundle mid-call. A stacked group's
program is observed into the shape catalog (``cluster/shape_catalog``),
so the next boot warms it. Stage-split serving (``cluster/stages``)
reuses these helpers across its pools. Not ported: the near tier, which
lives in the fleet cache (A.6a).
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
    ``cache: "bypass"`` member never serves (it runs and refreshes)."""
    p.result_key = _cache_key_for(p, cache)
    if p.result_key is None or p.member.cache_mode == "bypass":
        return False
    hit = cache.results.get(p.result_key)
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
    except Exception as e:  # noqa: BLE001
        debug_log(f"result cache: fill failed for "
                  f"{p.result_key[:12]}: {e}")


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
