"""The metric families of the port, declared in one place (the JAX
package's ``telemetry/metrics.py``, less the families whose
instrumentation sites are not ported yet: warmup, residency, the fleet
cache, preemption, stages, the autoscaler, drain and steal, the autotuner
and the XLA compile cache; ``ROADMAP.md`` names each under its item).

Instrumentation sites import these objects and guard every use with
``telemetry.enabled()``. Naming follows Prometheus conventions: ``cdt_``
prefix, base-unit suffixes (``_seconds``, ``_bytes``), counters end in
``_total``.

Label conventions (kept low-cardinality):

- ``pipeline``: ``txt2img``, ``img2img``, ``flow_dp``, ``tile_img2img``.
- ``event`` (tiles): ``seeded`` / ``assigned`` / ``completed`` /
  ``requeued`` / ``restored`` / ``dead_letter`` / ``timed_out``.
- ``transport``: ``http`` / ``ws``; ``outcome``: ``ok`` / ``error`` (or
  probe-specific ``online`` / ``offline`` / ``quarantined``, eviction
  ``evicted`` / ``spared``).
"""

from __future__ import annotations

from .registry import BYTES_BUCKETS, COMPILE_BUCKETS, REGISTRY

# --- diffusion pipelines ----------------------------------------------------

SAMPLER_STEP_SECONDS = REGISTRY.histogram(
    "cdt_sampler_step_seconds",
    "Per-step sampler wall-clock (the sampling loop's synchronised "
    "wall-clock / ladder steps), by pipeline.",
    ("pipeline",))

PIPELINE_COMPILE_SECONDS = REGISTRY.histogram(
    "cdt_pipeline_compile_seconds",
    "Wall-clock of a pipeline's first call (cuDNN and cuBLAS set-up and "
    "the kernels' first launches included), by pipeline.",
    ("pipeline",), buckets=COMPILE_BUCKETS)

PIPELINE_EXECUTE_SECONDS = REGISTRY.histogram(
    "cdt_pipeline_execute_seconds",
    "Wall-clock of a pipeline's calls after the first, by pipeline.",
    ("pipeline",))

# --- attention kernel dispatch (ops/attention.py) ---------------------------

ATTN_KERNEL_SELECTED = REGISTRY.counter(
    "cdt_attn_kernel_selected",
    "Attention kernel-tier selections on the card, by tier "
    "(fused/packed/bh) and geometry (hH.dD.qN.kvN.dtype, sequence "
    "lengths bucketed to powers of two). Increments once per geometry "
    "and tier a process selects.",
    ("tier", "geometry"))

# --- tile farm --------------------------------------------------------------

TILE_EVENTS = REGISTRY.counter(
    "cdt_tile_tasks_total",
    "Tile-farm task lifecycle events.",
    ("event",))

TILE_QUEUE_DEPTH = REGISTRY.gauge(
    "cdt_tile_queue_depth",
    "Pending (unassigned) tile tasks across all live tile jobs.")

TILE_WORKER_EVICTIONS = REGISTRY.counter(
    "cdt_tile_worker_evictions_total",
    "Heartbeat-timeout verdicts on tile workers.",
    ("outcome",))   # evicted | spared

# --- cluster dispatch / probing --------------------------------------------

DISPATCH_SECONDS = REGISTRY.histogram(
    "cdt_dispatch_seconds",
    "Prompt dispatch round-trip latency to a worker host.",
    ("transport", "outcome"))

DISPATCH_PAYLOAD_BYTES = REGISTRY.histogram(
    "cdt_dispatch_payload_bytes",
    "Serialized prompt payload size per dispatch.",
    ("transport",), buckets=BYTES_BUCKETS)

WORKER_PROBES = REGISTRY.counter(
    "cdt_worker_probe_total",
    "Worker health-probe outcomes (orchestration fan-out).",
    ("outcome",))   # online | offline | quarantined

MEDIA_SYNC_FILES = REGISTRY.counter(
    "cdt_media_sync_files_total",
    "Per-file media sync outcomes (master -> remote host).",
    ("outcome",))   # uploaded | skipped | missing | failed

MEDIA_SYNC_BYTES = REGISTRY.counter(
    "cdt_media_sync_bytes_total",
    "Bytes uploaded by media sync.")

# --- resilience (cluster/resilience.py + cluster/faults.py) -----------------

BREAKER_STATE = REGISTRY.gauge(
    "cdt_worker_breaker_state",
    "Per-worker circuit breaker state (0=closed, 1=half-open, 2=open).",
    ("worker",))

BREAKER_TRANSITIONS = REGISTRY.counter(
    "cdt_worker_breaker_transitions_total",
    "Breaker state transitions by destination state.",
    ("to",))   # closed | half_open | open

RETRY_ATTEMPTS = REGISTRY.counter(
    "cdt_retry_attempts_total",
    "Retries performed by the unified RetryPolicy, by operation.",
    ("op",))   # dispatch | request_work | submit | collect | media | ...

FAULTS_INJECTED = REGISTRY.counter(
    "cdt_faults_injected_total",
    "Faults injected by the deterministic chaos harness (CDT_FAULTS).",
    ("op", "kind"))

# --- text encoders (models/text.py) -----------------------------------------

HASH_TOKENIZATION = REGISTRY.counter(
    "cdt_hash_tokenization_total",
    "Text encodes that used the deterministic hash tokenisation (no BPE "
    "vocabulary loaded), by tower. Nonzero on a production worker means "
    "conditioning does not reflect the prompt.",
    ("tower",))

# --- serving front door (cluster/frontdoor) ---------------------------------

ADMISSION_TOTAL = REGISTRY.counter(
    "cdt_admission_total",
    "Front-door admission decisions. admitted = fast path; queued = "
    "accepted past the soft high-watermark; shed = refused with 429 + "
    "Retry-After (overload or tenant rate).",
    ("outcome", "priority"))   # admitted | queued | shed

BATCH_SIZE = REGISTRY.histogram(
    "cdt_batch_size",
    "Microbatch occupancy per executed sampler program (1 = solo "
    "pass-through). Mean > 1 means cross-user coalescing is working.",
    buckets=(1, 2, 4, 8, 16, 32, 64))

BATCH_FALLBACKS = REGISTRY.counter(
    "cdt_batch_fallbacks_total",
    "Microbatched programs that failed and fell back to per-member solo "
    "execution (admitted jobs are retried solo, never dropped).")

FD_QUEUE_DEPTH = REGISTRY.gauge(
    "cdt_fd_queue_depth",
    "Per-priority-class request depth by stage: coalescing (held in a "
    "front-door window) or queued (in the prompt queue).",
    ("stage", "priority"))

QUEUE_WAIT_SECONDS = REGISTRY.histogram(
    "cdt_queue_wait_seconds",
    "Time-in-queue per request (submission to execution start, "
    "coalescing window included), by priority class.",
    ("priority",))

# --- content cache (cluster/cache) ------------------------------------------

CACHE_HITS = REGISTRY.counter(
    "cdt_cache_hits_total",
    "Content-cache hits by tier (conditioning = a text-encode skipped; "
    "result = a whole sampler program skipped). Disk hits count here too "
    "— a hit is a hit wherever the bytes came from.",
    ("tier",))

CACHE_MISSES = REGISTRY.counter(
    "cdt_cache_misses_total",
    "Content-cache misses by tier (the computation ran and filled the "
    "entry).",
    ("tier",))

CACHE_BYTES = REGISTRY.gauge(
    "cdt_cache_bytes",
    "In-memory bytes held per cache tier (LRU under the "
    "CDT_CACHE_*_MAX_BYTES caps).",
    ("tier",))

CACHE_ENTRIES = REGISTRY.gauge(
    "cdt_cache_entries",
    "In-memory entries per cache tier.",
    ("tier",))

CACHE_EVICTIONS = REGISTRY.counter(
    "cdt_cache_evictions_total",
    "LRU evictions per cache tier (memory budget or persisted-tier cap).",
    ("tier",))

CACHE_CORRUPT = REGISTRY.counter(
    "cdt_cache_corrupt_total",
    "Persisted cache entries rejected at load: checksum mismatch or "
    "unreadable sidecar. Always followed by a recompute — corruption is "
    "never served.",
    ("tier",))

COALESCE_WIDTH = REGISTRY.histogram(
    "cdt_coalesce_width",
    "Requests answered per executed fingerprint (1 = no duplicates were "
    "in flight; N = one execution fanned out to N-1 waiters).",
    buckets=(1, 2, 4, 8, 16, 32, 64))

# --- prompt queue -----------------------------------------------------------

PROMPTS_TOTAL = REGISTRY.counter(
    "cdt_prompts_total",
    "Prompt executions by terminal status.",
    ("status",))   # success | error | interrupted | expired

PROMPT_SECONDS = REGISTRY.histogram(
    "cdt_prompt_duration_seconds",
    "End-to-end graph execution wall-clock per prompt.")

PROMPT_QUEUE_DEPTH = REGISTRY.gauge(
    "cdt_prompt_queue_depth",
    "Prompts queued or executing on this controller.")

# --- HTTP control plane -----------------------------------------------------

HTTP_REQUESTS = REGISTRY.counter(
    "cdt_http_requests_total",
    "Control-plane requests by route template and status.",
    ("method", "path", "status"))

# --- worker monitor (standalone watchdog) ----------------------------------
# When the monitor runs as its own process (the launch path,
# workers/lifecycle.py) this family lives in THAT process and is not
# scrapable; it surfaces only when monitor_and_run is embedded in a
# serving process (tests, custom supervisors).

WORKER_MONITOR_CHECKS = REGISTRY.counter(
    "cdt_worker_monitor_checks_total",
    "Watchdog verdicts (master_died / worker_exit / signal).",
    ("outcome",))
