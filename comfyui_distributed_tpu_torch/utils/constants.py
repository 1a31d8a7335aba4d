"""The environment knobs the port's control plane reads, under the JAX
package's names and with its defaults (``utils/constants.py`` there).

Each knob is a plain function that reads the environment when it is
called, so a launcher or a test that sets a variable is seen at the next
read. An empty value means the default; a value that does not parse
raises ``KnobError`` at that read.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

# request fields of the serving front door (``cluster/frontdoor``):
# priority classes in strict order, the first the most latency-sensitive
# (the last sheds first under overload); ``cache`` modes of a request
# ("near" opts into the fleet cache's near tier)
PRIORITY_CLASSES = ("interactive", "batch")
DEFAULT_PRIORITY = "interactive"
DEFAULT_TENANT = "default"
CACHE_MODES = ("use", "bypass", "near")


class KnobError(ValueError):
    """A ``CDT_*`` variable holds a value that does not parse."""


def _bool(raw: str) -> bool:
    low = raw.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise ValueError(f"expected one of {_TRUE + _FALSE}")


def _read(name: str, default: T, parse: Callable[[str], T],
          lenient: bool = False) -> T:
    """``lenient``: a value that does not parse reads as the default (the
    JAX package's ``on_garbage="default"`` knobs)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return parse(raw.strip())
    except ValueError as e:
        if lenient:
            return default
        raise KnobError(f"{name}={raw!r} does not parse: {e}") from None


# --- identity and paths --------------------------------------------------------


def auth_token() -> Optional[str]:
    """The cluster's shared secret (``utils/auth.py``); it wins over the
    config's ``settings.auth_token``."""
    return _read("CDT_AUTH_TOKEN", None, str)


def is_worker() -> bool:
    return _read("CDT_IS_WORKER", False, _bool)


def worker_id() -> str:
    return _read("CDT_WORKER_ID", "", str)


def worker_index() -> int:
    return _read("CDT_WORKER_INDEX", 0, int)


def config_path() -> Optional[str]:
    return _read("CDT_CONFIG_PATH", None, str)


def debug() -> bool:
    """Verbose debug logging (the config's ``settings.debug`` can only
    add to it)."""
    return _read("CDT_DEBUG", False, _bool)


def output_dir() -> str:
    return _read("CDT_OUTPUT_DIR", "output", str)


def input_dir() -> str:
    return _read("CDT_INPUT_DIR", "input", str)


def checkpoint_root() -> Optional[str]:
    """Root of model checkpoints: ``<root>/<name>.safetensors`` (an LDM
    single file, converted on first load) or ``<root>/<name>/`` (a
    converted bundle) for preset ``name``."""
    return _read("CDT_CHECKPOINT_ROOT", None, str)


def upscale_model_dir() -> Optional[str]:
    """Directory of RRDBNet upscaler ``.safetensors`` files (falls back to
    ``CDT_CHECKPOINT_ROOT/upscalers``)."""
    return _read("CDT_UPSCALE_MODEL_DIR", None, str)


def controlnet_dir() -> Optional[str]:
    """Directory of ControlNet ``.safetensors`` files (falls back to
    ``CDT_CHECKPOINT_ROOT/controlnet``)."""
    return _read("CDT_CONTROLNET_DIR", None, str)


def lora_dir() -> Optional[str]:
    """Directory of kohya LoRA ``.safetensors`` files (falls back to
    ``CDT_CHECKPOINT_ROOT/loras``)."""
    return _read("CDT_LORA_DIR", None, str)


def tokenizer_dir() -> Optional[str]:
    """CLIP BPE vocabulary directory (``vocab.json`` + ``merges.txt``)."""
    return _read("CDT_TOKENIZER_DIR", None, str)


def t5_tokenizer_dir() -> Optional[str]:
    """T5 tokenizer directory (its ``tokenizer.json``; FLUX's text stack)."""
    return _read("CDT_T5_TOKENIZER_DIR", None, str)


def tile_journal_dir() -> str:
    """Crash-resume journal of completed tile tasks ("" = off)."""
    return _read("CDT_TILE_JOURNAL_DIR", "", str)


# --- payload caps --------------------------------------------------------------


def max_payload_size() -> int:
    """Largest request body the server reads (bytes)."""
    return _read("CDT_MAX_PAYLOAD_SIZE", 50 * 1024 * 1024, int)


def max_frame_raw_bytes() -> int:
    """Bound on the decoded size of one CDTF frame (bytes)."""
    return _read("CDT_MAX_FRAME_RAW_BYTES", 1 << 30, int)


def max_audio_payload_bytes() -> int:
    """Cap on an audio envelope's float32 waveform (bytes)."""
    return _read("CDT_MAX_AUDIO_PAYLOAD_BYTES", 256 * 1024 * 1024, int)


# --- orchestration concurrency and timeouts ------------------------------------


def worker_probe_concurrency() -> int:
    """Concurrent worker probes of an orchestration fan-out and of
    ``local-worker-status`` (fallback of the config's
    ``settings.worker_probe_concurrency``)."""
    return _read("CDT_PROBE_CONCURRENCY", 10, int)


def worker_prep_concurrency() -> int:
    """Concurrent per-worker prompt preparations (fallback of
    ``settings.worker_prep_concurrency``)."""
    return _read("CDT_PREP_CONCURRENCY", 4, int)


def probe_timeout() -> float:
    return _read("CDT_PROBE_TIMEOUT", 5.0, float)


def dispatch_timeout() -> float:
    return _read("CDT_DISPATCH_TIMEOUT", 30.0, float)


def media_sync_concurrency() -> int:
    """Concurrent media-sync transfers to one host (fallback of the
    config's ``settings.media_sync_concurrency``)."""
    return _read("CDT_MEDIA_SYNC_CONCURRENCY", 4, int)


def media_sync_timeout() -> float:
    """Timeout of one media-sync call, seconds (fallback of
    ``settings.media_sync_timeout_seconds``)."""
    return _read("CDT_MEDIA_SYNC_TIMEOUT", 120.0, float)


def heartbeat_timeout() -> float:
    return _read("CDT_HEARTBEAT_TIMEOUT", 60.0, float)


def heartbeat_interval() -> float:
    """How often the tile master checks its workers' heartbeats, and the
    ping interval of a worker's dispatch WebSocket."""
    return _read("CDT_HEARTBEAT_INTERVAL", 10.0, float)


def max_batch() -> int:
    """Result items per flush from a worker host."""
    return _read("CDT_MAX_BATCH", 20, int)


def work_request_budget() -> float:
    """Wall-clock window of a worker's 404-tolerant work-request loop."""
    return _read("CDT_WORK_REQUEST_BUDGET", 30.0, float)


def collect_poll_timeout() -> float:
    return _read("CDT_COLLECT_POLL_TIMEOUT", 5.0, float)


def collect_grace_s() -> float:
    """Deadline extension per round for a silent but busy worker."""
    return _read("CDT_COLLECT_GRACE_S", 30.0, float)


def collect_max_grace_rounds() -> int:
    return _read("CDT_COLLECT_MAX_GRACE_ROUNDS", 20, int)


def job_init_grace() -> float:
    """How long a result may wait for its collector job to exist."""
    return _read("CDT_JOB_INIT_GRACE", 10.0, float)


# --- retries (exponential backoff with full jitter) ----------------------------


def send_max_retries() -> int:
    return _read("CDT_SEND_MAX_RETRIES", 5, int)


def dispatch_max_retries() -> int:
    return _read("CDT_DISPATCH_MAX_RETRIES", 3, int)


def send_backoff_base() -> float:
    return _read("CDT_SEND_BACKOFF_BASE", 0.5, float)


def retry_cap_s() -> float:
    return _read("CDT_RETRY_CAP_S", 5.0, float)


# --- resilience ----------------------------------------------------------------


def breaker_fail_threshold() -> int:
    """Consecutive failures that open a worker's circuit breaker."""
    return _read("CDT_BREAKER_FAIL_THRESHOLD", 3, int)


def breaker_recovery_s() -> float:
    """Seconds an open breaker waits before one half-open trial."""
    return _read("CDT_BREAKER_RECOVERY_S", 30.0, float)


def faults() -> str:
    """A seeded fault plan for the control plane's outbound calls
    (``cluster/faults.py`` grammar; "" = off)."""
    return _read("CDT_FAULTS", "", str)


def max_tile_requeues() -> int:
    """Requeues of one tile task before it dead-letters."""
    return _read("CDT_MAX_TILE_REQUEUES", 3, int)


# --- serving front door (cluster/frontdoor) ------------------------------------


def frontdoor() -> bool:
    """Kill switch: 0 restores the legacy queue route unchanged."""
    return _read("CDT_FRONTDOOR", True, _bool)


def fd_window_ms() -> float:
    """Coalescing window: how long a group waits for same-shape company
    before flushing (ms)."""
    return _read("CDT_FD_WINDOW_MS", 25.0, float)


def fd_max_batch() -> int:
    """Largest group one microbatch executes."""
    return _read("CDT_FD_MAX_BATCH", 8, int)


def fd_inflight() -> int:
    """Batch jobs the front door keeps in the prompt queue at once
    (continuous batching)."""
    return _read("CDT_FD_INFLIGHT", 2, int)


def fd_soft_depth() -> int:
    """Depth past which admission answers 'queued' (accepted, busy)."""
    return _read("CDT_FD_SOFT_DEPTH", 64, int)


def fd_shed_depth() -> int:
    """Depth past which requests are shed with 429 + Retry-After (the
    lowest priority sheds at half)."""
    return _read("CDT_FD_SHED_DEPTH", 256, int)


def fd_tenant_rate() -> float:
    """Per-tenant token bucket: sustained requests a second."""
    return _read("CDT_FD_TENANT_RATE", 20.0, float)


def fd_tenant_burst() -> float:
    """Per-tenant token bucket: burst capacity."""
    return _read("CDT_FD_TENANT_BURST", 40.0, float)


def fd_max_tenants() -> int:
    """LRU cap on the per-tenant bucket map."""
    return _read("CDT_FD_MAX_TENANTS", 1024, int)


def fd_retry_after_s() -> float:
    """Base Retry-After of a shed answer (scaled by the overload ratio)."""
    return _read("CDT_FD_RETRY_AFTER_S", 2.0, float)


def fd_max_wait_ms() -> Optional[float]:
    """Force-flush valve: the most ms a ready group waits for capacity
    (None: 20 × the window)."""
    return _read("CDT_FD_MAX_WAIT_MS", None, float)


# --- content-addressed cache (cluster/cache) ------------------------------------


def cache() -> bool:
    """Kill switch of the content cache."""
    return _read("CDT_CACHE", True, _bool)


def cache_dir() -> Optional[str]:
    """Persisted-tier directory (None: the default under the output
    directory); an empty value, unlike other knobs, means memory-only."""
    raw = os.environ.get("CDT_CACHE_DIR")
    return None if raw is None else raw.strip()


def cache_cond_max_bytes() -> int:
    """In-memory conditioning-tier LRU cap (bytes)."""
    return _read("CDT_CACHE_COND_MAX_BYTES", 256 * 1024 * 1024, int)


def cache_result_max_bytes() -> int:
    """In-memory result-tier LRU cap (bytes): whole decoded image
    batches."""
    return _read("CDT_CACHE_RESULT_MAX_BYTES", 1024 * 1024 * 1024, int)


def cache_disk_max_bytes() -> int:
    """Persisted-tier byte cap (oldest first out)."""
    return _read("CDT_CACHE_DISK_MAX_BYTES", 4 * 1024 * 1024 * 1024, int)


# --- the fleet tier of the content cache (cluster/cache/fleet.py) ----------------


def fleet_cache() -> bool:
    """Kill switch of the fleet tier (the hash ring, remote serves and
    fills, the drain handback, the near tier); 0 keeps the cache per
    host."""
    return _read("CDT_FLEET_CACHE", True, _bool)


def fleet_cache_vnodes() -> int:
    """Virtual nodes a member on the consistent-hash ring."""
    return _read("CDT_FLEET_CACHE_VNODES", 64, int)


def fleet_cache_seed() -> str:
    """Ring placement seed: every controller of a fleet must share it, or
    they disagree on ownership (misses, never wrong bytes)."""
    return _read("CDT_FLEET_CACHE_SEED", "cdt-fleet-ring-v1", str)


def fleet_cache_timeout_s() -> float:
    """Seconds a remote serve may take before it reads as a miss."""
    return _read("CDT_FLEET_CACHE_TIMEOUT_S", 2.0, float)


def fleet_cache_near_max() -> int:
    """Donor checkpoints the near tier keeps (LRU)."""
    return _read("CDT_FLEET_CACHE_NEAR_MAX", 64, int)


# --- stage-split serving (cluster/stages) ---------------------------------------


def stages() -> bool:
    """Kill switch of stage-split serving: 0 restores the fused group path
    (encode, denoise and decode on the one graph thread)."""
    return _read("CDT_STAGES", True, _bool)


def stage_encode_workers() -> int:
    """Encode-pool threads (graph prefix, text encode through the
    conditioning tier, the result-tier probe)."""
    return _read("CDT_STAGE_ENCODE_WORKERS", 2, int)


def stage_decode_workers() -> int:
    """Decode-pool threads (VAE decode and graph suffix)."""
    return _read("CDT_STAGE_DECODE_WORKERS", 2, int)


def stage_max_workers() -> int:
    """Ceiling the rebalancer grows the encode and decode pools to (the
    denoise pool is always one: it owns the card)."""
    return _read("CDT_STAGE_MAX_WORKERS", 4, int)


def stage_scale_depth() -> float:
    """Queue depth per worker past which a host-side pool grows by one."""
    return _read("CDT_STAGE_SCALE_DEPTH", 8.0, float)


def stage_decode_batch() -> int:
    """Most latents one decode-pool pickup takes from a shape bucket."""
    return _read("CDT_STAGE_DECODE_BATCH", 8, int)


def stage_decode_window_ms() -> float:
    """How long a latent waits for same-bucket company before the decode
    pool flushes its bucket (ms)."""
    return _read("CDT_STAGE_DECODE_WINDOW_MS", 5.0, float)


def stage_wire() -> bool:
    """Send every denoise→decode handoff through the checksummed latent
    wire format (in-process handoffs otherwise keep the card's tensor)."""
    return _read("CDT_STAGE_WIRE", False, _bool)


def stage_steal() -> bool:
    """An idle encode or decode worker serves the deeper sibling queue."""
    return _read("CDT_STAGE_STEAL", True, _bool)


def stage_max_redispatch() -> int:
    """Re-dispatches of an item whose stage worker died, past which its
    member errors."""
    return _read("CDT_STAGE_MAX_REDISPATCH", 3, int)


# --- card-memory residency (cluster/residency.py) --------------------------------


def hbm_budget_gb() -> float:
    """Budget of the residency planner: GB of the card's memory for model
    bundles (0 = unlimited, planner off). The name is the JAX package's."""
    return _read("CDT_HBM_BUDGET_GB", 0.0, float)


# --- offload (diffusion/offload.py) ---------------------------------------------

F8_NAME = "float8_e4m3fn"
# the stream dtype's spellings, as the JAX package accepts them
_STREAM_DTYPES = {"fp8": F8_NAME, "f8": F8_NAME, "float8": F8_NAME,
                  F8_NAME: F8_NAME, "native": "native", "bfloat16": "native",
                  "bf16": "native", "exact": "native"}


def stream_dtype_name(raw: str) -> str:
    """The canonical name of a stream dtype spelling: ``float8_e4m3fn``
    or ``native`` (``bfloat16``/``bf16``/``exact`` leave every leaf in its
    own dtype, they cast nothing)."""
    try:
        return _STREAM_DTYPES[raw]
    except KeyError:
        raise ValueError(f"unknown CDT_OFFLOAD_STREAM_DTYPE {raw!r} (use "
                         f"{F8_NAME!r} or 'native')") from None


def offload() -> Optional[bool]:
    """Offloaded execution of FLUX- and WAN-class bundles forced on or off;
    unset: the caller's default (off on every server path)."""
    return _read("CDT_OFFLOAD", None, _bool)


def offload_resident_gb() -> float:
    """Card memory an offload executor keeps its blocks resident in (GB);
    the blocks past it stream from the host. The default is the JAX
    package's, sized there for a TPU chip."""
    return _read("CDT_OFFLOAD_RESIDENT_GB", 13.0, float)


def offload_stream_dtype() -> str:
    """``float8_e4m3fn`` (block matrices quantised, one scale per output
    channel) or ``native`` (every leaf as it is)."""
    return _read("CDT_OFFLOAD_STREAM_DTYPE", F8_NAME, stream_dtype_name)


def offload_ladder() -> str:
    """How a fully resident offload executor runs its ladder: ``jit``
    (any sampler, interruptible only at the expert boundary) or ``step``
    (euler, checked for an interrupt before every step)."""
    def parse(raw: str) -> str:
        if raw not in ("jit", "step"):
            raise ValueError("expected 'jit' or 'step'")
        return raw

    return _read("CDT_OFFLOAD_LADDER", "jit", parse)


def offload_cache_dir() -> Optional[str]:
    """Directory of the quantised-block cache (unset or empty: none)."""
    return _read("CDT_OFFLOAD_CACHE_DIR", None, str)


# --- step-granular preemption (cluster/preemption.py) ------------------------------


def preempt() -> bool:
    """Step-granular preemption: the serving sampler runs in resumable
    segments, and higher-priority work preempts the running job at the
    next segment boundary (0 = one uninterrupted run, no preemption)."""
    return _read("CDT_PREEMPT", True, _bool)


def preempt_segment_steps() -> int:
    """Denoise steps per resumable segment: the preemption granularity."""
    return _read("CDT_PREEMPT_SEGMENT_STEPS", 8, int)


def preempt_max() -> int:
    """Preemptions of one job past which it runs to completion (the
    starvation guard)."""
    return _read("CDT_PREEMPT_MAX", 4, int)


def preempt_resume_retries() -> int:
    """Restore attempts before a checkpoint is dead-lettered and its job
    restarts from scratch."""
    return _read("CDT_PREEMPT_RESUME_RETRIES", 2, int)


def preempt_sweep_s() -> float:
    """Cadence of the queued-deadline sweep in seconds (0 = off): a job
    whose deadline passes while queued goes ``expired`` within one sweep."""
    return _read("CDT_PREEMPT_SWEEP_S", 0.5, float)


def ckpt_mem_bytes() -> int:
    """In-memory latent-checkpoint store cap (bytes, LRU; the entry being
    resumed is pinned)."""
    return _read("CDT_CKPT_MEM_BYTES", 512 * 1024 * 1024, int)


def ckpt_dir() -> Optional[str]:
    """Persisted checkpoint tier directory (checksummed sidecar files;
    unset or empty: memory only)."""
    return _read("CDT_CKPT_DIR", None, str)


# --- the shape catalog and warmup (cluster/shape_catalog.py, diffusion/warmup.py)


def shape_catalog() -> Optional[str]:
    """Shape-catalog JSON path (default ``CDT_OUTPUT_DIR/
    shape_catalog_torch.json``)."""
    return _read("CDT_SHAPE_CATALOG", None, str)


def shape_observe() -> bool:
    """Record the request path's program shapes into the catalog."""
    return _read("CDT_SHAPE_OBSERVE", True, _bool)


def shape_catalog_max() -> int:
    """Cap on the catalog's size under runtime observation (each entry is
    warmed on every future boot); empty or 0 = uncapped."""
    raw = os.environ.get("CDT_SHAPE_CATALOG_MAX")
    if raw is not None and not raw.strip():
        return 0
    return _read("CDT_SHAPE_CATALOG_MAX", 128, int)


def warmup() -> bool:
    """Warm the shape catalog's programs when the controller boots (the
    health probe reports cold, warming, ready or error)."""
    return _read("CDT_WARMUP", False, _bool)


def warmup_models() -> str:
    """Comma list of the models a warm pass may build ('all' or '*': every
    model of the catalog; empty: the loaded and the tiny presets)."""
    return _read("CDT_WARMUP_MODELS", "", str)



# --- the elastic fleet (cluster/elastic) -------------------------------------------


def autoscale() -> bool:
    """The autoscaler's policy loop (off by default)."""
    return _read("CDT_AUTOSCALE", False, _bool)


def scale_provider() -> str:
    """``module:factory`` of a custom ScaleProvider; empty: the local
    process provider."""
    return _read("CDT_SCALE_PROVIDER", "", str)


def steal_seed() -> int:
    """Seed of the cross-job steal scheduler's tie-breaks."""
    return _read("CDT_STEAL_SEED", 0, int)


def drain_deadline_s() -> float:
    """Seconds a draining worker may keep its held work before the
    handback."""
    return _read("CDT_DRAIN_DEADLINE_S", 120.0, float)


def autoscale_interval_s() -> float:
    """Seconds between the autoscaler's evaluations."""
    return _read("CDT_AUTOSCALE_INTERVAL_S", 5.0, float)


def autoscale_min() -> int:
    """The fleet envelope's floor (managed workers)."""
    return _read("CDT_AUTOSCALE_MIN", 0, int)


def autoscale_max() -> int:
    """The fleet envelope's ceiling (managed workers)."""
    return _read("CDT_AUTOSCALE_MAX", 4, int)


def autoscale_up_depth() -> float:
    """Pressure (work a capacity unit) at or above which the fleet scales
    up."""
    return _read("CDT_AUTOSCALE_UP_DEPTH", 4.0, float)


def autoscale_down_depth() -> float:
    """Pressure at or below which the fleet scales down."""
    return _read("CDT_AUTOSCALE_DOWN_DEPTH", 0.5, float)


def autoscale_up_streak() -> int:
    """Evaluations in a row over the up depth before a scale-up."""
    return _read("CDT_AUTOSCALE_UP_STREAK", 2, int)


def autoscale_down_streak() -> int:
    """Evaluations in a row under the down depth before a scale-down."""
    return _read("CDT_AUTOSCALE_DOWN_STREAK", 4, int)


def autoscale_up_cooldown_s() -> float:
    """Least seconds between two scale-ups."""
    return _read("CDT_AUTOSCALE_UP_COOLDOWN_S", 30.0, float)


def autoscale_down_cooldown_s() -> float:
    """Least seconds between two scale-downs (removing capacity is
    reluctant)."""
    return _read("CDT_AUTOSCALE_DOWN_COOLDOWN_S", 120.0, float)

# --- the device mesh (parallel/) ----------------------------------------------

# mesh axis names, the JAX package's
AXIS_DATA = "dp"
AXIS_TENSOR = "tp"
AXIS_SEQUENCE = "sp"
COLLECTIVE_QUANT_MODES = ("none", "int8")


def mesh_devices() -> Optional[int]:
    """A launched worker's mesh: this many devices over ``dp`` (set from
    its host entry's ``mesh_devices``; wins over the config's shape)."""
    return _read("CDT_MESH_DEVICES", None, int)


def virtual_devices() -> Optional[int]:
    """Mesh ranks over the devices there are: ``n`` ranks on the one
    card (or on the CPU), the counterpart of XLA's virtual devices."""
    return _read("CDT_VIRTUAL_DEVICES", None, int)


def coordinator() -> Optional[str]:
    """Multi-host: the ``HOST:PORT`` of host 0's rendezvous store."""
    return _read("CDT_COORDINATOR", None, str)


def num_hosts() -> Optional[int]:
    """Multi-host: the number of host processes."""
    return _read("CDT_NUM_HOSTS", None, int)


def host_index() -> Optional[int]:
    """Multi-host: this host's process index (0 serves)."""
    return _read("CDT_HOST_INDEX", None, int)


def mesh_secret() -> Optional[str]:
    """The key that signs the mesh's call messages: the same on every host
    under ``serve --coordinator``; a local mesh gives its followers a
    fresh one of its own."""
    return _read("CDT_MESH_SECRET", None, str)


def mesh_tier() -> bool:
    """The mesh placement planner (0: flat ``dp`` always)."""
    return _read("CDT_MESH_TIER", True, _bool)


def mesh_tp() -> int:
    """A pinned ``tp`` degree for the placement planner (0: derive)."""
    return _read("CDT_MESH_TP", 0, int)


def collective_quant() -> str:
    """Wire format of ring attention's rotating K/V: ``none`` (exact) or
    ``int8``."""
    def parse(raw: str) -> str:
        if raw not in COLLECTIVE_QUANT_MODES:
            raise ValueError(f"expected one of {COLLECTIVE_QUANT_MODES}")
        return raw

    return _read("CDT_COLLECTIVE_QUANT", "none", parse)


def ring_block() -> int:
    """Key sub-block of one ring-attention hop (0: the whole hop)."""
    return _read("CDT_RING_BLOCK", 1024, int, lenient=True)


# --- tiles ---------------------------------------------------------------------


def tiles_per_device() -> int:
    """Tiles per dispatch of the tile engine (0 = computed)."""
    return _read("CDT_TILES_PER_DEVICE", 0, int, lenient=True)


def tile_master_holdback_s() -> float:
    """Seconds the tile master leaves the queue to workers before it
    competes for tasks itself (0 = off)."""
    return _read("CDT_TILE_MASTER_HOLDBACK_S", 0.0, float)


def tile_ready_polls() -> int:
    """Polls (one a second) while a worker waits for a tile job."""
    return _read("CDT_TILE_READY_POLLS", 120, int, lenient=True)


# --- video VAE decode ------------------------------------------------------------


def vae_tile_threshold() -> int:
    """Latent frame area (h·w) past which a 3D VAE decode tiles spatially
    (0 = always whole-frame)."""
    return _read("CDT_VAE_TILE_THRESHOLD", 48 * 48, int)


def vae_tile() -> int:
    """Tile edge of the tiled VAE decode, in latent pixels."""
    return _read("CDT_VAE_TILE", 32, int)


def vae_tile_overlap() -> int:
    """Overlap of neighbouring decode tiles, in latent pixels."""
    return _read("CDT_VAE_TILE_OVERLAP", 8, int)


# --- worker processes (workers/, the launcher's environment) -------------------
# The standalone watchdog (workers/worker_monitor.py) reads CDT_MASTER_PID
# (default 0: no master to watch), CDT_MONITOR_POLL (2.0 s) and
# CDT_PID_FILE from its environment itself.


def master_port() -> str:
    """Master control-plane port a launched worker reports ready to."""
    return _read("CDT_MASTER_PORT", "", str)


def log_dir() -> str:
    """Directory of the per-worker log files."""
    return _read("CDT_LOG_DIR", "logs", str)


def log_file() -> str:
    """This process's log file (set by the launcher; ``local_log`` tails
    it)."""
    return _read("CDT_LOG_FILE", "", str)


# --- observability and the dashboard ---------------------------------------------


def profile_dir() -> str:
    """Where ``/distributed/profile`` traces are written (default
    ``cdt_profile`` in the temporary directory: ``/tmp/cdt_profile``
    unless ``TMPDIR`` says otherwise)."""
    import tempfile

    return _read("CDT_PROFILE_DIR",
                 os.path.join(tempfile.gettempdir(), "cdt_profile"), str)


def workflows_dir() -> Optional[str]:
    """Override of the shipped ``workflows/`` directory."""
    return _read("CDT_WORKFLOWS_DIR", None, str)


def telemetry() -> bool:
    """Kill switch of the telemetry subsystem, read once when it is
    imported. Unset: on; an empty value is off (the shell ``CDT_TELEMETRY=``
    idiom)."""
    raw = os.environ.get("CDT_TELEMETRY")
    if raw is None:
        return True
    if not raw.strip():
        return False
    return _read("CDT_TELEMETRY", True, _bool)


# --- tunnel (utils/tunnel.py) --------------------------------------------------


def tunnel_start_timeout() -> float:
    """Seconds to wait for cloudflared to print its URL."""
    return _read("CDT_TUNNEL_START_TIMEOUT", 30.0, float)


def cloudflared_version() -> Optional[str]:
    """cloudflared release to download ('latest' or a version; default:
    the pinned version)."""
    return _read("CDT_CLOUDFLARED_VERSION", None, str)


def cloudflared_sha256() -> Optional[str]:
    """Expected sha256 of the cloudflared download."""
    return _read("CDT_CLOUDFLARED_SHA256", None, str)


def cloudflared_auto_download() -> bool:
    """Allow downloading cloudflared when no binary is found."""
    return _read("CDT_CLOUDFLARED_AUTO_DOWNLOAD", True, _bool)
