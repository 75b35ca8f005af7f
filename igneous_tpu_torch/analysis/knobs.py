"""The port's one ``IGNEOUS_*`` knob registry.

The port's copy of ``igneous_tpu/analysis/knobs.py``: every environment
knob the port reads is declared here once, with its type, default,
operator-facing doc and README section. Knobs the two packages share keep
the JAX package's name, type and default; ``IGNEOUS_TORCH_DEVICE`` is the
port's own. This module is the only one of the port that reads
``os.environ`` for an ``IGNEOUS_*`` name: ``python -m igneous_tpu_torch
lint`` (pass IGN1, :mod:`.env_knobs`) refuses raw reads anywhere else,
and the port's README knob table is generated from this registry
(``lint --knobs-md --write``), between markers of its own.

Accessor semantics (the JAX registry's):

* unset or empty value: the registered default (``None`` means "derived
  where it is read", e.g. thread counts that follow the host's cores);
* unparseable number: the registered default (a bad knob never takes a
  worker down; strict knobs such as ``IGNEOUS_PAGE_SHAPE`` read
  :func:`raw` and keep their own parse and error);
* booleans: ``0``, ``off``, ``false`` and ``no`` (any case) are False,
  anything else set is True.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

Default = Union[str, int, float, bool, None]


@dataclass(frozen=True)
class Knob:
  name: str
  type: str          # "str" | "int" | "float" | "bool" | "shape"
  default: Default   # None = unset (doc explains what "unset" derives)
  doc: str
  section: str

  @property
  def default_str(self) -> str:
    """Markdown rendering of the default."""
    if self.default is None:
      return "unset"
    if self.type == "bool":
      return "on" if self.default else "off"
    if isinstance(self.default, float) and self.default.is_integer():
      return str(int(self.default))
    return str(self.default) if self.default != "" else "auto"


_REGISTRY: Dict[str, Knob] = {}

# section display order for the generated README table
SECTIONS = (
  "pipeline", "chunk cache", "device kernels", "paged batching",
  "compile cache / autotune",
  "multihost", "worker lifecycle", "retry", "queue", "campaign survival",
  "storage", "integrity", "serve",
  "journal", "trace / metrics / profile", "health / SLO", "autoscale",
  "simulator", "misc",
)


def _knob(name: str, type: str, default: Default, doc: str,
          section: str) -> None:
  assert name.startswith("IGNEOUS_"), name
  assert name not in _REGISTRY, f"duplicate knob {name}"
  assert section in SECTIONS, section
  _REGISTRY[name] = Knob(name, type, default, doc, section)


# --- pipeline --------------------------------------------------------------
_knob('IGNEOUS_PIPELINE', 'str', 'auto',
      'staged-pipeline master switch: `on|off|auto` (auto: task *streams* pipeline, solo task execution stays serial)', 'pipeline')
_knob('IGNEOUS_PIPELINE_MEM_MB', 'float', None,
      'stage-buffer byte budget in MB; unset derives 2x the downsample memory target', 'pipeline')
_knob('IGNEOUS_PIPELINE_PREFETCH', 'int', 2,
      'max cutouts downloading ahead of compute', 'pipeline')
_knob('IGNEOUS_PIPELINE_THREADS', 'str', 'auto',
      'force stage-overlap threading `1|0`; auto follows the host (single-core degrades to in-order)', 'pipeline')
_knob('IGNEOUS_PIPELINE_IO_THREADS', 'int', None,
      'download/decode pool width; unset = min(8, cores*2)', 'pipeline')
_knob('IGNEOUS_PIPELINE_ENCODE_THREADS', 'int', None,
      'encode/upload pool width; unset = min(8, cores)', 'pipeline')

# --- chunk cache -----------------------------------------------------------
_knob('IGNEOUS_CHUNK_CACHE', 'str', 'auto',
      'shared decoded-chunk cache switch: `on|off|auto` (auto = on)', 'chunk cache')
_knob('IGNEOUS_CHUNK_CACHE_MB', 'float', None,
      'cache byte budget in MB; unset = pipeline budget / 8', 'chunk cache')

# --- device kernels --------------------------------------------------------
_knob('IGNEOUS_TORCH_DEVICE', 'str', 'cuda',
      "the port's device: `cuda`, `cuda:N` or `cpu` (without CUDA only `cpu` runs)", 'device kernels')
_knob('IGNEOUS_CCL_TILE', 'str', '',
      'tile of `tile_resolve` `tz,ty,tx` (auto when unset)', 'device kernels')

# --- paged batching --------------------------------------------------------
_knob('IGNEOUS_PAGE_SHAPE', 'shape', '32,32,32',
      'fixed device page shape `pz,py,px`; divides every standard mip factor chain', 'paged batching')
_knob('IGNEOUS_PAGE_BATCH', 'int', 32,
      'pages per round (rounded up to a power of two)', 'paged batching')

# --- compile cache / autotune ----------------------------------------------
_knob('IGNEOUS_COMPILE_CACHE', 'str', None,
      'library store root (`gs://…`|`file://…`): workers fetch built kernel libraries instead of compiling them; unset disables', 'compile cache / autotune')
_knob('IGNEOUS_TUNE_CONFIG', 'str', None,
      'tuned-config root override; unset reads `tuned/<device_kind>.json` under IGNEOUS_COMPILE_CACHE (knob resolution: explicit env > tuned config > registry default)', 'compile cache / autotune')
_knob('IGNEOUS_TUNE_BUDGET_SEC', 'float', None,
      '`igneous tune` wall-clock budget in seconds; unset sweeps every candidate', 'compile cache / autotune')
_knob('IGNEOUS_TUNE_REPEATS', 'int', 2,
      'timed repeats per tune candidate (best-of)', 'compile cache / autotune')

# --- multihost -------------------------------------------------------------
_knob('IGNEOUS_COORDINATOR', 'str', None,
      'torch.distributed rendezvous `host:port` or `tcp://host:port`; unset = `env://` (torchrun)', 'multihost')
_knob('IGNEOUS_NUM_PROCESSES', 'int', None,
      'pod ranks (the world size); unset = `env://`\'s `WORLD_SIZE`', 'multihost')
_knob('IGNEOUS_PROCESS_ID', 'int', None,
      "this process's rank in the pod; unset = `env://`'s `RANK`", 'multihost')

# --- worker lifecycle ------------------------------------------------------
_knob('IGNEOUS_HEARTBEAT_SEC', 'float', None,
      'lease-renewal interval; unset = lease/3, 0 disables renewal', 'worker lifecycle')
_knob('IGNEOUS_PREEMPT_SENTINEL', 'str', None,
      'file path whose appearance triggers a graceful drain', 'worker lifecycle')
_knob('IGNEOUS_PREEMPT_URL', 'str', None,
      'metadata endpoint polled for preemption notice', 'worker lifecycle')
_knob('IGNEOUS_PREEMPT_POLL_SEC', 'float', 1.0,
      'preemption poll cadence', 'worker lifecycle')

# --- retry -----------------------------------------------------------------
_knob('IGNEOUS_RETRY_ATTEMPTS', 'int', 6,
      'total attempts incl. the first (1 = no retries)', 'retry')
_knob('IGNEOUS_RETRY_BASE_S', 'float', 0.25,
      'first backoff delay (exponential, full jitter)', 'retry')
_knob('IGNEOUS_RETRY_CAP_S', 'float', 30.0,
      'max single backoff delay', 'retry')
_knob('IGNEOUS_RETRY_BUDGET_S', 'float', 120.0,
      'total sleep budget per operation', 'retry')

# --- queue -----------------------------------------------------------------
_knob('IGNEOUS_QUEUE_SHARDS', 'int', 16,
      'segment files a known-total `insert_batch` spreads across (lease-contention fan-out)', 'queue')
_knob('IGNEOUS_QUEUE_SEG_TASKS', 'int', 1024,
      'max tasks per fq:// segment file; 0 = classic one-file-per-task layout', 'queue')
_knob('IGNEOUS_QUEUE_RECYCLE_SEC', 'float', 5.0,
      'min interval between expired-lease scans on lease(); 0 scans every call (forced when the pending pool looks drained)', 'queue')

# --- campaign survival -----------------------------------------------------
_knob('IGNEOUS_SPECULATE_MIN_TASKS', 'int', 1,
      'smallest range-lease tail worth double-issuing as a speculative twin', 'campaign survival')
_knob('IGNEOUS_SPECULATE_MAX_TWINS', 'int', 4,
      'max new speculation pairs per `speculate_flagged` sweep', 'campaign survival')
_knob('IGNEOUS_SPECULATE_MIN_HELD_SEC', 'float', 0.0,
      "a flagged worker's lease must be at least this old before its tail is twinned", 'campaign survival')
_knob('IGNEOUS_SPECULATE_TAIL_RATIO', 'float', 1.5,
      'campaign runner: speculate a lease whose projected finish (tail size / holder rate) exceeds ratio x the fleet p95 projection', 'campaign survival')
_knob('IGNEOUS_SPECULATE_WASTE_MAX', 'float', 0.5,
      '`speculation_storm` health anomaly: fenced/issued wasted-work ratio ceiling', 'campaign survival')
_knob('IGNEOUS_SPECULATE_MIN_ISSUED', 'int', 8,
      'min issued speculations before the storm detector fires', 'campaign survival')
_knob('IGNEOUS_STEAL', 'bool', False,
      'idle lease-batcher workers claim unstarted sub-ranges off long-held range leases (pull-model work stealing)', 'campaign survival')
_knob('IGNEOUS_STEAL_MIN_TASKS', 'int', 2,
      'smallest unstarted tail a holder will grant (and the smallest foreign range a thief will claim)', 'campaign survival')
_knob('IGNEOUS_STEAL_MIN_HELD_SEC', 'float', 2.0,
      'a range must be held this long before a thief may claim it', 'campaign survival')
_knob('IGNEOUS_STEAL_FRACTION', 'float', 0.5,
      "fraction of the holder's unstarted tail a serviced claim releases", 'campaign survival')
_knob('IGNEOUS_STEAL_CLAIM_TTL_SEC', 'float', 300.0,
      'unserviced steal claims recycle after this long (holder died before its heartbeat saw the claim)', 'campaign survival')
_knob('IGNEOUS_CAMPAIGN_TICK_SEC', 'float', 5.0,
      '`igneous campaign run` control-loop period', 'campaign survival')
_knob('IGNEOUS_CAMPAIGN_MAX_WALL_SEC', 'float', 0.0,
      'campaign runner wall-clock safety valve (0 = unlimited)', 'campaign survival')
_knob('IGNEOUS_CAMPAIGN_SPECULATE', 'bool', True,
      'campaign runner double-issues flagged/slow-tail leases', 'campaign survival')

# --- storage ---------------------------------------------------------------
_knob('IGNEOUS_SCRATCH_COMPRESS', 'str', '',
      'scratch-layer codec fleet-wide: `gzip-1..9|gzip|zstd|none` (unset keeps bytes identical to previous releases)', 'storage')
_knob('IGNEOUS_S3_MULTIPART_THRESHOLD', 'int', 67108864,
      'objects >= this many bytes use S3 multipart upload', 'storage')
_knob('IGNEOUS_S3_MULTIPART_CHUNK', 'int', 33554432,
      'S3 multipart part size in bytes', 'storage')
_knob('IGNEOUS_GCS_RESUMABLE_THRESHOLD', 'int', 8388608,
      'objects >= this many bytes use a GCS resumable session', 'storage')
_knob('IGNEOUS_GCS_UPLOAD_CHUNK', 'int', 8388608,
      'GCS resumable-upload chunk size in bytes', 'storage')
_knob('IGNEOUS_TRANSFER_PASSTHROUGH', 'bool', True,
      '`0|off` forces eligible transfers down the decode/re-encode path (debug + bench A/B)', 'storage')

# --- integrity -------------------------------------------------------------
_knob('IGNEOUS_INTEGRITY', 'bool', True,
      'checksummed write envelope: record a blake2b digest of every stored task-output object into `integrity/` manifest sidecars (`0|off` restores the bytes-only write path)', 'integrity')
_knob('IGNEOUS_INTEGRITY_BATCH', 'int', 256,
      'manifest records buffered per layer before a write-once JSONL segment is flushed', 'integrity')
_knob('IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE', 'bool', False,
      'read every put back and compare digests before it returns (turns a torn write into an immediate, retryable task failure)', 'integrity')
_knob('IGNEOUS_INTEGRITY_SERVE_VERIFY', 'bool', True,
      'serve fill path: validate the wire compression of an origin fetch before admitting it to any cache tier', 'integrity')
_knob('IGNEOUS_INTEGRITY_SSD_VERIFY', 'bool', True,
      'serve SSD tier: spot-verify stored-byte digests on SSD->RAM promotion for entries seeded from a restart index scan', 'integrity')

# --- serve -----------------------------------------------------------------
_knob('IGNEOUS_SERVE_RAM_MB', 'float', 256.0,
      'RAM cache budget', 'serve')
_knob('IGNEOUS_SERVE_SSD_DIR', 'str', None,
      'local-SSD spill directory (unset disables the SSD tier)', 'serve')
_knob('IGNEOUS_SERVE_SSD_MB', 'float', 4096.0,
      'SSD spill budget', 'serve')
_knob('IGNEOUS_SERVE_CACHE_CONTROL', 'str', 'public, max-age=300',
      'Cache-Control header on responses', 'serve')
_knob('IGNEOUS_SERVE_SYNTH_MIPS', 'bool', True,
      'synthesize unmaterialized mips on the fly', 'serve')
_knob('IGNEOUS_SERVE_WRITEBACK', 'bool', False,
      'persist synthesized mips back to storage', 'serve')
_knob('IGNEOUS_SERVE_MAX_OBJECT_MB', 'float', 64.0,
      'largest object served/cached', 'serve')
_knob('IGNEOUS_SERVE_IO_THREADS', 'int', 16,
      'backend fetch pool width', 'serve')
_knob('IGNEOUS_SERVE_DRAIN_SEC', 'float', 30.0,
      'SIGTERM drain deadline for in-flight responses', 'serve')
_knob('IGNEOUS_SERVE_FLEET_PEERS', 'str', None,
      'comma-separated replica base URLs: static federation ring membership (unset + no membership dir = federation off)', 'serve')
_knob('IGNEOUS_SERVE_FLEET_MEMBERSHIP', 'str', None,
      'shared membership directory cloudpath: replicas heartbeat + discover the ring here (dynamic join/leave)', 'serve')
_knob('IGNEOUS_SERVE_FLEET_SELF', 'str', None,
      "this replica's advertised base URL (default derived from the bound host/port)", 'serve')
_knob('IGNEOUS_SERVE_FLEET_TTL_SEC', 'float', 15.0,
      'membership heartbeat TTL; silent replicas leave the ring', 'serve')
_knob('IGNEOUS_SERVE_FLEET_TIMEOUT_MS', 'float', 2000.0,
      'peer-fill HTTP timeout before falling back to origin', 'serve')
_knob('IGNEOUS_SERVE_FLEET_RETRY_SEC', 'float', 10.0,
      'dead-peer quarantine before peer fills retry that replica', 'serve')
_knob('IGNEOUS_SERVE_PREWARM', 'bool', False,
      'telemetry-driven prefetch of predicted-hot chunks mined from journal request traces', 'serve')
_knob('IGNEOUS_SERVE_PREWARM_INTERVAL_SEC', 'float', 30.0,
      'prewarm cycle cadence (cycles are skipped while requests are in flight)', 'serve')
_knob('IGNEOUS_SERVE_PREWARM_TOP', 'int', 16,
      'hottest mined chunks whose neighbors/children are predicted per cycle', 'serve')
_knob('IGNEOUS_SERVE_PREWARM_BUDGET', 'int', 64,
      'max prefetch fetches per prewarm cycle', 'serve')
_knob('IGNEOUS_SERVE_QOS_RPS', 'float', 0.0,
      'global admission rate (requests/s) split across layers by QoS weight; 0 disables load shedding', 'serve')
_knob('IGNEOUS_SERVE_QOS_WEIGHTS', 'str', None,
      "per-layer QoS weights as 'layer=weight,...'; unlisted layers weigh 1", 'serve')
_knob('IGNEOUS_SERVE_QOS_BURST_SEC', 'float', 2.0,
      "token-bucket depth in seconds of each layer's admission rate", 'serve')

# --- journal ---------------------------------------------------------------
_knob('IGNEOUS_JOURNAL', 'str', None,
      'journal cloudpath override (fq:// queues default to a `journal/` sibling; SQS fleets need this set)', 'journal')
_knob('IGNEOUS_JOURNAL_FLUSH_SEC', 'float', 30.0,
      'journal segment flush interval', 'journal')
_knob('IGNEOUS_JOURNAL_COMPRESS', 'bool', False,
      'gzip journal segments (read side sniffs magic bytes, mixed fleets fine)', 'journal')
_knob('IGNEOUS_JOURNAL_RETAIN', 'float', 3600.0,
      '`fleet gc` retention for raw segments already folded into rollups', 'journal')
_knob('IGNEOUS_ROLLUP_WINDOW_SEC', 'float', 60.0,
      'rollup window width', 'journal')
_knob('IGNEOUS_ROLLUP_MAX_SAMPLES', 'int', 512,
      'duration samples kept per rollup window', 'journal')
_knob('IGNEOUS_ROLLUP_EVERY', 'int', 16,
      'worker self-compaction cadence in segments (0 disables)', 'journal')

# --- trace / metrics / profile ---------------------------------------------
_knob('IGNEOUS_TRACE_SAMPLE', 'float', 1.0,
      'span sampling rate (0 disables tracing)', 'trace / metrics / profile')
_knob('IGNEOUS_METRICS_PORT', 'int', None,
      'Prometheus /metrics port (0 = OS-assigned; unset disables)', 'trace / metrics / profile')
_knob('IGNEOUS_METRICS_TEXTFILE', 'str', None,
      'node-exporter textfile collector path', 'trace / metrics / profile')
_knob('IGNEOUS_PROFILE_DIR', 'str', None,
      'torch.profiler capture directory (unset = profiling inert)', 'trace / metrics / profile')
_knob('IGNEOUS_TPU_PROFILE_DIR', 'str', None,
      'legacy alias of `IGNEOUS_PROFILE_DIR`', 'trace / metrics / profile')
_knob('IGNEOUS_PROFILE_EVERY', 'int', 0,
      'sample a capture every Nth device dispatch (0 disables)', 'trace / metrics / profile')
_knob('IGNEOUS_PROFILE_SEC', 'float', 2.0,
      'sampled-capture duration', 'trace / metrics / profile')

# --- health / SLO ----------------------------------------------------------
_knob('IGNEOUS_HEALTH_WINDOW_SEC', 'float', 600.0,
      'analysis window for rates/SLO', 'health / SLO')
_knob('IGNEOUS_HEALTH_STRAGGLER_RATIO', 'float', 3.0,
      'worker p95 >= ratio x fleet median', 'health / SLO')
_knob('IGNEOUS_HEALTH_STRAGGLER_MIN_TASKS', 'int', 3,
      'min samples per side for the straggler detector', 'health / SLO')
_knob('IGNEOUS_HEALTH_STALL_SEC', 'float', 120.0,
      'journal silence => liveness straggler', 'health / SLO')
_knob('IGNEOUS_HEALTH_FORGET_SEC', 'float', 3600.0,
      'silent workers forgotten entirely', 'health / SLO')
_knob('IGNEOUS_HEALTH_DLQ_RATE', 'float', 0.05,
      'DLQ promotions / executions ceiling', 'health / SLO')
_knob('IGNEOUS_HEALTH_RETRY_RATE', 'float', 1.0,
      'retries / executions ceiling', 'health / SLO')
_knob('IGNEOUS_HEALTH_ZOMBIE_RATE', 'float', 0.5,
      'zombie fences / executions ceiling', 'health / SLO')
_knob('IGNEOUS_HEALTH_STALL_RATIO', 'float', 0.9,
      'throughput-regression detector', 'health / SLO')
_knob('IGNEOUS_HEALTH_RECOMPILES_PER_MIN', 'float', 10.0,
      'recompile-storm ceiling (the port compiles no signatures)', 'health / SLO')
_knob('IGNEOUS_HEALTH_HBM_FRAC', 'float', 0.9,
      'HBM high-water fraction', 'health / SLO')
_knob('IGNEOUS_HEALTH_DEVICE_IDLE_RATIO', 'float', 0.05,
      'busy-ratio floor while the queue has backlog', 'health / SLO')
_knob('IGNEOUS_SLO_SUCCESS', 'float', 0.99,
      'task success-rate SLO', 'health / SLO')
_knob('IGNEOUS_SLO_P95_MS', 'float', None,
      'optional p95 task-latency SLO', 'health / SLO')
_knob('IGNEOUS_SERVE_SLO_P99_MS', 'float', None,
      'optional p99 serve-latency SLO', 'health / SLO')
_knob('IGNEOUS_SERVE_PEER_FAIL_RATIO', 'float', 0.5,
      'peer-fill failure-storm ceiling (fallbacks / peer attempts)', 'health / SLO')
_knob('IGNEOUS_SERVE_PEER_MIN', 'int', 8,
      'min peer-fill attempts before the failure-storm detector fires', 'health / SLO')
_knob('IGNEOUS_SERVE_SHED_RATIO', 'float', 0.2,
      'shed-rate SLO ceiling (sheds / offered requests)', 'health / SLO')
_knob('IGNEOUS_SERVE_MISS_RATIO', 'float', 0.9,
      'cold-miss-storm: backend-fetch fraction ceiling', 'health / SLO')
_knob('IGNEOUS_SERVE_MIN_REQUESTS', 'int', 50,
      'min in-window requests before serve detectors fire', 'health / SLO')
_knob('IGNEOUS_HEALTH_INTEGRITY_MAX', 'float', 0.0,
      'corrupt-read / failed-verify / quarantine count ceiling (default: any corruption is an anomaly)', 'health / SLO')

# --- autoscale -------------------------------------------------------------
_knob('IGNEOUS_AUTOSCALE_MIN', 'int', 1,
      'worker floor (0 = scale-to-zero)', 'autoscale')
_knob('IGNEOUS_AUTOSCALE_MAX', 'int', 1000,
      'worker ceiling', 'autoscale')
_knob('IGNEOUS_AUTOSCALE_HORIZON_SEC', 'float', 600.0,
      'drain the backlog within this many seconds', 'autoscale')
_knob('IGNEOUS_AUTOSCALE_HYSTERESIS', 'float', 0.2,
      'no-change band around the current worker count', 'autoscale')
_knob('IGNEOUS_AUTOSCALE_COOLDOWN_SEC', 'float', 60.0,
      'min seconds between controller actions', 'autoscale')
_knob('IGNEOUS_AUTOSCALE_STEP_MAX', 'int', 0,
      'max +- workers per action (0 = uncapped)', 'autoscale')
_knob('IGNEOUS_AUTOSCALE_INTERVAL_SEC', 'float', 15.0,
      'controller tick period', 'autoscale')

# --- simulator -------------------------------------------------------------
_knob('IGNEOUS_SIM_WORKERS', 'int', 4,
      'virtual fleet size', 'simulator')
_knob('IGNEOUS_SIM_SEED', 'int', 0,
      'determinism seed', 'simulator')
_knob('IGNEOUS_SIM_BATCH', 'int', 1,
      'members per lease round', 'simulator')
_knob('IGNEOUS_SIM_LEASE_SEC', 'float', 60.0,
      'virtual lease duration', 'simulator')
_knob('IGNEOUS_SIM_MAX_DELIVERIES', 'int', 5,
      'DLQ threshold', 'simulator')
_knob('IGNEOUS_SIM_POLL_SEC', 'float', 2.0,
      'idle poll period', 'simulator')
_knob('IGNEOUS_SIM_WORKER_START_SEC', 'float', 5.0,
      'spawn -> first lease (autoscale adds)', 'simulator')
_knob('IGNEOUS_SIM_FAIL_SCALE', 'float', 1.0,
      'multiply mined failure probabilities', 'simulator')
_knob('IGNEOUS_SIM_MAX_SEC', 'float', 2592000.0,
      'simulated-time safety valve (30 days)', 'simulator')
_knob('IGNEOUS_SIM_RANGE_LEASE', 'int', 0,
      '1 = simulate range-lease rounds (one shared lease per batch); 0 = classic per-member leases', 'simulator')
_knob('IGNEOUS_SIM_SPECULATE', 'int', 0,
      '1 = model straggler speculation (duplicate-issue + first-ack-wins fencing) in range-lease mode', 'simulator')
_knob('IGNEOUS_SIM_STEAL', 'int', 0,
      '1 = model idle-worker steal splits of long-held ranges in range-lease mode', 'simulator')

# --- misc ------------------------------------------------------------------
_knob('IGNEOUS_TPU_SECRETS', 'str', None,
      'secrets directory; unset = `~/.cloudfiles/secrets`', 'misc')
_knob('IGNEOUS_RACE_CHECK', 'bool', False,
      'wrap `guarded-by`-annotated structures with lock-ownership asserts (dynamic companion of lint pass IGN3; on in the port\'s soak)', 'misc')


KNOBS: Dict[str, Knob] = dict(_REGISTRY)

_FALSE_WORDS = ("0", "off", "false", "no")


def _lookup(name: str) -> Knob:
  try:
    return _REGISTRY[name]
  except KeyError:
    raise KeyError(
      f"unregistered knob {name!r}: declare it in "
      "igneous_tpu_torch/analysis/knobs.py (lint enforces this)"
    ) from None


def raw(name: str) -> Optional[str]:
  """The value exactly as set (None when unset); no default applied. For
  call sites with a strict parse or a tri-state of their own."""
  _lookup(name)
  return os.environ.get(name)


def get_str(name: str) -> Optional[str]:
  knob = _lookup(name)
  val = os.environ.get(name)
  if val is None or val == "":
    d = knob.default
    return None if d is None else str(d)
  return val


def get_int(name: str) -> Optional[int]:
  knob = _lookup(name)
  val = os.environ.get(name)
  if val is not None and val != "":
    try:
      return int(float(val))
    except ValueError:
      pass
  return None if knob.default is None else int(knob.default)


def get_float(name: str) -> Optional[float]:
  knob = _lookup(name)
  val = os.environ.get(name)
  if val is not None and val != "":
    try:
      return float(val)
    except ValueError:
      pass
  return None if knob.default is None else float(knob.default)


def opt_float(name: str) -> Optional[float]:
  """None when unset, empty or unparseable: for ``from_env`` builders
  where None keeps the dataclass field's default (equal to the
  registry's)."""
  _lookup(name)
  val = os.environ.get(name)
  if val is None or val == "":
    return None
  try:
    return float(val)
  except ValueError:
    return None


def get_bool(name: str) -> bool:
  knob = _lookup(name)
  val = os.environ.get(name)
  if val is None or val == "":
    return bool(knob.default)
  return val.strip().lower() not in _FALSE_WORDS


def set_env(name: str, value) -> None:
  """A registered write: set a knob for this process and the workers it
  spawns."""
  _lookup(name)
  os.environ[name] = str(value)


def del_env(name: str) -> None:
  """A registered unset: the tuner's sweep restores a knob to unset
  between candidates."""
  _lookup(name)
  os.environ.pop(name, None)


BEGIN_MARK = (
  "<!-- port-knob-table:begin (python -m igneous_tpu_torch lint --knobs-md) -->"
)
END_MARK = "<!-- port-knob-table:end -->"


def knobs_markdown() -> str:
  """The generated README table of the port's knobs (between the port's
  markers): sections in declaration order, knobs alphabetical within."""
  out = [
    BEGIN_MARK,
    "",
    "_Generated from `igneous_tpu_torch/analysis/knobs.py` by "
    "`python -m igneous_tpu_torch lint --knobs-md --write`; the port's "
    "lint fails if this table drifts from its registry. Do not edit by "
    "hand._",
    "",
  ]
  by_section: Dict[str, list] = {}
  for knob in _REGISTRY.values():
    by_section.setdefault(knob.section, []).append(knob)
  for section in SECTIONS:
    knobs = sorted(by_section.get(section, []), key=lambda k: k.name)
    if not knobs:
      continue
    out.append(f"**{section}**")
    out.append("")
    out.append("| Variable | Type | Default | Meaning |")
    out.append("|---|---|---|---|")
    for k in knobs:
      out.append(
        f"| `{k.name}` | {k.type} | {k.default_str} | {k.doc} |"
      )
    out.append("")
  out.append(END_MARK)
  return "\n".join(out) + "\n"
