"""Workload mining: fold journal history into a replayable model.

The port's own copy of ``igneous_tpu/observability/replay.py``: either
package's journal mines to the same model, and either package reads the
other's saved model.

The journal records everything a capacity model needs — per-task
spans with durations/attempts/errors, per-round lease overhead, device
transfer byte counts, per-worker latency spread — but nothing reads it
*forward* in time. :class:`WorkloadModel` is that forward view: empirical
per-task-type distributions mined from journal records (raw segments or
rollups interchangeably, since rollups keep task spans verbatim), small
enough to serialize next to the journal and deterministic enough to seed
the fleet simulator (:mod:`.sim`).

What gets mined:

* **durations** — per task type, error-free deliveries only, as a capped
  empirical sample list (the simulator bootstraps draws from it, so
  straggler *tails* survive — no parametric fit to hide them);
* **retry probability** — failed deliveries / total deliveries per type
  (the journal's ``error`` spans ARE the empirical failure process);
* **bytes moved** — h2d/d2h transfer spans and storage get/put byte
  attrs, attributed to task types through each span's trace id;
* **round overhead** — ``lease.acquire`` spans (queue interaction time
  per lease round, recorded by the lease batcher) so batched campaigns
  simulate queue costs, not just compute;
* **worker speed spread** — per-worker median vs fleet median, so a
  simulated fleet replays the real fleet's heterogeneity instead of N
  identical clones.

Everything is plain JSON (:meth:`to_dict`/:meth:`from_dict`,
:meth:`save`/:meth:`load` via CloudFiles) — a mined model is an artifact
you can commit, diff, and re-simulate months later.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

MODEL_VERSION = 1

# per-type duration sample cap: 4096 doubles keep a model file small
# (~32KB/type) while pinning p99 of any realistic campaign
DEFAULT_SAMPLE_CAP = 4096

# spans whose byte counts attribute data movement to the owning trace
_BYTE_SPAN_NAMES = ("device.h2d", "device.d2h")


def _percentile(sorted_vals: List[float], q: float) -> float:
  if not sorted_vals:
    return 0.0
  idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
  return sorted_vals[idx]


class WorkloadModel:
  """Empirical fleet workload distributions mined from journal records."""

  def __init__(
    self,
    task_types: Optional[Dict[str, dict]] = None,
    round_overhead: Optional[dict] = None,
    worker_speeds: Optional[List[float]] = None,
    meta: Optional[dict] = None,
    range_sizes: Optional[List[int]] = None,
  ):
    # task_types[name] = {count, failures, sum, durs (sorted, capped),
    #                     bytes_per_task, max_attempt}
    self.task_types: Dict[str, dict] = task_types or {}
    # round_overhead = {count, sum, durs} from lease.acquire spans
    self.round_overhead: dict = round_overhead or {
      "count": 0, "sum": 0.0, "durs": [],
    }
    # range-lease spans per round, mined from the lease batcher's
    # ``range_sizes`` attr on lease.acquire; empty for
    # campaigns that ran per-task leases
    self.range_sizes: List[int] = list(range_sizes or [])
    # per-worker median_dur / fleet median_dur ratios (sorted): the
    # straggler-tail replay — a simulated worker's speed is one of these
    self.worker_speeds: List[float] = sorted(worker_speeds or [])
    self.meta: dict = meta or {}

  # -- mining ---------------------------------------------------------------

  @classmethod
  def mine(
    cls,
    records: Iterable[dict],
    sample_cap: int = DEFAULT_SAMPLE_CAP,
    window_sec: Optional[float] = None,
    now: Optional[float] = None,
  ) -> "WorkloadModel":
    """Fold journal records (``fleet.load_effective`` output — rollups
    and raw mix freely) into a model. ``window_sec`` restricts to spans
    ending after ``now - window_sec`` (None = all history)."""
    from . import fleet

    records = list(records)
    if now is None and window_sec is not None:
      now = max(
        (float(r.get("ts") or 0.0) + float(r.get("dur") or 0.0)
         for r in fleet.iter_task_spans(records)),
        default=0.0,
      )
    cutoff = (now - window_sec) if window_sec is not None else None

    types: Dict[str, dict] = {}
    trace_to_type: Dict[str, str] = {}
    per_worker_durs: Dict[str, List[tuple]] = defaultdict(list)
    overhead = {"count": 0, "sum": 0.0, "durs": []}
    range_sizes: List[int] = []

    def type_stats(name: str) -> dict:
      st = types.get(name)
      if st is None:
        st = types[name] = {
          "count": 0, "failures": 0, "sum": 0.0, "durs": [],
          "bytes": 0.0, "bytes_spans": 0, "max_attempt": 1,
        }
      return st

    for rec in fleet.iter_task_spans(records):
      ts, dur = rec.get("ts"), rec.get("dur")
      if ts is None or dur is None:
        continue
      if cutoff is not None and float(ts) + float(dur) < cutoff:
        continue
      name = rec.get("task", "?")
      st = type_stats(name)
      st["count"] += 1
      tid = rec.get("trace")
      if tid:
        trace_to_type[tid] = name
      attempt = rec.get("attempt")
      if attempt:
        st["max_attempt"] = max(st["max_attempt"], int(attempt))
      if rec.get("error"):
        st["failures"] += 1
        continue
      d = float(dur)
      st["sum"] += d
      if len(st["durs"]) < sample_cap:
        st["durs"].append(d)
      per_worker_durs[rec.get("worker", "local")].append((name, d))

    # second pass: byte movement + round overhead (non-task spans live
    # only in raw segments and rollup stage aggregates; bytes need the
    # per-span attrs, so they mine best before rollup GC)
    for rec in records:
      if rec.get("kind", "span") != "span":
        continue
      name = rec.get("name", "")
      if name == "lease.acquire":
        dur = rec.get("dur")
        if dur is None:
          continue
        overhead["count"] += 1
        overhead["sum"] += float(dur)
        if len(overhead["durs"]) < sample_cap:
          overhead["durs"].append(float(dur))
        sizes = rec.get("range_sizes")
        if isinstance(sizes, (list, tuple)):
          for s in sizes:
            if len(range_sizes) >= sample_cap:
              break
            range_sizes.append(int(s))
        continue
      if name in _BYTE_SPAN_NAMES:
        nbytes = rec.get("bytes")
        ttype = trace_to_type.get(rec.get("trace"))
        if nbytes and ttype:
          st = types[ttype]
          st["bytes"] += float(nbytes)
          st["bytes_spans"] += 1

    task_types = {}
    for name, st in types.items():
      st["durs"].sort()
      completed = len(st["durs"])
      task_types[name] = {
        "count": st["count"],
        "failures": st["failures"],
        "sum": round(st["sum"], 6),
        "durs": [round(d, 6) for d in st["durs"]],
        "bytes_per_task": (
          round(st["bytes"] / completed, 1) if completed and st["bytes"]
          else None
        ),
        "max_attempt": st["max_attempt"],
      }
    overhead["sum"] = round(overhead["sum"], 6)
    overhead["durs"] = sorted(round(d, 6) for d in overhead["durs"])

    # worker speed compares SAME-TYPE durations only: on a heterogeneous
    # mix, a worker that happened to draw the quick task types is not a
    # faster machine (one downsample-heavy worker once mined as "84×
    # fleet speed" and poisoned every forecast built on the model). Each
    # worker's per-type median is normalized by the fleet median for
    # that type; its speed is the sample-count-weighted mean of ratios.
    fleet_type_median = {
      name: _percentile(t["durs"], 0.50)
      for name, t in task_types.items() if t["durs"]
    }
    speeds = []
    for samples in per_worker_durs.values():
      by_type: Dict[str, List[float]] = defaultdict(list)
      for name, d in samples:
        by_type[name].append(d)
      num = den = 0.0
      for name, durs in by_type.items():
        fm = fleet_type_median.get(name, 0.0)
        if fm <= 0 or len(durs) < 2:
          continue
        num += (_percentile(sorted(durs), 0.50) / fm) * len(durs)
        den += len(durs)
      if den:
        speeds.append(round(num / den, 4))

    return cls(
      task_types=task_types,
      round_overhead=overhead,
      worker_speeds=speeds,
      range_sizes=sorted(range_sizes),
      meta={
        "version": MODEL_VERSION,
        "tasks_seen": sum(t["count"] for t in task_types.values()),
        "workers_seen": len(per_worker_durs),
        "window_sec": window_sec,
      },
    )

  # -- queries --------------------------------------------------------------

  def total_tasks(self) -> int:
    return sum(t["count"] for t in self.task_types.values())

  def task_mix(self) -> Dict[str, int]:
    """Completed-delivery count per type — the campaign shape a default
    simulation replays (retries excluded: the simulator re-rolls its own
    failures from :meth:`fail_prob`)."""
    return {
      name: max(len(t["durs"]), 1) for name, t in self.task_types.items()
    }

  def clip_outliers(self, factor: float = 4.0) -> int:
    """Drop per-type duration samples beyond ``factor`` × the type
    median. A journal mined from a chaos run carries fault-inflated
    spans — a SIGSTOPped worker's interrupted task records the whole
    freeze inside its ``dur`` — and a forecast that injects the same
    fault through a ChaosSpec would double-count it. Returns the number
    of samples dropped; ``sum`` is re-derived from the survivors."""
    dropped = 0
    for t in self.task_types.values():
      durs = t.get("durs") or []
      if len(durs) < 4:
        continue
      median = durs[len(durs) // 2]   # durs are mined sorted
      if median <= 0:
        continue
      kept = [d for d in durs if d <= factor * median]
      if len(kept) == len(durs):
        continue
      dropped += len(durs) - len(kept)
      t["durs"] = kept
      t["sum"] = round(sum(kept), 6)
    return dropped

  def fail_prob(self, task_type: str) -> float:
    t = self.task_types.get(task_type)
    if not t or not t["count"]:
      return 0.0
    return t["failures"] / t["count"]

  def sample_duration(self, task_type: str, rng) -> float:
    """One bootstrap draw from the type's empirical distribution.
    Deterministic given a seeded ``random.Random`` — the simulator's
    bit-identical-rerun contract rides on this."""
    t = self.task_types.get(task_type)
    durs = t["durs"] if t else ()
    if not durs:
      return 1.0  # unmodeled type: a neutral unit task
    return durs[rng.randrange(len(durs))]

  def sample_round_overhead(self, rng) -> float:
    durs = self.round_overhead.get("durs") or ()
    if not durs:
      return 0.0
    return durs[rng.randrange(len(durs))]

  def sample_worker_speed(self, rng) -> float:
    """One draw from the mined per-worker speed spread (1.0 = fleet
    median; >1 = slower). Falls back to 1.0 for unmined fleets."""
    if not self.worker_speeds:
      return 1.0
    return self.worker_speeds[rng.randrange(len(self.worker_speeds))]

  def summary(self) -> dict:
    """Human-facing digest (`fleet simulate` header, sim-report.json)."""
    per_type = {}
    for name, t in sorted(self.task_types.items()):
      durs = t["durs"]
      per_type[name] = {
        "count": t["count"],
        "fail_prob": round(self.fail_prob(name), 4),
        "p50_ms": round(_percentile(durs, 0.50) * 1e3, 2),
        "p95_ms": round(_percentile(durs, 0.95) * 1e3, 2),
        "p99_ms": round(_percentile(durs, 0.99) * 1e3, 2),
        "mean_ms": (
          round(t["sum"] / len(durs) * 1e3, 2) if durs else None
        ),
        "bytes_per_task": t.get("bytes_per_task"),
      }
    od = self.round_overhead.get("durs") or []
    return {
      "tasks_seen": self.total_tasks(),
      "task_types": per_type,
      "round_overhead_p50_ms": round(_percentile(od, 0.50) * 1e3, 2),
      "worker_speed_spread": self.worker_speeds,
    }

  # -- serialization --------------------------------------------------------

  def to_dict(self) -> dict:
    return {
      "version": MODEL_VERSION,
      "task_types": self.task_types,
      "round_overhead": self.round_overhead,
      "worker_speeds": self.worker_speeds,
      "range_sizes": self.range_sizes,
      "meta": self.meta,
    }

  @classmethod
  def from_dict(cls, d: dict) -> "WorkloadModel":
    ver = d.get("version", 0)
    if ver > MODEL_VERSION:
      raise ValueError(
        f"workload model version {ver} is newer than this reader "
        f"({MODEL_VERSION}); upgrade igneous_tpu_torch"
      )
    return cls(
      task_types=d.get("task_types") or {},
      round_overhead=d.get("round_overhead"),
      worker_speeds=d.get("worker_speeds"),
      # models mined before range leases have no range_sizes; default to none mined
      range_sizes=d.get("range_sizes"),
      meta=d.get("meta"),
    )

  def save(self, cloudpath: str, key: str = "workload_model.json") -> str:
    from ..storage import CloudFiles

    CloudFiles(cloudpath).put(
      key, json.dumps(self.to_dict()).encode("utf8"), compress=None,
    )
    return key

  @classmethod
  def load(cls, cloudpath: str,
           key: str = "workload_model.json") -> "WorkloadModel":
    from ..storage import CloudFiles

    data = CloudFiles(cloudpath).get(key)
    if data is None:
      raise FileNotFoundError(f"{cloudpath}/{key}")
    return cls.from_dict(json.loads(data.decode("utf8")))


def mine_journal(journal_path: str, **kw) -> WorkloadModel:
  """Mine a journal path directly (rollups + uncovered raw segments —
  the `igneous fleet simulate --from-journal` entry point)."""
  from . import fleet

  return WorkloadModel.mine(fleet.load_effective(journal_path), **kw)
