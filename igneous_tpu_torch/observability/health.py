"""Closed-loop fleet health: detectors, SLO burn, autoscaler signal.

The journal and the fleet commands make the fleet visible; this module
makes the telemetry *actionable*. A :class:`HealthEngine` evaluates journal rollups + live
segments (``rollup.load_effective``) against a queue depth snapshot and
produces one structured report:

* **stragglers** — workers whose p95 task latency is a configurable
  multiple of the fleet median, and workers whose journal went silent
  (no flush for ``stall_sec``) while the queue still has backlog — the
  stalled workers chaos soaks deliberately inject;
* **anomalies** — DLQ/retry/zombie rates out of band, stall-ratio
  regressions, and a fully stalled journal (every writer silent with
  work remaining: the dead-journal-writer alert);
* **SLO burn** — task success rate (and optionally p95 latency) against
  a target, expressed as error-budget burn rate;
* **autoscale** — a desired-worker recommendation from backlog vs
  journal-derived per-worker throughput, hysteresis-damped so an HPA or
  cron consuming it doesn't flap.

The report fans out to every consumer the loop needs: Prometheus gauges
(``igneous_fleet_stragglers``, ``igneous_fleet_desired_workers``,
``igneous_slo_burn``) via :func:`publish_gauges`, structured ``health.*``
events appended to the journal via :func:`emit_events`, a
``health/flags.json`` straggler report that LeaseBatcher polls to
surrender pre-leases early, an exit-code-bearing ``igneous fleet check``
for CI/cron, and the live ``igneous fleet watch`` dashboard rendered by
:func:`render_dashboard`.

The port's own copy of ``igneous_tpu/observability/health.py``; its
reports, lines, flags and events are byte for byte the JAX package's on
the same records. On the card a recompile is a library build (an nvcc or
g++ run); a fetch from the library store is none.
"""

from __future__ import annotations

import json
import os
import socket
import time
from collections import defaultdict
from dataclasses import dataclass, fields
from typing import Iterable, List, Optional

from . import fleet, metrics

from .. import secrets as knobs

FLAGS_KEY = "health/flags.json"

# a worker's first compile of each kernel is churn-free startup, not a
# storm: the recompile-storm anomaly needs at least this many recompiles
# in the measured interval before the per-minute rate means anything
DEVICE_RECOMPILE_STORM_MIN = 10


@dataclass
class HealthConfig:
  """Detector thresholds; every field has an ``IGNEOUS_*`` env override
  (see :meth:`from_env`) so deployments tune without code."""

  # analysis window for latency/throughput/SLO (seconds of recent history)
  window_sec: float = 600.0
  # latency straggler: worker p95 >= ratio x fleet median, given at least
  # min_tasks samples on both sides
  straggler_ratio: float = 3.0
  straggler_min_tasks: int = 3
  # liveness straggler: no journal record from the worker for this long
  # while the queue still has backlog (clean drain/exit records exempt)
  stall_sec: float = 120.0
  # workers silent longer than this are forgotten entirely (a pod
  # replaced hours ago is history, not a straggler)
  forget_sec: float = 3600.0
  # anomaly rate ceilings, as fractions of observed task executions
  dlq_rate_max: float = 0.05
  retry_rate_max: float = 1.0
  zombie_rate_max: float = 0.5
  stall_ratio_max: float = 0.9
  # SLO: task success-rate target and optional p95 latency target
  slo_success: float = 0.99
  slo_p95_ms: Optional[float] = None
  # autoscaler: drain the backlog within horizon_sec at the observed
  # per-worker rate; recommendations within the hysteresis band of the
  # current worker count collapse to "no change"
  horizon_sec: float = 600.0
  hysteresis: float = 0.2
  min_workers: int = 1
  max_workers: int = 1000
  # device plane: recompile storm = sustained recompiles (the port's
  # library builds)
  # per minute above this (shape churn eating the compile cache); HBM
  # high-water = peak bytes over this fraction of the device limit;
  # device idle = busy ratio below this while the queue has backlog
  recompiles_per_min_max: float = 10.0
  hbm_highwater_frac: float = 0.9
  device_idle_ratio: float = 0.05
  # serving tier: p99 request-latency SLO (ms; None = no
  # latency SLO on serving), cold-miss storm = backend-fetch fraction of
  # requests above this with at least min_requests in window (the cache
  # is being bypassed or thrashed — every client hits origin)
  serve_p99_ms: Optional[float] = None
  serve_miss_ratio_max: float = 0.9
  serve_min_requests: int = 50
  # serve federation: peer-fill failure storm = origin
  # fallbacks above this fraction of peer attempts (the ring is
  # half-dead and every miss pays a failed peer round before origin);
  # shed-rate SLO = 503s above this fraction of offered requests
  serve_peer_fail_max: float = 0.5
  serve_peer_min_attempts: int = 8
  serve_shed_ratio_max: float = 0.2
  # data integrity: corrupt reads + failed write-verifies +
  # quarantined objects above this count is an anomaly — the default 0
  # means ANY detected corruption alerts (it should: every one names a
  # damaged object that needs an audit/heal pass)
  integrity_corrupt_max: float = 0.0
  # campaign survival: speculation storm = the fenced share
  # of issued twins above this ceiling (the fleet keeps double-running
  # work the original holder finishes first — insurance premiums with
  # no payout), once at least min_issued twins give the ratio meaning
  speculate_waste_max: float = 0.5
  speculate_min_issued: int = 8

  _ENV = {
    "window_sec": "IGNEOUS_HEALTH_WINDOW_SEC",
    "straggler_ratio": "IGNEOUS_HEALTH_STRAGGLER_RATIO",
    "straggler_min_tasks": "IGNEOUS_HEALTH_STRAGGLER_MIN_TASKS",
    "stall_sec": "IGNEOUS_HEALTH_STALL_SEC",
    "forget_sec": "IGNEOUS_HEALTH_FORGET_SEC",
    "dlq_rate_max": "IGNEOUS_HEALTH_DLQ_RATE",
    "retry_rate_max": "IGNEOUS_HEALTH_RETRY_RATE",
    "zombie_rate_max": "IGNEOUS_HEALTH_ZOMBIE_RATE",
    "stall_ratio_max": "IGNEOUS_HEALTH_STALL_RATIO",
    "slo_success": "IGNEOUS_SLO_SUCCESS",
    "slo_p95_ms": "IGNEOUS_SLO_P95_MS",
    "horizon_sec": "IGNEOUS_AUTOSCALE_HORIZON_SEC",
    "hysteresis": "IGNEOUS_AUTOSCALE_HYSTERESIS",
    "min_workers": "IGNEOUS_AUTOSCALE_MIN",
    "max_workers": "IGNEOUS_AUTOSCALE_MAX",
    "recompiles_per_min_max": "IGNEOUS_HEALTH_RECOMPILES_PER_MIN",
    "hbm_highwater_frac": "IGNEOUS_HEALTH_HBM_FRAC",
    "device_idle_ratio": "IGNEOUS_HEALTH_DEVICE_IDLE_RATIO",
    "serve_p99_ms": "IGNEOUS_SERVE_SLO_P99_MS",
    "serve_miss_ratio_max": "IGNEOUS_SERVE_MISS_RATIO",
    "serve_min_requests": "IGNEOUS_SERVE_MIN_REQUESTS",
    "serve_peer_fail_max": "IGNEOUS_SERVE_PEER_FAIL_RATIO",
    "serve_peer_min_attempts": "IGNEOUS_SERVE_PEER_MIN",
    "serve_shed_ratio_max": "IGNEOUS_SERVE_SHED_RATIO",
    "integrity_corrupt_max": "IGNEOUS_HEALTH_INTEGRITY_MAX",
    "speculate_waste_max": "IGNEOUS_SPECULATE_WASTE_MAX",
    "speculate_min_issued": "IGNEOUS_SPECULATE_MIN_ISSUED",
  }

  @classmethod
  def from_env(cls, **overrides) -> "HealthConfig":
    """Env-derived config; keyword overrides (CLI flags) win. ``None``
    overrides mean "not given" and fall through to env/default."""
    kw = {}
    for f in fields(cls):
      if f.name.startswith("_"):
        continue
      env_name = cls._ENV.get(f.name)
      val = overrides.get(f.name)
      if val is None and env_name:
        val = knobs.opt_float(env_name)
      if val is not None:
        if f.type in ("int",):
          val = int(val)
        kw[f.name] = val
    cfg = cls(**kw)
    cfg.straggler_min_tasks = int(cfg.straggler_min_tasks)
    cfg.min_workers = int(cfg.min_workers)
    cfg.max_workers = int(cfg.max_workers)
    cfg.serve_min_requests = int(cfg.serve_min_requests)
    cfg.serve_peer_min_attempts = int(cfg.serve_peer_min_attempts)
    cfg.speculate_min_issued = int(cfg.speculate_min_issued)
    return cfg


def _percentile(sorted_vals: List[float], q: float) -> float:
  if not sorted_vals:
    return 0.0
  idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
  return sorted_vals[idx]


class HealthEngine:
  """Evaluates journal-derived records into one health report dict."""

  def __init__(self, config: Optional[HealthConfig] = None):
    self.config = config or HealthConfig.from_env()

  # -- record scan ----------------------------------------------------------

  def _scan(self, records: Iterable[dict], now: float) -> dict:
    cfg = self.config
    per = {}  # worker -> view

    def view(worker: str) -> dict:
      v = per.get(worker)
      if v is None:
        v = per[worker] = {
          "last_seen": 0.0, "clean_exit": False,
          "task_durs": [], "tasks_failed": 0,
          "task_starts": [], "task_ends": [],
        }
      return v

    counters_by_worker: dict = {}
    device_latest: dict = {}    # worker -> newest cumulative device ledger
    device_earliest: dict = {}  # worker -> oldest in-window ledger (rates)
    stall_total = work_total = 0.0
    serve_durs: list = []       # serve.request spans in window (seconds)
    serve_fetches = 0           # serve.fetch spans in window (origin trips)

    def seen(worker, ts):
      # "health-*" actors are check/cron processes appending health.*
      # events, not fleet workers — never liveness targets; ditto the
      # autoscale controller's own journal records
      if worker and ts and not worker.startswith(("health-", "autoscale-")):
        v = view(worker)
        v["last_seen"] = max(v["last_seen"], float(ts))

    def take_task(rec):
      worker = rec.get("worker", "local")
      ts, dur = rec.get("ts"), rec.get("dur")
      if ts is None or dur is None:
        return
      end = float(ts) + float(dur)
      seen(worker, end)
      if end < now - cfg.window_sec or float(ts) > now + fleet.CLOCK_SKEW_TOLERANCE_SEC:
        return
      v = view(worker)
      if rec.get("error"):
        v["tasks_failed"] += 1
      else:
        v["task_durs"].append(float(dur))
        v["task_starts"].append(float(ts))
        v["task_ends"].append(end)

    def take_stage(name, total):
      # unlike fleet.status's informational ratio, this one feeds an
      # exit-code-bearing anomaly — so "queue.wait" (time tasks sat
      # ENQUEUED: that's backlog, the autoscaler's job) must not count
      # as stall, or every backlogged-but-healthy fleet alerts. Only
      # worker-side pipeline stalls (buffer starvation) are regressions.
      nonlocal stall_total, work_total
      if "queue.wait" in name:
        return
      if any(m in name for m in fleet.STALL_MARKERS):
        stall_total += total
      elif (
        name != "task" and not name.startswith("health.")
        and not name.startswith("serve.")
      ):
        # serve.* spans are request latency, not pipeline work — they
        # get their own detectors below, not the stall-ratio one
        work_total += total

    for rec in records:
      kind = rec.get("kind")
      if kind == "rollup":
        for wid, last in (rec.get("workers") or {}).items():
          seen(wid, last)
        for name, s in (rec.get("stages") or {}).items():
          take_stage(name, float(s.get("sum", 0.0)))
        for t in rec.get("tasks") or ():
          take_task(t)
      elif kind == "counters":
        worker = rec.get("worker", "local")
        seen(worker, rec.get("ts"))
        prev = counters_by_worker.get(worker)
        if prev is None or rec.get("ts", 0) >= prev.get("ts", 0):
          counters_by_worker[worker] = rec
        if rec.get("event") in ("drain", "exit"):
          view(worker)["clean_exit"] = True
      elif kind == "device":
        worker = rec.get("worker", "local")
        ts = rec.get("ts")
        seen(worker, ts)
        prev = device_latest.get(worker)
        if prev is None or (ts or 0) >= prev.get("ts", 0):
          device_latest[worker] = rec
        if ts is not None and ts >= now - cfg.window_sec:
          early = device_earliest.get(worker)
          if early is None or ts < early.get("ts", float("inf")):
            device_earliest[worker] = rec
      elif kind == "span":
        worker = rec.get("worker", "local")
        ts, dur = rec.get("ts"), rec.get("dur")
        if ts is None or dur is None:
          continue
        if rec.get("name") == "task":
          take_task(rec)
        else:
          seen(worker, float(ts) + float(dur))
          name = rec.get("name", "span")
          if float(ts) + float(dur) >= now - cfg.window_sec:
            if name == "serve.request":
              serve_durs.append(float(dur))
            elif name == "serve.fetch":
              serve_fetches += 1
          take_stage(name, float(dur))

    # a worker silent past forget_sec is history, not a detector target
    per = {
      w: v for w, v in per.items()
      if v["last_seen"] >= now - self.config.forget_sec
    }
    counters: dict = defaultdict(int)
    for rec in counters_by_worker.values():
      for k, val in (rec.get("counters") or {}).items():
        counters[k] += val
    return {
      "per_worker": per,
      "counters": dict(counters),
      "stall_total": stall_total,
      "work_total": work_total,
      "device_latest": device_latest,
      "device_earliest": device_earliest,
      "serve_durs": serve_durs,
      "serve_fetches": serve_fetches,
    }

  # -- evaluation -----------------------------------------------------------

  def evaluate(self, records: Iterable[dict],
               queue_stats: Optional[dict] = None,
               now: Optional[float] = None) -> dict:
    cfg = self.config
    now = time.time() if now is None else now
    scan = self._scan(records, now)
    per = scan["per_worker"]
    counters = scan["counters"]
    backlog = int((queue_stats or {}).get("backlog") or 0)

    all_durs = sorted(d for v in per.values() for d in v["task_durs"])
    tasks_ok = len(all_durs)
    tasks_failed = sum(v["tasks_failed"] for v in per.values())
    tasks_total = tasks_ok + tasks_failed
    fleet_median = _percentile(all_durs, 0.50)
    fleet_p95 = _percentile(all_durs, 0.95)

    # throughput over the observed in-window task extent
    starts = [t for v in per.values() for t in v["task_starts"]]
    ends = [t for v in per.values() for t in v["task_ends"]]
    elapsed = max(max(ends) - min(starts), 1.0) if starts else 0.0
    tasks_per_sec = (tasks_ok / elapsed) if elapsed > 0 else 0.0

    stragglers = []
    for worker in sorted(per):
      v = per[worker]
      durs = sorted(v["task_durs"])
      if (
        len(durs) >= cfg.straggler_min_tasks
        and len(all_durs) >= cfg.straggler_min_tasks
        and fleet_median > 0
      ):
        p95 = _percentile(durs, 0.95)
        if p95 >= cfg.straggler_ratio * fleet_median:
          stragglers.append({
            "worker": worker, "kind": "latency",
            "p95_ms": round(p95 * 1e3, 1),
            "fleet_median_ms": round(fleet_median * 1e3, 1),
            "ratio": round(p95 / fleet_median, 2),
            "tasks": len(durs),
          })
          continue
      age = now - v["last_seen"]
      if backlog > 0 and not v["clean_exit"] and age >= cfg.stall_sec:
        stragglers.append({
          "worker": worker, "kind": "stalled",
          "last_seen_age_sec": round(age, 1),
          "stall_sec": cfg.stall_sec,
        })

    anomalies = []
    denom = max(tasks_total, 1)
    dlq = counters.get("dlq.promoted", 0)
    if dlq and dlq / denom > cfg.dlq_rate_max:
      anomalies.append({
        "kind": "dlq_rate", "dlq_promoted": dlq,
        "rate": round(dlq / denom, 3), "max": cfg.dlq_rate_max,
      })
    retries = sum(v for k, v in counters.items() if k.startswith("retries."))
    if retries and retries / denom > cfg.retry_rate_max:
      anomalies.append({
        "kind": "retry_rate", "retries": retries,
        "rate": round(retries / denom, 3), "max": cfg.retry_rate_max,
      })
    zombies = sum(v for k, v in counters.items() if k.startswith("zombie."))
    if zombies and zombies / denom > cfg.zombie_rate_max:
      anomalies.append({
        "kind": "zombie_rate", "zombie_fences": zombies,
        "rate": round(zombies / denom, 3), "max": cfg.zombie_rate_max,
      })
    # campaign survival: speculation is insurance against
    # stragglers — a fenced twin means the original holder resolved
    # first and the duplicate issue bought nothing. A high fenced share
    # is a storm: the driver keeps paying premiums with no payout
    # (mis-tuned tail ratio, or flags firing on healthy workers)
    spec_issued = counters.get("speculation.issued", 0)
    spec_won = counters.get("speculation.won", 0)
    spec_fenced = counters.get("speculation.fenced", 0)
    spec_waste = (spec_fenced / spec_issued) if spec_issued else None
    if (
      spec_issued >= cfg.speculate_min_issued
      and spec_waste is not None and spec_waste > cfg.speculate_waste_max
    ):
      anomalies.append({
        "kind": "speculation_storm",
        "issued": spec_issued, "won": spec_won, "fenced": spec_fenced,
        "waste_ratio": round(spec_waste, 3),
        "max": cfg.speculate_waste_max,
        "wasted_ms": counters.get("speculation.wasted_ms", 0),
      })
    # data integrity: every corrupt read / failed
    # verify-after-write / quarantined object names at-rest damage that
    # retries cannot fix — only an audit/heal pass can
    corrupt_reads = counters.get("integrity.corrupt_reads", 0)
    verify_failed = counters.get("integrity.verify_failed", 0)
    quarantined = counters.get("integrity.quarantined", 0)
    audit_findings = counters.get("integrity.audit.findings", 0)
    corrupt_total = corrupt_reads + verify_failed + quarantined
    if corrupt_total > cfg.integrity_corrupt_max or audit_findings > 0:
      anomalies.append({
        "kind": "integrity",
        "corrupt_reads": corrupt_reads,
        "verify_failed": verify_failed,
        "quarantined": quarantined,
        "audit_findings": audit_findings,
        "max": cfg.integrity_corrupt_max,
      })
    stall_total, work_total = scan["stall_total"], scan["work_total"]
    stall_ratio = (
      stall_total / (stall_total + work_total)
      if stall_total + work_total > 0 else None
    )
    if stall_ratio is not None and stall_ratio > cfg.stall_ratio_max:
      anomalies.append({
        "kind": "stall_ratio", "stall_ratio": round(stall_ratio, 3),
        "max": cfg.stall_ratio_max,
      })
    if per and backlog > 0 and all(
      now - v["last_seen"] >= cfg.stall_sec and not v["clean_exit"]
      for v in per.values()
    ):
      # every journal writer silent with work remaining: the journal
      # itself (or the whole fleet) is dead — alert even though no
      # single worker stands out
      anomalies.append({
        "kind": "journal_stalled",
        "workers": len(per), "backlog": backlog,
        "stall_sec": cfg.stall_sec,
      })

    # device-plane anomalies: recompile storms, HBM pressure,
    # and "the device idles while work waits" — all from the cumulative per-worker device ledgers
    device_ledgers = scan["device_latest"]
    for worker in sorted(device_ledgers):
      rec = device_ledgers[worker]
      early = scan["device_earliest"].get(worker)
      d_rec = rec.get("recompiles", 0)
      dt = float(rec.get("ts", now)) - float(
        rec.get("t_start", rec.get("ts", now))
      )
      if (
        early is not None and early is not rec
        and rec.get("ts", 0) > early.get("ts", 0)
      ):
        # two in-window snapshots: rate over their delta, not since boot
        d_rec = rec.get("recompiles", 0) - early.get("recompiles", 0)
        dt = float(rec["ts"]) - float(early["ts"])
      rate_per_min = d_rec / max(dt, 1.0) * 60.0
      if (
        d_rec >= DEVICE_RECOMPILE_STORM_MIN
        and rate_per_min > cfg.recompiles_per_min_max
      ):
        anomalies.append({
          "kind": "recompile_storm", "worker": worker,
          "recompiles": d_rec, "per_min": round(rate_per_min, 2),
          "max_per_min": cfg.recompiles_per_min_max,
        })
      for dev, dstats in sorted((rec.get("hbm") or {}).items()):
        limit = dstats.get("bytes_limit")
        if not limit:
          continue
        frac = dstats.get("peak_bytes_in_use", 0) / limit
        if frac >= cfg.hbm_highwater_frac:
          anomalies.append({
            "kind": "hbm_high_water", "worker": worker, "device": dev,
            "peak_frac": round(frac, 3),
            "max_frac": cfg.hbm_highwater_frac,
            "peak_bytes": dstats.get("peak_bytes_in_use", 0),
            "limit_bytes": limit,
          })
      busy = rec.get("busy_ratio")
      v = per.get(worker)
      worker_live = (
        v is not None and not v["clean_exit"]
        and now - v["last_seen"] < cfg.stall_sec
      )
      if (
        backlog > 0 and worker_live and busy is not None
        and rec.get("dispatches", 0) > 0
        and busy <= cfg.device_idle_ratio
      ):
        anomalies.append({
          "kind": "device_idle", "worker": worker,
          "busy_ratio": busy, "min_busy_ratio": cfg.device_idle_ratio,
          "backlog": backlog,
        })

    # serving-tier detectors: request latency SLO + cold-miss
    # storm, from the per-request spans the serve tier journals
    serve_durs = sorted(scan["serve_durs"])
    serve_req = len(serve_durs)
    serve_fetches = scan["serve_fetches"]
    serve_p50 = _percentile(serve_durs, 0.50)
    serve_p99 = _percentile(serve_durs, 0.99)
    serve_miss_ratio = (serve_fetches / serve_req) if serve_req else None
    if (
      serve_req >= cfg.serve_min_requests
      and serve_miss_ratio is not None
      and serve_miss_ratio > cfg.serve_miss_ratio_max
    ):
      anomalies.append({
        "kind": "cold_miss_storm", "requests": serve_req,
        "backend_fetches": serve_fetches,
        "miss_ratio": round(serve_miss_ratio, 3),
        "max": cfg.serve_miss_ratio_max,
      })
    if cfg.serve_p99_ms and serve_p99 * 1e3 > cfg.serve_p99_ms:
      anomalies.append({
        "kind": "serve_latency_slo", "p99_ms": round(serve_p99 * 1e3, 1),
        "target_ms": cfg.serve_p99_ms, "requests": serve_req,
      })

    # serve federation detectors, from the fleet-aggregated
    # counters: a peer-fill failure storm means misses pay a dead peer
    # round before origin on every fill; shed rate over the SLO ceiling
    # means the fleet is turning real viewers away faster than budgeted
    peer_hits = counters.get("serve.peer.hits", 0)
    peer_fallbacks = counters.get("serve.peer.fallback", 0)
    peer_attempts = (
      peer_hits + peer_fallbacks + counters.get("serve.peer.notfound", 0)
    )
    peer_fail_ratio = (
      peer_fallbacks / peer_attempts if peer_attempts else None
    )
    if (
      peer_attempts >= cfg.serve_peer_min_attempts
      and peer_fail_ratio is not None
      and peer_fail_ratio > cfg.serve_peer_fail_max
    ):
      anomalies.append({
        "kind": "peer_fill_storm", "attempts": peer_attempts,
        "fallbacks": peer_fallbacks,
        "fail_ratio": round(peer_fail_ratio, 3),
        "max": cfg.serve_peer_fail_max,
      })
    serve_sheds = counters.get("serve.shed.requests", 0)
    serve_offered = serve_sheds + counters.get("serve.requests", 0)
    shed_ratio = (serve_sheds / serve_offered) if serve_offered else None
    if (
      serve_offered >= cfg.serve_min_requests
      and shed_ratio is not None
      and shed_ratio > cfg.serve_shed_ratio_max
    ):
      anomalies.append({
        "kind": "shed_rate_slo", "offered": serve_offered,
        "sheds": serve_sheds, "shed_ratio": round(shed_ratio, 3),
        "max": cfg.serve_shed_ratio_max,
      })

    # SLO burn: error-budget consumption rate (1.0 = burning exactly at
    # budget; >1 = on track to violate the SLO)
    success_rate = (tasks_ok / tasks_total) if tasks_total else None
    err_budget = max(1.0 - cfg.slo_success, 1e-9)
    burn = 0.0
    if success_rate is not None:
      burn = (1.0 - success_rate) / err_budget
    if cfg.slo_p95_ms and fleet_p95 > 0:
      burn = max(burn, (fleet_p95 * 1e3) / cfg.slo_p95_ms)
    if cfg.serve_p99_ms and serve_p99 > 0:
      burn = max(burn, (serve_p99 * 1e3) / cfg.serve_p99_ms)
    burn = round(burn, 3)

    # autoscale: workers active now vs workers needed to drain the
    # backlog within the horizon at the observed per-worker rate
    active = [
      w for w, v in per.items()
      if not v["clean_exit"] and now - v["last_seen"] < cfg.stall_sec
    ]
    contributing = [w for w, v in per.items() if v["task_durs"]]
    current = len(active)
    per_worker_rate = tasks_per_sec / max(len(contributing), 1)
    # the desired-workers formula lives in observability.autoscale so
    # the HealthEngine report, the fleet simulator, and the live
    # controller share one implementation
    from .autoscale import AutoscalePolicy, compute_desired

    desired, damped = compute_desired(
      backlog, per_worker_rate, current,
      AutoscalePolicy(
        min_workers=cfg.min_workers, max_workers=cfg.max_workers,
        horizon_sec=cfg.horizon_sec, hysteresis=cfg.hysteresis,
      ),
    )

    workers_report = {
      w: {
        "tasks": len(v["task_durs"]),
        "tasks_failed": v["tasks_failed"],
        "p95_ms": round(_percentile(sorted(v["task_durs"]), 0.95) * 1e3, 1),
        "last_seen_age_sec": round(now - v["last_seen"], 1),
        "clean_exit": v["clean_exit"],
      }
      for w, v in sorted(per.items())
    }
    flagged = sorted({s["worker"] for s in stragglers})
    report = {
      "ts": now,
      "window_sec": cfg.window_sec,
      "healthy": not stragglers and not anomalies and burn <= 1.0,
      "stragglers": stragglers,
      "anomalies": anomalies,
      "flagged_workers": flagged,
      "fleet": {
        "workers_seen": len(per),
        "workers_active": current,
        "tasks": tasks_total,
        "tasks_failed": tasks_failed,
        "tasks_per_sec": round(tasks_per_sec, 3),
        "median_task_ms": round(fleet_median * 1e3, 1),
        "p95_task_ms": round(fleet_p95 * 1e3, 1),
        "stall_ratio": (
          round(stall_ratio, 3) if stall_ratio is not None else None
        ),
      },
      "slo": {
        "success_rate": (
          round(success_rate, 4) if success_rate is not None else None
        ),
        "target": cfg.slo_success,
        "p95_target_ms": cfg.slo_p95_ms,
        "burn": burn,
      },
      "autoscale": {
        "backlog": backlog,
        "current_workers": current,
        "desired_workers": desired,
        "per_worker_tasks_per_sec": round(per_worker_rate, 3),
        "horizon_sec": cfg.horizon_sec,
        "hysteresis_damped": damped,
      },
      "workers": workers_report,
    }
    if serve_req > 0 or peer_attempts or serve_sheds:
      report["serve"] = {
        "requests": serve_req,
        "backend_fetches": serve_fetches,
        "p50_ms": round(serve_p50 * 1e3, 1),
        "p99_ms": round(serve_p99 * 1e3, 1),
        "miss_ratio": (
          round(serve_miss_ratio, 3) if serve_miss_ratio is not None else None
        ),
        "p99_target_ms": cfg.serve_p99_ms,
        "peer_hits": peer_hits,
        "peer_attempts": peer_attempts,
        "peer_fail_ratio": (
          round(peer_fail_ratio, 3) if peer_fail_ratio is not None else None
        ),
        "sheds": serve_sheds,
        "shed_ratio": (
          round(shed_ratio, 3) if shed_ratio is not None else None
        ),
      }
    if spec_issued or counters.get("steal.claims", 0):
      report["speculation"] = {
        "issued": spec_issued,
        "won": spec_won,
        "fenced": spec_fenced,
        "waste_ratio": (
          round(spec_waste, 3) if spec_waste is not None else None
        ),
        "wasted_ms": counters.get("speculation.wasted_ms", 0),
        "steal_claims": counters.get("steal.claims", 0),
        "steal_granted": counters.get("steal.granted", 0),
        "steal_tasks": counters.get("steal.tasks", 0),
      }
    if corrupt_total or audit_findings:
      report["integrity"] = {
        "corrupt_reads": corrupt_reads,
        "verify_failed": verify_failed,
        "quarantined": quarantined,
        "audit_findings": audit_findings,
      }
    from . import device as device_mod

    report["devices"] = device_mod.fleet_summary(device_ledgers)
    return report


# -- consumers ----------------------------------------------------------------


def publish_gauges(report: dict) -> None:
  """Report → Prometheus gauges (rendered by observability.prom):
  ``igneous_fleet_stragglers``, ``igneous_fleet_desired_workers``,
  ``igneous_fleet_backlog``, ``igneous_slo_burn``,
  ``igneous_fleet_anomalies``."""
  metrics.gauge_set("fleet.stragglers", len(report["stragglers"]))
  metrics.gauge_set("fleet.anomalies", len(report["anomalies"]))
  metrics.gauge_set("fleet.desired_workers",
                    report["autoscale"]["desired_workers"])
  metrics.gauge_set("fleet.backlog", report["autoscale"]["backlog"])
  metrics.gauge_set("slo.burn", report["slo"]["burn"])
  dev = report.get("devices")
  if dev:
    if dev.get("busy_ratio") is not None:
      metrics.gauge_set("fleet.device_busy_ratio", dev["busy_ratio"])
    metrics.gauge_set("fleet.device_recompiles", dev["recompiles"])
    metrics.gauge_set("fleet.device_dispatches", dev["dispatches"])
    if dev.get("hbm_peak_frac") is not None:
      metrics.gauge_set("fleet.device_hbm_peak_frac", dev["hbm_peak_frac"])
  srv = report.get("serve")
  if srv:
    metrics.gauge_set("fleet.serve_requests", srv["requests"])
    metrics.gauge_set("fleet.serve_p99_ms", srv["p99_ms"])
    if srv.get("miss_ratio") is not None:
      metrics.gauge_set("fleet.serve_miss_ratio", srv["miss_ratio"])
    if srv.get("peer_fail_ratio") is not None:
      metrics.gauge_set("fleet.serve_peer_fail_ratio",
                        srv["peer_fail_ratio"])
    if srv.get("shed_ratio") is not None:
      metrics.gauge_set("fleet.serve_shed_ratio", srv["shed_ratio"])
  spec = report.get("speculation")
  if spec:
    # rendered by observability.prom as igneous_speculation_* — the
    # deployment.yaml igneous-campaign PrometheusRule alerts on these
    metrics.gauge_set("speculation.issued", spec["issued"])
    metrics.gauge_set("speculation.won", spec["won"])
    metrics.gauge_set("speculation.fenced", spec["fenced"])
    if spec.get("waste_ratio") is not None:
      metrics.gauge_set("speculation.waste_ratio", spec["waste_ratio"])
    metrics.gauge_set("steal.claims", spec["steal_claims"])
    metrics.gauge_set("steal.tasks", spec["steal_tasks"])
  integ = report.get("integrity")
  if integ:
    # rendered by observability.prom as igneous_integrity_* — the
    # deployment.yaml igneous-integrity PrometheusRule alerts on these
    metrics.gauge_set("integrity.corrupt_reads", integ["corrupt_reads"])
    metrics.gauge_set("integrity.quarantined", integ["quarantined"])
    metrics.gauge_set("integrity.audit_findings", integ["audit_findings"])


def health_events(report: dict) -> List[dict]:
  """Structured ``health.*`` journal records for one report (zero-dur
  span records, so ``fleet status|trace`` surface them natively)."""
  now = report["ts"]
  events = []

  def ev(name, **attrs):
    events.append({
      "kind": "span", "name": name, "ts": now, "dur": 0.0, **attrs,
    })

  for s in report["stragglers"]:
    ev("health.straggler", flagged=s["worker"], straggler_kind=s["kind"],
       detail={k: v for k, v in s.items() if k not in ("worker", "kind")})
  for a in report["anomalies"]:
    ev("health.anomaly", anomaly_kind=a["kind"],
       detail={k: v for k, v in a.items() if k != "kind"})
  if report["slo"]["burn"] > 1.0:
    ev("health.slo_burn", burn=report["slo"]["burn"],
       success_rate=report["slo"]["success_rate"],
       target=report["slo"]["target"])
  ev("health.autoscale", **report["autoscale"])
  return events


def emit_events(report: dict, journal) -> Optional[str]:
  """Append the report's ``health.*`` events to the journal as one
  segment (``journal`` is an ``observability.journal.Journal``)."""
  return journal.write_records(health_events(report), event="health")


def write_flags(cloudpath: str, report: dict) -> None:
  """Publish the straggler report where workers can see it
  (``<journal>/health/flags.json``): LeaseBatcher polls this and a
  flagged worker stops pre-leasing round i+1 — it surrenders queue
  depth to healthy workers instead of hoarding leases it will be slow
  to serve."""
  from ..storage import CloudFiles

  CloudFiles(cloudpath).put_json(FLAGS_KEY, {
    "ts": report["ts"],
    "stragglers": report["flagged_workers"],
    "desired_workers": report["autoscale"]["desired_workers"],
  })


def flagged_workers(cloudpath: str, max_age_sec: float = 600.0) -> set:
  """Workers the last health evaluation flagged (empty when no flags
  file exists or it is older than ``max_age_sec`` — stale verdicts must
  not dampen a worker forever)."""
  from ..storage import CloudFiles

  try:
    flags = CloudFiles(cloudpath).get_json(FLAGS_KEY)
  except Exception:
    return set()
  if not flags:
    return set()
  if time.time() - float(flags.get("ts") or 0) > max_age_sec:
    return set()
  return set(flags.get("stragglers") or ())


# -- rendering ----------------------------------------------------------------


def check_lines(report: dict) -> List[str]:
  """Human summary for ``igneous fleet check`` (and each ``watch``
  frame): verdict first, then every straggler/anomaly by name."""
  f, a = report["fleet"], report["autoscale"]
  lines = [
    ("HEALTHY" if report["healthy"] else "UNHEALTHY")
    + f" — {f['workers_active']} active / {f['workers_seen']} seen workers, "
      f"{f['tasks']} tasks in window ({f['tasks_failed']} failed)",
    f"throughput: {f['tasks_per_sec']} tasks/s  "
    f"p50 {f['median_task_ms']}ms p95 {f['p95_task_ms']}ms"
    + (f"  stall {f['stall_ratio']}" if f["stall_ratio"] is not None else ""),
    f"slo: success {report['slo']['success_rate']} "
    f"(target {report['slo']['target']}) burn {report['slo']['burn']}",
    f"autoscale: current {a['current_workers']} -> desired "
    f"{a['desired_workers']} (backlog {a['backlog']}, "
    f"{a['per_worker_tasks_per_sec']} tasks/s/worker"
    + (", damped)" if a["hysteresis_damped"] else ")"),
  ]
  srv = report.get("serve")
  if srv:
    lines.insert(3, (
      f"serve: {srv['requests']} requests  p50 {srv['p50_ms']}ms "
      f"p99 {srv['p99_ms']}ms  miss {srv['miss_ratio']}"
      + (f" (p99 target {srv['p99_target_ms']}ms)"
         if srv.get("p99_target_ms") else "")
      + (f"  peer-fill {srv['peer_hits']}/{srv['peer_attempts']}"
         if srv.get("peer_attempts") else "")
      + (f"  shed {srv['sheds']} ({srv['shed_ratio']})"
         if srv.get("sheds") else "")
    ))
  for s in report["stragglers"]:
    if s["kind"] == "stalled":
      lines.append(
        f"STRAGGLER {s['worker']}: stalled — no journal record for "
        f"{s['last_seen_age_sec']}s (threshold {s['stall_sec']}s)"
      )
    else:
      lines.append(
        f"STRAGGLER {s['worker']}: p95 {s['p95_ms']}ms = "
        f"{s['ratio']}x fleet median {s['fleet_median_ms']}ms"
      )
  for an in report["anomalies"]:
    detail = " ".join(
      f"{k}={v}" for k, v in an.items() if k != "kind"
    )
    lines.append(f"ANOMALY {an['kind']}: {detail}")
  return lines


def render_dashboard(report: dict, queue_stats: Optional[dict] = None,
                     title: str = "igneous fleet") -> List[str]:
  """One ``fleet watch`` frame: status header, per-worker table,
  alerts, autoscale line."""
  ts = time.strftime("%H:%M:%S", time.localtime(report["ts"]))
  lines = [f"{title} — {ts}  (window {int(report['window_sec'])}s)"]
  if queue_stats:
    q = queue_stats
    lines.append(
      "queue: "
      + "  ".join(
        f"{k} {q[k]}" for k in
        ("backlog", "leased", "completed", "dlq", "stale_leases")
        if q.get(k) is not None
      )
    )
  lines.extend(check_lines(report)[:4])
  dev = report.get("devices")
  if dev:
    fp = dev.get("fastpath") or {}
    fp_total = fp.get("batched", 0) + fp.get("host", 0)
    lines.append(
      "devices: "
      + (
        f"busy {dev['busy_ratio'] * 100:.1f}%  "
        if dev.get("busy_ratio") is not None else ""
      )
      + f"dispatches {dev['dispatches']}  recompiles {dev['recompiles']}"
      + (
        f"  hbm peak {dev['hbm_peak_frac'] * 100:.0f}%"
        if dev.get("hbm_peak_frac") is not None else ""
      )
      + (
        f"  pad waste {dev['pad_waste_ratio'] * 100:.1f}%"
        if dev.get("pad_waste_ratio") is not None else ""
      )
      + (
        f"  fastpath {fp.get('batched', 0)}/{fp_total} batched"
        if fp_total else ""
      )
    )
  spec = report.get("speculation")
  if spec:
    lines.append(
      f"speculation: issued {spec['issued']}  won {spec['won']}  "
      f"fenced {spec['fenced']}"
      + (
        f"  waste {spec['waste_ratio']}"
        if spec.get("waste_ratio") is not None else ""
      )
      + (
        f"  steal {spec['steal_granted']}/{spec['steal_claims']} grants"
        f" ({spec['steal_tasks']} tasks)"
        if spec["steal_claims"] else ""
      )
    )
  lines.append("")
  lines.append(f"{'worker':<28}{'tasks':>6}{'fail':>6}{'p95_ms':>9}"
               f"{'seen_ago':>10}  state")
  flagged = set(report["flagged_workers"])
  for w, v in report["workers"].items():
    if v["clean_exit"]:
      state = "drained"
    elif w in flagged:
      state = "STRAGGLER"
    else:
      state = "ok"
    lines.append(
      f"{w:<28}{v['tasks']:>6}{v['tasks_failed']:>6}{v['p95_ms']:>9}"
      f"{v['last_seen_age_sec']:>9.1f}s  {state}"
    )
  alerts = check_lines(report)[4:]
  if alerts:
    lines.append("")
    lines.extend(alerts)
  return lines


def default_checker_id() -> str:
  host = socket.gethostname().split(".")[0] or "health"
  return f"health-{host}-{os.getpid()}"


def report_json(report: dict) -> str:
  return json.dumps(report, indent=2, sort_keys=False)
