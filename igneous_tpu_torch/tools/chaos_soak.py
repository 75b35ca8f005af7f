"""Chaos soak of the port: downsample campaigns under injected faults,
worker kills, stalls and silent damage must write the bytes of a run
without them.

The scenarios of ``tools/chaos_soak.py``, on the port's own modules, each
with every check of its JAX original:

``--scenario faults`` (default): a clean run (an fq:// queue drained
serially, ``IGNEOUS_PIPELINE=off``) against the same pipeline with every
storage backend wrapped in ``chaos.ChaosStorage`` (failed puts, corrupted
gets, 503 storms, a crash between compute and upload) and the queue in
``chaos.ChaosQueue`` (dropped deletes, skewed lease clocks, stalled
workers whose late acks are fenced); byte for byte equal layers, then a
poison task in the dead-letter queue with its failure recorded.

``--scenario corruption``: seeded torn writes and bit flips land silently
mid-campaign; ``audit`` must name every injected fault and no other, and
a heal must converge to the clean run's bytes.

``--scenario preemption``: three port worker processes drain a queue
while one is SIGTERMed (it drains and exits ``EXIT_PREEMPTED``, 83) and
one SIGKILLed (its leases recycle), plus a stalled zombie whose late
delete must be fenced; completions equal the task count exactly, the
output the clean run's bytes, and the workers' journal segments merge
into one fleet view (``--trace-out``: its Perfetto trace).

``--scenario stall``: a stalled worker and a backlog; ``fleet check``
must exit 2 naming it, recommend more workers, leave a
``health.straggler`` event, and the compacted roll-ups must agree with
the raw segments (``--health-out``: the check's report).

``--scenario hostile``: the port's ``CampaignRunner`` drives a range-lease
campaign through a seeded freeze, kill and preemption storm with
speculation and stealing; byte-identical output, completions exact, no
dead letter, ``won + fenced == issued`` from the journal alone, and the
``fleet simulate`` forecast of the storm's own journal within ±20% of
the live makespan.

``--scenario all`` runs them all; ``--pipeline`` runs every faulted run
through the staged pipeline (the clean reference stays serial). The soak
sets ``IGNEOUS_RACE_CHECK=1`` for itself and its workers, so an unlocked
write to a ``guarded-by`` structure fails it. The pooling runs on the
port's device: the card, or the CPU with ``IGNEOUS_TORCH_DEVICE=cpu``,
which the workers inherit.

Usage:
  python -m igneous_tpu_torch.tools.chaos_soak --seed 7 [--size 96] [--keep]
      [--scenario faults|preemption|stall|corruption|hostile|all]
      [--pipeline] [--report-out R] [--trace-out T] [--health-out H]

It prints one JSON report and exits 0 when every check held; the seed
names the fault schedule and the storm, so a failing seed replays.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..analysis import knobs


class SoakFailure(RuntimeError):
  """A check of the soak did not hold."""


def _check(cond: bool, msg: str) -> None:
  if not cond:
    raise SoakFailure(msg)


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_tasks(path):
  # a memory target that cuts the default 96^3 volume into 8 tasks: the
  # faults must land across many leases, not one
  from .. import task_creation as tc

  return list(tc.create_downsampling_tasks(
    path, mip=0, num_mips=2, memory_target=int(6e5), compress="gzip",
  ))


def grid_tasks(path):
  """The storm scenarios' one-mip downsample grid: 18 tasks on their
  160x160x64 volume, whatever ``--size`` is."""
  from .. import task_creation as tc

  return list(tc.create_downsampling_tasks(
    path, mip=0, num_mips=1, memory_target=int(6e5), compress="gzip",
  ))


def storm_image(seed: int) -> np.ndarray:
  """The storm scenarios' volume: a kill needs a task grid, not one cell."""
  rng = np.random.default_rng(seed)
  return rng.integers(0, 255, (160, 160, 64)).astype(np.uint8)


def worker_env(**extra) -> dict:
  """The caller's environment for a worker process of the port (it
  inherits ``IGNEOUS_TORCH_DEVICE`` and ``IGNEOUS_RACE_CHECK``), with the
  repo on its path."""
  env = dict(os.environ, **extra)
  env["PYTHONPATH"] = (
    REPO_ROOT + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else REPO_ROOT
  )
  return env


def _same_layers(clean: dict, other: dict, what: str) -> None:
  missing = sorted(set(clean) - set(other))
  extra = sorted(set(other) - set(clean))
  _check(not missing and not extra,
         f"{what}: key sets differ: missing={missing[:5]} extra={extra[:5]}")
  diff = [k for k in clean if clean[k] != other[k]]
  _check(not diff, f"{what}: {len(diff)} objects differ byte-wise: {diff[:5]}")


def layer_bytes(root: str) -> dict:
  """Every object under a layer directory but provenance (it holds dates)
  and the integrity sidecars (their names and timestamps are a run's),
  and no ``.tmp.*`` file of an interrupted atomic write."""
  out = {}
  for dirpath, _dirs, files in os.walk(root):
    for name in files:
      if ".tmp." in name:
        continue
      full = os.path.join(dirpath, name)
      rel = os.path.relpath(full, root)
      if rel.startswith("provenance") or rel.startswith("integrity"):
        continue
      with open(full, "rb") as f:
        out[rel] = f.read()
  return out


def drain(queue, lease_seconds: float = 0.5, deadline: float = 120.0) -> int:
  """Poll until nothing is enqueued; failed deliveries are out on expiring
  leases while the queue reads empty, so wait for them to recycle."""
  from .. import telemetry

  start = time.monotonic()

  def stop(executed, empty):
    if time.monotonic() - start > deadline:
      raise TimeoutError(
        f"soak queue failed to drain in {deadline}s "
        f"(enqueued={queue.enqueued}, counters={telemetry.counters_snapshot()})"
      )
    return empty and queue.enqueued == 0

  return queue.poll(lease_seconds=lease_seconds, stop_fn=stop, verbose=False,
                    max_backoff_window=0.2)


@contextlib.contextmanager
def pinned(**values):
  """Set knobs (for this process and the workers it starts) for a block,
  and restore them after."""
  prev = {name: knobs.raw(name) for name in values}
  for name, value in values.items():
    knobs.set_env(name, value)
  try:
    yield
  finally:
    for name, value in prev.items():
      if value is None:
        knobs.del_env(name)
      else:
        knobs.set_env(name, value)


def serial_pipeline():
  """The clean run pins the bytes on the serial loop."""
  return pinned(IGNEOUS_PIPELINE="off")


def run_pipeline(workdir: str, img, chaos_cfg=None, tag: str = "", task_fn=None):
  """(tasks executed, layer bytes) of one run into ``workdir``."""
  from ..chaos import ChaosQueue, chaos_storage
  from ..queues import FileQueue
  from ..volume import Volume

  layer = f"file://{workdir}/layer"
  Volume.from_numpy(img, layer, chunk_size=(32, 32, 32), compress="gzip")
  q = FileQueue(f"fq://{workdir}/q", max_deliveries=25)
  q.insert((task_fn or make_tasks)(layer))
  if chaos_cfg is None:
    executed = drain(q)
  else:
    with chaos_storage(chaos_cfg):
      executed = drain(ChaosQueue(q, chaos_cfg), lease_seconds=0.5)
  _check(q.is_empty(), f"{tag}: queue not drained")
  _check(q.dlq_count == 0, f"{tag}: unexpected DLQ entries: {q.dlq_ls()}")
  return executed, layer_bytes(os.path.join(workdir, "layer"))


def poison_phase(workdir: str) -> dict:
  """A task that raises on every delivery ends in the DLQ after its
  deliveries, its failure recorded, not in an endless retry loop."""
  from ..queues import FileQueue
  from ..tasks import FailTask

  q = FileQueue(f"fq://{workdir}/poison", max_deliveries=3)
  q.insert(FailTask())
  for _ in range(4):
    q.poll(lease_seconds=0.01, stop_fn=lambda executed, empty: empty)
    time.sleep(0.03)
  q.lease(0.01)  # the last recycle promotes a lease still out
  _check(q.dlq_count == 1, f"poison task not quarantined ({q.dlq_count})")
  rec = q.dlq_ls()[0]
  _check(rec["deliveries"] == 3, f"poison deliveries: {rec}")
  _check(any("intentional failure" in f["error"] for f in rec["failures"]),
         f"poison failures: {rec}")
  return rec


def fault_config(seed: int):
  """The soak's fault storm (the JAX soak's rates)."""
  from ..chaos import ChaosConfig

  return ChaosConfig(
    seed=seed,
    put_fail=0.15,        # transient 503 on upload
    get_corrupt=0.10,     # a flipped byte on download (gzip's CRC finds it)
    storm=0.05,           # 503 on any operation
    crash_put=0.10,       # the worker dies between compute and upload
    drop_delete=0.20,     # a completed task's ack is lost: it runs again
    clock_skew=0.10,      # a lease granted already expired
    stalled_worker=0.10,  # a late ack after the task was reissued: fenced
    max_faults_per_key=2,
  )


def run_faults_scenario(scratch: str, img, seed: int) -> dict:
  """The fault storm against the clean run, byte for byte; then the
  poison task."""
  from .. import telemetry

  with serial_pipeline():
    n_clean, clean = run_pipeline(os.path.join(scratch, "clean"), img, tag="clean")
  n_chaos, chaos = run_pipeline(os.path.join(scratch, "chaos"), img,
                                chaos_cfg=fault_config(seed), tag="chaos")
  _same_layers(clean, chaos, "faults")
  poison = poison_phase(scratch)
  counters = telemetry.counters_snapshot()
  injected = sum(v for k, v in counters.items() if k.startswith("chaos."))
  _check(injected > 0, "the chaos layer injected no faults: the soak proved nothing")
  return {
    "objects_compared": len(clean),
    "clean_executed": n_clean,
    "chaos_executed": n_chaos,
    "faults_injected": injected,
    "dlq_poison_deliveries": poison["deliveries"],
    "byte_identical": True,
  }


def run_corruption_scenario(scratch: str, img, seed: int) -> dict:
  """Seeded torn writes and bit flips land silently mid-campaign (the
  tasks that write them succeed; nothing reads the damage back during the
  run). ``audit`` must then name every injected fault and no other, a heal
  must converge, and the healed layer must be the clean run's bytes."""
  from .. import integrity, telemetry
  from ..chaos import ChaosConfig
  from ..queues import LocalTaskQueue
  from ..storage import COMPRESSION_EXTS
  from ..task_creation.audit import (
    create_integrity_audit_tasks,
    downsample_provenance,
    downsample_repair_tasks,
    load_findings,
  )
  from ..volume import Volume

  with serial_pipeline():
    _, clean = run_pipeline(os.path.join(scratch, "cor-clean"), img, tag="cor-clean")

  # the regex picks the x=0, y=0 column of output chunks ("<mip dir>/<bbox>";
  # queue, journal and provenance writes do not match, and the mip-0 ingest
  # runs before chaos wraps the backends). torn_write 0.5 and bit_flip 1.0
  # corrupt every matching put, a seeded mix of the two; the chunks off the
  # column stay clean, so the exact match below tests both completeness and
  # precision. One fault a key: the injected list is the exact truth.
  cfg = ChaosConfig(
    seed=seed,
    torn_write=0.5,
    bit_flip=1.0,
    corrupt_key_re=r"^\d+_\d+_\d+/0-\d+_0-\d+_",
    max_faults_per_key=1,
  )
  workdir = os.path.join(scratch, "cor-chaos")
  run_pipeline(workdir, img, chaos_cfg=cfg, tag="cor-chaos")
  integrity.flush_all()

  _check(bool(cfg.injected), "the corruption scenario injected nothing: re-seed")
  exts = tuple(e for e in COMPRESSION_EXTS.values() if e)
  injected_keys = set()
  for _op, key in cfg.injected:
    for ext in exts:
      if key.endswith(ext):
        key = key[: -len(ext)]
        break
    injected_keys.add(key)

  layer = f"file://{workdir}/layer"
  report_dir = f"{layer}/integrity/audit"
  prov = downsample_provenance(Volume(layer, mip=0))
  _check(prov is not None, "the downsample campaign left no provenance")
  mips = range(int(prov["mip"]) + 1, int(prov["mip"]) + int(prov["num_mips"]) + 1)

  def audit_round():
    for mip in mips:
      LocalTaskQueue(parallel=1).insert(
        create_integrity_audit_tasks(layer, mip, report_dir)
      )
    return load_findings(report_dir)

  findings, totals = audit_round()
  detected = {f["key"] for f in findings}
  _check(detected == injected_keys,
         f"audit missed or invented faults: missed={sorted(injected_keys - detected)[:5]} "
         f"extra={sorted(detected - injected_keys)[:5]}")

  repairs, unhealable = downsample_repair_tasks(layer, findings)
  _check(not unhealable, f"unhealable findings: {unhealable[:3]}")
  _check(bool(repairs), "findings produced no repair tasks")
  LocalTaskQueue(parallel=1).insert(repairs)
  integrity.flush_all()  # the repairs' records reach the manifests first

  refindings, _ = audit_round()
  _check(not refindings, f"heal did not converge: {refindings[:3]}")
  _same_layers(clean, layer_bytes(os.path.join(workdir, "layer")), "corruption after heal")

  counters = telemetry.counters_snapshot()
  return {
    "objects_compared": len(clean),
    "faults_injected": len(cfg.injected),
    "torn_writes": counters.get("chaos.torn_write", 0),
    "bit_flips": counters.get("chaos.bit_flip", 0),
    "findings": len(findings),
    "repair_tasks": len(repairs),
    "audited_chunks": totals["chunks"],
    "healed_byte_identical": True,
  }


# one worker process of the port: the graceful drain of `execute` (StopFlag,
# signal handlers, heartbeats), a delay before each task so the storm
# catches workers mid-run, and a ready file written once the handlers are
# live (a signal before that would kill the interpreter mid-import, which is
# the SIGKILL case, not the drain)
_STORM_WORKER_SRC = r"""
import os, sys, time
import igneous_tpu_torch.tasks  # registers the port's tasks
from igneous_tpu_torch import lifecycle
from igneous_tpu_torch.observability import journal as journal_mod
from igneous_tpu_torch.queues import FileQueue

spec, lease_sec, task_delay, hb_sec, ready_path = (
  sys.argv[1], float(sys.argv[2]), float(sys.argv[3]), float(sys.argv[4]),
  sys.argv[5],
)
flag = lifecycle.StopFlag()
lifecycle.install_signal_handlers(flag)
q = FileQueue(spec)
# each storm worker journals its spans; the SIGTERMed one's drain flush
# must leave its last batch behind for the merge
journal_mod.set_active(
  journal_mod.Journal(journal_mod.journal_path_for(q, spec))
)
with open(ready_path, "w") as f:
  f.write(str(os.getpid()))
q.poll(
  lease_seconds=lease_sec,
  verbose=False,
  stop_fn=lambda executed, empty: empty and q.enqueued == 0,
  max_backoff_window=0.2,
  before_fn=lambda task: time.sleep(task_delay),
  drain_flag=flag,
  heartbeat_seconds=hb_sec,
)
sys.exit(lifecycle.EXIT_PREEMPTED if flag.is_set() else 0)
"""


def run_preemption_storm(scratch: str, seed: int, trace_out=None) -> dict:
  """SIGTERM and SIGKILL port workers at seeded points, plus a stalled
  zombie; the output the clean run's bytes, the completions tally exactly
  the task count."""
  import random
  import signal
  import subprocess

  from .. import lifecycle, telemetry
  from ..observability import fleet, perfetto
  from ..queues import FileQueue
  from ..volume import Volume

  img = storm_image(seed)
  with serial_pipeline():
    n_clean, clean = run_pipeline(os.path.join(scratch, "storm-clean"), img,
                                  tag="storm-clean", task_fn=grid_tasks)

  workdir = os.path.join(scratch, "storm")
  layer = f"file://{workdir}/layer"
  Volume.from_numpy(img, layer, chunk_size=(32, 32, 32), compress="gzip")
  spec = f"fq://{workdir}/q"
  q = FileQueue(spec)
  n_tasks = q.insert(grid_tasks(layer))
  _check(n_tasks >= 8, f"the storm needs a task grid, got {n_tasks}")

  # the stalled zombie: lease a task, do the work, then stall past the lease
  # while the storm reissues and completes it; its late ack must be fenced
  zombie = q.lease(1.0)
  _check(zombie is not None, "the zombie leased nothing")
  ztask, zlease = zombie
  ztask.execute()

  rng = random.Random(seed)
  env = worker_env()
  ready = [os.path.join(workdir, f"ready-{i}") for i in range(3)]
  workers = [
    subprocess.Popen(
      [sys.executable, "-c", _STORM_WORKER_SRC, spec, "1.5", "0.25", "0.3", ready[i]],
      env=env,
    )
    for i in range(3)
  ]
  try:
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline and not all(os.path.exists(r) for r in ready):
      time.sleep(0.05)
    _check(all(os.path.exists(r) for r in ready), "storm workers never started")

    # seeded kill points, once the fleet is processing
    time.sleep(rng.uniform(0.2, 0.8))
    workers[0].send_signal(signal.SIGTERM)  # a graceful drain
    time.sleep(rng.uniform(0.2, 0.8))
    if workers[1].poll() is None:
      workers[1].send_signal(signal.SIGKILL)  # a hard death: its leases recycle
    exit_codes = [w.wait(timeout=300) for w in workers]
  finally:
    for w in workers:
      if w.poll() is None:
        w.kill()
        w.wait()

  # a SIGTERM to a live worker drains, it does not fail (0: it finished
  # the queue before the signal landed)
  _check(exit_codes[0] in (lifecycle.EXIT_PREEMPTED, 0), f"exit codes {exit_codes}")
  _check(exit_codes[1] in (-signal.SIGKILL, 0), f"exit codes {exit_codes}")

  # the backstop: recycle what the SIGKILLed worker stranded, and finish
  drain(q, lease_seconds=1.5, deadline=180.0)
  _check(q.is_empty(), "storm queue not drained")

  # the zombie wakes: its task was reissued and completed by a live
  # worker, so its late delete must be refused
  completed_before = q.completed
  _check(q.delete(zlease) is False, "zombie delete was not fenced")
  _check(q.completed == completed_before, "the fenced delete moved the tally")
  zombie_fences = telemetry.counters_snapshot().get("zombie.delete", 0)
  _check(zombie_fences >= 1, "no zombie fence counted")

  # no duplicate completion: each task counted once, despite the kills,
  # the redeliveries and the zombie
  _check(q.completed == n_tasks,
         f"duplicate/lost completions: tally={q.completed} tasks={n_tasks}")
  _same_layers(clean, layer_bytes(os.path.join(workdir, "layer")), "preemption")

  # the journal segments survive the storm (the SIGTERMed worker's drain
  # batch too) and merge into one fleet view
  jpath = f"file://{workdir}/q/journal"
  records = fleet.load(jpath)
  _check(bool(records), "no journal segments survived the storm")
  journal_workers = {r.get("worker") for r in records if r.get("kind") == "span"}
  _check(bool(journal_workers), "the journal has no span records")
  drain_batches = [r for r in records
                   if r.get("kind") == "counters" and r.get("event") == "drain"]
  # exit 83: the SIGTERM landed mid-poll, so its drain flush left a batch
  # (exit 0: the queue drained first, no drain batch due)
  _check(bool(drain_batches) or exit_codes[0] == 0,
         "the SIGTERMed worker exited 83 but left no drain journal batch")
  merged = fleet.status(records)
  _check(merged["tasks"] >= 1, f"the merged view has no task: {merged}")
  if trace_out:
    n_events = perfetto.dump(records, trace_out)
    _check(n_events > 0, "the Perfetto export produced no events")

  return {
    "tasks": n_tasks,
    "clean_executed": n_clean,
    "worker_exit_codes": exit_codes,
    "completions_tally": q.completed,
    "zombie_delete_fenced": zombie_fences,
    "objects_compared": len(clean),
    "byte_identical": True,
    "journal_segments": len({r.get("segment") for r in records}),
    "journal_workers": sorted(w for w in journal_workers if w),
    "journal_drain_batches": len(drain_batches),
    "fleet_tasks_merged": merged["tasks"],
  }


# a worker that executes a slice of the queue and exits, journaling often:
# the healthy half of the stall scenario's fleet
_STALL_WORKER_SRC = r"""
import os, sys, time
os.environ["IGNEOUS_JOURNAL_FLUSH_SEC"] = "0.2"
import igneous_tpu_torch.tasks  # registers the port's tasks
from igneous_tpu_torch.observability import journal as journal_mod
from igneous_tpu_torch.queues import FileQueue

spec, num_tasks, task_delay = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
q = FileQueue(spec)
journal_mod.set_active(
  journal_mod.Journal(journal_mod.journal_path_for(q, spec))
)
q.poll(
  lease_seconds=30,
  verbose=False,
  stop_fn=lambda executed, empty: empty or executed >= num_tasks,
  max_backoff_window=0.2,
  before_fn=lambda task: time.sleep(task_delay),
)
journal_mod.disarm_last_will()  # a clean exit: a drain batch, no stall flag
"""


def run_stall_health_scenario(scratch: str, seed: int, health_out=None) -> dict:
  """A stalled worker and a backlogged queue: ``fleet check`` must exit 2
  naming the stalled worker, leave a ``health.straggler`` event in the
  journal and recommend more workers than there are, and ``fleet status``
  over compacted roll-ups must equal the raw segments' view."""
  import json as json_mod
  import subprocess

  from ..observability import fleet, journal as journal_mod, rollup, trace
  from ..queues import FileQueue
  from ..volume import Volume

  img = storm_image(seed)
  workdir = os.path.join(scratch, "stall")
  layer = f"file://{workdir}/layer"
  Volume.from_numpy(img, layer, chunk_size=(32, 32, 32), compress="gzip")
  spec = f"fq://{workdir}/q"
  q = FileQueue(spec)
  n_tasks = q.insert(grid_tasks(layer))
  _check(n_tasks >= 8, f"the stall scenario needs a task grid, got {n_tasks}")
  jpath = journal_mod.journal_path_for(q, spec)

  # the stalled worker: leases a task, journals once (so the health plane
  # knows it), then goes silent holding the lease, as a wedged worker
  # whose heartbeat thread died
  stalled_id = f"stalled-{os.getpid()}"
  zombie = q.lease(600)
  _check(zombie is not None, "the stalled worker leased nothing")
  stalled_journal = journal_mod.Journal(jpath, worker_id=stalled_id)
  journal_mod.set_active(stalled_journal)
  trace.record_root("task", time.time() - 1.0, 0.9, worker=stalled_id)
  stalled_journal.flush(event="interval")
  journal_mod.set_active(None)
  stalled_at = time.monotonic()

  # the healthy worker drains half the queue and exits cleanly: the check
  # sees throughput and a backlog left
  env = worker_env()
  live = subprocess.run(
    [sys.executable, "-c", _STALL_WORKER_SRC, spec, str(max(n_tasks // 2, 2)), "0.3"],
    env=env, timeout=300,
  )
  _check(live.returncode == 0, f"the healthy worker failed: {live.returncode}")
  backlog = q.backlog
  _check(backlog > 0, "the stall scenario needs a backlog left")

  # the stalled worker ages past the detector's threshold
  stall_sec = 2.0
  time.sleep(max(0.0, stall_sec + 0.5 - (time.monotonic() - stalled_at)))

  report_path = health_out or os.path.join(scratch, "health-report.json")
  check = subprocess.run(
    [sys.executable, "-m", "igneous_tpu_torch", "fleet", "check",
     "-q", spec, "--stall-sec", str(stall_sec), "--horizon-sec", "1",
     "--json", "--out", report_path],
    env=env, capture_output=True, text=True, timeout=120,
  )
  _check(check.returncode == 2,
         f"fleet check must exit 2 on a stalled worker, got {check.returncode}: "
         f"{check.stdout}\n{check.stderr}")
  report = json_mod.loads(check.stdout)
  flagged = {s["worker"] for s in report["stragglers"]}
  _check(stalled_id in flagged, f"{stalled_id} not flagged: {report['stragglers']}")
  auto = report["autoscale"]
  _check(auto["desired_workers"] > auto["current_workers"], f"autoscale {auto}")
  events = [r for r in fleet.load(jpath)
            if r.get("kind") == "span" and r.get("name") == "health.straggler"]
  _check(any(e.get("flagged") == stalled_id for e in events),
         f"no health.straggler event names {stalled_id}: {events}")

  # the compacted view must equal the raw segments' view
  st_raw = fleet.status(fleet.load(jpath))
  res = rollup.compact(jpath)
  _check(res["segments_compacted"] > 0, f"nothing compacted: {res}")
  st_eff = fleet.status(fleet.load_effective(jpath))
  _check(st_raw == st_eff, "roll-ups disagree with the raw segments: " + str({
    k: (st_raw.get(k), st_eff.get(k))
    for k in set(st_raw) | set(st_eff) if st_raw.get(k) != st_eff.get(k)
  }))

  return {
    "tasks": n_tasks,
    "backlog_at_check": backlog,
    "stalled_worker": stalled_id,
    "flagged": sorted(flagged),
    "desired_workers": auto["desired_workers"],
    "current_workers": auto["current_workers"],
    "health_report": report_path,
    "rollup_segments_compacted": res["segments_compacted"],
    "rollup_status_matches_raw": True,
  }


def run_hostile_scenario(scratch: str, seed: int) -> dict:
  """A seeded freeze, kill and preemption storm with speculation over a
  range-lease campaign driven by the port's ``CampaignRunner``: output the
  clean run's bytes, completions exactly the task count (first ack wins,
  never counted twice), no dead letter, ``won + fenced == issued`` from the
  journal alone, and a ``fleet simulate`` forecast mined from the storm's
  own journal within ±20% of the live makespan."""
  import random
  import signal

  from ..observability import (
    autoscale,
    campaign,
    fleet,
    health,
    journal as journal_mod,
    replay,
    sim as sim_mod,
  )
  from ..queues import FileQueue
  from ..tasks import SleepTask
  from ..volume import Volume

  img = storm_image(seed)
  with serial_pipeline():
    n_clean, clean = run_pipeline(os.path.join(scratch, "hostile-clean"), img,
                                  tag="hostile-clean", task_fn=grid_tasks)

  workdir = os.path.join(scratch, "hostile")
  layer = f"file://{workdir}/layer"
  Volume.from_numpy(img, layer, chunk_size=(32, 32, 32), compress="gzip")
  # the downsample grid carries the byte-identity claim; SleepTasks (they
  # write nothing) stretch the campaign across enough ticks for the storm
  # to land mid-range
  tasks = grid_tasks(layer) + [SleepTask(seconds=0.6) for _ in range(30)]
  spec = f"fq://{workdir}/q"

  # few, fat segments: range leases hold real unfinished tails for
  # speculation to twin and thieves to carve (a known-total insert_batch
  # spreads the tasks over IGNEOUS_QUEUE_SHARDS segments)
  with pinned(IGNEOUS_QUEUE_SHARDS="3"):
    q = FileQueue(spec, max_deliveries=25)
    n_tasks = q.insert_batch(tasks, total=len(tasks))
  _check(n_tasks >= 8, f"the hostile storm needs a task grid, got {n_tasks}")
  jpath = journal_mod.journal_path_for(q, spec)

  # the workers journal often (stall detection reads flush age), steal
  # when idle, and speculation twins fresh leases too
  env = {
    "PYTHONPATH": worker_env()["PYTHONPATH"],
    "IGNEOUS_JOURNAL_FLUSH_SEC": "0.2",
    "IGNEOUS_STEAL": "1",
    "IGNEOUS_STEAL_MIN_HELD_SEC": "1.0",
    "IGNEOUS_SPECULATE_MIN_HELD_SEC": "0",
  }
  actuator = autoscale.LocalPoolActuator(
    spec,
    # --batch 4: the lease batcher takes fq segments as range leases;
    # --lease-sec 20 outlives the freeze, so speculation (not expiry) is
    # what rescues the frozen worker's tail
    worker_args=["--lease-sec", "20", "--batch", "4"],
    env=env, grace_sec=60.0,
  )
  policy = autoscale.AutoscalePolicy(
    min_workers=2, max_workers=3, horizon_sec=5.0,
    hysteresis=0.2, cooldown_sec=1.0, step_max=2,
  )
  runner = campaign.CampaignRunner(
    jpath, q, actuator,
    policy=policy,
    health_config=health.HealthConfig(stall_sec=3.0),
    tick_sec=1.0, speculate=True, max_wall_sec=240.0,
  )

  # the storm, keyed to the runner's ticks: freeze a worker mid-range
  # (SIGSTOP: the flagged straggler and speculation), kill another (its
  # leases recycle at expiry, the autoscaler respawns), SIGTERM a third (a
  # graceful drain), then wake the frozen one so its late acks hit the
  # fence. Seeded jitter: each seed a different storm.
  rng = random.Random(seed)
  state = {"tick": 0, "stopped": None, "resume_at": 0,
           "stalled": 0, "killed": 0, "preempted": 0, "resumed": 0}
  stall_tick = 1 + rng.randrange(2)

  def range_holder_pids():
    # worker ids are <host>-<pid>: the live range-lease holders mapped to
    # the pool's processes, so the freeze lands mid-range
    pids = set()
    for r in q.range_leases():
      holder = r.get("holder") or ""
      if not r.get("expired") and "-" in holder:
        try:
          pids.add(int(holder.rsplit("-", 1)[1]))
        except ValueError:
          pass
    return pids

  def working(procs):
    # the live workers past their start-up that hold a range: a port
    # worker spends seconds importing torch, and a kill or SIGTERM there
    # would hit a worker with nothing in flight, which the JAX storm's
    # fast-starting workers never are
    holders = range_holder_pids()
    return [p for p in procs if p is not state["stopped"] and p.pid in holders]

  def chaos_sleep(dt):
    state["tick"] += 1
    t = state["tick"]
    actuator.reap()
    procs = [p for p in actuator.procs if p.poll() is None]
    if procs and not state["stalled"] and t >= stall_tick:
      # a worker that holds a live range: freezing a leaseless one stalls
      # nothing, and speculation would go unexercised
      holders = range_holder_pids()
      victims = [p for p in procs if p.pid in holders]
      if victims:
        victim = victims[rng.randrange(len(victims))]
        victim.send_signal(signal.SIGSTOP)
        state.update(stalled=1, stopped=victim, stall_t=time.time(),
                     resume_at=t + 8 + rng.randrange(3))
    elif procs and not state["killed"] and t >= stall_tick + 3:
      live = working(procs)
      if live:
        live[-1].send_signal(signal.SIGKILL)
        state.update(killed=1, kill_t=time.time())
    elif procs and not state["preempted"] and t >= stall_tick + 6:
      live = working(procs)
      if live:
        live[0].send_signal(signal.SIGTERM)
        state.update(preempted=1, preempt_t=time.time())
    if state["stopped"] is not None and t >= state["resume_at"]:
      # the zombie wakes mid-campaign: what it still holds was speculated
      # away or recycled, so its acks must fence
      state["stopped"].send_signal(signal.SIGCONT)
      state["stopped"] = None
      state["resumed"] = 1
    time.sleep(dt)

  try:
    with pinned(IGNEOUS_SPECULATE_MIN_HELD_SEC="0"):
      summary = runner.run(sleep_fn=chaos_sleep)
  finally:
    if state["stopped"] is not None:  # never left frozen on a fast drain
      state["stopped"].send_signal(signal.SIGCONT)
    actuator.reap()
    for p in actuator.procs:
      if p.poll() is None:
        p.kill()
        p.wait()

  _check(bool(state["stalled"] and state["killed"]),
         f"the storm never landed its faults (ticks={state['tick']}): {state}")
  _check(not summary["timed_out"], f"the campaign timed out: {summary}")
  _check(q.is_empty() and q.enqueued == 0, "the hostile queue did not drain")
  _check(q.dlq_count == 0, f"DLQ leakage: {q.dlq_ls()}")
  # completions exact: twins, steals, recycles and the waking zombie's late
  # acks never count a task twice
  _check(q.completed == n_tasks,
         f"completions drifted: tally={q.completed} tasks={n_tasks}")
  _same_layers(clean, layer_bytes(os.path.join(workdir, "layer")), "hostile")

  # the speculation ledger reconciles from the journal alone: issued on the
  # driver, won or fenced on whichever worker's ack made the done marker
  records = fleet.load_effective(jpath)
  counters = fleet.status(records)["counters"]
  spec_issued = counters.get("speculation.issued", 0)
  spec_won = counters.get("speculation.won", 0)
  spec_fenced = counters.get("speculation.fenced", 0)
  _check(spec_issued > 0,
         f"the storm never speculated: the stall was not flagged in time "
         f"(counters={counters}, history={runner.history[-5:]})")
  _check(spec_won + spec_fenced == spec_issued,
         f"speculation ledger broken: issued={spec_issued} won={spec_won} "
         f"fenced={spec_fenced}")

  # forecast fidelity: mine this journal (the task-duration model, each
  # worker's arrival, the storm's fault times), replay the campaign in the
  # simulator with speculation and stealing, and hold the forecast within
  # ±20% of the live makespan. The arrivals are each worker's first task
  # span, so the workers' start-up (torch's import) is outside both sides.
  task_spans = [r for r in records if r.get("kind") == "span" and r.get("name") == "task"]
  first_task_ts = min(r["ts"] for r in task_spans)
  # the last first resolution, not the last span end: the waking zombie's
  # interrupted spans carry the whole freeze and its acks are fenced; only
  # winners append to the completions tally, so its mtime is the finish
  last_completion = os.path.getmtime(os.path.join(q.path, "completions"))
  live_makespan = last_completion - first_task_ts
  first_seen = {}
  for r in task_spans:
    w = r.get("worker")
    if w and (w not in first_seen or r["ts"] < first_seen[w]):
      first_seen[w] = r["ts"]
  arrivals = sorted(max(ts - first_task_ts, 0.0) for ts in first_seen.values())
  model = replay.WorkloadModel.mine(records)
  # the frozen worker's interrupted span carries the freeze in its dur; the
  # ChaosSpec injects that fault, so inflated samples would count it twice
  clipped = model.clip_outliers()
  cfg = sim_mod.SimConfig(
    workers=len(arrivals), seed=seed, tasks=n_tasks,
    batch_size=4, lease_sec=20.0, range_lease=1, speculate=1, steal=1,
    steal_min_held_sec=1.0, worker_arrivals=arrivals,
    # the live runner sweeps every tick with stall_sec=3 detection latency:
    # the simulator's sweep interval is the same lag
    speculate_interval_sec=3.0,
    chaos=sim_mod.ChaosSpec(
      stall=1, kill=1, preempt=state["preempted"],
      kill_at=max(state.get("kill_t", 0) - first_task_ts, 0.1),
      preempt_at=max(state.get("preempt_t", 0) - first_task_ts, 0.1),
    ),
  )
  forecast = sim_mod.FleetSimulator(model, cfg).run()
  ratio = forecast["makespan_sec"] / max(live_makespan, 1e-9)
  _check(0.8 <= ratio <= 1.2,
         f"the simulator's forecast diverged from the live hostile run: "
         f"forecast={forecast['makespan_sec']}s live={round(live_makespan, 3)}s "
         f"(ratio {ratio:.2f}; arrivals={[round(a, 2) for a in arrivals]} "
         f"clipped={clipped} chaos={cfg.chaos})")

  return {
    "tasks": n_tasks,
    "clean_executed": n_clean,
    "completions_tally": q.completed,
    "dlq": q.dlq_count,
    "objects_compared": len(clean),
    "byte_identical": True,
    "campaign": {k: summary[k] for k in ("ticks", "actions", "speculated", "wall_sec")},
    "storm": {k: state[k] for k in ("stalled", "killed", "preempted", "resumed")},
    "speculation": {
      "issued": spec_issued, "won": spec_won, "fenced": spec_fenced,
      "duplicate_acks": counters.get("speculation.duplicate_ack", 0),
      "wasted_ms": counters.get("speculation.wasted_ms", 0),
    },
    "steal": {
      "claims": counters.get("steal.claims", 0),
      "granted": counters.get("steal.granted", 0),
      "tasks": counters.get("steal.tasks", 0),
    },
    "zombie_fenced": counters.get("zombie.delete", 0),
    "forecast": {
      "live_makespan_sec": round(live_makespan, 3),
      "sim_makespan_sec": forecast["makespan_sec"],
      "ratio": round(ratio, 3),
      "worker_arrivals": [round(a, 2) for a in arrivals],
      "outlier_durs_clipped": clipped,
      "sim_speculation": forecast["speculation"],
      "sim_steals": forecast["steals"],
    },
  }


SCENARIOS = ("faults", "preemption", "stall", "corruption", "hostile")

def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--seed", type=int, default=0,
                  help="fault schedule seed (same seed = same storm)")
  ap.add_argument("--size", type=int, default=96,
                  help="cube edge of the faults and corruption scenarios' volume")
  ap.add_argument("--keep", action="store_true",
                  help="keep the scratch dir for inspection")
  ap.add_argument("--scenario", choices=SCENARIOS + ("all",), default="faults",
                  help="faults: the storage and queue fault storm; preemption: the "
                       "worker kill storm and a zombie; stall: a stalled worker and a "
                       "backlog, which `fleet check` must flag; corruption: silent "
                       "damage at rest, which audit names and a heal repairs; hostile: "
                       "the campaign runner under a kill, freeze and preempt storm with "
                       "speculation, its forecast within ±20%%; all: every one")
  ap.add_argument("--report-out", default=None, help="write the report JSON here")
  ap.add_argument("--trace-out", default=None,
                  help="write the preemption storm's merged journal as a Perfetto "
                       "trace JSON here")
  ap.add_argument("--health-out", default=None,
                  help="write the stall scenario's `fleet check` report JSON here")
  ap.add_argument("--pipeline", action="store_true",
                  help="run every faulted run through the staged pipeline (threaded "
                       "encode, upload and prefetch); the clean reference stays serial")
  args = ap.parse_args(argv)

  # the dynamic lock checker, for this process and the workers it starts
  env = {"IGNEOUS_RACE_CHECK": "1"}
  if args.pipeline:
    # the clean runs pin the bytes serially (serial_pipeline); the drains
    # of the faulted runs read the pipeline from the environment, threads
    # forced so one core still runs the stages concurrently
    env.update(IGNEOUS_PIPELINE="1", IGNEOUS_PIPELINE_THREADS="1")
  with pinned(**env):
    return _run(args)


def _run(args) -> int:
  import igneous_tpu_torch.tasks  # noqa: F401  (registers the port's tasks)
  from .. import telemetry

  scratch = tempfile.mkdtemp(prefix="chaos-soak-")
  telemetry.reset_all()
  t0 = time.monotonic()
  chosen = SCENARIOS if args.scenario == "all" else (args.scenario,)
  try:
    rng = np.random.default_rng(args.seed)
    img = rng.integers(0, 255, (args.size, args.size, args.size // 2)).astype(np.uint8)
    report = {"seed": args.seed, "scenario": args.scenario}
    if "faults" in chosen:
      report["faults"] = run_faults_scenario(scratch, img, args.seed)
    if "preemption" in chosen:
      report["preemption"] = run_preemption_storm(scratch, args.seed,
                                                  trace_out=args.trace_out)
    if "stall" in chosen:
      report["stall"] = run_stall_health_scenario(scratch, args.seed,
                                                  health_out=args.health_out)
    if "corruption" in chosen:
      report["corruption"] = run_corruption_scenario(scratch, img, args.seed)
    if "hostile" in chosen:
      report["hostile"] = run_hostile_scenario(scratch, args.seed)
    report["counters"] = telemetry.counters_snapshot()
    report["wall_s"] = round(time.monotonic() - t0, 2)
    if args.report_out:
      with open(args.report_out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
  finally:
    if args.keep:
      print(f"scratch kept at {scratch}", file=sys.stderr)
    else:
      shutil.rmtree(scratch, ignore_errors=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
