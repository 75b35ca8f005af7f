"""Chaos soak of the port: a downsample under injected faults must write
the bytes of a run without them.

The ``faults`` scenario of ``tools/chaos_soak.py``, on the port's own
modules. Two runs over one seeded volume:

  1. clean: ingest, downsample tasks, an fq:// queue drained serially
     (``IGNEOUS_PIPELINE=off``);
  2. chaos: the same pipeline with every storage backend wrapped in
     ``chaos.ChaosStorage`` (failed puts, corrupted gets, 503 storms, a
     crash between compute and upload) and the queue in
     ``chaos.ChaosQueue`` (dropped deletes, skewed lease clocks, stalled
     workers whose late acks are fenced). Failed deliveries recycle on a
     short lease; transient faults heal after a bounded number, so the
     queue drains.

The two layers must be byte for byte equal (provenance and integrity
sidecars aside), and a poison task must end in the dead-letter queue with
its failure recorded. The pooling runs on the port's device: the card, or
the CPU with ``IGNEOUS_TORCH_DEVICE=cpu``.

Usage:
  python -m igneous_tpu_torch.tools.chaos_soak --seed 7 [--size 96] [--keep]

It prints one JSON report and exits 0 when every check held; the seed
names the fault schedule, so a failing seed replays exactly.
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


class SoakFailure(RuntimeError):
  """A check of the soak did not hold."""


def _check(cond: bool, msg: str) -> None:
  if not cond:
    raise SoakFailure(msg)


def make_tasks(path):
  # a memory target that cuts the default 96^3 volume into 8 tasks: the
  # faults must land across many leases, not one
  from .. import task_creation as tc

  return list(tc.create_downsampling_tasks(
    path, mip=0, num_mips=2, memory_target=int(6e5), compress="gzip",
  ))


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
def serial_pipeline():
  """The clean run pins the bytes on the serial loop."""
  prev = os.environ.get("IGNEOUS_PIPELINE")
  os.environ["IGNEOUS_PIPELINE"] = "off"
  try:
    yield
  finally:
    if prev is None:
      os.environ.pop("IGNEOUS_PIPELINE", None)
    else:
      os.environ["IGNEOUS_PIPELINE"] = prev


def run_pipeline(workdir: str, img, chaos_cfg=None, tag: str = ""):
  """(tasks executed, layer bytes) of one run into ``workdir``."""
  from ..chaos import ChaosQueue, chaos_storage
  from ..queues import FileQueue
  from ..volume import Volume

  layer = f"file://{workdir}/layer"
  Volume.from_numpy(img, layer, chunk_size=(32, 32, 32), compress="gzip")
  q = FileQueue(f"fq://{workdir}/q", max_deliveries=25)
  q.insert(make_tasks(layer))
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
  missing = sorted(set(clean) - set(chaos))
  extra = sorted(set(chaos) - set(clean))
  _check(not missing and not extra,
         f"key sets differ: missing={missing[:5]} extra={extra[:5]}")
  diff = [k for k in clean if clean[k] != chaos[k]]
  _check(not diff, f"{len(diff)} objects differ byte-wise: {diff[:5]}")
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


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--seed", type=int, default=0,
                  help="fault schedule seed (same seed = same storm)")
  ap.add_argument("--size", type=int, default=96,
                  help="cube edge of the synthetic volume")
  ap.add_argument("--keep", action="store_true",
                  help="keep the scratch dir for inspection")
  ap.add_argument("--scenario", choices=("faults",), default="faults",
                  help="faults: the storage and queue fault storm")
  ap.add_argument("--report-out", default=None, help="write the report JSON here")
  args = ap.parse_args(argv)

  import igneous_tpu_torch.tasks  # noqa: F401  (registers the port's tasks)
  from .. import telemetry

  scratch = tempfile.mkdtemp(prefix="chaos-soak-")
  telemetry.reset_all()
  t0 = time.monotonic()
  try:
    rng = np.random.default_rng(args.seed)
    img = rng.integers(0, 255, (args.size, args.size, args.size // 2)).astype(np.uint8)
    report = {"seed": args.seed, "scenario": args.scenario}
    report["faults"] = run_faults_scenario(scratch, img, args.seed)
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
