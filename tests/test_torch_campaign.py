"""The port's campaign runner and a flagged worker's paged split, against
the JAX package.

(a) ``CampaignRunner`` with a dummy actuator makes the JAX runner's
speculation decisions on copies of one queue and journal: the same slow
holders (tail ratio against the fleet p95), silent holders (journal-silent
past the stall window) and flagged holders, and the same twins. (b)
``campaign run --actuator textfile --iterations N`` writes the JAX CLI's
target file, summary and journal counters. (c) A lease-batcher worker that
the health plane flags after its first page round sheds the clamped
members none of whose pages ran back to the queue (``paged_splits``),
does not rerun them solo, and once a healthy worker has run them the
layer equals ``LocalTaskQueue``'s and the JAX package's, byte for byte.
"""

import json
import os
import pathlib
import shutil
import time
import types

import numpy as np
import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
import igneous_tpu.telemetry as jax_telemetry
from igneous_tpu import Volume as JaxVolume
from igneous_tpu import task_creation as jax_tc
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.observability import autoscale as jax_autoscale
from igneous_tpu.observability import campaign as jax_campaign
from igneous_tpu.observability import health as jax_health
from igneous_tpu.observability import journal as jax_journal
from igneous_tpu.observability import trace as jax_trace
from igneous_tpu.queues import FileQueue as JaxFileQueue
from igneous_tpu.queues import LocalTaskQueue as JaxLocalTaskQueue
from igneous_tpu.queues import PrintTask as JaxPrintTask
from igneous_tpu_torch import Volume, device, telemetry
from igneous_tpu_torch import task_creation as tc
from igneous_tpu_torch.cli import main as port_cli
from igneous_tpu_torch.observability import autoscale, campaign, health, journal, trace
from igneous_tpu_torch.parallel import lease_batcher, paged
from igneous_tpu_torch.queues import FileQueue, LocalTaskQueue

from test_torch_integrity import flush_local, layer_tree

PKG = {
  "jax": types.SimpleNamespace(
    FileQueue=JaxFileQueue, autoscale=jax_autoscale, campaign=jax_campaign,
    health=jax_health, journal=jax_journal, telemetry=jax_telemetry, trace=jax_trace,
  ),
  "port": types.SimpleNamespace(
    FileQueue=FileQueue, autoscale=autoscale, campaign=campaign,
    health=health, journal=journal, telemetry=telemetry, trace=trace,
  ),
}


def _reset():
  for P in PKG.values():
    P.telemetry.reset_all()
    P.trace.reset()
    P.journal.set_active(None)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_POOL_HOST", "0")
  monkeypatch.setenv("IGNEOUS_QUEUE_RECYCLE_SEC", "0")
  for name in ("IGNEOUS_PAGE_SHAPE", "IGNEOUS_PAGE_BATCH", "IGNEOUS_PIPELINE", "IGNEOUS_JOURNAL",
               "QUEUE_URL", "IGNEOUS_STEAL", "IGNEOUS_QUEUE_SEG_TASKS"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  _reset()
  yield
  _reset()
  device.reset_device()


class _Dummy:
  """An actuator that only remembers its target."""

  name = "dummy"

  def __init__(self, n=0):
    self.n = n

  def current(self):
    return self.n

  def scale_to(self, n):
    self.n = n

  def reap(self):
    pass

  def shutdown(self):
    pass


def _span(worker, i, ts, dur):
  return {"kind": "span", "worker": worker, "trace": f"{worker}{i}", "span": f"s{worker}{i}",
          "parent": None, "name": "task", "ts": ts, "dur": dur, "task": "PrintTask",
          "attempt": 1}


def _campaign_fixture(root: pathlib.Path, now: float):
  """A queue of four 4-task ranges held by ``flagged``, ``slow``,
  ``silent`` and ``fast``, and a journal where ``slow`` takes 5 s a task,
  ``fast`` and ``flagged`` 0.1 s, and ``silent`` never wrote."""
  os.environ["IGNEOUS_QUEUE_SHARDS"] = "4"
  try:
    JaxFileQueue(f"fq://{root / 'q'}").insert_batch(
      [JaxPrintTask(f"t{i}").to_json() for i in range(16)], total=16)
  finally:
    del os.environ["IGNEOUS_QUEUE_SHARDS"]
  for who in ("flagged", "slow", "silent", "fast"):
    got = JaxFileQueue(f"fq://{root / 'q'}", worker_id=who).lease_batch(600, max_tasks=4)
    assert len(got) == 4
  q = JaxFileQueue(f"fq://{root / 'q'}")
  for name in os.listdir(q.meta_dir):
    meta = q._read_meta(name)
    meta["leased_at"] = now - (1000.0 if meta.get("holder") == "silent" else 30.0)
    q._write_meta(name, meta)
  records = []
  for i in range(6):
    records.append(_span("slow", i, now - 40 + 5 * i, 5.0))
    records.append(_span("fast", i, now - 10 + i, 0.1))
    records.append(_span("flagged", i, now - 10 + i, 0.1))
  lines = "\n".join(json.dumps(r) for r in records) + "\n"
  (root / "q" / "journal").mkdir()
  (root / "q" / "journal" / "w-000000.jsonl").write_text(lines)
  return records


def test_campaign_runner_speculates_as_the_reference(tmp_path, monkeypatch):
  monkeypatch.setenv("IGNEOUS_SPECULATE_MIN_HELD_SEC", "0")
  now = time.time()
  records = _campaign_fixture(tmp_path / "base", now)
  report = {"flagged_workers": ["flagged"], "fleet": {"p95_task_ms": 200.0}}
  got = {}
  for who, P in PKG.items():
    root = tmp_path / who
    shutil.copytree(tmp_path / "base", root)
    q = P.FileQueue(f"fq://{root / 'q'}")
    runner = P.campaign.CampaignRunner(
      f"file://{root / 'q' / 'journal'}", q, _Dummy(),
      health_config=P.health.HealthConfig(stall_sec=60.0), speculate=True, tick_sec=0.0,
    )
    slow = runner._slow_holders(report, records)
    silent = runner._silent_holders(records, now=now)
    n = runner._speculate(report, records)
    pairs = sorted(
      json.loads((root / "q" / "spec" / f).read_text())["holder"]
      for f in os.listdir(root / "q" / "spec") if f.startswith("pair_")
    )
    got[who] = (slow, silent, n, pairs)
  assert got["port"] == got["jax"]
  assert got["port"] == ({"slow"}, {"silent"}, 12, ["flagged", "silent", "slow"])


def test_campaign_tick_decides_as_the_reference(tmp_path, monkeypatch):
  """One whole tick on each package: the controller's decision (less its
  timestamp), the flags file and the twins."""
  monkeypatch.setenv("IGNEOUS_SPECULATE_MIN_HELD_SEC", "0")
  monkeypatch.setenv("IGNEOUS_HEALTH_STALL_SEC", "60")
  now = time.time()
  _campaign_fixture(tmp_path / "base", now)
  got = {}
  for who, P in PKG.items():
    _reset()
    root = tmp_path / who
    shutil.copytree(tmp_path / "base", root)
    runner = P.campaign.CampaignRunner(
      f"file://{root / 'q' / 'journal'}", P.FileQueue(f"fq://{root / 'q'}"), _Dummy(1),
      policy=P.autoscale.AutoscalePolicy(min_workers=0, max_workers=4, cooldown_sec=0.0),
      tick_sec=0.0, speculate=True,
    )
    d = runner.tick(now=now)
    d.pop("ts")
    flags = json.loads((root / "q" / "journal" / "health" / "flags.json").read_text())
    got[who] = (d, sorted(flags["stragglers"]), sorted(
      f.split("_")[0] for f in os.listdir(root / "q" / "spec")))
  assert got["port"] == got["jax"]
  assert got["port"][0]["speculated"] >= 4


@pytest.mark.parametrize("iterations", [1, 3])
def test_campaign_run_cli_as_the_reference(tmp_path, capsys, iterations):
  now = time.time()
  _campaign_fixture(tmp_path / "base", now)
  got = {}
  for who in ("jax", "port"):
    _reset()
    root = tmp_path / who
    shutil.copytree(tmp_path / "base", root)
    target = root / "desired.json"
    args = ["campaign", "run", "-q", f"fq://{root / 'q'}", "--actuator", "textfile",
            "--target-file", str(target), "--iterations", str(iterations),
            "--tick-sec", "0", "--min-workers", "0", "--max-workers", "3",
            "--cooldown-sec", "0", "--no-speculate", "--json"]
    if who == "jax":
      res = CliRunner().invoke(jax_cli, args)
      rc, out = res.exit_code, res.stdout
    else:
      capsys.readouterr()
      rc = port_cli(args)
      out = capsys.readouterr().out
    lines = [json.loads(line) for line in out.strip().splitlines()]
    for d in lines[:-1]:
      d.pop("ts")
    summary = lines[-1]
    summary.pop("wall_sec")
    fleet = summary.pop("fleet_status")
    written = json.loads(target.read_text())
    written.pop("ts")
    counters = fleet["counters"]
    got[who] = (rc, lines[:-1], summary, written,
                {k: v for k, v in counters.items() if k.startswith(("autoscale.", "campaign."))})
  assert got["port"] == got["jax"]
  rc, ticks, summary, written, counters = got["port"]
  # a tick is narrated when the runner sleeps after it: not after the last
  assert rc == 3 and len(ticks) == iterations - 1  # the leases are still held
  assert summary["ticks"] == iterations
  assert counters.get("autoscale.scale_up", 0) >= 1


# ---------------------------------------------------------------------------
# (c) a flagged worker's paged split


SHAPE = (601, 421, 8)


def _layer(root: pathlib.Path, who: str) -> str:
  path = f"file://{root / 'layer'}"
  data = np.random.default_rng(7).integers(0, 256, SHAPE, dtype=np.uint8)
  (JaxVolume if who == "jax" else Volume).from_numpy(
    data, path, resolution=(8, 8, 40), chunk_size=(32, 32, 8))
  return path


def _layer_files(root):
  flush_local()
  return layer_tree(root / "layer")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
  """The JAX package's and the port's ``LocalTaskQueue`` on the layer."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv(device.ENV, "cpu")
    mp.setenv("IGNEOUS_POOL_HOST", "0")
    device.reset_device()
    for who, (make, Queue) in {
      "jax": (jax_tc.create_downsampling_tasks, JaxLocalTaskQueue),
      "port": (tc.create_downsampling_tasks, LocalTaskQueue),
    }.items():
      root = tmp_path_factory.mktemp(f"ref_{who}")
      path = _layer(root, who)
      Queue(parallel=1).insert(
        make(path, mip=0, num_mips=2, memory_target=200000))
      out[who] = _layer_files(root)
  device.reset_device()
  return out


def test_a_flagged_worker_sheds_its_unstarted_paged_members(tmp_path, reference, monkeypatch):
  assert reference["port"] == reference["jax"]
  path = _layer(tmp_path, "port")
  tasks = list(tc.create_downsampling_tasks(path, mip=0, num_mips=2, memory_target=200000))
  assert len(tasks) == 20  # 12 full 128x128 cutouts, 8 clamped at the far edges
  spec = f"fq://{tmp_path / 'q'}"
  q = FileQueue(spec)
  monkeypatch.setenv("IGNEOUS_QUEUE_SHARDS", "1")
  q.insert_batch(tasks, total=len(tasks))
  monkeypatch.setenv("IGNEOUS_PAGE_BATCH", "8")  # several page rounds

  rounds = []
  run_round = paged.PagedPyramid.run_round

  def counted(self):
    rounds.append(len(self._entries) - self._next)
    return run_round(self)

  monkeypatch.setattr(paged.PagedPyramid, "run_round", counted)
  # the health plane flags this worker once its first page round ran
  monkeypatch.setattr(lease_batcher.LeaseBatcher, "_straggler_flagged",
                      lambda self: bool(rounds))
  solo = []
  monkeypatch.setattr(lease_batcher.LeaseBatcher, "_run_round_inner",
                      _spy_solo(lease_batcher.LeaseBatcher._run_round_inner, solo))
  executed, stats = lease_batcher.poll_batched(
    FileQueue(spec, worker_id="flagged"), batch_size=20, task_budget=20,
    stop_fn=lambda executed, empty: empty or executed > 0,
  )
  shed = stats["paged_splits"]
  # 74 pages of 8 clamped members at 8 a round: the first round starts
  # the first member (12 pages), which finishes its 4 pages on this worker
  assert rounds == [74, 4] and shed == 7
  assert stats["dispatches"]["downsample"] == 1 and stats["dispatches"]["downsample_paged"] == 2
  assert executed == 20 - shed and stats["released"] == shed and stats["solo"] == 0
  assert not solo  # a shed member is never rerun solo
  assert q.completed == 20 - shed and q.enqueued == shed

  monkeypatch.undo()  # a healthy worker, unpatched, with the default knobs
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_QUEUE_RECYCLE_SEC", "0")
  monkeypatch.setenv("IGNEOUS_POOL_HOST", "0")
  executed, stats = lease_batcher.poll_batched(
    FileQueue(spec, worker_id="healthy"), batch_size=8,
    stop_fn=lambda executed, empty: empty,
  )
  assert executed == shed and stats["paged_splits"] == 0
  assert stats["dispatches"]["downsample_paged"] >= 1
  assert q.completed == 20 and q.enqueued == 0
  assert _layer_files(tmp_path) == reference["port"]


def _spy_solo(inner, solo):
  """Wrap ``_run_round_inner`` to record every member that runs its own
  ``execute`` (the solo path; a group member never does)."""

  def wrapped(self, members):
    for task, _lease in members:
      task.execute = types.MethodType(
        lambda t, _run=task.execute: (solo.append(t), _run())[1], task)
    return inner(self, members)

  return wrapped
