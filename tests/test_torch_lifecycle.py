"""The port's worker lifecycle: heartbeats, fencing, drains, signals,
preemption watchers and spawned workers.

A task longer than its 0.5 s lease runs exactly once under the heartbeat
(as the JAX package's does), and without it the late ack is fenced and
the expired delivery dead-letters; a heartbeat remaps the lease token
that the poll loop later deletes; a drain finishes only the task in
flight, and the lease batcher releases the members it had not started;
signal handlers are installed and restored; the sentinel and the
metadata-URL watchers (a local stdlib ``http.server``) drain; a
subprocess ``execute --drain-sentinel`` exits 83 holding no lease;
``LocalTaskQueue(parallel=2, max_deliveries=2)`` records the dead letters
of the serial run, and ``execute -p 2`` completes every task once.
"""

import http.server
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import pytest

from igneous_tpu.queues.filequeue import FileQueue as JaxFileQueue
from igneous_tpu.queues.heartbeat import LeaseHeartbeat as JaxLeaseHeartbeat
from igneous_tpu.tasks import TouchFileTask as JaxTouchFileTask
from igneous_tpu_torch import device, telemetry
from igneous_tpu_torch.lifecycle import (
  EXIT_PREEMPTED, PreemptionWatcher, StopFlag, install_signal_handlers,
)
from igneous_tpu_torch.parallel.lease_batcher import LeaseBatcher
from igneous_tpu_torch.queues import FileQueue, LeaseHeartbeat, LocalTaskQueue, RegisteredTask
from igneous_tpu_torch.tasks import FailTask, SleepTask, TouchFileTask

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_QUEUE_RECYCLE_SEC", "0")
  monkeypatch.delenv("IGNEOUS_HEARTBEAT_SEC", raising=False)
  device.reset_device()
  telemetry.reset_all()
  yield
  device.reset_device()


class CountedSleepTask(RegisteredTask):
  """Appends a line to ``path`` and sleeps: its runs are countable."""

  def __init__(self, path: str, seconds: float = 1.0):
    self.path = path
    self.seconds = seconds

  def execute(self):
    with open(self.path, "a") as f:
      f.write("ran\n")
    time.sleep(float(self.seconds))


_DRAIN = {"flag": None}


class DrainingTask(RegisteredTask):
  """Touches ``path`` and sets the test's drain flag."""

  def __init__(self, path: str):
    self.path = path

  def execute(self):
    open(self.path, "a").close()
    _DRAIN["flag"].set("test drain")


@pytest.mark.parametrize("package", ["jax", "port"])
def test_heartbeat_renews_and_remaps_tokens(tmp_path, package):
  Q, HB, Touch = (
    (JaxFileQueue, JaxLeaseHeartbeat, JaxTouchFileTask) if package == "jax"
    else (FileQueue, LeaseHeartbeat, TouchFileTask)
  )
  q = Q(f"fq://{tmp_path / 'q'}")
  q.insert([Touch(str(tmp_path / "a"))])
  q.insert_batch([Touch(str(tmp_path / f"s{i}")) for i in range(3)])
  hb = HB(q, 0.8, interval=0.25)
  leased = q.lease_batch(0.8, max_tasks=4)
  keys = [hb.track(t) for _, t in leased]
  time.sleep(0.45)
  hb.beat()
  assert hb.renewals == 4
  time.sleep(0.45)  # past the first deadline: only the renewal keeps them
  classic = [k for k in keys if isinstance(k, str)]
  assert len(classic) == 1 and hb.current(classic[0]) != classic[0]
  assert q.delete(classic[0]) is False  # the original token is dead
  assert all(q.delete(hb.untrack(k)) for k in keys)
  assert q.completed == 4 and q.leased == 0


@pytest.mark.parametrize("heartbeat", [True, False])
def test_a_long_task_runs_once_under_the_heartbeat(tmp_path, heartbeat):
  """Two workers on one queue, a 1 s task, the first worker's lease 0.5 s.
  With the heartbeat (every lease/3) it runs once; without it the second
  worker (its lease 5 s) takes the expired lease, the first worker's late
  ack is fenced (``zombie.delete``), and one completion is tallied all
  the same."""
  runs = tmp_path / "runs"
  FileQueue(f"fq://{tmp_path / 'q'}").insert([CountedSleepTask(str(runs))])
  hb = None if heartbeat else 0
  results = []

  def worker(delay, lease):
    time.sleep(delay)
    q = FileQueue(f"fq://{tmp_path / 'q'}")
    results.append(q.poll(lease_seconds=lease, heartbeat_seconds=hb,
                          stop_fn=lambda executed, empty: empty or executed))

  threads = [threading.Thread(target=worker, args=a) for a in ((0, 0.5), (0.7, 5))]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  q = FileQueue(f"fq://{tmp_path / 'q'}")
  assert q.completed == 1 and q.enqueued == 0
  if heartbeat:
    assert runs.read_text() == "ran\n" and sorted(results) == [0, 1]
    assert "zombie.delete" not in telemetry.counters_snapshot()
  else:
    assert runs.read_text() == "ran\nran\n"
    assert telemetry.counters_snapshot()["zombie.delete"] == 1


def test_without_the_heartbeat_an_overrun_is_contained(tmp_path):
  """``max_deliveries=1``: the overrunning task's ack is fenced and its
  expired lease dead-letters with the expiry as its reason."""
  q = FileQueue(f"fq://{tmp_path / 'q'}", max_deliveries=1)
  q.insert([CountedSleepTask(str(tmp_path / "runs"), 0.5)])
  # the loop counts the delivery it ran; its ack is fenced
  assert q.poll(lease_seconds=0.2, heartbeat_seconds=0,
                stop_fn=lambda executed, empty: empty) == 1
  assert telemetry.counters_snapshot()["zombie.delete"] == 1
  assert (tmp_path / "runs").read_text() == "ran\n"
  assert q.completed == 0 and q.enqueued == 0 and q.dlq_count == 1
  [rec] = q.dlq_ls()
  assert rec["failures"][-1]["error"].startswith("lease expired after delivery 1")


def test_a_drain_finishes_only_the_task_in_flight(tmp_path):
  q = FileQueue(f"fq://{tmp_path / 'q'}")
  q.insert_batch([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(6)])
  flag = StopFlag()
  executed = q.poll(lease_seconds=30, drain_flag=flag,
                    before_fn=lambda task: flag.set("drain mid-task"))
  assert executed == 1 and len(list(tmp_path.glob("t*"))) == 1
  assert q.completed == 1 and q.leased == 0 and q.enqueued == 5


def test_the_batcher_releases_the_members_it_had_not_started(tmp_path):
  """Solo members run in order; the first requests a drain: it finishes,
  the round's other members and the pre-leased next round go back."""
  flag = _DRAIN["flag"] = StopFlag()
  q = FileQueue(f"fq://{tmp_path / 'q'}")
  q.insert([DrainingTask(str(tmp_path / "d0"))])
  q.insert([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(7)])
  batcher = LeaseBatcher(q, batch_size=4, lease_seconds=30, drain_flag=flag)
  # the draining task must run first: lease it alone, then three more
  first = q.lease_batch(30, max_tasks=8)
  order = sorted(first, key=lambda m: type(m[0]).__name__ != "DrainingTask")
  for _, tok in order[4:]:
    q.release(tok)
  batcher.run_round(order[:4])
  assert batcher.stats["executed"] == 1 and batcher.stats["released"] == 3
  assert (tmp_path / "d0").exists() and not list(tmp_path.glob("t*"))
  assert q.leased == 0 and q.enqueued == 7 and q.completed == 1
  assert batcher.poll() == 1  # a set drain returns at once, leasing nothing
  assert q.leased == 0


def test_signal_handlers_are_installed_and_restored():
  before = signal.getsignal(signal.SIGTERM)
  flag = StopFlag()
  restore = install_signal_handlers(flag)
  try:
    assert signal.getsignal(signal.SIGTERM) is not before
    os.kill(os.getpid(), signal.SIGTERM)
    for _ in range(500):
      if flag.is_set():
        break
      time.sleep(0.01)
    assert flag.is_set() and flag.reason == "SIGTERM"
  finally:
    restore()
  assert signal.getsignal(signal.SIGTERM) is before
  # off the main thread nothing is installed
  out = []
  t = threading.Thread(target=lambda: out.append(install_signal_handlers(StopFlag())))
  t.start()
  t.join()
  out[0]()
  assert signal.getsignal(signal.SIGTERM) is before


def test_the_sentinel_watcher_drains(tmp_path, monkeypatch):
  sentinel = tmp_path / "preempt"
  monkeypatch.setenv("IGNEOUS_PREEMPT_SENTINEL", str(sentinel))
  flag = StopFlag()
  with PreemptionWatcher(flag, interval=0.02) as w:
    assert w.sentinel == str(sentinel)
    time.sleep(0.1)
    assert not flag.is_set()
    sentinel.touch()
    for _ in range(500):
      if flag.is_set():
        break
      time.sleep(0.01)
  assert flag.reason == "sentinel"
  assert PreemptionWatcher(StopFlag(), sentinel="").start()._thread is None


def test_the_metadata_url_watcher_drains():
  """A local http.server stands in for the metadata endpoint: the watcher
  sends the Metadata-Flavor header and drains once the body reads TRUE."""
  state = {"body": b"FALSE", "headers": []}

  class Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
      state["headers"].append(self.headers.get("Metadata-Flavor"))
      self.send_response(200)
      self.end_headers()
      self.wfile.write(state["body"])

    def log_message(self, *args):
      pass

  server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
  threading.Thread(target=server.serve_forever, daemon=True).start()
  try:
    url = f"http://127.0.0.1:{server.server_address[1]}/preempted"
    flag = StopFlag()
    w = PreemptionWatcher(flag, metadata_url=url, interval=0.02)
    assert w.check() is None
    with w:
      time.sleep(0.1)
      assert not flag.is_set()
      state["body"] = b"TRUE\n"
      for _ in range(500):
        if flag.is_set():
          break
        time.sleep(0.01)
    assert flag.reason == "preempted"
    assert set(state["headers"]) == {"Google"}
    # an unreachable endpoint never drains a healthy worker
    assert PreemptionWatcher(StopFlag(), metadata_url="http://127.0.0.1:9/x").check() is None
  finally:
    server.shutdown()


def _env():
  return dict(os.environ, PYTHONPATH=str(REPO), IGNEOUS_TORCH_DEVICE="cpu",
              IGNEOUS_QUEUE_RECYCLE_SEC="0")


def test_execute_drain_sentinel_exits_83_holding_no_lease(tmp_path):
  q = FileQueue(f"fq://{tmp_path / 'q'}")
  q.insert_batch([SleepTask(0.3) for _ in range(20)])
  sentinel = tmp_path / "drain"
  proc = subprocess.Popen(
    [sys.executable, "-m", "igneous_tpu_torch", "execute", f"fq://{tmp_path / 'q'}",
     "--drain-sentinel", str(sentinel), "--lease-sec", "30", "-q", "--batch", "2"],
    cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
  )
  try:
    deadline = time.time() + 60
    while q.completed < 2 and time.time() < deadline:
      time.sleep(0.05)
    sentinel.touch()
    out, err = proc.communicate(timeout=60)
  finally:
    proc.kill()
  assert proc.returncode == EXIT_PREEMPTED, err
  assert "drained (sentinel)" in out
  snap = q.depth_snapshot()
  assert snap["leased"] == 0 and snap["completed"] >= 2
  assert snap["completed"] + snap["enqueued"] == 20


def test_local_queue_in_two_processes_records_the_serial_dead_letters(tmp_path, monkeypatch):
  monkeypatch.setenv("IGNEOUS_PIPELINE", "off")
  tasks = [TouchFileTask(str(tmp_path / "a")), FailTask("poison"),
           TouchFileTask(str(tmp_path / "b"))]
  letters = {}
  for parallel in (1, 2):
    q = LocalTaskQueue(parallel=parallel, max_deliveries=2)
    q.insert(tasks)
    letters[parallel] = (q.dead_letters, q.completed, q.inserted)
  assert letters[2] == letters[1]
  # the dead letter is the inserted payload, its trace identity included
  assert letters[1][0] == [{"payload": tasks[1].to_json(),
                            "error": "RuntimeError: poison"}]


def test_execute_in_two_spawned_workers_completes_every_task_once(tmp_path):
  q = FileQueue(f"fq://{tmp_path / 'q'}")
  q.insert_batch([TouchFileTask(str(tmp_path / "out" / f"t{i}")) for i in range(12)], total=12)
  proc = subprocess.run(
    [sys.executable, "-m", "igneous_tpu_torch", "-p", "2", "execute",
     f"fq://{tmp_path / 'q'}", "-x", "-q", "--lease-sec", "60"],
    cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120,
  )
  assert proc.returncode == 0, proc.stderr
  assert sorted(os.listdir(tmp_path / "out")) == sorted(f"t{i}" for i in range(12))
  snap = q.depth_snapshot()
  assert (snap["completed"], snap["enqueued"], snap["leased"]) == (12, 0, 0)


def test_execute_without_cuda_raises_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
  """A worker never quietly runs on the CPU: with no device asked for and
  no CUDA it raises before leasing anything."""
  import torch

  from igneous_tpu_torch.cli import main as cli_main

  q = FileQueue(f"fq://{tmp_path / 'q'}")
  q.insert([TouchFileTask(str(tmp_path / "t"))])
  monkeypatch.delenv(device.ENV, raising=False)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  device.reset_device()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cli_main(["execute", f"fq://{tmp_path / 'q'}", "-x"])
  assert q.depth_snapshot()["leased"] == 0 and not (tmp_path / "t").exists()
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  assert cli_main(["execute", f"fq://{tmp_path / 'q'}", "-x", "-q"]) == 0
  assert (tmp_path / "t").exists()
