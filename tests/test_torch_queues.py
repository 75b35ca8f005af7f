"""The port's fq:// queue against the JAX package's, state for state.

(a) One script of queue operations (classic inserts and segments,
lease, lease_batch, renew with the old token stale, ack, nack with a
reason, release, deliveries exhausted into ``dlq/`` by nack and by
expiry, ``fsck(repair=True)``, ``rezero``, ``reset_deliveries``,
``purge``) runs on both packages' ``FileQueue`` in separate directories,
with ``uuid4`` and the lease pick made deterministic: after every step
``depth_snapshot()``, the queue counters, ``dlq_ls()`` without timestamps,
the fsck report and the whole directory tree (lease deadlines and meta
times normalised) are equal. (b) Each package's poll loop drains a queue
that the other inserted. (c) ``queue status|release --reset-deliveries|
fsck|dlq ls|retry|purge|cp|mv`` print what the JAX CLI prints on the same
queue. (d) A queue with a live ``spec/`` pair or ``steal/`` claim leases,
acks and renews in the port as in the JAX package.
"""

import json
import os
import pathlib
import random
import re
import time
import types
import uuid

import pytest
from click.testing import CliRunner

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
import igneous_tpu.telemetry as jax_telemetry
from igneous_tpu.cli import main as jax_cli
from igneous_tpu.queues import filequeue as jax_filequeue
from igneous_tpu.queues.filequeue import FileQueue as JaxFileQueue
from igneous_tpu.queues.filequeue import StaleLeaseError as JaxStaleLeaseError
from igneous_tpu.tasks import TouchFileTask as JaxTouchFileTask
from igneous_tpu_torch import device, telemetry
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import filequeue as port_filequeue
from igneous_tpu_torch.queues import FileQueue, StaleLeaseError, TaskQueue
from igneous_tpu_torch.tasks import TouchFileTask

PACKAGES = {
  "jax": (JaxFileQueue, JaxStaleLeaseError),
  "port": (FileQueue, StaleLeaseError),
}


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  monkeypatch.setenv("IGNEOUS_QUEUE_RECYCLE_SEC", "0")
  for name in ("IGNEOUS_QUEUE_SHARDS", "IGNEOUS_QUEUE_SEG_TASKS"):
    monkeypatch.delenv(name, raising=False)
  device.reset_device()
  yield
  device.reset_device()


@pytest.fixture
def deterministic(monkeypatch):
  """``uuid4`` from a counter (``reset()`` restarts it) and the lease
  pick always the first name of the window: both packages then name
  every file alike and lease the same task at every step."""
  state = {"n": 0}

  def uuid4():
    state["n"] += 1
    return uuid.UUID(int=state["n"])

  # only the queues' names: the JAX package's tasks mint trace ids too
  for module in (jax_filequeue, port_filequeue):
    monkeypatch.setattr(module, "uuid", types.SimpleNamespace(uuid4=uuid4))
  monkeypatch.setattr(random, "randrange", lambda n: 0)
  return lambda: state.update(n=0)


_LEASE_NAME = re.compile(r"^\d+\.\d{3}--")


def _tree(root: pathlib.Path) -> dict:
  """Every file of a queue directory: lease deadlines in names and the
  times and holders in meta files normalised."""
  out = {}
  for p in sorted(root.rglob("*")):
    if not p.is_file():
      continue
    rel = str(p.relative_to(root))
    parts = rel.split("/")
    parts[-1] = _LEASE_NAME.sub("T--", parts[-1])
    data = p.read_bytes()
    if parts[0] == "meta":
      meta = json.loads(data)
      meta.pop("leased_at", None)
      if "holder" in meta:
        meta["holder"] = "H"
      for f in meta.get("failures", []):
        f.pop("time", None)
      data = json.dumps(meta, sort_keys=True).encode()
    out["/".join(parts)] = data
  return out


def _dlq(q) -> list:
  recs = q.dlq_ls()
  for rec in recs:
    for f in rec["failures"]:
      f.pop("time", None)
  return recs


def _counters(who) -> dict:
  snap = jax_telemetry.counters_snapshot() if who == "jax" else telemetry.counters_snapshot()
  return {k: v for k, v in snap.items()
          if k.split(".")[0] in ("zombie", "dlq", "tasks", "drain")}


def _payloads(root: pathlib.Path, n: int, tag: str) -> list:
  """JAX-serialized TouchFileTask payloads (the port runs them as they are)."""
  return [JaxTouchFileTask(str(root / "out" / f"{tag}{i}")).to_json() for i in range(n)]


def _script(who: str, root: pathlib.Path, payloads, reset_ids, monkeypatch):
  """Run the script on one package's queue; returns [(step, observation)]."""
  FQ, Stale = PACKAGES[who]
  (jax_telemetry.reset_counters if who == "jax" else telemetry.reset_all)()
  reset_ids()
  monkeypatch.setenv("IGNEOUS_QUEUE_SEG_TASKS", "256")
  qdir = root / "q"
  q = FQ(f"fq://{qdir}", max_deliveries=2)
  obs = []

  def snap(step, extra=None):
    obs.append((step, {
      "depth": q.depth_snapshot(), "files": q.queue_files, "counters": _counters(who),
      "dlq": _dlq(q), "tree": _tree(qdir), "extra": extra,
    }))

  classic, segmented = payloads
  q.insert(classic)
  snap("insert 40 classic")
  q.insert_batch(segmented, total=len(segmented))
  snap("insert_batch 3000 at 256")

  task, token = q.lease(60)
  time.sleep(0.01)  # a renewal names the lease by its new deadline (ms)
  new = q.renew(token, 60)
  stale_renew = False
  try:
    q.renew(token, 60)
  except Stale:
    stale_renew = True
  snap("lease, renew", [type(task).__name__, new != token, stale_renew])
  snap("stale delete then current delete", [q.delete(token), q.delete(new)])

  got = q.lease_batch(60, max_tasks=50)
  tokens = [t for _, t in got]
  kinds = [type(t).__name__ for t in tokens]
  acked = q.ack_batch(tokens[:30])
  q.nack_batch(tokens[30:35], "boom", requeue=True)
  for t in tokens[35:39]:
    q.release(t)
  acked += q.ack_batch(tokens[39:])
  snap("lease_batch 50: ack 41, nack 5, release 4", [kinds, acked])

  got = q.lease_batch(60, max_tasks=9)
  q.nack_batch([t for _, t in got], "second")
  snap("second deliveries nacked into dlq", len(got))

  got = q.lease_batch(60, max_tasks=20)
  tokens = [t for _, t in got]
  q.nack(tokens[3], "member failed")
  q.release(tokens[4])
  acked = q.ack_batch(tokens[5:])
  snap("segment: carve a failed member, release one, ack 15", acked)

  # a segment leased briefly twice: its second expiry dead-letters it
  for _ in range(2):
    got = q.lease_batch(0.5, max_tasks=12)
    snap("brief lease", len(got))
    time.sleep(0.6)
    q._recycle_expired(force=True)
    snap("expired", None)

  qdir_queue = qdir / "queue"
  (qdir_queue / "garbage.json").write_text("not a payload")
  (qdir / "leased" / "badname.json").write_text(classic[0])
  snap("fsck", q.fsck(repair=False))
  snap("fsck repair", q.fsck(repair=True))
  snap("reset_deliveries", q.reset_deliveries())
  snap("dlq_retry 3", q.dlq_retry(sorted(os.listdir(qdir / "dlq"))[:3]))
  q.rezero()
  snap("rezero", None)
  snap("dlq_purge", q.dlq_purge())
  q.purge()
  snap("purge", None)
  return obs


def test_same_script_on_both_queues(tmp_path, deterministic, monkeypatch):
  payloads = (_payloads(tmp_path, 40, "c"), _payloads(tmp_path, 3000, "s"))
  runs = {who: _script(who, tmp_path / who, payloads, deterministic, monkeypatch)
          for who in ("jax", "port")}
  assert [s for s, _ in runs["port"]] == [s for s, _ in runs["jax"]]
  for (step, got), (_, want) in zip(runs["port"], runs["jax"]):
    for key in want:
      assert got[key] == want[key], (step, key)
  steps = dict(runs["port"])
  assert steps["insert_batch 3000 at 256"]["files"] == 40 + 16
  assert steps["lease, renew"]["extra"] == ["TouchFileTask", True, True]
  assert steps["stale delete then current delete"]["extra"] == [False, True]
  assert len(steps["second deliveries nacked into dlq"]["dlq"]) == 9
  assert any(k.startswith("dlq/task_") for k in steps["expired"]["tree"])
  assert steps["fsck"]["extra"]["malformed_tasks"] == ["garbage.json"]
  assert steps["purge"]["depth"]["enqueued"] == 0


@pytest.mark.parametrize("inserter,poller", [("jax", "port"), ("port", "jax")])
def test_each_package_drains_the_others_queue(tmp_path, inserter, poller):
  """Classic files and segments inserted by one package, leased, executed
  and acked by the other's poll loop: every TouchFileTask runs once."""
  Touch = JaxTouchFileTask if inserter == "jax" else TouchFileTask
  tasks = [Touch(str(tmp_path / "out" / f"t{i}")) for i in range(30)]
  PACKAGES[inserter][0](f"fq://{tmp_path / 'q'}").insert(tasks[:10])
  PACKAGES[inserter][0](f"fq://{tmp_path / 'q'}").insert_batch(tasks[10:], total=20)
  q = PACKAGES[poller][0](f"fq://{tmp_path / 'q'}")
  executed = q.poll(lease_seconds=30, stop_fn=lambda executed, empty: empty)
  assert executed == 30
  assert sorted(os.listdir(tmp_path / "out")) == sorted(f"t{i}" for i in range(30))
  snap = q.depth_snapshot()
  assert (snap["inserted"], snap["completed"], snap["enqueued"], snap["dlq"]) == (30, 30, 0, 0)


@pytest.mark.parametrize("sidecar", ["spec", "steal"])
def test_a_live_survival_sidecar_is_read(tmp_path, sidecar, monkeypatch):
  """A live speculation pair (``spec``) or steal claim (``steal``) on a
  held range: each package leases, renews and acks through it, with the
  same tallies and the same files left behind."""
  monkeypatch.setenv("IGNEOUS_SPECULATE_MIN_HELD_SEC", "0")
  monkeypatch.setenv("IGNEOUS_STEAL_MIN_HELD_SEC", "0")
  payloads = [JaxTouchFileTask(str(tmp_path / f"t{i}")).to_json() for i in range(6)]
  seen = {}
  for who, (FQ, _stale) in PACKAGES.items():
    qdir = tmp_path / who
    q = FQ(f"fq://{qdir}", worker_id="holder")
    q.insert_batch(payloads)
    held = q.lease_batch(30, max_tasks=6)
    held[0][1].mark_started()
    time.sleep(0.002)  # past the millisecond leased_at is rounded to
    other = FQ(f"fq://{qdir}", worker_id="other")
    if sidecar == "spec":
      assert other.speculate_flagged({"holder"}) == 6
    else:
      assert other.steal_claim() == held[0][1].parent.segid
    assert os.listdir(qdir / sidecar)
    q.renew(held[0][1], 30)  # services a claim
    got = other.lease_batch(30, max_tasks=6)  # the twin, or the granted tail
    acked = q.ack_batch([t for _x, t in held]) + other.ack_batch([t for _x, t in got])
    seen[who] = {
      "other": len(got), "acked": acked, "completed": q.completed,
      "won": q.speculation_won, "fenced": q.speculation_fenced,
      "empty": q.is_empty(), "steal": sorted(os.listdir(qdir / "steal"))
      if (qdir / "steal").exists() else None,
    }
  assert seen["port"] == seen["jax"]
  assert seen["port"]["completed"] == 6 and seen["port"]["empty"]
  if sidecar == "spec":
    assert seen["port"]["other"] == 6 and seen["port"]["fenced"] == 6
  else:
    assert seen["port"]["other"] == 2 and seen["port"]["steal"] == []


# ---------------------------------------------------------------------------
# the queue commands


def _jax(args) -> str:
  res = CliRunner().invoke(jax_cli, args, catch_exceptions=False)
  assert res.exit_code == 0, res.output
  return res.output


def _port(args, capsys) -> str:
  capsys.readouterr()
  assert cli_main(args) == 0
  return capsys.readouterr().out


def _queue_state(root: pathlib.Path, who: str, payloads):
  """A queue with pending, leased, nacked and dead-lettered tasks."""
  Q = PACKAGES[who][0]
  q = Q(f"fq://{root / 'q'}", max_deliveries=1)
  q.insert(payloads[:6])
  q.insert_batch(payloads[6:], total=20)
  got = q.lease_batch(300, max_tasks=9)
  q.nack_batch([t for _, t in got[:3]], "boom")  # first delivery: dead letters
  q.ack_batch([t for _, t in got[3:5]])
  return f"fq://{root / 'q'}"


def test_queue_commands_agree_with_the_jax_cli(tmp_path, deterministic, capsys):
  specs = {}
  payloads = _payloads(tmp_path, 26, "t")
  for who in ("jax", "port"):
    deterministic()
    specs[who] = _queue_state(tmp_path / who, who, payloads)

  def both(*args, spec_at=1):
    outs = {}
    for who, run in (("jax", _jax), ("port", lambda a: _port(a, capsys))):
      a = [specs[who] if x == "SPEC" else x for x in args]
      outs[who] = run(a)
    return outs

  def status():
    outs = both("queue", "status", "SPEC")
    return {who: [l for l in o.splitlines() if not l.startswith("lease_expiry")]
            for who, o in outs.items()}

  s = status()
  assert s["port"] == s["jax"] and "dead-lettered: 3" in s["port"]
  ls = both("queue", "dlq", "ls", "SPEC")
  recs = {who: [json.loads(l) for l in o.splitlines()] for who, o in ls.items()}
  for who in recs:
    for r in recs[who]:
      for f in r["failures"]:
        f.pop("time")
  assert recs["port"] == recs["jax"] and len(recs["port"]) == 3
  out = both("queue", "fsck", "SPEC")
  assert out["port"] == out["jax"]
  out = both("queue", "release", "SPEC", "--reset-deliveries")
  assert out["port"] == out["jax"] and out["port"].startswith("reset delivery counts")
  assert status()["port"] == status()["jax"]
  out = both("queue", "dlq", "retry", "SPEC")
  assert out["port"] == out["jax"] == "requeued 3 tasks\n"
  assert _tree(tmp_path / "port" / "q").keys() == _tree(tmp_path / "jax" / "q").keys()
  for verb in ("cp", "mv"):
    outs = {}
    for who in ("jax", "port"):
      dest = f"fq://{tmp_path / who / verb}"
      args = ["queue", verb, specs[who], dest]
      outs[who] = _jax(args) if who == "jax" else _port(args, capsys)
      assert TaskQueue(dest).enqueued > 0
    assert outs["port"] == outs["jax"]
  out = both("queue", "dlq", "purge", "SPEC")
  assert out["port"] == out["jax"]
  assert both("queue", "rezero", "SPEC")["port"] == ""
  both("queue", "purge", "SPEC")
  assert status()["port"] == status()["jax"]
