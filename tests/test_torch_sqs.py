"""The port's ``sqs://`` binding against the JAX package's.

One script (insert, insert_batch, lease, renew, a stale receipt, nack,
expiry and redelivery on a stepped clock, the ApproximateReceiveCount
dead letters, ack_batch, nack_batch with requeue, counts, the empty
double confirmation) runs on each package's ``SQSQueue`` over its own
``FakeSQSTransport``: every observation is equal. ``sqs://`` without
boto3 raises ``RuntimeError``, and ``execute`` drains an ``sqs://`` queue
through an explicit transport.
"""

import builtins
import os

import pytest

import igneous_tpu.tasks  # noqa: F401  (registers the JAX package's tasks)
from igneous_tpu.queues.filequeue import StaleLeaseError as JaxStaleLeaseError
from igneous_tpu.queues.sqs import FakeSQSTransport as JaxFakeSQSTransport
from igneous_tpu.queues.sqs import SQSQueue as JaxSQSQueue
from igneous_tpu.tasks import FailTask as JaxFailTask
from igneous_tpu.tasks import TouchFileTask as JaxTouchFileTask
from igneous_tpu_torch import device
from igneous_tpu_torch.cli import main as cli_main
from igneous_tpu_torch.queues import (
  FakeSQSTransport, SQSQueue, StaleLeaseError, TaskQueue, register_queue_protocol,
)
from igneous_tpu_torch.queues import queue as port_queue_module

PACKAGES = {
  "jax": (JaxSQSQueue, JaxFakeSQSTransport, JaxStaleLeaseError),
  "port": (SQSQueue, FakeSQSTransport, StaleLeaseError),
}


@pytest.fixture(autouse=True)
def _torch_cpu(monkeypatch):
  monkeypatch.setenv(device.ENV, "cpu")
  device.reset_device()
  yield
  device.reset_device()


class Clock:
  def __init__(self):
    self.t = 1000.0

  def __call__(self):
    return self.t


def _id(task) -> str:
  return getattr(task, "path", None) or task.message


def _script(who, payloads):
  Q, Fake, Stale = PACKAGES[who]
  clock = Clock()
  sleeps = []
  q = Q("sqs://test", transport=Fake(time_fn=clock), max_deliveries=2,
        sleep_fn=sleeps.append, empty_confirmation_sec=120)
  obs = []

  def snap(step, extra=None):
    obs.append((step, q.depth_snapshot(), extra))

  q.insert(payloads[:3])
  q.insert_batch(payloads[3:], total=len(payloads) - 3)
  snap("inserted")
  task, receipt = q.lease(30)
  snap("lease", [type(task).__name__, _id(task), q.last_receive_count])
  assert q.renew(receipt, 30) == receipt
  snap("renew")
  q.nack(receipt, "boom")
  clock.t += 31  # the visibility timeout passes: redelivery
  again, receipt2 = q.lease(30)
  stale = False
  try:
    q.renew(receipt, 30)
  except Stale:
    stale = True
  snap("redelivered", [_id(again) == _id(task), q.last_receive_count, stale,
                       q.delete(receipt)])
  q.nack(receipt2, "second")
  clock.t += 31
  got = q.lease_batch(30, max_tasks=4)  # the third receive dead-letters it
  snap("dead letter", [[_id(t) for t, _ in got], q.dead_letters])
  snap("ack_batch", q.ack_batch([r for _, r in got[:3]]))
  q.nack_batch([got[3][1]], "requeued", requeue=True)
  got = q.lease_batch(30, max_tasks=20)
  snap("requeued and the rest", [sorted(_id(t) for t, _ in got), q.last_receive_count])
  snap("acks", q.ack_batch([r for _, r in got]))
  snap("empty", [q.is_empty(), len(sleeps), sleeps[:1]])
  return obs


def test_sqs_matches_jax_under_one_script(tmp_path):
  payloads = [JaxTouchFileTask(str(tmp_path / f"t{i}")).to_json() for i in range(12)]
  payloads[2] = JaxFailTask("poison").to_json()
  runs = {who: _script(who, payloads) for who in PACKAGES}
  assert runs["port"] == runs["jax"]
  steps = {s: (d, e) for s, d, e in runs["port"]}
  dead = steps["dead letter"][1][1]
  assert len(dead) == 1 and dead[0]["deliveries"] == 3 and dead[0]["error"] == "second"
  assert steps["empty"][1][0] is True
  assert steps["empty"][0]["completed"] == 11


def test_sqs_without_a_transport_raises_runtime_error(monkeypatch):
  real_import = builtins.__import__

  def no_boto3(name, *args, **kw):
    if name == "boto3":
      raise ImportError("no boto3")
    return real_import(name, *args, **kw)

  monkeypatch.setattr(builtins, "__import__", no_boto3)
  with pytest.raises(RuntimeError, match="boto3"):
    SQSQueue("sqs://queue")
  with pytest.raises(RuntimeError, match="boto3"):
    TaskQueue("sqs://queue")


def test_execute_drains_sqs_through_an_explicit_transport(tmp_path, monkeypatch, capsys):
  """``execute sqs://...`` with the protocol bound to a transport: each
  task runs once, and the poison task dead-letters after its
  deliveries."""
  fake = FakeSQSTransport()
  queues = []

  def factory(spec, **kw):
    q = SQSQueue(spec, transport=fake, empty_confirmation_sec=0, **kw)
    queues.append(q)
    return q

  monkeypatch.setitem(port_queue_module._QUEUE_PROTOCOLS, "sqs", factory)
  feeder = factory("sqs://work")
  from igneous_tpu_torch.tasks import FailTask, TouchFileTask

  feeder.insert_batch([TouchFileTask(str(tmp_path / f"t{i}")) for i in range(5)])
  poison = FailTask("poison")
  feeder.insert(poison)
  rc = cli_main(["execute", "sqs://work", "-x", "--lease-sec", "0",
                 "--max-deliveries", "2", "--heartbeat-sec", "0"])
  assert rc == 0
  assert sorted(os.listdir(tmp_path)) == [f"t{i}" for i in range(5)]
  worker = queues[-1]
  assert worker.completed == 5
  # the dead letter is the inserted payload, its trace identity included
  assert [d["payload"] for d in worker.dead_letters] == [poison.to_json()]
  assert worker.dead_letters[0]["error"] == "RuntimeError: poison"
  assert fake.approximate_counts() == (0, 0)


def test_register_queue_protocol_binds_a_new_scheme(monkeypatch):
  fake = FakeSQSTransport()
  monkeypatch.setattr(port_queue_module, "_QUEUE_PROTOCOLS",
                      dict(port_queue_module._QUEUE_PROTOCOLS))
  register_queue_protocol("fakesqs", lambda spec, **kw: SQSQueue(spec, transport=fake, **kw))
  q = TaskQueue("fakesqs://x", max_deliveries=3)
  assert isinstance(q, SQSQueue) and q.max_deliveries == 3
  with pytest.raises(ValueError, match="not available"):
    TaskQueue("nosuch://x")
