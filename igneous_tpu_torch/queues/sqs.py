"""``sqs://`` queue binding.

The port's own copy of ``igneous_tpu/queues/sqs.py``: at-least-once
delivery with a visibility timeout, lease release by a visibility reset,
approximate counts, and the 120-second empty double confirmation before
an empty queue is trusted (SQS counts are eventually consistent, so a
single zero sample is not evidence).

The AWS wire protocol sits behind a pluggable *transport*. The default is
boto3, imported only when an ``SQSQueue`` is made without a transport;
where boto3 is absent that raises ``RuntimeError``. ``FakeSQSTransport``
is an in-process transport with SQS's visibility semantics (receipt
handles invalidated on redelivery, approximate visible/in-flight counts,
``ApproximateReceiveCount``).
"""

from __future__ import annotations

import functools
import time
import uuid
from typing import Iterable, Optional, Tuple

from .. import telemetry
from .filequeue import StaleLeaseError, iter_tasks, poll_loop
from .registry import RegisteredTask, deserialize, serialize

EMPTY_CONFIRMATION_SEC = 120.0
EMPTY_SAMPLES = 3
SQS_BATCH = 10  # hard AWS cap on entries per *Batch API call


class FakeSQSTransport:
  """In-process transport with SQS visibility-timeout semantics.

  ``time_fn`` is injectable so tests can step time instead of sleeping.
  """

  def __init__(self, time_fn=time.monotonic):
    self._now = time_fn
    self._messages = {}     # id -> body
    self._visible_at = {}   # id -> timestamp
    self._receipt = {}      # id -> current receipt handle
    self._by_receipt = {}   # receipt -> id
    self._receive_count = {}  # id -> deliveries (ApproximateReceiveCount)

  def send_message(self, body: str) -> str:
    mid = uuid.uuid4().hex
    self._messages[mid] = body
    self._visible_at[mid] = self._now()
    self._receive_count[mid] = 0
    return mid

  def receive_message(
    self, visibility_timeout: float
  ) -> Optional[Tuple[str, str, dict]]:
    now = self._now()
    for mid, vis in self._visible_at.items():
      if vis <= now:
        # redelivery invalidates any prior receipt (SQS behavior)
        old = self._receipt.pop(mid, None)
        if old is not None:
          self._by_receipt.pop(old, None)
        receipt = uuid.uuid4().hex
        self._receipt[mid] = receipt
        self._by_receipt[receipt] = mid
        self._visible_at[mid] = now + visibility_timeout
        self._receive_count[mid] = self._receive_count.get(mid, 0) + 1
        attrs = {
          "ApproximateReceiveCount": str(self._receive_count[mid])
        }
        return self._messages[mid], receipt, attrs
    return None

  def delete_message(self, receipt: str) -> bool:
    mid = self._by_receipt.pop(receipt, None)
    if mid is None:
      return False  # stale receipt: message was redelivered elsewhere
    self._messages.pop(mid, None)
    self._visible_at.pop(mid, None)
    self._receipt.pop(mid, None)
    self._receive_count.pop(mid, None)
    return True

  def change_visibility(self, receipt: str, timeout: float) -> bool:
    mid = self._by_receipt.get(receipt)
    if mid is None or mid not in self._messages:
      return False
    self._visible_at[mid] = self._now() + timeout
    return True

  # -- batch entry points (same shapes the boto3 transport exposes) ---------

  def send_message_batch(self, bodies) -> list:
    return [self.send_message(b) for b in bodies]

  def receive_messages(self, max_messages: int, visibility_timeout: float):
    out = []
    for _ in range(int(max_messages)):
      got = self.receive_message(visibility_timeout)
      if got is None:
        break
      out.append(got)
    return out

  def delete_message_batch(self, receipts) -> list:
    return [self.delete_message(r) for r in receipts]

  def change_visibility_batch(self, receipts, timeout: float) -> list:
    return [self.change_visibility(r, timeout) for r in receipts]

  def approximate_counts(self) -> Tuple[int, int]:
    now = self._now()
    visible = sum(1 for v in self._visible_at.values() if v <= now)
    return visible, len(self._messages) - visible

  def purge(self):
    self._messages.clear()
    self._visible_at.clear()
    self._receipt.clear()
    self._by_receipt.clear()
    self._receive_count.clear()


def _boto3_transport(spec: str):
  try:
    import boto3  # noqa: F401
  except ImportError as e:
    raise RuntimeError(
      "sqs:// needs the boto3 transport, which is not installed. Install "
      "boto3 (with AWS credentials; SQS_REGION_NAME / SQS_ENDPOINT_URL, "
      "igneous_tpu_torch.secrets), or pass SQSQueue(spec, transport=...), "
      "e.g. FakeSQSTransport for tests."
    ) from e
  from .. import secrets

  sqs = boto3.client(
    "sqs", region_name=secrets.sqs_region_name(),
    endpoint_url=secrets.sqs_endpoint_url() or None,
  )
  url = spec[len("sqs://"):]

  class Boto3Transport:
    def send_message(self, body):
      return sqs.send_message(QueueUrl=url, MessageBody=body)["MessageId"]

    def receive_message(self, visibility_timeout):
      resp = sqs.receive_message(
        QueueUrl=url, MaxNumberOfMessages=1,
        VisibilityTimeout=int(visibility_timeout), WaitTimeSeconds=1,
        AttributeNames=["ApproximateReceiveCount"],
      )
      msgs = resp.get("Messages", [])
      if not msgs:
        return None
      return (
        msgs[0]["Body"], msgs[0]["ReceiptHandle"],
        msgs[0].get("Attributes", {}),
      )

    def delete_message(self, receipt):
      # stale receipt (task outlived its visibility timeout and was
      # redelivered): report False like the fake, don't crash the worker
      try:
        sqs.delete_message(QueueUrl=url, ReceiptHandle=receipt)
      except Exception as e:
        code = getattr(e, "response", {}).get("Error", {}).get("Code", "")
        if code in ("ReceiptHandleIsInvalid", "InvalidParameterValue"):
          return False
        raise
      return True

    def change_visibility(self, receipt, timeout):
      sqs.change_message_visibility(
        QueueUrl=url, ReceiptHandle=receipt, VisibilityTimeout=int(timeout)
      )
      return True

    # -- batched wire protocol: one API call per <= 10 entries.
    # Each *Batch response splits into Successful/Failed; Failed entries
    # get ONE retry (SQS batch failures are routinely partial/transient)
    # before erroring (sends) or reporting False (deletes/visibility).

    def send_message_batch(self, bodies):
      bodies = list(bodies)
      out = []
      for i in range(0, len(bodies), SQS_BATCH):
        chunk = bodies[i:i + SQS_BATCH]
        entries = [
          {"Id": str(j), "MessageBody": b} for j, b in enumerate(chunk)
        ]
        resp = sqs.send_message_batch(QueueUrl=url, Entries=entries)
        got = {e["Id"]: e["MessageId"] for e in resp.get("Successful", [])}
        failed = [e["Id"] for e in resp.get("Failed", [])]
        if failed:
          resp = sqs.send_message_batch(QueueUrl=url, Entries=[
            {"Id": fid, "MessageBody": chunk[int(fid)]} for fid in failed
          ])
          got.update(
            {e["Id"]: e["MessageId"] for e in resp.get("Successful", [])}
          )
          still = [e["Id"] for e in resp.get("Failed", [])]
          if still:
            raise RuntimeError(
              f"SendMessageBatch: {len(still)} entries failed after retry"
            )
        out.extend(got[str(j)] for j in range(len(chunk)))
      return out

    def receive_messages(self, max_messages, visibility_timeout):
      resp = sqs.receive_message(
        QueueUrl=url,
        MaxNumberOfMessages=max(1, min(int(max_messages), SQS_BATCH)),
        VisibilityTimeout=int(visibility_timeout), WaitTimeSeconds=1,
        AttributeNames=["ApproximateReceiveCount"],
      )
      return [
        (m["Body"], m["ReceiptHandle"], m.get("Attributes", {}))
        for m in resp.get("Messages", [])
      ]

    def _receipt_batch(self, api, receipts, extra):
      receipts = list(receipts)
      ok = [False] * len(receipts)
      for i in range(0, len(receipts), SQS_BATCH):
        chunk = receipts[i:i + SQS_BATCH]
        entries = [
          {"Id": str(j), "ReceiptHandle": r, **extra}
          for j, r in enumerate(chunk)
        ]
        resp = api(QueueUrl=url, Entries=entries)
        failed = [e["Id"] for e in resp.get("Failed", [])]
        if failed:
          resp = api(QueueUrl=url, Entries=[
            {"Id": fid, "ReceiptHandle": chunk[int(fid)], **extra}
            for fid in failed
          ])
          failed = [e["Id"] for e in resp.get("Failed", [])]
        bad = {int(fid) for fid in failed}
        for j in range(len(chunk)):
          ok[i + j] = j not in bad
      return ok

    def delete_message_batch(self, receipts):
      return self._receipt_batch(sqs.delete_message_batch, receipts, {})

    def change_visibility_batch(self, receipts, timeout):
      return self._receipt_batch(
        sqs.change_message_visibility_batch, receipts,
        {"VisibilityTimeout": int(timeout)},
      )

    def approximate_counts(self):
      attrs = sqs.get_queue_attributes(
        QueueUrl=url,
        AttributeNames=[
          "ApproximateNumberOfMessages",
          "ApproximateNumberOfMessagesNotVisible",
        ],
      )["Attributes"]
      return (
        int(attrs["ApproximateNumberOfMessages"]),
        int(attrs["ApproximateNumberOfMessagesNotVisible"]),
      )

    def purge(self):
      sqs.purge_queue(QueueUrl=url)

  return Boto3Transport()


class SQSQueue:
  """Queue facade over an SQS(-shaped) transport.

  Same surface as FileQueue where the backend permits: insert / lease /
  delete / release / poll / purge / is_empty / enqueued / leased.
  Tallies (inserted/completed) are per-process — SQS keeps no global
  counters, so cross-worker totals need CloudWatch, not this client.
  """

  def __init__(
    self, spec: str, transport=None,
    empty_confirmation_sec: float = EMPTY_CONFIRMATION_SEC,
    sleep_fn=time.sleep,
    max_deliveries: Optional[int] = None,
    dlq=None,
  ):
    """``max_deliveries``/``dlq``: client-side mirror of SQS redrive —
    a message received more than ``max_deliveries`` times routes to
    ``dlq`` (any queue-like with .insert(), e.g. another SQSQueue or a
    FileQueue) instead of being delivered. With ``dlq=None`` quarantined
    bodies accumulate in ``self.dead_letters`` (per-process). Production
    deployments should prefer a server-side RedrivePolicy; this mirror
    gives the shared poll loop identical semantics on the fake."""
    self.spec = spec
    self.transport = transport or _boto3_transport(spec)
    self.empty_confirmation_sec = float(empty_confirmation_sec)
    self._sleep = sleep_fn
    self._inserted = 0
    self._completed = 0
    self.max_deliveries = (
      None if not max_deliveries or int(max_deliveries) <= 0
      else int(max_deliveries)
    )
    self.dlq = dlq
    self.dead_letters: list = []
    self.last_receive_count: int = 0
    # reasons key on the message BODY (stable across redeliveries —
    # receipts rotate every receive, so they cannot carry attribution
    # from the failing delivery to the promoting one)
    self._failure_reasons: dict = {}  # body -> last recorded reason
    self._receipt_body: dict = {}     # live receipt -> body

  # -- counters -------------------------------------------------------------

  @property
  def inserted(self) -> int:
    return self._inserted

  @property
  def completed(self) -> int:
    return self._completed

  @property
  def enqueued(self) -> int:
    visible, in_flight = self.transport.approximate_counts()
    return visible + in_flight

  @property
  def leased(self) -> int:
    return self.transport.approximate_counts()[1]

  @property
  def backlog(self) -> int:
    """Work remaining (visible + in flight); approximate, like every SQS
    count."""
    return self.enqueued

  def depth_snapshot(self) -> dict:
    visible, in_flight = self.transport.approximate_counts()
    return {
      "inserted": self.inserted,
      "enqueued": visible + in_flight,
      "leased": in_flight,
      "completed": self.completed,
      "backlog": visible + in_flight,
    }

  def __len__(self) -> int:
    return self.enqueued

  # -- queue ops ------------------------------------------------------------

  def insert(self, tasks: Iterable, total=None):
    del total
    n = 0
    for task in iter_tasks(tasks):
      body = task if isinstance(task, str) else serialize(task)
      self.transport.send_message(body)
      n += 1
    self._inserted += n
    return n

  def insert_batch(self, tasks: Iterable, total=None):
    """Batched enqueue: SendMessageBatch at the 10-entry API cap — one
    wire round-trip per 10 tasks instead of per task. Transports without
    a batch entry point fall back to per-task sends."""
    del total
    send_batch = getattr(self.transport, "send_message_batch", None)
    if send_batch is None:
      return self.insert(tasks)
    n = 0
    chunk = []
    for task in iter_tasks(tasks):
      chunk.append(task if isinstance(task, str) else serialize(task))
      if len(chunk) >= SQS_BATCH:
        send_batch(chunk)
        n += len(chunk)
        chunk = []
    if chunk:
      send_batch(chunk)
      n += len(chunk)
    self._inserted += n
    return n

  def _admit(self, got):
    """Shared receive gate: route exhausted redeliveries to the DLQ,
    register the receipt->body mapping, deserialize. None = promoted."""
    body, receipt = got[0], got[1]
    attrs = got[2] if len(got) > 2 else {}
    count = int(attrs.get("ApproximateReceiveCount", 0) or 0)
    self.last_receive_count = count
    if self.max_deliveries is not None and count > self.max_deliveries:
      # redelivery budget exhausted BEFORE this delivery: quarantine
      # instead of handing a poison task to yet another worker
      self._promote_to_dlq(body, receipt, count)
      return None
    self._receipt_body[receipt] = body
    return deserialize(body), receipt

  def lease(self, seconds: float = 600):
    while True:
      got = self.transport.receive_message(seconds)
      if got is None:
        return None
      admitted = self._admit(got)
      if admitted is not None:
        return admitted

  def lease_batch(self, seconds: float = 600, max_tasks: int = 1):
    """Lease up to ``max_tasks`` in ReceiveMessage batches of 10.
    Returns a list of (task, receipt) pairs — [] when drained."""
    recv = getattr(self.transport, "receive_messages", None)
    out = []
    while len(out) < max_tasks:
      want = max_tasks - len(out)
      if recv is not None:
        batch = recv(min(want, SQS_BATCH), seconds)
      else:
        got = self.transport.receive_message(seconds)
        batch = [] if got is None else [got]
      if not batch:
        break
      for got in batch:
        admitted = self._admit(got)
        if admitted is not None:
          out.append(admitted)
    return out

  def ack_batch(self, tokens):
    """Complete many tasks via DeleteMessageBatch. Results align with
    ``tokens``; False = stale receipt (zombie-fenced, not a completion)."""
    tokens = list(tokens)
    del_batch = getattr(self.transport, "delete_message_batch", None)
    if del_batch is None:
      return [self.delete(t) for t in tokens]
    for t in tokens:
      body = self._receipt_body.pop(t, None)
      if body is not None:
        self._failure_reasons.pop(body, None)
    results = [bool(r) for r in del_batch(tokens)]
    ok = sum(results)
    self._completed += ok
    if ok < len(results):
      telemetry.incr("zombie.delete", len(results) - ok)
    return results

  def nack_batch(self, tokens, reason: str = "", requeue: bool = False):
    """Record many failed deliveries; with ``requeue=True`` the messages
    return to visibility via ChangeMessageVisibilityBatch(0)."""
    tokens = list(tokens)
    for t in tokens:
      body = self._receipt_body.pop(t, None)
      if body is not None:
        self._failure_reasons[body] = str(reason)[:2000]
    if requeue:
      cvb = getattr(self.transport, "change_visibility_batch", None)
      if cvb is None:
        for t in tokens:
          self.release(t)
      else:
        cvb(tokens, 0)

  def _promote_to_dlq(self, body: str, receipt: str, count: int):
    if self.dlq is not None:
      self.dlq.insert(body)
    else:
      self.dead_letters.append({
        "payload": body,
        "deliveries": count,
        "error": self._failure_reasons.pop(body, ""),
      })
    self.transport.delete_message(receipt)
    telemetry.incr("dlq.promoted", 1)

  def renew(self, lease_id: str, seconds: float = 600) -> str:
    """Extend the visibility timeout (ChangeMessageVisibility). The
    receipt handle stays valid across renewals, so the token is returned
    unchanged. A stale receipt — the message was redelivered elsewhere
    while this worker stalled — raises StaleLeaseError (``zombie.renew``),
    matching the fq:// fencing contract."""
    if not self.transport.change_visibility(lease_id, seconds):
      telemetry.incr("zombie.renew", 1)
      raise StaleLeaseError(
        "receipt no longer owns its message (redelivered after the "
        "visibility timeout)"
      )
    return lease_id

  def delete(self, lease_id: str) -> bool:
    body = self._receipt_body.pop(lease_id, None)
    if body is not None:
      self._failure_reasons.pop(body, None)
    if self.transport.delete_message(lease_id):
      self._completed += 1
      return True
    # stale receipt: the task outlived its visibility and was re-issued;
    # this worker's late ack must not count as a completion
    telemetry.incr("zombie.delete", 1)
    return False

  def nack(self, lease_id: str, reason: str = "", requeue: bool = False):
    """Record a failed delivery. SQS keeps no per-message metadata, so
    the reason lives client-side (telemetry + last-reason map, keyed by
    message body); the visibility timeout (or ``requeue=True``) drives
    redelivery, and the receive-count check in lease() drives DLQ
    promotion."""
    body = self._receipt_body.pop(lease_id, None)
    if body is not None:
      self._failure_reasons[body] = str(reason)[:2000]
    if requeue:
      self.release(lease_id)

  def release(self, lease_id: str):
    self.transport.change_visibility(lease_id, 0)

  def release_all(self):
    raise NotImplementedError(
      "SQS cannot enumerate in-flight receipts; leases recycle on their "
      "visibility timeout (or drop them per-worker with release())."
    )

  def purge(self):
    self.transport.purge()

  def rezero(self):
    self._inserted = 0
    self._completed = 0

  def is_empty(self) -> bool:
    """Empty only after sustained zero counts across the confirmation
    window: SQS counts are approximate and eventually consistent."""
    # N samples span (N-1) intervals: dividing by N would shrink the
    # sustained-zero span below the documented window
    interval = self.empty_confirmation_sec / max(EMPTY_SAMPLES - 1, 1)
    for i in range(EMPTY_SAMPLES):
      visible, in_flight = self.transport.approximate_counts()
      if visible + in_flight > 0:
        return False
      if i < EMPTY_SAMPLES - 1:
        self._sleep(interval)
    return True

  def poll(
    self,
    lease_seconds: float = 600,
    verbose: bool = False,
    tally: bool = True,
    stop_fn=None,
    max_backoff_window: float = 30.0,
    before_fn=None,
    after_fn=None,
    task_deadline_seconds: Optional[float] = None,
    heartbeat_seconds: Optional[float] = None,
    drain_flag=None,
  ):
    del tally
    return poll_loop(
      self, lease_seconds, verbose, stop_fn, max_backoff_window,
      before_fn, after_fn, task_deadline_seconds,
      heartbeat_seconds, drain_flag,
    )
