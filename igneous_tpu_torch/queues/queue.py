"""``TaskQueue``: queues addressed by URL.

The port's own copy of ``igneous_tpu/queues/queue.py``: ``fq://<dir>`` (or
a bare path) is a ``FileQueue``, ``sqs://`` an ``SQSQueue`` (registered by
the package; it needs boto3 or an explicit transport), and any other
protocol attaches through ``register_queue_protocol``. ``copy_queue`` and
``move_queue`` are ``queue cp`` and ``queue mv``.
"""

from __future__ import annotations

from .filequeue import FileQueue

_QUEUE_PROTOCOLS = {}


def register_queue_protocol(name: str, factory):
  _QUEUE_PROTOCOLS[name] = factory


def _require_filequeue(q, spec):
  from .filequeue import FileQueue

  if not isinstance(q, FileQueue):
    raise ValueError(
      f"queue cp/mv supports fq:// queues only (got {spec!r}); protocol "
      "backends expose their own bulk-transfer tooling"
    )
  return q


def _snapshot_payloads(src, delete: bool):
  """Yield (name, [payloads]) per pending FILE (one payload for a classic
  file, every member's for a segment), skipping files that workers lease
  mid-walk. With ``delete=True`` the file is removed only after its
  payloads were yielded back to the consumer."""
  import os

  from .filequeue import seg_parse

  for name in sorted(os.listdir(src.queue_dir)):
    path = os.path.join(src.queue_dir, name)
    if seg_parse(name) is not None:
      try:
        payloads = [p for _i, p in src._read_segment(path)]
      except FileNotFoundError:
        continue  # a worker leased it between listing and reading
    else:
      try:
        with open(path) as f:
          payloads = [f.read()]
      except FileNotFoundError:
        continue
    yield name, payloads
    if delete:
      try:
        os.remove(path)
      except FileNotFoundError:
        pass


def _batched_insert(dest, payloads) -> int:
  ins = getattr(dest, "insert_batch", None)
  if ins is None:
    for p in payloads:
      dest.insert(p)
  else:
    # no total= hint: a source segment moves as ONE dest segment
    ins(payloads)
  return len(payloads)


def copy_queue(src_spec: str, dest_spec: str) -> int:
  """Copy all pending tasks of an fq:// queue into another queue
  (``queue cp``). Leased tasks are not copied."""
  src = _require_filequeue(TaskQueue(src_spec), src_spec)
  dest = TaskQueue(dest_spec)
  n = 0
  for _name, payloads in _snapshot_payloads(src, delete=False):
    n += _batched_insert(dest, payloads)
  return n


def move_queue(src_spec: str, dest_spec: str) -> int:
  """Move all pending tasks (``queue mv``). Each file is deleted only
  after its copies land, so tasks inserted concurrently are never
  dropped (they stay in the source)."""
  src = _require_filequeue(TaskQueue(src_spec), src_spec)
  dest = TaskQueue(dest_spec)
  n = 0
  for _name, payloads in _snapshot_payloads(src, delete=True):
    n += _batched_insert(dest, payloads)
  return n


def TaskQueue(spec, **kw):
  """Create a queue from a URL spec (or pass through a queue object)."""
  if not isinstance(spec, str):
    return spec
  if spec.startswith("fq://") or "://" not in spec:
    return FileQueue(spec, **kw)
  protocol = spec.split("://", 1)[0]
  if protocol in _QUEUE_PROTOCOLS:
    return _QUEUE_PROTOCOLS[protocol](spec, **kw)
  raise ValueError(
    f"Queue protocol {protocol}:// not available. "
    f"Use fq:// or register_queue_protocol()."
  )
