"""Task queues for the port: the JSON task wire format, local execution,
the lease queues (``fq://`` and ``sqs://``) and their worker loop."""

from .registry import (
  FN_REGISTRY,
  TASK_REGISTRY,
  FunctionTask,
  PrintTask,
  RegisteredTask,
  deserialize,
  queueable,
  serialize,
)
from .local import LocalTaskQueue
from .filequeue import (
  FileQueue,
  StaleLeaseError,
  TaskDeadlineError,
  failure_reason,
  poll_loop,
)
from .heartbeat import LeaseHeartbeat
from .ranges import RangeLease, RangeSub
from .queue import TaskQueue, copy_queue, move_queue, register_queue_protocol
from .sqs import FakeSQSTransport, SQSQueue

register_queue_protocol("sqs", SQSQueue)
