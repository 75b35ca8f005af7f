"""The staged execution pipeline: overlapped download → compute on the
device → parallel encode/upload.

  * ``buffers``: the byte-budgeted hand-off between stages, with stall and
    bytes telemetry and waits that a drain flag wakes.
  * ``encoder``: the persistent encode/upload pool; chunk encodes and puts
    grouped under per-task tickets, with deterministic bytes.
  * ``runner``: the scheduler: prefetch pool ∥ in-order compute ∥ upload
    pool, with write barriers, drain and failure containment.

Env knobs (``config``): ``IGNEOUS_PIPELINE``, ``IGNEOUS_PIPELINE_MEM_MB``,
``IGNEOUS_PIPELINE_PREFETCH``, ``IGNEOUS_PIPELINE_THREADS``,
``IGNEOUS_PIPELINE_IO_THREADS``, ``IGNEOUS_PIPELINE_ENCODE_THREADS``.
"""

from . import config
from .buffers import BoundedBuffer, PipelineInterrupted
from .encoder import (
  EncodePool,
  SerialSink,
  UploadTicket,
  shared_encode_pool,
  shared_io_pool,
  shared_prefetch_pool,
)
from .runner import (
  StagePlan,
  execute_with_sink,
  run_tasks_pipelined,
  stage_plan_of,
)

__all__ = [
  "config",
  "BoundedBuffer",
  "PipelineInterrupted",
  "EncodePool",
  "SerialSink",
  "UploadTicket",
  "shared_encode_pool",
  "shared_io_pool",
  "shared_prefetch_pool",
  "StagePlan",
  "execute_with_sink",
  "run_tasks_pipelined",
  "stage_plan_of",
]
