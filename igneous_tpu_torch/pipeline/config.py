"""Pipeline sizing: the env knobs and the memory budget behind every bound.

The port's own copy of ``igneous_tpu/pipeline/config.py``, with the same
knobs, parses and defaults. The staged pipeline holds decoded cutouts
(download → compute buffer) in host memory, and the chunk decode cache
takes its budget from the same number:

  IGNEOUS_PIPELINE          on|off|auto   master switch (auto: task
                                          streams pipeline, solo task
                                          execution stays serial)
  IGNEOUS_PIPELINE_MEM_MB   float         stage-buffer byte budget
                                          (default: the downsample
                                          memory target)
  IGNEOUS_PIPELINE_PREFETCH int           cutouts downloading ahead of
                                          compute (default 2)
  IGNEOUS_PIPELINE_THREADS  1|0|auto      overlap the stages on threads
                                          (auto: when the host has more
                                          than one core)
  IGNEOUS_PIPELINE_IO_THREADS int         download pool width
                                          (default min(8, 2 * cores))
  IGNEOUS_PIPELINE_ENCODE_THREADS int     encode/upload pool width
                                          (default min(8, cores))
"""

from __future__ import annotations

import os
from typing import Optional

from ..secrets import env_number

# the downsample planner's default task byte target
# (task_creation.image.create_downsampling_tasks memory_target)
DEFAULT_MEMORY_TARGET = int(3.5e9)

_TRUE = ("1", "on", "true", "yes")
_FALSE = ("0", "off", "false", "no")


def _cores() -> int:
  try:
    return len(os.sched_getaffinity(0))
  except AttributeError:
    return os.cpu_count() or 1


def _env_str(name: str) -> str:
  return os.environ.get(name, "").strip().lower()


def enabled(default: Optional[bool] = None) -> bool:
  """The master switch. ``default`` is what "auto" means at the call site:
  stream runners (LocalTaskQueue) pass True, solo execution False."""
  val = _env_str("IGNEOUS_PIPELINE")
  if val in _TRUE:
    return True
  if val in _FALSE:
    return False
  return bool(default)


def memory_budget_bytes(
  task_nbytes: Optional[int] = None,
  memory_target: Optional[int] = None,
) -> int:
  """Byte budget of the stage buffers: ``IGNEOUS_PIPELINE_MEM_MB`` when
  set, else the memory target (at most twice ``task_nbytes``, a known
  cutout size)."""
  mb = env_number("IGNEOUS_PIPELINE_MEM_MB", None, float)
  if mb:
    return max(int(mb * 1e6), 1)
  base = memory_target if memory_target else DEFAULT_MEMORY_TARGET
  if task_nbytes:
    base = min(base, int(task_nbytes) * 2)
  return max(int(base), 1)


def prefetch_depth() -> int:
  depth = env_number("IGNEOUS_PIPELINE_PREFETCH", None, int)
  return max(2 if depth is None else depth, 1)


def use_threads() -> bool:
  """Whether the staged runner overlaps its stages on threads. On one core
  the stages only contend, so the runner then executes the same stage
  plans in order (same bytes)."""
  val = _env_str("IGNEOUS_PIPELINE_THREADS")
  if val in _TRUE:
    return True
  if val in _FALSE:
    return False
  return _cores() > 1


def io_threads() -> int:
  env = env_number("IGNEOUS_PIPELINE_IO_THREADS", None, int)
  if env:
    return max(env, 1)
  return min(8, _cores() * 2)


def encode_threads() -> int:
  env = env_number("IGNEOUS_PIPELINE_ENCODE_THREADS", None, int)
  if env:
    return max(env, 1)
  return min(8, max(_cores(), 1))
