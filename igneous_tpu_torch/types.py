"""Shared enums: the port's copy of ``igneous_tpu/types.py``."""

from __future__ import annotations

from enum import IntEnum
from typing import Union


class DownsampleMethods(IntEnum):
  AUTO = 0
  AVERAGE = 1
  MODE = 2
  MIN = 3
  MAX = 4
  STRIDING = 5

  @classmethod
  def to_name(cls, method: "Union[DownsampleMethods, int, str]") -> str:
    """Normalize to the string names ops.pooling understands."""
    if isinstance(method, str):
      return method.lower()
    return cls(method).name.lower()
