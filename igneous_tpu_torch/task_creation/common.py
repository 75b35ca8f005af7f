"""Factory commons: grid decomposition and bounds resolution.

The port's copy of the parts of ``igneous_tpu/task_creation/common.py``
that the downsample, CCL and mesh factories use.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..lib import Bbox, Vec, ceil_div
from ..volume import Volume


def operator_contact() -> str:
  """git email for provenance records (best effort)."""
  try:
    return (
      subprocess.check_output(
        ["git", "config", "user.email"], stderr=subprocess.DEVNULL
      )
      .decode("utf8")
      .strip()
    )
  except Exception:
    return ""


def get_bounds(
  vol: Volume,
  bounds: Optional[Bbox],
  mip: int,
  bounds_mip: int = 0,
  chunk_size: Optional[Sequence[int]] = None,
) -> Bbox:
  """Resolve a user bbox (given at bounds_mip) to task bounds at mip,
  expanded to the chunk grid and clamped to the volume."""
  if bounds is None:
    return vol.meta.bounds(mip)
  bounds = vol.meta.bbox_to_mip(bounds, bounds_mip, mip)
  if chunk_size is not None:
    bounds = bounds.expand_to_chunk_size(chunk_size, vol.meta.voxel_offset(mip))
  return Bbox.intersection(bounds, vol.meta.bounds(mip))


def label_prefixes(magnitude: int) -> Iterator[str]:
  """Decimal prefixes covering every positive integer label exactly once:
  full-length prefixes (no leading zeros) plus terminated ``N:`` prefixes
  for labels shorter than ``magnitude`` digits (the mesh-manifest
  fan-out)."""
  for prefix in range(10 ** (magnitude - 1), 10**magnitude):
    yield str(prefix)
  for ndigits in range(1, magnitude):
    lo = 10 ** (ndigits - 1) if ndigits > 1 else 1
    for prefix in range(lo, 10**ndigits):
      yield f"{prefix}:"


class GridTaskIterator:
  """Splits ``bounds`` into a ``shape``-sized grid (x fastest) and yields
  ``task_fn(shape, offset)`` per cell, then calls ``finish_fn``."""

  def __init__(
    self,
    bounds: Bbox,
    shape: Sequence[int],
    task_fn: Callable[[Vec, Vec], object],
    finish_fn: Optional[Callable[[], None]] = None,
  ):
    self.bounds = bounds
    self.shape = Vec(*shape)
    self.grid = Vec(*ceil_div(np.asarray(bounds.size3()), np.asarray(self.shape)))
    self._task_fn = task_fn
    self._finish_fn = finish_fn

  def __len__(self) -> int:
    return int(np.prod(np.asarray(self.grid)))

  def __iter__(self) -> Iterator:
    gx, gy, _gz = (int(v) for v in self.grid)
    for index in range(len(self)):
      coord = Vec(index % gx, (index // gx) % gy, index // (gx * gy))
      offset = self.bounds.minpt + coord * self.shape
      yield self._task_fn(self.shape.clone(), Vec(*offset))
    if self._finish_fn is not None:
      self._finish_fn()
