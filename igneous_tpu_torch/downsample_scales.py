"""Downsample planning math: factors, mip counts, memory-budget task shapes.

The port's own copy of the parts of ``igneous_tpu/downsample_scales.py``
that the downsample path uses.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .lib import Vec
from .meta import PrecomputedMetadata

DEFAULT_FACTOR = (2, 2, 1)


def axis_to_factor(axis: str) -> Tuple[int, int, int]:
  """The 2x downsample factor that PRESERVES ``axis``."""
  return {"x": (1, 2, 2), "y": (2, 1, 2), "z": (2, 2, 1)}[axis]


def normalize_factor_sequence(factor, num_mips: int) -> List[Tuple[int, int, int]]:
  """A single (fx,fy,fz) repeats per mip; a sequence of triples is used
  per-mip as given."""
  arr = np.asarray(factor, dtype=np.int64)
  if arr.ndim == 2:
    return [tuple(int(v) for v in f) for f in arr[:num_mips]]
  return [tuple(int(v) for v in arr)] * num_mips


def compute_factors(
  task_shape: Sequence[int],
  factor,
  num_mips: int,
  chunk_size: Optional[Sequence[int]] = None,
) -> List[Tuple[int, int, int]]:
  """Per-mip factors achievable inside one task of ``task_shape``: a mip is
  achievable while the running shape divides evenly by that mip's factor
  and (when ``chunk_size`` is given) the result stays chunk-writable."""
  shape = np.asarray(task_shape, dtype=np.int64)
  factors: List[Tuple[int, int, int]] = []
  for f in normalize_factor_sequence(factor, num_mips):
    fa = np.asarray(f, dtype=np.int64)
    if np.any(shape % fa != 0):
      break
    nxt = shape // fa
    if chunk_size is not None and np.any(
      (nxt % np.asarray(chunk_size, dtype=np.int64) != 0) & (nxt != 1)
    ):
      break
    factors.append(f)
    shape = nxt
  return factors


def chunk_writable_factors(
  task_shape: Sequence[int],
  factor,
  num_mips: int,
  chunk_size: Sequence[int],
  mip_extent: Sequence[int],
) -> List[Tuple[int, int, int]]:
  """compute_factors truncated at the first mip whose task-level output
  could not legally be uploaded: each produced cutout must land on the
  chunk grid, except along axes where one task spans the whole mip extent.
  ``mip_extent`` is the dataset size at the SOURCE mip."""
  extent = np.asarray(mip_extent, dtype=np.int64)
  cs = np.asarray(chunk_size, dtype=np.int64)

  def per_mip(i, cum):
    return cs, -(-extent // cum)  # ceil: scale geometry is ceil-size

  return truncate_writable_factors(
    task_shape, compute_factors(task_shape, factor, num_mips), per_mip
  )


def truncate_writable_factors(task_shape, factors, per_mip):
  """Truncate ``factors`` at the first mip where some produced cutout axis
  is neither chunk-aligned nor extent-spanning. ``per_mip(i, cum)`` gives
  that mip's (chunk_size, extent)."""
  shape = np.asarray(task_shape, dtype=np.int64)
  out: List[Tuple[int, int, int]] = []
  cum = np.ones(3, dtype=np.int64)
  for i, f in enumerate(factors):
    cum = cum * np.asarray(f, dtype=np.int64)
    nxt = shape // cum
    cs, msize = per_mip(i, cum)
    if np.any(
      (nxt % np.asarray(cs, dtype=np.int64) != 0)
      & (nxt < np.asarray(msize, dtype=np.int64))
    ):
      break
    out.append(f)
  return out


def pyramid_memory_bytes(
  shape: Sequence[int],
  data_width: int,
  factor: Sequence[int],
  num_mips: int,
  num_channels: int = 1,
) -> int:
  """Bytes to hold a task cutout plus all its downsampled mips."""
  shape = np.asarray(shape, dtype=np.float64)
  f = np.prod(np.asarray(factor, dtype=np.float64))
  vox = float(np.prod(shape))
  total = vox * sum((1.0 / f) ** i for i in range(num_mips + 1))
  return int(np.ceil(total * data_width * num_channels))


def num_mips_from_memory_target(
  memory_target: int,
  data_width: int,
  chunk_size: Sequence[int],
  factor: Sequence[int],
  num_channels: int = 1,
  max_mips: int = 30,
) -> int:
  """Max mips m such that a (chunk_size * factor^m) task pyramid fits the
  byte budget."""
  cs = np.asarray(chunk_size, dtype=np.int64)
  f = np.asarray(factor, dtype=np.int64)
  best = 1
  for m in range(1, max_mips + 1):
    shape = cs * f**m
    if np.any(shape <= 0) or np.any(shape > 2**31):
      break
    if pyramid_memory_bytes(shape, data_width, factor, m, num_channels) > memory_target:
      break
    best = m
  return best


def downsample_shape_from_memory_target(
  data_width: int,
  cx: int,
  cy: int,
  cz: int,
  factor: Sequence[int],
  byte_target: int,
  max_mips: Optional[int] = None,
  num_channels: int = 1,
) -> Vec:
  """Chunk-aligned task shape chunk_size * factor^m with the most mips m
  whose pyramid fits ``byte_target``."""
  if byte_target <= 0:
    raise ValueError("byte_target must be positive")
  m = num_mips_from_memory_target(
    byte_target, data_width, (cx, cy, cz), factor, num_channels
  )
  if max_mips is not None:
    m = min(m, max_mips)
  f = np.asarray(factor, dtype=np.int64)
  return Vec(*(np.asarray((cx, cy, cz), dtype=np.int64) * f**m))


def create_downsample_scales(
  meta: PrecomputedMetadata,
  mip: int,
  task_shape: Sequence[int],
  factor: Sequence[int] = DEFAULT_FACTOR,
  num_mips: Optional[int] = None,
  chunk_size: Optional[Sequence[int]] = None,
  encoding: Optional[str] = None,
) -> List[int]:
  """Add the scales a downsample pass over source ``mip`` will produce;
  returns the destination mip indices."""
  shape = np.asarray(task_shape, dtype=np.int64)
  cs = chunk_size if chunk_size is not None else meta.chunk_size(mip)
  factors = compute_factors(
    shape, factor, 30 if num_mips is None else num_mips, chunk_size=None
  )
  base_ratio = np.asarray(meta.downsample_ratio(mip), dtype=np.int64)
  res0 = np.asarray(meta.scale(0)["resolution"], dtype=np.int64)

  new_mips = []
  cumulative = np.ones(3, dtype=np.int64)
  for f in factors:
    cumulative *= np.asarray(f, dtype=np.int64)
    meta.add_scale(base_ratio * cumulative, chunk_size=cs, encoding=encoding)
    new_mips.append(meta.mip_from_key(
      "_".join(str(int(r)) for r in res0 * base_ratio * cumulative)
    ))
  return new_mips
