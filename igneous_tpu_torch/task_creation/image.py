"""Image task factories: the downsample pyramid.

Counterpart of ``create_downsampling_tasks`` in
``igneous_tpu/task_creation/image.py``: the same task shapes, scales and
DownsampleTask payloads for the options ported here.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

from ..downsample_scales import (
  DEFAULT_FACTOR,
  axis_to_factor,
  chunk_writable_factors,
  create_downsample_scales,
  downsample_shape_from_memory_target,
)
from ..lib import Bbox, Vec, jsonify
from ..tasks.image import DownsampleTask
from ..volume import Volume
from .common import GridTaskIterator, get_bounds

MEMORY_TARGET = int(3.5e9)  # bytes per task


def _pick_task_shape(
  vol: Volume,
  mip: int,
  factor,
  memory_target: int,
  num_mips: int,
  chunk_size: Optional[Sequence[int]] = None,
) -> Vec:
  """The largest chunk-aligned task shape whose pyramid fits
  ``memory_target``, clipped to the (chunk-expanded) volume."""
  cs = Vec(*(chunk_size if chunk_size is not None else vol.meta.chunk_size(mip)))
  arr = np.asarray(factor, dtype=np.int64)
  if arr.ndim == 2:
    # per-mip factor sequence: the largest chunk-aligned shape whose
    # pyramid fits the byte budget
    width = vol.dtype.itemsize * vol.num_channels
    seq = [np.asarray(f, dtype=np.int64) for f in arr[:num_mips]]
    shape = np.asarray(cs) * seq[0]
    for m in range(1, len(seq) + 1):
      cand = np.asarray(cs) * np.prod(np.stack(seq[:m]), axis=0)
      series = 1.0 + sum(
        1.0 / float(np.prod(np.prod(np.stack(seq[:i]), axis=0)))
        for i in range(1, m + 1)
      )
      if float(np.prod(cand)) * series * width > memory_target and m > 1:
        break
      shape = cand
  else:
    shape = downsample_shape_from_memory_target(
      vol.dtype.itemsize,
      int(cs.x), int(cs.y), int(cs.z),
      factor,
      memory_target,
      max_mips=num_mips,
      num_channels=vol.num_channels,
    )
  return Vec(*np.minimum(
    np.asarray(shape),
    np.asarray(vol.meta.bounds(mip).expand_to_chunk_size(
      cs, vol.meta.voxel_offset(mip)
    ).size3()),
  ))


def create_downsampling_tasks(
  layer_path: str,
  mip: int = 0,
  fill_missing: bool = False,
  num_mips: int = 5,
  sparse: bool = False,
  chunk_size: Optional[Sequence[int]] = None,
  encoding: Optional[str] = None,
  delete_black_uploads: bool = False,
  background_color: int = 0,
  compress="gzip",
  factor: Optional[Sequence[int]] = None,
  axis: str = "z",
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
  memory_target: int = MEMORY_TARGET,
  downsample_method: str = "auto",
  preserve_chunk_size: bool = True,
):
  """Grid of DownsampleTasks; creates the destination scales first.

  ``factor`` is one triple or a per-mip sequence of triples."""
  if encoding not in (None, "raw"):
    raise NotImplementedError(
      f"encoding {encoding!r} is not ported to igneous_tpu_torch yet; use raw"
    )
  vol = Volume(layer_path, mip=mip)
  if compress == "auto":
    compress = "gzip"  # raw is the one ported encoding, and it takes gzip
  if (not preserve_chunk_size and chunk_size is None
      and vol.meta.num_mips > mip + 1):
    # reuse the NEXT mip's existing chunking for the new scales
    chunk_size = [int(v) for v in vol.meta.chunk_size(mip + 1)]
  if factor is None:
    factor = axis_to_factor(axis) if axis != "z" else DEFAULT_FACTOR
  cs = chunk_size if chunk_size is not None else vol.meta.chunk_size(mip)

  shape = _pick_task_shape(vol, mip, factor, memory_target, num_mips, chunk_size)
  factors = chunk_writable_factors(
    shape, factor, num_mips, cs, vol.meta.bounds(mip).size3()
  )
  if num_mips > 0 and not factors:
    raise ValueError(
      f"task shape {shape.tolist()} admits no chunk-writable downsample "
      f"by {list(factor)} (chunk {list(map(int, cs))}); raise "
      f"memory_target or pass a larger/even shape"
    )
  if len(factors) < num_mips:
    warnings.warn(
      f"requested num_mips={num_mips} but task shape "
      f"{[int(v) for v in shape]} only supports {len(factors)} "
      f"chunk-writable mip(s) (chunk {[int(v) for v in cs]}); raise "
      f"memory_target to plan the full pyramid, or re-run downsampling "
      f"from the deepest produced mip",
      stacklevel=2,
    )
  create_downsample_scales(
    vol.meta, mip, shape, factor,
    num_mips=len(factors), chunk_size=chunk_size, encoding=encoding,
  )
  vol.commit_info()

  task_bounds = get_bounds(vol, bounds, mip, bounds_mip)

  def make_task(shape_: Vec, offset: Vec):
    return DownsampleTask(
      layer_path=layer_path,
      mip=mip,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      fill_missing=fill_missing,
      sparse=sparse,
      delete_black_uploads=delete_black_uploads,
      background_color=background_color,
      compress=compress,
      downsample_method=downsample_method,
      num_mips=len(factors),
      factor=tuple(factor),
    )

  def finish():
    vol.meta.refresh_provenance()
    vol.meta.add_provenance_entry(jsonify({
      "task": "DownsampleTask",
      "mip": mip,
      "num_mips": len(factors),
      "shape": shape.tolist(),
      "factor": list(factor),
      "sparse": sparse,
      "bounds": task_bounds.to_list(),
      "method": downsample_method,
      "fill_missing": fill_missing,
      "compress": compress,
      "delete_black_uploads": delete_black_uploads,
      "background_color": background_color,
    }))
    vol.meta.commit_provenance()

  return GridTaskIterator(task_bounds, shape, make_task, finish)
