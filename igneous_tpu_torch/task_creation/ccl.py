"""CCL task factories and single-machine orchestration.

The port's own copy of ``igneous_tpu/task_creation/ccl.py``: the same task
grids, payloads and scratch files. ``ccl_auto`` runs the four passes on a
``LocalTaskQueue``; lease-based queues (fq://) are not ported yet.

The destination's default encoding stays ``compressed_segmentation``, as
in the reference, but the port has no codec for it yet: the factories
refuse it before any task runs (``encoding="raw"`` works).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..lib import Bbox, Vec, ceil_div
from ..meta import PrecomputedMetadata
from ..storage import CloudFiles
from ..tasks.ccl import (
  CCLEquivalancesTask,
  CCLFacesTask,
  RelabelCCLTask,
  ccl_scratch_path,
  create_relabeling,
)
from ..volume import Volume
from .common import GridTaskIterator, get_bounds, operator_contact

DEFAULT_CCL_SHAPE = (448, 448, 448)
PORTED_ENCODINGS = ("raw",)


def _check_encoding(encoding: str) -> None:
  if encoding not in PORTED_ENCODINGS:
    raise NotImplementedError(
      f"destination encoding {encoding!r} is not ported to igneous_tpu_torch "
      "yet (ROADMAP.md, codecs); pass encoding=\"raw\" (--encoding raw)"
    )


def _grid(vol: Volume, mip: int, shape: Sequence[int], bounds: Optional[Bbox]):
  # pass 4 writes core bboxes directly: the task shape and bounds must be
  # aligned to the chunk grid (every factory normalizes identically so all
  # four passes agree on the task grid)
  cs = np.asarray(vol.meta.chunk_size(mip))
  task_bounds = get_bounds(vol, bounds, mip, mip, chunk_size=cs)
  shape = Vec(*(ceil_div(np.asarray(shape), cs) * cs))
  grid_size = Vec(*ceil_div(np.asarray(task_bounds.size3()), np.asarray(shape)))
  return task_bounds, shape, grid_size


def _ccl_iterator(task_cls, src_path, mip, shape, bounds, grid_size, extra):
  def make_task(shape_: Vec, offset: Vec):
    # task_num comes from the grid coordinate, not the iteration order
    coord = (np.asarray(offset) - np.asarray(bounds.minpt)) // np.asarray(shape_)
    task_num = int(
      coord[0] + int(grid_size.x) * (coord[1] + int(grid_size.y) * coord[2])
    )
    return task_cls(
      src_path=src_path,
      mip=mip,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      task_num=task_num,
      **extra,
    )

  return GridTaskIterator(bounds, shape, make_task)


def create_ccl_face_tasks(
  src_path: str,
  mip: int = 0,
  shape: Sequence[int] = DEFAULT_CCL_SHAPE,
  fill_missing: bool = False,
  threshold_gte: Optional[float] = None,
  threshold_lte: Optional[float] = None,
  bounds: Optional[Bbox] = None,
  dust_threshold: int = 0,
):
  vol = Volume(src_path, mip=mip)
  task_bounds, shape, grid_size = _grid(vol, mip, shape, bounds)
  return _ccl_iterator(
    CCLFacesTask, src_path, mip, shape, task_bounds, grid_size,
    dict(
      fill_missing=fill_missing,
      threshold_gte=threshold_gte,
      threshold_lte=threshold_lte,
      dust_threshold=dust_threshold,
    ),
  )


def create_ccl_equivalence_tasks(
  src_path: str,
  mip: int = 0,
  shape: Sequence[int] = DEFAULT_CCL_SHAPE,
  fill_missing: bool = False,
  threshold_gte: Optional[float] = None,
  threshold_lte: Optional[float] = None,
  bounds: Optional[Bbox] = None,
  dust_threshold: int = 0,
):
  vol = Volume(src_path, mip=mip)
  task_bounds, shape, grid_size = _grid(vol, mip, shape, bounds)
  return _ccl_iterator(
    CCLEquivalancesTask, src_path, mip, shape, task_bounds, grid_size,
    dict(
      grid_size=[int(v) for v in grid_size],
      fill_missing=fill_missing,
      threshold_gte=threshold_gte,
      threshold_lte=threshold_lte,
      dust_threshold=dust_threshold,
    ),
  )


def create_ccl_relabel_tasks(
  src_path: str,
  dest_path: str,
  mip: int = 0,
  shape: Sequence[int] = DEFAULT_CCL_SHAPE,
  fill_missing: bool = False,
  threshold_gte: Optional[float] = None,
  threshold_lte: Optional[float] = None,
  bounds: Optional[Bbox] = None,
  encoding: str = "compressed_segmentation",
  chunk_size: Optional[Sequence[int]] = None,
  dust_threshold: int = 0,
):
  """Creates the destination segmentation layer and the pass-4 grid.
  Requires create_relabeling to have produced max_label.json."""
  _check_encoding(encoding)
  vol = Volume(src_path, mip=mip)
  cf = CloudFiles(src_path)
  scratch = ccl_scratch_path(src_path, mip)
  max_doc = cf.get_json(f"{scratch}/max_label.json")
  if max_doc is None:
    raise FileNotFoundError(
      "max_label.json missing: run create_relabeling (ccl calc-labels) first"
    )
  max_label = int(max_doc["max_label"])
  dtype = "uint16" if max_label < 2**16 else (
    "uint32" if max_label < 2**32 else "uint64"
  )

  scale = vol.meta.scale(mip)
  info = PrecomputedMetadata.create_info(
    num_channels=1,
    layer_type="segmentation",
    data_type=dtype,
    encoding=encoding,
    resolution=scale["resolution"],
    voxel_offset=scale.get("voxel_offset", [0, 0, 0]),
    volume_size=scale["size"],
    chunk_size=chunk_size or scale["chunk_sizes"][0],
  )
  try:
    dest = Volume(dest_path)
  except FileNotFoundError:
    dest = Volume.create(dest_path, info)
  dest.meta.refresh_provenance()
  dest.meta.add_provenance_entry(
    {"task": "RelabelCCLTask", "src": src_path, "mip": mip,
     "max_label": max_label},
    operator_contact(),
  )
  dest.meta.commit_provenance()

  task_bounds, shape, grid_size = _grid(vol, mip, shape, bounds)
  if chunk_size is not None and np.any(
    np.asarray(shape) % np.asarray(chunk_size) != 0
  ):
    raise ValueError(
      f"dest chunk_size {list(chunk_size)} must divide the task shape "
      f"{shape.tolist()} or pass-4 writes will be misaligned"
    )
  return _ccl_iterator(
    RelabelCCLTask, src_path, mip, shape, task_bounds, grid_size,
    dict(
      dest_path=dest_path,
      fill_missing=fill_missing,
      threshold_gte=threshold_gte,
      threshold_lte=threshold_lte,
      dust_threshold=dust_threshold,
    ),
  )


def clean_ccl_files(src_path: str, mip: int = 0):
  """Delete the intermediate faces/equivalences/relabel scratch files."""
  cf = CloudFiles(src_path)
  cf.delete(list(cf.list(ccl_scratch_path(src_path, mip) + "/")))


def ccl_auto(
  src_path: str,
  dest_path: str,
  mip: int = 0,
  shape: Sequence[int] = DEFAULT_CCL_SHAPE,
  queue=None,
  clean: bool = True,
  encoding: str = "compressed_segmentation",
  chunk_size: Optional[Sequence[int]] = None,
  **kw,
):
  """Run all four passes with a barrier between each (the
  ``igneous image ccl auto`` capability). ``queue`` is a LocalTaskQueue
  (one is made when omitted), which executes each pass on insert."""
  from ..queues import LocalTaskQueue

  _check_encoding(encoding)  # before any pass, not in pass 4
  tq = queue if queue is not None else LocalTaskQueue()
  tq.insert(create_ccl_face_tasks(src_path, mip, shape, **kw))
  tq.insert(create_ccl_equivalence_tasks(src_path, mip, shape, **kw))
  max_label = create_relabeling(src_path, mip)
  tq.insert(create_ccl_relabel_tasks(
    src_path, dest_path, mip, shape,
    encoding=encoding, chunk_size=chunk_size, **kw,
  ))
  if clean:
    clean_ccl_files(src_path, mip)
  return max_label
