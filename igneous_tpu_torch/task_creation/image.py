"""Image task factories: the downsample pyramid, the transfer and the
voxel-count census.

Counterpart of ``create_downsampling_tasks``, ``create_transfer_tasks``
and ``create_voxel_counting_tasks`` in
``igneous_tpu/task_creation/image.py``: the same task shapes, scales,
``info`` and provenance, and the same DownsampleTask, TransferTask and
CountVoxelsTask payloads. Graphene sources (agglomerate / timestamp / stop_layer) and
sharded scales are refused before anything is written.
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
from ..meta import PrecomputedMetadata
from ..tasks.image import DownsampleTask, TransferTask
from ..tasks.stats import CountVoxelsTask, refuse_unported as refuse_graphene_census
from ..volume import Volume
from .common import GridTaskIterator, get_bounds, operator_contact

MEMORY_TARGET = int(3.5e9)  # bytes per task


def _resolve_auto_compress(compress, encoding, vol, mip):
  """compress="auto": gzip for encodings that benefit (raw, cseg,
  compresso, crackle); no second-stage compression for the image codecs,
  which compress themselves."""
  if compress != "auto":
    return compress
  enc = (encoding or vol.meta.encoding(mip)).lower()
  if enc in ("raw", "compressed_segmentation", "compresso",
             "compresso-cpsx", "crackle"):
    return "gzip"
  return False


def _warn_truncated_mips(factors, num_mips: int, shape, chunk_size):
  """Say so when the task shape holds fewer chunk-writable mips than
  asked for."""
  if len(factors) >= num_mips:
    return
  warnings.warn(
    f"requested num_mips={num_mips} but task shape "
    f"{[int(v) for v in shape]} only supports {len(factors)} "
    f"chunk-writable mip(s) (chunk {[int(v) for v in chunk_size]}); "
    f"raise memory_target or pass a larger shape to plan the full "
    f"pyramid, or re-run downsampling from the deepest produced mip",
    stacklevel=3,
  )


def _provenance(vol: Volume, method: dict):
  vol.meta.refresh_provenance()
  vol.meta.add_provenance_entry(jsonify(method), operator_contact())
  vol.meta.commit_provenance()


def _refuse_sharded(vol: Volume, what: str):
  if any("sharding" in scale for scale in vol.info["scales"]):
    raise NotImplementedError(
      f"sharded scales ({what} {vol.cloudpath}) are not ported to "
      "igneous_tpu_torch yet"
    )


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
  encoding_level: Optional[int] = None,
  encoding_effort: Optional[int] = None,
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
  vol = Volume(layer_path, mip=mip)
  compress = _resolve_auto_compress(compress, encoding, vol, mip)
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
  _warn_truncated_mips(factors, num_mips, shape, cs)
  create_downsample_scales(
    vol.meta, mip, shape, factor,
    num_mips=len(factors), chunk_size=chunk_size, encoding=encoding,
  )
  if encoding_level is not None or encoding_effort is not None:
    for m in range(mip + 1, mip + 1 + len(factors)):
      vol.meta.set_encoding(m, None, encoding_level, encoding_effort)
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
    _provenance(vol, {
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
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_transfer_tasks(
  src_layer_path: str,
  dest_layer_path: str,
  chunk_size: Optional[Sequence[int]] = None,
  shape: Optional[Sequence[int]] = None,
  mip: int = 0,
  dest_voxel_offset: Optional[Sequence[int]] = None,
  translate: Sequence[int] = (0, 0, 0),
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
  fill_missing: bool = False,
  skip_first: bool = False,
  skip_downsamples: bool = False,
  delete_black_uploads: bool = False,
  background_color: int = 0,
  sparse: bool = False,
  compress="gzip",
  encoding: Optional[str] = None,
  encoding_level: Optional[int] = None,
  encoding_effort: Optional[int] = None,
  num_mips: int = 0,
  factor: Optional[Sequence[int]] = None,
  memory_target: int = MEMORY_TARGET,
  downsample_method: str = "auto",
  agglomerate: bool = False,
  timestamp: Optional[float] = None,
  stop_layer: Optional[int] = None,
  clean_info: bool = False,
  no_src_update: bool = False,
  truncate_scales: bool = True,
  cutout: bool = False,
  use_https_for_source: bool = False,
  max_mips: Optional[int] = None,
  preserve_chunk_size: bool = True,
):
  """Grid of TransferTasks; creates or extends the destination info.

  ``cutout`` restricts a NEWLY created destination's bounds to ``bounds``;
  ``truncate_scales`` drops scales above ``mip`` from a new destination;
  ``clean_info`` scrubs mesh/skeleton fields from a new destination;
  ``no_src_update`` skips the source provenance note.
  ``use_https_for_source`` only implies ``no_src_update``.
  ``agglomerate``, ``timestamp`` and ``stop_layer`` (graphene sources)
  and sharded scales raise NotImplementedError before anything is
  written."""
  if agglomerate or timestamp is not None or stop_layer is not None:
    raise NotImplementedError(
      "graphene transfers (agglomerate/timestamp/stop_layer) are not "
      "ported to igneous_tpu_torch"
    )
  src = Volume(src_layer_path, mip=mip)
  _refuse_sharded(src, "source")
  compress = _resolve_auto_compress(compress, encoding, src, mip)
  if max_mips is not None:
    num_mips = max_mips  # the reference's keyword for the same cap
  if (not preserve_chunk_size and chunk_size is None
      and src.meta.num_mips > mip + 1):
    chunk_size = [int(v) for v in src.meta.chunk_size(mip + 1)]
  if factor is None:
    factor = DEFAULT_FACTOR

  # the destination mirrors the source's scales through `mip` (so its mip
  # indices line up with the task's), with fresh chunking
  src_scale = src.meta.scale(mip)
  dest_chunk = list(chunk_size) if chunk_size else src_scale["chunk_sizes"][0]
  base_scale = src.meta.scale(0)
  dest_info = PrecomputedMetadata.create_info(
    num_channels=src.num_channels,
    layer_type=src.layer_type,
    data_type=src.meta.data_type,
    encoding=encoding or src_scale["encoding"],
    resolution=base_scale["resolution"],
    voxel_offset=(
      list(dest_voxel_offset)
      if dest_voxel_offset is not None
      else (np.asarray(base_scale.get("voxel_offset", [0, 0, 0]))
            + np.asarray(translate)).tolist()
    ),
    volume_size=base_scale["size"],
    chunk_size=dest_chunk,
  )
  if use_https_for_source:
    no_src_update = True  # a read-only source gets no provenance note
  try:
    dest = Volume(dest_layer_path)  # an existing destination's info wins
    _refuse_sharded(dest, "destination")
  except FileNotFoundError:
    dest = Volume.create(dest_layer_path, dest_info)
    for m in range(1, mip + 1):
      dest.meta.add_scale(
        np.asarray(src.meta.downsample_ratio(m)),
        chunk_size=dest_chunk,
        encoding=encoding or src.meta.encoding(m),
      )
    if not truncate_scales:
      # keep the source's scale structure above `mip` too
      for m in range(mip + 1, src.meta.num_mips):
        dest.meta.add_scale(
          np.asarray(src.meta.downsample_ratio(m)),
          chunk_size=dest_chunk,
          encoding=encoding or src.meta.encoding(m),
        )
    if cutout and bounds is not None:
      # restrict the new volume to the requested bounds
      bounds_res = np.asarray(src.meta.resolution(bounds_mip), dtype=float)
      for i in range(len(dest.info["scales"])):
        ratio = bounds_res / np.asarray(dest.meta.resolution(i), dtype=float)
        sc = dest.info["scales"][i]
        sc["voxel_offset"] = [
          int(v) for v in np.asarray(bounds.minpt, dtype=float) * ratio
        ]
        sc["size"] = [
          int(np.ceil(v)) for v in np.asarray(bounds.size3(), float) * ratio
        ]
    if clean_info:
      for key in ("mesh", "meshing", "skeletons"):
        dest.info.pop(key, None)

  if shape is None:
    shape = downsample_shape_from_memory_target(
      src.dtype.itemsize,
      dest_chunk[0], dest_chunk[1], dest_chunk[2],
      factor, memory_target,
      max_mips=max(num_mips, 1),
      num_channels=src.num_channels,
    )
  shape = Vec(*shape)

  if num_mips > 0:
    factors = chunk_writable_factors(
      shape, factor, num_mips, dest_chunk, dest.meta.bounds(mip).size3()
    )
    if not factors:
      raise ValueError(
        f"task shape {shape.tolist()} admits no chunk-writable downsample "
        f"by {list(factor)} (chunk {list(dest_chunk)}); raise "
        f"memory_target, pass a larger/even shape, or num_mips=0"
      )
    _warn_truncated_mips(factors, num_mips, shape, dest_chunk)
    create_downsample_scales(
      dest.meta, mip, shape, factor, num_mips=len(factors),
      chunk_size=dest_chunk, encoding=encoding,
    )
    # the tasks carry the truncated plan: deeper scales may already exist
    # in the destination (truncate_scales=False)
    num_mips = len(factors)
  if encoding_level is not None or encoding_effort is not None:
    for m in range(mip, len(dest.info["scales"])):
      dest.meta.set_encoding(m, None, encoding_level, encoding_effort)
  dest.commit_info()

  task_bounds = get_bounds(src, bounds, mip, bounds_mip)

  def make_task(shape_: Vec, offset: Vec):
    return TransferTask(
      src_path=src_layer_path,
      dest_path=dest_layer_path,
      mip=mip,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      fill_missing=fill_missing,
      translate=tuple(translate),
      skip_first=skip_first,
      skip_downsamples=skip_downsamples,
      delete_black_uploads=delete_black_uploads,
      background_color=background_color,
      sparse=sparse,
      compress=compress,
      downsample_method=downsample_method,
      num_mips=num_mips,
      factor=tuple(factor),
      agglomerate=agglomerate,
      timestamp=timestamp,
      stop_layer=stop_layer,
    )

  def finish():
    _provenance(dest, {
      "task": "TransferTask",
      "src": src_layer_path,
      "dest": dest_layer_path,
      "mip": mip,
      "shape": shape.tolist(),
      "translate": list(translate),
      "bounds": task_bounds.to_list(),
    })
    if not no_src_update:
      # note the outbound copy on the source too
      _provenance(src, {
        "task": "TransferTask",
        "transferred_to": dest_layer_path,
        "mip": mip,
        "bounds": task_bounds.to_list(),
      })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_voxel_counting_tasks(
  cloudpath: str,
  mip: int = 0,
  shape: Sequence[int] = (512, 512, 512),
  bounds: Optional[Bbox] = None,
  fill_missing: bool = False,
  agglomerate: bool = False,
  timestamp: Optional[float] = None,
):
  """Census phase of the voxel statistics; reduce with
  ``tasks.stats.accumulate_voxel_counts``."""
  refuse_graphene_census(agglomerate, timestamp)
  vol = Volume(cloudpath, mip=mip)
  task_bounds = get_bounds(vol, bounds, mip, mip)
  shape = Vec(*shape)

  def make_task(shape_: Vec, offset: Vec):
    return CountVoxelsTask(
      cloudpath=cloudpath,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      fill_missing=fill_missing,
      agglomerate=agglomerate,
      timestamp=timestamp,
    )

  return GridTaskIterator(task_bounds, shape, make_task)
