"""Image task factories: the downsample pyramid (isotropic factors
included), the transfer, their sharded forms, the layer-maintenance
tasks, the voxel-count census, contrast correction, the spatial index,
the z reorder and the ROI detection.

Counterpart of ``igneous_tpu/task_creation/image.py``'s
``create_downsampling_tasks``, ``create_transfer_tasks``,
``create_image_shard_transfer_tasks``,
``create_image_shard_downsample_tasks``, ``create_deletion_tasks``,
``create_blackout_tasks``, ``create_touch_tasks``,
``create_quantized_affinity_info``, ``create_quantize_tasks``,
``create_fixup_downsample_tasks``, ``create_voxel_counting_tasks``,
``create_luminance_levels_tasks``, ``create_contrast_normalization_tasks``,
``create_clahe_tasks``, ``create_spatial_index_tasks``,
``create_reordering_tasks`` and ``compute_rois``: the same task shapes,
scales, sharding specs, ``info`` (ROIs included) and provenance, and the
same payloads. From graphene sources, transfers and the census take
``agglomerate`` / ``timestamp`` (transfers also ``stop_layer``), with the
JAX package's ``ValueError`` for an invalid combination before anything is
written.
"""

from __future__ import annotations

import sys
import warnings
from typing import Optional, Sequence

import numpy as np

from ..downsample_scales import (
  DEFAULT_FACTOR,
  axis_to_factor,
  chunk_writable_factors,
  create_downsample_scales,
  downsample_shape_from_memory_target,
  near_isotropic_factor_sequence,
)
from ..lib import Bbox, Vec, chunk_bboxes, jsonify
from ..meta import PrecomputedMetadata
from ..ops import pooling
from ..ops.ccl import component_boxes, connected_components
from ..ops.mesh import labels_on_device
from ..sharding import create_sharded_image_info, image_shard_shape_from_spec
from ..tasks.image import (
  BlackoutTask,
  DeleteTask,
  DownsampleTask,
  QuantizeTask,
  TouchTask,
  TransferTask,
)
from ..device import get_device
from ..tasks.contrast import CLAHETask, ContrastNormalizationTask, LuminanceLevelsTask
from ..tasks.image_sharded import ImageShardDownsampleTask, ImageShardTransferTask
from ..tasks.stats import (
  CountVoxelsTask,
  ReorderTask,
  SpatialIndexTask,
)
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


def _transfer_destination(
  dest_path: str, dest_info: dict, src: Volume, mip: int, chunk_size, encoding,
  truncate_scales: bool, cutout: bool, bounds: Optional[Bbox], bounds_mip: int,
  clean_info: bool, mip_voxel_offset=None,
) -> Volume:
  """A transfer's destination. An existing layer's info wins. A new one
  (``dest_info``) mirrors the source's scales through ``mip``, so that the
  mip indices line up (all of them unless ``truncate_scales``), with
  ``chunk_size``; then ``mip_voxel_offset`` sets scale ``mip``'s offset,
  ``cutout`` restricts every scale to ``bounds`` (given at the source's
  ``bounds_mip``) and ``clean_info`` scrubs the mesh and skeleton fields."""
  try:
    return Volume(dest_path)
  except FileNotFoundError:
    pass
  dest = Volume.create(dest_path, dest_info)
  for m in range(1, mip + 1 if truncate_scales else src.meta.num_mips):
    dest.meta.add_scale(
      np.asarray(src.meta.downsample_ratio(m)),
      chunk_size=chunk_size,
      encoding=encoding or src.meta.encoding(m),
    )
  if mip_voxel_offset is not None:
    dest.meta.scale(mip)["voxel_offset"] = list(mip_voxel_offset)
  if cutout and bounds is not None:
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
  return dest


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

  ``factor`` is one triple, a per-mip sequence of triples, or the string
  "isotropic" (per-mip factors that drive the resolution toward
  isotropy, ``near_isotropic_factor_sequence``)."""
  vol = Volume(layer_path, mip=mip)
  compress = _resolve_auto_compress(compress, encoding, vol, mip)
  if (not preserve_chunk_size and chunk_size is None
      and vol.meta.num_mips > mip + 1):
    # reuse the NEXT mip's existing chunking for the new scales
    chunk_size = [int(v) for v in vol.meta.chunk_size(mip + 1)]
  if isinstance(factor, str):
    if factor != "isotropic":
      raise ValueError(f"unknown factor spec {factor!r}")
    factor = near_isotropic_factor_sequence([int(v) for v in vol.resolution], num_mips)
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
  ``agglomerate`` (graphene sources) writes the proofread root ids as of
  ``timestamp``, ``stop_layer=2`` the L2 ids, into a uint64 destination.
  A sharded source scale reads through ``Volume``."""
  src = Volume(src_layer_path, mip=mip)
  compress = _resolve_auto_compress(compress, encoding, src, mip)
  if max_mips is not None:
    num_mips = max_mips  # the reference's keyword for the same cap
  if (not preserve_chunk_size and chunk_size is None
      and src.meta.num_mips > mip + 1):
    chunk_size = [int(v) for v in src.meta.chunk_size(mip + 1)]
  if factor is None:
    factor = DEFAULT_FACTOR
  # the graphene options, before any destination state is written
  materialize_ids = agglomerate or stop_layer is not None
  if materialize_ids and src.graphene is None:
    raise ValueError(
      "agglomerate/stop_layer transfers require a graphene:// source"
    )
  if stop_layer not in (None, 1, 2):
    raise ValueError(f"stop_layer must be 1 or 2: {stop_layer!r}")
  if timestamp is not None and not materialize_ids:
    raise ValueError(
      "timestamp only applies with agglomerate=True or stop_layer"
    )

  # the destination mirrors the source's scales through `mip` (so its mip
  # indices line up with the task's), with fresh chunking
  src_scale = src.meta.scale(mip)
  dest_chunk = list(chunk_size) if chunk_size else src_scale["chunk_sizes"][0]
  base_scale = src.meta.scale(0)
  dest_info = PrecomputedMetadata.create_info(
    num_channels=src.num_channels,
    layer_type=src.layer_type,
    # root and L2 ids are uint64 above 2^40, whatever the watershed
    # layer's dtype: a narrower destination would wrap them
    data_type="uint64" if materialize_ids else src.meta.data_type,
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
  dest = _transfer_destination(
    dest_layer_path, dest_info, src, mip, dest_chunk, encoding, truncate_scales,
    cutout, bounds, bounds_mip, clean_info,
  )
  if materialize_ids and dest.meta.data_type != "uint64":
    raise ValueError(
      f"agglomerate/stop_layer transfers write uint64 root ids, but the "
      f"existing destination is {dest.meta.data_type}; they would "
      f"silently wrap on upload — delete or widen the destination first"
    )

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


def _shard_data_encoding(compress) -> Optional[str]:
  """The shard ``data_encoding`` of the ``compress`` knob: None ("auto")
  leaves it to the encoding, gzip unless the codec compresses itself."""
  if compress == "auto":
    return None
  if compress in (None, False, 0) or str(compress).lower() in ("none", "false"):
    return "raw"
  if compress is True or str(compress).lower() == "gzip":
    return "gzip"
  raise ValueError(f"unsupported shard compress: {compress!r}")


def create_image_shard_transfer_tasks(
  src_layer_path: str,
  dest_layer_path: str,
  mip: int = 0,
  chunk_size: Optional[Sequence[int]] = None,
  encoding: Optional[str] = None,
  encoding_level: Optional[int] = None,
  encoding_effort: Optional[int] = None,
  translate: Sequence[int] = (0, 0, 0),
  dest_voxel_offset: Optional[Sequence[int]] = None,
  fill_missing: bool = False,
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
  uncompressed_shard_bytesize: int = MEMORY_TARGET,
  memory_target: Optional[int] = None,
  cutout: bool = False,
  clean_info: bool = False,
  truncate_scales: bool = True,
  agglomerate: bool = False,
  timestamp: Optional[float] = None,
  stop_layer: Optional[int] = None,
  compress="auto",
  minishard_index_encoding: str = "gzip",
  use_https_for_source: bool = False,
):
  """Transfer into a SHARDED destination scale, one task per shard-aligned
  region. ``memory_target`` is another name for
  ``uncompressed_shard_bytesize``; ``compress`` False forces raw shard
  data. ``use_https_for_source`` has no effect (sharded transfers write no
  source provenance)."""
  del use_https_for_source
  src = Volume(src_layer_path, mip=mip)
  if memory_target is not None:
    uncompressed_shard_bytesize = memory_target
  # the graphene options, before any destination state is written
  materialize_ids = agglomerate or stop_layer is not None
  if materialize_ids and src.graphene is None:
    raise ValueError(
      "agglomerate/stop_layer transfers require a graphene:// source"
    )
  if stop_layer not in (None, 1, 2):
    raise ValueError(f"stop_layer must be 1 or 2: {stop_layer!r}")
  if timestamp is not None and not materialize_ids:
    raise ValueError(
      "timestamp only applies with agglomerate=True or stop_layer"
    )
  data_encoding = _shard_data_encoding(compress)
  src_scale = src.meta.scale(mip)
  dest_chunk = list(chunk_size) if chunk_size else src_scale["chunk_sizes"][0]
  dest_offset = (
    list(dest_voxel_offset)
    if dest_voxel_offset is not None
    else (np.asarray(src_scale.get("voxel_offset", [0, 0, 0]))
          + np.asarray(translate)).tolist()
  )
  spec = create_sharded_image_info(
    dataset_size=src_scale["size"],
    chunk_size=dest_chunk,
    encoding=encoding or src_scale["encoding"],
    # the shard spec's dtype follows the ids written; the layer's
    # data_type stays the source's, as in the JAX package
    dtype="uint64" if materialize_ids else src.meta.data_type,
    uncompressed_shard_bytesize=uncompressed_shard_bytesize,
    minishard_index_encoding=minishard_index_encoding,
    data_encoding=data_encoding,
  )
  # the destination mirrors the source's scales through `mip`, so that the
  # mip indices line up; dest_voxel_offset is at mip 0's geometry
  base_scale = src.meta.scale(0)
  dest_info = PrecomputedMetadata.create_info(
    num_channels=src.num_channels,
    layer_type=src.layer_type,
    data_type=src.meta.data_type,
    encoding=encoding or base_scale["encoding"],
    resolution=base_scale["resolution"],
    voxel_offset=(
      dest_offset if mip == 0
      else base_scale.get("voxel_offset", [0, 0, 0])
    ),
    volume_size=base_scale["size"],
    chunk_size=dest_chunk,
  )
  dest = _transfer_destination(
    dest_layer_path, dest_info, src, mip, dest_chunk, encoding, truncate_scales,
    cutout, bounds, bounds_mip, clean_info,
    mip_voxel_offset=dest_voxel_offset if mip > 0 else None,
  )
  # the spec lands on the scale the tasks write, also of an existing layer
  dest.meta.scale(mip)["sharding"] = spec
  if encoding_level is not None or encoding_effort is not None:
    dest.meta.set_encoding(mip, None, encoding_level, encoding_effort)
  dest.commit_info()

  shape = Vec(*image_shard_shape_from_spec(spec, src_scale["size"], dest_chunk))
  # shard files are written once: the task grid is shard aligned, so no
  # two tasks write the same file
  task_bounds = get_bounds(src, bounds, mip, bounds_mip).expand_to_chunk_size(
    shape, src.meta.voxel_offset(mip)
  ).clamp(src.meta.bounds(mip))

  def make_task(shape_: Vec, offset: Vec):
    return ImageShardTransferTask(
      src_path=src_layer_path,
      dest_path=dest_layer_path,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      fill_missing=fill_missing,
      translate=tuple(translate),
      agglomerate=agglomerate,
      timestamp=timestamp,
      stop_layer=stop_layer,
    )

  def finish():
    _provenance(dest, {
      "task": "ImageShardTransferTask",
      "src": src_layer_path, "dest": dest_layer_path,
      "mip": mip, "shape": shape.tolist(),
      "sharding": spec,
      "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_image_shard_downsample_tasks(
  layer_path: str,
  mip: int = 0,
  fill_missing: bool = False,
  sparse: bool = False,
  chunk_size: Optional[Sequence[int]] = None,
  encoding: Optional[str] = None,
  encoding_level: Optional[int] = None,
  encoding_effort: Optional[int] = None,
  factor: Sequence[int] = (2, 2, 1),
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
  memory_target: int = MEMORY_TARGET,
  downsample_method: str = "auto",
  num_mips: int = 1,
  agglomerate: bool = False,
  timestamp: Optional[float] = None,
  truncate_scales: bool = False,
):
  """Downsampled SHARDED mips, several a pass. Each of the ``num_mips``
  new scales gets its own sharding spec, sized so that a task holds the
  source region of one shard of it; the task stride is the largest
  per-mip shard extent (shard extents are powers of two per axis, so the
  largest contains them all), and ``num_mips`` is clamped so that every
  produced mip stays chunk aligned within the stride."""
  vol = Volume(layer_path, mip=mip)
  if agglomerate and vol.graphene is None:
    raise ValueError("agglomerate downsamples require a graphene:// source")
  if agglomerate and vol.meta.data_type != "uint64":
    # a layer has one data_type: root ids cannot go into a narrower
    # watershed layer's own scales
    raise ValueError(
      f"agglomerate downsamples write uint64 root ids, but this layer's "
      f"data_type is {vol.meta.data_type}; transfer the roots to a "
      f"uint64 destination first"
    )
  if truncate_scales:
    # drop the scales above mip before making them again
    vol.info["scales"] = vol.info["scales"][: mip + 1]
  factor = tuple(int(v) for v in factor)
  num_mips = max(int(num_mips), 1)
  cs = list(chunk_size) if chunk_size else [int(v) for v in vol.meta.chunk_size(mip)]

  base_ratio = np.asarray(vol.meta.downsample_ratio(mip), dtype=np.int64)
  specs = []
  dest_mips = []
  stride = np.zeros(3, dtype=np.int64)
  cum = np.ones(3, dtype=np.int64)
  for _ in range(num_mips):
    cum = cum * np.asarray(factor, dtype=np.int64)
    dest_size = [int(v) for v in -(-np.asarray(vol.meta.volume_size(mip)) // cum)]
    spec = create_sharded_image_info(
      dataset_size=dest_size,
      chunk_size=cs,
      encoding=encoding or vol.meta.encoding(mip),
      dtype=vol.meta.data_type,
      # a task holds the SOURCE region of one shard: a voxel at mip+i
      # costs prod(cum) source voxels, plus the pyramid
      uncompressed_shard_bytesize=max(
        int(memory_target // (int(np.prod(cum)) + 1)), int(1e6)
      ),
    )
    vol.meta.add_scale(base_ratio * cum, chunk_size=cs, encoding=encoding, sharding=spec)
    dmip = vol.meta.mip_from_resolution(
      np.asarray(vol.meta.scale(0)["resolution"]) * base_ratio * cum
    )
    if encoding_level is not None or encoding_effort is not None:
      vol.meta.set_encoding(dmip, None, encoding_level, encoding_effort)
    specs.append(spec)
    dest_mips.append(dmip)
    shard_shape = np.asarray(
      image_shard_shape_from_spec(spec, dest_size, cs), dtype=np.int64
    )
    stride = np.maximum(stride, shard_shape * cum)

  # clamp num_mips so that every produced mip's region inside the stride
  # is chunk aligned
  max_mips = num_mips
  for axis in range(3):
    if factor[axis] == 1:
      continue
    chunks_per_dim = stride[axis] // cs[axis]
    max_mips = min(max_mips, int(
      np.floor(np.log2(max(chunks_per_dim, 1)) / np.log2(factor[axis]))
    ))
  max_mips = max(max_mips, 1)
  if max_mips < num_mips:
    # the unreachable scales go again
    for dmip in sorted(dest_mips[max_mips:], reverse=True):
      del vol.info["scales"][dmip]
    dest_mips = dest_mips[:max_mips]
    specs = specs[:max_mips]
  if max_mips > 1 and (encoding or vol.meta.encoding(mip)) == "jpeg":
    # a lossy pyramid keeps its top mip lossless, so that a later pass
    # can build on it
    vol.meta.set_encoding(dest_mips[-1], "png", 9)
  vol.commit_info()

  shape = Vec(*stride)
  # shard files are written once: the task grid is shard aligned
  task_bounds = get_bounds(vol, bounds, mip, bounds_mip).expand_to_chunk_size(
    shape, vol.meta.voxel_offset(mip)
  ).clamp(vol.meta.bounds(mip))

  def make_task(shape_: Vec, offset: Vec):
    return ImageShardDownsampleTask(
      src_path=layer_path,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      fill_missing=fill_missing,
      sparse=sparse,
      factor=list(factor),
      downsample_method=downsample_method,
      num_mips=max_mips,
      agglomerate=agglomerate,
      timestamp=timestamp,
    )

  def finish():
    _provenance(vol, {
      "task": "ImageShardDownsampleTask",
      "mip": mip, "dest_mips": [int(m) for m in dest_mips],
      "num_mips": max_mips,
      "factor": list(factor), "sharding": specs[0],
      "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_deletion_tasks(
  layer_path: str,
  mip: int = 0,
  num_mips: int = 0,
  shape: Optional[Sequence[int]] = None,
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
):
  """Grid of DeleteTasks over ``bounds`` (default: the whole layer), each
  deleting its chunks at mip ... mip+num_mips."""
  vol = Volume(layer_path, mip=mip)
  if shape is None:
    shape = vol.meta.chunk_size(mip) * 4
  shape = Vec(*shape)
  task_bounds = get_bounds(vol, bounds, mip, bounds_mip)

  def make_task(shape_: Vec, offset: Vec):
    return DeleteTask(
      layer_path=layer_path,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      num_mips=num_mips,
    )

  def finish():
    _provenance(vol, {
      "task": "DeleteTask", "mip": mip, "num_mips": num_mips,
      "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_blackout_tasks(
  cloudpath: str,
  bounds: Bbox,
  mip: int = 0,
  shape: Sequence[int] = (2048, 2048, 64),
  value: int = 0,
  non_aligned_writes: bool = False,
):
  """Grid of BlackoutTasks writing ``value`` over ``bounds``, expanded to
  the chunk grid unless ``non_aligned_writes``."""
  vol = Volume(cloudpath, mip=mip)
  shape = Vec(*shape)
  if not non_aligned_writes:
    bounds = bounds.expand_to_chunk_size(
      vol.meta.chunk_size(mip), vol.meta.voxel_offset(mip)
    )
  bounds = Bbox.intersection(bounds, vol.meta.bounds(mip))

  def make_task(shape_: Vec, offset: Vec):
    return BlackoutTask(
      cloudpath=cloudpath,
      mip=mip,
      shape=np.minimum(
        np.asarray(shape_), np.asarray(bounds.maxpt) - np.asarray(offset)
      ).tolist(),
      offset=offset.tolist(),
      value=value,
      non_aligned_writes=non_aligned_writes,
    )

  return GridTaskIterator(bounds, shape, make_task)


def create_touch_tasks(
  cloudpath: str,
  mip: int = 0,
  shape: Sequence[int] = (2048, 2048, 64),
  bounds: Optional[Bbox] = None,
):
  """Grid of TouchTasks: read every chunk, a missing one raising."""
  vol = Volume(cloudpath, mip=mip)
  shape = Vec(*shape)
  task_bounds = get_bounds(vol, bounds, mip, mip)

  def make_task(shape_: Vec, offset: Vec):
    return TouchTask(
      cloudpath=cloudpath, mip=mip,
      shape=shape_.tolist(), offset=offset.tolist(),
    )

  def finish():
    _provenance(vol, {
      "task": "TouchTask", "mip": mip, "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_quantized_affinity_info(
  src_layer: str,
  dest_layer: str,
  shape: Sequence[int],
  mip: int,
  chunk_size: Sequence[int],
  encoding: str = "raw",
) -> dict:
  """The info of a one-channel uint8 image layer with the geometry of
  ``src_layer``'s scale at ``mip``."""
  scale = Volume(src_layer, mip=mip).meta.scale(mip)
  return PrecomputedMetadata.create_info(
    num_channels=1,
    layer_type="image",
    data_type="uint8",
    encoding=encoding,
    resolution=scale["resolution"],
    voxel_offset=scale.get("voxel_offset", [0, 0, 0]),
    volume_size=scale["size"],
    chunk_size=chunk_size,
  )


def create_quantize_tasks(
  src_layer: str,
  dest_layer: str,
  shape: Sequence[int],
  mip: int = 0,
  fill_missing: bool = False,
  chunk_size: Sequence[int] = (128, 128, 64),
  encoding: str = "raw",
  bounds: Optional[Bbox] = None,
  bounds_mip: int = 0,
):
  """Create the quantized destination and a grid of QuantizeTasks."""
  shape = Vec(*shape)
  info = create_quantized_affinity_info(
    src_layer, dest_layer, shape, mip, chunk_size, encoding=encoding,
  )
  dest = Volume.create(dest_layer, info)
  src = Volume(src_layer, mip=mip)
  task_bounds = get_bounds(src, bounds, mip, bounds_mip)

  def make_task(shape_: Vec, offset: Vec):
    return QuantizeTask(
      source_layer_path=src_layer,
      dest_layer_path=dest_layer,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      fill_missing=fill_missing,
    )

  def finish():
    _provenance(dest, {
      "task": "QuantizeTask", "mip": mip, "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_fixup_downsample_tasks(
  layer_path: str,
  bad_bboxes: Optional[Sequence[Bbox]] = None,
  mip: int = 0,
  shape: Sequence[int] = (2048, 2048, 64),
  fill_missing: bool = True,
  num_mips: int = 1,
  sparse: bool = False,
  points: Optional[Sequence[Sequence[int]]] = None,
  axis: str = "z",
):
  """DownsampleTasks that run again over damaged regions: the task cells
  of ``shape`` that meet each bbox, or each mip-0 point in ``points``
  (one inside each black spot), each cell once."""
  vol = Volume(layer_path, mip=mip)
  bad_bboxes = list(bad_bboxes or [])
  if points:
    ratio = np.asarray(vol.meta.downsample_ratio(mip), dtype=np.int64)
    bad_bboxes += [
      Bbox(Vec(*(np.asarray(p, np.int64) // ratio)),
           Vec(*(np.asarray(p, np.int64) // ratio)) + 1)
      for p in points
    ]
  shape = Vec(*shape)
  seen = set()
  for bbx in bad_bboxes:
    aligned = Bbox.intersection(
      bbx.expand_to_chunk_size(shape, vol.meta.voxel_offset(mip)), vol.meta.bounds(mip)
    )
    for task_box in chunk_bboxes(aligned, shape, vol.meta.voxel_offset(mip), clamp=False):
      key = task_box.to_filename()
      if key in seen:
        continue
      seen.add(key)
      yield DownsampleTask(
        layer_path=layer_path,
        mip=mip,
        shape=shape.tolist(),
        offset=[int(v) for v in task_box.minpt],
        fill_missing=fill_missing,
        sparse=sparse,
        num_mips=num_mips,
        factor=tuple(int(v) for v in axis_to_factor(axis)),
      )


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
  vol = Volume(cloudpath, mip=mip)
  if agglomerate and vol.graphene is None:
    # fail at creation, not in every queued task
    raise ValueError("agglomerate voxel counting requires a graphene:// path")
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


def create_luminance_levels_tasks(
  src_path: str,
  levels_path: Optional[str] = None,
  mip: int = 0,
  coverage_factor: float = 0.01,
  shape: Optional[Sequence[int]] = None,
  offset: Optional[Sequence[int]] = None,
  bounds: Optional[Bbox] = None,
  bounds_mip: Optional[int] = None,
  fill_missing: bool = False,
):
  """Phase 1 of contrast correction: per-z histograms, one task per
  chunk-z-aligned slab unless ``shape`` says otherwise (a task downloads
  its sampled patches as whole z columns, so each stored chunk decodes
  once)."""
  vol = Volume(src_path, mip=mip)
  if offset is not None and bounds is None and shape is not None:
    # a shape/offset pair: one explicit task window
    bounds = Bbox(Vec(*offset), Vec(*offset) + Vec(*shape))
  task_bounds = get_bounds(
    vol, bounds, mip, mip if bounds_mip is None else bounds_mip,
    chunk_size=vol.meta.chunk_size(mip),
  )
  if shape is None:
    sz3 = task_bounds.size3()
    shape = (int(sz3.x), int(sz3.y), int(vol.meta.chunk_size(mip).z))
  shape = Vec(*shape)

  def make_task(shape_: Vec, offset: Vec):
    return LuminanceLevelsTask(
      src_path=src_path,
      levels_path_=levels_path,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      coverage_factor=coverage_factor,
      fill_missing=fill_missing,
    )

  return GridTaskIterator(task_bounds, shape, make_task)


def _same_geometry_info(src: Volume, mip: int, layer_type: str, chunk_size,
                        encoding=None, voxel_offset=None) -> dict:
  """The info of a new one-scale layer with scale ``mip`` of ``src``'s
  geometry."""
  scale = src.meta.scale(mip)
  return PrecomputedMetadata.create_info(
    num_channels=src.num_channels,
    layer_type=layer_type,
    data_type=src.meta.data_type,
    encoding=encoding or scale["encoding"],
    resolution=scale["resolution"],
    voxel_offset=(scale.get("voxel_offset", [0, 0, 0]) if voxel_offset is None
                  else voxel_offset),
    volume_size=scale["size"],
    chunk_size=chunk_size or scale["chunk_sizes"][0],
  )


def _open_or_create(dest_path: str, info: dict) -> Volume:
  try:
    return Volume(dest_path)
  except FileNotFoundError:
    return Volume.create(dest_path, info)


def create_contrast_normalization_tasks(
  src_path: str,
  dest_path: str,
  levels_path: Optional[str] = None,
  mip: int = 0,
  clip_fraction: float = 0.01,
  shape: Optional[Sequence[int]] = None,
  translate: Sequence[int] = (0, 0, 0),
  bounds: Optional[Bbox] = None,
  bounds_mip: Optional[int] = None,
  fill_missing: bool = False,
  minval: int = 0,
  maxval: int = 255,
  chunk_size: Optional[Sequence[int]] = None,
):
  """Phase 2: histogram stretch into a new layer (8x8 chunks a task by
  default)."""
  src = Volume(src_path, mip=mip)
  scale = src.meta.scale(mip)
  dest = _open_or_create(dest_path, _same_geometry_info(
    src, mip, src.layer_type, chunk_size,
    voxel_offset=(np.asarray(scale.get("voxel_offset", [0, 0, 0]))
                  + np.asarray(translate)).tolist(),
  ))
  task_bounds = get_bounds(
    src, bounds, mip, mip if bounds_mip is None else bounds_mip,
    chunk_size=src.meta.chunk_size(mip),
  )
  if shape is None:
    cs = dest.meta.chunk_size(0)
    shape = (int(cs.x) * 8, int(cs.y) * 8, int(cs.z))
  shape = Vec(*shape)

  def make_task(shape_: Vec, offset: Vec):
    return ContrastNormalizationTask(
      levels_path_=levels_path,
      src_path=src_path,
      dest_path=dest_path,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      clip_fraction=clip_fraction,
      fill_missing=fill_missing,
      translate=tuple(translate),
      minval=minval,
      maxval=maxval,
    )

  def finish():
    _provenance(dest, {
      "task": "ContrastNormalizationTask", "src": src_path,
      "mip": mip, "clip_fraction": clip_fraction,
      "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_clahe_tasks(
  src_path: str,
  dest_path: str,
  mip: int = 0,
  clip_limit: float = 40.0,
  tile_grid_size=8,
  shape: Sequence[int] = (2048, 2048, 64),
  bounds: Optional[Bbox] = None,
  bounds_mip: Optional[int] = None,
  fill_missing: bool = False,
  chunk_size: Optional[Sequence[int]] = None,
):
  """CLAHE of every z plane into a new image layer, one ``clahe`` launch a
  task."""
  src = Volume(src_path, mip=mip)
  dest = _open_or_create(dest_path, _same_geometry_info(src, mip, "image", chunk_size))
  task_bounds = get_bounds(
    src, bounds, mip, mip if bounds_mip is None else bounds_mip,
    chunk_size=src.meta.chunk_size(mip),
  )
  shape = Vec(*shape)

  def make_task(shape_: Vec, offset: Vec):
    return CLAHETask(
      src_path=src_path,
      dest_path=dest_path,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      clip_limit=clip_limit,
      tile_grid_size=tile_grid_size,
      fill_missing=fill_missing,
    )

  def finish():
    _provenance(dest, {
      "task": "CLAHETask", "src": src_path, "mip": mip,
      "clip_limit": clip_limit, "bounds": task_bounds.to_list(),
    })

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_spatial_index_tasks(
  cloudpath: str,
  prefix: str,
  mip: int = 0,
  shape: Sequence[int] = (448, 448, 448),
  bounds: Optional[Bbox] = None,
  fill_missing: bool = False,
):
  """Rebuild a layer's .spatial files under ``prefix`` (a mesh or skeleton
  directory), one per task cell."""
  vol = Volume(cloudpath, mip=mip)
  task_bounds = get_bounds(vol, bounds, mip, mip)
  shape = Vec(*shape)

  def make_task(shape_: Vec, offset: Vec):
    return SpatialIndexTask(
      cloudpath=cloudpath,
      prefix=prefix,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      fill_missing=fill_missing,
    )

  return GridTaskIterator(task_bounds, shape, make_task)


def create_reordering_tasks(
  src_path: str,
  dest_path: str,
  mapping: dict,
  mip: int = 0,
  z_per_task: int = 16,
  fill_missing: bool = False,
  encoding: Optional[str] = None,
  encoding_level: Optional[int] = None,
  encoding_effort: Optional[int] = None,
  compress="gzip",
  delete_black_uploads: bool = False,
  background_color: int = 0,
):
  """Z-slice shuffle (``dest[z] = src[mapping[z]]``) into a fresh layer,
  ``z_per_task`` slices a task."""
  src = Volume(src_path, mip=mip)
  info = _same_geometry_info(src, mip, src.layer_type, None, encoding=encoding)
  try:
    Volume(dest_path)
  except FileNotFoundError:
    dest = Volume.create(dest_path, info)
    if encoding_level is not None or encoding_effort is not None:
      dest.meta.set_encoding(0, None, encoding_level, encoding_effort)
      dest.commit_info()

  z0 = int(src.bounds.minpt.z)
  z1 = int(src.bounds.maxpt.z)
  for zs in range(z0, z1, z_per_task):
    yield ReorderTask(
      src_path=src_path,
      dest_path=dest_path,
      mip=mip,
      z_start=zs,
      z_end=min(zs + z_per_task, z1),
      mapping=mapping,
      fill_missing=fill_missing,
      compress=compress,
      delete_black_uploads=delete_black_uploads,
      background_color=background_color,
    )


def compute_rois(
  cloudpath: str,
  mip: Optional[int] = None,
  threshold: float = 0.0,
  dust_threshold: int = 100,
  suppress_faint_voxels: int = 0,
  max_axial_length: int = 512,
  z_step: Optional[int] = None,
  progress: bool = False,
  save: bool = True,
) -> list:
  """Detect tissue regions of interest: connected components (6-connected)
  of the foreground of the coarsest mip, as physical-space boxes. ``save``
  also records them in the info as mip-0 voxel boxes, flat
  ``[x0, y0, z0, x1, y1, z1]`` lists with inclusive max corners.

  ``suppress_faint_voxels`` zeroes values at or below that level first;
  ``max_axial_length`` halves x and y in memory (2x2x1 averages on the
  device, one ``downsample`` call for all the rounds) until the plane fits
  that square; ``z_step`` evaluates ROIs per z slab, so thin tissue at
  different depths gives separate boxes. A box whose volume is below
  ``dust_threshold`` is dropped. The ROIs come in the JAX package's order,
  ``ndimage.label``'s: by each component's first voxel in C order of the
  (x, y, z) slab, where the port's ``connected_components`` numbers in
  Fortran order."""
  vol = Volume(cloudpath)
  mip = vol.meta.num_mips - 1 if mip is None else mip
  img = vol.download(vol.meta.bounds(mip), mip=mip)[..., 0]
  res = np.asarray(vol.meta.resolution(mip), dtype=np.int64)
  offset = np.asarray(vol.meta.voxel_offset(mip), dtype=np.int64)

  sx, sy, rounds = img.shape[0], img.shape[1], 0
  while sx * sy > max_axial_length ** 2:
    sx, sy, rounds = (sx + 1) // 2, (sy + 1) // 2, rounds + 1
  if rounds:
    img = pooling.downsample(img, (2, 2, 1), rounds, method="average")[-1]
  scale_xy = 2 ** rounds

  if suppress_faint_voxels:
    img = np.where(img <= suppress_faint_voxels, 0, img)
  fg = img > threshold

  nz = img.shape[2]
  z_step = nz if not z_step else int(z_step)
  rois = []
  z_starts = range(0, nz, z_step)
  vx_scale = np.asarray([scale_xy, scale_xy, 1], dtype=np.int64)
  dev = get_device()
  for i, z0 in enumerate(z_starts, start=1):
    if progress:
      # progress goes to stderr, so stdout keeps the ROI lines alone
      print(f"ROI z-slabs: {i}/{len(z_starts)}", file=sys.stderr)
    slab = fg[:, :, z0:z0 + z_step]
    cc, n = connected_components(slab, connectivity=6, return_N=True)
    if not n:
      continue
    seg, _ = labels_on_device(cc, (0, 0, 0), (0, 0, 0), dev)
    lo, hi, first = component_boxes(seg, n)
    del seg
    for label in np.argsort(first[1:], kind="stable") + 1:
      if np.prod(hi[label] - lo[label]) < dust_threshold:
        continue
      mn = (lo[label] + [0, 0, z0]) * vx_scale
      mx = (hi[label] + [0, 0, z0]) * vx_scale
      rois.append(Bbox((mn + offset) * res, (mx + offset) * res))
  if save:
    res0 = np.asarray(vol.meta.resolution(0), dtype=np.int64)
    vol.info["scales"][0]["rois"] = [
      [int(v) for v in np.asarray(r.minpt) // res0]
      + [int(v) - 1 for v in np.asarray(r.maxpt) // res0]
      for r in rois
    ]
    vol.commit_info()
  return rois
