"""Image tasks: transfer and downsample, and the layer-maintenance tasks
(delete, blackout, touch, quantize).

Counterpart of ``igneous_tpu/tasks/image.py``: the same constructor
signatures (so payloads serialized by the JAX package run here), the same
pyramid schedule and the same uploads. Each task publishes a stage plan
(``pipeline.StagePlan``) that ``LocalTaskQueue`` runs through the staged
pipeline, and ``execute()`` runs the same plan on a serial sink. A
transfer decodes its cutout, re-encodes it in the destination's encoding
and chunking (at a translated offset if asked), and builds its mip
pyramid on the port's device with ``ops.pooling.downsample_auto``. A
transfer whose layers line up exactly moves the stored chunk bytes
instead, decoding nothing (the passthrough; ``IGNEOUS_TRANSFER_PASSTHROUGH
=off`` turns it off). From a graphene source, ``agglomerate`` writes the
proofread root ids as of ``timestamp`` (``stop_layer=2`` the L2 ids, 1 the
supervoxels): the cutout downloads on the prefetch thread and its ids are
mapped on the device in the compute stage (``Volume.map_ids``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import chunk_cache, telemetry
from ..analysis import knobs
from ..downsample_scales import DEFAULT_FACTOR, compute_factors, truncate_writable_factors
from ..lib import Bbox, Vec, chunk_bboxes
from ..ops import pooling
from ..pipeline import SerialSink, StagePlan, shared_io_pool
from ..queues.registry import RegisteredTask
from ..storage import CloudFiles, compress_bytes, decompress_bytes, wire_ext
from ..volume import Volume

# an empty cutout stages as a no-op, so the pipeline needs no barrier for it
_NOOP_PLAN = StagePlan(lambda: None, lambda p: None, lambda o, s: None)


def _passthrough_enabled() -> bool:
  """``IGNEOUS_TRANSFER_PASSTHROUGH=0|off|false|no`` sends eligible
  transfers down the decode and re-encode route."""
  return knobs.get_bool("IGNEOUS_TRANSFER_PASSTHROUGH")


def _cutout_nbytes(vol: Volume, bounds: Bbox) -> int:
  """Decoded bytes of ``bounds`` in ``vol``: what the prefetch budget
  reserves before the download starts."""
  voxels = int(np.prod([int(v) for v in bounds.size3()]))
  return voxels * vol.dtype.itemsize * vol.num_channels


def _resolve_factors(
  vol: Volume,
  mip: int,
  task_shape: Sequence[int],
  num_mips: Optional[int],
  factor: Optional[Sequence[int]],
):
  """The pyramid schedule of one task: the factors that divide the task
  shape, truncated at the first destination mip whose cutouts would not
  land on that mip's chunk grid (unless one task spans its whole extent)."""
  if factor is None:
    factor = DEFAULT_FACTOR
  available = vol.meta.num_mips - mip - 1
  num_mips = available if num_mips is None else min(num_mips, available)
  factors = compute_factors(task_shape, factor, num_mips)

  def per_mip(i, cum):
    dest_mip = mip + i + 1
    return vol.meta.chunk_size(dest_mip), vol.meta.bounds(dest_mip).size3()

  return truncate_writable_factors(task_shape, factors, per_mip)


def downsample_and_upload(
  image: np.ndarray,
  bounds: Bbox,
  vol: Volume,
  task_shape: Sequence[int],
  mip: int,
  num_mips: Optional[int] = None,
  factor: Optional[Sequence[int]] = None,
  sparse: bool = False,
  method: str = "auto",
  compress="gzip",
  _mips_out=None,
  sink=None,
):
  """Build the mip pyramid of one cutout on the device and upload every
  level. ``image`` covers ``bounds`` at ``mip``. ``_mips_out`` injects a
  pyramid computed earlier (the batched and paged runners' device stage),
  so that only the upload loop runs here and the chunk bytes stay those
  of solo execution. ``sink`` routes each chunk's encode and put through
  an upload ticket (``Volume.upload``; the caller joins it)."""
  factors = _resolve_factors(vol, mip, task_shape, num_mips, factor)
  if not factors:
    return
  if _mips_out is not None:
    mips_out = _mips_out
  else:
    method = pooling.method_for_layer(vol.layer_type, method)
    mips_out = pooling.downsample_auto(
      image, factors, len(factors), method=method, sparse=sparse
    )

  cur_bounds = bounds.clone()
  for i, mipped in enumerate(mips_out):
    dest_mip = mip + i + 1
    minpt = cur_bounds.minpt // Vec(*factors[i])
    cur_bounds = Bbox(minpt, minpt + Vec(*mipped.shape[:3]))
    dest_bounds = Bbox.intersection(cur_bounds, vol.meta.bounds(dest_mip))
    sl = tuple(slice(0, int(s)) for s in dest_bounds.size3())
    with telemetry.stage("upload"):
      vol.upload(
        dest_bounds, np.asarray(mipped[sl], dtype=vol.dtype),
        mip=dest_mip, compress=compress, sink=sink,
      )


class TransferTask(RegisteredTask):
  """Copy a cutout into the destination's chunking and encoding
  (optionally translated), then build its downsample pyramid on the
  device."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    mip: int,
    shape: Sequence[int],
    offset: Sequence[int],
    fill_missing: bool = False,
    translate: Sequence[int] = (0, 0, 0),
    skip_first: bool = False,
    skip_downsamples: bool = False,
    delete_black_uploads: bool = False,
    background_color: int = 0,
    sparse: bool = False,
    compress="gzip",
    downsample_method: str = "auto",
    num_mips: Optional[int] = None,
    factor: Optional[Sequence[int]] = None,
    agglomerate: bool = False,
    timestamp: Optional[float] = None,
    stop_layer: Optional[int] = None,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.mip = int(mip)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.fill_missing = fill_missing
    self.translate = Vec(*translate)
    self.skip_first = skip_first
    self.skip_downsamples = skip_downsamples
    self.delete_black_uploads = delete_black_uploads
    self.background_color = background_color
    self.sparse = sparse
    self.compress = compress
    self.downsample_method = downsample_method
    self.num_mips = num_mips
    self.factor = factor
    # graphene sources: write root ids (or L2 ids, stop_layer=2) as of
    # the timestamp
    self.agglomerate = bool(agglomerate)
    self.timestamp = timestamp
    self.stop_layer = stop_layer
    if timestamp is not None and not (agglomerate or stop_layer is not None):
      raise ValueError(
        "timestamp only applies to agglomerate/stop_layer downloads; "
        "set agglomerate=True (roots) or stop_layer=2 (L2 ids)"
      )

  def trace_attrs(self) -> dict:
    """Task-span attributes for ``fleet top|trace``: which cutout this
    was, as the JAX package names it."""
    return {
      "dest": self.dest_path,
      "mip": self.mip,
      "bbox": f"{tuple(self.offset)}+{tuple(self.shape)}",
    }

  def _volumes_and_bounds(self):
    src = Volume(self.src_path, mip=self.mip, fill_missing=self.fill_missing)
    dest = Volume(
      self.dest_path,
      mip=self.mip,
      fill_missing=self.fill_missing,
      delete_black_uploads=self.delete_black_uploads,
      background_color=self.background_color,
    )
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), src.bounds
    )
    return src, dest, bounds

  def execute(self):
    src, dest, bounds = self._volumes_and_bounds()
    if bounds.empty():
      return
    # the stage code the pipeline schedules: one implementation, one set
    # of bytes
    plan = self._plan_for(src, dest, bounds)
    plan.upload(plan.compute(plan.download()), SerialSink())

  def stage_plan(self) -> StagePlan:
    """The task's pipeline stages: download the cutout (host only), build
    its pyramid on the device, route every chunk encode and put through
    the sink. A passthrough-eligible transfer publishes a plan that moves
    stored bytes and computes nothing."""
    src, dest, bounds = self._volumes_and_bounds()
    if bounds.empty():
      return _NOOP_PLAN
    return self._plan_for(src, dest, bounds)

  def _plan_for(self, src, dest, bounds: Bbox) -> StagePlan:
    if self._passthrough_eligible(src, dest, bounds):
      return self._passthrough_plan(src, dest, bounds)
    return self._build_plan(src, dest, bounds)

  def _build_plan(self, src, dest, bounds: Bbox) -> StagePlan:
    dest_bounds = Bbox(bounds.minpt + self.translate, bounds.maxpt + self.translate)
    if self.skip_downsamples:
      factors = []
    else:
      factors = _resolve_factors(dest, self.mip, self.shape, self.num_mips, self.factor)
    writes = set()
    if not self.skip_first:
      writes.add((self.dest_path, self.mip))
    writes.update((self.dest_path, self.mip + i + 1) for i in range(len(factors)))

    def download():
      # numpy and storage only: it runs on a prefetch thread
      with telemetry.stage("download"):
        return src.download(bounds)

    def compute(image):
      # the caller's thread: the only one that touches the device
      if self.agglomerate or self.stop_layer is not None:
        image = src.map_ids(
          image, bounds, self.mip, self.agglomerate, self.timestamp,
          self.stop_layer,
        )
      if not factors:
        return image, None
      method = pooling.method_for_layer(dest.layer_type, self.downsample_method)
      return image, pooling.downsample_auto(
        image, factors, len(factors), method=method, sparse=self.sparse
      )

    def upload(outputs, sink):
      image, mips_out = outputs
      if not self.skip_first:
        with telemetry.stage("upload"):
          dest.upload(dest_bounds, image, compress=self.compress, sink=sink)
      if mips_out is not None:
        downsample_and_upload(
          image, dest_bounds, dest,
          task_shape=self.shape, mip=self.mip, num_mips=self.num_mips,
          factor=self.factor, sparse=self.sparse,
          method=self.downsample_method, compress=self.compress,
          _mips_out=mips_out, sink=sink,
        )

    return StagePlan(
      download, compute, upload,
      reads={(self.src_path, self.mip)}, writes=writes,
      nbytes_hint=_cutout_nbytes(dest, bounds),
      aligned_writes=self._writes_chunk_aligned(dest, dest_bounds, factors),
    )

  def _writes_chunk_aligned(self, dest, dest_bounds: Bbox, factors) -> bool:
    """True when every bbox the upload writes (the first mip's cutout and
    each pyramid level, walked with the kernels' ceil-division shapes as
    ``downsample_and_upload`` walks them) is chunk aligned or clipped at
    the volume's bounds: then the plan touches whole chunk objects only
    and may overlap other aligned writers of the same (path, mip)."""
    def aligned(box: Bbox, mip: int) -> bool:
      if box.empty():
        return True  # writes nothing
      expanded = box.expand_to_chunk_size(
        dest.meta.chunk_size(mip), dest.meta.voxel_offset(mip)
      )
      return Bbox.intersection(expanded, dest.meta.bounds(mip)) == box

    if not self.skip_first and not aligned(dest_bounds, self.mip):
      return False
    cur_min = np.asarray(dest_bounds.minpt, dtype=np.int64)
    cur_shape = np.asarray([int(v) for v in dest_bounds.size3()], dtype=np.int64)
    for i, f in enumerate(factors):
      fa = np.asarray([int(v) for v in f], dtype=np.int64)
      cur_min = cur_min // fa
      cur_shape = -(-cur_shape // fa)
      dest_mip = self.mip + i + 1
      box = Bbox.intersection(
        Bbox(cur_min, cur_min + cur_shape), dest.meta.bounds(dest_mip)
      )
      if not aligned(box, dest_mip):
        return False
    return True

  def _passthrough_eligible(self, src, dest, bounds: Bbox) -> bool:
    """Whether the stored chunk objects can move without decoding a voxel:
    the grids, dtype and encoding line up exactly and nothing is
    resampled or remapped."""
    mip = self.mip
    sm, dm = src.meta, dest.meta
    return (
      _passthrough_enabled()
      and self.skip_downsamples
      and not self.skip_first  # skip_first with skip_downsamples does nothing
      and not self.agglomerate
      and self.stop_layer is None
      # the decode route writes explicit background chunks for holes
      and not self.fill_missing
      # the decode route deletes all-background chunks: a stored-byte move
      # cannot tell them without decoding
      and not self.delete_black_uploads
      # an unknown wire compression raises, with context, on the decode route
      and wire_ext(self.compress) is not None
      and tuple(int(v) for v in self.translate) == (0, 0, 0)
      # edge chunks carry the volume's clamped bounds in their names
      and src.bounds == dest.bounds
      and not sm.is_sharded(mip) and not dm.is_sharded(mip)
      and bool(np.all(sm.chunk_size(mip) == dm.chunk_size(mip)))
      and bool(np.all(sm.voxel_offset(mip) == dm.voxel_offset(mip)))
      and src.dtype == dest.dtype
      and sm.encoding(mip) == dm.encoding(mip)
      and (
        sm.encoding(mip) != "compressed_segmentation"
        or bool(np.all(sm.cseg_block_size(mip) == dm.cseg_block_size(mip)))
      )
      and bounds == Bbox.intersection(
        bounds.expand_to_chunk_size(sm.chunk_size(mip), sm.voxel_offset(mip)),
        src.bounds,
      )
    )

  def _passthrough_plan(self, src, dest, bounds: Bbox) -> StagePlan:
    """The zero-decode transfer: stored chunk bytes move as they are when
    their wire compression is already ``compress``, and are only
    re-wrapped (inflate, deflate) otherwise; no chunk codec runs. Every
    write is a whole chunk object, so the plan proves alignment."""
    mip = self.mip
    sm, dm = src.meta, dest.meta
    src_cf, dest_cf = CloudFiles(self.src_path), CloudFiles(self.dest_path)
    dest_ext = wire_ext(self.compress)
    chunks = [
      c for c in (
        Bbox.intersection(gc, src.bounds)
        for gc in chunk_bboxes(
          bounds, sm.chunk_size(mip), offset=sm.voxel_offset(mip), clamp=False
        )
      )
      if not c.empty()
    ]

    def download():
      keys = [sm.chunk_name(mip, c) for c in chunks]
      with telemetry.stage("passthrough_download"):
        if len(keys) > 1:
          return list(shared_io_pool().map(src_cf.get_stored, keys))
        return [src_cf.get_stored(k) for k in keys]

    def compute(stored):
      return stored  # nothing to decode or resample

    def upload(stored, sink):
      with telemetry.stage("passthrough_upload"):
        for c, (data, method) in zip(chunks, stored):
          if data is None:
            continue  # a missing chunk stays missing
          key = dm.chunk_name(mip, c)

          def put_one(key=key, data=data, method=method):
            telemetry.incr("transfer.passthrough.chunks", 1)
            telemetry.incr("transfer.passthrough.bytes", len(data))
            if wire_ext(method) == dest_ext:
              telemetry.incr("transfer.passthrough.verbatim", 1)
              dest_cf.put_stored(key, data, method)
            else:
              telemetry.incr("transfer.passthrough.recompressed", 1)
              dest_cf.put_stored(
                key, compress_bytes(decompress_bytes(data, method), self.compress),
                self.compress,
              )

          sink.submit(put_one)
      chunk_cache.invalidate(dest.cloudpath, mip)

    return StagePlan(
      download, compute, upload,
      reads={(self.src_path, mip)}, writes={(self.dest_path, mip)},
      nbytes_hint=_cutout_nbytes(dest, bounds), aligned_writes=True,
    )


class DownsampleTask(TransferTask):
  """TransferTask onto itself with the source level skipped."""

  def __init__(
    self,
    layer_path: str,
    mip: int,
    shape: Sequence[int],
    offset: Sequence[int],
    fill_missing: bool = False,
    sparse: bool = False,
    delete_black_uploads: bool = False,
    background_color: int = 0,
    compress="gzip",
    downsample_method: str = "auto",
    num_mips: Optional[int] = None,
    factor: Optional[Sequence[int]] = None,
  ):
    super().__init__(
      src_path=layer_path,
      dest_path=layer_path,
      mip=mip,
      shape=shape,
      offset=offset,
      fill_missing=fill_missing,
      skip_first=True,
      sparse=sparse,
      delete_black_uploads=delete_black_uploads,
      background_color=background_color,
      compress=compress,
      downsample_method=downsample_method,
      num_mips=num_mips,
      factor=factor,
    )


class DeleteTask(RegisteredTask):
  """Delete the chunks covering a bbox at mip ... mip+num_mips."""

  def __init__(
    self,
    layer_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    num_mips: int = 0,
  ):
    self.layer_path = layer_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.num_mips = int(num_mips)

  def execute(self):
    vol = Volume(self.layer_path, mip=self.mip)
    bounds = Bbox.intersection(Bbox(self.offset, self.offset + self.shape), vol.bounds)
    if bounds.empty():
      return
    for mip in range(self.mip, min(self.mip + self.num_mips + 1, vol.meta.num_mips)):
      mip_bounds = vol.meta.bbox_to_mip(bounds, self.mip, mip)
      mip_bounds = mip_bounds.expand_to_chunk_size(
        vol.meta.chunk_size(mip), vol.meta.voxel_offset(mip)
      ).clamp(vol.meta.bounds(mip))
      vol.delete(mip_bounds, mip=mip)


class BlackoutTask(RegisteredTask):
  """Overwrite a bbox with a constant value."""

  def __init__(
    self,
    cloudpath: str,
    mip: int,
    shape: Sequence[int],
    offset: Sequence[int],
    value: int = 0,
    non_aligned_writes: bool = False,
  ):
    self.cloudpath = cloudpath
    self.mip = int(mip)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.value = value
    self.non_aligned_writes = non_aligned_writes

  def execute(self):
    vol = Volume(self.cloudpath, mip=self.mip, non_aligned_writes=self.non_aligned_writes)
    bounds = Bbox.intersection(Bbox(self.offset, self.offset + self.shape), vol.bounds)
    if bounds.empty():
      return
    img = np.full(
      tuple(int(v) for v in bounds.size3()) + (vol.num_channels,),
      self.value, dtype=vol.dtype,
    )
    vol.upload(bounds, img)


class TouchTask(RegisteredTask):
  """Read a bbox with ``fill_missing`` off: a missing or corrupt chunk
  raises."""

  def __init__(self, cloudpath: str, mip: int, shape: Sequence[int], offset: Sequence[int]):
    self.cloudpath = cloudpath
    self.mip = int(mip)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)

  def execute(self):
    vol = Volume(self.cloudpath, mip=self.mip, fill_missing=False)
    vol.download(Bbox.intersection(Bbox(self.offset, self.offset + self.shape), vol.bounds))


class QuantizeTask(RegisteredTask):
  """The first channel of a float affinity layer as uint8:
  ``clip(float32(x) * 255, 0, 255)``, truncated."""

  def __init__(
    self,
    source_layer_path: str,
    dest_layer_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    fill_missing: bool = False,
  ):
    self.source_layer_path = source_layer_path
    self.dest_layer_path = dest_layer_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.fill_missing = fill_missing

  def execute(self):
    src = Volume(self.source_layer_path, mip=self.mip, fill_missing=self.fill_missing)
    dest = Volume(self.dest_layer_path, mip=self.mip)
    bounds = Bbox.intersection(Bbox(self.offset, self.offset + self.shape), src.bounds)
    if bounds.empty():
      return
    image = src.download(bounds)[..., :1]
    image = np.clip(image.astype(np.float32) * 255.0, 0, 255).astype(np.uint8)
    dest.upload(bounds, image)
