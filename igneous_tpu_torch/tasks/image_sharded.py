"""Sharded image tasks: ``ImageShardTransferTask`` and
``ImageShardDownsampleTask``.

Counterpart of ``igneous_tpu/tasks/image_sharded.py``: the same
constructor signatures (so payloads of either package run in the other)
and the same shard files. One task produces complete shard files, which
are immutable, so the factories' task grid is shard aligned. A downsample
task's pyramid is ``ops.pooling.downsample_auto`` on the card: the fused
``pyramid2x2x1`` over the leading run of 2x2x1 factors.

Neither class is a ``TransferTask``: the lease batcher groups those, and
a sharded task runs solo in a worker's round, as in the JAX package.
From a graphene source, ``agglomerate`` (with ``timestamp``) and
``stop_layer`` map the downloaded supervoxels on the device in the
compute stage (``Volume.map_ids``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import telemetry
from ..lib import Bbox, Vec
from ..ops import pooling
from ..pipeline import SerialSink, StagePlan
from ..queues.registry import RegisteredTask
from ..sharded_image import upload_shard
from ..volume import Volume

# shard-aligned empty cutouts stage as no-ops
_NOOP_PLAN = StagePlan(lambda: None, lambda p: None, lambda o, s: None)


def _download(vol: Volume, bounds: Bbox):
  with telemetry.stage("download"):
    return vol.download(bounds)


def _nbytes(vol: Volume, bounds: Bbox) -> int:
  voxels = int(np.prod([int(v) for v in bounds.size3()]))
  return voxels * vol.dtype.itemsize * vol.num_channels


class ImageShardTransferTask(RegisteredTask):
  """Copy a shard-aligned cutout into a sharded destination scale."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    fill_missing: bool = False,
    translate: Sequence[int] = (0, 0, 0),
    agglomerate: bool = False,
    timestamp=None,
    stop_layer=None,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.fill_missing = fill_missing
    self.translate = Vec(*translate)
    self.agglomerate = bool(agglomerate)
    self.timestamp = timestamp
    self.stop_layer = stop_layer

  def trace_attrs(self) -> dict:
    """Task-span attributes for ``fleet top|trace``: which cutout this
    was, as the JAX package names it."""
    return {
      "dest": self.dest_path,
      "mip": self.mip,
      "bbox": f"{tuple(self.offset)}+{tuple(self.shape)}",
    }

  def execute(self):
    plan = self.stage_plan()
    plan.upload(plan.compute(plan.download()), SerialSink())

  def stage_plan(self) -> StagePlan:
    """Download the cutout; encode its chunks on the sink and put each
    shard file once its last chunk is encoded (``upload_shard``)."""
    src = Volume(self.src_path, mip=self.mip, fill_missing=self.fill_missing)
    dest = Volume(self.dest_path, mip=self.mip)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), src.bounds
    )
    if bounds.empty():
      return _NOOP_PLAN

    def compute(img):
      return src.map_ids(
        img, bounds, self.mip, self.agglomerate, self.timestamp, self.stop_layer,
      )

    def upload(img, sink):
      upload_shard(dest, bounds.translate(self.translate), img, self.mip, sink=sink)

    return StagePlan(
      lambda: _download(src, bounds), compute, upload,
      reads={(self.src_path, self.mip)},
      writes={(self.dest_path, self.mip)},
      nbytes_hint=_nbytes(dest, bounds),
      # each shard file is written once, by the task that owns its
      # shard-aligned bbox: no read-modify-write, so writers of the same
      # (path, mip) may overlap in the pipeline
      aligned_writes=True,
    )


class ImageShardDownsampleTask(RegisteredTask):
  """Downsample a shard-aligned region of ``mip`` into sharded scales
  mip+1 ... mip+num_mips. The task bbox (source-mip coordinates) covers
  whole destination shards at every produced mip, or their remainders at
  the dataset's edge."""

  def __init__(
    self,
    src_path: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    fill_missing: bool = False,
    sparse: bool = False,
    factor: Sequence[int] = (2, 2, 1),
    downsample_method: str = "auto",
    num_mips: int = 1,
    agglomerate: bool = False,
    timestamp=None,
  ):
    self.src_path = src_path
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.fill_missing = fill_missing
    self.sparse = sparse
    self.factor = Vec(*factor)
    self.downsample_method = downsample_method
    self.num_mips = int(num_mips)
    self.agglomerate = bool(agglomerate)
    self.timestamp = timestamp

  def trace_attrs(self) -> dict:
    """Task-span attributes for ``fleet top|trace``: which cutout this
    was, as the JAX package names it."""
    return {
      "dest": self.src_path,  # a sharded downsample writes back to its source
      "mip": self.mip,
      "bbox": f"{tuple(self.offset)}+{tuple(self.shape)}",
    }

  def execute(self):
    plan = self.stage_plan()
    plan.upload(plan.compute(plan.download()), SerialSink())

  def stage_plan(self) -> StagePlan:
    vol = Volume(self.src_path, mip=self.mip, fill_missing=self.fill_missing)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), vol.bounds
    )
    if bounds.empty():
      return _NOOP_PLAN
    factor = tuple(int(v) for v in self.factor)
    cum = np.ones(3, dtype=np.int64)
    dest_mips = []
    for _ in range(self.num_mips):
      cum *= np.asarray(factor, dtype=np.int64)
      # each destination scale by its resolution, not its position:
      # add_scale keeps the scales sorted, so mip+i need not be it
      dest_res = np.asarray(vol.meta.resolution(self.mip)) * cum
      dest_mips.append((vol.meta.mip_from_resolution(dest_res), cum.copy()))

    def compute(img):
      img = vol.map_ids(img, bounds, self.mip, self.agglomerate, self.timestamp)
      method = pooling.method_for_layer(vol.layer_type, self.downsample_method)
      return pooling.downsample_auto(
        img, factor, self.num_mips, method=method, sparse=self.sparse,
      )

    def upload(mips_out, sink):
      for mipped, (dest_mip, cumf) in zip(mips_out, dest_mips):
        dest_min = bounds.minpt // Vec(*cumf)
        dest_bounds = Bbox(dest_min, dest_min + Vec(*mipped.shape[:3]))
        dest_bounds = Bbox.intersection(dest_bounds, vol.meta.bounds(dest_mip))
        sl = tuple(slice(0, int(s)) for s in dest_bounds.size3())
        upload_shard(vol, dest_bounds, mipped[sl], dest_mip, sink=sink)

    return StagePlan(
      lambda: _download(vol, bounds), compute, upload,
      reads={(self.src_path, self.mip)},
      writes={(self.src_path, m) for m, _ in dest_mips},
      nbytes_hint=_nbytes(vol, bounds),
      aligned_writes=True,  # write-once shard files, as above
    )
