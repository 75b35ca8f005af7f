"""Image tasks: transfer and downsample.

Counterpart of ``igneous_tpu/tasks/image.py``: the same constructor
signatures (so payloads serialized by the JAX package run here), the same
pyramid schedule and the same uploads. A transfer decodes its cutout,
re-encodes it in the destination's encoding and chunking (at a translated
offset if asked), and builds its mip pyramid on the port's device with
``ops.pooling.downsample_auto``. The compressed-domain passthrough (which
moves stored chunks without decoding them), the staged pipeline and
graphene (agglomerate / timestamp / stop_layer) are not ported yet: every
transfer here decodes and re-encodes, with the bytes of the JAX package's
decode route.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import telemetry
from ..downsample_scales import DEFAULT_FACTOR, compute_factors, truncate_writable_factors
from ..lib import Bbox, Vec
from ..ops import pooling
from ..queues.registry import RegisteredTask
from ..volume import Volume


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
):
  """Build the mip pyramid of one cutout on the device and upload every
  level. ``image`` covers ``bounds`` at ``mip``."""
  factors = _resolve_factors(vol, mip, task_shape, num_mips, factor)
  if not factors:
    return
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
        mip=dest_mip, compress=compress,
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
    if agglomerate or stop_layer is not None or timestamp is not None:
      raise NotImplementedError(
        "graphene transfers (agglomerate/timestamp/stop_layer) are not "
        "ported to igneous_tpu_torch"
      )
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

  def execute(self):
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
    if bounds.empty():
      return
    dest_bounds = Bbox(bounds.minpt + self.translate, bounds.maxpt + self.translate)
    with telemetry.stage("download"):
      image = src.download(bounds)
    if not self.skip_first:
      with telemetry.stage("upload"):
        dest.upload(dest_bounds, image, compress=self.compress)
    if not self.skip_downsamples:
      downsample_and_upload(
        image, dest_bounds, dest,
        task_shape=self.shape, mip=self.mip, num_mips=self.num_mips,
        factor=self.factor, sparse=self.sparse,
        method=self.downsample_method, compress=self.compress,
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
