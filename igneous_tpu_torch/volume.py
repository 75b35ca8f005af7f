"""Chunked Precomputed volume IO: the port's host data plane.

The port's own copy of the parts of ``igneous_tpu/volume.py`` that the
downsample, transfer, connected-components, meshing, skeleton, census
and inference paths use: ``from_numpy``, ``download`` (``bounded=False``
reads of boxes that reach past the bounds, background outside) and
``upload`` of bbox cutouts at a mip in any of the ported encodings
(``codecs.py``), and the info accessors.
Pure host numpy: the device work happens in
``igneous_tpu_torch.ops`` on arrays produced here. Chunk reads go
through the process-wide decode cache (``chunk_cache.py``), and uploads
invalidate it. Integrity manifests, sharded scales and graphene are not
ported yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from . import chunk_cache, codecs
from .lib import Bbox, chunk_bboxes
from .meta import PrecomputedMetadata
from .storage import decompress_bytes

IO_THREADS = 8


class VolumeException(Exception):
  pass


class OutOfBoundsError(VolumeException):
  pass


class AlignmentError(VolumeException):
  pass


class EmptyVolumeError(VolumeException):
  pass


def _io_map(fn, items, parallel: int):
  """``map`` over ``items``, on ``parallel`` threads when there are several
  (zlib and file IO release the interpreter lock)."""
  if parallel <= 1 or len(items) <= 1:
    return [fn(i) for i in items]
  with ThreadPoolExecutor(min(parallel, len(items))) as pool:
    return list(pool.map(fn, items))


class Volume:
  """A Precomputed volume rooted at ``cloudpath`` (file:// or mem://)."""

  def __init__(
    self,
    cloudpath: str,
    mip: int = 0,
    fill_missing: bool = False,
    bounded: bool = True,
    delete_black_uploads: bool = False,
    background_color: int = 0,
    info: Optional[dict] = None,
    parallel: int = IO_THREADS,
  ):
    self.meta = PrecomputedMetadata(cloudpath, info=info)
    self.cloudpath = self.meta.cloudpath
    self.cf = self.meta.cf
    self.mip = mip
    # False: downloads may reach past the bounds and read background there
    self.bounded = bounded
    self.fill_missing = fill_missing
    self.delete_black_uploads = delete_black_uploads
    self.background_color = background_color
    self.parallel = parallel

  # -- constructors ---------------------------------------------------------

  @classmethod
  def create(cls, cloudpath: str, info: dict, **kw) -> "Volume":
    meta = PrecomputedMetadata(cloudpath, info=info)
    meta.commit_info()
    meta.refresh_provenance()
    meta.commit_provenance()
    return cls(cloudpath, **kw)

  @classmethod
  def from_numpy(
    cls,
    arr: np.ndarray,
    cloudpath: str,
    resolution: Sequence[int] = (1, 1, 1),
    voxel_offset: Sequence[int] = (0, 0, 0),
    chunk_size: Sequence[int] = (64, 64, 64),
    layer_type: Optional[str] = None,
    encoding: str = "raw",
    compress="gzip",
  ) -> "Volume":
    if arr.ndim == 3:
      arr = arr[..., np.newaxis]
    if layer_type is None:
      layer_type = (
        "segmentation" if np.issubdtype(arr.dtype, np.unsignedinteger)
        and arr.dtype.itemsize >= 4 else "image"
      )
    info = PrecomputedMetadata.create_info(
      num_channels=arr.shape[3],
      layer_type=layer_type,
      data_type=np.dtype(arr.dtype).name,
      encoding=encoding,
      resolution=resolution,
      voxel_offset=voxel_offset,
      volume_size=arr.shape[:3],
      chunk_size=chunk_size,
    )
    vol = cls.create(cloudpath, info)
    vol.upload(vol.meta.bounds(0), arr, mip=0, compress=compress)
    return vol

  # -- properties -----------------------------------------------------------

  @property
  def info(self) -> dict:
    return self.meta.info

  @property
  def layer_type(self) -> str:
    return self.meta.layer_type

  @property
  def dtype(self) -> np.dtype:
    return self.meta.dtype

  @property
  def num_channels(self) -> int:
    return self.meta.num_channels

  @property
  def bounds(self) -> Bbox:
    return self.meta.bounds(self.mip)

  @property
  def resolution(self):
    return self.meta.resolution(self.mip)

  def mip_bounds(self, mip: int) -> Bbox:
    return self.meta.bounds(mip)

  def commit_info(self):
    self.meta.commit_info()

  # -- download -------------------------------------------------------------

  def _chunks(self, bbox: Bbox, mip: int):
    """Stored chunk extents covering ``bbox``: grid-aligned, clamped to the
    volume bounds."""
    bounds = self.meta.bounds(mip)
    chunks = (
      Bbox.intersection(gc, bounds)
      for gc in chunk_bboxes(
        bbox, self.meta.chunk_size(mip),
        offset=self.meta.voxel_offset(mip), clamp=False,
      )
    )
    return [c for c in chunks if not c.empty()]

  def _decode(self, stored, chunk_bbx: Bbox, mip: int) -> np.ndarray:
    """Decode a (stored bytes, compression) pair through the chunk decode
    cache; a hit skips both the inflate and the chunk codec. Read-only
    where the codec allows it: download copies the voxels."""
    data, method = stored
    shape = tuple(int(v) for v in chunk_bbx.size3()) + (self.num_channels,)
    if data is None:
      if not self.fill_missing:
        raise EmptyVolumeError(
          f"Missing chunk {self.meta.chunk_name(mip, chunk_bbx)} in {self.cloudpath}"
        )
      return np.full(shape, self.background_color, dtype=self.dtype)
    encoding = self.meta.encoding(mip)

    def decode():
      return codecs.decode(
        decompress_bytes(data, method), encoding, shape, self.dtype,
        block_size=self.meta.cseg_block_size(mip), writable=False,
      )

    # an uncompressed raw chunk decodes as a view of its bytes: caching it
    # would spend budget to save nothing
    if not chunk_cache.enabled() or (method is None and encoding == "raw"):
      return decode()
    bbox_key = (
      tuple(int(v) for v in chunk_bbx.minpt), tuple(int(v) for v in chunk_bbx.maxpt)
    )
    key, arr = chunk_cache.lookup(self.cloudpath, mip, bbox_key, data)
    if arr is not None:
      return arr
    # a chunk that fails to decode raises here, before it could be stored
    return chunk_cache.store(key, decode())

  def download(self, bbox: Bbox, mip: Optional[int] = None) -> np.ndarray:
    """The (x, y, z, c) cutout of ``bbox`` at ``mip``, Fortran-ordered: its
    (c, z, y, x) transpose is C-contiguous, the device layout. A bounded
    volume raises for a box past its bounds; an unbounded one fills the
    voxels outside them with ``background_color``."""
    mip = self.mip if mip is None else mip
    bbox = Bbox(bbox.minpt, bbox.maxpt)
    bounds = self.meta.bounds(mip)
    if self.bounded:
      if not bounds.contains_bbox(bbox):
        raise OutOfBoundsError(f"{bbox} is not contained in {bounds}")
      inner = bbox
    else:
      inner = Bbox.intersection(bbox, bounds)

    out_shape = tuple(int(v) for v in bbox.size3()) + (self.num_channels,)
    if inner == bbox:
      # the chunks cover every voxel: no background to write first
      out = np.empty(out_shape, dtype=self.dtype, order="F")
    else:
      out = np.full(out_shape, self.background_color, dtype=self.dtype, order="F")
    if inner.empty():
      return out

    def place(c):
      img = self._decode(self.cf.get_stored(self.meta.chunk_name(mip, c)), c, mip)
      isect = Bbox.intersection(c, bbox)
      dst = tuple(
        slice(int(a), int(b))
        for a, b in zip(isect.minpt - bbox.minpt, isect.maxpt - bbox.minpt)
      )
      src = tuple(
        slice(int(a), int(b))
        for a, b in zip(isect.minpt - c.minpt, isect.maxpt - c.minpt)
      )
      out[dst] = img[src]  # disjoint regions: threads never overlap

    _io_map(place, self._chunks(inner, mip), self.parallel)
    return out

  # -- upload ---------------------------------------------------------------

  def upload(
    self,
    bbox: Bbox,
    img: np.ndarray,
    mip: Optional[int] = None,
    compress: Optional[str] = "gzip",
    sink=None,
  ):
    """Write ``img`` (x, y, z[, c]) over ``bbox`` at ``mip``, one object per
    chunk. ``bbox`` must be chunk-aligned or clipped at the volume bounds.

    ``sink`` (``pipeline.UploadTicket`` or ``SerialSink``): when given,
    each chunk's encode and put is submitted to it instead of run here;
    the caller joins the sink before it treats the upload as durable and
    leaves ``img`` unchanged until then. The bytes are the same either
    way."""
    mip = self.mip if mip is None else mip
    if img.ndim == 3:
      img = img[..., np.newaxis]
    if tuple(img.shape[:3]) != tuple(int(v) for v in bbox.size3()):
      raise VolumeException(f"Image shape {img.shape} does not match bbox {bbox}")
    if img.shape[3] != self.num_channels:
      raise VolumeException(
        f"Image has {img.shape[3]} channels, volume has {self.num_channels}"
      )
    if img.dtype != self.dtype:
      if not np.can_cast(img.dtype, self.dtype, casting="same_kind"):
        raise VolumeException(
          f"Image dtype {img.dtype} is not compatible with volume dtype "
          f"{self.meta.data_type}; cast explicitly."
        )
      img = img.astype(self.dtype)
    bounds = self.meta.bounds(mip)
    if not bounds.contains_bbox(bbox):
      raise OutOfBoundsError(f"{bbox} exceeds bounds {bounds}")

    cs = self.meta.chunk_size(mip)
    offset = self.meta.voxel_offset(mip)
    expanded = bbox.expand_to_chunk_size(cs, offset)
    if Bbox.intersection(expanded, bounds) != bbox:
      raise AlignmentError(
        f"{bbox} is not chunk-aligned (chunk {list(map(int, cs))}, "
        f"offset {list(map(int, offset))}) nor clipped to bounds {bounds}"
      )

    encoding = self.meta.encoding(mip)
    block_size = self.meta.cseg_block_size(mip)
    # the scale's quality knob (meta.set_encoding)
    enc_kw = {}
    scale = self.meta.scale(mip)
    if encoding == "jpeg" and "jpeg_quality" in scale:
      enc_kw["jpeg_quality"] = int(scale["jpeg_quality"])
    elif encoding == "png" and "png_level" in scale:
      enc_kw["png_level"] = int(scale["png_level"])
    jobs, deletes = [], []
    for chunk_bbx in self._chunks(bbox, mip):
      src = tuple(
        slice(int(a), int(b))
        for a, b in zip(chunk_bbx.minpt - bbox.minpt, chunk_bbx.maxpt - bbox.minpt)
      )
      key = self.meta.chunk_name(mip, chunk_bbx)
      cutout = img[src]
      if self.delete_black_uploads and np.all(cutout == self.background_color):
        deletes.append(key)
        continue
      jobs.append((key, cutout))

    def put(job):
      key, cutout = job
      self.cf.put(
        key, codecs.encode(cutout, encoding, block_size=block_size, **enc_kw),
        compress=compress,
      )

    if sink is not None:
      for job in jobs:
        sink.submit(lambda job=job: put(job))
    else:
      _io_map(put, jobs, self.parallel)
    if deletes:
      self.cf.delete(deletes)
    # entries under this (path, mip) are doomed (the digest key already
    # keeps later reads right; this frees their memory now). Puts routed
    # through a sink may still be in flight: the pipeline runner
    # invalidates again when it joins the ticket.
    chunk_cache.invalidate(self.cloudpath, mip)

  def __repr__(self):
    return (
      f"Volume({self.cloudpath!r}, mip={self.mip}, "
      f"bounds={self.bounds}, dtype={self.meta.data_type})"
    )
