"""Chunked Precomputed volume IO: the port's host data plane.

The port's own copy of the parts of ``igneous_tpu/volume.py`` that the
ported paths use: ``from_numpy``, ``download`` (``bounded=False`` reads
of boxes that reach past the bounds, background outside; a sharded scale
reads through ``sharded_image.download_sharded``), ``upload`` of bbox
cutouts at a mip in any of the ported encodings (``codecs.py``; partial
chunks read-modify-written with ``non_aligned_writes``; a sharded scale
refuses direct writes), ``exists``, ``delete`` and the info accessors.
Pure host numpy: the device work happens in
``igneous_tpu_torch.ops`` on arrays produced here. Chunk reads go
through the process-wide decode cache (``chunk_cache.py``), and uploads
and deletes invalidate it. A chunk that fails to inflate or decode raises
``integrity.CorruptChunkError``, ticks ``integrity.corrupt_reads`` and is
quarantined, and never reaches the cache.

A ``graphene://`` path reads its watershed (supervoxel) layer: the inner
path, or the ``data_dir`` a PyChunkGraph server publishes. ``download``
then takes ``agglomerate`` (proofread root ids as of ``timestamp``) and
``stop_layer`` (1: the supervoxels as uint64; 2: L2 chunk-graph ids),
with the JAX package's ``ValueError`` on a plain volume or another stop
layer. The per-voxel work (the unique ids and their inverse, the voxel
chunk index, the gathers back) runs on the port's device
(``ops.graphene_ids``); the client's lookups see unique ids only.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from . import chunk_cache, codecs, integrity, telemetry
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
  """A Precomputed volume rooted at ``cloudpath`` (any ``storage`` protocol)."""

  def __init__(
    self,
    cloudpath: str,
    mip: int = 0,
    fill_missing: bool = False,
    bounded: bool = True,
    non_aligned_writes: bool = False,
    delete_black_uploads: bool = False,
    background_color: int = 0,
    info: Optional[dict] = None,
    parallel: int = IO_THREADS,
  ):
    from .graphene import graphene_client, is_graphene, watershed_path

    self.graphene = None
    if is_graphene(cloudpath):
      # chunks and metadata come from the watershed layer; the client maps
      # supervoxels to roots and L2 ids on download
      self.graphene = graphene_client(cloudpath)
      cloudpath = getattr(self.graphene, "data_dir", None) or watershed_path(cloudpath)
    self.meta = PrecomputedMetadata(cloudpath, info=info)
    self.cloudpath = self.meta.cloudpath
    self.cf = self.meta.cf
    self.mip = mip
    # False: downloads may reach past the bounds and read background there
    self.bounded = bounded
    # True: uploads may cover chunks partially (read-modify-write)
    self.non_aligned_writes = non_aligned_writes
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
    encoding_level: Optional[int] = None,
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
    if encoding_level is not None:
      # before the upload: the quality knob lives in the scale
      vol.meta.set_encoding(0, None, encoding_level)
      vol.commit_info()
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
      try:
        return codecs.decode(
          decompress_bytes(data, method), encoding, shape, self.dtype,
          block_size=self.meta.cseg_block_size(mip), writable=False,
        )
      except (OSError, EOFError, ValueError, zlib.error) as e:
        # a torn or bit-flipped object: typed, counted and quarantined
        key = self.meta.chunk_name(mip, chunk_bbx)
        telemetry.incr("integrity.corrupt_reads", 1)
        reason = f"{type(e).__name__}: {e}"
        integrity.quarantine(self.cloudpath, key, reason)
        raise integrity.CorruptChunkError(self.cloudpath, key, reason) from e

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
    # a corrupt chunk raises here, before it could be stored
    return chunk_cache.store(key, decode())

  def download(
    self, bbox: Bbox, mip: Optional[int] = None, agglomerate: bool = False,
    timestamp: Optional[float] = None, stop_layer: Optional[int] = None,
  ) -> np.ndarray:
    """The (x, y, z, c) cutout of ``bbox`` at ``mip``, Fortran-ordered: its
    (c, z, y, x) transpose is C-contiguous, the device layout. A bounded
    volume raises for a box past its bounds; an unbounded one fills the
    voxels outside them with ``background_color``. On a graphene volume,
    ``agglomerate`` and ``stop_layer`` map the supervoxels (uint64 out)."""
    if (agglomerate or stop_layer is not None) and self.graphene is None:
      raise ValueError(
        "agglomerate/stop_layer require a graphene:// volume"
      )
    if stop_layer not in (None, 1, 2):
      # argument validation: reject before any chunk is fetched
      raise ValueError(
        f"stop_layer={stop_layer!r} unsupported: 1 (supervoxels) and "
        "2 (L2 chunk ids) are the graphene stop layers"
      )
    return self.map_ids(
      self._download(bbox, mip), bbox, mip, agglomerate, timestamp, stop_layer,
    )

  def map_ids(
    self, cutout: np.ndarray, bbox: Bbox, mip: Optional[int] = None,
    agglomerate: bool = False, timestamp: Optional[float] = None,
    stop_layer: Optional[int] = None,
  ) -> np.ndarray:
    """A downloaded supervoxel ``cutout`` of ``bbox`` at ``mip`` mapped as
    ``download(agglomerate=, timestamp=, stop_layer=)`` maps it: (x, y,
    z, 1) uint64, root and L2 ids never narrowed to the layer's dtype. The
    per-voxel work runs on the port's device; the client looks up unique
    ids (a transfer calls this on its compute stage, not on the prefetch
    thread that downloaded the cutout)."""
    if not (agglomerate or stop_layer is not None):
      return cutout
    if self.graphene is None:
      raise ValueError("agglomerate/stop_layer require a graphene:// volume")
    from .ops import graphene_ids

    mip = self.mip if mip is None else mip
    sv = cutout[..., 0]
    with telemetry.stage("graphene"):
      if stop_layer == 2:
        # graph chunks are defined at the watershed base resolution
        mapped = graphene_ids.l2_ids_on_device(
          self.graphene, sv, bbox.minpt, self.graphene.chunk_size,
          scale=self.meta.downsample_ratio(mip), timestamp=timestamp,
        )
      elif stop_layer == 1:
        mapped = sv.astype(np.uint64)  # the supervoxels: no lookup
      else:
        mapped = graphene_ids.roots_on_device(self.graphene, sv, timestamp)
    return mapped[..., np.newaxis]

  def _download(self, bbox: Bbox, mip: Optional[int] = None) -> np.ndarray:
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

    def place(c, img):
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

    if self.meta.is_sharded(mip):
      from .sharded_image import download_sharded

      for c, img in download_sharded(self, inner, mip):
        place(c, img)
      return out

    def fetch(c):
      place(c, self._decode(self.cf.get_stored(self.meta.chunk_name(mip, c)), c, mip))

    _io_map(fetch, self._chunks(inner, mip), self.parallel)
    return out

  def exists(self, bbox: Bbox, mip: Optional[int] = None) -> dict:
    """Chunk key -> whether it is stored, for the chunks covering ``bbox``."""
    mip = self.mip if mip is None else mip
    keys = [self.meta.chunk_name(mip, c) for c in self._chunks(bbox, mip)]
    return {key: self.cf.exists(key) for key in keys}

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
    if Bbox.intersection(expanded, bounds) != bbox and not self.non_aligned_writes:
      raise AlignmentError(
        f"{bbox} is not chunk-aligned (chunk {list(map(int, cs))}, "
        f"offset {list(map(int, offset))}) nor clipped to bounds {bounds}"
      )
    if self.meta.is_sharded(mip):
      raise VolumeException(
        "Direct writes to sharded scales are not supported; "
        "use ImageShardTransferTask / make_shard."
      )

    encoding, block_size, enc_kw = self._codec_args(mip)
    jobs, deletes = [], []
    for chunk_bbx in self._chunks(bbox, mip):
      isect = Bbox.intersection(chunk_bbx, bbox)
      src = tuple(
        slice(int(a), int(b))
        for a, b in zip(isect.minpt - bbox.minpt, isect.maxpt - bbox.minpt)
      )
      key = self.meta.chunk_name(mip, chunk_bbx)
      if isect == chunk_bbx:
        cutout = img[src]
      else:
        # a partial chunk: read-modify-write it, so that the stored file
        # keeps its canonical key and the voxels outside bbox survive
        shape = tuple(int(v) for v in chunk_bbx.size3()) + (self.num_channels,)
        data = self.cf.get(key)
        if data is None:
          cutout = np.full(shape, self.background_color, dtype=self.dtype)
        else:
          cutout = codecs.decode(data, encoding, shape, self.dtype, block_size=block_size)
        cutout[tuple(
          slice(int(a), int(b))
          for a, b in zip(isect.minpt - chunk_bbx.minpt, isect.maxpt - chunk_bbx.minpt)
        )] = img[src]
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

  def _codec_args(self, mip: int):
    """(encoding, cseg block size, codec keywords) of a scale's chunk
    writes: the quality knob recorded by ``meta.set_encoding``."""
    encoding = self.meta.encoding(mip)
    enc_kw = {}
    scale = self.meta.scale(mip)
    if encoding == "jpeg" and "jpeg_quality" in scale:
      enc_kw["jpeg_quality"] = int(scale["jpeg_quality"])
    elif encoding == "png" and "png_level" in scale:
      enc_kw["png_level"] = int(scale["png_level"])
    return encoding, self.meta.cseg_block_size(mip), enc_kw

  # -- deletion -------------------------------------------------------------

  def delete(self, bbox: Bbox, mip: Optional[int] = None):
    """Delete every chunk file covering ``bbox``, which must be chunk
    aligned (or clipped at the bounds)."""
    mip = self.mip if mip is None else mip
    cs = self.meta.chunk_size(mip)
    offset = self.meta.voxel_offset(mip)
    if bbox != bbox.expand_to_chunk_size(cs, offset).clamp(self.meta.bounds(mip)):
      raise AlignmentError(f"delete bbox {bbox} must be chunk aligned")
    self.cf.delete([
      self.meta.chunk_name(mip, c) for c in chunk_bboxes(bbox, cs, offset=offset)
    ])
    chunk_cache.invalidate(self.cloudpath, mip)

  def __repr__(self):
    return (
      f"Volume({self.cloudpath!r}, mip={self.mip}, "
      f"bounds={self.bounds}, dtype={self.meta.data_type})"
    )
