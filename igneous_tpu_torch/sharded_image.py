"""Sharded-format image reads and writes (Neuroglancer sharded Precomputed).

The port's own copy of ``igneous_tpu/sharded_image.py``: chunk ids are
compressed morton codes of the chunk's grid coordinates, and shard
placement follows the scale's ``sharding`` spec (``sharding.py``). The
shard files are those of the JAX package byte for byte.

``upload_shard`` takes a sink (``pipeline.UploadTicket`` or
``SerialSink``), as ``Volume.upload`` does: each chunk's encode and
``data_encoding`` runs as its own job, and the job that finishes a shard's
last chunk assembles the shard and puts it. The shard is laid out by chunk
id, so its bytes do not depend on the order in which the chunks finish.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np

from . import chunk_cache, codecs
from .lib import Bbox
from .sharding import ShardReader, ShardingSpecification, compressed_morton_code


def _grid_geometry(vol, mip: int):
  meta = vol.meta
  cs = np.asarray(meta.chunk_size(mip), dtype=np.int64)
  offset = np.asarray(meta.voxel_offset(mip), dtype=np.int64)
  grid_size = np.ceil(
    np.asarray(meta.volume_size(mip), dtype=np.int64) / cs
  ).astype(np.int64)
  return cs, offset, grid_size


def chunk_morton_id(vol, chunk_bbx: Bbox, mip: int) -> int:
  cs, offset, grid_size = _grid_geometry(vol, mip)
  gridpt = (np.asarray(chunk_bbx.minpt) - offset) // cs
  return int(compressed_morton_code(gridpt, grid_size))


def download_sharded(vol, bbox: Bbox, mip: int) -> List[Tuple[Bbox, np.ndarray]]:
  """``Volume.download``'s reader of a sharded scale: [(stored chunk bbox,
  array), ...] covering ``bbox``, read on ``vol.parallel`` threads. The
  arrays are read-only (``Volume._decode``): the caller copies them."""
  from .volume import _io_map

  meta = vol.meta
  reader = ShardReader(
    vol.cf, ShardingSpecification.from_dict(meta.sharding(mip)), prefix=meta.key(mip)
  )

  def read(chunk_bbx):
    data = reader.get_chunk(chunk_morton_id(vol, chunk_bbx, mip))
    return chunk_bbx, vol._decode((data, None), chunk_bbx, mip)

  return _io_map(read, vol._chunks(bbox, mip), vol.parallel)


class _ShardAssembly:
  """The encoded chunks of one shard file, put once the last one is in."""

  def __init__(self, vol, key: str, spec: ShardingSpecification, mip: int, pending: int):
    self.vol = vol
    self.key = key
    self.spec = spec
    self.mip = mip
    self.pending = pending
    self.encoded: Dict[int, bytes] = {}
    self.lock = threading.Lock()

  def add(self, cid: int, data: bytes) -> None:
    with self.lock:
      self.encoded[cid] = data
      self.pending -= 1
      last = self.pending == 0
    if last:
      # shard files carry their own internal compression; never gzip the file
      self.vol.cf.put(self.key, self.spec.assemble_shard(self.encoded), compress=None)
      chunk_cache.invalidate(self.vol.cloudpath, self.mip)


def upload_shard(vol, bbox: Bbox, img: np.ndarray, mip: int, sink=None):
  """Write one task's worth of chunks as shard file(s).

  ``bbox`` must be shard-aligned (or clipped at the dataset boundary) so
  every chunk id belonging to each produced shard file is present:
  sharded files are immutable and written exactly once. ``sink`` takes
  the encode jobs (the caller joins it and leaves ``img`` unchanged until
  then); without one they run here, one after another."""
  from .pipeline import SerialSink

  sink = SerialSink() if sink is None else sink
  meta = vol.meta
  spec = ShardingSpecification.from_dict(meta.sharding(mip))
  if img.ndim == 3:
    img = img[..., np.newaxis]
  encoding, block_size, enc_kw = vol._codec_args(mip)

  jobs = []
  for chunk_bbx in vol._chunks(bbox, mip):
    if Bbox.intersection(chunk_bbx, bbox) != chunk_bbx:
      raise ValueError(
        f"shard upload bbox {bbox} does not fully cover chunk {chunk_bbx}"
      )
    sl = tuple(
      slice(int(a), int(b))
      for a, b in zip(chunk_bbx.minpt - bbox.minpt, chunk_bbx.maxpt - bbox.minpt)
    )
    jobs.append((chunk_morton_id(vol, chunk_bbx, mip), sl))
  if not jobs:
    return
  shard_of = spec.shard_number(np.array([cid for cid, _ in jobs], dtype=np.uint64))
  shard_of = np.atleast_1d(shard_of)
  assemblies = {}
  for s in np.unique(shard_of):
    assemblies[int(s)] = _ShardAssembly(
      vol, f"{meta.key(mip)}/{spec.shard_filename(int(s))}", spec, mip,
      int(np.count_nonzero(shard_of == s)),
    )

  def encode(cid, sl, assembly):
    chunk = codecs.encode(img[sl], encoding, block_size=block_size, **enc_kw)
    assembly.add(cid, spec.encode_chunk(chunk))

  for (cid, sl), s in zip(jobs, shard_of.tolist()):
    sink.submit(lambda cid=cid, sl=sl, a=assemblies[int(s)]: encode(cid, sl, a))
