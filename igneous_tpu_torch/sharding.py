"""Neuroglancer ``neuroglancer_uint64_sharded_v1`` shard codec and hash math.

The port's own copy of ``igneous_tpu/sharding.py``: the same hash, chunk
ids, shard files and parameter solvers, so a sharded layer written by
either package reads in the other. Host numpy on ids and bytes, no device
work: the hash stays in numpy's uint32/uint64 arithmetic, which torch's
unsigned tensors lack.

Format summary (Neuroglancer sharded spec):
  hashed = hash(chunk_id >> preshift_bits)
  minishard = hashed & (2^minishard_bits - 1)
  shard    = (hashed >> minishard_bits) & (2^shard_bits - 1)
  shard file "<hex shard, ceil(shard_bits/4) digits>.shard":
    [fixed index: 2^minishard_bits pairs of uint64le (start,end) byte
     offsets of each minishard index, relative to the END of this index]
    [chunk data ... minishard indexes ...]
  minishard index (after minishard_index_encoding): uint64le[3][n]:
    row0 chunk ids, delta-encoded;
    row1 start offsets: first relative to end of fixed index, each
         subsequent delta relative to the PREVIOUS CHUNK'S END;
    row2 chunk byte lengths (after data_encoding).
"""

from __future__ import annotations

import gzip as gzip_mod
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

U32 = np.uint32
U64 = np.uint64


# ---------------------------------------------------------------------------
# murmurhash3_x86_128 (low 64 bits) of a uint64 little-endian key, seed 0.
# Vectorized over numpy arrays.

_C1 = U32(0x239B961B)
_C2 = U32(0xAB0E9789)
_C3 = U32(0x38B34AE5)
_C4 = U32(0xA1E38B93)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
  return (x << U32(r)) | (x >> U32(32 - r))


def _fmix32(h: np.ndarray) -> np.ndarray:
  h = h ^ (h >> U32(16))
  h = h * U32(0x85EBCA6B)
  h = h ^ (h >> U32(13))
  h = h * U32(0xC2B2AE35)
  h = h ^ (h >> U32(16))
  return h


def murmurhash3_x86_128_low64(keys) -> np.ndarray:
  """Low 64 bits of MurmurHash3_x86_128(8-byte LE key, seed=0), vectorized."""
  keys = np.asarray(keys, dtype=U64)
  with np.errstate(over="ignore"):
    k1 = (keys & U64(0xFFFFFFFF)).astype(U32)  # bytes 0-3
    k2 = (keys >> U64(32)).astype(U32)  # bytes 4-7
    h1 = np.zeros_like(k1)
    h2 = np.zeros_like(k1)
    h3 = np.zeros_like(k1)
    h4 = np.zeros_like(k1)

    # tail processing for len=8: k2 then k1 (no body blocks)
    k2 = k2 * _C2
    k2 = _rotl32(k2, 16)
    k2 = k2 * _C3
    h2 = h2 ^ k2

    k1 = k1 * _C1
    k1 = _rotl32(k1, 15)
    k1 = k1 * _C2
    h1 = h1 ^ k1

    # finalization
    length = U32(8)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h3 = h3 ^ length
    h4 = h4 ^ length

    h1 = h1 + h2 + h3 + h4
    h2 = h2 + h1
    h3 = h3 + h1
    h4 = h4 + h1

    h1 = _fmix32(h1)
    h2 = _fmix32(h2)
    h3 = _fmix32(h3)
    h4 = _fmix32(h4)

    h1 = h1 + h2 + h3 + h4
    h2 = h2 + h1

    return h1.astype(U64) | (h2.astype(U64) << U64(32))


def _apply_hash(ids: np.ndarray, hashtype: str) -> np.ndarray:
  if hashtype == "identity":
    return np.asarray(ids, dtype=U64)
  if hashtype == "murmurhash3_x86_128":
    return murmurhash3_x86_128_low64(ids)
  raise ValueError(f"Unknown shard hash: {hashtype}")


# ---------------------------------------------------------------------------
# compressed morton code (image chunk ids)


def compressed_morton_code(
  gridpt: Sequence[int], grid_size: Sequence[int]
) -> Union[int, np.ndarray]:
  """Neuroglancer compressed morton code of grid coordinate(s).

  Interleaves bits x,y,z (x lowest) but only for dimensions that still have
  grid range left at that bit position."""
  gridpt = np.atleast_2d(np.asarray(gridpt, dtype=U64))
  grid_size = np.asarray(grid_size, dtype=np.int64)
  nbits = [max(int(np.ceil(np.log2(max(g, 1)))), 0) for g in grid_size]
  code = np.zeros(gridpt.shape[0], dtype=U64)
  out_bit = 0
  for j in range(max(nbits) if nbits else 0):
    for d in range(3):
      if j < nbits[d]:
        bit = (gridpt[:, d] >> U64(j)) & U64(1)
        code |= bit << U64(out_bit)
        out_bit += 1
  return code if code.size > 1 else int(code[0])


# ---------------------------------------------------------------------------
# specification


class ShardingSpecification:
  def __init__(
    self,
    type: str = "neuroglancer_uint64_sharded_v1",
    preshift_bits: int = 0,
    hash: str = "murmurhash3_x86_128",
    minishard_bits: int = 0,
    shard_bits: int = 0,
    minishard_index_encoding: str = "gzip",
    data_encoding: str = "gzip",
  ):
    if type != "neuroglancer_uint64_sharded_v1":
      raise ValueError(f"Unknown sharding type: {type}")
    self.type = type
    self.preshift_bits = int(preshift_bits)
    self.hash = hash
    self.minishard_bits = int(minishard_bits)
    self.shard_bits = int(shard_bits)
    self.minishard_index_encoding = minishard_index_encoding
    self.data_encoding = data_encoding

  @classmethod
  def from_dict(cls, d: dict) -> "ShardingSpecification":
    d = dict(d)
    d["type"] = d.pop("@type", "neuroglancer_uint64_sharded_v1")
    return cls(**d)

  def to_dict(self) -> dict:
    return {
      "@type": self.type,
      "preshift_bits": self.preshift_bits,
      "hash": self.hash,
      "minishard_bits": self.minishard_bits,
      "shard_bits": self.shard_bits,
      "minishard_index_encoding": self.minishard_index_encoding,
      "data_encoding": self.data_encoding,
    }

  # -- placement ------------------------------------------------------------

  def hashed(self, ids) -> np.ndarray:
    ids = np.asarray(ids, dtype=U64) >> U64(self.preshift_bits)
    return _apply_hash(ids, self.hash)

  def minishard_number(self, ids) -> np.ndarray:
    return self.hashed(ids) & U64((1 << self.minishard_bits) - 1)

  def shard_number(self, ids) -> np.ndarray:
    h = self.hashed(ids) >> U64(self.minishard_bits)
    return h & U64((1 << self.shard_bits) - 1)

  def shard_filename(self, shard_number: int) -> str:
    digits = max(1, int(np.ceil(self.shard_bits / 4)))
    return f"{int(shard_number):0{digits}x}.shard"

  def assign_labels_to_shards(self, labels) -> Dict[int, List[int]]:
    """label → shard grouping (shard-computer equivalent, vectorized)."""
    labels = np.asarray(labels, dtype=U64)
    shards = self.shard_number(labels)
    out: Dict[int, List[int]] = {}
    order = np.argsort(shards, kind="stable")
    for s, lbl in zip(shards[order].tolist(), labels[order].tolist()):
      out.setdefault(int(s), []).append(int(lbl))
    return out

  # -- encoding -------------------------------------------------------------

  def _encode(self, data: bytes, encoding: str) -> bytes:
    if encoding == "gzip":
      return gzip_mod.compress(data, compresslevel=6, mtime=0)
    return data

  def _decode(self, data: bytes, encoding: str) -> bytes:
    if encoding == "gzip":
      return gzip_mod.decompress(data)
    return data

  def synthesize_shard(
    self,
    chunks: Dict[int, bytes],
    preambles: Optional[Dict[int, bytes]] = None,
  ) -> bytes:
    """Build one shard file from {chunk_id: raw bytes}. All ids must map to
    the same shard number (not re-verified here).

    ``preambles``: optional per-id bytes written immediately BEFORE the
    indexed chunk content but excluded from its indexed byte range — the
    multires mesh layout, where fragment data precedes each label's
    manifest in the shard (requires data_encoding='raw')."""
    if preambles and self.data_encoding != "raw":
      raise ValueError("preambles require data_encoding='raw'")
    return self.assemble_shard(
      {cid: self.encode_chunk(data) for cid, data in chunks.items()}, preambles
    )

  def encode_chunk(self, data: bytes) -> bytes:
    """One chunk's bytes as the shard stores them (``data_encoding``)."""
    return self._encode(data, self.data_encoding)

  def assemble_shard(
    self,
    encoded: Dict[int, bytes],
    preambles: Optional[Dict[int, bytes]] = None,
  ) -> bytes:
    """The shard file of {chunk_id: ``encode_chunk`` bytes}. Entries are
    laid out by chunk id, so the bytes do not depend on the order in which
    the chunks were encoded."""
    n_minishards = 1 << self.minishard_bits
    buckets: Dict[int, List[Tuple[int, bytes]]] = {}
    for cid, data in encoded.items():
      ms = int(self.minishard_number(cid))
      buckets.setdefault(ms, []).append((int(cid), data))

    data_parts: List[bytes] = []
    data_pos = 0  # relative to end of fixed index
    msindex_blobs: List[Optional[bytes]] = [None] * n_minishards

    for ms in sorted(buckets):
      entries = sorted(buckets[ms])  # by chunk id
      ids = np.array([e[0] for e in entries], dtype=U64)
      raw = [e[1] for e in entries]
      sizes = np.array([len(r) for r in raw], dtype=U64)
      starts = np.zeros(len(raw), dtype=U64)
      pos = data_pos
      for i, (cid, _) in enumerate(entries):
        pre = preambles.get(cid, b"") if preambles else b""
        if pre:
          data_parts.append(pre)
          pos += len(pre)
        starts[i] = pos
        pos += len(raw[i])
        data_parts.append(raw[i])

      index = np.zeros((3, len(raw)), dtype=U64)
      index[0, 0] = ids[0]
      index[0, 1:] = np.diff(ids)
      # spec: first start is relative to the end of the fixed index;
      # subsequent starts are deltas relative to the previous chunk's END
      index[1, 0] = starts[0]
      if len(raw) > 1:
        prev_ends = starts[:-1] + sizes[:-1]
        index[1, 1:] = starts[1:] - prev_ends
      index[2, :] = sizes
      msindex_blobs[ms] = self._encode(
        index.tobytes(), self.minishard_index_encoding
      )
      data_pos = pos

    # minishard indexes follow the data section
    shard_index = np.zeros((n_minishards, 2), dtype=U64)
    pos = data_pos
    for ms in range(n_minishards):
      blob = msindex_blobs[ms]
      if blob is None:
        shard_index[ms] = (pos, pos)  # empty minishard
      else:
        shard_index[ms] = (pos, pos + len(blob))
        data_parts.append(blob)
        pos += len(blob)

    return shard_index.tobytes() + b"".join(data_parts)

  def synthesize_shard_files(
    self,
    chunks: Dict[int, bytes],
    preambles: Optional[Dict[int, bytes]] = None,
  ) -> Dict[str, bytes]:
    """Group {chunk_id: bytes} by shard and build every shard file."""
    ids = np.array(sorted(chunks.keys()), dtype=U64)
    if len(ids) == 0:
      return {}
    shard_nums = self.shard_number(ids)
    out = {}
    for s in np.unique(shard_nums):
      members = ids[shard_nums == s]
      out[self.shard_filename(int(s))] = self.synthesize_shard(
        {int(i): chunks[int(i)] for i in members},
        preambles=preambles,
      )
    return out


class ShardReader:
  """Random access into shard files via ranged reads."""

  def __init__(self, cf, spec: ShardingSpecification, prefix: str = ""):
    self.cf = cf
    self.spec = spec
    self.prefix = prefix.rstrip("/") + "/" if prefix else ""
    self._msindex_cache: Dict[Tuple[str, int], Optional[np.ndarray]] = {}
    self._fixed_cache: Dict[str, Optional[np.ndarray]] = {}

  def _shard_key(self, shard_number: int) -> str:
    return self.prefix + self.spec.shard_filename(shard_number)

  def _fixed_index(self, key: str) -> Optional[np.ndarray]:
    if key in self._fixed_cache:
      return self._fixed_cache[key]
    n = 1 << self.spec.minishard_bits
    raw = self.cf.get_range(key, 0, n * 16)
    result = None
    if raw is not None and len(raw) >= n * 16:
      result = np.frombuffer(raw, dtype=U64).reshape(n, 2)
    self._fixed_cache[key] = result
    return result

  def minishard_index(self, shard_number: int, minishard: int) -> Optional[np.ndarray]:
    key = self._shard_key(shard_number)
    cache_key = (key, minishard)
    if cache_key in self._msindex_cache:
      return self._msindex_cache[cache_key]
    fixed = self._fixed_index(key)
    result = None
    if fixed is not None:
      start, end = int(fixed[minishard, 0]), int(fixed[minishard, 1])
      if end > start:
        base = (1 << self.spec.minishard_bits) * 16
        raw = self.cf.get_range(key, base + start, end - start)
        if raw is not None:
          raw = self.spec._decode(raw, self.spec.minishard_index_encoding)
          arr = np.frombuffer(raw, dtype=U64).reshape(3, -1).copy()
          arr[0] = np.cumsum(arr[0])  # ids
          # starts: first relative to end of fixed index, then delta from
          # previous chunk end
          starts = arr[1].copy()
          sizes = arr[2]
          for i in range(1, len(starts)):
            starts[i] = starts[i - 1] + sizes[i - 1] + starts[i]
          arr[1] = starts
          result = arr
    self._msindex_cache[cache_key] = result
    return result

  def get_chunk(self, chunk_id: int) -> Optional[bytes]:
    spec = self.spec
    shard = int(spec.shard_number(chunk_id))
    ms = int(spec.minishard_number(chunk_id))
    index = self.minishard_index(shard, ms)
    if index is None:
      return None
    ids = index[0]
    pos = np.searchsorted(ids, U64(chunk_id))
    if pos >= len(ids) or ids[pos] != U64(chunk_id):
      return None
    base = (1 << spec.minishard_bits) * 16
    start = base + int(index[1, pos])
    length = int(index[2, pos])
    raw = self.cf.get_range(self._shard_key(shard), start, length)
    if raw is None:
      return None
    return spec._decode(raw, spec.data_encoding)

  def list_labels(self, shard_number: int) -> np.ndarray:
    """All chunk ids stored in one shard file."""
    out = []
    for ms in range(1 << self.spec.minishard_bits):
      index = self.minishard_index(shard_number, ms)
      if index is not None:
        out.append(index[0])
    if not out:
      return np.zeros(0, dtype=U64)
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# shard parameter solvers


def compute_shard_params_for_hashed(
  num_labels: int,
  shard_index_bytes: int = 8192,
  minishard_index_bytes: int = 40000,
  min_shards: int = 1,
) -> Tuple[int, int, int]:
  """(shard_bits, minishard_bits, preshift_bits) for hash-sharded label data
  (meshes/skeletons).

  Targets: fixed index ≤ shard_index_bytes (16 bytes/minishard), minishard
  index ≤ minishard_index_bytes (24 bytes/label), ≥ min_shards shards.
  preshift_bits stays 0 because hashed placement gains nothing from it.
  """
  if num_labels <= 0:
    return (0, 0, 0)

  max_minishard_bits = max(int(np.log2(max(shard_index_bytes // 16, 1))), 0)
  labels_per_minishard = max(minishard_index_bytes // 24, 1)

  total_minishards_needed = int(np.ceil(num_labels / labels_per_minishard))
  total_bits = max(int(np.ceil(np.log2(max(total_minishards_needed, 1)))), 0)

  minishard_bits = min(total_bits, max_minishard_bits)
  shard_bits = max(total_bits - minishard_bits, 0)
  min_shard_bits = max(int(np.ceil(np.log2(max(min_shards, 1)))), 0)
  shard_bits = max(shard_bits, min_shard_bits)
  return (shard_bits, minishard_bits, 0)


def create_sharded_image_info(
  dataset_size: Sequence[int],
  chunk_size: Sequence[int],
  encoding: str,
  dtype,
  uncompressed_shard_bytesize: int = int(3.5e9),
  max_shard_index_bytes: int = 8192,
  minishard_index_bytes: int = 40000,
  min_shards: int = 1,
  minishard_index_encoding: str = "gzip",
  data_encoding: "str | None" = None,
) -> dict:
  """Sharding spec dict for an image scale.

  Image chunk ids are compressed morton codes, so PRESHIFT bits group
  spatially-adjacent chunks into the same minishard; identity hash keeps
  that locality. The solver picks bits so one shard holds about
  uncompressed_shard_bytesize of voxel data with bounded index sizes.
  """
  dataset_size = np.asarray(dataset_size, dtype=np.int64)
  chunk_size = np.asarray(chunk_size, dtype=np.int64)
  grid_size = np.ceil(dataset_size / chunk_size).astype(np.int64)
  # morton code space is 2^ceil(log2(g)) per axis
  grid_bits = sum(max(int(np.ceil(np.log2(max(g, 1)))), 0) for g in grid_size)

  voxels_per_chunk = int(np.prod(chunk_size))
  byte_width = np.dtype(dtype).itemsize
  chunk_bytes = voxels_per_chunk * byte_width

  chunks_per_shard = max(int(uncompressed_shard_bytesize // chunk_bytes), 1)
  chunk_bits = max(int(np.floor(np.log2(chunks_per_shard))), 0)
  chunk_bits = min(chunk_bits, grid_bits)

  # split chunk_bits between preshift (spatial grouping inside a minishard)
  # and minishard bits, bounded by the index byte budgets
  max_minishard_bits = max(int(np.log2(max(max_shard_index_bytes // 16, 1))), 0)
  chunks_per_minishard_cap = max(minishard_index_bytes // 24, 1)
  preshift_cap = max(int(np.floor(np.log2(chunks_per_minishard_cap))), 0)

  preshift_bits = min(chunk_bits, preshift_cap)
  minishard_bits = min(chunk_bits - preshift_bits, max_minishard_bits)

  shard_bits = max(grid_bits - preshift_bits - minishard_bits, 0)
  min_shard_bits = max(int(np.ceil(np.log2(max(min_shards, 1)))), 0)
  shard_bits = max(shard_bits, min_shard_bits)

  return {
    "@type": "neuroglancer_uint64_sharded_v1",
    "preshift_bits": preshift_bits,
    "hash": "identity",
    "minishard_bits": minishard_bits,
    "shard_bits": shard_bits,
    "minishard_index_encoding": minishard_index_encoding,
    # gzip everything except codecs that are already entropy-coded;
    # callers may force a data_encoding (e.g. compress=False -> raw)
    "data_encoding": data_encoding or (
      "raw" if encoding in ("jpeg", "png", "jpegxl", "fpzip", "zfpc", "jxl")
      else "gzip"
    ),
  }


def image_shard_shape_from_spec(
  spec: Union[dict, ShardingSpecification],
  dataset_size: Sequence[int],
  chunk_size: Sequence[int],
) -> np.ndarray:
  """Spatial shape one shard file covers: distribute the
  preshift+minishard bits over x,y,z in morton order."""
  if isinstance(spec, ShardingSpecification):
    spec = spec.to_dict()
  chunk_size = np.asarray(chunk_size, dtype=np.int64)
  dataset_size = np.asarray(dataset_size, dtype=np.int64)
  grid_size = np.ceil(dataset_size / chunk_size).astype(np.int64)
  nbits = [max(int(np.ceil(np.log2(max(g, 1)))), 0) for g in grid_size]

  spatial_bits = int(spec["preshift_bits"]) + int(spec["minishard_bits"])
  axis_bits = [0, 0, 0]
  j = 0  # bit level
  consumed = 0
  while consumed < spatial_bits:
    progressed = False
    for d in range(3):
      if j < nbits[d]:
        if consumed < spatial_bits:
          axis_bits[d] += 1
          consumed += 1
        progressed = True
    if not progressed:
      break  # grid exhausted; shard covers everything
    j += 1

  shape = chunk_size * (2 ** np.asarray(axis_bits, dtype=np.int64))
  return shape
