"""Multi-resolution mesh merge tasks (stage 2, the LOD format).

The port's own copy of ``igneous_tpu/tasks/mesh_multires.py``:
``MultiResUnshardedMeshMergeTask`` (legacy fragments → a ``<label>.index``
manifest and a ``<label>`` fragment file per label),
``MultiResShardedMeshMergeTask`` (the sharded forge's ``.frags`` → one
multires shard file) and ``MultiResShardedFromUnshardedMeshMergeTask``
(legacy fragments → one shard file, in this layer or another). Every
label's mesh is fused, its LOD octree built by ``mesh_multires`` and its
fragments draco-encoded on the host, as in the JAX package; shards are
``data_encoding="raw"``, each label's fragments written immediately
before its manifest. The bytes are the JAX package's.

``draco_compression_level`` is recorded and has no effect (the draco
encoder is the fixed sequential method), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..queues.registry import RegisteredTask
from ..storage import CloudFiles
from ..volume import Volume
from ..mesh_io import FragMap, Mesh
from ..mesh_multires import process_mesh
from ..spatial_index import SpatialIndex
from .mesh import mesh_dir_for


def legacy_label_fragments(cf, src_dir: str, prefix: str = "") -> dict:
  """{label: [fragment filenames]} under ``src_dir`` discovered from the
  ``<label>:0:<bbox>`` fragment files themselves (no manifest pass is
  required between forge and a multires merge) plus any legacy
  ``<label>:0`` manifests."""
  out = {}
  for key in cf.list(f"{src_dir}/{prefix}"):
    name = key.split("/")[-1]
    parts = name.split(":")
    if len(parts) == 3 and parts[1] == "0":
      out.setdefault(int(parts[0]), set()).add(name)
    elif len(parts) == 2 and parts[1] == "0":
      out.setdefault(int(parts[0]), set())
  return {label: sorted(names) for label, names in out.items()}


def legacy_manifest_labels(cf, src_dir: str, prefix: str = "") -> list:
  """Labels present as legacy manifests OR raw fragment files."""
  return sorted(legacy_label_fragments(cf, src_dir, prefix).keys())


def _fetch_legacy_label_mesh(
  cf, src_dir: str, label: int, fragments=None,
) -> Optional[Mesh]:
  """Assemble one label's mesh from its fragment files (listed directly
  and/or via a legacy ``<label>:0`` manifest)."""
  names = set(fragments or [])
  manifest = cf.get_json(f"{src_dir}/{label}:0")
  if manifest is not None:
    names.update(manifest.get("fragments", []))
  pieces = []
  for frag in sorted(names):
    data = cf.get(f"{src_dir}/{frag}")
    if data is not None:
      pieces.append(Mesh.from_precomputed(data))
  if not pieces:
    return None
  return Mesh.concatenate(*pieces).consolidate()


def _map_labels(fn, labels, parallel: int):
  """Per-label merge work threaded across cores: every stage is numpy or
  a GIL-releasing ctypes call (the QEM collapse inside process_mesh), and
  results are keyed by label, so outputs are order-independent and
  byte-identical to the serial path."""
  labels = list(labels)
  if int(parallel) > 1 and len(labels) > 1:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=int(parallel)) as ex:
      return list(ex.map(fn, labels))
  return [fn(l) for l in labels]


def _multires_process_kw(vol, info, min_chunk_size):
  """Per-label process_mesh kwargs derived from the multires info:
  quantization bits from the info file; min_chunk_size (voxels) scaled to
  physical units by the info's mip resolution."""
  kw = {"quantization_bits": int(info.get("vertex_quantization_bits", 16))}
  if min_chunk_size is not None:
    res = np.asarray(vol.meta.resolution(int(info.get("mip", 0))))
    kw["min_chunk_size"] = (np.asarray(min_chunk_size) * res).tolist()
  return kw


class MultiResUnshardedMeshMergeTask(RegisteredTask):
  """Legacy fragments → unsharded multires: per label ``<label>.index``
  manifest + ``<label>`` fragment file."""

  def __init__(
    self,
    cloudpath: str,
    prefix: str,
    src_mesh_dir: Optional[str] = None,
    mesh_dir: Optional[str] = None,
    num_lods: int = 2,
    encoding: str = "draco",
    parallel: int = 1,
    min_chunk_size=None,
    draco_compression_level: int = 7,
  ):
    self.cloudpath = cloudpath
    self.prefix = str(prefix)
    self.src_mesh_dir = src_mesh_dir
    self.mesh_dir = mesh_dir
    self.num_lods = int(num_lods)
    self.encoding = encoding
    self.parallel = int(parallel)
    self.min_chunk_size = (
      [int(v) for v in min_chunk_size] if min_chunk_size else None
    )
    # recorded, no effect: the draco encoder is the sequential method
    self.draco_compression_level = int(draco_compression_level)

  def execute(self):
    vol = Volume(self.cloudpath)
    src_dir = self.src_mesh_dir or mesh_dir_for(vol, None)
    out_dir = self.mesh_dir or f"{src_dir}_multires"
    cf = CloudFiles(vol.cloudpath)
    info = cf.get_json(f"{out_dir}/info") or {}
    pkw = _multires_process_kw(vol, info, self.min_chunk_size)

    per_label = legacy_label_fragments(cf, src_dir, self.prefix)

    def one(label):
      # writes happen inside the worker: per-label outputs are
      # independent files, so streaming keeps peak memory at
      # O(parallel labels) instead of O(all labels)
      mesh = _fetch_legacy_label_mesh(
        cf, src_dir, label, fragments=per_label.get(label)
      )
      if mesh is None or len(mesh.faces) == 0:
        return None
      manifest, frags = process_mesh(
        mesh, num_lods=self.num_lods, encoding=self.encoding, **pkw
      )
      cf.put(f"{out_dir}/{label}.index", manifest)
      cf.put(f"{out_dir}/{label}", frags)
      return None

    _map_labels(one, sorted(per_label.keys()), self.parallel)


class MultiResShardedMeshMergeTask(RegisteredTask):
  """Sharded stage-1 ``.frags`` → one multires shard file: fetch each label's fragments via the spatial
  index, fuse, build the LOD octree, synthesize the shard with fragment
  data immediately preceding each manifest."""

  def __init__(
    self,
    cloudpath: str,
    shard_no: int,
    mesh_dir: Optional[str] = None,
    num_lods: int = 2,
    encoding: str = "draco",
    parallel: int = 1,
    min_chunk_size=None,
    draco_compression_level: int = 7,
  ):
    self.cloudpath = cloudpath
    self.shard_no = int(shard_no)
    self.mesh_dir = mesh_dir
    self.num_lods = int(num_lods)
    self.encoding = encoding
    self.parallel = int(parallel)
    self.min_chunk_size = (
      [int(v) for v in min_chunk_size] if min_chunk_size else None
    )
    self.draco_compression_level = int(draco_compression_level)

  def execute(self):
    from ..sharding import ShardingSpecification

    vol = Volume(self.cloudpath)
    mdir = mesh_dir_for(vol, self.mesh_dir)
    cf = CloudFiles(vol.cloudpath)
    info = cf.get_json(f"{mdir}/info") or {}
    spec = ShardingSpecification.from_dict(info["sharding"])
    pkw = _multires_process_kw(vol, info, self.min_chunk_size)

    si = SpatialIndex(cf, mdir)
    locations = si.file_locations_per_label()
    labels = np.array(sorted(locations.keys()), dtype=np.uint64)
    if len(labels) == 0:
      return
    mine = labels[spec.shard_number(labels) == self.shard_no]
    if len(mine) == 0:
      return

    needed = sorted({f for lbl in mine for f in locations[int(lbl)]})
    # concurrent container fetches; the sorted key order is kept, and it
    # is the order of each label's pieces
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as ex:
      datas = list(ex.map(
        lambda k: cf.get(k.replace(".spatial", ".frags")), needed
      ))
    fragmaps = [FragMap.frombytes(d) for d in datas if d is not None]

    def one(label):
      pieces = []
      for fm in fragmaps:
        blob = fm.get(label)
        if blob is not None:
          pieces.append(Mesh.from_precomputed(blob))
      if not pieces:
        return None
      mesh = Mesh.concatenate(*pieces).consolidate()
      if len(mesh.faces) == 0:
        return None
      manifest, frags = process_mesh(
        mesh, num_lods=self.num_lods, encoding=self.encoding, **pkw
      )
      return int(label), manifest, frags

    manifests = {}
    preambles = {}
    for item in _map_labels(one, mine.tolist(), self.parallel):
      if item is None:
        continue
      label, manifest, frags = item
      manifests[label] = manifest
      preambles[label] = frags

    if manifests:
      files = spec.synthesize_shard_files(manifests, preambles=preambles)
      for filename, data in files.items():
        cf.put(f"{mdir}/{filename}", data, compress=None)


class MultiResShardedFromUnshardedMeshMergeTask(RegisteredTask):
  """Legacy unsharded meshes → one multires shard. ``dest_cloudpath``
  writes the shard into a different volume (the ``mesh xfer --sharded``
  conversion path)."""

  def __init__(
    self,
    cloudpath: str,
    shard_no: int,
    src_mesh_dir: str,
    mesh_dir: str,
    num_lods: int = 2,
    encoding: str = "draco",
    parallel: int = 1,
    min_chunk_size=None,
    draco_compression_level: int = 7,
    dest_cloudpath: Optional[str] = None,
  ):
    self.cloudpath = cloudpath
    self.shard_no = int(shard_no)
    self.src_mesh_dir = src_mesh_dir
    self.mesh_dir = mesh_dir
    self.num_lods = int(num_lods)
    self.encoding = encoding
    self.parallel = int(parallel)
    self.min_chunk_size = (
      [int(v) for v in min_chunk_size] if min_chunk_size else None
    )
    self.draco_compression_level = int(draco_compression_level)
    self.dest_cloudpath = dest_cloudpath

  def execute(self):
    from ..sharding import ShardingSpecification

    vol = Volume(self.cloudpath)
    cf = CloudFiles(vol.cloudpath)
    out_cf = CloudFiles(self.dest_cloudpath or self.cloudpath)
    info = out_cf.get_json(f"{self.mesh_dir}/info") or {}
    spec = ShardingSpecification.from_dict(info["sharding"])
    pkw = _multires_process_kw(vol, info, self.min_chunk_size)

    per_label = legacy_label_fragments(cf, self.src_mesh_dir)
    labels = np.array(sorted(per_label.keys()), dtype=np.uint64)
    if len(labels) == 0:
      return
    mine = labels[spec.shard_number(labels) == self.shard_no]

    def one(label):
      mesh = _fetch_legacy_label_mesh(
        cf, self.src_mesh_dir, label, fragments=per_label.get(int(label))
      )
      if mesh is None or len(mesh.faces) == 0:
        return None
      manifest, frags = process_mesh(
        mesh, num_lods=self.num_lods, encoding=self.encoding, **pkw
      )
      return int(label), manifest, frags

    manifests = {}
    preambles = {}
    for item in _map_labels(one, mine.tolist(), self.parallel):
      if item is None:
        continue
      label, manifest, frags = item
      manifests[label] = manifest
      preambles[label] = frags

    if manifests:
      files = spec.synthesize_shard_files(manifests, preambles=preambles)
      for filename, data in files.items():
        out_cf.put(f"{self.mesh_dir}/{filename}", data, compress=None)
