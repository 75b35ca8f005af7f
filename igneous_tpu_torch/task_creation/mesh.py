"""Mesh task factories.

The port's own copy of ``igneous_tpu/task_creation/mesh.py``: the forge
grid (``create_meshing_tasks``, legacy or sharded ``.frags``, Precomputed
or draco; a graphene layer meshes its L2 ids), the graphene forge grid
(``create_graphene_meshing_tasks``: draco ``.frags`` on the chunk graph's
grid), the legacy manifests, the three multires merges with their info
and shard planning, and the deletion and transfer fan-outs of
``@queueable`` functions. The same task grid, payloads, infos and
provenance.
"""

from __future__ import annotations

from functools import partial
from typing import Iterator, Optional, Sequence

import numpy as np

from ..lib import Bbox, Vec
from ..mesh_multires import multires_info
from ..sharding import ShardingSpecification, compute_shard_params_for_hashed
from ..spatial_index import SpatialIndex
from ..storage import CloudFiles
from ..tasks.mesh import (
  DeleteMeshFilesTask,
  MeshManifestPrefixTask,
  MeshTask,
  GrapheneMeshTask,
  TransferMeshFilesTask,
  check_options,
  mesh_dir_for,
)
from ..tasks.mesh_multires import (
  MultiResShardedFromUnshardedMeshMergeTask,
  MultiResShardedMeshMergeTask,
  MultiResUnshardedMeshMergeTask,
  legacy_manifest_labels,
)
from ..volume import Volume
from .common import GridTaskIterator, get_bounds, label_prefixes, operator_contact


def create_meshing_tasks(
  layer_path: str,
  mip: int = 0,
  shape: Sequence[int] = (448, 448, 448),
  simplification: bool = True,
  simplification_factor: int = 100,
  max_simplification_error: int = 40,
  mesh_dir: Optional[str] = None,
  dust_threshold: Optional[int] = None,
  dust_global: bool = False,
  object_ids: Optional[Sequence[int]] = None,
  exclude_object_ids: Optional[Sequence[int]] = None,
  remap_table: Optional[dict] = None,
  fill_missing: bool = False,
  encoding: str = "precomputed",
  spatial_index: bool = True,
  sharded: bool = False,
  bounds: Optional[Bbox] = None,
  closed_dataset_edges: bool = True,
  fill_holes: int = 0,
  mesher: str = "cubes",
  parallel: int = 1,
  compress: str = "gzip",
):
  """Stage-1 mesh forge grid; writes the mesh ``info`` and points the
  layer's ``info`` at it."""
  check_options(encoding, compress)
  vol = Volume(layer_path, mip=mip)
  if vol.layer_type != "segmentation":
    raise ValueError("Meshing requires a segmentation layer")

  if mesh_dir is None:
    mesh_dir = vol.info.get("mesh") or f"mesh_mip_{mip}_err_{max_simplification_error}"
  vol.info["mesh"] = mesh_dir
  mesh_info = {"@type": "neuroglancer_legacy_mesh", "mip": int(mip)}
  if spatial_index:
    res = [int(v) for v in vol.resolution]
    mesh_info["spatial_index"] = {
      "resolution": res,
      "chunk_size": [int(s * r) for s, r in zip(shape, res)],
    }
  vol.cf.put_json(f"{mesh_dir}/info", mesh_info)
  vol.commit_info()

  shape = Vec(*shape)
  task_bounds = get_bounds(
    vol, bounds, mip, mip, chunk_size=vol.meta.chunk_size(mip)
  )

  if not simplification:
    simplification_factor = 1

  def make_task(shape_: Vec, offset: Vec):
    return MeshTask(
      shape=shape_.tolist(),
      offset=offset.tolist(),
      layer_path=layer_path,
      mip=mip,
      simplification_factor=simplification_factor,
      max_simplification_error=max_simplification_error,
      mesh_dir=mesh_dir,
      dust_threshold=dust_threshold,
      dust_global=dust_global,
      object_ids=list(object_ids) if object_ids else None,
      exclude_object_ids=(
        list(exclude_object_ids) if exclude_object_ids else None
      ),
      remap_table=remap_table,
      fill_missing=fill_missing,
      encoding=encoding,
      spatial_index=spatial_index,
      sharded=sharded,
      closed_dataset_edges=closed_dataset_edges,
      fill_holes=fill_holes,
      mesher=mesher,
      parallel=parallel,
      compress=compress,
    )

  def finish():
    vol.meta.refresh_provenance()
    vol.meta.add_provenance_entry({
      "task": "MeshTask", "mip": mip, "shape": shape.tolist(),
      "mesh_dir": mesh_dir, "sharded": sharded,
      "simplification_factor": simplification_factor,
      "bounds": task_bounds.to_list(),
    }, operator_contact())
    vol.meta.commit_provenance()

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_mesh_manifest_tasks(
  layer_path: str,
  magnitude: int = 2,
  mesh_dir: Optional[str] = None,
) -> Iterator:
  """Stage-2 manifest tasks split by decimal label prefix
  (``label_prefixes``: exactly-once coverage, no dead tasks)."""
  for prefix in label_prefixes(magnitude):
    yield MeshManifestPrefixTask(
      layer_path=layer_path, prefix=prefix, mesh_dir=mesh_dir
    )


def configure_multires_info(
  cloudpath: str,
  mesh_dir: str,
  vertex_quantization_bits: int = 16,
  sharding: Optional[dict] = None,
  mip: int = 0,
) -> dict:
  """Write the multires mesh dir's info and point the layer at it (a
  bucket with no volume info keeps only the mesh info)."""
  info = multires_info(
    vertex_quantization_bits=vertex_quantization_bits,
    sharding=sharding,
    mip=mip,
  )
  CloudFiles(cloudpath).put_json(f"{mesh_dir}/info", info)
  try:
    vol = Volume(cloudpath)
    vol.info["mesh"] = mesh_dir
    vol.commit_info()
  except FileNotFoundError:
    pass  # mesh-only bucket: no volume info to update
  return info


def create_unsharded_multires_mesh_tasks(
  cloudpath: str,
  magnitude: int = 2,
  src_mesh_dir: Optional[str] = None,
  mesh_dir: Optional[str] = None,
  num_lods: int = 2,
  encoding: str = "draco",
  parallel: int = 1,
  vertex_quantization_bits: int = 16,
  min_chunk_size: Optional[Sequence[int]] = None,
  draco_compression_level: int = 7,
) -> Iterator:
  """Legacy fragments → unsharded multires, one task a label prefix."""
  vol = Volume(cloudpath)
  src = mesh_dir_for(vol, src_mesh_dir)  # raises if nothing is configured
  out = mesh_dir or f"{src}_multires"
  configure_multires_info(
    cloudpath, out, vertex_quantization_bits=vertex_quantization_bits,
  )
  for prefix in label_prefixes(magnitude):
    yield MultiResUnshardedMeshMergeTask(
      cloudpath=cloudpath,
      prefix=prefix,
      src_mesh_dir=src,
      mesh_dir=out,
      num_lods=num_lods,
      encoding=encoding,
      parallel=parallel,
      min_chunk_size=min_chunk_size,
      draco_compression_level=draco_compression_level,
    )


def _multires_shard_spec(
  num_labels: int,
  shard_index_bytes: int = 2**13,
  minishard_index_bytes: int = 2**15,
  min_shards: int = 1,
  max_labels_per_shard: Optional[int] = None,
  minishard_index_encoding: str = "gzip",
):
  if max_labels_per_shard and num_labels > 0:
    # bound the average shard population
    min_shards = max(
      min_shards, int(np.ceil(num_labels / max_labels_per_shard))
    )
  shard_bits, minishard_bits, preshift_bits = compute_shard_params_for_hashed(
    num_labels,
    shard_index_bytes=shard_index_bytes,
    minishard_index_bytes=minishard_index_bytes,
    min_shards=min_shards,
  )
  return ShardingSpecification(
    preshift_bits=preshift_bits,
    hash="murmurhash3_x86_128",
    minishard_bits=minishard_bits,
    shard_bits=shard_bits,
    # raw data: fragment ranges inside the shard are read by offset; the
    # multires fragment-before-manifest layout requires it
    minishard_index_encoding=minishard_index_encoding,
    data_encoding="raw",
  )


def create_sharded_multires_mesh_tasks(
  cloudpath: str,
  mesh_dir: Optional[str] = None,
  num_lods: int = 2,
  encoding: str = "draco",
  parallel: int = 1,
  vertex_quantization_bits: int = 16,
  min_chunk_size: Optional[Sequence[int]] = None,
  draco_compression_level: int = 7,
  shard_index_bytes: int = 2**13,
  minishard_index_bytes: int = 2**15,
  minishard_index_encoding: str = "gzip",
  min_shards: int = 1,
  max_labels_per_shard: Optional[int] = None,
  spatial_index_db: Optional[str] = None,
) -> Iterator:
  """Sharded stage-1 .frags → sharded multires: census labels via the
  spatial index (or a ``SpatialIndex.to_sqlite`` db), solve shard bits,
  write the info, one task per shard."""
  vol = Volume(cloudpath)
  mdir = mesh_dir_for(vol, mesh_dir)
  if spatial_index_db:
    labels = SpatialIndex.query_sqlite(spatial_index_db)
  else:
    labels = SpatialIndex(vol.cf, mdir).query()
  spec = _multires_shard_spec(
    len(labels),
    shard_index_bytes=shard_index_bytes,
    minishard_index_bytes=minishard_index_bytes,
    min_shards=min_shards,
    max_labels_per_shard=max_labels_per_shard,
    minishard_index_encoding=minishard_index_encoding,
  )
  configure_multires_info(
    cloudpath, mdir, sharding=spec.to_dict(),
    vertex_quantization_bits=vertex_quantization_bits,
  )

  for shard_no in range(2**spec.shard_bits):
    yield MultiResShardedMeshMergeTask(
      cloudpath=cloudpath,
      shard_no=shard_no,
      mesh_dir=mdir,
      num_lods=num_lods,
      encoding=encoding,
      parallel=parallel,
      min_chunk_size=min_chunk_size,
      draco_compression_level=draco_compression_level,
    )


def create_sharded_multires_mesh_from_unsharded_tasks(
  cloudpath: str,
  dest_cloudpath: Optional[str] = None,
  src_mesh_dir: Optional[str] = None,
  mesh_dir: Optional[str] = None,
  num_lods: int = 2,
  encoding: str = "draco",
  parallel: int = 1,
  vertex_quantization_bits: int = 16,
  min_chunk_size: Optional[Sequence[int]] = None,
  draco_compression_level: int = 7,
  shard_index_bytes: int = 2**13,
  minishard_index_bytes: int = 2**15,
  minishard_index_encoding: str = "gzip",
  min_shards: int = 1,
  max_labels_per_shard: Optional[int] = None,
) -> Iterator:
  """Legacy unsharded meshes → sharded multires. ``dest_cloudpath``
  writes the converted meshes into a different volume (the ``mesh xfer
  --sharded`` path)."""
  vol = Volume(cloudpath)
  src = mesh_dir_for(vol, src_mesh_dir)  # raises if nothing is configured
  out = mesh_dir or f"{src}_multires"
  labels = legacy_manifest_labels(vol.cf, src)
  spec = _multires_shard_spec(
    len(labels),
    shard_index_bytes=shard_index_bytes,
    minishard_index_bytes=minishard_index_bytes,
    min_shards=min_shards,
    max_labels_per_shard=max_labels_per_shard,
    minishard_index_encoding=minishard_index_encoding,
  )
  configure_multires_info(
    dest_cloudpath or cloudpath, out, sharding=spec.to_dict(),
    vertex_quantization_bits=vertex_quantization_bits,
  )

  for shard_no in range(2**spec.shard_bits):
    yield MultiResShardedFromUnshardedMeshMergeTask(
      cloudpath=cloudpath,
      shard_no=shard_no,
      src_mesh_dir=src,
      mesh_dir=out,
      num_lods=num_lods,
      encoding=encoding,
      parallel=parallel,
      min_chunk_size=min_chunk_size,
      draco_compression_level=draco_compression_level,
      dest_cloudpath=dest_cloudpath,
    )


def create_mesh_deletion_tasks(
  layer_path: str, magnitude: int = 1, mesh_dir: Optional[str] = None
):
  """One ``DeleteMeshFilesTask`` a decimal prefix of ``magnitude`` digits."""
  mdir = mesh_dir_for(Volume(layer_path), mesh_dir)
  for prefix in range(10**magnitude):
    yield partial(DeleteMeshFilesTask, layer_path, mdir, str(prefix))


def create_mesh_transfer_tasks(
  src_layer: str, dest_layer: str, mesh_dir: Optional[str] = None,
  magnitude: int = 1,
):
  """One ``TransferMeshFilesTask`` a decimal prefix; points the
  destination's info at the mesh dir."""
  mdir = mesh_dir_for(Volume(src_layer), mesh_dir)
  try:
    dest = Volume(dest_layer)
    dest.info["mesh"] = mdir
    dest.commit_info()
  except FileNotFoundError:
    pass  # mesh-only bucket: no info to update
  for prefix in range(10**magnitude):
    yield partial(TransferMeshFilesTask, src_layer, dest_layer, mdir, str(prefix))


def create_graphene_meshing_tasks(
  cloudpath: str,
  mip: int = 0,
  shape: Optional[Sequence[int]] = None,
  timestamp: Optional[float] = None,
  mesh_dir: Optional[str] = None,
  simplification: bool = True,
  simplification_factor: int = 100,
  max_simplification_error: int = 40,
  fill_missing: bool = False,
  bounds: Optional[Bbox] = None,
  object_ids: Optional[Sequence[int]] = None,
  draco_compression_level: int = 1,
):
  """Stage-1 graphene mesh forge: L2-granularity draco meshes in sharded
  .frags containers. The task shape defaults to twice the chunk graph's
  chunk size and must be a multiple of it, so every task covers whole L2
  chunks (their ids are per (root, chunk)).

  ``draco_compression_level`` is accepted and has no effect (the draco
  encoder is the fixed sequential method); ``simplification`` False
  disables the simplifier as in ``create_meshing_tasks``."""
  del draco_compression_level
  if not simplification:
    simplification_factor = 1

  vol = Volume(cloudpath, mip=mip)
  if vol.graphene is None:
    raise ValueError("create_graphene_meshing_tasks needs a graphene:// path")
  gcs = np.asarray(vol.graphene.chunk_size, dtype=np.int64)
  if shape is None:
    shape = tuple(int(c) * 2 for c in vol.graphene.chunk_size)
  if np.any(np.asarray(shape, dtype=np.int64) % gcs):
    raise ValueError(
      f"graphene mesh task shape {list(shape)} must be a multiple of the "
      f"chunk-graph chunk size {gcs.tolist()} so no L2 chunk straddles "
      "two tasks"
    )
  if mesh_dir is None:
    mesh_dir = vol.info.get("mesh") or "mesh_graphene"
  vol.info["mesh"] = mesh_dir
  res = [int(v) for v in vol.resolution]
  vol.cf.put_json(f"{mesh_dir}/info", {
    "@type": "neuroglancer_legacy_mesh", "mip": int(mip),
    "spatial_index": {
      "resolution": res,
      "chunk_size": [int(s * r) for s, r in zip(shape, res)],
    },
  })
  vol.commit_info()

  shape = Vec(*shape)
  task_bounds = get_bounds(
    vol, bounds, mip, mip, chunk_size=vol.meta.chunk_size(mip)
  )
  # align the task grid to the CHUNK-GRAPH chunk grid (absolute origin):
  # L2 ids are per graph chunk, so a task boundary inside a graph chunk
  # would split one L2 id's mesh across two tasks. Expanded bounds are
  # safe — tasks clamp their cores to the volume themselves.
  mn = (np.asarray(task_bounds.minpt) // gcs) * gcs
  mx = -(-np.asarray(task_bounds.maxpt) // gcs) * gcs
  task_bounds = Bbox(mn, mx)

  def make_task(shape_: Vec, offset: Vec):
    return GrapheneMeshTask(
      object_ids=list(object_ids) if object_ids else None,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      layer_path=cloudpath,
      mip=mip,
      simplification_factor=simplification_factor,
      max_simplification_error=max_simplification_error,
      mesh_dir=mesh_dir,
      fill_missing=fill_missing,
      timestamp=timestamp,
    )

  return GridTaskIterator(task_bounds, shape, make_task)
