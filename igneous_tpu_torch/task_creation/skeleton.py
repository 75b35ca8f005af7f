"""Skeleton task factories.

The port's own copy of ``igneous_tpu/task_creation/skeleton.py``: the
forge grid (legacy or sharded ``.frags``), the unsharded and sharded
merges (the shard spec solved from the spatial index's labels, or a
``SpatialIndex.to_sqlite`` db), the re-pack of finished skeletons into
shards, and the deletion and transfer fan-outs of ``@queueable``
functions. The same task grid, payloads, skeleton ``info``
(``vertex_attributes``, with ``cross_sectional_area`` when asked for;
``spatial_index``, ``sharding``) and provenance; ``fix_autapses`` on a
layer that is not graphene raises ``ValueError`` before anything is
written.
"""

from __future__ import annotations

from functools import partial
from typing import Iterator, Optional, Sequence

import numpy as np

from ..lib import Bbox, Vec
from ..sharding import ShardingSpecification, compute_shard_params_for_hashed
from ..skeleton_io import DEFAULT_ATTRIBUTES
from ..spatial_index import SpatialIndex
from ..storage import CloudFiles
from ..tasks.skeleton import (
  DeleteSkeletonFilesTask,
  ShardedFromUnshardedSkeletonMergeTask,
  ShardedSkeletonMergeTask,
  SkeletonTask,
  TransferSkeletonFilesTask,
  UnshardedSkeletonMergeTask,
  skel_dir_for,
)
from ..volume import Volume
from .common import GridTaskIterator, get_bounds, label_prefixes, operator_contact


def create_skeletonizing_tasks(
  cloudpath: str,
  mip: int = 0,
  shape: Sequence[int] = (512, 512, 512),
  teasar_params: Optional[dict] = None,
  object_ids: Optional[Sequence[int]] = None,
  mask_ids: Optional[Sequence[int]] = None,
  dust_threshold: int = 1000,
  dust_global: bool = False,
  fill_missing: bool = False,
  sharded: bool = False,
  skel_dir: Optional[str] = None,
  spatial_index: bool = True,
  fix_borders: bool = True,
  fill_holes: int = 0,
  fix_branching: bool = True,
  fix_avocados: bool = False,
  fix_autapses: bool = False,
  cross_sectional_area: bool = False,
  csa_smoothing_window: int = 1,
  csa_repair_sec_per_label: int = -1,
  low_memory_csa: bool = False,
  synapses: Optional[dict] = None,
  parallel: int = 1,
  bounds: Optional[Bbox] = None,
  timestamp: Optional[float] = None,
  frag_path: Optional[str] = None,
  root_ids_cloudpath: Optional[str] = None,
  cross_sectional_area_smoothing_window: Optional[int] = None,
  cross_sectional_area_repair_sec_per_label: Optional[int] = None,
):
  """Stage-1 skeleton forge grid; writes the skeleton ``info`` with its
  vertex_attributes and points the layer's ``info`` at it. The two long
  spellings alias ``csa_smoothing_window`` and
  ``csa_repair_sec_per_label``.

  ``synapses`` become per-task extra targets, in either form:
  ``{label: [[x, y, z] physical points]}`` or
  ``[((x, y, z), label, swc_label), ...]``."""
  if cross_sectional_area_smoothing_window is not None:
    csa_smoothing_window = cross_sectional_area_smoothing_window
  if cross_sectional_area_repair_sec_per_label is not None:
    csa_repair_sec_per_label = cross_sectional_area_repair_sec_per_label
  vol = Volume(cloudpath, mip=mip)
  if vol.layer_type != "segmentation":
    raise ValueError("Skeletonization requires a segmentation layer")
  if fix_autapses and vol.graphene is None:
    raise ValueError("fix_autapses requires a graphene:// volume")

  if skel_dir is None:
    skel_dir = vol.info.get("skeletons") or f"skeletons_mip_{mip}"
  vol.info["skeletons"] = skel_dir

  vertex_attributes = list(DEFAULT_ATTRIBUTES)
  if cross_sectional_area:
    # extra attributes serialize sorted by id after the defaults
    # (Skeleton.to_precomputed): the info lists the same order
    vertex_attributes.append({
      "id": "cross_sectional_area",
      "data_type": "float32",
      "num_components": 1,
    })
  skel_info = {
    "@type": "neuroglancer_skeletons",
    # vertices are stored in physical nm already: identity transform
    "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
    "vertex_attributes": vertex_attributes,
    "mip": int(mip),
  }
  if spatial_index:
    res = [int(v) for v in vol.resolution]
    skel_info["spatial_index"] = {
      "resolution": res,
      "chunk_size": [int(s * r) for s, r in zip(shape, res)],
    }
  vol.cf.put_json(f"{skel_dir}/info", skel_info)
  vol.commit_info()

  shape = Vec(*shape)
  task_bounds = get_bounds(
    vol, bounds, mip, mip, chunk_size=vol.meta.chunk_size(mip)
  )

  # synapses -> per-task voxel targets, bucketed by grid cell once
  cell_targets = {}  # (cx,cy,cz) -> {label: [[x,y,z,swc_label], ...]}
  if synapses:
    res = np.asarray(vol.resolution, dtype=np.float64)
    grid_lo = np.asarray(task_bounds.minpt, dtype=np.int64)
    shape_arr = np.asarray(shape, dtype=np.int64)

    def normalized():
      if isinstance(synapses, dict):
        for label, pts in synapses.items():
          for p in pts:
            yield (p, int(label), 0)
      else:
        for p, label, swc_label in synapses:
          yield (p, int(label), int(swc_label))

    for p, label, swc_label in normalized():
      vox = (np.asarray(p, dtype=np.float64) / res).astype(np.int64)
      rel = vox - grid_lo
      cells = {tuple((rel // shape_arr).tolist())}
      # a point on a cell's first plane also sits in the previous cell's
      # +1 overlap cutout
      for axis in range(3):
        if rel[axis] % shape_arr[axis] == 0 and rel[axis] > 0:
          for c in list(cells):
            lower = list(c)
            lower[axis] -= 1
            cells.add(tuple(lower))
      entry = [int(vox[0]), int(vox[1]), int(vox[2]), swc_label]
      for c in cells:
        cell_targets.setdefault(c, {}).setdefault(label, []).append(entry)

  def task_targets(offset: Vec, shape_: Vec):
    if not cell_targets:
      return None
    cell = tuple((
      (np.asarray(offset, dtype=np.int64)
       - np.asarray(task_bounds.minpt, dtype=np.int64))
      // np.asarray(shape_, dtype=np.int64)
    ).tolist())
    return cell_targets.get(cell)

  def make_task(shape_: Vec, offset: Vec):
    return SkeletonTask(
      cloudpath=cloudpath,
      shape=shape_.tolist(),
      offset=offset.tolist(),
      mip=mip,
      teasar_params=teasar_params,
      object_ids=list(object_ids) if object_ids else None,
      mask_ids=list(mask_ids) if mask_ids else None,
      dust_threshold=dust_threshold,
      dust_global=dust_global,
      fill_missing=fill_missing,
      sharded=sharded,
      skel_dir=skel_dir,
      spatial_index=spatial_index,
      fix_borders=fix_borders,
      fill_holes=fill_holes,
      fix_branching=fix_branching,
      fix_avocados=fix_avocados,
      fix_autapses=fix_autapses,
      cross_sectional_area=cross_sectional_area,
      csa_smoothing_window=csa_smoothing_window,
      csa_repair_sec_per_label=csa_repair_sec_per_label,
      low_memory_csa=low_memory_csa,
      extra_targets=task_targets(offset, shape_),
      parallel=parallel,
      timestamp=timestamp,
      frag_path=frag_path,
      root_ids_cloudpath=root_ids_cloudpath,
    )

  def finish():
    vol.meta.refresh_provenance()
    vol.meta.add_provenance_entry({
      "task": "SkeletonTask", "mip": mip, "shape": shape.tolist(),
      "skel_dir": skel_dir, "sharded": sharded,
      "teasar_params": teasar_params or {},
      "dust_threshold": dust_threshold,
      "dust_global": dust_global,
      "bounds": task_bounds.to_list(),
    }, operator_contact())
    vol.meta.commit_provenance()

  return GridTaskIterator(task_bounds, shape, make_task, finish)


def create_unsharded_skeleton_merge_tasks(
  cloudpath: str,
  magnitude: int = 1,
  skel_dir: Optional[str] = None,
  dust_threshold: float = 4000.0,
  tick_threshold: float = 6000.0,
  delete_fragments: bool = False,
  max_cable_length: Optional[float] = None,
  crop: int = 0,
) -> Iterator:
  """Stage-2 merge split by decimal label prefix (``label_prefixes``:
  exactly-once coverage)."""
  for prefix in label_prefixes(magnitude):
    yield UnshardedSkeletonMergeTask(
      cloudpath=cloudpath,
      prefix=prefix,
      skel_dir=skel_dir,
      dust_threshold=dust_threshold,
      tick_threshold=tick_threshold,
      delete_fragments=delete_fragments,
      max_cable_length=max_cable_length,
      crop=crop,
    )


def create_sharded_skeleton_merge_tasks(
  cloudpath: str,
  skel_dir: Optional[str] = None,
  dust_threshold: float = 4000.0,
  tick_threshold: float = 6000.0,
  shard_index_bytes: int = 8192,
  minishard_index_bytes: int = 40000,
  min_shards: int = 1,
  max_cable_length: Optional[float] = None,
  max_labels_per_shard: Optional[int] = None,
  minishard_index_encoding: str = "gzip",
  data_encoding: str = "gzip",
  spatial_index_db: Optional[str] = None,
) -> Iterator:
  """Stage-2 sharded merge: census labels via the spatial index, solve
  shard parameters, attach the sharding spec to the skeleton info, and
  emit one task per shard file."""
  vol = Volume(cloudpath)
  sdir = skel_dir_for(vol, skel_dir)
  if spatial_index_db:
    labels = SpatialIndex.query_sqlite(spatial_index_db)
  else:
    labels = SpatialIndex(vol.cf, sdir).query()
  if max_labels_per_shard and len(labels) > 0:
    # bound the average shard population
    min_shards = max(
      min_shards, int(np.ceil(len(labels) / max_labels_per_shard))
    )
  shard_bits, minishard_bits, preshift_bits = compute_shard_params_for_hashed(
    num_labels=len(labels),
    shard_index_bytes=shard_index_bytes,
    minishard_index_bytes=minishard_index_bytes,
    min_shards=min_shards,
  )
  spec = ShardingSpecification(
    preshift_bits=preshift_bits,
    hash="murmurhash3_x86_128",
    minishard_bits=minishard_bits,
    shard_bits=shard_bits,
    minishard_index_encoding=minishard_index_encoding,
    data_encoding=data_encoding,
  )
  skel_info = vol.cf.get_json(f"{sdir}/info") or {}
  skel_info["sharding"] = spec.to_dict()
  vol.cf.put_json(f"{sdir}/info", skel_info)

  for shard_no in range(2**shard_bits):
    yield ShardedSkeletonMergeTask(
      cloudpath=cloudpath,
      shard_no=shard_no,
      skel_dir=sdir,
      dust_threshold=dust_threshold,
      tick_threshold=tick_threshold,
      max_cable_length=max_cable_length,
    )


def create_sharded_from_unsharded_skeleton_merge_tasks(
  cloudpath: str,
  dest_cloudpath: Optional[str] = None,
  src_skel_dir: Optional[str] = None,
  skel_dir: Optional[str] = None,
) -> Iterator:
  """Re-pack finished unsharded skeletons into shard files.
  ``dest_cloudpath`` writes them into a different volume (``skeleton xfer
  --sharded``)."""
  vol = Volume(cloudpath)
  src = src_skel_dir or skel_dir_for(vol, None)
  out = skel_dir or f"{src}_sharded"

  labels = [
    int(k.split("/")[-1]) for k in vol.cf.list(f"{src}/")
    if k.split("/")[-1].isdigit()
  ]
  shard_bits, minishard_bits, preshift_bits = compute_shard_params_for_hashed(
    len(labels)
  )
  spec = ShardingSpecification(
    preshift_bits=preshift_bits,
    hash="murmurhash3_x86_128",
    minishard_bits=minishard_bits,
    shard_bits=shard_bits,
  )
  src_info = vol.cf.get_json(f"{src}/info") or {
    "@type": "neuroglancer_skeletons",
    "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
    "vertex_attributes": DEFAULT_ATTRIBUTES,
  }
  src_info["sharding"] = spec.to_dict()
  if dest_cloudpath:
    CloudFiles(dest_cloudpath).put_json(f"{out}/info", src_info)
    try:
      dest = Volume(dest_cloudpath)
      dest.info["skeletons"] = out
      dest.commit_info()
    except FileNotFoundError:
      pass  # skeleton-only bucket
  else:
    vol.cf.put_json(f"{out}/info", src_info)
    vol.info["skeletons"] = out
    vol.commit_info()

  for shard_no in range(2**shard_bits):
    yield ShardedFromUnshardedSkeletonMergeTask(
      cloudpath=cloudpath,
      shard_no=shard_no,
      src_skel_dir=src,
      skel_dir=out,
      dest_cloudpath=dest_cloudpath,
    )


def create_skeleton_deletion_tasks(
  cloudpath: str, magnitude: int = 1, skel_dir: Optional[str] = None
):
  """One ``DeleteSkeletonFilesTask`` a label prefix (``label_prefixes``)."""
  sdir = skel_dir_for(Volume(cloudpath), skel_dir)
  for prefix in label_prefixes(magnitude):
    yield partial(DeleteSkeletonFilesTask, cloudpath, sdir, prefix)


def create_skeleton_transfer_tasks(
  src_layer: str, dest_layer: str, skel_dir: Optional[str] = None,
  magnitude: int = 1,
):
  """One ``TransferSkeletonFilesTask`` a label prefix; points the
  destination's info at the skeleton dir."""
  sdir = skel_dir_for(Volume(src_layer), skel_dir)
  try:
    dest = Volume(dest_layer)
    dest.info["skeletons"] = sdir
    dest.commit_info()
  except FileNotFoundError:
    pass
  for prefix in label_prefixes(magnitude):
    yield partial(TransferSkeletonFilesTask, src_layer, dest_layer, sdir, prefix)
