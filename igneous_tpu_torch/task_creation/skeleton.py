"""Skeleton task factories (unsharded format).

The port's own copy of ``create_skeletonizing_tasks`` and
``create_unsharded_skeleton_merge_tasks`` from
``igneous_tpu/task_creation/skeleton.py``: the same task grid, payloads,
skeleton ``info`` (``vertex_attributes``, ``spatial_index``) and
provenance. The options the port does not run yet (sharded output,
dust_global, fill_holes, fix_autapses, cross-sectional area, graphene
layers and root ids) raise ``NotImplementedError`` before anything is
written.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ..lib import Bbox, Vec
from ..skeleton_io import DEFAULT_ATTRIBUTES
from ..tasks.skeleton import SkeletonTask, UnshardedSkeletonMergeTask, refuse_unported
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
  synapses: Optional[dict] = None,
  parallel: int = 1,
  bounds: Optional[Bbox] = None,
  timestamp: Optional[float] = None,
  frag_path: Optional[str] = None,
  root_ids_cloudpath: Optional[str] = None,
):
  """Stage-1 skeleton forge grid; writes the skeleton ``info`` with its
  vertex_attributes and points the layer's ``info`` at it.

  ``synapses`` become per-task extra targets, in either form:
  ``{label: [[x, y, z] physical points]}`` or
  ``[((x, y, z), label, swc_label), ...]``."""
  refuse_unported(
    cloudpath, sharded, dust_global, fill_holes, fix_autapses,
    cross_sectional_area, root_ids_cloudpath,
  )
  vol = Volume(cloudpath, mip=mip)
  if vol.layer_type != "segmentation":
    raise ValueError("Skeletonization requires a segmentation layer")

  if skel_dir is None:
    skel_dir = vol.info.get("skeletons") or f"skeletons_mip_{mip}"
  vol.info["skeletons"] = skel_dir

  skel_info = {
    "@type": "neuroglancer_skeletons",
    # vertices are stored in physical nm already: identity transform
    "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
    "vertex_attributes": list(DEFAULT_ATTRIBUTES),
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
