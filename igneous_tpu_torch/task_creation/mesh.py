"""Mesh task factories (the legacy, unsharded format).

The port's own copy of ``create_meshing_tasks`` and
``create_mesh_manifest_tasks`` from ``igneous_tpu/task_creation/mesh.py``:
the same task grid, payloads, mesh ``info`` and provenance. The options
the port does not run yet (sharded output, draco, graphene layers) raise ``NotImplementedError`` before anything is
written.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from ..lib import Bbox, Vec
from ..tasks.mesh import MeshManifestPrefixTask, MeshTask, refuse_unported
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
  refuse_unported(layer_path, sharded, encoding, compress)
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
