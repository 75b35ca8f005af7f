"""Mesh forge and manifest tasks (the legacy, unsharded mesh format).

The port's own copy of ``MeshTask``, ``MeshManifestPrefixTask`` and
``MeshManifestFilesystemTask`` from ``igneous_tpu/tasks/mesh.py``. A
``MeshTask`` meshes every label of its cutout (the task's box plus a
1-voxel high-side overlap, so adjacent tasks' surfaces meet), closing
surfaces at the dataset boundary, and writes one ``<label>:0:<bbox>``
fragment per label and a ``.spatial`` index file, byte-identical to the
JAX package's.

Where the JAX package runs every per-voxel stage on the host in numpy,
the port runs them on the device: the cutout goes there once, and the
unique labels with their counts, the dense renumbering, each label's
bounding box, the masks, the count pass and the emission stay there
(``ops.mesh``). Only triangles come back; the weld, simplification,
encoding and upload run on the host.

``fill_holes`` closes cavities before the boundary pad (``ops.morphology``:
a host flood fill, with a dilation and an erosion on the device from
level 3), and ``dust_global`` drops the labels whose count in the layer's
voxel-count census (``tasks.stats``) is below ``dust_threshold`` in place
of this cutout's counts.

Not ported yet (refused before anything is written): sharded ``.frags``
output, draco and graphene layers.

Stage timers (``telemetry``): download, remap (object-id options),
fill_holes (with dilate and erode from level 3), h2d, labels (unique,
renumber, boxes), count, emit, d2h, weld, simplify and upload.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from .. import telemetry
from ..device import get_device
from ..lib import Bbox, Vec
from ..mesh_io import Mesh, encode_mesh, simplify
from ..ops import remap as fastremap
from ..ops.mesh import (
  LabelMasks,
  label_boxes,
  labels_on_device,
  marching_cubes_batch,
  marching_tetrahedra_batch,
)
from ..ops.morphology import fill_holes
from ..queues.registry import RegisteredTask
from ..spatial_index import SpatialIndex
from ..storage import CloudFiles
from ..volume import Volume
from .stats import globally_small_labels


def mesh_dir_for(vol: Volume, mesh_dir: Optional[str]) -> str:
  if mesh_dir:
    return mesh_dir
  if vol.info.get("mesh"):
    return vol.info["mesh"]
  raise ValueError("No mesh directory configured in the info file")


def refuse_unported(
  layer_path: str = "", sharded: bool = False, encoding: str = "precomputed",
  compress="gzip",
) -> None:
  """Raise NotImplementedError for the mesh options the port does not
  run yet; the factory and the task call it before anything is written."""
  refused = []
  if str(layer_path).startswith("graphene://"):
    refused.append("graphene layers")
  if sharded:
    refused.append("sharded .frags output")
  if encoding == "draco":
    refused.append("draco encoding")
  if compress not in ("gzip", None, False, ""):
    refused.append(f"compress={compress!r}")
  if refused:
    raise NotImplementedError(
      f"not ported to igneous_tpu_torch yet: {', '.join(refused)}"
    )
  if encoding != "precomputed":
    raise ValueError(f"Unknown mesh encoding: {encoding}")


class MeshTask(RegisteredTask):
  # labels per count pass (bounds the device's mask memory)
  MESH_BATCH = 16

  def __init__(
    self,
    shape: Sequence[int],
    offset: Sequence[int],
    layer_path: str,
    mip: int = 0,
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
    closed_dataset_edges: bool = True,
    fill_holes: int = 0,
    timestamp: Optional[float] = None,
    mesher: str = "cubes",
    parallel: int = 1,
    compress: str = "gzip",
  ):
    refuse_unported(layer_path, sharded, encoding, compress)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.layer_path = layer_path
    self.mip = int(mip)
    self.simplification_factor = simplification_factor
    self.max_simplification_error = max_simplification_error
    self.mesh_dir = mesh_dir
    self.dust_threshold = dust_threshold
    # dust by the layer's voxel-count census instead of this cutout's
    self.dust_global = bool(dust_global)
    self.object_ids = list(object_ids) if object_ids else None
    self.exclude_object_ids = (
      list(exclude_object_ids) if exclude_object_ids else None
    )
    # {orig_id: new_id} agglomeration applied before meshing; only the
    # table's keys are meshed (see prepare_jobs)
    self.remap_table = (
      {int(k): int(v) for k, v in remap_table.items()} if remap_table
      else None
    )
    self.fill_missing = fill_missing
    self.encoding = encoding
    self.spatial_index = spatial_index
    self.closed_dataset_edges = closed_dataset_edges
    # the hole-filling level of ops.morphology.fill_holes (0 off)
    self.fill_holes = int(fill_holes)
    if mesher not in ("cubes", "tetrahedra"):
      raise ValueError(f"mesher must be 'cubes' or 'tetrahedra': {mesher!r}")
    self.mesher = mesher
    self.compress = compress or None
    # threads for the per-label simplification (the native collapse
    # releases the interpreter lock; results are keyed by label)
    self.parallel = int(parallel)

  def execute(self):
    ctx = self.prepare_jobs()
    if ctx is None:
      return
    mesher_batch = (
      marching_cubes_batch if self.mesher == "cubes"
      else marching_tetrahedra_batch
    )
    for g0 in range(0, len(ctx["jobs"]), self.MESH_BATCH):
      group = ctx["jobs"][g0 : g0 + self.MESH_BATCH]
      results = mesher_batch(
        self.group_masks(ctx, group),
        anisotropy=ctx["resolution"],
        offsets=self.group_offsets(ctx, group),
        batch_size=self.MESH_BATCH,
      )
      self.finish_group(ctx, group, results)
    self.finalize(ctx)

  def prepare_jobs(self):
    """Download, label options, and the per-voxel label work on the
    device. Returns a context dict (or None when there is nothing to
    mesh); its ``jobs`` are (label, (x, y, z) slices of the box grown by
    one voxel, dense id) in ascending label order."""
    vol = Volume(
      self.layer_path, mip=self.mip, fill_missing=self.fill_missing,
      bounded=False,
    )
    bounds = vol.meta.bounds(self.mip)
    core = Bbox.intersection(Bbox(self.offset, self.offset + self.shape), bounds)
    if core.empty():
      return None
    # 1-voxel high-side overlap: adjacent tasks share a boundary plane so
    # their surfaces meet exactly
    cutout = Bbox.intersection(Bbox(core.minpt, core.maxpt + 1), bounds)
    with telemetry.stage("download"):
      img = vol.download(cutout)[..., 0]

    with telemetry.stage("remap"):
      if self.remap_table:
        # only the table's keys are meshed (everything else is masked to
        # background first) and background is never remapped
        table = dict(self.remap_table)
        table[0] = 0
        img = fastremap.mask_except(img, list(table.keys()))
        img = fastremap.remap(img, table)
      if self.object_ids:
        img = fastremap.mask_except(img, self.object_ids)
      if self.exclude_object_ids:
        img = fastremap.mask(img, self.exclude_object_ids)

    if self.fill_holes:
      # close internal cavities so meshes have no interior shells; before
      # the boundary pad, as in the JAX package
      img = fill_holes(img, level=self.fill_holes)

    # zero-pad where the cutout touches the dataset boundary so surfaces
    # close instead of gaping; interior task edges stay open (the
    # neighbour task supplies the adjoining surface)
    pad_lo = [int(cutout.minpt[a] == bounds.minpt[a]) for a in range(3)]
    pad_hi = [int(cutout.maxpt[a] == bounds.maxpt[a]) for a in range(3)]
    if not self.closed_dataset_edges:
      pad_lo = [0, 0, 0]
      pad_hi = [0, 0, 0]
    origin = cutout.minpt - Vec(*pad_lo)

    dev = get_device()
    with telemetry.stage("h2d"):
      seg, flip = labels_on_device(img, pad_lo, pad_hi, dev)
    X, Y, Z = (int(s) for s in reversed(seg.shape))

    with telemetry.stage("labels"):
      labels, counts, dense, lo, hi = label_boxes(seg, flip)
      del seg
    labels = labels.view(np.uint64) if flip else labels.astype(img.dtype)
    sel = labels != 0
    if self.dust_threshold and self.dust_global:
      # global counts keep objects that straddle task borders
      small = set(globally_small_labels(
        self.layer_path, self.mip, labels[sel], self.dust_threshold,
      ))
      sel &= np.asarray([int(l) not in small for l in labels], dtype=bool)
    elif self.dust_threshold:
      sel &= counts >= self.dust_threshold
    if not sel.any():
      self._upload({}, core, cutout, vol)
      return None

    # dense ids are the ranks of the nonzero labels: each kept label's
    # box, grown by one voxel and clipped to the padded cutout
    shape = (X, Y, Z)
    first = int(labels[0] == 0)
    jobs = []
    for new_id in range(1, len(labels) - first + 1):
      u = new_id - 1 + first
      if not sel[u]:
        continue
      grow = tuple(
        slice(max(int(lo[new_id, a]) - 1, 0), min(int(hi[new_id, a]) + 1, shape[a]))
        for a in range(3)
      )
      jobs.append((int(labels[u]), grow, new_id))

    return {
      "vol": vol, "core": core, "cutout": cutout, "origin": origin,
      "dense": dense, "jobs": jobs,
      "resolution": np.asarray(vol.resolution, dtype=np.float32),
      "res_int": np.asarray(vol.resolution, dtype=np.int64),
      "meshes": {}, "label_bounds": {},
    }

  @staticmethod
  def group_masks(ctx, group) -> LabelMasks:
    return LabelMasks(
      ctx["dense"], [grow for _, grow, _ in group],
      [new_id for _, _, new_id in group],
    )

  @staticmethod
  def group_offsets(ctx, group):
    return [
      np.asarray(ctx["origin"], dtype=np.float32)
      + np.asarray([g.start for g in grow], dtype=np.float32)
      for _, grow, _ in group
    ]

  def finish_group(self, ctx, group, results):
    """Host stage for one group of labels: simplification and bounding
    boxes, on ``parallel`` threads."""
    origin, res_int = ctx["origin"], ctx["res_int"]

    def _finish(args):
      (orig, grow, _), (verts, faces) = args
      mesh = Mesh(verts, faces)
      if self.simplification_factor > 1:
        with telemetry.stage("simplify"):
          mesh = simplify(
            mesh, self.simplification_factor, self.max_simplification_error
          )
      mn = (np.asarray([g.start for g in grow]) + np.asarray(origin)) * res_int
      mx = (np.asarray([g.stop for g in grow]) + np.asarray(origin)) * res_int
      return orig, mesh, Bbox(mn, mx)

    telemetry.add("labels", len(group))
    telemetry.add("faces", sum(len(faces) for _, faces in results))
    pairs = list(zip(group, results))
    if self.parallel > 1 and len(pairs) > 1:
      with ThreadPoolExecutor(max_workers=self.parallel) as ex:
        finished = list(ex.map(_finish, pairs))
    else:
      finished = [_finish(p) for p in pairs]
    telemetry.add("faces_simplified", sum(len(m.faces) for _, m, _ in finished))
    for orig, mesh, bbx in finished:
      ctx["meshes"][orig] = mesh
      ctx["label_bounds"][orig] = bbx

  def finalize(self, ctx):
    self._upload(
      ctx["meshes"], ctx["core"], ctx["cutout"], ctx["vol"],
      ctx["label_bounds"],
    )

  def _upload(self, meshes, core, cutout, vol, label_bounds=None):
    with telemetry.stage("upload"):
      mdir = mesh_dir_for(vol, self.mesh_dir)
      cf = CloudFiles(vol.cloudpath)
      res = np.asarray(vol.resolution, dtype=np.int64)
      # the .spatial file is named by the task's physical box
      physical = Bbox(core.minpt * res, core.maxpt * res)
      for label, m in meshes.items():
        cf.put(
          f"{mdir}/{label}:0:{core.to_filename()}",
          encode_mesh(m, self.encoding),
          compress=self.compress,
        )
      if self.spatial_index and label_bounds is not None:
        SpatialIndex(cf, mdir).put(physical, label_bounds)


class MeshManifestPrefixTask(RegisteredTask):
  """Stage 2 (legacy format): group the fragment files of the labels
  under one decimal prefix and write their ``<label>:0`` manifests."""

  def __init__(self, layer_path: str, prefix: str, mesh_dir: Optional[str] = None):
    self.layer_path = layer_path
    self.prefix = str(prefix)
    self.mesh_dir = mesh_dir

  def execute(self):
    vol = Volume(self.layer_path)
    mdir = mesh_dir_for(vol, self.mesh_dir)
    cf = CloudFiles(vol.cloudpath)
    fragments = defaultdict(list)
    for key in cf.list(f"{mdir}/{self.prefix}"):
      name = key.split("/")[-1]
      parts = name.split(":")
      if len(parts) != 3:  # skip manifests/spatial files
        continue
      fragments[parts[0]].append(name)
    for label, frags in fragments.items():
      cf.put_json(f"{mdir}/{label}:0", {"fragments": sorted(frags)})


class MeshManifestFilesystemTask(RegisteredTask):
  """Stage 2 over the whole mesh dir in one task (small datasets)."""

  def __init__(self, layer_path: str, mesh_dir: Optional[str] = None):
    self.layer_path = layer_path
    self.mesh_dir = mesh_dir

  def execute(self):
    MeshManifestPrefixTask(
      layer_path=self.layer_path, prefix="", mesh_dir=self.mesh_dir
    ).execute()
