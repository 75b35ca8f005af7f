"""Mesh forge, manifest and maintenance tasks.

The port's own copy of ``MeshTask``, ``MeshManifestPrefixTask``,
``MeshManifestFilesystemTask`` and the ``@queueable`` functions
``TransferMeshFilesTask`` and ``DeleteMeshFilesTask`` from
``igneous_tpu/tasks/mesh.py``. A ``MeshTask`` meshes every label of its
cutout (the task's box plus a 1-voxel high-side overlap, so adjacent
tasks' surfaces meet), closing surfaces at the dataset boundary, and
writes one ``<label>:0:<bbox>`` fragment per label (or, with
``sharded=True``, one uncompressed ``<bbox>.frags`` container of every
label's fragment, named by the task's physical box, for the multires
merges of ``tasks.mesh_multires``) and a ``.spatial`` index file,
byte-identical to the JAX package's. Fragments are Precomputed or draco.

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

A graphene layer meshes at L2 granularity: the cutout downloads with
``stop_layer=2`` (the supervoxels mapped to per-(root, chunk) L2 ids on the
device, ``ops.graphene_ids``), as of ``timestamp``. ``GrapheneMeshTask``
is that ``MeshTask`` with draco fragments in sharded ``.frags``.

Stage timers (``telemetry``): download, graphene (the id maps), remap
(object-id options),
fill_holes (with dilate and erode from level 3), h2d, labels (unique,
renumber, boxes), count, emit, d2h, weld, simplify and upload.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from .. import telemetry
from ..device import get_device
from ..lib import Bbox, Vec
from ..mesh_io import FragMap, Mesh, encode_mesh, simplify
from ..ops import remap as fastremap
from ..ops.mesh import (
  LabelMasks,
  label_boxes,
  labels_on_device,
  marching_cubes_batch,
  marching_tetrahedra_batch,
)
from ..ops.morphology import fill_holes
from ..queues.registry import RegisteredTask, queueable
from ..spatial_index import SpatialIndex
from ..storage import CloudFiles, wire_ext
from ..volume import Volume
from .stats import globally_small_labels


def mesh_dir_for(vol: Volume, mesh_dir: Optional[str]) -> str:
  if mesh_dir:
    return mesh_dir
  if vol.info.get("mesh"):
    return vol.info["mesh"]
  raise ValueError("No mesh directory configured in the info file")


def check_options(encoding: str = "precomputed", compress="gzip") -> None:
  """Raise ValueError for an unknown encoding or a compression the
  storage does not write; the factory and the task call it before
  anything is written."""
  if encoding not in ("precomputed", "draco"):
    raise ValueError(f"Unknown mesh encoding: {encoding}")
  fragment_compression(compress)


def fragment_compression(compress):
  """The storage method of a ``compress=`` choice for the fragments: None
  for none (``None``, ``False``, ``""``, ``"none"``, ``"false"``), else
  ``gzip``, ``gzip-1`` ... ``gzip-9`` or ``zstd`` as given; ValueError for
  any other."""
  if not compress or (isinstance(compress, str) and compress.lower() in ("none", "false")):
    return None
  if wire_ext(compress) is None:
    raise ValueError(
      f"Unsupported compression: {compress!r} (fragments take gzip, "
      "gzip-1..gzip-9, zstd or none)"
    )
  return compress


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
    check_options(encoding, compress)
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
    self.sharded = bool(sharded)
    self.closed_dataset_edges = closed_dataset_edges
    # the hole-filling level of ops.morphology.fill_holes (0 off)
    self.fill_holes = int(fill_holes)
    # graphene layers: the proofreading state to mesh (None: the latest)
    self.timestamp = timestamp
    if mesher not in ("cubes", "tetrahedra"):
      raise ValueError(f"mesher must be 'cubes' or 'tetrahedra': {mesher!r}")
    self.mesher = mesher
    self.compress = fragment_compression(compress)
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
    try:
      for g0 in range(0, len(ctx["jobs"]), self.MESH_BATCH):
        group = ctx["jobs"][g0 : g0 + self.MESH_BATCH]
        results = mesher_batch(
          self.group_masks(ctx, group),
          anisotropy=ctx["resolution"],
          offsets=self.group_offsets(ctx, group),
          batch_size=self.MESH_BATCH,
        )
        self.finish_group(ctx, group, results)
    except BaseException:
      drop_pool(ctx)
      raise
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
      # a graphene layer meshes its L2 ids: stable chunk-local ids whose
      # meshes the proofreading frontend stitches per root
      img = vol.download(
        cutout, stop_layer=2, timestamp=self.timestamp
      )[..., 0] if vol.graphene is not None else vol.download(cutout)[..., 0]

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
      "finished": [],
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
    boxes. With ``parallel`` > 1 the labels go to one pool of that many
    threads for the whole task (made at its first group), and ``finalize``
    collects them in job order: a group's simplification overlaps the next
    group's count pass, and no thread waits on a group's largest label."""
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

    telemetry.incr("mesh.labels", len(group))
    telemetry.incr("mesh.faces", sum(len(faces) for _, faces in results))
    pairs = list(zip(group, results))
    if self.parallel > 1:
      if "pool" not in ctx:
        ctx["pool"] = ThreadPoolExecutor(max_workers=self.parallel)
      ctx["finished"] += [ctx["pool"].submit(_finish, p) for p in pairs]
    else:
      ctx["finished"] += [_finish(p) for p in pairs]

  def finalize(self, ctx):
    try:
      finished = [f.result() if isinstance(f, Future) else f for f in ctx["finished"]]
    finally:
      drop_pool(ctx)
    telemetry.incr("mesh.faces_simplified", sum(len(m.faces) for _, m, _ in finished))
    self._upload(
      {orig: mesh for orig, mesh, _ in finished}, ctx["core"], ctx["cutout"],
      ctx["vol"], {orig: bbx for orig, _, bbx in finished},
    )

  def _upload(self, meshes, core, cutout, vol, label_bounds=None):
    with telemetry.stage("upload"):
      mdir = mesh_dir_for(vol, self.mesh_dir)
      cf = CloudFiles(vol.cloudpath)
      res = np.asarray(vol.resolution, dtype=np.int64)
      # .frags and .spatial share the physical bbox name, so the merges
      # map spatial-index cells to fragment containers by rename alone
      physical = Bbox(core.minpt * res, core.maxpt * res)
      if self.sharded:
        # the container stays uncompressed: its key table is read in place
        frags = {
          label: encode_mesh(m, self.encoding) for label, m in meshes.items()
        }
        cf.put(f"{mdir}/{physical.to_filename()}.frags", FragMap.tobytes(frags))
      else:
        for label, m in meshes.items():
          cf.put(
            f"{mdir}/{label}:0:{core.to_filename()}",
            encode_mesh(m, self.encoding),
            compress=self.compress,
          )
      if self.spatial_index and label_bounds is not None:
        SpatialIndex(cf, mdir).put(physical, label_bounds)


def drop_pool(ctx) -> None:
  """Shut down a task context's simplification pool, if it has one,
  dropping the labels it has not started."""
  pool = ctx.pop("pool", None)
  if pool is not None:
    pool.shutdown(cancel_futures=True)


class _StreamMasks(LabelMasks):
  """The label masks of several tasks as one stream: item i is job
  ``index`` of that task's ``LabelMasks`` (each task's renumbered cutout
  stays on the device where ``prepare_jobs`` put it)."""

  def __init__(self, parts):
    self.parts = list(parts)  # (LabelMasks, index)
    self.boxes = [m.boxes[i] for m, i in self.parts]
    self.device = self.parts[0][0].device

  def fill(self, i: int, out) -> None:
    masks, j = self.parts[i]
    masks.fill(j, out)


def execute_mesh_tasks_batched(tasks) -> int:
  """Run K MeshTasks with the count pass batched ACROSS tasks: every
  task's per-label masks feed one stream, cut into groups of
  ``MeshTask.MESH_BATCH`` and launched one count pass a
  mask bucket, instead of each task filling its own partial groups. The
  host stages (weld, simplification, upload) stay per task and write the
  bytes of solo execution.

  Callers group tasks by (layer, mip, mesher), so resolution and kernel
  agree across the stream (``parallel.lease_batcher``). A task's failure
  is stashed on ``task._batch_error`` (the lease batcher re-raises it for
  that member alone). Returns the number of count-pass dispatches."""
  from ..ops.mesh import _bucket_shape

  bs = MeshTask.MESH_BATCH
  for t in tasks:
    t._batch_error = None

  def prep(task):
    try:
      return task.prepare_jobs()
    except Exception as e:  # noqa: BLE001 - stashed, re-raised per lease
      task._batch_error = e
      return None

  # the download and label work reach the device: one task at a time on
  # this thread, in task order
  ctxs = [prep(t) for t in tasks]
  stream = []
  for task, ctx in zip(tasks, ctxs):
    if ctx is None:
      continue
    masks = task.group_masks(ctx, ctx["jobs"])
    for j, job in enumerate(ctx["jobs"]):
      stream.append((task, ctx, job, masks, j))

  mesher_batch = (
    marching_cubes_batch if tasks[0].mesher == "cubes"
    else marching_tetrahedra_batch
  )
  dispatches = 0
  for g0 in range(0, len(stream), bs):
    grp = [e for e in stream[g0 : g0 + bs] if e[0]._batch_error is None]
    if not grp:
      continue
    masks = _StreamMasks([(m, j) for _, _, _, m, j in grp])
    dispatches += len({_bucket_shape(masks.shape(i)) for i in range(len(masks))})
    offsets = [t.group_offsets(ctx, [job])[0] for t, ctx, job, _, _ in grp]
    results = mesher_batch(
      masks, anisotropy=grp[0][1]["resolution"], offsets=offsets,
      batch_size=bs,
    )
    # hand each task its own labels' results
    per_task = {}
    for (task, ctx, job, _, _), res in zip(grp, results):
      per_task.setdefault(id(task), (task, ctx, [], []))
      per_task[id(task)][2].append(job)
      per_task[id(task)][3].append(res)
    for task, ctx, jobs, ress in per_task.values():
      try:
        task.finish_group(ctx, jobs, ress)
      except Exception as e:  # noqa: BLE001
        task._batch_error = e

  for task, ctx in zip(tasks, ctxs):
    if ctx is None:
      continue
    if task._batch_error is not None:
      drop_pool(ctx)
      continue
    try:
      task.finalize(ctx)
    except Exception as e:  # noqa: BLE001
      task._batch_error = e
  return dispatches


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


@queueable
def TransferMeshFilesTask(
  src: str, dest: str, mesh_dir: str, prefix: str = ""
):
  """Copy the stored files under ``<mesh_dir>/<prefix>`` of ``src`` to
  ``dest`` as they are stored."""
  cf = CloudFiles(src)
  cf.transfer_to(dest, paths=list(cf.list(f"{mesh_dir}/{prefix}")))


@queueable
def DeleteMeshFilesTask(cloudpath: str, mesh_dir: str, prefix: str = ""):
  """Delete the files under ``<mesh_dir>/<prefix>``."""
  cf = CloudFiles(cloudpath)
  cf.delete(list(cf.list(f"{mesh_dir}/{prefix}")))


class GrapheneMeshTask(MeshTask):
  """Mesh forge of a graphene:// layer: ``MeshTask`` at L2 granularity
  (``stop_layer=2``), draco fragments in sharded ``.frags`` containers,
  the JAX package's ``GrapheneMeshTask``. The 1-voxel overlap and the
  same L2 ids on shared planes make adjacent chunk meshes weld."""

  def __init__(
    self,
    shape: Sequence[int],
    offset: Sequence[int],
    layer_path: str,
    mip: int = 0,
    simplification_factor: int = 100,
    max_simplification_error: int = 40,
    mesh_dir: Optional[str] = None,
    fill_missing: bool = False,
    encoding: str = "draco",
    timestamp: Optional[float] = None,
    object_ids: Optional[Sequence[int]] = None,
  ):
    super().__init__(
      shape=shape,
      offset=offset,
      layer_path=layer_path,
      mip=mip,
      simplification_factor=simplification_factor,
      max_simplification_error=max_simplification_error,
      mesh_dir=mesh_dir,
      fill_missing=fill_missing,
      encoding=encoding,
      sharded=True,
      timestamp=timestamp,
      object_ids=object_ids,
    )
