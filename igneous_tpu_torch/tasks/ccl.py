"""Whole-image connected components labelling: the 4-pass protocol.

The port's own copy of ``igneous_tpu/tasks/ccl.py``:
  pass 1 CCLFacesTask        local CCL -> store the 3 back faces
  pass 2 CCLEquivalancesTask link faces of adjacent tasks
  pass 3 create_relabeling   single-machine global union-find
  pass 4 RelabelCCLTask      recompute + remap + write the destination

Every pass recomputes the identical deterministic local CCL
(``ops.ccl.connected_components``); label offsets are task_num times the
voxels of a cutout, so local ids never collide; cross-task data flows
through the object store only (faces, equivalence JSONs, relabel maps),
in files byte-identical to the JAX package's; the +1 overlap cutout is
blacked out on its "rails" (voxels extended in >= 2 axes), so 6-connected
merges are exactly the ones the face planes witness.

Stage timers (``telemetry``): download, prep (threshold, rails), the
CCL's own (dense_relabel, h2d, kernel, d2h, tile_merge, renumber; again
for dust), offset, faces, equivalences, remap and upload.
"""

from __future__ import annotations

import gzip
import io
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import telemetry
from ..lib import Bbox, Vec
from ..ops import remap as fastremap
from ..ops.ccl import DisjointSet, connected_components, dust, threshold_image
from ..queues.registry import RegisteredTask
from ..storage import CloudFiles, scratch_gzip_level
from ..volume import Volume


def _npy_bytes(arr: np.ndarray) -> bytes:
  buf = io.BytesIO()
  np.save(buf, arr)
  # face planes are scratch (pass 2 consumes, clean deletes): the level
  # follows IGNEOUS_SCRATCH_COMPRESS; 4 when unset
  return gzip.compress(
    buf.getvalue(), compresslevel=scratch_gzip_level(4), mtime=0
  )


def _npy_load(data: bytes) -> np.ndarray:
  return np.load(io.BytesIO(gzip.decompress(data)))


def ccl_scratch_path(dest_path: str, mip: int) -> str:
  return f"ccl/{mip}"


def label_offset(task_num: int, shape: Sequence[int]) -> int:
  """Task-local -> global label offset: task_num x cutout voxels
  (cutout = shape + 1 overlap)."""
  vox = int(np.prod(np.asarray(shape, dtype=np.int64) + 1))
  return task_num * vox


def _download_and_ccl(
  src_path: str,
  mip: int,
  shape: Vec,
  offset: Vec,
  task_num: int,
  fill_missing: bool,
  threshold_gte: Optional[float],
  threshold_lte: Optional[float],
  dust_threshold: int = 0,
) -> Tuple[np.ndarray, Bbox, Bbox]:
  """The deterministic shared pass: cutout+1 -> threshold -> rails blackout
  -> dust -> device CCL -> +offset. Returns (labels_u64, cutout_bbox,
  core_bbox)."""
  img, cutout, core = _prep_ccl_image(
    src_path, mip, shape, offset, fill_missing, threshold_gte, threshold_lte,
    dust_threshold,
  )
  cc = connected_components(img)
  with telemetry.stage("offset"):
    return _offset_components(cc, task_num, shape), cutout, core


def _prep_ccl_image(
  src_path, mip, shape, offset, fill_missing, threshold_gte, threshold_lte,
  dust_threshold: int = 0,
) -> Tuple[np.ndarray, Bbox, Bbox]:
  """Download + threshold + rails blackout + dust (everything before the
  CCL)."""
  # the reference opens the source with bounded=False; the port's Volume
  # has no such option and needs none: the cutout below is intersected
  # with the bounds before it is downloaded
  vol = Volume(src_path, mip=mip, fill_missing=fill_missing)
  bounds = vol.meta.bounds(mip)
  core = Bbox.intersection(Bbox(offset, offset + shape), bounds)
  cutout = Bbox.intersection(Bbox(offset, offset + shape + 1), bounds)

  with telemetry.stage("download"):
    img = vol.download(cutout)[..., 0]
  with telemetry.stage("prep"):
    img = threshold_image(img, threshold_gte, threshold_lte)
    # rails blackout: voxels extended past the core in >= 2 axes
    ext_counts = np.zeros(img.shape, dtype=np.uint8)
    for axis in range(3):
      if cutout.maxpt[axis] > core.maxpt[axis]:
        sl = [slice(None)] * 3
        sl[axis] = slice(int(core.maxpt[axis] - cutout.minpt[axis]), None)
        ext = np.zeros(img.shape, dtype=np.uint8)
        ext[tuple(sl)] = 1
        ext_counts += ext
    img[ext_counts >= 2] = 0
  if dust_threshold:
    # dust BEFORE the CCL so every pass recomputes identical labels
    img = dust(img, dust_threshold, connectivity=6, in_place=True)
  return img, cutout, core


def _offset_components(cc: np.ndarray, task_num: int, shape) -> np.ndarray:
  cc = cc.astype(np.uint64)
  cc[cc != 0] += np.uint64(label_offset(task_num, shape))
  return cc


def store_ccl_faces(cc, cutout, core, task_num, cf, scratch):
  """Upload the 3 overlap ('back') face planes (pass-1 output format)."""
  for axis, name in enumerate("xyz"):
    if cutout.maxpt[axis] > core.maxpt[axis]:
      sl = [slice(None)] * 3
      sl[axis] = int(cutout.size3()[axis]) - 1
      cf.put(
        f"{scratch}/faces/{task_num}-{name}.npy.gz",
        _npy_bytes(cc[tuple(sl)]),
      )


class CCLFacesTask(RegisteredTask):
  """Pass 1: per-task CCL; store the 3 overlap ('back') face planes."""

  def __init__(
    self,
    src_path: str,
    mip: int,
    shape: Sequence[int],
    offset: Sequence[int],
    task_num: int,
    fill_missing: bool = False,
    threshold_gte: Optional[float] = None,
    threshold_lte: Optional[float] = None,
    dust_threshold: int = 0,
  ):
    self.src_path = src_path
    self.mip = int(mip)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.task_num = int(task_num)
    self.fill_missing = fill_missing
    self.threshold_gte = threshold_gte
    self.threshold_lte = threshold_lte
    self.dust_threshold = int(dust_threshold)

  def execute(self):
    cc, cutout, core = _download_and_ccl(
      self.src_path, self.mip, self.shape, self.offset, self.task_num,
      self.fill_missing, self.threshold_gte, self.threshold_lte,
      self.dust_threshold,
    )
    with telemetry.stage("faces"):
      store_ccl_faces(
        cc, cutout, core, self.task_num, CloudFiles(self.src_path),
        ccl_scratch_path(self.src_path, self.mip),
      )


class CCLEquivalancesTask(RegisteredTask):
  """Pass 2: recompute the local CCL; link the first planes against the
  previous tasks' stored back faces; emit (all local labels, equivalence
  pairs)."""

  def __init__(
    self,
    src_path: str,
    mip: int,
    shape: Sequence[int],
    offset: Sequence[int],
    task_num: int,
    grid_size: Sequence[int],
    fill_missing: bool = False,
    threshold_gte: Optional[float] = None,
    threshold_lte: Optional[float] = None,
    dust_threshold: int = 0,
  ):
    self.src_path = src_path
    self.mip = int(mip)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.task_num = int(task_num)
    self.grid_size = Vec(*grid_size)
    self.fill_missing = fill_missing
    self.threshold_gte = threshold_gte
    self.threshold_lte = threshold_lte
    self.dust_threshold = int(dust_threshold)

  def execute(self):
    cc, cutout, core = _download_and_ccl(
      self.src_path, self.mip, self.shape, self.offset, self.task_num,
      self.fill_missing, self.threshold_gte, self.threshold_lte,
      self.dust_threshold,
    )
    with telemetry.stage("equivalences"):
      self._link(cc)

  def _link(self, cc: np.ndarray):
    cf = CloudFiles(self.src_path)
    scratch = ccl_scratch_path(self.src_path, self.mip)
    gx, gy, gz = (int(v) for v in self.grid_size)
    coord = (
      self.task_num % gx,
      (self.task_num // gx) % gy,
      self.task_num // (gx * gy),
    )
    strides = (1, gx, gx * gy)

    pairs = set()
    for axis, name in enumerate("xyz"):
      if coord[axis] == 0:
        continue
      neighbor = self.task_num - strides[axis]
      data = cf.get(f"{scratch}/faces/{neighbor}-{name}.npy.gz")
      if data is None:
        continue
      their_face = _npy_load(data)
      sl = [slice(None)] * 3
      sl[axis] = 0  # our first plane == their stored overlap plane
      my_face = cc[tuple(sl)]
      if their_face.shape != my_face.shape:
        # dataset-edge clamping can shave a row; compare the intersection
        mins = tuple(min(a, b) for a, b in zip(their_face.shape, my_face.shape))
        their_face = their_face[: mins[0], : mins[1]]
        my_face = my_face[: mins[0], : mins[1]]
      icm = fastremap.inverse_component_map(my_face, their_face)
      for mine, theirs in icm.items():
        for t in theirs.tolist():
          pairs.add((int(mine), int(t)))

    labels = [int(v) for v in np.unique(cc) if v != 0]
    cf.put_json(
      f"{scratch}/equivalences/{self.task_num}.json",
      {"labels": labels, "pairs": sorted(pairs)},
    )


def create_relabeling(src_path: str, mip: int = 0, shape=None) -> int:
  """Pass 3 (single machine): global union-find over all equivalence files
  -> per-task relabel maps + max_label.json. Returns the final component
  count. ``shape`` is accepted for signature parity with the reference;
  the equivalence listing already determines the grid."""
  del shape
  cf = CloudFiles(src_path)
  scratch = ccl_scratch_path(src_path, mip)
  ds = DisjointSet()
  task_labels = {}  # task_num -> [labels]
  for key in cf.list(f"{scratch}/equivalences/"):
    doc = cf.get_json(key)
    task_num = int(key.split("/")[-1].split(".")[0])
    task_labels[task_num] = doc["labels"]
    for lbl in doc["labels"]:
      ds.makeset(lbl)
    for a, b in doc["pairs"]:
      ds.union(a, b)

  mapping, max_label = ds.renumber(start=1)
  for task_num, labels in task_labels.items():
    cf.put_json(
      f"{scratch}/relabel/{task_num}.json",
      {str(lbl): mapping[lbl] for lbl in labels},
    )
  cf.put_json(f"{scratch}/max_label.json", {"max_label": max_label})
  return max_label


class RelabelCCLTask(RegisteredTask):
  """Pass 4: recompute the local CCL, apply the global relabel map, crop
  the overlap, and write the destination segmentation."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    mip: int,
    shape: Sequence[int],
    offset: Sequence[int],
    task_num: int,
    fill_missing: bool = False,
    threshold_gte: Optional[float] = None,
    threshold_lte: Optional[float] = None,
    dust_threshold: int = 0,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.mip = int(mip)
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.task_num = int(task_num)
    self.fill_missing = fill_missing
    self.threshold_gte = threshold_gte
    self.threshold_lte = threshold_lte
    self.dust_threshold = int(dust_threshold)

  def execute(self):
    cc, cutout, core = _download_and_ccl(
      self.src_path, self.mip, self.shape, self.offset, self.task_num,
      self.fill_missing, self.threshold_gte, self.threshold_lte,
      self.dust_threshold,
    )
    cf = CloudFiles(self.src_path)
    scratch = ccl_scratch_path(self.src_path, self.mip)
    table = cf.get_json(f"{scratch}/relabel/{self.task_num}.json")
    if table is None:
      raise FileNotFoundError(
        f"No relabel map for task {self.task_num}; run create_relabeling"
      )
    with telemetry.stage("remap"):
      table = {np.uint64(k): np.uint64(v) for k, v in table.items()}
      table[np.uint64(0)] = np.uint64(0)
      out = fastremap.remap(cc, table)

    sl = tuple(
      slice(int(a), int(b))
      for a, b in zip(core.minpt - cutout.minpt, core.maxpt - cutout.minpt)
    )
    dest = Volume(self.dest_path, mip=self.mip)
    with telemetry.stage("upload"):
      dest.upload(core, out[sl].astype(dest.dtype))
