"""The voxel-count census and the global dust it serves, the spatial
index and the z reorder.

The port's own copy of ``CountVoxelsTask``, ``accumulate_voxel_counts``,
``load_voxel_counts``, ``globally_small_labels``, ``SpatialIndexTask`` and
``ReorderTask`` from ``igneous_tpu/tasks/stats.py``. A ``CountVoxelsTask``
counts each label's voxels in its cutout on the device and writes one gzip JSON
``stats/voxel_counts/<mip>/<bbox>``; ``accumulate_voxel_counts`` sums them
into ``voxel_counts.im`` (a ``FragMap`` of uint64 counts), which
``globally_small_labels`` reads for the ``dust_global`` option of the mesh
and skeleton forges. Every file is byte-identical to the JAX package's:
the counts come back in numpy's ascending order of the labels (uint64 ids
at or above 2^63 last), which is the JSON's key order.

``SpatialIndexTask`` finds each label's box on the device
(``ops.mesh.label_boxes``) and writes the ``.spatial`` file with its keys
in the JAX package's order, the ascending order of ``ops.remap.renumber``'s
ids (numpy's, uint64 ids at or above 2^63 last), so the gzip bytes are
equal. ``ReorderTask`` is host code: one z slice read and written at a
time.

On a graphene layer, ``agglomerate`` counts the proofread root ids as of
``timestamp`` (mapped on the device, ``Volume.map_ids``).

Stage timers (``telemetry``): download, graphene (the id map), unique
(the device count with its copies), boxes, upload.
"""

from __future__ import annotations

import struct
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from .. import telemetry
from ..device import get_device
from ..lib import Bbox, Vec
from ..mesh_io import FragMap
from ..ops.mesh import label_boxes, labels_on_device, unique_on_device
from ..queues.registry import RegisteredTask
from ..spatial_index import SpatialIndex
from ..storage import CloudFiles
from ..volume import Volume

VOXEL_COUNT_DIR = "stats/voxel_counts"


class CountVoxelsTask(RegisteredTask):
  """Per-task label -> voxel-count census, uploaded as one JSON."""

  def __init__(
    self,
    cloudpath: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    fill_missing: bool = False,
    agglomerate: bool = False,
    timestamp=None,
  ):
    self.cloudpath = cloudpath
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.fill_missing = fill_missing
    # graphene layers: count the proofread root ids as of the timestamp
    self.agglomerate = bool(agglomerate)
    self.timestamp = timestamp

  def execute(self):
    vol = Volume(self.cloudpath, mip=self.mip, fill_missing=self.fill_missing,
                 bounded=False)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), vol.bounds
    )
    if bounds.empty():
      return
    with telemetry.stage("download"):
      img = vol.download(bounds)
    img = vol.map_ids(img, bounds, self.mip, self.agglomerate, self.timestamp)[..., 0]
    with telemetry.stage("unique"):
      labels, counts = unique_on_device(img, get_device(), return_counts=True)
    with telemetry.stage("upload"):
      CloudFiles(vol.cloudpath).put_json(
        f"{VOXEL_COUNT_DIR}/{self.mip}/{bounds.to_filename()}",
        {str(int(l)): int(c) for l, c in zip(labels, counts)},
        compress="gzip",
      )


def accumulate_voxel_counts(
  cloudpath: str, mip: int = 0, compress: str = "gzip",
  additional_output: Optional[str] = None,
) -> Dict[int, int]:
  """Single-machine reduce: sum all census JSONs -> ``voxel_counts.im`` (a
  FragMap of uint64 counts). Returns the totals. ``additional_output``
  also writes the FragMap to a local path."""
  cf = CloudFiles(cloudpath)
  totals: Dict[int, int] = defaultdict(int)
  for key in cf.list(f"{VOXEL_COUNT_DIR}/{mip}/"):
    doc = cf.get_json(key)
    if not doc:
      continue
    for label, count in doc.items():
      totals[int(label)] += int(count)
  payload = {
    label: struct.pack("<Q", count) for label, count in totals.items()
  }
  blob = FragMap.tobytes(payload)
  cf.put(f"{VOXEL_COUNT_DIR}/{mip}/voxel_counts.im", blob, compress=compress)
  if additional_output:
    with open(additional_output, "wb") as f:
      f.write(blob)
  return dict(totals)


def load_voxel_counts(cloudpath: str, mip: int = 0) -> Optional[FragMap]:
  data = CloudFiles(cloudpath).get(f"{VOXEL_COUNT_DIR}/{mip}/voxel_counts.im")
  return None if data is None else FragMap.frombytes(data)


def globally_small_labels(
  cloudpath: str, mip: int, labels, threshold: float,
) -> list:
  """Labels whose GLOBAL voxel count (from the voxel_counts.im census)
  falls below ``threshold``: the dust_global primitive of SkeletonTask
  and MeshTask. Raises if the census has not been built."""
  counts = load_voxel_counts(cloudpath, mip)
  if counts is None:
    raise ValueError(
      "dust_global requires the voxel-count census: run "
      "`python -m igneous_tpu_torch image voxels count` then `... voxels "
      "sum` (or tasks.stats.accumulate_voxel_counts) on this layer first."
    )
  small = []
  for label in labels:
    label = int(label)
    if label == 0:
      continue
    blob = counts.get(label)
    total = struct.unpack("<Q", blob)[0] if blob else 0
    if total < threshold:
      small.append(label)
  return small


class SpatialIndexTask(RegisteredTask):
  """(Re)build one grid cell's .spatial file from the segmentation."""

  def __init__(
    self,
    cloudpath: str,
    prefix: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
    fill_missing: bool = False,
  ):
    self.cloudpath = cloudpath
    self.prefix = prefix
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.fill_missing = fill_missing

  def execute(self):
    vol = Volume(self.cloudpath, mip=self.mip, fill_missing=self.fill_missing,
                 bounded=False)
    bounds = Bbox.intersection(
      Bbox(self.offset, self.offset + self.shape), vol.bounds
    )
    if bounds.empty():
      return
    with telemetry.stage("download"):
      img = vol.download(bounds)[..., 0]
    with telemetry.stage("boxes"):
      seg, flip = labels_on_device(img, (0, 0, 0), (0, 0, 0), get_device())
      labels, _counts, _dense, lo, hi = label_boxes(seg, flip)
      del seg, _dense
    res = np.asarray(vol.resolution, dtype=np.int64)
    minpt = np.asarray(bounds.minpt)
    # the dense ids 1..n follow the nonzero labels in ascending order, the
    # insertion order of the JAX package's dict
    if flip:
      labels = labels.view(np.uint64)
    nonzero = [int(v) for v in labels.tolist() if v != 0]
    label_bounds = {
      label: Bbox((lo[i] + minpt) * res, (hi[i] + minpt) * res)
      for i, label in enumerate(nonzero, start=1)
    }
    physical = Bbox(bounds.minpt * res, bounds.maxpt * res)
    with telemetry.stage("upload"):
      SpatialIndex(CloudFiles(vol.cloudpath), self.prefix).put(physical, label_bounds)


class ReorderTask(RegisteredTask):
  """Copy z-slices into a new z order: dest[z] = src[mapping[z]] for the
  task's z range."""

  def __init__(
    self,
    src_path: str,
    dest_path: str,
    mip: int,
    z_start: int,
    z_end: int,
    mapping: Dict,
    fill_missing: bool = False,
    compress="gzip",
    delete_black_uploads: bool = False,
    background_color: int = 0,
  ):
    self.src_path = src_path
    self.dest_path = dest_path
    self.mip = int(mip)
    self.z_start = int(z_start)
    self.z_end = int(z_end)
    self.mapping = {int(k): int(v) for k, v in mapping.items()}
    self.fill_missing = fill_missing
    self.compress = compress
    self.delete_black_uploads = bool(delete_black_uploads)
    self.background_color = int(background_color)

  def execute(self):
    src = Volume(self.src_path, mip=self.mip, fill_missing=self.fill_missing)
    dest = Volume(
      self.dest_path, mip=self.mip,
      delete_black_uploads=self.delete_black_uploads,
      background_color=self.background_color,
    )
    bounds = src.bounds
    for z in range(self.z_start, self.z_end):
      src_z = self.mapping.get(z, z)
      sl = Bbox(
        (bounds.minpt.x, bounds.minpt.y, src_z),
        (bounds.maxpt.x, bounds.maxpt.y, src_z + 1),
      )
      dl = Bbox(
        (bounds.minpt.x, bounds.minpt.y, z),
        (bounds.maxpt.x, bounds.maxpt.y, z + 1),
      )
      with telemetry.stage("download"):
        img = src.download(sl)
      with telemetry.stage("upload"):
        dest.upload(dl, img, compress=self.compress)
