"""The voxel-count census and the global dust it serves.

The port's own copy of ``CountVoxelsTask``, ``accumulate_voxel_counts``,
``load_voxel_counts`` and ``globally_small_labels`` from
``igneous_tpu/tasks/stats.py``. A ``CountVoxelsTask`` counts each label's
voxels in its cutout on the device and writes one gzip JSON
``stats/voxel_counts/<mip>/<bbox>``; ``accumulate_voxel_counts`` sums them
into ``voxel_counts.im`` (a ``FragMap`` of uint64 counts), which
``globally_small_labels`` reads for the ``dust_global`` option of the mesh
and skeleton forges. Every file is byte-identical to the JAX package's:
the counts come back in numpy's ascending order of the labels (uint64 ids
at or above 2^63 last), which is the JSON's key order.

Not ported: ``SpatialIndexTask`` and ``ReorderTask``, and the graphene
options ``agglomerate`` and ``timestamp`` (refused when the task is made).

Stage timers (``telemetry``): download, unique (the device count with its
copies), upload.
"""

from __future__ import annotations

import struct
from collections import defaultdict
from typing import Dict, Optional, Sequence

from .. import telemetry
from ..device import get_device
from ..lib import Bbox, Vec
from ..mesh_io import FragMap
from ..ops.mesh import unique_on_device
from ..queues.registry import RegisteredTask
from ..storage import CloudFiles
from ..volume import Volume

VOXEL_COUNT_DIR = "stats/voxel_counts"


def refuse_unported(agglomerate: bool = False, timestamp=None) -> None:
  """Raise NotImplementedError for the census options of graphene layers."""
  if agglomerate or timestamp is not None:
    raise NotImplementedError(
      "not ported to igneous_tpu_torch yet: agglomerate/timestamp "
      "(graphene layers)"
    )


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
    refuse_unported(agglomerate, timestamp)
    self.cloudpath = cloudpath
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
