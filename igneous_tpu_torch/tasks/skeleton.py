"""Skeleton forge and merge tasks (unsharded format).

The port's own copy of ``skel_dir_for``, ``border_targets``,
``SkeletonTask``, ``_merge_label`` and ``UnshardedSkeletonMergeTask`` from
``igneous_tpu/tasks/skeleton.py``. A ``SkeletonTask`` skeletonizes every
label of its cutout (the task's box plus a 1-voxel high-side overlap, so
adjacent tasks share a boundary plane), pins a vertex per label patch on
every shared plane so that the merge welds the pieces, and writes one
``<label>:<bbox>.sk`` fragment per label and a ``.spatial`` index file,
byte-identical to the JAX package's. The merge fuses each label's
fragments and writes ``<label>``.

Where the JAX package runs the whole-cutout EDT and the renumbering on the
host, the port runs them on the device (``ops.skeletonize``); tracing,
encoding and upload stay on the host.

Not ported yet (``NotImplementedError`` when the task is made, before any
download): sharded ``.frags`` output and its merge, ``dust_global``,
``fill_holes``, ``fix_autapses``, graphene layers and ``root_ids``, and
``cross_sectional_area``.

Stage timers (``telemetry``): download, pins (the border pins: their
planes' connected components on the CPU, whose own stages ``ops.ccl``
records too), h2d, edt, labels, d2h, trace, upload (encoding included).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..lib import Bbox, Vec
from ..ops import remap as fastremap
from ..ops.ccl import connected_components
from ..ops.skeletonize import TeasarParams, skeletonize
from ..queues.registry import RegisteredTask
from ..skeleton_io import Skeleton, postprocess
from ..spatial_index import SpatialIndex
from ..storage import CloudFiles
from ..volume import Volume


def skel_dir_for(vol: Volume, skel_dir: Optional[str]) -> str:
  if skel_dir:
    return skel_dir
  if vol.info.get("skeletons"):
    return vol.info["skeletons"]
  raise ValueError("No skeleton directory configured in the info file")


def refuse_unported(
  cloudpath: str = "", sharded: bool = False, dust_global: bool = False,
  fill_holes: int = 0, fix_autapses: bool = False,
  cross_sectional_area: bool = False, root_ids_cloudpath: Optional[str] = None,
) -> None:
  """Raise NotImplementedError for the skeleton options the port does not
  run yet; the factory and the task call it before anything is read or
  written."""
  refused = []
  if str(cloudpath).startswith("graphene://"):
    refused.append("graphene layers")
  if sharded:
    refused.append("sharded .frags output")
  if dust_global:
    refused.append("dust_global")
  if fill_holes:
    refused.append("fill_holes")
  if fix_autapses:
    refused.append("fix_autapses")
  if cross_sectional_area:
    refused.append("cross_sectional_area")
  if root_ids_cloudpath:
    refused.append("root_ids_cloudpath")
  if refused:
    raise NotImplementedError(
      f"not ported to igneous_tpu_torch yet: {', '.join(refused)}"
    )


def border_targets(
  labels: np.ndarray, core_shape, low_sides=(False, False, False)
) -> Dict[int, np.ndarray]:
  """Deterministic pinned voxels per label on every shared boundary plane.

  A task's high-side +1 overlap plane is the SAME global plane as its
  neighbor's first core plane, so both tasks compute the pin from
  identical plane content: each label patch's member voxel nearest the
  patch centroid. Their skeletons gain a common vertex and the merge's
  consolidation welds them. ``low_sides[axis]`` is True when a neighbor
  task exists below (pin plane index 0); the high plane at index
  core_shape[axis] is pinned whenever the cutout includes it.

  Each plane is labelled by one multilabel connected-components call (a
  1-thick 6-connected slab is in-plane 4-connectivity), on the CPU: the
  planes are small, and the components' numbering (first voxel in
  Fortran order), which orders each label's pins, is the JAX package's
  ``_ccl_native``'s."""
  cpu = torch.device("cpu")
  out: Dict[int, List[np.ndarray]] = defaultdict(list)
  for axis in range(3):
    planes = []
    if core_shape[axis] < labels.shape[axis]:
      planes.append(core_shape[axis])  # high-side overlap plane
    if low_sides[axis]:
      planes.append(0)  # low-side shared plane
    for plane_idx in planes:
      sl = [slice(None)] * 3
      sl[axis] = plane_idx
      plane = labels[tuple(sl)]
      comps = connected_components(plane[:, :, None], 6, device=cpu)[:, :, 0]
      others = [a for a in range(3) if a != axis]
      flat = comps.ravel()
      fg = np.flatnonzero(flat)
      if len(fg) == 0:
        continue
      order = fg[np.argsort(flat[fg], kind="stable")]
      sorted_c = flat[order]
      starts = np.flatnonzero(
        np.concatenate([[True], sorted_c[1:] != sorted_c[:-1]])
      )
      ends = np.concatenate([starts[1:], [len(order)]])
      w = plane.shape[1]
      plane_flat = plane.ravel()
      for s, e in zip(starts, ends):
        members = order[s:e]
        pts = np.stack([members // w, members % w], axis=1)
        centroid = pts.mean(axis=0)
        nearest = pts[np.argmin(((pts - centroid) ** 2).sum(axis=1))]
        coord = np.zeros(3, dtype=np.int64)
        coord[axis] = plane_idx
        coord[others[0]] = nearest[0]
        coord[others[1]] = nearest[1]
        out[int(plane_flat[members[0]])].append(coord)
  return {k: np.stack(v) for k, v in out.items()}


class SkeletonTask(RegisteredTask):
  """Stage 1: skeletonize every label of one cutout. The constructor takes
  every parameter of the JAX package's ``SkeletonTask``, so its payloads
  run here unchanged; the unported options raise."""

  def __init__(
    self,
    cloudpath: str,
    shape: Sequence[int],
    offset: Sequence[int],
    mip: int = 0,
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
    extra_targets: Optional[Dict] = None,
    parallel: int = 1,
    timestamp: Optional[float] = None,
    frag_path: Optional[str] = None,
    root_ids_cloudpath: Optional[str] = None,
  ):
    refuse_unported(
      cloudpath, sharded, dust_global, fill_holes, fix_autapses,
      cross_sectional_area, root_ids_cloudpath,
    )
    self.cloudpath = cloudpath
    self.shape = Vec(*shape)
    self.offset = Vec(*offset)
    self.mip = int(mip)
    self.teasar_params = teasar_params or {}
    self.object_ids = list(object_ids) if object_ids else None
    self.mask_ids = list(mask_ids) if mask_ids else None
    self.dust_threshold = int(dust_threshold)
    self.fill_missing = fill_missing
    self.skel_dir = skel_dir
    self.spatial_index = spatial_index
    self.fix_borders = fix_borders
    self.fix_branching = bool(fix_branching)
    self.fix_avocados = bool(fix_avocados)
    # {label: [[x,y,z(,swc_label)] global voxel coords]}: synapse/marker
    # points that must become skeleton vertices, optionally typed
    self.extra_targets = {
      int(k): [
        [int(p[0]), int(p[1]), int(p[2]), int(p[3]) if len(p) > 3 else 0]
        for p in v
      ]
      for k, v in (extra_targets or {}).items()
    }
    self.parallel = int(parallel)
    # write the fragments and spatial cells under another path
    self.frag_path = frag_path

  def prepare_labels(self, vol: Volume):
    """Download and the object-id masks: everything before the EDT.
    Returns (labels, cutout, core, bounds) or None for an empty core."""
    bounds = vol.meta.bounds(self.mip)
    core = Bbox.intersection(Bbox(self.offset, self.offset + self.shape), bounds)
    if core.empty():
      return None
    # +1 overlap: adjacent tasks share their boundary plane
    cutout = Bbox.intersection(Bbox(core.minpt, core.maxpt + 1), bounds)
    with telemetry.stage("download"):
      labels = vol.download(cutout)[..., 0]
    if self.object_ids:
      labels = fastremap.mask_except(labels, self.object_ids)
    if self.mask_ids:
      labels = fastremap.mask(labels, self.mask_ids)
    return labels, cutout, core, bounds

  def targets(self, labels, cutout: Bbox, core: Bbox, bounds: Bbox):
    """The vertices each label must keep, cutout-local: the border pins
    (with ``fix_borders``) and this task's ``extra_targets``; None if
    there are none."""
    targets = (
      border_targets(
        labels,
        tuple(int(v) for v in core.size3()),
        low_sides=tuple(
          bool(core.minpt[a] > bounds.minpt[a]) for a in range(3)
        ),
      )
      if self.fix_borders
      else {}
    )
    # synapse/marker targets: global voxel coords -> cutout-local
    for label, pts in self.extra_targets.items():
      arr = np.asarray(pts, dtype=np.int64).reshape(-1, 4)
      local = arr[:, :3] - np.asarray(cutout.minpt)
      inside = np.all(
        (local >= 0) & (local < np.asarray(labels.shape)), axis=1
      )
      if inside.any():
        prior = targets.get(label)
        merged = local[inside] if prior is None else np.concatenate(
          [prior, local[inside]]
        )
        targets[label] = merged
    return targets or None

  def execute(self, _prepared=None, _edt_field=None):
    """``_prepared`` (what ``prepare_labels`` returned) and ``_edt_field``
    (the cutout's distance field) come from a batched runner
    (``parallel.batch_runner.batched_skeleton_forge``), which downloads
    ahead and runs the EDT of several tasks at once; the fragments are
    the same."""
    # the reference opens the layer with bounded=False; the port's Volume
    # has no such option and needs none: the cutout is intersected with
    # the bounds before it is downloaded
    vol = Volume(self.cloudpath, mip=self.mip, fill_missing=self.fill_missing)
    prepared = _prepared if _prepared is not None else self.prepare_labels(vol)
    if prepared is None:
      return
    labels, cutout, core, bounds = prepared
    with telemetry.stage("pins"):
      targets = self.targets(labels, cutout, core, bounds)
    skels = skeletonize(
      labels,
      anisotropy=tuple(float(v) for v in vol.resolution),
      params=TeasarParams.from_dict(self.teasar_params),
      offset=tuple(float(v) for v in cutout.minpt),
      dust_threshold=self.dust_threshold,
      extra_targets_per_label=targets,
      parallel=self.parallel,
      edt_field=_edt_field,
      fix_branching=self.fix_branching,
      fix_avocados=self.fix_avocados,
    )

    # type the synapse vertices for SWC export
    if self.extra_targets:
      res_f = np.asarray(vol.resolution, dtype=np.float32)
      for label, pts in self.extra_targets.items():
        skel = skels.get(int(label))
        if skel is None or skel.empty:
          continue
        for x, y, z, swc_label in pts:
          if not swc_label:
            continue
          phys = np.asarray([x, y, z], np.float32) * res_f
          d = np.abs(skel.vertices - phys).max(axis=1)
          hit = np.flatnonzero(d < 1e-3)
          if len(hit):
            skel.vertex_types[hit[0]] = np.uint8(swc_label)

    with telemetry.stage("upload"):
      self._upload(vol, skels, core)

  def _upload(self, vol: Volume, skels: Dict[int, Skeleton], core: Bbox) -> None:
    sdir = skel_dir_for(vol, self.skel_dir)
    cf = CloudFiles(self.frag_path or vol.cloudpath)
    res = np.asarray(vol.resolution, dtype=np.int64)
    # the .spatial file is named by the task's physical box
    physical = Bbox(core.minpt * res, core.maxpt * res)
    for label, s in skels.items():
      cf.put(f"{sdir}/{label}:{core.to_filename()}.sk", s.to_precomputed(),
             compress="gzip")
    if self.spatial_index:
      label_bounds = {}
      for label, s in skels.items():
        mn = s.vertices.min(axis=0)
        mx = s.vertices.max(axis=0) + 1
        label_bounds[label] = Bbox(mn.astype(np.int64), mx.astype(np.int64))
      SpatialIndex(cf, sdir).put(physical, label_bounds)


def _merge_label(
  fragments: List[Skeleton],
  dust_threshold: float,
  tick_threshold: float,
  max_cable_length: "float | None" = None,
) -> Skeleton:
  merged = Skeleton.simple_merge(fragments)
  if (
    max_cable_length is not None
    and merged.cable_length() > max_cable_length
  ):
    # over-limit skeletons (merge-error monsters fusing many cells) skip
    # the expensive postprocess but are still uploaded
    return merged.consolidate()
  return postprocess(
    merged, dust_threshold=dust_threshold, tick_threshold=tick_threshold
  )


class UnshardedSkeletonMergeTask(RegisteredTask):
  """Stage 2: fuse one label-prefix's fragments into final skeletons."""

  def __init__(
    self,
    cloudpath: str,
    prefix: str,
    skel_dir: Optional[str] = None,
    dust_threshold: float = 4000.0,
    tick_threshold: float = 6000.0,
    delete_fragments: bool = False,
    max_cable_length: Optional[float] = None,
    crop: int = 0,
  ):
    self.cloudpath = cloudpath
    self.prefix = str(prefix)
    self.skel_dir = skel_dir
    self.dust_threshold = dust_threshold
    self.tick_threshold = tick_threshold
    self.delete_fragments = delete_fragments
    self.max_cable_length = (
      float(max_cable_length) if max_cable_length is not None else None
    )
    # trim this many voxels from each fragment's bbox faces before the
    # merge (0: the border-pinned fragments need no trimming)
    self.crop = int(crop)

  def execute(self):
    vol = Volume(self.cloudpath)
    sdir = skel_dir_for(vol, self.skel_dir)
    cf = CloudFiles(vol.cloudpath)
    skel_info = cf.get_json(f"{sdir}/info") or {}
    attrs = skel_info.get("vertex_attributes")
    # fragment bboxes are voxel coords at the skeletonization mip (the
    # info records it); vertices are physical nm
    skel_mip = int(skel_info.get("mip", 0))

    frags = defaultdict(list)
    frag_keys = []
    for key in cf.list(f"{sdir}/{self.prefix}"):
      name = key.split("/")[-1]
      if not name.endswith(".sk"):
        continue
      label = int(name.split(":")[0])
      frag_keys.append(key)
      frags[label].append(key)

    res = np.asarray(vol.meta.resolution(skel_mip), dtype=np.float32)
    for label, keys in frags.items():
      skels = []
      for k in keys:
        skel = Skeleton.from_precomputed(cf.get(k), vertex_attributes=attrs)
        if self.crop > 0:
          # fragment filenames carry the task bbox: label:bbox.sk
          bbx = Bbox.from_filename(k.split(":", 1)[1][: -len(".sk")])
          lo = (np.asarray(bbx.minpt) + self.crop) * res
          hi = (np.asarray(bbx.maxpt) - self.crop) * res
          if np.any(hi <= lo):
            # the crop would swallow the whole fragment: keep it uncropped
            skels.append(skel)
            continue
          keep = np.all(
            (skel.vertices >= lo - 1e-3) & (skel.vertices <= hi + 1e-3),
            axis=1,
          )
          skel = skel._select_vertices(keep)
        skels.append(skel)
      merged = _merge_label(
        skels, self.dust_threshold, self.tick_threshold,
        self.max_cable_length,
      )
      if merged.empty:
        continue
      cf.put(f"{sdir}/{label}", merged.to_precomputed(), compress="gzip")
    if self.delete_fragments:
      cf.delete(frag_keys)
